"""Serving launcher: static one-shot generation of an LM (any family: the
dense, MoE, SSM and hybrid decoders, the VLM and the encoder-decoder),
continuous batching replaying a Poisson request trace (the decoder
families), or the multi-tenant HDC service replaying one.

  # on the GPU, TinyLlama-1.1B at its published width, weights from the seed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 8 --prompt-len 1024 --max-new 32

  # on the CPU, the reduced same-family config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu

  # the SSM decoder (Falcon-Mamba-7B) and the hybrid (Zamba2-2.7B): any
  # --arch the registry carries, static or --stream
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --smoke --device cpu --stream

  # the encoder-decoder (Whisper-tiny: 1500 stub frames a request) and the
  # VLM (Qwen2-VL-7B: 16 stub patch embeddings of a 4 x 4 grid, M-RoPE),
  # static generation
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --batch 32 --prompt-len 32 --max-new 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \
      --smoke --device cpu

  # continuous batching: a seeded Poisson trace of mixed prompt lengths
  # through the scheduler (step-granular admission and eviction)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --stream --requests 32 --rate 8 --slots 4 --max-new 16

  # the multi-tenant HDC service: tenant-tagged Poisson arrivals through
  # the slot ring, one multi-tenant OTA serve a step (add --device cpu to
  # run it on the CPU)
  PYTHONPATH=src python -m repro_torch.launch.serve --hdc --requests 48 \
      --rate 800 --slots 8 --tenants 4

  # the same with the port's span recorder on (`repro_torch.spans`): after
  # the trace, each span's count and host and device ms a step, and the
  # slots' occupancy
  PYTHONPATH=src python -m repro_torch.launch.serve --hdc --trace

The weights, the trace and the tenants' codebooks are drawn from ``--seed``
(no download), as the reference's launcher draws them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as _device


def build_batch(cfg, generator: torch.Generator, batch_size: int, prompt_len: int,
                grid_hw: tuple[int, int] = (4, 4)) -> dict:
    """Random prompts [B, S] in [0, vocab), on the generator's device, and
    the inputs the family reads, drawn from the generator as the reference's
    launcher draws them: the enc-dec's stub frames [B, enc_seq, d] (0.02 x
    normals), the VLM's stub patch embeddings [B, gh * gw, d] (the same)
    and their M-RoPE positions (`vlm.default_positions`)."""
    dev = generator.device
    batch = {"tokens": torch.randint(0, cfg.vocab, (batch_size, prompt_len),
                                     generator=generator, device=dev, dtype=torch.int32)}
    if cfg.kind == "encdec":
        batch["frames"] = (0.02 * torch.randn((batch_size, cfg.enc_seq, cfg.d_model),
                                              generator=generator, device=dev)).to(cfg.dtype)
    if cfg.kind == "vlm":
        from repro_torch.models import vlm

        sv = grid_hw[0] * grid_hw[1]
        batch["patch_embeds"] = (0.02 * torch.randn((batch_size, sv, cfg.d_model),
                                                    generator=generator, device=dev)
                                 ).to(cfg.dtype)
        batch["positions"] = vlm.default_positions(batch_size, sv, prompt_len, grid_hw,
                                                   device=dev)
    return batch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_static(args, cfg, model, params, dev: torch.device) -> torch.Tensor:
    """Generate twice (the first call pays the kernel build and the
    allocator's warm-up) and print the tokens, times and tokens/s."""
    from repro_torch.serving import Engine, ServeConfig

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batch = build_batch(cfg, gen, args.batch, args.prompt_len)
    eng = Engine(model, ServeConfig(max_new=args.max_new, temperature=args.temperature))
    secs = []
    for _ in range(2):
        sample_gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
        _sync(dev)
        t0 = time.perf_counter()
        toks = eng.generate(params, batch, sample_gen)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    print(f"generated {tuple(toks.shape)} tokens on {dev}; first call {secs[0]:.3f} s, "
          f"warm {secs[1]:.3f} s ({args.batch * args.max_new / secs[1]:.1f} tok/s)")
    print("sample:", toks[0][:12].tolist())
    return toks


def run_stream(args, cfg, model, params, dev: torch.device) -> dict:
    """Continuous batching: a seeded Poisson trace of mixed prompt lengths
    through `Scheduler` + `ContinuousEngine`. A warm-up admits one request
    of each length; then the trace is replayed in real time and the
    tokens/s, decode steps and request latencies (queueing included) are
    printed."""
    from repro_torch.serving import ContinuousEngine, Scheduler, ServeConfig

    if args.prompt_lens:
        lengths = tuple(int(x) for x in args.prompt_lens.split(","))
    else:
        lengths = tuple(sorted({max(4, args.prompt_len // 2), args.prompt_len,
                                args.prompt_len * 2}))
    rng = np.random.default_rng(args.seed)
    req_lens = rng.choice(lengths, size=args.requests)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests))
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab, (int(n),)), dtype=torch.int32,
                               device=dev) for n in req_lens]
    eng = ContinuousEngine(model, ServeConfig(max_new=args.max_new,
                                              temperature=args.temperature),
                           num_slots=args.slots, max_prompt_len=max(lengths), device=dev)

    t0 = time.perf_counter()
    warm = Scheduler(eng, params)
    for n in lengths:
        warm.submit(torch.zeros((n,), dtype=torch.int32), max_new=min(2, args.max_new))
    warm.run(timeout=600)
    print(f"warm-up: {len(eng._prefill_sigs)} prompt lengths admitted and stepped in "
          f"{time.perf_counter() - t0:.3f} s")

    sched = Scheduler(eng, params)
    t0 = time.monotonic()
    nxt = 0
    while len(sched.results) < args.requests:
        now = time.monotonic() - t0
        while nxt < args.requests and arrivals[nxt] <= now:
            sched.submit(prompts[nxt])
            nxt += 1
        if sched.pending or sched.active:
            sched.step()
        elif nxt < args.requests:
            time.sleep(min(arrivals[nxt] - now, 0.01))
    wall = time.monotonic() - t0

    done = list(sched.results.values())
    n_tok = sum(len(c.tokens) for c in done)
    lat = np.asarray([c.latency for c in done])
    print(f"{args.requests} requests (lens {lengths}, rate {args.rate}/s, {args.slots} slots) "
          f"on {dev}: {wall:.3f} s wall, {n_tok} tokens, {n_tok / wall:.1f} tok/s, "
          f"{sched.steps} decode steps")
    print(f"request latency p50 {np.percentile(lat, 50) * 1e3:.3f} ms  "
          f"p95 {np.percentile(lat, 95) * 1e3:.3f} ms  max {lat.max() * 1e3:.3f} ms")
    return sched.results


def run_hdc_stream(args, dev: torch.device) -> dict:
    """Multi-tenant HDC serving: tenant-tagged Poisson arrivals through the
    slot-ring `HDCScheduler`, every step one multi-tenant OTA serve. A warm-up
    fills every slot once; then the trace is replayed in real time and the
    trials/s and request latencies (queueing included) are printed. With
    ``--trace`` the span recorder is on from the start, and its summary is
    printed at the end."""
    from repro_torch import phy, spans
    from repro_torch.core import classifier, hypervector as hv, scaleout
    from repro_torch.serving import HDCEngine, HDCScheduler

    if args.trace:
        spans.enable()
    rep = "unpacked" if args.unpacked else "packed"
    cfg = scaleout.ScaleOutConfig(n_classes=args.classes, dim=args.dim, m_tx=3, n_rx_cores=8,
                                  batch=args.hdc_batch, representation=rep, noise="exact")
    tcfg = classifier.HDCTaskConfig(n_classes=args.classes, dim=args.dim)
    books = classifier.make_tenant_codebooks(
        [torch.Generator(device=dev).manual_seed(args.seed + t) for t in range(args.tenants)],
        tcfg, device=dev)
    state = phy.state_from_ber(torch.full((cfg.n_rx_cores,), 0.02, device=dev), cfg.m_tx)
    eng = HDCEngine(cfg, state, num_slots=args.slots, max_tenants=args.tenants, device=dev)
    for t in range(args.tenants):
        eng.registry.onboard(t, hv.pack(books[t]) if cfg.packed else books[t])

    rng = np.random.default_rng(args.seed)
    tenant_of = rng.integers(0, args.tenants, args.requests)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests))
    queries = [scaleout.make_queries(torch.Generator(device=dev).manual_seed(100 + i), cfg,
                                     books[int(t)])[1] for i, t in enumerate(tenant_of)]

    t0 = time.perf_counter()
    warm = HDCScheduler(eng)
    for _ in range(args.slots):
        warm.submit(0, queries[0])
    warm.run(timeout=600)
    print(f"warm-up: one full-ring step of {args.slots} slots in "
          f"{time.perf_counter() - t0:.3f} s")

    sched = HDCScheduler(eng)
    t0 = time.monotonic()
    nxt = 0
    while len(sched.results) < args.requests:
        now = time.monotonic() - t0
        while nxt < args.requests and arrivals[nxt] <= now:
            sched.submit(int(tenant_of[nxt]), queries[nxt])
            nxt += 1
        if sched.pending or sched.running:
            sched.step()
        elif nxt < args.requests:
            time.sleep(min(arrivals[nxt] - now, 0.01))
    wall = time.monotonic() - t0

    lat = np.asarray([c.latency for c in sched.results.values()])
    n_trials = args.requests * cfg.batch
    print(f"{args.requests} requests x {cfg.batch} trials, {args.tenants} tenants ({rep}, "
          f"rate {args.rate}/s, {args.slots} slots) on {dev}: {wall:.3f} s wall, "
          f"{n_trials / wall:.1f} trials/s, {sched.steps} serve steps")
    print(f"request latency p50 {np.percentile(lat, 50) * 1e3:.3f} ms  "
          f"p95 {np.percentile(lat, 95) * 1e3:.3f} ms  max {lat.max() * 1e3:.3f} ms")
    if args.trace:
        spans.disable()
        print_spans(spans.summary())
        print_slowest(sched.results, spans.records(), spans.unix_ns)
    return sched.results


def print_spans(summary: dict) -> None:
    """The span recorder's summary: a line a span name, then the slots'
    occupancy (live slots over slots served)."""
    def ms(x):
        return "-" if x is None else f"{x:.4f}"

    print(f"spans over {summary['steps']} steps ({summary['dropped']} dropped): "
          "count, host ms a step, device ms a step, host ms in all")
    for name, s in summary["spans"].items():
        print(f"  {name:20s} {s['count']:6d} {ms(s['host_ms_per_step']):>10s} "
              f"{ms(s['device_ms_per_step']):>10s} {s['host_ms']:10.3f}")
    c = summary["counters"]
    if c.get("hdc.slots"):
        print(f"slot occupancy {c.get('hdc.slots_live', 0)} of {c['hdc.slots']} slots "
              f"served ({c.get('hdc.slots_live', 0) / c['hdc.slots']:.3f})")


def print_slowest(results: dict, records: list, unix_ns) -> None:
    """The slowest request, the step that served it (`HDCCompletion.step`)
    and that step's spans, host and device ms, with the step's start in Unix
    ns (``unix_ns``), where a profile taken alongside places it."""
    done = max(results.values(), key=lambda c: c.latency)
    mine = [r for r in records if r.step == done.step]
    head = next((r for r in mine if r.name == "sched.step"), None)
    if head is None:
        return
    parts = ", ".join(f"{r.name} {r.host_ms:.3f}" + (
        "" if r.device_ms is None else f" (device {r.device_ms:.3f})") for r in mine)
    print(f"slowest request {done.rid}: {done.latency * 1e3:.3f} ms, served in step "
          f"{done.step} (from Unix ns {unix_ns(head.start_ns)}); its spans, ms: {parts}")


def main(argv: list[str] | None = None) -> torch.Tensor | dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", help="LM architecture: a dense, MoE, SSM (falcon-mamba-7b) or "
                                   "hybrid (zamba2-2.7b) decoder, the VLM (qwen2-vl-7b) or "
                                   "the encoder-decoder (whisper-tiny)")
    ap.add_argument("--smoke", action="store_true", help="the reduced f32 config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--stream", action="store_true",
                    help="continuous batching: replay a Poisson request trace")
    ap.add_argument("--hdc", action="store_true",
                    help="multi-tenant HDC serving over the OTA wire path")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=8.0, help="arrivals per second")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-lens", default="",
                    help="comma-separated prompt-length buckets (default: derived "
                         "from --prompt-len)")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--hdc-batch", type=int, default=4, help="(--hdc) trials per request")
    ap.add_argument("--classes", type=int, default=128)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--unpacked", action="store_true",
                    help="(--hdc) elementwise representation instead of packed")
    ap.add_argument("--trace", action="store_true",
                    help="(--hdc) record the port's spans and print their summary")
    args = ap.parse_args(argv)

    if args.hdc:
        return run_hdc_stream(args, _device.resolve(args.device))
    if not args.arch:
        raise SystemExit("--arch is required unless --hdc")

    from repro_torch import configs
    from repro_torch.models import get_model, init_params

    dev = _device.resolve(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    if args.stream and cfg.kind != "decoder":
        raise SystemExit(f"--stream replays token-only requests, as the reference's trace "
                         f"does; {cfg.name} ({cfg.kind}) needs its "
                         f"{'frames' if cfg.kind == 'encdec' else 'patch embeddings'} too: "
                         "serve it statically (without --stream)")
    model = get_model(cfg)
    params = init_params(model.specs, torch.Generator(device=dev).manual_seed(args.seed), dev)
    if args.stream:
        return run_stream(args, cfg, model, params, dev)
    return run_static(args, cfg, model, params, dev)


if __name__ == "__main__":
    main()
