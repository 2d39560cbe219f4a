#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failing phase exits non-zero; there is no CPU
fallback, and a missing GPU is a failure):

1. card: the GPU's name and power limit (nvidia-smi); build the CUDA kernels
   from src/repro_torch/csrc with nvcc and print the build seconds;
2. kernels: each of the four kernels against its plain PyTorch version on the
   card, at the serve's shapes and at one tall shape (102,400 classes over 64
   cores, d = 2048, batch 4096) -- bit-exact, with the kernel's median device
   time (CUDA-graph replay) and eager call time, the plain version's time,
   one PyTorch library call's where one computes the same function, and the
   bound (least time the card could take);
3. precharacterization: the EM channel + exhaustive OTA phase search at
   3 TX / 64 RX / 7 dB, avg BER 0.0100 +- 1e-4;
4. OTA serve at the paper's configuration (6400 classes, d = 512, M = 3,
   64 cores, batch 256): 8 calls in each of the four bsc modes
   (baseline/permuted x unpacked/packed) and ideal baseline unpacked/packed;
   packed == unpacked on the same seeds, ideal == the noise-free reference
   (predictions and maxsim), and the launch counters show which kernels
   each serve ran;
5. wired serve, unpacked and packed, with the same checks;
6. the bsc tier alone at the serve shape: every core's flip rate lies within
   5 sigma of its BER, and the packed draw equals the unpacked one.

Then the card line again, a JSON line {"kernels": [...]} (launches counted on
the serve runs of phases 4-5 only), and as the last line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile --json out/chip_smoke.json

adds a profile of every serve mode under torch.profiler (device busy time,
idle share, top device ops per call), and writes every number of the run,
unrounded, to the JSON file.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
CALLS = 8                        # serve calls per mode
# serve modes: (serve, PHY tier, permuted bundling, representation)
MODES = ([("ota", ch, perm, rep) for ch, perm in (("bsc", False), ("bsc", True), ("ideal", False))
          for rep in ("unpacked", "packed")]
         + [("wired", "bsc", False, rep) for rep in ("unpacked", "packed")])
SERVE_KERNELS = {  # (serve, representation) -> the kernels its calls must launch
    ("ota", "unpacked"): ("assoc_matmul",), ("ota", "packed"): ("hamming_topk_banked",),
    ("wired", "unpacked"): ("majority_bundle", "assoc_matmul"),
    ("wired", "packed"): ("hamming_search",),
}
KERNELS = {  # name -> (route, source, the TPU kernel it replaces)
    "hamming_topk_banked": ("cuda", "src/repro_torch/csrc/hamming.cu",
                            "src/repro/kernels/hamming/kernel.py:109"),
    "hamming_search": ("cuda", "src/repro_torch/csrc/hamming.cu",
                       "src/repro/kernels/hamming/kernel.py:260"),
    "assoc_matmul": ("cuda", "src/repro_torch/csrc/assoc_matmul.cu",
                     "src/repro/kernels/assoc_matmul/kernel.py:42"),
    "majority_bundle": ("cuda", "src/repro_torch/csrc/majority.cu",
                        "src/repro/kernels/majority/kernel.py:27"),
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _events(torch):
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def call_ms(torch, fn, samples: int = 7) -> float:
    """Median time of one eager call of `fn` issued back to back from Python:
    the device time or, when the host issues slower than the device runs,
    the host's cost per call (what an eager caller pays)."""
    fn()
    torch.cuda.synchronize()
    start, end = _events(torch)
    per_call = []
    for _ in range(samples):
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / 20)
    return statistics.median(per_call)


def time_ms(torch, fn, samples: int = 7) -> float:
    """Median device time of one call of `fn`: a batch of calls (sized from
    one eager call to take ~2 ms) captured in one CUDA graph, so the host's
    launch cost drops out, and the graph replayed `samples` times between
    CUDA events. Caches stay warm, as for the serve, which reuses its
    prototypes from call to call."""
    fn()
    torch.cuda.synchronize()
    start, end = _events(torch)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(1, min(100, int(2.0 / max(start.elapsed_time(end), 1e-3))))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up on a side stream before capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(per_call)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(torch, gen):
    """(kernel name, shape label, kernel call, plain call, library call or
    None, bytes moved, operations, operation kind) at the main path's shapes
    and the tall shape."""
    from repro_torch import kernels as tk
    from repro_torch.core import hypervector as hv
    from repro_torch.kernels.assoc_matmul.ref import assoc_matmul_ref
    from repro_torch.kernels.hamming.ref import hamming_search_ref, hamming_topk_banked_ref
    from repro_torch.kernels.majority.ref import majority_bundle_ref

    dev = "cuda"

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.uint8)

    cases = []
    for label, (g, b, c, w) in [("serve baseline G=64", (64, 256, 100, 16)),
                                ("serve permuted G=192", (192, 256, 100, 16)),
                                ("tall", (64, 4096, 1600, 64)),
                                # static + dynamic shared memory just past 48 KB
                                ("wide", (4, 64, 300, 76))]:
        q, p = words(g, b, w), words(g, c, w)
        cases.append(("hamming_topk_banked", f"{label} B={b} C={c} W={w}",
                      lambda q=q, p=p: tk.hamming_topk_banked(q, p),
                      lambda q=q, p=p: hamming_topk_banked_ref(q, p), None,
                      4 * g * (b + c) * w + 8 * g * b, 3 * g * b * c * w, "int32"))
    for label, (b, c, w) in [("serve wired", (256, 6400, 16)), ("tall", (4096, 102400, 64))]:
        q, p = words(b, w), words(c, w)
        # cdist with p=0 counts the coordinates that differ: the Hamming
        # distance, on the unpacked bits as f32
        qf, pf = hv.unpack(q, 32 * w).float(), hv.unpack(p, 32 * w).float()
        cases.append(("hamming_search", f"{label} B={b} C={c} W={w}",
                      lambda q=q, p=p: tk.hamming_search(q, p),
                      lambda q=q, p=p: hamming_search_ref(q, p),
                      lambda qf=qf, pf=pf: torch.cdist(qf, pf, p=0),
                      4 * (b + c) * w + 4 * b * c, 3 * b * c * w, "int32"))
    for label, (g, b, c, k) in [("serve per core G=64", (64, 256, 100, 512)),
                                ("serve permuted G=192", (192, 256, 100, 512)),
                                ("serve wired G=1", (1, 256, 6400, 512)),
                                ("tall", (64, 4096, 1600, 2048))]:
        q, p = bits(g, b, k), bits(g, c, k)
        qb = (2 * q.to(torch.bfloat16) - 1).contiguous()
        pbt = (2 * p.to(torch.bfloat16) - 1).transpose(1, 2).contiguous()
        cases.append(("assoc_matmul", f"{label} B={b} C={c} K={k}",
                      lambda q=q, p=p: tk.assoc_matmul_banked(q, p),
                      lambda q=q, p=p: assoc_matmul_ref(q, p),
                      lambda qb=qb, pbt=pbt: torch.bmm(qb, pbt),
                      g * (b + c) * k + 4 * g * b * c, 2 * g * b * c * k, "int8"))
    for label, (m, b, d) in [("serve wired", (3, 256, 512)), ("tall", (3, 4096, 2048))]:
        x = bits(m, b, d)
        cases.append(("majority_bundle", f"{label} M={m} B={b} d={d}",
                      lambda x=x: tk.majority_bundle(x),
                      lambda x=x, m=m: majority_bundle_ref(x.reshape(m, -1)).reshape(x.shape[1:]),
                      lambda x=x: torch.mode(x, 0).values,   # odd M: the mode is the majority
                      m * b * d + b * d, m * b * d, "int32"))
    return cases


def phase_kernels(torch, gen) -> dict:
    results = {}
    for name, label, kern, plain, lib, nbytes, ops, kind in kernel_cases(torch, gen):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                  for a, b in zip(got_t, want_t))
        exact = all(torch.equal(a, b) for a, b in zip(got_t, want_t))
        require(exact, f"{name} [{label}] differs from its plain version (max |err| {err})")
        ms, eager_ms = time_ms(torch, kern), call_ms(torch, kern)
        plain_ms = time_ms(torch, plain, samples=3)
        lib_ms = time_ms(torch, lib, samples=3) if lib is not None else None
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if kind == "int8":      # a product with a tensor-core form: its int8 peak
            ops_ms = ops / INT8_OPS_PER_S * 1e3
            bound_ms, bound_by = max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                                          else "operations")
        else:                   # popcount / int adds: no published peak, bytes bound
            bound_ms, bound_by = bytes_ms, "bytes"
        row = dict(shape=label, max_abs_err=err, ms=ms, call_ms=eager_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=lib_ms, bytes=nbytes, ops=ops, op_kind=kind)
        results.setdefault(name, []).append(row)
        print(f"kernel {name} [{label}]: bit-exact, {ms:.4f} ms (eager call {eager_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, "
              f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}; {nbytes} B, {ops} {kind} ops)", flush=True)
    return results


# ---------------------------------------------------------------------------
# phases 4-5: the serves
# ---------------------------------------------------------------------------

def serve_setup(torch, base, mode, protos_u, device):
    """One serve mode: (label, cfg, serve fn, its prototypes, CALLS batches of
    (classes, queries), noise generator). The query and noise generators are
    seeded alike in every mode, so every mode sees the same draws."""
    import dataclasses

    from repro_torch.core import hypervector as hv
    from repro_torch.core import scaleout

    kind, ch, perm, rep = mode
    cfg = dataclasses.replace(base, channel=ch, permuted=perm, representation=rep)
    make = scaleout.make_ota_serve if kind == "ota" else scaleout.make_wired_serve
    label = (f"ota {ch} {'permuted' if perm else 'baseline'} {rep}" if kind == "ota"
             else f"wired {rep}")
    gq = torch.Generator(device=device).manual_seed(1)
    batches = [scaleout.make_queries(gq, cfg, protos_u) for _ in range(CALLS)]
    return (label, cfg, make(cfg, device=device), hv.pack(protos_u) if cfg.packed else protos_u,
            batches, torch.Generator(device=device).manual_seed(2))


def run_serve(torch, base, mode, protos_u, state, device):
    """CALLS serve calls of one mode with the launch counters set to 0 just
    before and read just after; returns predictions, maxsims, classes, the
    noise-free reference's predictions and maxsims, per-call ms and kernel
    launches."""
    from repro_torch import kernels as tk
    from repro_torch.core import scaleout

    label, cfg, serve, protos, batches, gn = serve_setup(torch, base, mode, protos_u, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    preds, sims, ms = [], [], []
    tk.reset_launch_counts()
    for _, q in batches:
        t0 = time.perf_counter()
        pred, sim = serve(protos, q, state, gn)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        preds.append(pred)
        sims.append(sim)
    counts = tk.launch_counts()
    refs = [scaleout.serve_reference(cfg, protos, q) for _, q in batches]
    return dict(label=label, pred=torch.cat(preds), sim=torch.cat(sims),
                classes=torch.cat([c for c, _ in batches]), ms=ms, counts=counts,
                ref_pred=torch.cat([r[0] for r in refs]),
                ref_sim=torch.cat([r[1] for r in refs]))


def hit_rate(torch, run, permuted: bool) -> dict:
    from repro_torch.core import classifier

    if permuted:
        return classifier.serve_accuracy(run["pred"], run["classes"])
    sent = (run["pred"][:, None] == run["classes"]).any(1)
    return {"hit": float(sent.float().mean())}


def phase_serves(torch, state, protos_u, base, device="cuda") -> dict:
    """Phases 4-5 at configuration `base` (the paper's on the card)."""
    launches = dict.fromkeys(KERNELS, 0)
    runs = {}
    for mode in MODES:
        run = runs[mode] = run_serve(torch, base, mode, protos_u, state, device)
        want = SERVE_KERNELS[(mode[0], mode[3])]
        require(all(run["counts"][k] > 0 for k in want),
                f"{run['label']}: {want} not all launched {run['counts']}")
        require(all(v == 0 for k, v in run["counts"].items() if k not in want),
                f"{run['label']}: unexpected launches {run['counts']}")
        for name, n in run["counts"].items():
            launches[name] += n
        run["acc"] = hit_rate(torch, run, mode[2])
        print(f"serve {run['label']}: {CALLS} calls x batch {base.batch}, "
              f"{statistics.median(run['ms']):.3f} ms/call median "
              f"(first {run['ms'][0]:.3f}), {json.dumps(run['acc'])}, launches {run['counts']}",
              flush=True)
    for kind, ch, perm, rep in MODES:
        run = runs[(kind, ch, perm, rep)]
        if rep == "packed":
            u = runs[(kind, ch, perm, "unpacked")]
            require(torch.equal(u["pred"], run["pred"]) and torch.equal(u["sim"], run["sim"]),
                    f"{run['label']}: differs from the unpacked serve")
        if kind == "wired" or ch == "ideal":
            require(torch.equal(run["pred"], run["ref_pred"])
                    and torch.equal(run["sim"], run["ref_sim"]),
                    f"{run['label']}: differs from serve_reference")
    require(runs[("ota", "bsc", False, "unpacked")]["acc"]["hit"] > 0.9,
            "bsc baseline: fewer than 90% of trials answered from the sent set")
    print("serve checks: packed == unpacked in every mode, ideal and wired == "
          "serve_reference (predictions and maxsim)", flush=True)
    return {"launches": launches, "runs": {
        r["label"]: dict(ms=r["ms"], acc=r["acc"], counts=r["counts"]) for r in runs.values()}}


def phase_flip_rate(torch, state, cfg) -> dict:
    """The bsc tier alone at the serve shape: CALLS draws of every core's
    copy of an all-zero bundle. Each core's flip rate must lie within 5 sigma
    of ``state.ber`` (binomial sigma over the bits drawn), and the packed
    tier's draw on the same seed must unpack to the unpacked one."""
    from repro_torch import phy
    from repro_torch.core import hypervector as hv

    chan, n = phy.get_channel("bsc"), cfg.n_rx_cores
    zeros = torch.zeros((cfg.batch, cfg.dim), dtype=torch.uint8, device="cuda")
    flips = torch.zeros(n, dtype=torch.float64, device="cuda")
    for seed in range(CALLS):
        draws = [chan.rx_copies(torch.Generator(device="cuda").manual_seed(100 + seed),
                                hv.pack(zeros) if packed else zeros, state, 0, n,
                                packed=packed, dim=cfg.dim, noise=cfg.noise)
                 for packed in (False, True)]
        require(torch.equal(hv.unpack(draws[1], cfg.dim), draws[0]),
                "bsc: the packed draw differs from the unpacked one")
        flips += draws[0].sum((1, 2), dtype=torch.float64)
    bits = CALLS * cfg.batch * cfg.dim
    ber = state.ber.double()
    rate = flips / bits
    sigma = (ber * (1 - ber) / bits).sqrt()
    z = float(((rate - ber).abs() / sigma.clamp_min(1e-300)).max())
    require(bool(((rate - ber).abs() <= 5 * sigma + 1e-12).all()),
            f"bsc: a core's flip rate is more than 5 sigma from its BER (max {z:.2f} sigma)")
    print(f"bsc flip rate: {n} cores x {bits} bits, within 5 sigma of each core's BER "
          f"(max {z:.3f} sigma), packed draw == unpacked", flush=True)
    return dict(bits_per_core=bits, max_sigma=z)


def phase_profile(torch, state, protos_u, base) -> dict:
    """Where a serve call's time goes (``--profile``): each mode's CALLS
    calls under torch.profiler; the device's busy time is the union of its
    kernel and copy intervals, its idle share the rest of the host's wall
    time of those calls, and the top device ops by summed time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for mode in MODES:
        label, _, serve, protos, batches, gn = serve_setup(torch, base, mode, protos_u, "cuda")
        serve(protos, batches[0][1], state, gn)       # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _, q in batches:
                serve(protos, q, state, gn)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, cur_s, cur_e, by_name = 0.0, None, None, {}
        for a, b, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            if cur_e is None or a > cur_e:
                busy += 0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        busy += 0 if cur_e is None else cur_e - cur_s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        row = dict(wall_ms_per_call=wall_us / CALLS / 1e3,
                   device_busy_ms_per_call=busy / CALLS / 1e3,
                   idle_share=(1 - busy / wall_us) if dev else None,
                   device_ops_per_call=len(dev) / CALLS,
                   top=[(n[:60], t / CALLS / 1e3) for n, t in top])
        out[label] = row
        idle = "n/a" if row["idle_share"] is None else f"{row['idle_share']:.3f}"
        print(f"profile {label}: {row['wall_ms_per_call']:.3f} ms/call wall, device busy "
              f"{row['device_busy_ms_per_call']:.3f} ms/call "
              f"({row['device_ops_per_call']:.0f} device ops), idle share {idle}; top: "
              + ", ".join(f"{n} {t:.4f}" for n, t in row["top"][:4]), flush=True)
    return out


def main(argv: list[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile every serve mode under torch.profiler")
    ap.add_argument("--json", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs only on the GPU here",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)
    from repro_torch.core import classifier, scaleout
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"card: {card} ({kind}, {count} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)
    _build.library()
    print(f"build: {_build.build_seconds:.2f} s (nvcc, sm_90a, "
          f"{len(_build.SOURCES)} sources in parallel)", flush=True)

    kernels = phase_kernels(torch, torch.Generator(device="cuda").manual_seed(0))

    cfg = scaleout.ScaleOutConfig()
    pre_ms = []
    for _ in range(2):                   # cold (first use of its ops), then warm
        t0 = time.perf_counter()
        state = scaleout.precharacterize_state(cfg, device="cuda")
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    avg, mx = float(state.ber.mean()), float(state.ber.max())
    print(f"precharacterization: {cfg.m_tx} TX / {cfg.n_rx_cores} RX / {cfg.snr_db} dB, "
          f"avg BER {avg:.6f}, max {mx:.6f}, {pre_ms[0]:.1f} ms cold, {pre_ms[1]:.1f} ms warm",
          flush=True)
    require(abs(avg - 0.0100) <= 1e-4, f"avg BER {avg} is not 0.0100 +- 1e-4")

    protos_u = classifier.make_codebook(
        torch.Generator(device="cuda").manual_seed(0),
        classifier.HDCTaskConfig(n_classes=cfg.n_classes, dim=cfg.dim), device="cuda")
    serves = phase_serves(torch, state, protos_u, cfg)
    flip = phase_flip_rate(torch, state, cfg)
    profiles = phase_profile(torch, state, protos_u, cfg) if args.profile else None

    line = []
    for name, (route, source, replaces) in KERNELS.items():
        main_row = kernels[name][0]          # the first case is the main path's shape
        line.append(dict(name=name, route=route, source=source, replaces=replaces,
                         launches=serves["launches"][name],
                         max_abs_err=max(r["max_abs_err"] for r in kernels[name]),
                         ms=main_row["ms"], call_ms=main_row["call_ms"],
                         plain_ms=main_row["plain_ms"],
                         bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                         library_ms=main_row["library_ms"], shape=main_row["shape"]))
    require(all(k["launches"] > 0 for k in line), "a kernel of the path never launched")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(
            card=card, kind=kind, torch=torch.__version__, build_s=_build.build_seconds,
            ber=dict(avg=avg, max=mx, ms=pre_ms), kernels=kernels, serves=serves["runs"],
            flip_rate=flip,
            profiles=profiles, seconds=time.perf_counter() - t_start), indent=1))
    print(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
