"""Serving launcher: static one-shot generation of a dense decoder.

  # on the GPU, TinyLlama-1.1B at its published width, weights from the seed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 8 --prompt-len 1024 --max-new 32

  # on the CPU, the reduced same-family config
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu

The weights are drawn from ``--seed`` (no download), as the reference's
launcher draws them. Continuous batching (``--stream``) and the multi-tenant
HDC serve (``--hdc``) wait for ROADMAP module item 12.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device


def build_batch(cfg, generator: torch.Generator, batch_size: int, prompt_len: int) -> dict:
    """Random decoder prompts [B, S] in [0, vocab), on the generator's device."""
    return {"tokens": torch.randint(0, cfg.vocab, (batch_size, prompt_len),
                                    generator=generator, device=generator.device,
                                    dtype=torch.int32)}


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


def main(argv: list[str] | None = None) -> torch.Tensor | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", help="LM architecture (dense decoders)")
    ap.add_argument("--smoke", action="store_true", help="the reduced f32 config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--stream", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--hdc", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.stream or args.hdc:
        raise SystemExit("--stream and --hdc are not ported yet: the slot ring, the "
                         "scheduler and the HDC engine wait for ROADMAP module item 12")
    if not args.arch:
        raise SystemExit("--arch is required")

    from repro_torch import configs
    from repro_torch.models import get_model, init_params

    dev = _device.resolve(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    model = get_model(cfg)
    params = init_params(model.specs, torch.Generator(device=dev).manual_seed(args.seed), dev)
    return run_static(args, cfg, model, params, dev)


if __name__ == "__main__":
    main()
