"""Training launcher (counterpart of `repro/launch/train.py`).

  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 20 --batch 8 --seq 1024
  python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu \\
      --steps 12 --batch 4 --seq 64 --ckpt-dir ck --ckpt-every 5

The first trains at the architecture's published width and depth on the card
(bf16 parameters drawn from seed 0, the synthetic Zipf and motif stream);
``--smoke`` takes the reduced f32 config. Runs on CUDA unless ``--device
cpu`` is asked for, and raises without a card. Rerunning with the same
``--ckpt-dir`` resumes from its latest checkpoint. Prints the architecture
and device, the loss every 10 steps, the first and final loss, and the
median step time with the tokens a second it gives.
"""
from __future__ import annotations

import argparse
import statistics
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--opt", default="adamw", choices=["adamw", "sign_majority"])
    ap.add_argument("--ota-ber", type=float, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt under TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.device import resolve
    from repro_torch.models import count_params, get_model
    from repro_torch.train.loop import Trainer, TrainerConfig, build_train_fns
    from repro_torch.train.optimizer import OptConfig

    dev = resolve(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    model = get_model(cfg)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} params={count_params(model.specs)} dtype="
          f"{str(cfg.dtype).split('.')[-1]} device={dev} ({name})", flush=True)

    opt = OptConfig(kind=args.opt, lr=args.lr, warmup=10, total_steps=args.steps)
    fns = build_train_fns(model, opt, microbatch=args.microbatch, ota_ber=args.ota_ber,
                          device=dev)
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch),
                       device=dev)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every)
    if args.ckpt_dir is not None:
        tcfg = dataclasses.replace(tcfg, ckpt_dir=args.ckpt_dir)
    trainer = Trainer(fns, pipe, tcfg)
    _, _, losses = trainer.run(0)
    if not losses:
        print(f"nothing to do: checkpoint already at step {args.steps}")
        return 0
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    warm = trainer.step_seconds[1:] or trainer.step_seconds
    ms = statistics.median(warm) * 1e3
    print(f"{len(losses)} steps on {dev}: median step {ms:.1f} ms (host clock, first step "
          f"{trainer.step_seconds[0] * 1e3:.1f} ms), {args.batch * args.seq / ms * 1e3:.0f} "
          f"tokens/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
