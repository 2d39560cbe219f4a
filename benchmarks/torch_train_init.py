#!/usr/bin/env python3
"""Whether TinyLlama-1.1B trains from the reference's init, on one H100.

    python3 benchmarks/torch_train_init.py

At TinyLlama-1.1B's published width and depth (remat, B 8 x S 1024 of the
synthetic stream, AdamW with warmup 5 and 30 total steps), 15 steps each
from the seed's draw of the reference's init in bf16, the same draw with
the attention projections at fan-in over their contraction
(`chip_smoke.fan_in_over_contraction`), the reference's init in f32, and
the reference's init at lr 3e-4; prints each run's host-clock ms a step
(the first run's includes the kernels' build and cuBLAS's warm-up) and its
(loss, global gradient norm) at every step. Needs a CUDA device.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_train_init: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import get_model
    from repro_torch.train.loop import build_train_fns
    from repro_torch.train.optimizer import OptConfig

    base = configs.get_config("tinyllama-1.1b")
    for label, cfg, cond, lr in [
            ("bf16 ref init", base, False, 1e-3), ("bf16 conditioned", base, True, 1e-3),
            ("f32 ref init", dataclasses.replace(base, dtype=torch.float32), False, 1e-3),
            ("bf16 ref init lr 3e-4", base, False, 3e-4)]:
        model = get_model(cfg)
        fns = build_train_fns(model, OptConfig(lr=lr, warmup=5, total_steps=30), device="cuda")
        pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=1024, global_batch=8), device="cuda")
        params, st = fns.init(0)
        if cond:
            cs.fan_in_over_contraction(params, cfg)
        out = []
        t0 = time.perf_counter()
        for step in range(15):
            params, st, m = fns.step(params, st, pipe.batch(step))
            out.append((round(float(m["loss"]), 4), round(float(m["gnorm"]), 2)))
        print(label, f"{(time.perf_counter() - t0) / 15 * 1e3:.1f} ms/step", out, flush=True)
        del params, st, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
