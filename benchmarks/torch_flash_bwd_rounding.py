#!/usr/bin/env python3
"""How far the attention backward's bf16 arithmetic puts the gradients from
the exact ones, on the CPU.

    PYTHONPATH=src python benchmarks/torch_flash_bwd_rounding.py

For bf16 inputs at cut versions of `chip_smoke.py`'s FLASH_BWD_CASES (batch
and heads cut so that an f64 computation fits the CPU), the plain twin
`flash_bwd_ref` with P and dS in f32 (``p_bf16=0``), rounded to bf16 (1,
the reference's FLASH_P_BF16) and split into bf16 hi + lo (2, the bf16
kernel's arithmetic): each one's largest |error| against the f64
`flash_bwd_exact`, for dq, dk and dv, as a ratio to the f32 twin's. The kernel's
gate on the card (`chip_smoke.py`, phase 16 (a)) allows 1.5.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# (B, Sq, Skv, H, KH, D, causal, window, q_offset)
CASES = [
    ("train", (1, 1024, 1024, 8, 1, 64, True, -1, 0)),
    ("gemma3-1b local", (1, 1024, 1024, 4, 1, 256, True, 512, 0)),
    ("gemma3-1b global", (1, 1024, 1024, 4, 1, 256, True, -1, 0)),
    ("deepseek-coder-33b", (1, 1024, 1024, 7, 1, 128, True, -1, 0)),
    ("D=16", (2, 300, 300, 4, 2, 16, True, -1, 0)),
    ("D=32", (2, 300, 300, 4, 2, 32, True, -1, 0)),
    ("non-causal", (1, 512, 512, 8, 1, 64, False, -1, 0)),
    ("chunk", (1, 256, 768, 8, 1, 64, True, -1, 512)),
    ("fully masked rows", (2, 128, 128, 4, 2, 64, True, -1, -64)),
]


def main() -> int:
    from repro_torch.kernels.flash_attention.ref import (flash_bwd_exact, flash_bwd_ref,
                                                       flash_fwd_ref)

    gen = torch.Generator().manual_seed(0)
    print("ratio of |error| vs f64 to the f32 twin's, dq/dk/dv: rounded (1) | split (2)")
    for label, (b, sq, skv, h, kh, d, causal, win, off) in CASES:
        q, dout = (torch.randn(b, sq, h, d, generator=gen).bfloat16() for _ in range(2))
        k, v = (torch.randn(b, skv, kh, d, generator=gen).bfloat16() for _ in range(2))
        kw = dict(causal=causal, window=win, q_offset=off)
        out, lse = flash_fwd_ref(q, k, v, return_lse=True, **kw)
        ex = flash_bwd_exact(q, k, v, dout, **kw)

        def err(p_bf16):
            got = flash_bwd_ref(q, k, v, out, lse, dout, p_bf16=p_bf16, **kw)
            return [float((a.double() - e).abs().max()) for a, e in zip(got, ex)]

        base = err(0)
        ratios = {n: [x / y for x, y in zip(err(n), base)] for n in (1, 2)}
        print(f"{label:20s} " + " | ".join("/".join(f"{r:.3f}" for r in ratios[n])
                                            for n in (1, 2)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
