#!/usr/bin/env python3
"""The learning rate of chip_smoke.py's phase 23 (training of the MoE, SSM
and hybrid decoders on one H100), swept.

    python3 benchmarks/torch_nondense_lr.py [--json out/nondense_lr.json]

For each AdamW setting of SETTINGS (phase 16's schedule, then rates held
from the first step, warm-up 1, as phase 19 holds its own) and each run of
`chip_smoke.NT_RUNS` (Mixtral-8x22B and Kimi-K2 at 1 layer, Kimi-K2 with 24
routed experts, Zamba2-2.7B whole, Falcon-Mamba-7B at its cut; B x 1024,
bf16, remat, the attention projections at fan-in over their contraction),
TRAIN["steps"] steps through `chip_smoke.nt_train` with its loss-drop gate
off (every other gate on): prints each run's losses, its largest loss over
its first, and its last loss below its first. Needs a CUDA device.
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SETTINGS = (dict(lr=1e-3, warmup=5), dict(lr=3e-4, warmup=1), dict(lr=1e-4, warmup=1),
            dict(lr=3e-5, warmup=1))


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_nondense_lr: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cs.TRAIN = dict(cs.TRAIN, min_drop=-math.inf)
    rows = []
    for setting in SETTINGS:
        cs.NT_OPT = dict(setting, total_steps=cs.TRAIN["total_steps"])
        for run in cs.NT_RUNS:
            res = cs.nt_train(torch, run, {})
            losses = res["losses"]
            rows.append(dict(setting=setting, arch=run["arch"], losses=losses,
                             ms_per_step=res["ms_per_step"]))
            print(f"lr sweep {run['arch']} lr {setting['lr']:g} warm-up {setting['warmup']}: "
                  f"largest loss / first {max(losses) / losses[0]:.3f}, last below first "
                  f"{losses[0] - losses[-1]:.4f}", flush=True)
    if "--json" in argv:
        out = Path(argv[argv.index("--json") + 1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=cs.card_line(), rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
