#!/usr/bin/env python3
"""Mutation check of `chip_smoke.py` phase 16's attention gates, on one H100.

    python3 benchmarks/torch_flash_bwd_mutants.py

Each mutant is a temporary copy of the tree (outside it, deleted after)
with one source line of a kernel broken: the bf16 backward's dK/dV pass
dropping the last query head of each kv head, or its dV product dropping
the lo term of P (a kernel that rounds P to bf16 alone), and the bf16
forward writing its log-sum-exp without the NEG_INF rule for rows that see
no key. In each
copy, phase 16 (a) runs at the training shape and on rows that see no key,
then (b) runs 3 AdamW steps with its in-path check (every layer's backward
kernel against the twin on the step's own inputs; the loss gate off).
Prints, per mutant, which gate caught it ("caught: ...") or "PASSED".
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MUTANTS = {
    "dK/dV drop the last query head of each kv head": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "const int G = H / KH, nqt = (Sq + BQ - 1) / BQ, total = G * nqt;",
        "const int G = H / KH, nqt = (Sq + BQ - 1) / BQ, total = (G > 1 ? G - 1 : G) * nqt;"),
    "dV drops the lo term of P (P rounded to bf16 alone)": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "      wgmma_rs<DH>(&acc_v[0][0], al[ks], db);\n", ""),
    "bf16 forward lse loses the NEG_INF rule": (
        "src/repro_torch/csrc/flash_attention.cu", "(m0 == NEG_INF ? NEG_INF : m0 * scale)",
        "(m0 * scale)"),
}
CODE = """
import sys; sys.path.insert(0, '.')
import torch, chip_smoke as cs
cs.FLASH_BWD_CASES = [c for c in cs.FLASH_BWD_CASES if c[0] in ('train', 'fully masked rows')]
try:
    cs.flash_bwd_cases(torch, torch.Generator(device='cuda').manual_seed(1)); print('(a) PASSED')
except cs.SmokeFailure as e:
    print('(a) caught:', str(e)[:400])
cs.TRAIN = dict(cs.TRAIN, steps=3, ref_init_steps=0, min_drop=-1e9)
try:
    cs.phase_train_adamw(torch, {}); print('(b) PASSED')
except cs.SmokeFailure as e:
    print('(b) caught:', str(e)[:400])
"""


def main() -> int:
    for name, (path, old, new) in MUTANTS.items():
        d = tempfile.mkdtemp(prefix="mutant_")
        try:
            shutil.copytree(ROOT, d, dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("build", ".git"))
            f = Path(d) / path
            src = f.read_text()
            if src.count(old) != 1:
                raise RuntimeError(f"mutant {name!r}: the line to break is not in {path}")
            f.write_text(src.replace(old, new))
            r = subprocess.run([sys.executable, "-c", CODE], cwd=d, capture_output=True,
                               text=True, timeout=900)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        print(f"== mutant: {name} (rc {r.returncode})")
        print("\n".join(l for l in r.stdout.splitlines() if l.startswith(("(a)", "(b)"))))
        if r.returncode:
            print(r.stderr[-2000:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
