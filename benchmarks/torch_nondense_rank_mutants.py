#!/usr/bin/env python3
"""Planted faults against `chip_smoke.py` phase 24's gates (training of the
non-dense families across gloo ranks), on one H100.

    python3 benchmarks/torch_nondense_rank_mutants.py

Each mutant is a temporary copy of the tree (outside it, deleted after;
the built kernel library copied along, so nothing is rebuilt) with the
port's rank code broken in one way:

* "partial sums not reduced": a model rank's partial sum over its heads or
  channels left unreduced where every rank's is summed: the decoders'
  attention output projection (`transformer._attn_out`; Mixtral, Kimi-K2,
  Zamba2's shared block, Qwen2-VL), Mamba-1's out projection (Falcon-Mamba)
  and the enc-dec's (Whisper);
* "Mamba-2 norm over the rank's channels": the gated RMSNorm's sum of
  squares over the rank's own channels (Zamba2).

(The third fault, the MoE aux taken per data rank, cannot show in phase 24,
whose MoE runs have one data rank; tests/test_torch_distributed_nondense.py
holds it on 2x1.) In each copy, phase 24 runs the runs the mutant touches
with its gates recording instead of stopping: it prints each gate that
catches the mutant ("caught: ...") and every run's readings, the worst
relative loss over the steps (rank 0's) and the step-1 gradient norm's
relative distance from one rank's. Phase 24's bounds sit between these
readings and those of sound runs (PERF.md §6).
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MUTANTS = {
    "partial sums not reduced": (None, [
        ("src/repro_torch/models/transformer.py",
         "    return collectives.reduce_from_group(out, collectives.cut_group(tp, h, "
         "cfg.n_heads))\n",
         "    return out\n"),
        ("src/repro_torch/models/mamba.py",
         "    out = collectives.reduce_from_group(dense(y, mine(\"out_proj\", 0)), group)\n",
         "    out = dense(y, mine(\"out_proj\", 0))\n"),
        ("src/repro_torch/models/encdec.py",
         "    return out if tp is None else collectives.reduce_from_group(\n",
         "    return out if True else collectives.reduce_from_group(\n"),
    ]),
    "Mamba-2 norm over the rank's channels": (("zamba2-2.7b",), [
        ("src/repro_torch/models/mamba.py",
         "    var = collectives.sum_both_ways((yf * yf).sum(-1, keepdim=True), group) / whole\n",
         "    var = (yf * yf).mean(-1, keepdim=True)\n"),
    ]),
}
CODE = """
import sys; sys.path.insert(0, '.'); sys.path.insert(0, 'src')
import torch, chip_smoke as cs
if __name__ == '__main__':
    only = %r
    caught = []
    cs.require = lambda cond, what: cond or caught.append(what)
    runs = {g: tuple(r for r in v if only is None or r['arch'] in only)
            for g, v in cs.NR_RUNS.items()}
    cs.NR_RUNS = {g: v for g, v in runs.items() if v}
    out = cs.phase_nondense_ranks(torch, {})
    for grid, row in out['grids'].items():
        for name, res in row.items():
            if name != 'wall_s':
                print(f'reading {grid} {name}: loss {max(res["loss_rel"]):.4g}, '
                      f'step-1 gradient norm {res["gnorm_rel"]:.4g}')
    for what in caught:
        print('caught:', what[:300])
    print('caught by', len(caught), 'gate checks' if caught else 'no gate: PASSED')
"""


def main() -> int:
    for name, (only, edits) in MUTANTS.items():
        d = tempfile.mkdtemp(prefix="mutant_")
        try:
            shutil.copytree(ROOT, d, dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns(".git"))
            for path, old, new in edits:
                f = Path(d) / path
                src = f.read_text()
                if src.count(old) != 1:
                    raise RuntimeError(f"mutant {name!r}: the line to break is not in {path}")
                f.write_text(src.replace(old, new))
            r = subprocess.run([sys.executable, "-c", CODE % (only,)], cwd=d,
                               capture_output=True, text=True, timeout=1200)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        print(f"== mutant: {name} (rc {r.returncode})", flush=True)
        print("\n".join(l for l in r.stdout.splitlines()
                        if l.startswith(("reading", "caught"))), flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
