"""Shared helpers of the benchmark's CPU tests: the real cells' plans, cut to
sizes the CPU runs in a second (the program's plain twins stand in for the
kernels there)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

WORKLOADS = ("hdc-paper-closed", "hdc-scale-closed")
TINY = dict(n_classes=64, dim=64, n_rx_cores=8, batch=8, slots=2, tenants=2)
# large enough that one precision lower flips some answers (the control)
SMALL = dict(n_classes=640, dim=512, n_rx_cores=64, batch=64, slots=2, tenants=2)
SEED = 2 ** 31 + 12345


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def plan(workload: str, sizes: dict = TINY, **traffic) -> dict:
    p = harness.cell_plan(spec(), workload)
    p["config"].update(sizes)
    p["traffic"].update(dict(clients=4, warm_steps=1, check_requests=6), **traffic)
    return p


def run(workload: str, *, trace: bool = False, sizes: dict = TINY, seconds: float = 0.3,
        seed: int = SEED):
    import time

    return harness.run_cell(plan(workload, sizes), seed, seconds, trace, "cpu",
                            time.perf_counter())
