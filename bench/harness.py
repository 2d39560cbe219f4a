"""The benchmark's general part: it finds a cell's configuration, traffic,
loop, system and metric readers by the names in ``BENCHMARK.json``, runs the
cell, reads its metrics, judges its answers against the plain reference and
prints the result line. Nothing here knows a cell: a cell is its files.

Files, found by name under ``bench/``:
  configs/<config>.json   the configuration (its ``system`` and ``limits``)
  traffic/<traffic>.json  the traffic mix (its ``loop``)
  loops/<loop>.py         ``run(system, traffic, seconds, spans, profile)``
  systems/<system>.py     ``build(config, traffic, seed, device, spans)``
  metrics/<metric>.py     ``read(ctx)``: the metric, or None where it finds
                          nothing to read
"""
from __future__ import annotations

import importlib.util
import json
import random
import sys
import time
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")      # top-level module names


def load(kind: str, name: str) -> types.ModuleType:
    """The module ``bench/<kind>/<name>.py``."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    key = f"bench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = sys.modules[key] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_plan(spec: dict, workload: str) -> dict:
    """The cell named ``workload``: its entry, configuration, traffic and the
    metrics it reports, end to end and per layer."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]

    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]))


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (default: the loaded modules)
    that are JAX's, Flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def run_cell(plan: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, chips: int = 1) -> tuple[dict, list[str]]:
    """Run one cell; returns (the result object, the compared numbers' lines)."""
    import torch

    config, traffic = plan["config"], plan["traffic"]
    cuda = torch.device(device).type == "cuda"
    spans: dict | None = {} if trace else None
    system = load("systems", config["system"]).build(config, traffic, seed, device, spans)
    profile = None
    if trace and cuda:
        from bench.yardstick.trace import profile_steps
        profile = profile_steps
    loop = load("loops", traffic["loop"]).run(system, traffic, seconds, spans or {}, profile)
    setup_s = loop.t_start - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = types.SimpleNamespace(loop=loop, trace=loop.trace, setup_s=setup_s,
                                shapes=system.shapes(), config=config, traffic=traffic)
    metrics = {}
    for m in plan["per_layer"] if trace else plan["end_to_end"]:
        value = load("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    system.release()
    t_check = time.perf_counter()
    checks = judge(system, loop, seed, traffic["check_requests"], config["limits"])
    t_check = time.perf_counter() - t_check
    failed = sum(not d.ok for d in loop.done)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(loop.done), "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": chips, "memory_peak_bytes": peak},
    }
    if trace and loop.trace is not None:
        from bench.yardstick.trace import top
        t = loop.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": top(t.ops), "idle_gaps": top(t.gaps)}
    result["checks"] = checks
    marks = [("process start", t_start)] + list(system.marks) + [("warm steps", loop.t_start)]
    lines = ["set-up, s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                                       for a, b in zip(marks, marks[1:])),
             f"window {loop.window_s:.3f} s, {loop.steps} steps, {len(loop.done)} requests; "
             f"the comparison took {t_check:.3f} s"]
    lines += [f"check {k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()]
    return result, lines


def judge(system, loop, seed: int, n_check: int, limits: dict,
          control: bool = False) -> dict:
    """The compared numbers, each with its limit: a sample of ``n_check``
    finished requests drawn from the seed (window, profiled steps and
    drain), each answer against the plain reference; requests never
    answered; requests that failed. ``control`` judges the reference at the
    precision below the stated one in the program's place."""
    from bench.seeds import derive

    pool = [d for d in loop.done + loop.later if d.ok]
    sample = sorted(random.Random(derive(seed, "check")).sample(pool, min(n_check, len(pool))),
                    key=lambda d: d.index)
    numbers = dict(system.mismatches(sample, control=control))
    numbers["unanswered"] = loop.unanswered
    numbers["failed"] = sum(not d.ok for d in loop.done + loop.later)
    numbers["uncompared"] = n_check - len(sample)
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def main(argv: list[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell of the port.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    plan = cell_plan(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    chips = plan["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, lines = run_cell(plan, args.seed, args.seconds, bool(args.trace), "cuda",
                             t_start, chips)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
