"""The readings that a cell's limits are set from, on the chip at the cell's
own size:

    python3 bench/control.py --workload <name> --seeds 12 --control-seeds 3 \\
        --seconds 2 --first-seed <n>

For each seed a short window of the cell's own traffic through the program,
then its compared numbers on the sampled requests (the lower readings); for
the first ``--control-seeds`` seeds also the control's: the plain reference
one precision below the stated noise in the program's place, on the same
requests (the upper readings). One JSON line a reading, then the largest
program reading and the smallest control reading of each number. The
benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(plan: dict, seed: int, seconds: float, control: bool, device: str) -> list:
    """[(kind, numbers)] of one seed: the program's, and with ``control``
    the control's on the same sampled requests."""
    from bench import harness

    config, traffic = plan["config"], plan["traffic"]
    system = harness.load("systems", config["system"]).build(config, traffic, seed, device,
                                                            None)
    loop = harness.load("loops", traffic["loop"]).run(system, traffic, seconds, {})
    system.release()
    out = []
    for kind in ("program", "control") if control else ("program",):
        t0 = time.perf_counter()
        numbers = harness.judge(system, loop, seed, traffic["check_requests"],
                                config["limits"], control=kind == "control")
        out.append((kind, {k: v["value"] for k, v in numbers.items()},
                    time.perf_counter() - t0))
    return out


def main(argv: list[str]) -> int:
    from bench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 7)
    args = ap.parse_args(argv)
    plan = harness.cell_plan(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    lower: dict = {}
    upper: dict = {}
    for i in range(args.seeds):
        seed = args.first_seed + i
        for kind, numbers, secs in readings(plan, seed, args.seconds,
                                            i < args.control_seeds, "cuda"):
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers, "check_s": secs}), flush=True)
            into, pick = (lower, max) if kind == "program" else (upper, min)
            for k, v in numbers.items():
                into[k] = v if k not in into else pick(into[k], v)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "control_seeds": args.control_seeds, "lower": lower, "upper": upper,
                      "seconds": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
