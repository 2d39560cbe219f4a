"""host_idle_ms: the device's idle ms a step while the host ran the
program's own code: the profiled idle gaps whose innermost host range is
one of the program's spans (``sched.*``, ``hdc.*``, ``ota.*``), over the
profiled steps (device layer). A gap left under a bare ``bench.*`` range
is the benchmark's own code; one under an operator or a CUDA call is
neither's. None without a device trace or without the program's spans in
the profiled steps; 0.0 where no gap falls under them."""
from bench.yardstick.program_spans import profiled_steps

PROGRAM = ("sched.", "hdc.", "ota.")


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps or t.busy_s <= 0 or profiled_steps(ctx) is None:
        return None
    mine = [s for label, s in t.gaps.items() if label.split("/")[-1].startswith(PROGRAM)]
    return sum(mine) / t.steps * 1e3
