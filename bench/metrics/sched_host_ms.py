"""sched_host_ms: the scheduler's own host ms a step: the program's
``sched.step`` span less the ``hdc.admit``, ``hdc.serve`` and
``sched.barrier`` spans inside it (the age-fair pick, the bookkeeping of
admissions and completions), over the profiled steps (scheduler layer)."""
from bench.yardstick.program_spans import profiled_steps

CHILDREN = ("hdc.admit", "hdc.serve", "sched.barrier")


def read(ctx):
    got = profiled_steps(ctx)
    if got is None:
        return None
    steps, recs = got
    inner = sum(r.host_ms for r in recs if r.name in CHILDREN)
    return (sum(r.host_ms for r in steps) - inner) / len(steps)
