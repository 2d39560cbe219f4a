"""The program's own spans (`repro_torch.spans`) of the profiled steps.

The port records its spans while a `torch.profiler` profile runs, so the
traced run's profiled steps (`yardstick.trace.profile_steps`) carry them:
the first ``trace.steps`` ``sched.step`` spans that start after the window
closes, and the spans of their steps. A program without the recorder, or a
run without a profiled trace, gives None."""
from __future__ import annotations


def profiled_steps(ctx):
    """(the profiled steps' ``sched.step`` spans, every span of those
    steps), or None."""
    t = ctx.trace
    if t is None or not t.steps:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    recs = spans.records()
    closed_ns = (ctx.loop.t_start + ctx.loop.window_s) * 1e9
    steps = sorted((r for r in recs if r.name == "sched.step" and r.start_ns >= closed_ns),
                   key=lambda r: r.start_ns)[:t.steps]
    if len(steps) != t.steps:
        return None
    ids = {r.step for r in steps}
    return steps, [r for r in recs if r.step in ids]
