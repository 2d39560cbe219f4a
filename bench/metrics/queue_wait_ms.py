"""queue_wait_ms: the mean of admission minus submission over the window's
completions, on the scheduler's own timestamps (scheduler layer)."""


def read(ctx):
    waits = [d.t_admit - d.t_submit for d in ctx.loop.done if d.ok]
    return sum(waits) / len(waits) * 1e3 if waits else None
