"""trials_per_s: every trial of every request completed in the window,
over the window's seconds (host clock)."""


def read(ctx):
    return sum(d.units for d in ctx.loop.done if d.ok) / ctx.loop.window_s
