"""device_idle: the share of the profiled window in which no kernel, copy
or set ran on the device (%)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
