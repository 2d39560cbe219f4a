"""serve_device_ms: device busy ms a step (every kernel, copy and set, as
the union of their intervals) over the profiled steps (multi-tenant serve
layer)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.steps or t.busy_s <= 0:
        return None
    return t.busy_s / t.steps * 1e3
