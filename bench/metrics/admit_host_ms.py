"""admit_host_ms: host ms a step inside `HDCEngine.admit_many`, from the
benchmark's span around the call, over the window (scheduler layer)."""


def read(ctx):
    spans = ctx.loop.spans.get("admit")
    if not spans or not ctx.loop.steps:
        return None
    return sum(spans) / ctx.loop.steps * 1e3
