"""precharacterize_s: host seconds of the channel's precharacterization in
this run's set-up, the program's ``ota.precharacterize`` span (a set-up span
the program records in every process): the last one to end before the
first timed step (set-up layer). Read, like the program's other span
readings, from a run with a device trace: None without one, and None from
a program without the span."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    t_start_ns = ctx.loop.t_start * 1e9
    mine = [r for r in spans.records()
            if r.name == "ota.precharacterize" and r.end_ns <= t_start_ns]
    return max(mine, key=lambda r: r.end_ns).host_ms * 1e-3 if mine else None
