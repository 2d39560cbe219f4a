"""fanout_device_ms: device ms a step of the per-slot PHY fan-out, the
program's ``ota.fanout`` span (`_rx_fanout` slot by slot and their stack),
over the profiled steps whose spans the program timed (multi-tenant serve
layer). The span's device time is a pair of CUDA events on the serve's
stream: the stream's time from the fan-out's start to its end, the
device's idle inside it included, where ``serve_device_ms`` is a busy
union. Under the profiler the program times the spans of one step in 50
ms (`repro_torch.spans.SAMPLE_NS`), so this is their mean."""
from bench.yardstick.program_spans import profiled_steps


def read(ctx):
    got = profiled_steps(ctx)
    if got is None:
        return None
    ms = [r.device_ms for r in got[1] if r.name == "ota.fanout" and r.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
