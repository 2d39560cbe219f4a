"""What a profiled run of steps spent on the device (`torch.profiler`, CUPTI
on the card): the busy time as the union of every kernel, copy and set
interval, the time by device operation, and the idle gaps between busy
intervals, each named by what the host ran at its middle (the innermost
host range there, under the benchmark's own ``bench.*`` range). The busy
union follows the port's chip smoke (`profile_calls`)."""
from __future__ import annotations

import dataclasses
import heapq
import time

# the profiled steps: at least MIN_STEPS and MIN_SECONDS, at most MAX_STEPS,
# so that a trace of the shortest steps stays small enough to read in seconds
MIN_STEPS, MIN_SECONDS, MAX_STEPS = 5, 0.5, 100
NAME_CHARS = 100            # device operation names are cut to this length
# template noise dropped from device operation names before the cut
NAME_NOISE = ("void ", "at::native::", "(anonymous namespace)::", "std::")


@dataclasses.dataclass
class Trace:
    window_s: float                 # host clock over the profiled steps
    busy_s: float                   # union of the device intervals
    steps: int
    ops: dict                       # device op name -> seconds
    gaps: dict                      # host activity -> idle seconds between busy intervals

    def op_seconds(self, *fragments: str) -> float:
        """Seconds in device ops whose name holds any of ``fragments``."""
        return sum(s for name, s in self.ops.items() if any(f in name for f in fragments))


def profile_steps(one_step) -> Trace:
    """Run ``one_step`` under the profiler. The window is timed between two
    synchronisations inside the profiled region, so the profiler's own
    start and end fall outside it."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        while n < MIN_STEPS or (time.perf_counter() - t0 < MIN_SECONDS and n < MAX_STEPS):
            with record_function("bench.step"):
                one_step()
            n += 1
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return reduce(prof.events(), window, n)


def reduce(events, window_s: float, steps: int) -> Trace:
    """A `Trace` from a profiler's events."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type != DeviceType.CUDA:
            host.append(span)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
            dev.append(span)        # a host range mirrored on the device's timeline is no work
    dev.sort()
    ops: dict[str, float] = {}
    merged = []
    for a, b, name in dev:
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + (b - a) * 1e-6
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = name_gaps([(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)], host)
    return Trace(window_s, busy, steps, ops, gaps)


def short_name(name: str) -> str:
    for noise in NAME_NOISE:
        name = name.replace(noise, "")
    return name[:NAME_CHARS]


def name_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by the host activity at each gap's middle: the
    innermost host range there, under the innermost ``bench.*`` range."""
    host = sorted(host)
    out: dict[str, float] = {}
    active: list = []                                 # (end, start, name), by end
    j = 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(active, (host[j][1], host[j][0], host[j][2]))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        inner = min(active, key=lambda x: x[0] - x[1], default=None)
        ours = [x for x in active if x[2].startswith("bench.")]
        outer = min(ours, key=lambda x: x[0] - x[1], default=None)
        parts = [x[2] for x in (outer, inner) if x is not None]
        label = "/".join(dict.fromkeys(parts)) or "no host range"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries as [[name, value], ...]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
