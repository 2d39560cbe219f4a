"""The port's span recorder: named host spans at the served path's layer
boundaries, device time where a span asks for it, and named counters.

    from repro_torch import spans
    spans.enable()
    ...                       # serve
    print(spans.summary())    # count, host and device ms a step, counters

The spans (`serving.scheduler`, `serving.hdc`, `core.scaleout`):

    sched.step         SlotScheduler.step, the whole call; opens the step id
    sched.admit          the age-fair pick and the backend's admission
    hdc.admit              HDCEngine.admit_many
    hdc.serve            HDCEngine._step_impl, where the host enqueues the serve
    ota.bundle             the over-the-air bundle (device time)
    ota.fanout             the per-slot PHY fan-out and its stack (device time)
    ota.search             the banked top-1 and the global top-1 (device time)
    sched.barrier        HDCScheduler._collect: the host copies and on_barrier
    ota.precharacterize  scaleout.precharacterize_state (set-up, no step)

and the counters ``hdc.slots`` (slots served, ``num_slots`` a step) and
``hdc.slots_live`` (those holding a request).

The recorder records while it is enabled (`enable`) and while a
`torch.profiler` profile runs in the process, so that every profile of the
program carries its layers. Otherwise `span` returns one shared no-op
context manager and `count` returns at once: no allocation, no profiler
range, no CUDA event, no host work a CUDA graph capture could see. A set-up
span (``always=True``: ``ota.precharacterize``, once a process and off the
hot path) records whatever the switch says, so a process's set-up can be
read after the fact.

Recording, a span keeps its name, its start and end on
`time.perf_counter_ns`, its own id and its parent's (from a stack: spans
nest as the calls do), and the scheduler step it belongs to (the ``step``
it was opened with, else its parent's). While a profiler runs it also opens
a profiler range of its name (`_RecordFunctionFast`, about an eighth of
`record_function`'s host cost), so the profiler places it among the
host events of the device trace, on the profiler's clock. A span given a
CUDA ``device`` records a pair of timing events on that device's current
stream; their `elapsed_time`, resolved only when the record is read, is its
device time: from the moment the stream reached the span's start to the
moment it reached its end, so it holds the device's idle inside the span
(the host's launch pace) as well as its kernels, where a trace's union of
kernel intervals holds only the kernels. Enabled, every such span is
timed; under a profiler alone, those of one step in `SAMPLE_NS`. Untimed,
and on the CPU, the device time is None.

The clock anchor is one reading of (`perf_counter_ns`, `time_ns`) taken
together at `enable` (at import before that): with it a record's times
convert to Unix nanoseconds (`unix_ns`), the timeline of a profiler's events
(its ``trace_start_ns()`` plus each event's offset).

The record is held in memory, at most `CAP` spans; beyond the cap the
oldest are dropped and counted (`summary`). One thread records: the stack
is the calling thread's nesting.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch
from torch._C._profiler import _RecordFunctionFast as _FastRange
from torch.autograd import profiler as _profiler

CAP = 1 << 16       # spans held by default
# Under a profiler alone, device time is sampled: the device spans of one
# step in SAMPLE_NS get their events. An event costs ~30 us of host time on
# an H100's host while the profiler traces the CUDA calls, so six a step
# would add ~2% to an 8 ms step.
SAMPLE_NS = 50_000_000


@dataclasses.dataclass
class Span:
    """One recorded span; times on `time.perf_counter_ns`."""

    name: str
    id: int
    parent: int | None
    step: int | None
    start_ns: int
    end_ns: int = 0
    device_ms: float | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _State:
    def __init__(self):
        self.on = False
        self.records: collections.deque = collections.deque(maxlen=CAP)
        self.dropped = 0
        self.counters: dict[str, int] = {}
        self.stack: list[Span] = []
        self.next_id = 0
        self.timed_step = None          # the step whose device spans get events
        self.next_timed_ns = 0
        self.anchor = (time.perf_counter_ns(), time.time_ns())


_st = _State()


class _Live:
    """A recording span (the context manager `span` returns)."""

    __slots__ = ("_name", "_device", "_step", "_rec", "_range", "_stream")

    def __init__(self, name: str, device, step):
        self._name, self._device, self._step = name, device, step

    def __enter__(self):
        st = _st
        parent = st.stack[-1] if st.stack else None
        step = self._step if self._step is not None else (parent and parent.step)
        if self._step is not None:              # a step opens: are its device spans timed?
            now = time.perf_counter_ns()
            if st.on or now >= st.next_timed_ns:
                st.timed_step, st.next_timed_ns = step, now + SAMPLE_NS
        self._range = _FastRange(self._name) if _profiler._is_profiler_enabled else None
        if self._range is not None:
            self._range.__enter__()
        events = None
        dev = self._device
        if (dev is not None and dev.type == "cuda"
                and (st.on or (step is not None and step == st.timed_step))):
            self._stream = torch.cuda.current_stream(dev)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(self._stream)
        self._rec = Span(self._name, st.next_id, parent and parent.id, step,
                         time.perf_counter_ns(), events=events)
        st.next_id += 1
        st.stack.append(self._rec)
        return self._rec

    def __exit__(self, *exc):
        rec, st = self._rec, _st
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record(self._stream)
        if self._range is not None:
            self._range.__exit__(*exc)
        if st.stack and st.stack[-1] is rec:
            st.stack.pop()
        if len(st.records) == st.records.maxlen:
            st.dropped += 1
        st.records.append(rec)
        return False


def span(name: str, device: torch.device | None = None, step: int | None = None,
         always: bool = False):
    """A context manager over one span named ``name``; with a CUDA
    ``device``, its device time too; ``step`` opens a scheduler step (its
    children inherit it); ``always``, a set-up span, records while nothing
    else does. The shared no-op while nothing records."""
    if not (always or _st.on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Live(name, device, step)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while nothing records)."""
    if not (_st.on or _profiler._is_profiler_enabled):
        return
    _st.counters[name] = _st.counters.get(name, 0) + n


def enable() -> None:
    """Start recording afresh: an empty record of at most `CAP` spans, no
    counts, a new clock anchor."""
    global _st
    _st = _State()
    _st.on = True


def disable() -> None:
    """Stop recording (a running profiler still records); the record stays
    readable."""
    _st.on = False


def unix_ns(perf_ns: int) -> int:
    """A `time.perf_counter_ns` reading as Unix nanoseconds, by the anchor."""
    p, u = _st.anchor
    return perf_ns - p + u


def _resolve(rec: Span) -> None:
    if rec.events is not None:
        rec.events[1].synchronize()
        rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
        rec.events = None


def records() -> list[Span]:
    """The finished spans held, oldest first, their device times resolved
    (which waits for the device to pass their ends)."""
    for rec in _st.records:
        _resolve(rec)
    return list(_st.records)


def drain() -> list[Span]:
    """`records`, then forget them, the count of dropped spans, the
    counters and the device time's sampling clock."""
    out = records()
    _st.records.clear()
    _st.dropped = 0
    _st.counters.clear()
    _st.next_timed_ns = 0
    return out


def counters() -> dict[str, int]:
    return dict(_st.counters)


def summary() -> dict:
    """For each span name its count, host ms and device ms in all and a
    step (over the held ``sched.step`` spans; None without one; device ms a
    step from the timed spans' mean, None where none was timed), and the
    counters."""
    recs = records()
    steps = sum(r.name == "sched.step" for r in recs) or None
    out: dict[str, dict] = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0, "device_ms": None, "timed": 0})
        s["count"] += 1
        s["host_ms"] += r.host_ms
        if r.device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
            s["timed"] += 1
    for s in out.values():
        s["host_ms_per_step"] = None if steps is None else s["host_ms"] / steps
        s["device_ms_per_step"] = (None if steps is None or not s["timed"]
                                   else s["device_ms"] / s["timed"] * s["count"] / steps)
    return {"steps": steps, "spans": out, "counters": counters(), "dropped": _st.dropped}
