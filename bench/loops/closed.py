"""The closed loop: a fixed number of clients, each with one request
outstanding, each resubmitting the moment its request completes. A slower
system receives less load; the queue never grows past the client count.

Traffic keys: ``clients`` (client i keeps one request in flight; the system
binds it to a tenant), ``warm_steps`` (steps of the full loop before the
window, counted as set-up).
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class LoopResult:
    t_start: float          # the first timed step's start (perf_counter)
    window_s: float
    steps: int
    done: list              # completions inside the window
    later: list             # completions after it (the profiled steps, the drain)
    spans: dict             # the window's host spans, by name
    unanswered: int         # requests never completed
    trace: object = None    # the profiled steps' summary (yardstick.trace)


DRAIN_S = 60.0              # how long a request may come late after the window


def run(system, traffic: dict, seconds: float, spans: dict, profile=None) -> LoopResult:
    """Warm up, then step for ``seconds`` (the window), then, with
    ``profile``, hand it a one-step callable to trace, then drain."""
    owner: dict[int, int] = {}          # rid -> client
    count = 0

    def submit(client: int) -> None:
        nonlocal count
        owner[system.submit(client, count)] = client
        count += 1

    def one_step(resubmit: bool = True) -> list:
        done = system.step()
        for d in done:
            client = owner.pop(d.rid)
            if resubmit:
                submit(client)
        return done

    for client in range(traffic["clients"]):
        submit(client)
    for _ in range(traffic["warm_steps"]):
        one_step()
    for v in spans.values():
        v.clear()
    window, steps = [], 0
    t0 = time.perf_counter()
    while True:
        done = one_step()
        steps += 1
        window.extend(done)
        if time.perf_counter() - t0 >= seconds:
            break
    # the window closes after the step that crosses ``seconds``, its
    # clients' resubmissions included
    t1 = time.perf_counter()
    window_spans = {k: list(v) for k, v in spans.items()}
    later, trace = [], None
    if profile is not None:
        trace = profile(lambda: later.extend(one_step()))
    t_end = time.perf_counter() + DRAIN_S
    while system.in_flight and time.perf_counter() < t_end:
        later.extend(one_step(resubmit=False))
    return LoopResult(t0, t1 - t0, steps, window, later, window_spans, system.in_flight,
                      trace)
