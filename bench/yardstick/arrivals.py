"""Arrival orders and latency percentiles for open loops (frozen from the
port's chip smoke, `poisson_race` and `latency_pcts`). No cell uses them
yet: the open loop of the paper point is left for a later cell."""
from __future__ import annotations

import numpy as np


def poisson_race(n_requests: int, tenants: int, seed: int = 0) -> list[int]:
    """The tenant of each arrival: the argmin of the tenants' next-event
    times under seeded exponential inter-arrivals."""
    rng = np.random.default_rng(seed)
    nxt = rng.exponential(1.0, tenants)
    trace = []
    for _ in range(n_requests):
        t = int(np.argmin(nxt))
        trace.append(t)
        nxt[t] += rng.exponential(1.0)
    return trace


def latency_pcts(lat: list) -> dict:
    """p50, p95 and the maximum of latencies in seconds, as ms."""
    a = np.asarray(lat)
    return dict(p50_ms=float(np.percentile(a, 50) * 1e3),
                p95_ms=float(np.percentile(a, 95) * 1e3), max_ms=float(a.max() * 1e3))
