"""The readers of the program's spans on the CPU at a tiny size: the traced
run's profiled steps carry the spans (here under a CPU-only profiler), the
readers count those steps, the set-up's precharacterization is read from
its span, the readers find nothing without a trace or without the recorder,
and each has its file and its entry."""
from __future__ import annotations

import sys
import time
import types

import pytest

import bench_tiny
from bench_tiny import WORKLOADS, harness

NEW = ("fanout_device_ms", "sched_host_ms", "host_idle_ms", "precharacterize_s")


@pytest.fixture(autouse=True)
def recorder_off():
    from repro_torch import spans

    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def cpu_profile(one_step, steps: int = 3):
    """`yardstick.trace.profile_steps` with the CPU's activity alone."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench.yardstick.trace import reduce

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("bench.step"):
                one_step()
        window = time.perf_counter() - t0
    return reduce(prof.events(), window, steps)


def traced_ctx(workload: str, profile=cpu_profile):
    plan = bench_tiny.plan(workload)
    config, traffic = plan["config"], plan["traffic"]
    system = harness.load("systems", config["system"]).build(config, traffic, bench_tiny.SEED,
                                                            "cpu", {})
    loop = harness.load("loops", traffic["loop"]).run(system, traffic, 0.3, {}, profile)
    return types.SimpleNamespace(loop=loop, trace=loop.trace, shapes=system.shapes(),
                                 config=config, traffic=traffic)


def read(name, ctx):
    return harness.load("metrics", name).read(ctx)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_profiled_steps_carry_the_program_spans(workload):
    from bench.yardstick.program_spans import profiled_steps

    ctx = traced_ctx(workload)
    steps, recs = profiled_steps(ctx)
    assert len(steps) == ctx.trace.steps == 3
    assert {r.name for r in recs} >= {"sched.step", "hdc.serve", "ota.fanout"}
    assert all(s.start_ns >= (ctx.loop.t_start + ctx.loop.window_s) * 1e9 for s in steps)
    value = read("sched_host_ms", ctx)
    assert isinstance(value, float) and 0 < value < sum(s.host_ms for s in steps) / 3
    # no device time and no device gaps on the CPU
    assert read("fanout_device_ms", ctx) is None and read("host_idle_ms", ctx) is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_precharacterize_s_reads_the_set_up_span(workload):
    from repro_torch import spans

    ctx = traced_ctx(workload)
    (pre,) = [r for r in spans.records() if r.name == "ota.precharacterize"]
    assert pre.end_ns <= ctx.loop.t_start * 1e9
    value = read("precharacterize_s", ctx)
    assert isinstance(value, float) and value == pytest.approx(pre.host_ms * 1e-3) and value > 0


def test_no_trace_no_reading():
    ctx = traced_ctx(WORKLOADS[0], profile=None)
    assert ctx.trace is None
    for name in NEW:
        assert read(name, ctx) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import repro_torch

    ctx = traced_ctx(WORKLOADS[0])
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)      # import fails
    for name in NEW:
        assert read(name, ctx) is None


def test_fanout_device_ms_sums_the_spans_device_time(monkeypatch):
    from repro_torch import spans

    ctx = traced_ctx(WORKLOADS[0])
    recs = spans.records()
    for r in recs:
        if r.name == "ota.fanout":
            r.device_ms = 2.5
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert read("fanout_device_ms", ctx) == pytest.approx(2.5)


def test_host_idle_ms_takes_the_gaps_under_the_program_spans():
    ctx = traced_ctx(WORKLOADS[0])

    def reading(gaps, busy_s=1.0):
        ctx.trace = types.SimpleNamespace(steps=3, busy_s=busy_s, gaps=gaps)
        return read("host_idle_ms", ctx)

    gaps = {"bench.step/sched.admit": 0.001, "bench.serve/hdc.serve": 0.002,
            "bench.step/ota.fanout": 0.003, "bench.step": 0.5,
            "bench.step/aten::copy_": 0.25, "hdc.serve": 0.0015}
    assert reading(gaps) == pytest.approx(2.5)
    # the program's spans ran, and no gap fell under them: 0, not None
    assert reading({"bench.step": 0.5, "bench.serve": 0.1}) == 0.0
    assert reading(gaps, busy_s=0.0) is None                         # no device trace


def test_each_new_metric_has_a_reader_and_an_entry_on_both_cells():
    entries = {m["name"]: m for m in bench_tiny.spec()["per_layer"]}
    for name in NEW:
        assert callable(harness.load("metrics", name).read)
        assert entries[name]["workloads"] == list(WORKLOADS)
        assert entries[name]["moves"] == (
            "setup_s" if name == "precharacterize_s" else "trials_per_s")
