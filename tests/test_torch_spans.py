"""The port's span recorder (`repro_torch.spans`) on the CPU: the shared
no-op while nothing records, the spans and counters of a small
`HDCScheduler` run with their nesting and step ids, the set-up span,
recording while a profiler runs, the clock anchor against the profiler's
timeline, the cap, and the HDC serve's ``--trace`` report."""
import pytest
import torch

from repro_torch import phy, spans
from repro_torch.core import scaleout
from repro_torch.serving import HDCEngine, HDCScheduler

CFG = scaleout.ScaleOutConfig(n_classes=16, dim=64, m_tx=3, n_rx_cores=4, batch=4,
                              representation="packed", noise="exact")
SLOTS, TENANTS = 3, 2
# every span of a served step and the span it sits in
PARENT = {"sched.step": None, "sched.admit": "sched.step", "hdc.admit": "sched.admit",
          "hdc.serve": "sched.step", "ota.bundle": "hdc.serve", "ota.fanout": "hdc.serve",
          "ota.search": "hdc.serve", "sched.barrier": "sched.step"}


@pytest.fixture(autouse=True)
def recorder_off():
    """The recorder is module state shared by every test of a worker."""
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _scheduler():
    state = phy.state_from_ber(torch.full((CFG.n_rx_cores,), 0.05), CFG.m_tx)
    eng = HDCEngine(CFG, state, num_slots=SLOTS, max_tenants=TENANTS, device="cpu")
    g = torch.Generator().manual_seed(0)
    books = torch.randint(-2 ** 31, 2 ** 31, (TENANTS, CFG.n_classes, CFG.words),
                          generator=g, dtype=torch.int32)
    for t in range(TENANTS):
        eng.registry.onboard(t, books[t])
    return HDCScheduler(eng), books


def _serve(requests: int):
    """Submit ``requests`` requests, run to the end; (scheduler, completions)."""
    sched, books = _scheduler()
    g = torch.Generator().manual_seed(1)
    for i in range(requests):
        cls = torch.randint(0, CFG.n_classes, (CFG.batch, CFG.m_tx), generator=g)
        sched.submit(i % TENANTS, books[i % TENANTS][cls][:, None],
                     generator=torch.Generator().manual_seed(100 + i))
    return sched, sched.run(timeout=60)


def test_off_is_one_shared_noop_and_records_nothing():
    assert spans.span("a") is spans.span("b", torch.device("cpu"), step=3)
    with spans.span("a") as inner:
        assert inner is None
    spans.count("hdc.slots", 8)
    assert spans.records() == [] and spans.counters() == {}


def _watch_ranges_and_events(monkeypatch) -> list:
    made = []
    monkeypatch.setattr(spans, "_FastRange", lambda *a, **k: made.append("range"))
    monkeypatch.setattr(spans._profiler, "record_function",
                        lambda *a, **k: made.append("range"))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append("event"))
    return made


def test_off_the_hot_path_makes_no_range_event_or_record(monkeypatch):
    made = _watch_ranges_and_events(monkeypatch)
    sched, done = _serve(5)
    assert len(done) == 5 and sched.step_id >= 2
    assert made == [] and spans.records() == [] and spans.counters() == {}


def test_on_without_a_profiler_opens_no_range(monkeypatch):
    made = _watch_ranges_and_events(monkeypatch)
    spans.enable()
    _serve(2)
    assert made == [] and len(spans.records()) == len(PARENT)


def test_on_every_span_once_a_step_nested_with_its_step_id():
    spans.enable()
    sched, done = _serve(7)                       # 3 slots: steps of 3, 3, 1 requests
    recs = spans.records()
    by_id = {r.id: r for r in recs}
    steps = [r for r in recs if r.name == "sched.step"]
    first = steps[0].step
    assert [r.step for r in steps] == list(range(first, sched.step_id + 1))
    for step in steps:
        mine = [r for r in recs if r.step == step.step]
        assert sorted(r.name for r in mine) == sorted(PARENT)
        for r in mine:
            want = PARENT[r.name]
            assert (r.parent is None) if want is None else by_id[r.parent].name == want
            assert step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns
            assert r.device_ms is None                       # no device time on the CPU
    assert {c.rid: c.step for c in done.values()} == {
        rid: rid // SLOTS + first for rid in range(7)}
    assert spans.counters() == {"hdc.slots": SLOTS * 3, "hdc.slots_live": 7}
    s = spans.summary()
    assert s["steps"] == 3 and s["spans"]["ota.fanout"]["count"] == 3
    assert s["spans"]["sched.step"]["host_ms_per_step"] > 0
    assert s["spans"]["ota.fanout"]["device_ms_per_step"] is None


def test_step_ids_are_unique_over_schedulers():
    spans.enable()
    a, _ = _serve(4)
    b, _ = _serve(4)
    ids = [r.step for r in spans.records() if r.name == "sched.step"]
    assert len(ids) == len(set(ids)) == 4 and a.step_id < min(ids[2:]) <= b.step_id


def test_precharacterization_is_a_set_up_span_recorded_while_off():
    scaleout.precharacterize_state(scaleout.ScaleOutConfig(n_rx_cores=4), device="cpu")
    (rec,) = spans.records()
    assert rec.name == "ota.precharacterize" and rec.step is None and rec.host_ms > 0
    assert spans.span("ota.precharacterize") is spans.span("x")      # only the set-up call


def test_a_running_profiler_records_and_places_the_spans_by_the_anchor():
    from torch.profiler import ProfilerActivity, profile

    sched, _ = _scheduler()
    books = sched.engine.registry.store
    sched.submit(0, books[0][:CFG.batch * CFG.m_tx].reshape(CFG.batch, 1, CFG.m_tx, -1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sched.step()
    (rec,) = [r for r in spans.records() if r.name == "sched.step"]
    (ev,) = [e for e in prof.events() if e.name == "sched.step"]
    prof_ns = prof.profiler.kineto_results.trace_start_ns() + ev.time_range.start * 1e3
    assert abs(spans.unix_ns(rec.start_ns) - prof_ns) < 1e6            # within 1 ms
    assert {e.name for e in prof.events()} >= set(PARENT)
    n = len(spans.records())
    sched.step()                                                       # profiler gone
    assert len(spans.records()) == n


def test_device_time_enabled_always_and_sampled_under_a_profiler_alone(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    class Event:                                   # a CUDA timing event, 1.5 ms apart
        def __init__(self, **kw):
            pass

        def record(self, stream=None):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 1.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    cuda = torch.device("cuda")

    def fanout_ms(steps, first):
        for k in range(first, first + steps):
            with spans.span("sched.step", step=k):
                with spans.span("ota.fanout", cuda):
                    pass
        return [r.device_ms for r in spans.drain() if r.name == "ota.fanout"]

    monkeypatch.setattr(spans, "SAMPLE_NS", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        assert fanout_ms(3, 1) == [1.5] * 3
    monkeypatch.setattr(spans, "SAMPLE_NS", 10 ** 12)
    with profile(activities=[ProfilerActivity.CPU]):
        assert fanout_ms(4, 4) == [1.5, None, None, None]      # one step in SAMPLE_NS
        fanout_ms(2, 8)
        with spans.span("ota.fanout", cuda):                  # outside any step
            pass
    (rec,) = spans.drain()
    assert rec.device_ms is None
    spans.enable()
    assert fanout_ms(3, 10) == [1.5] * 3                      # enabled, every span
    fanout_ms(2, 13)
    spans.disable()
    with profile(activities=[ProfilerActivity.CPU]):
        fanout_ms(1, 20)
        for k in (21, 22):
            with spans.span("sched.step", step=k):
                with spans.span("ota.fanout", cuda):
                    pass
    s = spans.summary()                  # device ms a step from the timed spans' mean
    assert s["spans"]["ota.fanout"]["count"] == 2
    assert s["spans"]["ota.fanout"]["device_ms_per_step"] == pytest.approx(1.5)


def test_the_cap_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 4)
    spans.enable()
    for i in range(6):
        with spans.span(f"s{i}"):
            pass
    assert [r.name for r in spans.records()] == ["s2", "s3", "s4", "s5"]
    assert spans.summary()["dropped"] == 2
    assert [r.name for r in spans.drain()] == ["s2", "s3", "s4", "s5"]
    assert spans.records() == [] and spans.summary()["dropped"] == 0


def test_the_hdc_serve_trace_report(capsys):
    from repro_torch.launch import serve as launch_serve

    res = launch_serve.main(["--hdc", "--trace", "--device", "cpu", "--requests", "6",
                             "--rate", "5000", "--slots", "2", "--tenants", "2",
                             "--classes", "16", "--dim", "64"])
    out = capsys.readouterr().out
    assert len(res) == 6 and "dropped): count, host ms a step" in out
    for name in PARENT:
        assert f"  {name} " in out
    assert "slot occupancy" in out
    slow = max(res.values(), key=lambda c: c.latency)
    assert f"slowest request {slow.rid}: " in out and f"served in step {slow.step} " in out
    assert "ota.fanout " in out.split("slowest request")[1]
