"""HDC-as-a-service in the port (repro_torch.serving, the multi-tenant serve
of repro_torch.core.scaleout) against the JAX reference at the reference
tests' size: 40 classes over 4 cores, d = 512, M = 3, batch 8.

`make_mt_ota_serve` must equal JAX's bit for bit (pred and maxsim) on the
ideal tier, on JAX's own per-slot bsc masks replayed through a slot-aware
registered tier, and on the coarse path; and each slot of the port's
multi-tenant serve must equal the port's standalone serve on a generator
seeded alike. The link controller is fed the same process states in both
packages and must leave the same trace."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_mesh
from repro import phy as jphy
from repro.core import classifier as jclf, hypervector as jhv, scaleout as jscale
from repro.serving import LinkController as JLinkController
from repro.serving import LinkControllerConfig as JLinkControllerConfig
from repro_torch import convert, faults as tfaults, phy as tphy
from repro_torch.core import classifier as tclf, hypervector as thv, scaleout as tscale
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import (AdaptiveHDCEngine, HDCEngine, HDCScheduler, LinkController,
                                 LinkControllerConfig, SlotRingEngine, TenantRegistry,
                                 slot_update)

CPU = "cpu"
BASE = dict(n_classes=40, dim=512, m_tx=3, n_rx_cores=4, batch=8)
MODES = [(False, "unpacked"), (False, "packed"), (True, "unpacked"), (True, "packed")]
BER = np.array([0.0, 0.05, 0.1, 0.2], np.float32)
ROWS = np.array([2, 0, 2], np.int32)          # slots 0 and 2 share tenant 2


def _cfgs(**kw):
    j = jscale.ScaleOutConfig(**BASE, use_kernels=False, noise="exact", **kw)
    t = tscale.ScaleOutConfig(**BASE, noise="exact", **kw)
    return j, t


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def books():
    """Three tenant codebooks [3, C, d] uint8 made by JAX."""
    tcfg = jclf.HDCTaskConfig(n_classes=BASE["n_classes"], dim=BASE["dim"])
    return np.asarray(jclf.make_tenant_codebooks(jax.random.PRNGKey(0), tcfg, 3))


@pytest.fixture(scope="module")
def sym_state():
    """The port's precharacterized 4-RX state (the symbol tier's physics)."""
    return tscale.precharacterize_state(tscale.ScaleOutConfig(**BASE), device=CPU)


def _words(a, packed):
    return np.asarray(jhv.pack(jnp.asarray(a))) if packed else np.asarray(a)


def _t(a):
    return convert.hv_from_numpy(np.asarray(a), CPU)


def _eq(port, ref):
    np.testing.assert_array_equal(convert.to_numpy(port), np.asarray(ref))


def _mt_inputs(jcfg, books, rows=ROWS):
    """(store, queries [N, B, 1, M, d|W]) as numpy, each slot's queries drawn
    by JAX from its tenant's codebook."""
    store = np.stack([_words(b, jcfg.packed) for b in books])
    qs = np.stack([np.asarray(jscale.make_queries(jax.random.PRNGKey(50 + s), jcfg,
                                                  jnp.asarray(books[r]), 1)[1])
                   for s, r in enumerate(rows)])
    return store, qs


def _keys(n):
    return jnp.stack([jax.random.PRNGKey(100 + s) for s in range(n)])


def _gens(n):
    return [torch.Generator().manual_seed(100 + s) for s in range(n)]


def _jax_masks(key, ber, batch, dim):
    """The masks JAX's bsc tier draws for one slot on a (1, 1) mesh: core i
    flips with bernoulli(fold_in(fold_in(key, dpos=0), i), ber[i], [B, d])."""
    kq = jax.random.fold_in(key, 0)
    return np.stack([
        np.asarray(jax.random.bernoulli(jax.random.fold_in(kq, i), jnp.float32(b),
                                        (batch, dim)), np.uint8)
        for i, b in enumerate(ber)])


class SlotReplayChannel(tphy.Channel):
    """The slot-aware variant of test_torch_scaleout.py's ReplayChannel:
    masks drawn beforehand by JAX, one [n_cores, B, d] set a slot, picked by
    the slot's generator's ``initial_seed()``."""

    name = "bsc_slot_replay"
    wire = "votes"

    def __init__(self, masks: dict):
        self.masks = masks

    def rx_copies(self, generator, reduced, state, rx_base, n_cores,
                  *, packed, dim, noise, planes=16):
        m = self.masks[generator.initial_seed()][rx_base:rx_base + n_cores]
        return reduced[None] ^ (thv.pack(m) if packed else m)


@pytest.fixture
def replay():
    """Register JAX's per-slot bsc masks for the generators of `_gens`."""
    masks = {100 + s: torch.from_numpy(_jax_masks(jax.random.PRNGKey(100 + s), BER,
                                                  BASE["batch"], BASE["dim"]))
             for s in range(len(ROWS))}
    tphy.register_channel(SlotReplayChannel(masks), override=True)
    yield SlotReplayChannel.name
    tphy.CHANNELS.pop(SlotReplayChannel.name)


def _both_mt(mesh, books, jcfg, tcfg):
    """(JAX mt serve, port mt serve) on the same store, queries, rows and BER."""
    store, qs = _mt_inputs(jcfg, books)
    jstate = jphy.state_from_ber(jnp.asarray(BER), 3)
    ref = jscale.make_mt_ota_serve(mesh, jcfg)(jnp.asarray(store), jnp.asarray(qs),
                                               jnp.asarray(ROWS), jstate, _keys(len(ROWS)))
    tstate = tphy.state_from_ber(torch.from_numpy(BER), 3)
    got = tscale.make_mt_ota_serve(tcfg, device=CPU)(_t(store), _t(qs), torch.from_numpy(ROWS),
                                                     tstate, _gens(len(ROWS)))
    return got, ref


@pytest.mark.parametrize("permuted,rep", MODES)
def test_mt_serve_ideal_matches_jax(mesh, books, permuted, rep):
    jcfg, tcfg = _cfgs(permuted=permuted, representation=rep, channel="ideal")
    (pred, sim), (jpred, jsim) = _both_mt(mesh, books, jcfg, tcfg)
    assert pred.dtype == torch.int32 and sim.dtype == torch.float32
    assert tuple(pred.shape) == (len(ROWS), BASE["batch"]) + ((3,) if permuted else ())
    _eq(pred, jpred)
    _eq(sim, jsim)


@pytest.mark.parametrize("permuted,rep", MODES)
def test_mt_serve_bsc_on_jax_slot_masks_matches_jax(mesh, books, replay, permuted, rep):
    jcfg, tcfg = _cfgs(permuted=permuted, representation=rep)
    (pred, sim), (jpred, jsim) = _both_mt(mesh, books, jcfg,
                                          dataclasses.replace(tcfg, channel=replay))
    _eq(pred, jpred)
    _eq(sim, jsim)
    # the noise mattered: the ideal serve answers differently somewhere
    ideal = _both_mt(mesh, books, *_cfgs(permuted=permuted, representation=rep,
                                         channel="ideal"))[0]
    assert not (torch.equal(ideal[0], pred) and torch.equal(ideal[1], sim))


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_mt_serve_coarse_matches_jax(mesh, books, replay, rep):
    """c_core = 10 in groups of 2 (5 summaries), 2 kept: a real screen."""
    jcfg, tcfg = _cfgs(representation=rep, coarse_group=2, coarse_keep=2)
    (pred, sim), (jpred, jsim) = _both_mt(mesh, books, jcfg,
                                          dataclasses.replace(tcfg, channel=replay))
    _eq(pred, jpred)
    _eq(sim, jsim)


def _port_state(channel, sym_state):
    if channel == "symbol":
        return sym_state
    return tphy.state_from_ber(torch.from_numpy(BER), 3)


@pytest.mark.parametrize("permuted", [False, True], ids=["baseline", "permuted"])
@pytest.mark.parametrize("rep", ["unpacked", "packed"])
@pytest.mark.parametrize("channel", ["bsc", "symbol"])
def test_mt_serve_equals_the_standalone_serve_slot_by_slot(books, sym_state, channel, rep,
                                                           permuted):
    jcfg, tcfg = _cfgs(permuted=permuted, representation=rep, channel=channel)
    state = _port_state(channel, sym_state)
    store, qs = _mt_inputs(jcfg, books)
    pred, sim = tscale.make_mt_ota_serve(tcfg, device=CPU)(
        _t(store), _t(qs), torch.from_numpy(ROWS), state, _gens(len(ROWS)))
    serve = tscale.make_ota_serve(tcfg, device=CPU)
    for s, (r, g) in enumerate(zip(ROWS, _gens(len(ROWS)))):
        wp, ws = serve(_t(store[r]), _t(qs[s]), state, g)
        assert torch.equal(pred[s], wp) and torch.equal(sim[s], ws), s


def test_mt_serve_process_form_is_the_static_serve_under_static_process(books, sym_state):
    _, tcfg = _cfgs(channel="symbol", representation="packed")
    jcfg, _ = _cfgs(representation="packed")
    store, qs = _mt_inputs(jcfg, books)
    args = (_t(store), _t(qs), torch.from_numpy(ROWS))
    want = tscale.make_mt_ota_serve(tcfg, device=CPU)(*args, sym_state, _gens(3))
    proc = tphy.StaticProcess()
    pserve = tscale.make_mt_ota_serve(tcfg, device=CPU, process=proc)
    pred, sim, p2 = pserve(*args, proc.init(sym_state), _gens(3), None)
    assert torch.equal(pred, want[0]) and torch.equal(sim, want[1]) and int(p2.t) == 1
    # quarantine core 0: no slot answers from its class range any more
    quar = tphy.set_quarantine(proc.init(sym_state), torch.arange(4) == 0)
    closed = pserve(*args, quar, _gens(3), None)[0]
    assert (want[0] < 10).any() and not (closed < 10).any()


def test_mt_serve_refusals(books):
    for rep in ("sparse", "auto"):
        cfg = tscale.ScaleOutConfig(**BASE, representation=rep, k_max=16)
        with pytest.raises(ValueError, match="does not support the sparse"):
            tscale.make_mt_ota_serve(cfg, device=CPU)
        with pytest.raises(ValueError, match="does not support the sparse"):
            jscale.make_mt_ota_serve(make_test_mesh((1, 1), ("data", "model")),
                                     jscale.ScaleOutConfig(**BASE, representation=rep,
                                                           k_max=16))
    _, tcfg = _cfgs(representation="packed")
    store = torch.zeros((2, 40, 16), dtype=torch.int32)
    q = torch.zeros((1, 8, 1, 3, 16), dtype=torch.int32)
    state = tphy.state_from_ber(torch.zeros(4), 3)
    fserve = tscale.make_mt_ota_serve(tcfg, device=CPU, faults=tfaults.StaticFaults())
    with pytest.raises(ValueError, match="fault state"):
        fserve(store, q, torch.zeros(1, dtype=torch.int32), state, _gens(1),
               tfaults.healthy_state(8, 3, 16, CPU), None)
    serve = tscale.make_mt_ota_serve(tcfg, device=CPU)
    with pytest.raises(ValueError, match="rows"):
        serve(store, q, torch.zeros(1, dtype=torch.int64), state, _gens(1))
    with pytest.raises(ValueError, match="generators"):
        serve(store, q, torch.zeros(1, dtype=torch.int32), state, _gens(2))
    with pytest.raises(TypeError):
        serve(store.to(torch.uint8), q, torch.zeros(1, dtype=torch.int32), state, _gens(1))


def test_tenant_codebooks_are_standalone_codebooks():
    tcfg = tclf.HDCTaskConfig(n_classes=40, dim=512)
    books = tclf.make_tenant_codebooks([torch.Generator().manual_seed(t) for t in range(3)],
                                       tcfg, device=CPU)
    assert books.dtype == torch.uint8 and tuple(books.shape) == (3, 40, 512)
    for t in range(3):
        assert torch.equal(books[t], tclf.make_codebook(torch.Generator().manual_seed(t), tcfg,
                                                        device=CPU))
    assert not torch.equal(books[0], books[1])


def test_slot_update_copies_and_never_aliases():
    state = {"q": torch.zeros((3, 2, 4), dtype=torch.int32), "g": [None] * 3}
    buf = torch.ones((1, 2, 4), dtype=torch.int32)
    gen = torch.Generator()
    out = slot_update(state, {"q": buf, "g": [gen]}, [1])
    assert out is state and out["g"][1] is gen
    buf.fill_(7)                                   # the caller reuses its buffer
    assert (state["q"][1] == 1).all() and (state["q"][[0, 2]] == 0).all()
    slot_update(state, {"q": [[[2] * 4] * 2, [[3] * 4] * 2], "g": [None, gen]}, [2, 0])
    assert state["q"][:, 0, 0].tolist() == [3, 1, 2]
    assert state["g"] == [gen, gen, None]
    with pytest.raises(ValueError, match="num_slots"):
        SlotRingEngine(0)


# ---------------------------------------------------------------------------
# the engine, the registry and the scheduler
# ---------------------------------------------------------------------------

def _protos(cfg, book):
    return thv.pack(_t(book)) if cfg.packed else _t(book)


def _query(cfg, book, seed):
    return tscale.make_queries(torch.Generator().manual_seed(seed), cfg, _t(book))[1]


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
@pytest.mark.parametrize("channel", ["bsc", "symbol"])
def test_tenant_lifecycle_identity(books, sym_state, channel, rep):
    """admit -> serve -> evict -> re-admit onto a DIFFERENT store row stays
    equal to a fresh standalone serve on a generator seeded alike."""
    _, cfg = _cfgs(representation=rep, channel=channel)
    state = _port_state(channel, sym_state)
    serve = tscale.make_ota_serve(cfg, device=CPU)
    eng = HDCEngine(cfg, state, num_slots=2, max_tenants=4, device=CPU)
    sched = HDCScheduler(eng)
    for t in range(2):
        eng.registry.onboard(t, _protos(cfg, books[t]))
    row0_before = eng.registry.rows[0]

    def check(tenant, seed):
        q = _query(cfg, books[tenant], seed)
        rid = sched.submit(tenant, q, generator=torch.Generator().manual_seed(1000 + seed))
        sched.run(timeout=600)
        got = sched.poll(rid)
        pr, si = serve(_protos(cfg, books[tenant]), q, state,
                       torch.Generator().manual_seed(1000 + seed))
        np.testing.assert_array_equal(got.pred, pr.numpy())
        np.testing.assert_array_equal(got.maxsim, si.numpy())
        assert got.status == "ok" and got.latency >= 0

    check(0, 7)
    check(1, 8)
    eng.registry.evict(0)
    eng.registry.onboard(2, _protos(cfg, books[2]))
    eng.registry.onboard(0, _protos(cfg, books[0]))   # re-admit: a new row
    assert eng.registry.rows[0] != row0_before
    check(0, 9)
    check(2, 10)


def test_scheduler_interleaves_tenants_and_drains(books):
    """R requests over S slots drain in ceil(R/S) steps with tenants mixed in
    one step; the registry's and the scheduler's guard rails raise the
    reference's messages."""
    _, cfg = _cfgs(representation="packed")
    state = tphy.state_from_ber(torch.zeros(4), 3)
    eng = HDCEngine(cfg, state, num_slots=2, max_tenants=2, device=CPU)
    sched = HDCScheduler(eng)
    eng.registry.onboard("a", _protos(cfg, books[0]))
    eng.registry.onboard("b", _protos(cfg, books[1]))
    q = _query(cfg, books[0], 3)
    rids = [sched.submit("a" if i % 2 == 0 else "b", q) for i in range(5)]
    res = sched.run(timeout=600)
    assert len(res) == 5 and sched.steps == 3         # ceil(5/2)
    assert all(sched.poll(r).pred.shape == (cfg.batch,) for r in rids)
    assert all(isinstance(sched.poll(r).pred, np.ndarray) for r in rids)
    # every slot holds the placeholder generator again after its step
    assert all(g is eng._placeholder for g in sched.state["generator"])
    with pytest.raises(ValueError, match="already onboarded"):
        eng.registry.onboard("a", _protos(cfg, books[0]))
    with pytest.raises(ValueError, match="registry full"):
        eng.registry.onboard("c", _protos(cfg, books[0]))
    with pytest.raises(ValueError, match="not onboarded"):
        sched.submit("nope", q)
    with pytest.raises(ValueError, match="not onboarded"):
        eng.registry.evict("nope")
    eng.registry.evict("a")
    with pytest.raises(ValueError, match="must be"):
        eng.registry.onboard("a", _protos(cfg, books[0])[:10])
    with pytest.raises(ValueError, match="must be"):
        eng.registry.onboard("a", _t(books[0]))       # unpacked bits into a packed store
    eng.registry.onboard("a", _protos(cfg, books[0]))
    # admission checks the queries' dtype and shape
    sched.submit("a", thv.unpack(q, cfg.dim))
    with pytest.raises(ValueError, match="queries must be"):
        sched.run(timeout=600)
    sched = HDCScheduler(eng)
    # a request queued for a tenant evicted before admission fails loudly
    sched.submit("a", q)
    eng.registry.evict("a")
    with pytest.raises(RuntimeError, match="evicted"):
        sched.run(timeout=600)


def test_deadline_eviction_requeues_then_fails(books):
    """A scheduler whose slots never finish: ungated it can only time out;
    with max_slot_steps each request is evicted, requeued once, evicted
    again and failed with status "evicted", and the queue drains."""
    import itertools

    class NeverScheduler(HDCScheduler):
        def _collect(self, emitted):
            self.engine.on_barrier()
            return []                     # nothing ever finishes normally

    class EvictLog(HDCEngine):
        def on_evict(self, slot):
            self.evicted.append(slot)

    def fake_clock(counter=itertools.count()):
        return float(next(counter))

    _, cfg = _cfgs(representation="packed")
    state = tphy.state_from_ber(torch.zeros(4), 3)
    eng = EvictLog(cfg, state, num_slots=2, max_tenants=1, device=CPU)
    eng.evicted = []
    eng.registry.onboard(0, _protos(cfg, books[0]))
    q = _query(cfg, books[0], 3)
    leaky = NeverScheduler(eng, fake_clock)
    leaky.submit(0, q)
    with pytest.raises(TimeoutError, match="did not drain"):
        leaky.run(timeout=50.0)
    assert 0 in leaky.running and 0 not in leaky.free
    with pytest.raises(ValueError, match="max_slot_steps"):
        NeverScheduler(eng, fake_clock, max_slot_steps=0)
    sched = NeverScheduler(eng, fake_clock, max_slot_steps=3, max_requeues=1)
    rids = [sched.submit(0, q), sched.submit(0, q)]
    results = sched.run(timeout=10_000.0)
    assert sorted(results) == rids
    assert all(results[r].status == "evicted" and results[r].pred.shape == (0,) for r in rids)
    assert sched.steps == 6 and len(eng.evicted) == 4
    assert not sched.running and sorted(sched.free) == [0, 1]


def test_admit_many_scatters_every_free_slot_at_once(books):
    _, cfg = _cfgs(representation="packed")
    eng = HDCEngine(cfg, tphy.state_from_ber(torch.zeros(4), 3), num_slots=4, max_tenants=2,
                    device=CPU)
    for t in range(2):
        eng.registry.onboard(t, _protos(cfg, books[t]))
    state = eng.init_state()
    qs = [_query(cfg, books[t], 20 + t) for t in range(2)]
    gens = _gens(2)
    out = eng.admit_many(state, qs, [1, 0], [3, 1], gens)
    assert out is state
    assert torch.equal(state["queries"][3], qs[0]) and torch.equal(state["queries"][1], qs[1])
    assert state["row"].tolist() == [0, 0, 0, 1]
    assert state["generator"][3] is gens[0] and state["generator"][0] is eng._placeholder
    qs[0].fill_(0)                                    # a copy, not an alias
    assert not torch.equal(state["queries"][3], qs[0])
    eng.admit_many(state, [qs[1]], [1], [0], [gens[1]])
    assert state["row"][0] == 1 and torch.equal(state["queries"][0], qs[1])
    with pytest.raises(ValueError, match="not onboarded"):
        eng.admit_many(state, [qs[1]], [7], [2], [gens[1]])
    with pytest.raises(ValueError, match="queries must be"):
        eng.admit_many(state, [qs[1][:4]], [1], [2], [gens[1]])


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA rule cannot show here")
    _, cfg = _cfgs(representation="packed")
    state = tphy.state_from_ber(torch.zeros(4), 3)
    builds = [lambda: HDCEngine(cfg, state, num_slots=1, max_tenants=1),
              lambda: TenantRegistry(cfg, 1),
              lambda: tscale.make_mt_ota_serve(cfg),
              lambda: AdaptiveHDCEngine(cfg, state, process=tphy.StaticProcess(), num_slots=1,
                                        max_tenants=1),
              lambda: tclf.make_tenant_codebooks([torch.Generator()], tclf.HDCTaskConfig()),
              lambda: launch_serve.main(["--hdc"])]
    for build in builds:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_launch_serve_hdc_on_the_cpu(capsys):
    res = launch_serve.main(["--hdc", "--device", "cpu", "--requests", "6", "--rate", "5000",
                             "--slots", "4", "--classes", "64"])
    out = capsys.readouterr().out
    assert len(res) == 6 and all(c.status == "ok" for c in res.values())
    assert "trials/s" in out and "p50" in out and "p95" in out and "max" in out
    res = launch_serve.main(["--hdc", "--device", "cpu", "--requests", "3", "--rate", "5000",
                             "--slots", "2", "--classes", "64", "--unpacked"])
    assert all(c.pred.shape == (4,) for c in res.values())


# ---------------------------------------------------------------------------
# living channels: the link controller and the adaptive engine
# ---------------------------------------------------------------------------

def _ctl_states(sym_state, est_bad, est_good=None):
    """(JAX, port) pairs of StaticProcess states on the 4-RX physics: ``bad``
    with junk symbols (every re-fit fails) and estimate ``est_bad``, ``good``
    with the characterized symbols and estimate ``est_good``."""
    jstate = jphy.ChannelState(*(jnp.asarray(a) for a in convert.to_numpy(sym_state).values()))
    jp = jphy.StaticProcess(guard_dims=8).init(jstate)
    junk = jax.random.normal(jax.random.PRNGKey(0), jp.chan.symbols.shape,
                             jnp.float32).astype(jnp.complex64)
    j_bad = dataclasses.replace(jp, chan=dataclasses.replace(jp.chan, symbols=junk),
                                est=jnp.asarray(est_bad))
    j_good = dataclasses.replace(jp, est=jnp.asarray(est_good if est_good is not None
                                                     else est_bad))

    def port(p):
        leaves = {f: np.asarray(getattr(p, f)) for f in tphy.ProcessState.FIELDS if f != "chan"}
        leaves["chan"] = {f: np.asarray(getattr(p.chan, f)) for f in tphy.ChannelState.FIELDS}
        return convert.pstate_from_numpy(leaves, CPU)

    return jp, port(jp), (j_bad, port(j_bad)), (j_good, port(j_good))


def _drive(jp, tp, seq, **cc):
    """Run both controllers over the same sequence of (JAX, port) states;
    their traces, quarantine masks and fleet modes must agree at every step."""
    jctl = JLinkController(JLinkControllerConfig(**cc), jp)
    tctl = LinkController(LinkControllerConfig(**cc), tp)
    for j, t in seq:
        _, jsw = jctl.act(j)
        _, tsw = tctl.act(t)
        assert jsw == tsw
        assert tctl.quarantined.tolist() == jctl.quarantined.tolist()
        assert tctl.degraded == jctl.degraded
        assert tctl.trace == jctl.trace
    return tctl


HI = np.full(4, 0.45, np.float32)


def test_link_controller_hysteresis_no_flap(sym_state):
    jp, tp, bad, good = _ctl_states(sym_state, HI)
    ctl = _drive(jp, tp, [bad] * 6 + [good] * 6, patience=1, quarantine_after=2,
                 release_after=2, drop_frac=0.5, band_kwargs={"cap": 0.05})
    acts = [e["action"] for e in ctl.trace]
    assert acts.count("quarantine") == 1 and acts.count("release") == 1
    assert acts.count("m_drop") == 1 and acts.count("m_restore") == 1
    assert not ctl.quarantined.any() and not ctl.degraded


def test_link_controller_quarantine_and_release_thresholds_exact(sym_state):
    jp, tp, bad, good = _ctl_states(sym_state, HI)
    cc = dict(patience=1, quarantine_after=3, release_after=2, drop_frac=2.0,
              band_kwargs={"cap": 0.05})
    ctl = _drive(jp, tp, [bad] * 2, **cc)
    assert not ctl.quarantined.any()                  # one short of the threshold
    ctl = _drive(jp, tp, [bad] * 3, **cc)
    assert ctl.quarantined.all()                      # exactly at quarantine_after
    ctl = _drive(jp, tp, [bad] * 3 + [good], **cc)
    assert ctl.quarantined.all()
    ctl = _drive(jp, tp, [bad] * 3 + [good] * 2, **cc)
    assert not ctl.quarantined.any() and not ctl.degraded


@pytest.mark.parametrize("above", [0.0, 0.01])
def test_link_controller_drop_frac_boundary_is_inclusive(sym_state, above):
    est = np.zeros(4, np.float32)
    est[0] = 0.45                                     # only row 0 out of band
    jp, tp, bad, _ = _ctl_states(sym_state, est)
    ctl = _drive(jp, tp, [bad], patience=1, quarantine_after=1, drop_frac=0.25 + above,
                 band_kwargs={"cap": 0.05})
    assert ctl.quarantined.tolist() == [True, False, False, False]
    assert ctl.degraded == (above == 0.0)


def test_link_controller_no_flap_under_oscillating_refits(sym_state):
    jp, tp, bad, good = _ctl_states(sym_state, HI)
    ctl = _drive(jp, tp, [bad, good] * 5, patience=1, quarantine_after=2, release_after=2,
                 drop_frac=2.0, band_kwargs={"cap": 0.05})
    assert not ctl.quarantined.any() and not ctl.degraded
    assert not any(e["action"] in ("quarantine", "release", "m_drop") for e in ctl.trace)


def test_adaptive_engine_static_process_is_the_static_engine(books, sym_state):
    _, cfg = _cfgs(channel="symbol")
    engines = (HDCEngine(cfg, sym_state, num_slots=2, max_tenants=2, device=CPU),
               AdaptiveHDCEngine(cfg, sym_state, process=tphy.StaticProcess(guard_dims=16),
                                 num_slots=2, max_tenants=2, device=CPU,
                                 controller=LinkControllerConfig(band_kwargs={"cap": 0.05})))
    results = []
    for eng in engines:
        sched = HDCScheduler(eng)
        for t in range(2):
            eng.registry.onboard(t, _protos(cfg, books[t]))
        rids = [sched.submit(r % 2, _query(cfg, books[r % 2], 50 + r),
                             generator=torch.Generator().manual_seed(100 + r))
                for r in range(4)]
        sched.run(timeout=600)
        results.append([(sched.results[r].pred, sched.results[r].maxsim) for r in rids])
    for (a, sa), (b, sb) in zip(*results):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa, sb)
    adaptive = engines[1]
    assert int(adaptive.pstate.t) == 2                # 4 requests / 2 slots
    assert adaptive.controller.trace == []


def test_adaptive_engine_fleet_switch_builds_each_variant_once(books, sym_state):
    """On the vote wire the fleet degrade path (quarantined fraction past
    drop_frac) switches to the (m_floor, collective) variant, built once and
    reused on every later switch; serving never stalls."""
    builds = []

    class Counting(AdaptiveHDCEngine):
        def _build_serve(self, cfg):
            builds.append((cfg.m_act, cfg.collective))
            return super()._build_serve(cfg)

    _, cfg = _cfgs(channel="bsc")
    eng = Counting(cfg, sym_state, num_slots=1, max_tenants=1, device=CPU,
                   process=tphy.PhaseDriftProcess(sigma=0.5, alpha=0.7, guard_dims=64),
                   process_generators=tphy.process_generators(3, CPU),
                   controller=LinkControllerConfig(patience=1, quarantine_ber=-1.0,
                                                   quarantine_after=1, release_ber=-1.0,
                                                   drop_frac=0.25, band_kwargs={"cap": 0.02}))
    sched = HDCScheduler(eng)
    eng.registry.onboard(0, _protos(cfg, books[0]))
    for r in range(8):
        sched.submit(0, _query(cfg, books[0], 50 + r))
        sched.run(timeout=600)
    acts = [e["action"] for e in eng.controller.trace]
    assert "quarantine" in acts and "m_drop" in acts and "link_mode" in acts
    assert sorted(eng._variants) == [(1, "psum"), (3, "psum")]
    for degraded in (False, True, False, True):
        eng._apply_fleet_mode(degraded)
    assert sorted(builds) == [(1, "psum"), (3, "psum")]
    assert len(sched.results) == 8
    # the alternative collective: the degraded variant is (m_floor, "rs_ag"),
    # which on one rank answers as the psum variant does, bit for bit
    alt = Counting(cfg, sym_state, process=tphy.StaticProcess(), num_slots=1,
                   max_tenants=1, device=CPU,
                   controller=LinkControllerConfig(alt_collective="rs_ag"))
    alt._apply_fleet_mode(True)
    assert builds[-1] == (1, "rs_ag") and alt.controller.trace[-1]["collective"] == "rs_ag"
    store, q = _protos(cfg, books[0])[None], _query(cfg, books[0], 50)[None]
    outs = [serve(store, q, torch.zeros(1, dtype=torch.int32), alt.pstate,
                  [torch.Generator().manual_seed(5)], alt.process_generators)[:2]
            for serve in (alt._variants[(1, "rs_ag")],
                          alt._build_serve(dataclasses.replace(cfg, m_active=1)))]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
