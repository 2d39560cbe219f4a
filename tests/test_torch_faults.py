"""Fault injection in the port (repro_torch.faults, the fault branches of
repro_torch.core.scaleout, the fault controller and engine of
repro_torch.serving) against the JAX reference at the reference tests'
size: 40 classes over 4 cores, d = 512, M = 3, batch 8.

JAX serves on a (1, 1) mesh through its ``use_kernels=False`` path. The
two packages draw from different generators, so JAX's fault states cross
through numpy (`convert.fstate_from_numpy`), its BSC masks and symbol-tier
normals are replayed through registered tiers, and its fault models' and
samplers' draws are fed through the port's ``draws=``/``masks=`` seams.
Predictions, maxsim, fault states and controller traces must match bit for
bit; the symbol tier's re-fit centroids (complex64 sums over the
constellation, summed in another order) within a relative 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_mesh
from repro import faults as jfaults, phy as jphy
from repro.core import classifier as jclf, hypervector as jhv, ota as jota
from repro.core import scaleout as jscale
from repro.phy.process import row_keys
from repro.serving import FaultController as JFaultController
from repro.serving import FaultControllerConfig as JFaultControllerConfig
from repro_torch import convert, faults as tfaults, phy as tphy
from repro_torch.core import hypervector as thv, ota as tota, scaleout as tscale
from repro_torch.serving import (AdaptiveHDCEngine, FaultController, FaultControllerConfig,
                                 FaultTolerantHDCEngine, HDCScheduler, LinkControllerConfig)

CPU = "cpu"
BASE = dict(n_classes=40, dim=512, m_tx=3, n_rx_cores=4, batch=8)
BER = np.array([0.0, 0.05, 0.1, 0.2], np.float32)
ROWS = np.array([1, 0], np.int32)
KEY = jax.random.PRNGKey(2)


def _cfgs(**kw):
    j = jscale.ScaleOutConfig(**BASE, use_kernels=False, noise="exact", **kw)
    t = tscale.ScaleOutConfig(**BASE, noise="exact", **kw)
    return j, t


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def books():
    """Two tenant codebooks [2, C, d] uint8 made by JAX."""
    tcfg = jclf.HDCTaskConfig(n_classes=BASE["n_classes"], dim=BASE["dim"])
    return np.asarray(jclf.make_tenant_codebooks(jax.random.PRNGKey(0), tcfg, 2))


@pytest.fixture(scope="module")
def sym_states():
    """(JAX, port) states on the same leaves: the port's precharacterized
    4-RX physics (tests/test_torch_ota.py holds its search against JAX's)."""
    tstate = tscale.precharacterize_state(tscale.ScaleOutConfig(**BASE), device=CPU)
    return _jstate(tstate), tstate


def _jstate(tstate):
    return jphy.ChannelState(*(jnp.asarray(a) for a in convert.to_numpy(tstate).values()))


def _tstate(jstate):
    return convert.state_from_numpy({f: np.asarray(getattr(jstate, f))
                                     for f in tphy.ChannelState.FIELDS}, CPU)


def _tf(jf):
    """The port's FaultState with a JAX FaultState's leaves."""
    return convert.fstate_from_numpy({f: np.asarray(getattr(jf, f))
                                      for f in tfaults.FaultState.FIELDS}, CPU)


def _same_f(tf, jf):
    got = convert.to_numpy(tf)
    for f in tfaults.FaultState.FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jf, f)), err_msg=f)


def _t(a):
    return convert.hv_from_numpy(np.asarray(a), CPU)


def _eq(port, ref):
    np.testing.assert_array_equal(convert.to_numpy(port), np.asarray(ref))


def _words(a, packed):
    return np.asarray(jhv.pack(jnp.asarray(a))) if packed else np.asarray(a)


def _inputs(jcfg, book, seed=1):
    """(protos, queries) as numpy in the cfg's representation, drawn by JAX."""
    _, q = jscale.make_queries(jax.random.PRNGKey(seed), jcfg, jnp.asarray(book), 1)
    return _words(book, jcfg.packed), np.asarray(q)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _bsc_state():
    return tphy.state_from_ber(torch.from_numpy(BER), 3)


# ---------------------------------------------------------------------------
# JAX's noise, replayed
# ---------------------------------------------------------------------------

class ReplayChannel(tphy.Channel):
    """BSC tier that flips core i with ``masks[i]`` [B, d] drawn beforehand
    by JAX (as in tests/test_torch_scaleout.py)."""

    name = "bsc_fault_replay"
    wire = "votes"

    def __init__(self, masks):
        self.masks = masks

    def rx_copies(self, generator, reduced, state, rx_base, n_cores,
                  *, packed, dim, noise, planes=16):
        m = self.masks[rx_base:rx_base + n_cores]
        return reduced[None] ^ (thv.pack(m) if packed else m)


class ReplaySymbol(tphy.SymbolChannel):
    """The symbol tier on JAX's draws: core i's normals and fallback flips
    (as in tests/test_torch_phy.py)."""

    name = "symbol_fault_replay"

    def __init__(self, nr, ni, flips):
        self.nr, self.ni, self.flips = nr, ni, flips

    def draws(self, generator, state, rx_base, n_cores, shape):
        rows = slice(rx_base, rx_base + n_cores)
        return self.nr[rows], self.ni[rows], self.flips[rows]


def _replay_tier(channel, ber):
    """The replay tier of JAX's draws for KEY on a (1, 1) mesh: core i from
    fold_in(fold_in(KEY, dpos=0), i)."""
    kq = jax.random.fold_in(KEY, 0)
    shape = (BASE["batch"], BASE["dim"])
    keys = [jax.random.fold_in(kq, i) for i in range(len(ber))]
    if channel == "bsc":
        return ReplayChannel(torch.from_numpy(np.stack([
            np.asarray(jax.random.bernoulli(k, jnp.float32(b), shape), np.uint8)
            for k, b in zip(keys, ber)])))
    nr, ni, flips = [], [], []
    for k, b in zip(keys, ber):
        kr, ki = jax.random.split(k)
        nr.append(np.asarray(jax.random.normal(kr, shape)))
        ni.append(np.asarray(jax.random.normal(ki, shape)))
        flips.append(np.asarray(jax.random.bernoulli(jax.random.fold_in(k, 1), jnp.float32(b),
                                                     shape)))
    return ReplaySymbol(*(torch.from_numpy(np.stack(a)) for a in (nr, ni, flips)))


@pytest.fixture
def replay():
    """Register a replay tier; yields a function (channel, ber) -> its name."""
    names = []

    def register(channel, ber):
        tier = _replay_tier(channel, ber)
        tphy.register_channel(tier, override=True)
        names.append(tier.name)
        return tier.name

    yield register
    for n in names:
        tphy.CHANNELS.pop(n, None)


# ---------------------------------------------------------------------------
# the registry, the state, the samplers, the planner
# ---------------------------------------------------------------------------

def test_fault_registry_and_errors():
    assert sorted(tfaults.FAULTS) == sorted(jfaults.FAULTS) == [
        "static", "transient_votes", "wearout"]
    m = tfaults.get_fault_model("transient_votes", p_drop=0.2)
    assert isinstance(m, tfaults.TransientVoteFaults) and m.p_drop == 0.2
    with pytest.raises(ValueError, match="unknown fault model"):
        tfaults.get_fault_model("gamma_ray")
    with pytest.raises(ValueError, match="already registered"):
        tfaults.register_fault_model(tfaults.StaticFaults)
    with pytest.raises(ValueError, match="non-empty .name"):
        tfaults.register_fault_model(tfaults.FaultModel)

    @dataclasses.dataclass(frozen=True)
    class Meteor(tfaults.StaticFaults):
        name = "meteor"

    try:
        tfaults.register_fault_model(Meteor)
        assert isinstance(tfaults.get_fault_model("meteor"), Meteor)
    finally:
        del tfaults.FAULTS["meteor"]


def test_healthy_state_and_inject_coercion_match_jax():
    jf, tf = jfaults.healthy_state(4, 3, 16), tfaults.healthy_state(4, 3, 16, CPU)
    _same_f(tf, jf)
    assert (tf.n_rx, tf.m_slots, tf.words) == (4, 3, 16)
    _same_f(tfaults.healthy_for(_cfgs()[1], CPU), jfaults.healthy_for(_cfgs()[0], 1))
    words = np.full((4, 16), 0xFFFFFFFF, np.uint32)
    words[1] = 0x80000001
    kw = dict(dead_rx=[0, 2], vote_drop=[1], serve_rows=np.array([1, 1, 2, 3]),
              dead_tx=np.array([False, False, True]), stuck1=words)
    _same_f(tfaults.inject(tf, **kw), jfaults.inject(jf, **kw))
    assert tfaults.inject(tf, stuck1=words).stuck1.dtype == torch.int32
    with pytest.raises(ValueError, match="shape"):
        tfaults.inject(tf, stuck0=np.zeros((4, 15), np.uint32))


def test_fstate_round_trips_through_numpy():
    tf = tfaults.inject(tfaults.healthy_state(4, 3, 16, CPU), dead_rx=[3],
                        stuck0=np.full((4, 16), 0xF000000F, np.uint32))
    back = convert.fstate_from_numpy(convert.to_numpy(tf), CPU)
    assert all(torch.equal(getattr(back, f), getattr(tf, f))
               for f in tfaults.FaultState.FIELDS)


def test_samplers_are_disjoint_sized_and_replay_jax():
    s0, s1 = tfaults.sample_stuck_cells(_gen(0), 4, 16, 0.1)
    assert s0.shape == (4, 16) and s0.dtype == torch.int32
    assert not (s0 & s1).any()                            # one conductance per cell
    bits = int(thv.unpack(s0, 512).sum() + thv.unpack(s1, 512).sum())
    assert 0.05 < bits / (4 * 16 * 32) < 0.2
    drop = tfaults.sample_word_dropout(_gen(1), 4, 16, 0.5)
    assert set(drop.unique().tolist()) == {0, -1}         # whole words only
    # JAX's draws through the seams give JAX's masks
    key = jax.random.PRNGKey(7)
    k0, k1 = jax.random.split(key)
    raw = [_t(jhv.bernoulli_words(k, 0.05, (4, 16))) for k in (k0, k1)]
    got = tfaults.sample_stuck_cells(None, 4, 16, 0.1, masks=raw)
    for g, w in zip(got, jfaults.sample_stuck_cells(key, 4, 16, 0.1)):
        _eq(thv.unpack(g, 512), jhv.unpack(w, 512))
    jdrop = jax.random.bernoulli(jax.random.PRNGKey(8), 0.5, (4, 16))
    got = tfaults.sample_word_dropout(None, 4, 16, 0.5, drop=torch.tensor(np.asarray(jdrop)))
    np.testing.assert_array_equal(
        convert.to_numpy(got, words=True),
        np.asarray(jfaults.sample_word_dropout(jax.random.PRNGKey(8), 4, 16, 0.5)))
    with pytest.raises(ValueError, match="Generator"):
        tfaults.sample_stuck_cells(None, 4, 16, 0.1)


@pytest.mark.parametrize("n,cps,dead", [
    (8, 4, [0, 1, 4, 5, 6, 7]),          # round-robin in shard 0, shard 1 exhausted
    (4, 4, [0]),
    (8, 2, [1, 2, 3, 6]),
    (6, 6, [0, 1, 2, 3, 4]),             # five banks dealt onto one healthy core
])
def test_plan_failover_matches_jax(n, cps, dead):
    jf = jfaults.plan_failover(jfaults.inject(jfaults.healthy_state(n, 3, 16), dead_rx=dead),
                               cps)
    tf = tfaults.plan_failover(tfaults.inject(tfaults.healthy_state(n, 3, 16, CPU),
                                              dead_rx=dead), cps)
    _same_f(tf, jf)


def test_plan_failover_refuses_a_split_shard():
    with pytest.raises(ValueError, match="shards of 3"):
        tfaults.plan_failover(tfaults.healthy_state(8, 3, 16, CPU), 3)


# ---------------------------------------------------------------------------
# the healthy state: fault awareness costs nothing
# ---------------------------------------------------------------------------

def _fault_free_and_healthy(jcfg, cfg, state, book, books, serve, process):
    """(fault-free, fault-aware under the healthy state) outputs of one call
    of the port's serve of ``cfg`` on JAX-drawn inputs of ``jcfg``,
    standalone or multi-tenant, with or without StaticProcess."""
    faults = tfaults.StaticFaults()
    proc = tphy.StaticProcess() if process else None
    if serve == "standalone":
        protos, q = (_t(a) for a in _inputs(jcfg, book))
        args, gens = (protos, q), lambda: _gen(100)
        build = tscale.make_ota_serve
    else:
        store = _t(np.stack([_words(b, cfg.packed) for b in books]))
        qs = _t(np.stack([_inputs(jcfg, books[r], 50 + s)[1] for s, r in enumerate(ROWS)]))
        args, gens = (store, qs, torch.from_numpy(ROWS)), lambda: [_gen(100), _gen(101)]
        build = tscale.make_mt_ota_serve
    lead = (proc.init(state),) if process else (state,)
    tail = (None,) if process else ()
    want = build(cfg, device=CPU, process=proc)(*args, *lead, gens(), *tail)
    got = build(cfg, device=CPU, process=proc, faults=faults)(
        *args, *lead, gens(), *tail, tfaults.healthy_for(cfg, CPU), None)
    return want, got


@pytest.mark.parametrize("process", [False, True], ids=["plain", "static_process"])
@pytest.mark.parametrize("serve", ["standalone", "mt"])
@pytest.mark.parametrize("permuted", [False, True], ids=["baseline", "permuted"])
@pytest.mark.parametrize("rep", ["unpacked", "packed"])
@pytest.mark.parametrize("channel", ["bsc", "symbol"])
def test_healthy_fault_serve_is_the_fault_free_serve(books, sym_states, channel, rep,
                                                     permuted, serve, process):
    jcfg, tcfg = _cfgs(channel=channel, representation=rep, permuted=permuted)
    state = sym_states[1] if channel == "symbol" else _bsc_state()
    want, got = _fault_free_and_healthy(jcfg, tcfg, state, books[0], books, serve, process)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[-1].t) == 1                            # the fault state stepped once
    if process:
        assert int(got[2].t) == int(want[2].t) == 1


@pytest.mark.parametrize("serve", ["standalone", "mt"])
@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_healthy_fault_serve_is_the_fault_free_serve_coarse(books, rep, serve):
    jcfg, tcfg = _cfgs(representation=rep, coarse_group=2, coarse_keep=2)
    want, got = _fault_free_and_healthy(jcfg, tcfg, _bsc_state(), books[0], books, serve,
                                        False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# each fault against JAX's fault serve, on JAX's replayed noise
# ---------------------------------------------------------------------------

_J_SERVES = {}


def _jax_fserve(mesh, jcfg):
    """JAX's fault-aware serve of ``jcfg`` (built once a config: the fault
    state is an input, so every scenario reuses it)."""
    if jcfg not in _J_SERVES:
        _J_SERVES[jcfg] = jscale.make_ota_serve(mesh, jcfg, faults=jfaults.StaticFaults())
    return _J_SERVES[jcfg]


def _stuck(density, cfg):
    s0, s1 = jfaults.sample_stuck_cells(jax.random.PRNGKey(7), cfg.n_rx_cores, cfg.words,
                                        density)
    return dict(stuck0=s0, stuck1=s1)


SCENARIOS = {
    # name: (cfg kwargs, JAX inject kwargs (callable of cfg), plan failover)
    "dead_rx_unaware": (dict(representation="packed", permuted=True),
                        lambda c: dict(dead_rx=[0, 2]), False),
    "dead_rx_aware": (dict(representation="packed", permuted=True),
                      lambda c: dict(dead_rx=[0, 2]), True),
    "dead_rx_aware_unpacked": (dict(permuted=False), lambda c: dict(dead_rx=[1]), True),
    "every_core_dead": (dict(representation="packed"),
                        lambda c: dict(dead_rx=[0, 1, 2, 3]), True),
    "stuck_packed": (dict(representation="packed", permuted=True),
                     lambda c: _stuck(0.2, c), False),
    "stuck_unpacked": (dict(permuted=True), lambda c: _stuck(0.2, c), False),
    "stuck_coarse_packed": (dict(representation="packed", coarse_group=2, coarse_keep=2),
                            lambda c: _stuck(0.2, c), False),
    "stuck_coarse_unpacked": (dict(coarse_group=2, coarse_keep=2),
                              lambda c: _stuck(0.2, c), False),
    "vote_erasure": (dict(representation="packed", permuted=True),
                     lambda c: dict(vote_drop=[1, 2]), False),
    "one_erasure_of_three": (dict(representation="packed", permuted=True),
                             lambda c: dict(vote_drop=[2]), False),
    "dead_tx_unpacked": (dict(), lambda c: dict(dead_tx=[0]), False),
    "all_at_once": (dict(representation="packed", permuted=True),
                    lambda c: dict(dead_rx=[3], vote_drop=[0], **_stuck(0.05, c)), True),
}


def _jax_and_port_fault_serve(mesh, replay, jcfg, tcfg, jstate, jf, book):
    protos, q = _inputs(jcfg, book)
    jpred, jsim, jf2 = _jax_fserve(mesh, jcfg)(jnp.asarray(protos), jnp.asarray(q), jstate,
                                               KEY, jf, jax.random.PRNGKey(9))
    tier = replay(tcfg.channel, np.asarray(jstate.ber))
    serve = tscale.make_ota_serve(dataclasses.replace(tcfg, channel=tier), device=CPU,
                                  faults=tfaults.StaticFaults())
    pred, sim, tf2 = serve(_t(protos), _t(q), _tstate(jstate), None, _tf(jf), None)
    _same_f(tf2, jf2)
    return (pred, sim), (jpred, jsim)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fault_serve_on_jax_noise_matches_jax(mesh, books, replay, name):
    kw, leaves, failover = SCENARIOS[name]
    jcfg, tcfg = _cfgs(**kw)
    jf = jfaults.inject(jfaults.healthy_for(jcfg, 1), **leaves(jcfg))
    if failover:
        jf = jfaults.plan_failover(jf, jcfg.n_rx_cores)
    jstate = jphy.state_from_ber(jnp.asarray(BER), 3)
    (pred, sim), (jpred, jsim) = _jax_and_port_fault_serve(mesh, replay, jcfg, tcfg, jstate,
                                                           jf, books[0])
    _eq(pred, jpred)
    _eq(sim, jsim)
    # the faults mattered: the port's fault-free serve on the same noise answers otherwise
    protos, q = _inputs(jcfg, books[0])
    tier = replay("bsc", BER)
    clean = tscale.make_ota_serve(dataclasses.replace(tcfg, channel=tier), device=CPU)(
        _t(protos), _t(q), _bsc_state(), None)
    assert not (torch.equal(clean[0], pred) and torch.equal(clean[1], sim))


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_dead_rx_failover_recovers_bit_exactly_on_a_clean_link(mesh, books, replay, rep):
    """Unaware, a dead core's zeroed copy misleads its bank; aware, the bank
    searches a healthy core's (identical, noise-free) copy and the serve
    equals the fault-free one, in both packages."""
    jcfg, tcfg = _cfgs(representation=rep, permuted=True)
    zero = np.zeros(4, np.float32)
    jstate = jphy.state_from_ber(jnp.asarray(zero), 3)
    dead = jfaults.inject(jfaults.healthy_for(jcfg, 1), dead_rx=[0])
    protos, q = _inputs(jcfg, books[0])
    want = tscale.make_ota_serve(tcfg, device=CPU)(_t(protos), _t(q), _tstate(jstate), None)
    for jf, recovers in ((dead, False), (jfaults.plan_failover(dead, 4), True)):
        (pred, sim), (jpred, jsim) = _jax_and_port_fault_serve(mesh, replay, jcfg, tcfg,
                                                               jstate, jf, books[0])
        _eq(pred, jpred)
        _eq(sim, jsim)
        assert (torch.equal(pred, want[0]) and torch.equal(sim, want[1])) == recovers


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_vote_erasure_is_the_m_active_oracle(books, rep):
    """Erasing TXs 1 and 2 leaves one live voter: the m_active = 1 serve."""
    jcfg, tcfg = _cfgs(representation=rep, permuted=True)
    protos, q = (_t(a) for a in _inputs(jcfg, books[0]))
    oracle = tscale.make_ota_serve(dataclasses.replace(tcfg, m_active=1), device=CPU)
    want = oracle(protos, q, _bsc_state(), _gen(3))
    f = tfaults.inject(tfaults.healthy_for(tcfg, CPU), vote_drop=[1], dead_tx=[2])
    got = tscale.make_ota_serve(tcfg, device=CPU, faults=tfaults.StaticFaults())(
        protos, q, _bsc_state(), _gen(3), f, None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
@pytest.mark.parametrize("permuted", [False, True], ids=["baseline", "permuted"])
def test_combo_wire_erasure_with_recentered_state_matches_jax(mesh, books, sym_states,
                                                              replay, permuted, rep):
    """TX 0 a stuck carrier on the symbol tier; the decoder re-fit on the
    live sub-constellation (JAX's `recenter_state`, carried across)."""
    jcfg, tcfg = _cfgs(channel="symbol", representation=rep, permuted=permuted)
    dead = jnp.array([True, False, False])
    jstate = jfaults.recenter_state(sym_states[0], dead)
    jf = jfaults.inject(jfaults.healthy_for(jcfg, 1), dead_tx=[0])
    (pred, sim), (jpred, jsim) = _jax_and_port_fault_serve(mesh, replay, jcfg, tcfg, jstate,
                                                           jf, books[0])
    _eq(pred, jpred)
    _eq(sim, jsim)


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_mt_fault_serve_matches_jax_and_each_slot_its_standalone_serve(mesh, books, rep):
    """The multi-tenant fault serve on the ideal tier (dead core failed over,
    a TX erased, stuck cells on the whole tenant store) equals JAX's, and
    each slot equals a standalone fault-aware serve under the same state."""
    jcfg, tcfg = _cfgs(representation=rep, permuted=True, channel="ideal")
    jf = jfaults.plan_failover(jfaults.inject(jfaults.healthy_for(jcfg, 1), dead_rx=[1],
                                              vote_drop=[0], **_stuck(0.1, jcfg)), 4)
    store = np.stack([_words(b, jcfg.packed) for b in books])
    qs = np.stack([_inputs(jcfg, books[r], 50 + s)[1] for s, r in enumerate(ROWS)])
    jstate = jphy.state_from_ber(jnp.asarray(BER), 3)
    fmt = jscale.make_mt_ota_serve(mesh, jcfg, faults=jfaults.StaticFaults())
    keys = jnp.stack([jax.random.PRNGKey(100 + s) for s in range(len(ROWS))])
    jpred, jsim, _ = fmt(jnp.asarray(store), jnp.asarray(qs), jnp.asarray(ROWS), jstate, keys,
                         jf, jax.random.PRNGKey(9))
    faults, tstate = tfaults.StaticFaults(), _tstate(jstate)
    pred, sim, _ = tscale.make_mt_ota_serve(tcfg, device=CPU, faults=faults)(
        _t(store), _t(qs), torch.from_numpy(ROWS), tstate, [None, None], _tf(jf), None)
    _eq(pred, jpred)
    _eq(sim, jsim)
    serve = tscale.make_ota_serve(tcfg, device=CPU, faults=faults)
    for s, r in enumerate(ROWS):
        wp, ws, _ = serve(_t(store[r]), _t(qs[s]), tstate, None, _tf(jf), None)
        assert torch.equal(pred[s], wp) and torch.equal(sim[s], ws), s


# ---------------------------------------------------------------------------
# the combo wire's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", [[False] * 3, [True, False, False], [False, True, False],
                                  [True, False, True]])
def test_live_combos_labels_and_recenter_match_jax(sym_states, dead):
    jdead = jnp.array(dead)
    tdead = torch.tensor(dead)
    _eq(tfaults.live_combo_mask(tdead, 3), jfaults.live_combo_mask(jdead, 3))
    _eq(tfaults.live_majority_labels(tdead, 3), jfaults.live_majority_labels(jdead, 3))
    jstate, tstate = sym_states
    got, want = tfaults.recenter_state(tstate, tdead), jfaults.recenter_state(jstate, jdead)
    for f in ("c0", "c1"):
        assert getattr(got, f).dtype == torch.complex64
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=0)
    assert torch.equal(got.symbols, tstate.symbols) and torch.equal(got.ber, tstate.ber)


def test_majority_centroids_mask(sym_states):
    """mask=None and an all-True mask fit the same centroids bit for bit; a
    sub-constellation mask matches JAX's within a relative 1e-6."""
    jstate, tstate = sym_states
    maj = tota.majority_labels(3)
    full = tota.majority_centroids(tstate.symbols, maj)
    ones = tota.majority_centroids(tstate.symbols, maj, mask=torch.ones(8, dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(full, ones))
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    got = tota.majority_centroids(tstate.symbols, maj, mask=torch.from_numpy(mask))
    want = jota.majority_centroids(jstate.symbols, jota.majority_labels(3),
                                   mask=jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the fault models
# ---------------------------------------------------------------------------

def test_transient_votes_on_jax_draws_match_jax_and_redraw_only_the_wire():
    jm, tm = jfaults.TransientVoteFaults(p_drop=0.5), tfaults.TransientVoteFaults(p_drop=0.5)
    key = jax.random.PRNGKey(0)
    jf, tf = jm.init(4, 8, 16), tm.init(4, 8, 16, CPU)
    for _ in range(3):
        kt = jax.random.fold_in(jax.random.fold_in(key, jf.t), 3)       # the reference's fold
        drop = np.asarray(jax.random.bernoulli(kt, 0.5, (8,)))
        jf, tf = jm.step(key, jf), tm.step(None, tf, draws={"vote_drop": torch.tensor(drop)})
        _same_f(tf, jf)
    g = _gen(0)
    f1 = tm.step(g, tm.init(4, 8, 16, CPU))
    f2 = tm.step(g, f1)
    assert int(f2.t) == 2 and not torch.equal(f1.vote_drop, f2.vote_drop)
    for name in ("dead_tx", "dead_rx", "stuck0", "stuck1", "serve_rows", "rx_mask"):
        assert torch.equal(getattr(f2, name), getattr(f1, name)), name
    with pytest.raises(ValueError, match="Generator"):
        tm.step(None, f1)


def _jax_wearout_draws(m, key, f):
    """What `WearoutFaults.step` draws: per row, split(fold_in(row key, 4), 3)."""
    words = f.stuck0.shape[-1]

    def one(k):
        kd, k0, k1 = jax.random.split(jax.random.fold_in(k, 4), 3)
        return (jax.random.bernoulli(kd, m.p_die),
                jhv.bernoulli_words(k0, m.stuck_rate / 2.0, (words,)),
                jhv.bernoulli_words(k1, m.stuck_rate / 2.0, (words,)))

    die, s0, s1 = jax.jit(jax.vmap(one))(row_keys(key, f.t, 0, f.dead_rx.shape[0]))
    return {"die": torch.tensor(np.asarray(die)), "stuck0": _t(s0), "stuck1": _t(s1)}


def test_wearout_on_jax_draws_matches_jax_and_accumulates_monotonically():
    jm = jfaults.WearoutFaults(p_die=0.3, stuck_rate=0.05)
    tm = tfaults.WearoutFaults(p_die=0.3, stuck_rate=0.05)
    key = jax.random.PRNGKey(0)
    jf, tf = jm.init(8, 3, 16), tm.init(8, 3, 16, CPU)
    jstep = jax.jit(jm.step)
    for _ in range(4):
        draws = _jax_wearout_draws(jm, key, jf)
        jf, tf = jstep(key, jf), tm.step(None, tf, draws=draws)
        _same_f(tf, jf)
    g, prev = _gen(0), tm.init(8, 3, 16, CPU)
    for _ in range(5):
        nxt = tm.step(g, prev)
        assert not (prev.dead_rx & ~nxt.dead_rx).any()        # nothing heals
        assert not (prev.stuck0 & ~nxt.stuck0).any()
        assert not (nxt.stuck0 & nxt.stuck1).any()            # rails disjoint
        prev = nxt
    assert int(prev.t) == 5 and prev.dead_rx.any() and prev.stuck0.any()


def test_static_faults_draw_nothing():
    f = tfaults.inject(tfaults.healthy_state(4, 3, 16, CPU), dead_rx=[1])
    g = _gen(0)
    before = g.get_state()
    f2 = tfaults.StaticFaults().step(g, f)
    assert torch.equal(g.get_state(), before) and int(f2.t) == 1
    assert torch.equal(f2.dead_rx, f.dead_rx)


# ---------------------------------------------------------------------------
# the fault controller and the fault-tolerant engine
# ---------------------------------------------------------------------------

def _ctl_pair(sym_states, est_bad):
    """(JAX, port) StaticProcess states, characterized and with junk symbols
    (every re-fit of a row out of band fails), estimate ``est_bad``."""
    jstate, tstate = sym_states
    jp = jphy.StaticProcess(guard_dims=8).init(jstate)
    junk = jax.random.normal(jax.random.PRNGKey(0), jp.chan.symbols.shape,
                             jnp.float32).astype(jnp.complex64)
    j_bad = dataclasses.replace(jp, chan=dataclasses.replace(jp.chan, symbols=junk),
                                est=jnp.asarray(est_bad))

    def port(p):
        leaves = {f: np.asarray(getattr(p, f)) for f in tphy.ProcessState.FIELDS if f != "chan"}
        leaves["chan"] = {f: np.asarray(getattr(p.chan, f)) for f in tphy.ChannelState.FIELDS}
        return convert.pstate_from_numpy(leaves, CPU)

    return (jp, port(jp)), (j_bad, port(j_bad))


@pytest.mark.parametrize("remap_after", [1, 3])
def test_fault_controller_trace_matches_jax(sym_states, remap_after):
    """Core 0 goes bad: quarantined after one bad re-fit, promoted to dead
    and failed over after ``remap_after`` quarantined barriers, in both
    packages, with the same trace and fault state at every barrier."""
    (jp, tp), (jbad, tbad) = _ctl_pair(sym_states, np.array([0.45, 0, 0, 0], np.float32))
    cc = dict(patience=1, quarantine_after=1, drop_frac=2.0, band_kwargs={"cap": 0.05},
              remap_after=remap_after)
    jctl = JFaultController(JFaultControllerConfig(**cc), jp)
    tctl = FaultController(FaultControllerConfig(**cc), tp)
    jf, tf = jfaults.healthy_state(4, 3, 16), tfaults.healthy_state(4, 3, 16, CPU)
    for step in range(1, 6):
        jctl.act(jbad)
        tctl.act(tbad)
        jf, tf = jctl.promote(jf, 4), tctl.promote(tf, 4)
        assert tctl.trace == jctl.trace
        _same_f(tf, jf)
        assert bool(tf.dead_rx[0]) == (step >= remap_after)
    assert [e["action"] for e in tctl.trace].count("remap") == 1
    assert int(tf.serve_rows[0]) != 0


def test_fault_controller_promotes_exactly_at_remap_after(sym_states):
    p = tphy.StaticProcess().init(sym_states[1])
    ctl = FaultController(FaultControllerConfig(remap_after=3, band_kwargs={"cap": 0.05}), p)
    f = tfaults.healthy_state(4, 3, 16, CPU)
    ctl.quarantined[:] = [True, False, False, False]
    for _ in range(2):                                    # below the threshold: no-op
        f = ctl.promote(f, 4)
        assert not f.dead_rx.any()
    f = ctl.promote(f, 4)                                 # the third quarantined barrier
    assert f.dead_rx.tolist() == [True, False, False, False] and int(f.serve_rows[0]) != 0
    f = ctl.promote(f, 4)                                 # one-way: never re-promoted
    assert [e["action"] for e in ctl.trace] == ["remap"] and ctl.trace[0]["rows"] == [0]
    ctl.quarantined[:] = False                            # a release resets the count
    ctl.promote(f, 4)
    assert (ctl._q_barriers == 0).all()


def _protos(cfg, book):
    return thv.pack(_t(book)) if cfg.packed else _t(book)


def _query(cfg, book, seed):
    return tscale.make_queries(_gen(seed), cfg, _t(book))[1]


def _run_engine(eng, cfg, books, n_requests):
    sched = HDCScheduler(eng)
    for t in range(2):
        eng.registry.onboard(t, _protos(cfg, books[t]))
    rids = [sched.submit(r % 2, _query(cfg, books[r % 2], 50 + r), generator=_gen(100 + r))
            for r in range(n_requests)]
    sched.run(timeout=600)
    return [(sched.results[r].pred, sched.results[r].maxsim) for r in rids]


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
@pytest.mark.parametrize("channel", ["bsc", "symbol"])
def test_fault_tolerant_engine_with_zero_faults_is_the_adaptive_engine(books, sym_states,
                                                                       channel, rep):
    _, cfg = _cfgs(channel=channel, representation=rep)
    kw = dict(process=tphy.StaticProcess(guard_dims=16), num_slots=2, max_tenants=2,
              device=CPU)
    adaptive = AdaptiveHDCEngine(cfg, sym_states[1], **kw,
                                 controller=LinkControllerConfig(band_kwargs={"cap": 0.05}))
    ft = FaultTolerantHDCEngine(cfg, sym_states[1], **kw, fault_model=tfaults.StaticFaults(),
                                controller=FaultControllerConfig(band_kwargs={"cap": 0.05}))
    for (a, sa), (b, sb) in zip(_run_engine(adaptive, cfg, books, 4),
                                _run_engine(ft, cfg, books, 4)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa, sb)
    assert int(ft.fstate.t) == int(ft.pstate.t) == 2      # 4 requests over 2 slots
    assert not ft.fstate.dead_rx.any() and ft.controller.trace == []


def test_fault_tolerant_engine_remaps_and_serves_through_the_failover(books, sym_states):
    """A core held quarantined is promoted at the third barrier; the next
    step serves through the re-dealt state, equal to a standalone
    fault-aware serve under it; a fleet-mode variant is a fault serve too."""
    _, cfg = _cfgs(representation="packed")
    state = sym_states[1]
    eng = FaultTolerantHDCEngine(cfg, state, process=tphy.StaticProcess(), num_slots=1,
                                 max_tenants=2, device=CPU, fault_model=tfaults.StaticFaults(),
                                 controller=FaultControllerConfig(band_kwargs={"cap": 0.05},
                                                                  drop_frac=2.0))
    eng.controller.quarantined[:] = [True, False, False, False]
    done = _run_engine(eng, cfg, books, 4)
    assert [(e["t"], e["action"], e["rows"]) for e in eng.controller.trace] == [
        (3, "remap", [0])]
    assert eng.fstate.dead_rx.tolist() == [True, False, False, False]
    assert int(eng.fstate.t) == 4
    serve = tscale.make_ota_serve(cfg, device=CPU, faults=tfaults.StaticFaults())
    wp, ws, _ = serve(_protos(cfg, books[1]), _query(cfg, books[1], 53), state, _gen(103),
                      eng.fstate, None)
    np.testing.assert_array_equal(done[3][0], wp.numpy())
    np.testing.assert_array_equal(done[3][1], ws.numpy())
    eng._apply_fleet_mode(True)
    sched = HDCScheduler(eng)
    rid = sched.submit(0, _query(cfg, books[0], 60), generator=_gen(7))
    sched.run(timeout=600)
    drop = tscale.make_ota_serve(dataclasses.replace(cfg, m_active=1), device=CPU,
                                 faults=tfaults.StaticFaults())
    wp, _, _ = drop(_protos(cfg, books[0]), _query(cfg, books[0], 60), state, _gen(7),
                    eng.fstate, None)
    np.testing.assert_array_equal(sched.results[rid].pred, wp.numpy())
    assert int(eng.fstate.t) == 5


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_fault_serve_refusals():
    sparse = tscale.ScaleOutConfig(**BASE, representation="sparse", k_max=16)
    with pytest.raises(ValueError, match="fault injection"):
        tscale.make_ota_serve(sparse, device=CPU, faults=tfaults.StaticFaults())
    with pytest.raises(ValueError, match="does not support the sparse"):
        tscale.make_mt_ota_serve(sparse, device=CPU, faults=tfaults.StaticFaults())
    _, cfg = _cfgs(representation="packed")
    serve = tscale.make_ota_serve(cfg, device=CPU, faults=tfaults.StaticFaults())
    protos = torch.zeros((40, 16), dtype=torch.int32)
    q = torch.zeros((8, 1, 3, 16), dtype=torch.int32)
    for wrong in (tfaults.healthy_state(5, 3, 16, CPU), tfaults.healthy_state(4, 2, 16, CPU),
                  tfaults.healthy_state(4, 3, 8, CPU)):
        with pytest.raises(ValueError, match="fault state"):
            serve(protos, q, _bsc_state(), _gen(0), wrong, None)
