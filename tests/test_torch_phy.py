"""The port's physical symbol tier, M-drop and bitplane noise
(repro_torch.phy.channel, .core.ota, .core.hypervector, .core.scaleout,
.core.classifier) against the JAX package at a small size: 16 RX cores,
32 classes, d = 512, batch 8, M = 3.

The two packages draw from different generators, so the noisy paths are
held by replaying JAX's own draws: the AWGN's standard normals, the
fallback's flip masks and the bitplanes, made from JAX's keys exactly as
the reference makes them. Integer results (decoded bits, predictions, trial
flags, masks) must match bit for bit. The one exception would be a decision
whose two centroid distances agree within a few ulps, where the two
packages' complex ``abs`` may round apart; the decode test counts such
points (none at these seeds). maxsim is held within 1e-6, the analytic band
within 1e-6."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_mesh
from repro import phy as jphy
from repro.core import classifier as jclf, em as jem, hypervector as jhv, ota as jota
from repro.core import scaleout as jscale
from repro.distributed import collectives as jcoll
from repro_torch import convert, phy as tphy
from repro_torch.core import classifier as tclf, em as tem, hypervector as thv, ota as tota
from repro_torch.core import scaleout as tscale, sparse as tsparse
from repro_torch.distributed import collectives as tcoll

CPU = "cpu"
SMALL = dict(n_classes=32, dim=512, m_tx=3, n_rx_cores=16, batch=8)
MODES = [(False, "unpacked"), (False, "packed"), (True, "unpacked"), (True, "packed")]


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh((1, 1), ("data", "model"))


def _jax_state(tstate):
    """The JAX package's ChannelState with the port's leaves."""
    return jphy.ChannelState(*(jnp.asarray(a) for a in convert.to_numpy(tstate).values()))


@pytest.fixture(scope="module")
def all_states():
    """Real M TX / 16 RX characterizations (the port's search, which
    tests/test_torch_ota.py holds against JAX's) for M = 1, 3, 5, as
    (JAX state, port state) on the same leaves."""
    out = {}
    for m in (1, 3, 5):
        tstate = tscale.precharacterize_state(
            tscale.ScaleOutConfig(**dict(SMALL, m_tx=m)), device=CPU)
        out[m] = _jax_state(tstate), tstate
    return out


@pytest.fixture(scope="module")
def states(all_states):
    """The 3 TX / 16 RX characterization, every row valid."""
    assert bool(all_states[3][1].valid.all())
    return all_states[3]


@pytest.fixture(scope="module")
def codebook():
    protos = jhv.random_hv(jax.random.PRNGKey(0), SMALL["n_classes"], SMALL["dim"])
    _, queries = jscale.make_queries(jax.random.PRNGKey(1), jscale.ScaleOutConfig(**SMALL),
                                     protos, 1)
    return np.asarray(protos), np.asarray(queries)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _normals(key, shape):
    """The standard normals `repro.core.ota.awgn_decide` draws from `key`."""
    kr, ki = jax.random.split(key)
    return _t(jax.random.normal(kr, shape)), _t(jax.random.normal(ki, shape))


def _eq(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_array_equal(convert.to_numpy(port, words=ref.dtype == np.uint32), ref)


# ---------------------------------------------------------------------------
# the decode, the bitplanes and the hypervector leftovers
# ---------------------------------------------------------------------------

def _near_ties(sym, c0, c1, nr, ni, n0, ulps=4):
    """Points whose two centroid distances agree within `ulps` ulps."""
    r = sym + torch.complex(nr, ni) * torch.sqrt(torch.as_tensor(n0, dtype=torch.float32) / 2)
    d1, d0 = (r - c1).abs(), (r - c0).abs()
    return int(((d1 - d0).abs() <= ulps * torch.finfo(torch.float32).eps * d0).sum())


def test_awgn_decide_and_simulate_ota_bundle_match_jax(states):
    jstate, tstate = states
    key = jax.random.PRNGKey(3)
    combo = np.random.default_rng(0).integers(0, 8, (16, 4096))
    jsym = jnp.take_along_axis(jstate.symbols, jnp.asarray(combo), 1)
    ref = jota.awgn_decide(key, jsym, jstate.c0[:, None], jstate.c1[:, None], jstate.n0)
    nr, ni = _normals(key, jsym.shape)
    sym = torch.gather(tstate.symbols, 1, _t(combo))
    c0, c1 = tstate.c0[:, None], tstate.c1[:, None]
    got = tota.awgn_decide(None, sym, c0, c1, tstate.n0, noise=(nr, ni))
    assert got.dtype == torch.uint8
    assert _near_ties(sym, c0, c1, nr, ni, tstate.n0) == 0
    _eq(got, ref)
    assert 0 < float(got.float().mean()) < 1
    # the whole Fig. 3b dataflow: M TXs superpose, every RX decodes
    queries = np.asarray(jhv.random_hv(jax.random.PRNGKey(4), 3, 512))
    ref = jota.simulate_ota_bundle(key, jnp.asarray(queries), jstate.h, jstate.phase_idx,
                                   jstate.n0)
    got = tota.simulate_ota_bundle(None, _t(queries), tstate.h, tstate.phase_idx, tstate.n0,
                                   noise=_normals(key, (16, 512)))
    _eq(got, ref)


def test_awgn_noise_has_variance_n0_over_2_per_component():
    """The port's own draw: a symbol at 0 between centroids at -1 and +1
    decodes wrong at 0.5 erfc(1/sqrt(n0)) when each component has variance
    n0/2; a complex64 randn (variance 1/2) would give another rate."""
    n, n0 = 200_000, 0.5
    sym = torch.full((n,), 1.0 + 0j, dtype=torch.complex64)
    got = tota.awgn_decide(torch.Generator().manual_seed(0), sym,
                           torch.tensor(-1.0 + 0j), torch.tensor(1.0 + 0j), n0)
    rate = 1.0 - float(got.double().mean())
    want = 0.5 * float(torch.special.erfc(torch.tensor(1.0 / n0 ** 0.5, dtype=torch.float64)))
    assert abs(rate - want) <= 5 * (want * (1 - want) / n) ** 0.5, (rate, want)


@pytest.mark.parametrize("precision,per_row", [(8, True), (16, False)])
def test_bernoulli_words_match_jax_on_replayed_planes(precision, per_row):
    key = jax.random.PRNGKey(precision)
    shape = (4, 8, 16)
    p = (np.array([0.0, 0.01, 0.2, 0.5], np.float32).reshape(4, 1, 1) if per_row
         else np.float32(0.07))
    ref = jhv.bernoulli_words(key, jnp.asarray(p), shape, precision)
    planes = _t(np.asarray(jax.random.bits(key, (precision,) + shape, jnp.uint32)).view(np.int32))
    got = thv.bernoulli_words(None, torch.as_tensor(p), shape, precision, planes=planes)
    _eq(got, ref)
    # the packed BSC's bitplane mode is the XOR with these words
    words = np.random.default_rng(precision).integers(0, 2**32, shape, dtype=np.uint32)
    ref = jcoll.ota_noise_packed(key, jnp.asarray(words), jnp.asarray(p), mode="bitplane",
                                 planes=precision)
    _eq(convert.hv_from_numpy(words, CPU) ^ got, ref)


def test_bernoulli_words_rate_and_comparator_per_bit():
    """The port's own planes: the comparator sets exactly the lanes whose
    precision-bit uniform (plane i is bit i) lies below round(p * 2^prec)."""
    g = torch.Generator().manual_seed(0)
    planes = thv._random_words(g, (8, 64, 16), CPU)
    got = thv.bernoulli_words(None, 0.3, (64, 16), 8, planes=planes)
    u = sum(((thv.unpack(planes[i], 512).to(torch.int64)) << i) for i in range(8))
    _eq(got, np.asarray(thv.pack((u < round(0.3 * 256)).to(torch.uint8))).view(np.uint32))
    rate = float(thv.unpack(thv.bernoulli_words(g, 0.3, (512, 16), 8), 512).double().mean())
    assert abs(rate - 77 / 256) < 5 * (0.3 * 0.7 / (512 * 512)) ** 0.5


def test_hypervector_leftovers_match_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 2**32, (4, 16), dtype=np.uint32) for _ in range(2))
    _eq(thv.bind_packed(convert.hv_from_numpy(a, CPU), convert.hv_from_numpy(b, CPU)),
        jhv.bind_packed(jnp.asarray(a), jnp.asarray(b)))
    # the keyed even-M tie-break on JAX's tie bits, unpacked and packed
    hvs = rng.integers(0, 2, (4, 6, 512), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    tie = _t(jax.random.bernoulli(key, 0.5, (6, 512)))
    ref = jhv.majority(jnp.asarray(hvs), key)
    _eq(thv.majority(_t(hvs), tie=tie), ref)
    _eq(thv.majority_packed(thv.pack(_t(hvs)), tie=tie),
        jhv.majority_packed(jhv.pack(jnp.asarray(hvs)), key))
    assert not np.array_equal(np.asarray(ref), np.asarray(jhv.majority(jnp.asarray(hvs))))
    # on the port's own generator: packed == unpacked, odd M never ties
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    assert torch.equal(thv.unpack(thv.majority_packed(thv.pack(_t(hvs)), g()), 512),
                       thv.majority(_t(hvs), g()))
    assert torch.equal(thv.majority(_t(hvs[:3]), g()), thv.majority(_t(hvs[:3])))
    # per-RX BSC: copy r flipped at ber[r]; packed packs the same draw
    ber = torch.tensor([0.0, 0.1, 0.5])
    x = _t(hvs[0])
    flips = thv.flip_bits_per_rx(g(), x, ber)
    assert tuple(flips.shape) == (3, 6, 512) and torch.equal(flips[0], x)
    assert torch.equal(thv.unpack(thv.flip_bits_per_rx_packed(g(), thv.pack(x), ber), 512),
                       flips)
    rates = (flips ^ x).double().mean((1, 2))
    assert abs(float(rates[1]) - 0.1) < 0.02 and abs(float(rates[2]) - 0.5) < 0.03
    words = thv.random_hv_packed(g(), 64, 512, CPU)
    assert words.dtype == torch.int32 and tuple(words.shape) == (64, 16)
    assert abs(float(thv.unpack(words, 512).double().mean()) - 0.5) < 0.01


def test_analytic_ber_band_matches_jax(states):
    jstate, tstate = states
    for kw in ({}, {"cap": 0.05}, {"slack_db": 3.0, "fade_slack": 1.0, "floor": 0.001}):
        np.testing.assert_allclose(
            tem.analytic_ber_band(tstate.h, tstate.n0, tstate.ber, **kw).numpy(),
            np.asarray(jem.analytic_ber_band(jstate.h, jstate.n0, jstate.ber, **kw)),
            rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the symbol serve
# ---------------------------------------------------------------------------

class ReplaySymbol(tphy.SymbolChannel):
    """The symbol tier on draws made beforehand (by JAX): core i's normals
    and fallback flips [n, B, d]."""

    name = "symbol_replay"

    def __init__(self, nr, ni, flips):
        self.nr, self.ni, self.flips = nr, ni, flips

    def draws(self, generator, state, rx_base, n_cores, shape):
        rows = slice(rx_base, rx_base + n_cores)
        return self.nr[rows], self.ni[rows], self.flips[rows]


def _jax_symbol_draws(key, ber, batch, dim):
    """What JAX's symbol tier draws on a (1, 1) mesh: core i's AWGN from
    fold_in(fold_in(key, dpos=0), i), its fallback flips from
    fold_in(that, 1)."""
    kq = jax.random.fold_in(key, 0)
    nr, ni, flips = [], [], []
    for i, b in enumerate(ber):
        k = jax.random.fold_in(kq, i)
        r, m = _normals(k, (batch, dim))
        nr.append(r)
        ni.append(m)
        flips.append(_t(jax.random.bernoulli(jax.random.fold_in(k, 1), jnp.float32(b),
                                             (batch, dim))))
    return torch.stack(nr), torch.stack(ni), torch.stack(flips)


def _inputs(codebook, packed):
    protos, queries = codebook
    jp, jq = jnp.asarray(protos), jnp.asarray(queries)
    if packed:
        jp, jq = jhv.pack(jp), jhv.pack(jq)
    return (jp, jq, convert.hv_from_numpy(np.asarray(jp), CPU),
            convert.hv_from_numpy(np.asarray(jq), CPU))


def _replay_serve(tcfg, tp, tq, tstate, draws):
    tphy.register_channel(ReplaySymbol(*draws), override=True)
    try:
        cfg = dataclasses.replace(tcfg, channel="symbol_replay")
        return tscale.make_ota_serve(cfg, device=CPU)(tp, tq, tstate, None)
    finally:
        tphy.CHANNELS.pop("symbol_replay")


@pytest.mark.parametrize("permuted,rep", MODES)
def test_symbol_serve_on_jax_noise_matches_jax(mesh, states, codebook, permuted, rep):
    jstate, tstate = states
    jcfg = jscale.ScaleOutConfig(**SMALL, permuted=permuted, representation=rep,
                                 channel="symbol", use_kernels=False)
    tcfg = tscale.ScaleOutConfig(**SMALL, permuted=permuted, representation=rep,
                                 channel="symbol")
    jp, jq, tp, tq = _inputs(codebook, rep == "packed")
    key = jax.random.PRNGKey(2)
    jpred, jsim = jscale.make_ota_serve(mesh, jcfg)(jp, jq, jstate, key)
    draws = _jax_symbol_draws(key, np.asarray(jstate.ber), SMALL["batch"], SMALL["dim"])
    pred, sim = _replay_serve(tcfg, tp, tq, tstate, draws)
    _eq(pred, jpred)
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=0, atol=1e-6)
    # the noise mattered somewhere: the noise-free oracle answers otherwise
    _, rsim = tscale.serve_reference(tcfg, tp, tq)
    assert not torch.equal(rsim, sim)


def test_symbol_fallback_rows_match_jax(mesh, states, codebook):
    """Rows marked invalid take the exact majority with BSC flips at their
    BER; JAX's branch runs when a row is invalid, on its own flip stream."""
    jstate, tstate = states
    valid = np.ones(16, bool)
    valid[::3] = False
    jstate = dataclasses.replace(jstate, valid=jnp.asarray(valid),
                                 ber=jnp.full((16,), 0.2, jnp.float32))
    tstate = dataclasses.replace(tstate, valid=_t(valid),
                                 ber=torch.full((16,), 0.2, dtype=torch.float32))
    jcfg = jscale.ScaleOutConfig(**SMALL, channel="symbol", use_kernels=False)
    tcfg = tscale.ScaleOutConfig(**SMALL, channel="symbol")
    jp, jq, tp, tq = _inputs(codebook, False)
    key = jax.random.PRNGKey(6)
    jpred, jsim = jscale.make_ota_serve(mesh, jcfg)(jp, jq, jstate, key)
    pred, sim = _replay_serve(tcfg, tp, tq, tstate,
                              _jax_symbol_draws(key, np.full(16, 0.2), 8, 512))
    _eq(pred, jpred)
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=0, atol=1e-6)


def test_symbol_tier_fallback_never_moves_valid_rows(states):
    """The port's own generator: on an all-valid state the tier's bits are
    the plain decode of the same normals (the fallback's flips, drawn after
    them, change nothing); a `state_from_ber` state (all rows invalid)
    decodes at its BER."""
    _, tstate = states
    chan = tphy.get_channel("symbol")
    combo = torch.randint(0, 8, (8, 512), generator=torch.Generator().manual_seed(0))
    bits = chan.rx_copies(torch.Generator().manual_seed(1), combo, tstate, 0, 16,
                          packed=False, dim=512, noise="exact")
    nr, ni = tota.awgn_draws(torch.Generator().manual_seed(1), (16, 8, 512))
    plain = tota.awgn_decide(None, tstate.symbols[:, combo], tstate.c0[:, None, None],
                             tstate.c1[:, None, None], tstate.n0, noise=(nr, ni))
    assert torch.equal(bits, plain)
    packed = chan.rx_copies(torch.Generator().manual_seed(1), combo, tstate, 0, 16,
                            packed=True, dim=512, noise="exact")
    assert torch.equal(thv.unpack(packed, 512), bits)
    ber = torch.tensor([0.0, 0.05, 0.2, 0.4])
    synth = tphy.state_from_ber(ber, 3)
    b, d = 64, 512
    combo = torch.randint(0, 8, (b, d), generator=torch.Generator().manual_seed(2))
    rx = chan.rx_copies(torch.Generator().manual_seed(3), combo, synth, 0, 4,
                        packed=False, dim=d, noise="exact")
    exact = tota.majority_labels(3)[combo]
    rate = (rx ^ exact).double().mean((1, 2)).numpy()
    sigma = np.sqrt(ber.numpy() * (1 - ber.numpy()) / (b * d))
    assert (np.abs(rate - ber.numpy()) <= 5 * sigma + 1e-12).all(), rate


def test_symbol_serve_packed_equals_unpacked_on_one_generator(states):
    _, tstate = states
    protos = tclf.make_codebook(torch.Generator().manual_seed(0),
                                tclf.HDCTaskConfig(n_classes=32, dim=512), device=CPU)
    for permuted in (False, True):
        outs = []
        for rep in ("unpacked", "packed"):
            cfg = tscale.ScaleOutConfig(**SMALL, permuted=permuted, representation=rep,
                                        channel="symbol")
            _, q = tscale.make_queries(torch.Generator().manual_seed(1), cfg, protos)
            p = thv.pack(protos) if cfg.packed else protos
            outs.append(tscale.make_ota_serve(cfg, device=CPU)(
                p, q, tstate, torch.Generator().manual_seed(2)))
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_bitplane_bsc_serve_flips_at_the_quantized_ber():
    ber = torch.tensor([0.0, 0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5])
    state = tphy.state_from_ber(ber, 3)
    chan = tphy.get_channel("bsc")
    b, d = 64, 512
    zeros = torch.zeros((b, d // 32), dtype=torch.int32)
    rx = chan.rx_copies(torch.Generator().manual_seed(0), zeros, state, 0, 8, packed=True,
                        dim=d, noise="bitplane", planes=8)
    rate = thv.unpack(rx, d).double().mean((1, 2)).numpy()
    q = np.minimum(np.round(ber.numpy() * 256), 255) / 256
    sigma = np.sqrt(q * (1 - q) / (b * d))
    assert (np.abs(rate - q) <= 5 * sigma + 1e-12).all(), (rate, q)
    cfg = tscale.ScaleOutConfig(**SMALL, representation="packed", noise="bitplane")
    protos = tclf.make_codebook(torch.Generator().manual_seed(0),
                                tclf.HDCTaskConfig(n_classes=32, dim=512), device=CPU)
    _, q = tscale.make_queries(torch.Generator().manual_seed(1), cfg, protos)
    st = tphy.state_from_ber(torch.full((16,), 0.01), 3)
    pred, _ = tscale.make_ota_serve(cfg, device=CPU)(thv.pack(protos), q, st,
                                                      torch.Generator().manual_seed(2))
    assert pred.dtype == torch.int32 and tuple(pred.shape) == (8,)


# ---------------------------------------------------------------------------
# validation and the M-drop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire,cfg", [
    ("combo", dict(collective="psum_packed", channel="symbol", m_tx=3, m_act=3)),
    ("combo", dict(collective="psum", channel="symbol", m_tx=3, m_act=1)),
    ("votes", dict(collective="psum", channel="bsc", m_tx=3, m_act=2)),
    ("votes", dict(collective="psum", channel="bsc", m_tx=3, m_act=0)),
    ("votes", dict(collective="psum", channel="bsc", m_tx=3, m_act=5)),
])
def test_validate_channel_raises_the_reference_errors(wire, cfg):
    cfg = types.SimpleNamespace(**cfg)
    chan = types.SimpleNamespace(wire=wire)
    with pytest.raises(ValueError) as ref:
        jscale._validate_channel(cfg, chan)
    with pytest.raises(ValueError) as got:
        tscale._validate_channel(cfg, chan)
    assert str(got.value) == str(ref.value)


def test_serve_build_validates_the_channel():
    with pytest.raises(ValueError, match="odd"):
        tscale.make_ota_serve(tscale.ScaleOutConfig(**SMALL, m_active=2), device=CPU)
    with pytest.raises(ValueError, match="vote-wire"):
        tscale.make_ota_serve(tscale.ScaleOutConfig(**SMALL, channel="symbol", m_active=1),
                              device=CPU)
    tscale.make_ota_serve(tscale.ScaleOutConfig(**SMALL, m_active=1), device=CPU)
    cfg = tscale.ScaleOutConfig(**SMALL)
    protos = torch.zeros((32, 512), dtype=torch.uint8)
    queries = torch.zeros((8, 1, 3, 512), dtype=torch.uint8)
    with pytest.raises(ValueError, match="characterizes 5 TXs"):
        tscale.make_ota_serve(cfg, device=CPU)(protos, queries,
                                               tphy.state_from_ber(torch.zeros(16), 5), None)
    state = tscale.precharacterize_state(cfg, device=CPU)
    assert torch.equal(tscale.precharacterize(cfg, device=CPU), state.ber)


@pytest.mark.parametrize("rep,permuted", [("unpacked", False), ("packed", False),
                                          ("sparse", False), ("unpacked", True),
                                          ("packed", True)])
def test_m_drop_serve_matches_serve_reference(codebook, rep, permuted):
    """m_active = 1 of 3 on the ideal tier: the bundle is TX 0's query, so
    the serve answers as the m_act = 1 oracle (the port's and JAX's); a
    permuted serve's first column is the meaningful one. The sparse case
    fails unless the abstaining slots are emptied before the bundle."""
    protos, queries = codebook
    kw = dict(**SMALL, representation=rep, channel="ideal", permuted=permuted)
    if rep == "sparse":
        kw["k_max"] = 512
    cfg = tscale.ScaleOutConfig(**kw, m_active=1)
    tp = convert.hv_from_numpy(protos, CPU)
    tq = convert.hv_from_numpy(queries, CPU)
    if rep == "packed":
        tp, tq = thv.pack(tp), thv.pack(tq)
    elif rep == "sparse":
        tp, tq = thv.pack(tp), tsparse.sparsify(tq, 512)
    state = tphy.state_from_ber(torch.full((16,), 0.3), 3)
    pred, sim = tscale.make_ota_serve(cfg, device=CPU)(tp, tq, state, torch.Generator())
    rpred, rsim = tscale.serve_reference(cfg, tp, tq)
    jcfg = jscale.ScaleOutConfig(**kw, m_active=1, use_kernels=False)
    jpred, jsim = jscale.serve_reference(jcfg, jnp.asarray(protos), jnp.asarray(queries))
    cols = (slice(None), slice(0, 1)) if permuted else (slice(None),)
    assert torch.equal(pred[cols], rpred[cols]) and torch.equal(sim[cols], rsim[cols])
    _eq(pred[cols], np.asarray(jpred)[cols])
    # the drop mattered: the full bundle answers otherwise
    full = tscale.make_ota_serve(dataclasses.replace(cfg, m_active=None), device=CPU)(
        tp, tq, state, torch.Generator())
    assert not torch.equal(full[1][cols], sim[cols])


# ---------------------------------------------------------------------------
# the symbol trials
# ---------------------------------------------------------------------------

def _jax_symbol_trial_draws(keys, c, m, d):
    """Per-trial classes and AWGN normals, as the reference's symbol trial
    draws them from each trial's key."""
    def one(k):
        k_cls, k_chan = jax.random.split(k)
        kr, ki = jax.random.split(k_chan)
        return (jax.random.randint(k_cls, (m,), 0, c), jax.random.normal(kr, (d,)),
                jax.random.normal(ki, (d,)))
    classes, nr, ni = jax.vmap(one)(keys)
    return _t(np.asarray(classes).astype(np.int64)), (_t(nr), _t(ni))


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
@pytest.mark.parametrize("bundling", ["baseline", "permuted"])
def test_symbol_trials_match_jax_on_replayed_draws(all_states, codebook, rep, bundling):
    protos = codebook[0]
    t = 96
    for m in ((1, 3, 5) if (rep, bundling) == ("unpacked", "baseline") else (3,)):
        jstate, tstate = all_states[m]
        keys = jax.random.split(jax.random.PRNGKey(m), t)
        ref = jclf._run_trials(keys, jnp.asarray(protos), m, jnp.float32(0.0), bundling, rep,
                               False, "symbol", jstate, 0)
        draws = _jax_symbol_trial_draws(keys, 32, m, 512)
        got = tclf._run_trials(convert.hv_from_numpy(protos, CPU), m, 0.0, bundling, rep, t,
                               channel="symbol", draws=draws, state=tstate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < np.asarray(ref).mean() < 1 or bundling == "permuted"


def test_symbol_trials_checks_and_packed_equals_unpacked(states):
    _, tstate = states
    cfg = tclf.HDCTaskConfig(n_classes=32, dim=512, n_trials=64)
    with pytest.raises(ValueError, match="ChannelState"):
        tclf.run_trials(0, cfg, 3, 0.0, channel="symbol", device=CPU)
    with pytest.raises(ValueError, match="all-False"):
        tclf.run_trials(0, cfg, 3, 0.0, channel="symbol",
                        state=tphy.state_from_ber(torch.zeros(16), 3), device=CPU)
    with pytest.raises(ValueError, match="symbol tier"):
        tclf.run_trials(0, cfg, 3, 0.0, representation="sparse", k_max=64, channel="symbol",
                        state=tstate, device=CPU)
    for bundling in ("baseline", "permuted"):
        flags = [tclf.run_trials(1, cfg, 3, 0.0, bundling, representation=rep,
                                 channel="symbol", state=tstate, device=CPU)
                 for rep in ("unpacked", "packed")]
        assert torch.equal(flags[0], flags[1])
    with pytest.raises(ValueError, match="characterizes 3 TXs"):
        tclf.run_trials(0, cfg, 5, 0.0, channel="symbol", state=tstate, device=CPU)
    # ber is unused on the symbol tier
    assert torch.equal(tclf.run_trials(1, cfg, 3, 0.4, channel="symbol", state=tstate,
                                       device=CPU),
                       tclf.run_trials(1, cfg, 3, 0.0, channel="symbol", state=tstate,
                                       device=CPU))
