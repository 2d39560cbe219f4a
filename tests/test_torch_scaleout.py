"""The port's serve path (repro_torch.core.scaleout) against the JAX
reference at a small size: 256 classes over 8 cores, d = 256, M = 3, B = 16.

Predictions and maxsim must be bit-exact: both packages compute
``max/(2.0*d) + 0.5`` in float32 from exact integers. JAX serves on a
(1, 1) ("data", "model") mesh through its ``use_kernels=False`` path (the
kernel tests pin that path to interpret-mode Pallas). The BSC noise of the
two packages comes from different generators, so the noisy serve is held by
replaying JAX's own flip masks through a registered port tier."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_mesh
from repro import phy as jphy
from repro.core import hypervector as jhv, scaleout as jscale
from repro_torch import convert, phy as tphy
from repro_torch.core import classifier as tclf, hypervector as thv, scaleout as tscale

CPU = "cpu"
SMALL = dict(n_classes=256, dim=256, m_tx=3, n_rx_cores=8, batch=16)
MODES = [(False, "unpacked"), (False, "packed"), (True, "unpacked"), (True, "packed")]
BER = np.array([0.0, 0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.45], np.float32)


def _cfgs(permuted, rep, channel="bsc"):
    j = jscale.ScaleOutConfig(**SMALL, permuted=permuted, representation=rep,
                              channel=channel, use_kernels=False)
    t = tscale.ScaleOutConfig(**SMALL, permuted=permuted, representation=rep,
                              channel=channel)
    return j, t


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def codebook():
    """Unpacked codebook and one query draw, made by JAX from a seed."""
    protos = jhv.random_hv(jax.random.PRNGKey(0), SMALL["n_classes"], SMALL["dim"])
    cfg = jscale.ScaleOutConfig(**SMALL)
    classes, queries = jscale.make_queries(jax.random.PRNGKey(1), cfg, protos, 1)
    return np.asarray(protos), np.asarray(classes), np.asarray(queries)


def _inputs(codebook, packed):
    """(JAX protos, JAX queries, port protos, port queries) of one codebook."""
    protos, _, queries = codebook
    jp, jq = jnp.asarray(protos), jnp.asarray(queries)
    if packed:
        jp, jq = jhv.pack(jp), jhv.pack(jq)
    return (jp, jq, convert.hv_from_numpy(np.asarray(jp), CPU),
            convert.hv_from_numpy(np.asarray(jq), CPU))


def _eq(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_array_equal(convert.to_numpy(port, words=ref.dtype == np.uint32), ref)


class ReplayChannel(tphy.Channel):
    """BSC tier that flips with masks drawn beforehand (by JAX), core i on
    ``masks[i]`` [B, d] uint8 — the port's serve run on JAX's noise."""

    name = "bsc_replay"
    wire = "votes"

    def __init__(self, masks: torch.Tensor):
        self.masks = masks

    def rx_copies(self, generator, reduced, state, rx_base, n_cores,
                  *, packed, dim, noise, planes):
        m = self.masks[rx_base:rx_base + n_cores]
        return reduced[None] ^ (thv.pack(m) if packed else m)


def _jax_masks(key, ber, batch, dim):
    """The masks JAX's bsc tier draws on a (1, 1) mesh: core i flips with
    bernoulli(fold_in(fold_in(key, dpos=0), i), ber[i], [B, d])."""
    kq = jax.random.fold_in(key, 0)
    return np.stack([
        np.asarray(jax.random.bernoulli(jax.random.fold_in(kq, i), jnp.float32(b),
                                        (batch, dim)), np.uint8)
        for i, b in enumerate(ber)])


@pytest.mark.parametrize("permuted,rep", MODES)
def test_ideal_serve_matches_jax_and_both_references(mesh, codebook, permuted, rep):
    jcfg, tcfg = _cfgs(permuted, rep, channel="ideal")
    jp, jq, tp, tq = _inputs(codebook, rep == "packed")
    jstate = jphy.state_from_ber(jnp.asarray(BER), 3)         # ideal ignores the BER
    jpred, jsim = jscale.make_ota_serve(mesh, jcfg)(jp, jq, jstate, jax.random.PRNGKey(2))
    tstate = tphy.state_from_ber(torch.from_numpy(BER), 3)
    pred, sim = tscale.make_ota_serve(tcfg, device=CPU)(tp, tq, tstate, torch.Generator())
    assert pred.dtype == torch.int32 and sim.dtype == torch.float32
    _eq(pred, jpred)
    _eq(sim, jsim)
    rpred, rsim = tscale.serve_reference(tcfg, tp, tq)
    _eq(rpred, jpred)
    _eq(rsim, jsim)
    jrpred, jrsim = jscale.serve_reference(jcfg, jp, jq)
    _eq(pred, jrpred)
    _eq(sim, jrsim)


@pytest.mark.parametrize("permuted,rep", MODES)
def test_bsc_serve_on_jax_noise_matches_jax(mesh, codebook, permuted, rep):
    jcfg, tcfg = _cfgs(permuted, rep)
    jp, jq, tp, tq = _inputs(codebook, rep == "packed")
    key = jax.random.PRNGKey(2)
    jstate = jphy.state_from_ber(jnp.asarray(BER), 3)
    jpred, jsim = jscale.make_ota_serve(mesh, jcfg)(jp, jq, jstate, key)
    # the port reads JAX's own state, carried across through numpy
    tstate = convert.state_from_numpy({f: np.asarray(getattr(jstate, f))
                                       for f in tphy.ChannelState.FIELDS}, CPU)
    masks = torch.from_numpy(_jax_masks(key, BER, SMALL["batch"], SMALL["dim"]))
    tphy.register_channel(ReplayChannel(masks), override=True)
    try:
        serve = tscale.make_ota_serve(dataclasses.replace(tcfg, channel="bsc_replay"),
                                      device=CPU)
        pred, sim = serve(tp, tq, tstate, None)
    finally:
        tphy.CHANNELS.pop("bsc_replay")
    _eq(pred, jpred)
    _eq(sim, jsim)
    # the noise mattered: the ideal serve answers differently somewhere
    ipred, _ = tscale.serve_reference(tcfg, tp, tq)
    assert not torch.equal(ipred, pred)


def test_bsc_tier_flip_rate_and_packed_equals_unpacked(codebook):
    """The port's own BSC on a torch.Generator: each core's flip rate lies
    within 5 sigma of its BER, and the packed serve answers exactly as the
    unpacked one on the same seed (the packed tier packs the same draw)."""
    chan = tphy.get_channel("bsc")
    state = tphy.state_from_ber(torch.from_numpy(BER), 3)
    b, d = 64, 512
    zeros = torch.zeros((b, d), dtype=torch.uint8)
    rx = chan.rx_copies(torch.Generator().manual_seed(3), zeros, state, 0, len(BER),
                        packed=False, dim=d, noise="exact")
    rate = rx.float().mean((1, 2)).numpy()
    sigma = np.sqrt(BER * (1 - BER) / (b * d))
    assert (np.abs(rate - BER) <= 5 * sigma + 1e-12).all(), (rate, BER)
    rxp = chan.rx_copies(torch.Generator().manual_seed(3), thv.pack(zeros), state, 0,
                         len(BER), packed=True, dim=d, noise="exact")
    assert torch.equal(thv.unpack(rxp, d), rx)
    for permuted in (False, True):
        outs = []
        for rep in ("unpacked", "packed"):
            _, tcfg = _cfgs(permuted, rep)
            _, _, tp, tq = _inputs(codebook, rep == "packed")
            serve = tscale.make_ota_serve(tcfg, device=CPU)
            outs.append(serve(tp, tq, state, torch.Generator().manual_seed(4)))
        _eq(outs[0][0], outs[1][0])
        _eq(outs[0][1], outs[1][1])


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_wired_serve_matches_jax(mesh, codebook, rep):
    jcfg, tcfg = _cfgs(False, rep)
    jp, jq, tp, tq = _inputs(codebook, rep == "packed")
    jstate = jphy.state_from_ber(jnp.asarray(BER), 3)
    jpred, jsim = jscale.make_wired_serve(mesh, jcfg)(jp, jq, jstate, jax.random.PRNGKey(2))
    tstate = tphy.state_from_ber(torch.from_numpy(BER), 3)
    pred, sim = tscale.make_wired_serve(tcfg, device=CPU)(tp, tq, tstate, None)
    _eq(pred, jpred)
    _eq(sim, jsim)


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_hdc_train_matches_jax(mesh, rep):
    jcfg, tcfg = _cfgs(False, rep)
    rng = np.random.default_rng(5)
    ex = rng.integers(0, 2, size=(96, SMALL["dim"]), dtype=np.uint8)
    labels = rng.integers(-2, SMALL["n_classes"] + 2, size=96).astype(np.int32)
    jex = jnp.asarray(ex)
    if rep == "packed":
        jex = jhv.pack(jex)
    ref = jscale.make_hdc_train(mesh, jcfg)(jex, jnp.asarray(labels))
    got = tscale.make_hdc_train(tcfg, device=CPU)(convert.hv_from_numpy(np.asarray(jex), CPU),
                                                  torch.from_numpy(labels))
    _eq(got, ref)


def test_state_round_trips_through_numpy():
    jstate = jscale.precharacterize_state(jscale.ScaleOutConfig(**SMALL))
    leaves = {f: np.asarray(getattr(jstate, f)) for f in tphy.ChannelState.FIELDS}
    tstate = convert.state_from_numpy(leaves, CPU)
    assert tstate.symbols.dtype == torch.complex64 and tstate.n_rx == SMALL["n_rx_cores"]
    back = convert.to_numpy(tstate)
    for f in tphy.ChannelState.FIELDS:
        assert back[f].dtype == leaves[f].dtype
        np.testing.assert_array_equal(back[f], leaves[f])
    with pytest.raises(KeyError):
        convert.state_from_numpy({"ber": leaves["ber"]}, CPU)


def test_serve_accuracy_and_queries(codebook):
    protos, classes, _ = codebook
    tcfg = tscale.ScaleOutConfig(**SMALL, permuted=True)
    tp = convert.hv_from_numpy(protos, CPU)
    cls, q = tscale.make_queries(torch.Generator().manual_seed(0), tcfg, tp)
    assert tuple(cls.shape) == (16, 3) and tuple(q.shape) == (16, 1, 3, 256)
    assert torch.equal(q[:, 0, 1], tp[cls[:, 1]])
    pred, _ = tscale.serve_reference(tcfg, tp, q)
    acc = tclf.serve_accuracy(pred, cls)
    assert acc == {"draw_acc": 1.0, "trial_acc": 1.0}
    with pytest.raises(ValueError):
        tclf.serve_accuracy(pred[:, 0], cls)
    book = tclf.make_codebook(torch.Generator().manual_seed(0), tclf.HDCTaskConfig(), device=CPU)
    assert book.dtype == torch.uint8 and tuple(book.shape) == (100, 512)


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA rule cannot show here")
    cfg = tscale.ScaleOutConfig(**SMALL)
    for build in (tscale.make_ota_serve, tscale.make_wired_serve, tscale.make_hdc_train,
                  tscale.precharacterize_state):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tclf.make_codebook(torch.Generator(), tclf.HDCTaskConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.hv_from_numpy(np.zeros((2, 32), np.uint8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_numpy({f: np.zeros(1) for f in tphy.ChannelState.FIELDS})


@pytest.mark.parametrize("bad", [dict(collective="psum_packed"),
                                 dict(representation="sparse", k_max=8,
                                      collective="psum_packed"),
                                 dict(representation="packed", noise="bitplane",
                                      collective="psum_packed"),
                                 dict(channel="symbol", collective="rs_ag"),
                                 dict(collective="rs_ag"),
                                 dict(m_active=1, collective="psum_packed"),
                                 dict(representation="packed", collective="rs_ag")])
def test_unported_config_values_raise(mesh, codebook, bad):
    """The multi-rank collectives on one rank, as the reference takes them:
    where its serve build rejects a combination (the symbol tier with
    another collective than psum) the port raises ValueError in the same
    words; elsewhere the port's ideal serve equals JAX's on its (1, 1)
    mesh, and the port's psum serve, bit for bit."""
    kw = {**SMALL, "channel": "ideal", **bad}
    jcfg = jscale.ScaleOutConfig(**kw, use_kernels=False)
    tcfg = tscale.ScaleOutConfig(**kw)
    if jcfg.channel == "symbol":
        with pytest.raises(ValueError) as ref:
            jscale.make_ota_serve(mesh, jcfg)
        with pytest.raises(ValueError) as got:
            tscale.make_ota_serve(tcfg, device=CPU)
        assert str(got.value) == str(ref.value)
        return
    protos = jnp.asarray(codebook[0])
    _, jq = jscale.make_queries(jax.random.PRNGKey(1), jcfg, protos, 1)
    jp = protos if tcfg.representation == "unpacked" else jhv.pack(protos)
    words = tcfg.representation != "unpacked"
    tp = convert.hv_from_numpy(np.asarray(jp), CPU)
    tq = (torch.from_numpy(np.array(jq)) if tcfg.sparse
          else convert.hv_from_numpy(np.asarray(jq), CPU))
    jstate = jphy.state_from_ber(jnp.asarray(BER), 3)
    tstate = tphy.state_from_ber(torch.from_numpy(BER), 3)
    jpred, jsim = jscale.make_ota_serve(mesh, jcfg)(jp, jq, jstate, jax.random.PRNGKey(2))
    pred, sim = tscale.make_ota_serve(tcfg, device=CPU)(tp, tq, tstate, torch.Generator())
    _eq(pred, jpred)
    _eq(sim, jsim)
    psum = dataclasses.replace(tcfg, collective="psum")
    ppred, psim = tscale.make_ota_serve(psum, device=CPU)(tp, tq, tstate, torch.Generator())
    assert torch.equal(pred, ppred) and torch.equal(sim, psim)
    assert words == (tp.dtype == torch.int32)


KERNELS = ("assoc_matmul", "assoc_matmul_banked", "hamming_search", "hamming_topk_banked",
           "majority_bundle", "sparse_topk_banked")


@pytest.mark.parametrize("channel", ["ideal", "bsc"])
@pytest.mark.parametrize("permuted,rep", MODES)
def test_serves_hand_the_kernels_dense_tensors(codebook, monkeypatch, permuted, rep, channel):
    """The CUDA kernels take contiguous tensors only (their CPU twins take
    any), so every tensor a serve hands a kernel wrapper must be dense:
    the standalone, multi-tenant and wired serves, on inputs cut as
    `shard_inputs` cuts them (views of larger tensors). The ideal tier's
    copies are a stride-0 expand, which a reshape keeps as a view."""
    seen = []

    def dense(name, fn):
        def wrapper(*args, **kwargs):
            seen.append(name)
            for a in args:
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), f"{name} got a non-contiguous {tuple(a.shape)}"
            return fn(*args, **kwargs)
        return wrapper

    for name in KERNELS:
        monkeypatch.setattr(tscale, name, dense(name, getattr(tscale, name)))
    _, tcfg = _cfgs(permuted, rep, channel=channel)
    _, _, tp, tq = _inputs(codebook, rep == "packed")
    state = tphy.state_from_ber(torch.from_numpy(BER), 3)
    wide = torch.cat([tq, tq], 1)[:, :1]                      # a view, as a rank's column
    tscale.make_ota_serve(tcfg, device=CPU)(tp, wide, state, torch.Generator())
    store = torch.stack([tp, tp])
    store = torch.cat([store, store], 1)[:, :tp.shape[0]]     # a view, as a rank's classes
    tscale.make_mt_ota_serve(tcfg, device=CPU)(store, torch.stack([wide, wide]),
                                               torch.tensor([1, 0], dtype=torch.int32), state,
                                               [torch.Generator(), torch.Generator()])
    if not permuted:
        tscale.make_wired_serve(tcfg, device=CPU)(tp, wide, state)
    assert seen


# ---------------------------------------------------------------------------
# the coarse-to-fine serve
# ---------------------------------------------------------------------------

# a real screen at the sizes of tests/test_topk.py: c_core = 64, gs = 4 ->
# 16 groups, keep 2: 8 of 64 rows rescored
SCREEN = dict(n_classes=512, dim=1024, m_tx=3, n_rx_cores=8, batch=32)


@pytest.fixture(scope="module")
def screen_codebook():
    protos = jhv.random_hv(jax.random.PRNGKey(0), SCREEN["n_classes"], SCREEN["dim"])
    _, queries = jscale.make_queries(jax.random.PRNGKey(1), jscale.ScaleOutConfig(**SCREEN),
                                     protos, 1)
    return np.asarray(protos), None, np.asarray(queries)


def _coarse_serves(mesh, book, size, rep, channel, ber, gs, keep):
    """(JAX coarse, port coarse, port flat) (pred, maxsim) of one setting; the
    bsc runs on JAX's own masks through `ReplayChannel`."""
    kw = dict(**size, representation=rep, channel=channel)
    jcfg = jscale.ScaleOutConfig(**kw, coarse_group=gs, coarse_keep=keep, use_kernels=False)
    tflat = tscale.ScaleOutConfig(**kw)
    jp, jq, tp, tq = _inputs(book, rep == "packed")
    bers = np.full(size["n_rx_cores"], ber, np.float32)
    key = jax.random.PRNGKey(2)
    jstate = jphy.state_from_ber(jnp.asarray(bers), size["m_tx"])
    ref = jscale.make_ota_serve(mesh, jcfg)(jp, jq, jstate, key)
    tstate = tphy.state_from_ber(torch.from_numpy(bers), size["m_tx"])
    if channel == "bsc":
        masks = torch.from_numpy(_jax_masks(key, bers, size["batch"], size["dim"]))
        tphy.register_channel(ReplayChannel(masks), override=True)
        tflat = dataclasses.replace(tflat, channel="bsc_replay")
    tcoarse = dataclasses.replace(tflat, coarse_group=gs, coarse_keep=keep)
    try:
        got = tscale.make_ota_serve(tcoarse, device=CPU)(tp, tq, tstate, None)
        flat = tscale.make_ota_serve(tflat, device=CPU)(tp, tq, tstate, None)
    finally:
        tphy.CHANNELS.pop("bsc_replay", None)
    return ref, got, flat


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
@pytest.mark.parametrize("channel", ["ideal", "bsc"])
def test_coarse_serve_at_full_keep_is_the_flat_serve(mesh, codebook, rep, channel):
    """keep == n_grp (c_core = 32, gs = 4: 8 groups, keep 8): the coarse serve
    equals JAX's, and the port's flat serve, in pred and maxsim."""
    ref, got, flat = _coarse_serves(mesh, codebook, SMALL, rep, channel, 0.05, 4, 8)
    for a, r, f in zip(got, ref, flat):
        _eq(a, r)
        assert torch.equal(a, f)


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
@pytest.mark.parametrize("channel", ["ideal", "bsc"])
def test_coarse_serve_real_screen_matches_jax(mesh, screen_codebook, rep, channel):
    ref, got, flat = _coarse_serves(mesh, screen_codebook, SCREEN, rep, channel, 0.02, 4, 2)
    for a, r in zip(got, ref):
        _eq(a, r)
    assert torch.equal(got[0], flat[0])          # the screen recalls every winner


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_coarse_fine_bank_rows_match_the_reference(rep):
    """`_coarse_fine_packed` / `_unpacked` against the reference's functions
    called directly, on a table of 3 banks searched by 6 banks (rows repeat),
    and without the indirection on the gathered banks."""
    t_, g, b, c_core, d, gs, keep = 3, 6, 5, 32, 256, 4, 3
    rng = np.random.default_rng(20)
    table = rng.integers(0, 2, (t_, c_core, d), dtype=np.uint8)
    q = rng.integers(0, 2, (g, b, d), dtype=np.uint8)
    rows = np.array([2, 0, 2, 1, 1, 0], np.int32)
    kw = dict(n_classes=c_core * 8, dim=d, m_tx=3, n_rx_cores=8, batch=b,
              representation=rep, coarse_group=gs, coarse_keep=keep)
    jcfg = jscale.ScaleOutConfig(**kw, use_kernels=False)
    tcfg = tscale.ScaleOutConfig(**kw)
    jt, jq = jnp.asarray(table), jnp.asarray(q)
    if rep == "packed":
        jt, jq = jhv.pack(jt), jhv.pack(jq)
    jfn = jscale._coarse_fine_packed if rep == "packed" else jscale._coarse_fine_unpacked
    tfn = tscale._coarse_fine_packed if rep == "packed" else tscale._coarse_fine_unpacked
    tt, tq = (convert.hv_from_numpy(np.asarray(x), CPU) for x in (jt, jq))
    ref = jfn(jcfg, jt, jq, jnp.asarray(rows))
    got = tfn(tcfg, tt, tq, torch.from_numpy(rows))
    for a, r in zip(got, ref):
        _eq(a, r)
    direct = tfn(tcfg, tt[torch.from_numpy(rows).long()], tq)
    assert all(torch.equal(a, r) for a, r in zip(got, direct))


def test_unpacked_screen_needs_the_tie_safe_top_k(monkeypatch):
    """Duplicate groups have equal summaries, so their screen similarities
    tie. `jax.lax.top_k` keeps the lower group first; the port's screen
    selects JAX's groups, where a plain `torch.topk` does not, and with it the
    coarse serve would answer from another row."""
    c_core, d, gs, keep = 64, 64, 4, 1
    rng = np.random.default_rng(21)
    half = rng.integers(0, 2, (1, c_core // 2, d), dtype=np.uint8)
    banks = np.concatenate([half, half], 1)                   # group j == group j + 8
    q = rng.integers(0, 2, (1, 64, d), dtype=np.uint8)
    kw = dict(n_classes=c_core, dim=d, m_tx=3, n_rx_cores=1, batch=64,
              coarse_group=gs, coarse_keep=keep)
    ref = jscale._coarse_fine_unpacked(jscale.ScaleOutConfig(**kw, use_kernels=False),
                                       jnp.asarray(banks), jnp.asarray(q))
    tb, tq = convert.hv_from_numpy(banks, CPU), convert.hv_from_numpy(q, CPU)
    tcfg = tscale.ScaleOutConfig(**kw)
    for a, r in zip(tscale._coarse_fine_unpacked(tcfg, tb, tq), ref):
        _eq(a, r)
    plain = lambda csims, k: torch.topk(csims, k, dim=-1).indices.to(torch.int32)  # noqa: E731
    monkeypatch.setattr(tscale, "_screen_topk", plain)
    _, row = tscale._coarse_fine_unpacked(tcfg, tb, tq)
    assert not np.array_equal(row.numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("bad,match", [(dict(permuted=True), "permuted"),
                                       (dict(coarse_group=3), "divide"),
                                       (dict(coarse_group=1), "divide"),
                                       (dict(coarse_keep=0), "coarse_keep"),
                                       (dict(dim=2**22, n_classes=8 * 2**10), "overflow")])
def test_validate_coarse_rejects_what_the_reference_rejects(bad, match):
    base = dict(n_classes=64, dim=512, m_tx=3, n_rx_cores=8, batch=8, coarse_group=4,
                coarse_keep=2)
    kw = {**base, **bad}
    with pytest.raises(ValueError, match=match):
        jscale._validate_coarse(jscale.ScaleOutConfig(**kw))
    with pytest.raises(ValueError, match=match):
        tscale._validate_coarse(tscale.ScaleOutConfig(**kw))
    with pytest.raises(ValueError, match=match):
        tscale.make_ota_serve(tscale.ScaleOutConfig(**kw), device=CPU)
    for ok in (dict(base, coarse_group=0), base):
        jscale._validate_coarse(jscale.ScaleOutConfig(**ok))
        tscale._validate_coarse(tscale.ScaleOutConfig(**ok))
