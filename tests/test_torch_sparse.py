"""The port's sparse representation (repro_torch.core.sparse, the sparse
kernel ops and the sparse serve) against the JAX package, bit for bit, on
inputs made from a seed with numpy.

The BSC draws of the two packages come from different generators, so the
noisy paths are held by replaying JAX's own draws: `apply_noise` on JAX's
(drop, pos, acc), and `sparse._noise_draws` replaced by JAX's per-core
draws inside the serve. The kernel ops on CPU tensors run their plain
versions; they are held against JAX's oracles and against the Pallas
kernels in interpret mode at the reference's own sweep shapes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_test_mesh
from repro import phy as jphy
from repro.core import hypervector as jhv, scaleout as jscale, sparse as jsparse
from repro.kernels.sparse import sparse_search as j_search, sparse_topk_banked as j_topk
from repro.kernels.sparse.ref import sparse_search_ref as j_search_ref
from repro.kernels.sparse.ref import sparse_topk_banked_ref as j_topk_ref
from repro_torch import convert, kernels as tk, phy as tphy
from repro_torch.core import hypervector as thv, scaleout as tscale, sparse as tsparse

CPU = "cpu"
S = tsparse.SENTINEL


def _t(a):
    return convert.hv_from_numpy(np.asarray(a), CPU)


def _eq(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_array_equal(convert.to_numpy(port, words=ref.dtype == np.uint32), ref)


def _bits(seed, shape, p):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


def _lists(seed, n, d, k_max, p):
    """Sorted SENTINEL-padded index lists (numpy), via the JAX sparsify."""
    return np.array(jsparse.sparsify(jnp.asarray(_bits(seed, (n, d), p)), k_max))


# (seed, d, k_max, density): sparse rows, and dense rows that saturate k_max
CASES = [(0, 64, 8, 4 / 64), (1, 96, 12, 0.5), (2, 320, 24, 0.03), (3, 160, 32, 0.5)]


# ---------------------------------------------------------------------------
# the algebra, op by op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,d,k_max,p", CASES)
def test_sparsify_densify_count_match_jax(seed, d, k_max, p):
    bits = _bits(seed, (5, d), p)
    bits[1] = 0                                   # the empty HV
    ref = jsparse.sparsify(jnp.asarray(bits), k_max)
    got = tsparse.sparsify(_t(bits), k_max)
    _eq(got, ref)
    assert got.is_contiguous()
    _eq(tsparse.densify(got, d), jsparse.densify(ref, d))
    _eq(tsparse.count(got), jsparse.count(ref))
    _eq(tsparse.valid(got), jsparse.valid(ref))


@pytest.mark.parametrize("seed,d,k_max,p", CASES)
def test_bind_bundle_permute_match_jax(seed, d, k_max, p):
    a, b = _lists(seed, 4, d, k_max, p), _lists(seed + 10, 4, d, k_max, p)
    _eq(tsparse.bind(_t(a), _t(b)), jsparse.bind(jnp.asarray(a), jnp.asarray(b)))
    stack = np.stack([a, b, _lists(seed + 20, 4, d, k_max, p)], 1)    # [4, 3, k]
    _eq(tsparse.bundle(_t(stack)), jsparse.bundle(jnp.asarray(stack)))
    for shift in (0, 1, 37, -5):
        _eq(tsparse.permute(_t(a), shift, d), jsparse.permute(jnp.asarray(a), shift, d))


def test_bundle_with_abstaining_voters_matches_jax():
    """Five slots, the last two abstaining (all SENTINEL) at m = 3, and an
    even m = 2 whose ties go to 0."""
    d, k = 128, 16
    stack = np.stack([_lists(s, 6, d, k, 0.08) for s in range(5)], 1)
    stack[:, 3:] = S
    for m in (3, 2):
        _eq(tsparse.bundle(_t(stack), m=m), jsparse.bundle(jnp.asarray(stack), m=m))
    _eq(tsparse.bundle(_t(stack), m=torch.tensor(3, dtype=torch.int32)),
        jsparse.bundle(jnp.asarray(stack), m=jnp.int32(3)))


def test_empty_hv_through_every_op():
    d, k = 96, 8
    empty = np.full((2, k), S, np.int32)
    e = _t(empty)
    assert not tsparse.densify(e, d).any()
    assert torch.equal(tsparse.bind(e, e), e)
    assert torch.equal(tsparse.bundle(torch.stack([e, e, e], 1)), e)
    assert torch.equal(tsparse.permute(e, 3, d), e)
    assert tsparse.count(e).tolist() == [0, 0]
    words = np.random.default_rng(0).integers(0, 2**32, (5, d // 32), dtype=np.uint32)
    ov = tsparse.overlap(e, _t(words))
    _eq(ov, jsparse.overlap(jnp.asarray(empty), jnp.asarray(words)))
    _eq(tsparse.hamming_from_overlap(e, _t(words), ov),
        jsparse.hamming_from_overlap(jnp.asarray(empty), jnp.asarray(words),
                                     jnp.zeros((2, 5), jnp.int32)))


@pytest.mark.parametrize("seed,d,k_max,p", CASES)
def test_overlap_and_hamming_match_jax(seed, d, k_max, p):
    q = _lists(seed, 6, d, k_max, p)
    words = np.random.default_rng(seed).integers(0, 2**32, (7, d // 32), dtype=np.uint32)
    jov = jsparse.overlap(jnp.asarray(q), jnp.asarray(words))
    ov = tsparse.overlap(_t(q), _t(words))
    _eq(ov, jov)
    _eq(tsparse.hamming_from_overlap(_t(q), _t(words), ov),
        jsparse.hamming_from_overlap(jnp.asarray(q), jnp.asarray(words), jov))


def test_index_lists_round_trip_through_numpy():
    q = _lists(4, 3, 256, 16, 0.05)
    t = convert.hv_from_numpy(q, CPU)
    assert t.dtype == torch.int32 and int(t.max()) == S
    back = convert.to_numpy(t)
    assert back.dtype == np.int32
    np.testing.assert_array_equal(back, q)
    with pytest.raises(TypeError):
        convert.hv_from_numpy(q.astype(np.int64), CPU)


# ---------------------------------------------------------------------------
# the sparse BSC on replayed draws
# ---------------------------------------------------------------------------

def _jax_draws(key, shape, ber, d, k_max):
    return tuple(torch.from_numpy(np.array(x))
                 for x in jsparse._noise_draws(key, shape, ber, d, k_max))


@pytest.mark.parametrize("seed,d,k_max,p", CASES)
@pytest.mark.parametrize("ber", [0.0, 0.02, 0.3])
def test_flip_bits_sparse_on_jax_draws_matches_jax(seed, d, k_max, p, ber):
    idx = _lists(seed, 4, d, k_max, p)
    key = jax.random.PRNGKey(seed)
    ref = jsparse.flip_bits_sparse(key, jnp.asarray(idx), ber, d)
    got = tsparse.apply_noise(_t(idx), *_jax_draws(key, idx.shape, ber, d, k_max))
    _eq(got, ref)


def test_flip_bits_sparse_ref_on_jax_draws_and_port_self_consistency(monkeypatch):
    d, k_max, ber = 160, 16, 0.05
    bits = _bits(7, (4, d), 0.06)
    key = jax.random.PRNGKey(7)
    ref = jsparse.flip_bits_sparse_ref(key, jnp.asarray(bits), ber, k_max)
    with monkeypatch.context() as mp:
        mp.setattr(tsparse, "_noise_draws",
                   lambda g, shape, b, dd, kk: _jax_draws(key, shape, ber, dd, kk))
        _eq(tsparse.flip_bits_sparse_ref(None, _t(bits), ber, k_max), ref)
    # the port's own generator: the sparse channel equals its dense oracle
    got = tsparse.flip_bits_sparse(torch.Generator().manual_seed(1),
                                   tsparse.sparsify(_t(bits), k_max), ber, d)
    want = tsparse.flip_bits_sparse_ref(torch.Generator().manual_seed(1), _t(bits), ber, k_max)
    assert torch.equal(tsparse.densify(got, d), want)


# ---------------------------------------------------------------------------
# the kernel ops (plain versions on CPU) against JAX's oracles and Pallas
# ---------------------------------------------------------------------------

SEARCH_SHAPES = [(4, 100, 512, 16), (17, 33, 1024, 32), (8, 130, 224, 8)]
BANKED_SHAPES = [(4, 8, 128, 512, 16), (3, 5, 7, 224, 8), (1, 9, 130, 1024, 32)]


def _protos(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)


@pytest.mark.parametrize("b,c,d,k_max", SEARCH_SHAPES)
def test_sparse_search_matches_jax_oracle_and_pallas(b, c, d, k_max):
    q = _lists(b * c, b, d, k_max, 4.0 / d)
    q[0] = S                                        # an empty query
    p = _protos(c, (c, d // 32))
    jq, jp = jnp.asarray(q), jnp.asarray(p)
    got = tk.sparse_search(_t(q), _t(p))
    _eq(got, j_search_ref(jq, jp))
    _eq(got, j_search(jq, jp, interpret=True))


@pytest.mark.parametrize("g,b,c,d,k_max", BANKED_SHAPES)
def test_sparse_topk_banked_matches_jax_oracle_and_pallas(g, b, c, d, k_max):
    q = _lists(g * b * c, g * b, d, k_max, 4.0 / d).reshape(g, b, k_max)
    q[0, 0] = S
    p = _protos(g * c, (g, c, d // 32))
    jq, jp = jnp.asarray(q), jnp.asarray(p)
    dist, idx = tk.sparse_topk_banked(_t(q), _t(p))
    rv, ri = j_topk_ref(jq, jp)
    _eq(dist, rv)
    _eq(idx, ri)
    kv, ki = j_topk(jq, jp, interpret=True)
    _eq(dist, kv)
    _eq(idx, ki)


def test_sparse_topk_ties_and_empty_query_take_first_minimum():
    """Duplicates of the query across chunk boundaries: the first copy wins,
    as in the reference; an empty query's distance is popcount(p)."""
    d, c, k_max = 512, 300, 16
    q = _lists(5, 1, d, k_max, 8.0 / d)
    qp = np.asarray(jhv.pack(jsparse.densify(jnp.asarray(q), d)))[0]
    base = _protos(6, (c, d // 32))
    layouts = [(5, 17), (5, 200), (130, 260), (129, 130, 299)]
    p = np.stack([base] * len(layouts))             # one bank per layout
    for bank, dups in enumerate(layouts):
        p[bank, list(dups)] = qp
    qs = np.repeat(q[None], len(layouts), 0)
    dist, idx = tk.sparse_topk_banked(_t(qs), _t(p))
    assert dist.flatten().tolist() == [0] * len(layouts)
    assert idx.flatten().tolist() == [dups[0] for dups in layouts]
    _eq(idx, j_topk_ref(jnp.asarray(qs), jnp.asarray(p))[1])
    empty = np.full((1, 1, k_max), S, np.int32)
    dist, idx = tk.sparse_topk_banked(_t(empty), _t(base[None]))
    rv, ri = j_topk_ref(jnp.asarray(empty), jnp.asarray(base[None]))
    _eq(dist, rv)
    _eq(idx, ri)


def test_sparse_topk_c_real_against_pallas_and_the_two_reduction_carry():
    """c_real < C: padding rows equal to a query (distance 0) never win,
    held against the Pallas kernel in interpret mode on padded banks; and
    the reference's two-reduction carry (the path it takes where the key
    dist*C + col would overflow int32) agrees with the port."""
    from repro.kernels.sparse.kernel import sparse_topk_banked_pallas
    from repro.kernels.sparse.ops import _streamed_topk_banked

    g, b, c_real, w, k = 2, 8, 100, 4, 8
    q = _lists(3, g * b, 32 * w, k, 0.05).reshape(g, b, k)
    qp = np.asarray(jhv.pack(jsparse.densify(jnp.asarray(q[:, :1]), 32 * w)))
    p = np.concatenate([_protos(8, (g, c_real, w)),
                        np.broadcast_to(qp, (g, 128 - c_real, w))], axis=1)
    jq, jp = jnp.asarray(q), jnp.asarray(p)
    jd, ji = sparse_topk_banked_pallas(jq, jp, c_real=c_real, bq=8, bc=128, interpret=True)
    dist, idx = tk.sparse_topk_banked(_t(q), _t(p), c_real=c_real)
    _eq(dist, jd)
    _eq(idx, ji)
    assert int(idx.max()) < c_real
    kv, ki = _streamed_topk_banked(jq, jp[:, :c_real], 16, key_encode=False)
    dist, idx = tk.sparse_topk_banked(_t(q), _t(p[:, :c_real].copy()))
    _eq(dist, kv)
    _eq(idx, ki)


def test_sparse_wrappers_check_inputs_and_count_no_cpu_launch():
    q, p = _t(_lists(1, 2, 64, 4, 0.1)), _t(_protos(1, (3, 2)))
    tk.reset_launch_counts()
    tk.sparse_search(q, p)
    tk.sparse_topk_banked(q[None], p[None])
    assert tk.launch_counts() == dict.fromkeys(tk.WRAPPERS, 0)
    with pytest.raises(TypeError):
        tk.sparse_search(q.to(torch.int64), p)
    with pytest.raises(ValueError):
        tk.sparse_topk_banked(q[None], p[None], c_real=4)
    with pytest.raises(ValueError):
        tk.sparse_topk_banked(q[None], torch.stack([p, p]))
    # the C entries take no |p| scratch: the kernels count |p| as the rows
    # pass (pointers: q, protos, the outputs, the stream; then ints)
    from repro_torch.kernels import _build
    sig = {name: _build.SIGNATURES[name] for name in ("sparse_search_launch",
                                                       "sparse_topk_banked_launch")}
    assert [t.__name__ for t in sig["sparse_search_launch"]].count("c_void_p") == 4
    assert [t.__name__ for t in sig["sparse_topk_banked_launch"]].count("c_void_p") == 5


# ---------------------------------------------------------------------------
# the sparse serve on a (1, 1) mesh
# ---------------------------------------------------------------------------

BASE = dict(n_classes=64, dim=1024, m_tx=3, n_rx_cores=4, batch=16)
K_MAX = 40
BER = np.array([0.0, 0.01, 0.05, 0.2], np.float32)


@pytest.fixture(scope="module")
def serve_inputs():
    """A codebook whose rows fit k_max (lossless sparsify) and one draw of
    sparse queries, made by JAX."""
    key = jax.random.PRNGKey(0)
    protos_u = jsparse.densify(jsparse.random_sparse(key, 64, 1024, K_MAX, 8.0 / 1024), 1024)
    cfg = jscale.ScaleOutConfig(**BASE, representation="sparse", k_max=K_MAX,
                                collective="index_ag")
    _, q = jscale.make_queries(key, cfg, protos_u, 1)
    return np.asarray(protos_u), np.asarray(jhv.pack(protos_u)), np.asarray(q)


def _serve_cfgs(channel, collective):
    kw = dict(BASE, representation="sparse", k_max=K_MAX, collective=collective,
              channel=channel)
    return jscale.ScaleOutConfig(**kw, use_kernels=False), tscale.ScaleOutConfig(**kw)


def _jax_core_draws(key, ber, batch, d, k_max):
    """The draws JAX's sparse bsc makes on a (1, 1) mesh: core i draws
    _noise_draws(fold_in(fold_in(key, 0), i), (B, k_max), ber[i], ...)."""
    kq = jax.random.fold_in(key, 0)
    per = [jsparse._noise_draws(jax.random.fold_in(kq, i), (batch, k_max), jnp.float32(b),
                                d, k_max) for i, b in enumerate(ber)]
    return tuple(torch.from_numpy(np.stack([np.asarray(p[j]) for p in per])) for j in range(3))


@pytest.mark.parametrize("collective", ["index_ag", "psum"])
def test_sparse_ideal_serve_matches_jax_packed_and_reference(serve_inputs, collective):
    mesh = make_test_mesh((1, 1), ("data", "model"))
    protos_u, protos_p, q = serve_inputs
    jcfg, tcfg = _serve_cfgs("ideal", collective)
    jstate = jphy.state_from_ber(jnp.asarray(BER), 3)
    jpred, jsim = jscale.make_ota_serve(mesh, jcfg)(jnp.asarray(protos_p), jnp.asarray(q),
                                                     jstate, jax.random.PRNGKey(2))
    tstate = tphy.state_from_ber(torch.from_numpy(BER), 3)
    pred, sim = tscale.make_ota_serve(tcfg, device=CPU)(_t(protos_p), _t(q), tstate, None)
    _eq(pred, jpred)
    _eq(sim, jsim)
    rpred, rsim = tscale.serve_reference(tcfg, _t(protos_p), _t(q))
    _eq(rpred, jpred)
    _eq(rsim, jsim)
    # the packed serve on the densified queries answers the same
    pcfg = dataclasses.replace(tcfg, representation="packed", collective="psum", k_max=0)
    qp = thv.pack(tsparse.densify(_t(q), BASE["dim"]))
    ppred, psim = tscale.make_ota_serve(pcfg, device=CPU)(_t(protos_p), qp, tstate, None)
    assert torch.equal(ppred, pred) and torch.equal(psim, sim)


@pytest.mark.parametrize("collective", ["index_ag", "psum"])
def test_sparse_bsc_serve_on_jax_draws_matches_jax(serve_inputs, collective, monkeypatch):
    mesh = make_test_mesh((1, 1), ("data", "model"))
    _, protos_p, q = serve_inputs
    jcfg, tcfg = _serve_cfgs("bsc", collective)
    key = jax.random.PRNGKey(3)
    jstate = jphy.state_from_ber(jnp.asarray(BER), 3)
    jpred, jsim = jscale.make_ota_serve(mesh, jcfg)(jnp.asarray(protos_p), jnp.asarray(q),
                                                     jstate, key)
    draws = _jax_core_draws(key, BER, BASE["batch"], BASE["dim"], K_MAX)

    def replay(generator, shape, ber, d, k_max):
        assert tuple(shape) == tuple(draws[0].shape)
        return draws

    monkeypatch.setattr(tsparse, "_noise_draws", replay)
    tstate = convert.state_from_numpy({f: np.asarray(getattr(jstate, f))
                                       for f in tphy.ChannelState.FIELDS}, CPU)
    pred, sim = tscale.make_ota_serve(tcfg, device=CPU)(_t(protos_p), _t(q), tstate, None)
    _eq(pred, jpred)
    _eq(sim, jsim)
    ipred, _ = tscale.serve_reference(tcfg, _t(protos_p), _t(q))
    assert not torch.equal(ipred, pred)         # the noise mattered


def test_sparse_queries_and_serve_on_the_port_generator(serve_inputs):
    protos_u, protos_p, _ = serve_inputs
    _, tcfg = _serve_cfgs("bsc", "index_ag")
    codes = tsparse.sparsify(_t(protos_u), K_MAX)
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    cls, q = tscale.make_queries(g1, tcfg, _t(protos_u))
    cls2, q2 = tscale.make_queries(g2, tcfg, codes)          # index lists in, same draw
    assert torch.equal(cls, cls2) and torch.equal(q, q2)
    assert tuple(q.shape) == (16, 1, 3, K_MAX) and torch.equal(q[:, 0, 2], codes[cls[:, 2]])
    serve = tscale.make_ota_serve(tcfg, device=CPU)
    state = tphy.state_from_ber(torch.from_numpy(BER), 3)
    out = [serve(_t(protos_p), q, state, torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(out[0][0], out[1][0]) and out[0][0].dtype == torch.int32


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(representation="sparse", k_max=0, collective="index_ag"),
    dict(representation="sparse", k_max=8, collective="index_ag", permuted=True),
    dict(representation="sparse", k_max=8, collective="index_ag", coarse_group=4),
    dict(representation="sparse", k_max=8, collective="rs_ag"),
    dict(representation="sparse", k_max=8, collective="index_ag", channel="symbol"),
    dict(representation="packed", collective="index_ag"),
    dict(representation="auto", k_max=0, collective="psum"),
    dict(representation="dense"),
])
def test_sparse_config_validation_raises_as_the_reference(bad):
    base = dict(n_classes=16, dim=256, m_tx=3, n_rx_cores=4, batch=4)
    with pytest.raises(ValueError):
        tscale.ScaleOutConfig(**{**base, **bad})
    if bad.get("representation") != "dense":
        with pytest.raises(ValueError):
            jscale.ScaleOutConfig(**{**base, **bad})


def test_auto_resolution_and_crossover_table():
    cfg = tscale.ScaleOutConfig(n_classes=16, dim=2048, m_tx=3, n_rx_cores=4, batch=4,
                                representation="auto", k_max=32, collective="psum")
    lo = tscale.resolve_representation(cfg)
    assert lo.representation == "sparse" and lo.collective == "index_ag"
    hi = tscale.resolve_representation(dataclasses.replace(cfg, k_max=256))
    # packed takes the reference's guard-bit psum_packed wire
    assert hi.representation == "packed" and hi.collective == "psum_packed"
    for k_max, want in ((32, lo), (256, hi), (64, hi), (63, lo)):   # 64 / 2048 = 1/32
        jcfg = jscale.ScaleOutConfig(n_classes=16, dim=2048, m_tx=3, n_rx_cores=4, batch=4,
                                     representation="auto", k_max=k_max, collective="psum")
        got = tscale.resolve_representation(dataclasses.replace(cfg, k_max=k_max))
        assert got.representation == want.representation
        assert jscale.resolve_representation(jcfg).representation == want.representation
    assert tscale.DEFAULT_CROSSOVER == jscale.DEFAULT_CROSSOVER
    assert tscale.resolve_representation(lo) is lo
    headline = tscale.ScaleOutConfig(representation="auto", dim=2**20, k_max=2048)
    assert tscale.resolve_representation(headline).representation == "sparse"
    mid = dataclasses.replace(cfg, k_max=128)                  # density 1/16
    assert tscale.resolve_representation(mid).representation == "packed"
    try:
        tscale.set_crossover_table({"density": 1.0 / 8.0})    # clears the cache
        assert tscale.resolve_representation(mid).representation == "sparse"
    finally:
        tscale.set_crossover_table(None)
    assert tscale.resolve_representation(mid).representation == "packed"


def test_sparse_unsupported_serves_raise():
    cfg = tscale.ScaleOutConfig(n_classes=16, dim=256, m_tx=3, n_rx_cores=4, batch=4,
                                representation="sparse", k_max=8, collective="index_ag")
    with pytest.raises(ValueError):
        tscale.make_wired_serve(cfg, device=CPU)
    with pytest.raises(ValueError):
        tscale.make_ota_serve(cfg, device=CPU, faults=object())
    with pytest.raises(ValueError):
        tscale.make_ota_serve(cfg, device=CPU, process=object())
