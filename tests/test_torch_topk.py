"""The port's fused top-k, per-bank search and masked majority (the plain
versions, on CPU tensors) against the JAX package, bit for bit.

JAX runs its ``use_kernel=False`` path (its streamed fallback, pinned equal
to interpret-mode Pallas by tests/test_topk.py and tests/test_kernels.py),
plus one interpret-mode Pallas case for each of the two kernels ported here
(`hamming_topk_k_banked_pallas`, `hamming_banked_pallas`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hypervector as jhv
from repro.kernels.hamming import hamming_search_banked as j_search_banked
from repro.kernels.hamming import hamming_topk_banked as j_topk
from repro_torch import convert
from repro_torch import kernels as tk
from repro_torch.core import hypervector as thv
from repro_torch.kernels.hamming import ref as href

# (g, b, c, d) of tests/test_topk.py: multi-tile class axes, shapes off the
# block sizes, c below k's headroom, a c spanning several 128-row tiles
SHAPES = [(4, 8, 128, 512), (3, 5, 7, 224), (8, 16, 2, 512), (1, 9, 300, 1024)]


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


def _t(a):
    return convert.hv_from_numpy(np.asarray(a), "cpu")


def _eq(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_array_equal(convert.to_numpy(port, words=ref.dtype == np.uint32), ref)


def _banks(g, b, c, d, seed=0):
    return _words(seed + g * b * c, (g, b, d // 32)), _words(seed + 7 * c, (g, c, d // 32))


@pytest.mark.parametrize("g,b,c,d", SHAPES)
def test_topk_matches_jax(g, b, c, d):
    q, p = _banks(g, b, c, d)
    for k in sorted({1, 2, min(5, c)}):
        dist, idx = tk.hamming_topk_banked(_t(q), _t(p), k=k)
        jd, ji = j_topk(jnp.asarray(q), jnp.asarray(p), k=k, use_kernel=False)
        assert dist.shape == (g, b, k) and dist.dtype == torch.int32
        _eq(dist, jd)
        _eq(idx, ji)


def test_topk_and_banked_search_equal_the_pallas_kernels_in_interpret_mode():
    q, p = _banks(2, 3, 20, 64, seed=1)
    dist, idx = tk.hamming_topk_banked(_t(q), _t(p), k=3)
    jd, ji = j_topk(jnp.asarray(q), jnp.asarray(p), k=3, interpret=True)
    _eq(dist, jd)
    _eq(idx, ji)
    _eq(tk.hamming_search_banked(_t(q), _t(p)),
        j_search_banked(jnp.asarray(q), jnp.asarray(p), interpret=True))


@pytest.mark.parametrize("g,b,c,w", [(1, 1, 1, 1), (3, 5, 130, 4), (8, 16, 300, 16)])
def test_hamming_search_banked_matches_jax(g, b, c, w):
    q, p = _words(g + b, (g, b, w)), _words(c + w, (g, c, w))
    _eq(tk.hamming_search_banked(_t(q), _t(p)),
        j_search_banked(jnp.asarray(q), jnp.asarray(p), use_kernel=False))


def test_topk_k1_equals_the_fused_top1():
    q, p = _banks(3, 7, 260, 512, seed=2)
    dist, idx = tk.hamming_topk_banked(_t(q), _t(p), k=1)
    d1, i1 = tk.hamming_topk_banked(_t(q), _t(p))
    assert torch.equal(dist[..., 0], d1) and torch.equal(idx[..., 0], i1)
    jd, ji = j_topk(jnp.asarray(q), jnp.asarray(p), use_kernel=False)
    _eq(d1, jd)
    _eq(i1, ji)


def test_topk_ties_keep_the_first_minimum_at_every_rank(monkeypatch):
    """The adversarial cases of tests/test_topk.py, with the plain version's
    class chunks cut to 8 columns so that every merge crosses a chunk edge:
    all rows identical (rank r is column r), and 12 rows at 0..11 bits from
    the query duplicated 12 columns on. Then the same at C = 300 with the
    copies straddling the CUDA kernel's 128-row tile edges."""
    g, b, c, d, k = 2, 4, 24, 256, 6
    monkeypatch.setattr(href, "CHUNK_ELEMS", g * b * (d // 32) * 8)
    q = _words(3, (g, b, d // 32))
    p = np.broadcast_to(_words(4, (g, 1, d // 32)), (g, c, d // 32)).copy()
    dist, idx = tk.hamming_topk_banked(_t(q), _t(p), k=k)
    assert idx.tolist() == np.broadcast_to(np.arange(k), (g, b, k)).tolist()
    assert bool((dist == dist[..., :1]).all())
    _eq(dist, j_topk(jnp.asarray(q), jnp.asarray(p), k=k, bc=8, use_kernel=False)[0])

    q_bits = np.random.default_rng(5).integers(0, 2, (g, d), dtype=np.uint8)
    flips = np.tril(np.ones((12, d), np.uint8), -1)[:, :d]       # row j: j bits set
    near = np.asarray(jhv.pack(jnp.asarray(q_bits[:, None, :] ^ flips[None])))  # [g, 12, W]
    q2 = np.asarray(jhv.pack(jnp.asarray(q_bits)))[:, None, :]
    for c2, at in ((24, (0, 12)), (300, (122, 250))):
        p2 = _words(6, (g, c2, d // 32))
        for a in at:
            p2[:, a:a + 12] = near
        dist, idx = tk.hamming_topk_banked(_t(q2), _t(p2), k=6)
        assert dist[:, 0].tolist() == [[0, 0, 1, 1, 2, 2]] * g
        want = [at[0], at[1], at[0] + 1, at[1] + 1, at[0] + 2, at[1] + 2]
        assert idx[:, 0].tolist() == [want] * g
        jd, ji = j_topk(jnp.asarray(q2), jnp.asarray(p2), k=6, bc=8, use_kernel=False)
        _eq(dist, jd)
        _eq(idx, ji)


def test_topk_ref_streams_equal_one_sort():
    """The plain top-k over many small chunks equals one sort of the unique
    (dist, col) keys, with ragged c_real."""
    q, p = _banks(2, 6, 70, 512, seed=7)
    tq, tp = _t(q), _t(p)
    full = href.hamming_search_banked_ref(tq, tp)[..., :61].to(torch.int64)
    keys = torch.sort((full << 32) + torch.arange(61), dim=-1).values[..., :5]
    dist, idx = tk.hamming_topk_banked(tq, tp, k=5, c_real=61)
    assert torch.equal(dist, (keys >> 32).to(torch.int32))
    assert torch.equal(idx, (keys & 0xFFFFFFFF).to(torch.int32))


@pytest.mark.parametrize("k", [None, 3])
def test_bank_rows_indirection_matches_jax(k):
    t_, g, b, c, d = 5, 8, 3, 40, 256
    q = _words(8, (g, b, d // 32))
    table = _words(9, (t_, c, d // 32))
    rows = np.array([4, 0, 4, 2, 2, 2, 1, 0], np.int32)              # repeats
    got = tk.hamming_topk_banked(_t(q), _t(table), k=k, bank_rows=torch.from_numpy(rows))
    ref = j_topk(jnp.asarray(q), jnp.asarray(table), k=k, bank_rows=jnp.asarray(rows),
                 use_kernel=False)
    for a, r in zip(got, ref):
        _eq(a, r)
    direct = tk.hamming_topk_banked(_t(q), _t(table[rows]), k=k)
    assert all(torch.equal(a, r) for a, r in zip(got, direct))


def test_topk_argument_checks():
    q, p = _t(_words(1, (2, 3, 4))), _t(_words(2, (2, 10, 4)))
    for k in (0, 11):
        with pytest.raises(ValueError, match="outside"):
            tk.hamming_topk_banked(q, p, k=k)
    with pytest.raises(ValueError, match="outside"):
        tk.hamming_topk_banked(q, p, k=6, c_real=5)
    with pytest.raises(ValueError, match="bank_rows"):
        tk.hamming_topk_banked(q, p, k=2, bank_rows=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="bank shapes"):
        tk.hamming_search_banked(q, p[:1])
    # the kernel's k limit covers the full-width screen's keep of 64
    assert tk.hamming.ops.MAX_K >= 64


def test_majority_packed_masked_matches_jax():
    m, n, d = 9, 6, 256
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, (m, n, d), dtype=np.uint8)
    words = np.asarray(jhv.pack(jnp.asarray(bits)))
    masks = [rng.random((m, n)) < 0.6,                   # random live counts
             np.zeros((m, n), bool),                     # empty: all-zero words
             np.arange(m)[:, None] < np.array([2, 4, 6, 8, 1, 9])[None, :]]  # even counts tie
    for mask in masks:
        got = thv.majority_packed_masked(_t(words), torch.from_numpy(mask))
        ref = jhv.majority_packed_masked(jnp.asarray(words), jnp.asarray(mask))
        _eq(got, ref)
        counts = (bits * mask[..., None]).sum(0)
        want = (counts * 2 > mask.sum(0)[..., None]).astype(np.uint8)
        np.testing.assert_array_equal(thv.unpack(got, d).numpy(), want)
    assert not thv.majority_packed_masked(_t(words), torch.from_numpy(masks[1])).any()
    # a mask over the leading axis only; all live == the unmasked majority
    full = thv.majority_packed_masked(_t(words), torch.ones(m, dtype=torch.bool))
    assert torch.equal(full, thv.majority_packed(_t(words)))
