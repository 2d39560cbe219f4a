"""The sparse kernels' plain twins against the Pallas kernels (interpret
mode) on the inputs that the CUDA kernels' segmented walk singles out:
indices on segment and row edges, lists with every slot live, lists whose
live slots fall in one segment, empty queries, and c_real < C past one
128-class tile; and the launch plan (`repro_torch.kernels.sparse.ops.plan`):
its segments cover W exactly, its buffers fit a block's shared memory, and a
walk over its segments (as the kernels walk: 32-slot windows, runs below a
segment's end bit, split walks starting at a searched slot) counts every
live index once."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.sparse import sparse_search as j_search, sparse_topk_banked as j_topk
from repro.kernels.sparse.kernel import sparse_topk_banked_pallas
from repro_torch import convert, kernels as tk
from repro_torch.core import sparse as tsparse
from repro_torch.kernels.sparse.ops import CLASS_TILE, SMEM_MAX, plan

S = tsparse.SENTINEL


def _t(a):
    return convert.hv_from_numpy(np.asarray(a), "cpu")


def _eq(port, ref):
    np.testing.assert_array_equal(convert.to_numpy(port), np.asarray(ref))


def _protos(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)


def _pad(rows, k):
    """Sorted index rows -> [n, k] int32, SENTINEL-padded."""
    q = np.full((len(rows), k), S, np.int32)
    for r, idx in enumerate(rows):
        idx = sorted(set(int(i) for i in idx))[:k]
        q[r, :len(idx)] = idx
    return q


def _random_rows(seed, n, d, k, density):
    rng = np.random.default_rng(seed)
    return [np.flatnonzero(rng.random(d) < density)[:k] for _ in range(n)]


def _edge_lists(seed, n, w, k, wseg):
    """The first and last bits of the row and of every segment of wseg words;
    the live slots of one list all in the middle segment; an empty list;
    random lists for the rest."""
    d, seg = 32 * w, 32 * wseg
    starts = range(0, d, seg)
    mid = starts[len(starts) // 2]
    rng = np.random.default_rng(seed)
    rows = [[0, seg - 1, seg, d - 1],
            [b for s in starts for b in (s, min(d, s + seg) - 1)],
            mid + rng.choice(min(seg, d - mid), size=min(k, 20), replace=False),
            []]
    return _pad(rows + _random_rows(seed, n - len(rows), d, k, 0.01), k)


def _full_lists(seed, n, w, k):
    """Every slot live: one index in each of k equal strides of the row."""
    stride = 32 * w // k
    rng = np.random.default_rng(seed)
    return (np.arange(k) * stride + rng.integers(0, stride, (n, k))).astype(np.int32)


# W = 400 words with 100 classes: the kernels' plan cuts the row in three
# segments (176, 176, 48); W = 64 in one
EDGE_W, EDGE_C, EDGE_K = 400, 100, 64


@pytest.mark.parametrize("kind", ["edges", "full"])
def test_sparse_search_edge_and_full_lists_match_pallas(kind):
    w, c, k, b = EDGE_W, EDGE_C, EDGE_K, 8
    wseg = plan(b, c, w, search=True).wseg
    assert 1 < -(-w // wseg) and w % wseg                  # several segments, a ragged last
    q = _edge_lists(1, b, w, k, wseg) if kind == "edges" else _full_lists(1, b, w, k)
    p = _protos(2, (c, w))
    _eq(tk.sparse_search(_t(q), _t(p)), j_search(jnp.asarray(q), jnp.asarray(p),
                                                 interpret=True))


@pytest.mark.parametrize("kind", ["edges", "full"])
def test_sparse_topk_banked_edge_and_full_lists_match_pallas(kind):
    g, b, w, c, k = 2, 8, EDGE_W, EDGE_C, EDGE_K
    wseg = plan(b, c, w, banks=g).wseg
    q = np.stack([_edge_lists(3 + i, b, w, k, wseg) if kind == "edges"
                  else _full_lists(3 + i, b, w, k) for i in range(g)])
    p = _protos(4, (g, c, w))
    dist, idx = tk.sparse_topk_banked(_t(q), _t(p))
    kv, ki = j_topk(jnp.asarray(q), jnp.asarray(p), interpret=True)
    _eq(dist, kv)
    _eq(idx, ki)


def test_one_segment_lists_and_empty_queries_match_jax():
    """Every live slot of each query inside one segment of the kernels'
    plan (a different one per query), and all-SENTINEL queries."""
    b, w, c, k = 6, EDGE_W, EDGE_C, 16
    wseg = plan(b, c, w, search=True).wseg
    rng = np.random.default_rng(5)
    rows = []
    for r in range(b):
        s0 = (r % 3) * 32 * wseg
        rows.append([] if r >= 4 else s0 + rng.choice(min(32 * wseg, 32 * w - s0), 12,
                                                       replace=False))
    q = _pad(rows, k)
    p = _protos(6, (c, w))
    jq, jp = jnp.asarray(q), jnp.asarray(p)
    got = tk.sparse_search(_t(q), _t(p))
    _eq(got, j_search(jq, jp, interpret=True))
    pop = np.unpackbits(p.view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(convert.to_numpy(got)[4:], np.broadcast_to(pop, (2, c)))


@pytest.mark.parametrize("c,c_real", [(33, 30), (333, 300), (333, 129)])
def test_c_real_below_c_past_a_class_tile_matches_pallas(c, c_real):
    """Columns at or past c_real never win, with C below, at and past the
    kernels' 128-class tile: the twin against the Pallas kernel (one class
    block of C, poisoned past c_real), padding rows equal to a query."""
    g, b, w, k = 2, 8, 8, 16
    q = np.stack([_pad(_random_rows(7 + i, b, 32 * w, k, 0.05), k) for i in range(g)])
    p = _protos(8, (g, c, w))
    dense = np.zeros((32 * w,), np.uint8)
    dense[q[0, 0][q[0, 0] != S]] = 1
    p[:, c_real:] = _pack_row(dense)              # padding rows at distance 0 from q[0, 0]
    jd, ji = sparse_topk_banked_pallas(jnp.asarray(q), jnp.asarray(p), c_real=c_real, bq=b,
                                       bc=c, interpret=True)
    dist, idx = tk.sparse_topk_banked(_t(q), _t(p), c_real=c_real)
    _eq(dist, jd)
    _eq(idx, ji)
    assert int(idx.max()) < c_real


def _pack_row(bits):
    """Bits [d] (index i -> word i // 32, bit i % 32) -> uint32 words [d // 32]."""
    return (bits.reshape(-1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)


# (B, C, W, banks, search): the main path's shapes, the chip cases and edges
PLAN_SHAPES = [(2000, 100, 32768, 1, True), (256, 6400, 32768, 1, True),
               (256, 100, 32768, 64, False), (77, 333, 1000, 3, False),
               (40, 129, 1000, 1, True), (20, 150, 65536, 2, False), (20, 150, 65536, 1, True),
               (4, 1, 1, 1, True), (1, 7, 999, 1, True), (300, 33, 2**25, 8, False)]


@pytest.mark.parametrize("b,c,w,banks,search", PLAN_SHAPES)
def test_plan_segments_cover_w_and_fit_shared_memory(b, c, w, banks, search):
    pl = plan(b, c, w, banks=banks, search=search)
    seg = pl.segments(w)
    assert seg[0][0] == 0 and seg[-1][1] == w
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(seg, seg[1:]))
    assert all(0 < e - s <= pl.wseg for s, e in seg)
    assert pl.wseg % 8 == 0 and pl.qpw in (1, 2, 4, 8)
    assert pl.rows == min(c, CLASS_TILE) and pl.stride >= pl.rows and pl.stride % 4 == 0
    assert pl.smem <= SMEM_MAX
    parts = pl.split_segments(w)
    assert len(parts) == pl.splits and all(parts)
    assert [s for part in parts for s in part] == seg
    assert search or pl.splits == 1


def test_plan_refuses_rows_past_int32_bit_indices():
    with pytest.raises(ValueError):
        plan(1, 1, 2**26)
    with pytest.raises(ValueError):
        plan(1, 0, 8)


def _lower_bound_warp(row, s):
    """The kernels' warp-wide search: the first slot of a sorted row >= s,
    32 probes a round."""
    lo, hi = 0, len(row)
    while lo < hi:
        step = (hi - lo + 31) >> 5
        n = sum(int(row[p]) < s for p in range(lo, hi, step)[:32])
        if n == 0:
            hi = lo
        else:
            hi, lo = min(hi, lo + n * step), lo + (n - 1) * step + 1
    return lo


def _walk(q, w, pl):
    """(|q| in the split's range, the indices visited) of one query, walked
    as the kernels walk each split of the plan."""
    k = len(q)
    counts, seen = [], []
    for part in pl.split_segments(w):
        base = _lower_bound_warp(q, 32 * part[0][0]) if part[0][0] else 0
        win, pos, cnt = list(q[base:base + 32]) + [S] * max(0, base + 32 - k), 0, 0
        for _, w1 in part:
            end = 32 * w1
            while True:
                n = sum(int(x) < end for x in win)
                seen += win[pos:n]
                cnt += n - pos
                if n < 32:
                    pos = n
                    break
                base, pos = base + 32, 0
                win = list(q[base:base + 32]) + [S] * max(0, base + 32 - k)
        counts.append(cnt)
    return counts, seen


@pytest.mark.parametrize("b,c,w,k", [(4, 100, 32768, 2048), (3, 7, 10000, 300),
                                     (2, 129, 999, 64)])
def test_walk_over_the_plan_visits_every_live_index_once(b, c, w, k):
    pl = plan(b, c, w, search=True)
    assert pl.splits > 1
    for q in (list(_full_lists(9, 2, w, k)) + list(_pad(_random_rows(10, b, 32 * w, k, 0.002), k))
              + [np.full(k, S, np.int32)]):
        counts, seen = _walk(q, w, pl)
        live = [int(x) for x in q if x != S]
        assert seen == live and sum(counts) == len(live)
