"""Plain-PyTorch models of two kernels of ``src/repro_torch/csrc``, held bit
for bit against the JAX package's Pallas kernels in interpret mode.

* The fused per-bank top-1 (``hamming_top1_kernel``): block (query tile,
  split, bank) walks its split's 128-class tiles; after each tile's products
  (popc(q AND p) over 256-bit k steps, zeros past W) every thread takes, for
  each of its rows, v = |p| - 2 acc over its columns in the accumulator
  layout (warpgroup wg's classes wcol + 8 nt + 2 (lane % 4) + j, in that
  order), and keeps the first minimum (a strictly smaller v replaces); then
  the four threads of a quad, the two warpgroups (64-query tiles) and the
  splits of ``plan_top1`` meet by a lexicographic (v, col) min, and the
  distance is |q| + v.
* The majority bundle (``majority_kernel``): the byte values summed in
  16-bit lanes (``w & 0x00FF00FF`` and ``(w >> 8) & 0x00FF00FF`` added as
  32-bit words), flushed into 32-bit counts every 257 rows, and
  ``count > M // 2`` per byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hamming.kernel import hamming_topk_banked_pallas
from repro.kernels.majority import majority_bundle as j_majority
from repro.kernels.majority.kernel import majority_pallas
from repro_torch import convert
from repro_torch import kernels as tk
from repro_torch.kernels.common import popcount32
from repro_torch.kernels.hamming import ops as hops

INT_MAX = 2**31 - 1
SMS, WAVES = 132, 2                # an H100 SXM's SMs; the plan's blocks an SM
STEP = 8                           # words a k step (256 bits)
FLUSH = 257                        # rows a 16-bit lane sums exactly


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


def _t(a):
    return convert.hv_from_numpy(a, "cpu")


# ---------------------------------------------------------------------------
# the top-1
# ---------------------------------------------------------------------------

def split_ranges(splits: int, c_real: int) -> list:
    """The class range [start, stop) of every split: split s walks the tiles
    [s*T//S, (s+1)*T//S) of the T 128-class tiles under c_real."""
    t, tile = -(-c_real // hops.CLASS_TILE), hops.CLASS_TILE
    return [(tile * (i * t // splits), min(c_real, tile * ((i + 1) * t // splits)))
            for i in range(splits)]


def lex_min(d1, c1, d2, c2):
    """Elementwise lexicographic (dist, col) min of two pairs of tensors."""
    take = (d2 < d1) | ((d2 == d1) & (c2 < c1))
    return torch.where(take, d2, d1), torch.where(take, c2, c1)


def owners(bm: int) -> torch.Tensor:
    """[128] owner of each column of a class tile: warpgroup * 4 + lane % 4
    among the threads of one query row (at 128-query tiles one warpgroup
    holds all 128 classes of its 64 rows; at 64-query tiles warpgroup wg
    holds classes [64 wg, 64 wg + 64))."""
    c = torch.arange(hops.CLASS_TILE)
    wg = torch.zeros_like(c) if bm == 128 else c // 64
    return wg * 4 + (c % 8) // 2


def model_top1(q: torch.Tensor, p: torch.Tensor, c_real: int, sms: int = SMS):
    """q [G, B, W], p [G, C, W] int32 -> (dist, idx) [G, B], as the kernel
    computes them: the products by k steps, every thread's running first
    minimum over its columns, then quad, warpgroup and split merges."""
    g, b, w = q.shape
    bm, splits = hops.plan_top1(g, b, c_real, sms)
    pad = (-w) % STEP
    qz = torch.cat([q, q.new_zeros(g, b, pad)], -1).long()
    pz = torch.cat([p, p.new_zeros(g, p.shape[1], pad)], -1).long()
    cq = popcount32(qz).sum(-1)                                   # [G, B]
    own = owners(bm)
    n_own = int(own.max()) + 1
    out = None
    for start, stop in split_ranges(splits, c_real):
        # [G, B, owner] running best (v, col) of each thread's rows
        bv = torch.full((g, b, n_own), INT_MAX, dtype=torch.long)
        bc = torch.full((g, b, n_own), INT_MAX, dtype=torch.long)
        for c0 in range(start, stop, hops.CLASS_TILE):
            tile = pz[:, c0:c0 + hops.CLASS_TILE]
            acc = torch.zeros(g, b, tile.shape[1], dtype=torch.long)
            for s0 in range(0, w + pad, STEP):                    # one 256-bit k step
                acc += popcount32(qz[:, :, None, s0:s0 + STEP]
                                  & tile[:, None, :, s0:s0 + STEP]).sum(-1)
            v = popcount32(tile).sum(-1)[:, None, :] - 2 * acc     # |p| - 2 acc
            cols = c0 + torch.arange(tile.shape[1])
            v = torch.where(cols < c_real, v, torch.full_like(v, INT_MAX))
            for o in range(n_own):
                mine = (own[:tile.shape[1]] == o).nonzero().flatten()   # increasing columns
                if not len(mine):         # columns past C (the kernel's are past c_real)
                    continue
                vo = v[..., mine]
                m = vo.min(-1).values
                first = mine[(vo == m[..., None]).long().argmax(-1)]    # first column at m
                better = m < bv[..., o]
                bv[..., o] = torch.where(better, m, bv[..., o])
                bc[..., o] = torch.where(better, c0 + first, bc[..., o])
        # the quad (lanes of one warpgroup), then the two warpgroups
        d, c = bv[..., 0], bc[..., 0]
        for o in range(1, n_own):
            d, c = lex_min(d, c, bv[..., o], bc[..., o])
        out = (d, c) if out is None else lex_min(*out, d, c)     # the split merge
    return (cq + out[0]).int(), out[1].int()


def pallas_top1(q, p, c_real):
    """JAX's fused top-1 kernel in interpret mode (B padded to its 8-row
    block; C to a multiple of 128, the padding masked by c_real)."""
    g, b, w = q.shape
    bp, cp = -(-b // 8) * 8, -(-p.shape[1] // 128) * 128
    qp = np.concatenate([q, np.zeros((g, bp - b, w), np.uint32)], 1)
    pp = np.concatenate([p, np.zeros((g, cp - p.shape[1], w), np.uint32)], 1)
    jd, ji = hamming_topk_banked_pallas(jnp.asarray(qp), jnp.asarray(pp), c_real=c_real,
                                        interpret=True)
    return np.asarray(jd)[:, :b], np.asarray(ji)[:, :b]


TOP1_CASES = {
    # (G, B, C, W, c_real): 64-query tiles and one split a tile at these sizes
    "random words": (2, 9, 300, 16, 300),
    "all rows equal": (2, 8, 640, 4, 640),
    "ties across split edges": (2, 16, 768, 8, 768),
    "c_real inside the last split": (2, 8, 700, 16, 650),
    "W=5": (1, 12, 400, 5, 400),
}


@pytest.mark.parametrize("case", list(TOP1_CASES))
def test_top1_model_equals_the_pallas_top1(case):
    g, b, c, w, c_real = TOP1_CASES[case]
    q, p = _words(1, (g, b, w)), _words(2, (g, c, w))
    if case == "all rows equal":
        p[:] = p[:, :1]
    if case.startswith("ties"):
        # equal copies of query 0's row straddle every split edge but the last
        edges = [a for a, _ in split_ranges(hops.plan_top1(g, b, c_real, SMS)[1], c_real)][1:]
        assert len(edges) >= 2
        for e in edges:
            p[:, e - 2:e + 2] = q[:, :1]
    if case.startswith("c_real"):
        p[:, c_real:] = q[:, :1]      # past c_real: distance 0 to query 0, must never win
    md, mi = model_top1(_t(q), _t(p), c_real)
    jd, ji = pallas_top1(q, p, c_real)
    np.testing.assert_array_equal(md.numpy(), jd)
    np.testing.assert_array_equal(mi.numpy(), ji)
    if case == "all rows equal":
        assert (mi == 0).all()
    if case.startswith("ties"):
        assert (mi[:, 0] == edges[0] - 2).all() and (md[:, 0] == 0).all()
    if case.startswith("c_real"):
        assert (mi < c_real).all()
    # the port's plain twin (what the card's result is held to) agrees
    td, ti = tk.hamming_topk_banked(_t(q), _t(p), c_real=c_real)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(ti.numpy(), ji)


@pytest.mark.parametrize("sms,tile", [(SMS, 64), (4, 128)])
def test_top1_model_at_each_query_tile_over_many_splits(sms, tile):
    """With few SMs the plan takes 128-query tiles (one warpgroup a row's
    128 classes), with many 64 (two warpgroups share a row), over several
    splits either way."""
    g, b, c, w = 1, 130, 1000, 16
    bm, splits = hops.plan_top1(g, b, c, sms)
    assert bm == tile and splits > 1
    q, p = _words(3, (g, b, w)), _words(4, (g, c, w))
    p[:, 500:510] = q[:, :1]
    md, mi = model_top1(_t(q), _t(p), c, sms)
    jd, ji = pallas_top1(q, p, c)
    np.testing.assert_array_equal(md.numpy(), jd)
    np.testing.assert_array_equal(mi.numpy(), ji)
    assert int(mi[0, 0]) == 500


@pytest.mark.parametrize("g,b,c_real", [(8, 512, 12800), (64, 256, 100), (192, 256, 100),
                                        (64, 4096, 1600), (1, 6400, 25600), (11, 2000, 100),
                                        (64, 256, 400), (2, 64, 3000), (1, 1, 1), (3, 77, 129)])
def test_plan_top1_covers_every_class_tile_once(g, b, c_real):
    bm, splits = hops.plan_top1(g, b, c_real, SMS)
    tiles = -(-c_real // hops.CLASS_TILE)
    ranges = split_ranges(splits, c_real)
    assert bm in (64, 128) and 1 <= splits <= tiles
    assert ranges[0][0] == 0 and ranges[-1][1] == c_real
    assert all(z == a2 for (_, z), (a2, _) in zip(ranges, ranges[1:]))
    assert all(a < z and a % hops.CLASS_TILE == 0 for a, z in ranges)
    if c_real <= hops.CLASS_TILE:
        assert splits == 1
    # 128-query tiles only where, split to one tile a block, they fill the card twice
    assert (bm == 128) == (g * -(-b // 128) * tiles >= WAVES * SMS)
    # no split count takes fewer waves x (tiles a block + 1)
    pairs, slots = g * -(-b // bm), WAVES * SMS

    def cost(s):
        return -(-pairs * s // slots) * (-(-tiles // s) + 1)

    assert all(cost(splits) <= cost(s) for s in range(1, tiles + 1))


def test_plan_top1_at_the_main_path_shapes():
    # the flat serve at C = 102,400: 8 x 4 (bank, 128-query tile) pairs, 8
    # splits: 256 blocks, one wave of two blocks an SM (9 would leave a second)
    assert hops.plan_top1(8, 512, 12800, SMS) == (128, 8)
    assert hops.plan_top1(64, 256, 100, SMS) == (64, 1)         # the OTA serve
    assert hops.plan_top1(192, 256, 100, SMS) == (128, 1)       # permuted
    assert hops.plan_top1(1, 6400, 25600, SMS) == (128, 5)      # multi-centroid predict
    with pytest.raises(ValueError):
        hops.plan_top1(1, 0, 10, SMS)


def test_top1_accepts_words_past_the_old_limit():
    """W = 400 (past the SIMT kernel's 360): the wrapper's plain twin against
    the JAX op's plain path, and the model."""
    from repro.kernels.hamming import hamming_topk_banked as j_topk

    q, p = _words(5, (1, 4, 400)), _words(6, (1, 130, 400))
    td, ti = tk.hamming_topk_banked(_t(q), _t(p))
    jd, ji = j_topk(jnp.asarray(q), jnp.asarray(p), use_kernel=False)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    md, mi = model_top1(_t(q), _t(p), 130)
    assert torch.equal(md, td) and torch.equal(mi, ti)


# ---------------------------------------------------------------------------
# the majority
# ---------------------------------------------------------------------------

def model_majority(x: np.ndarray, flush: int = FLUSH) -> np.ndarray:
    """[M, N] uint8 -> [N] uint8 as the kernel counts: 16-bit lanes of
    little-endian words, flushed into 32-bit counts every `flush` rows."""
    m, n = x.shape
    words = np.zeros((m, -(-n // 4) * 4), np.uint8)
    words[:, :n] = x
    w = words.view("<u4")                                         # [M, N / 4]
    counts = np.zeros((4, w.shape[1]), np.uint64)                 # byte k of each word
    for m0 in range(0, m, flush):
        lo = np.zeros(w.shape[1], np.uint32)
        hi = np.zeros(w.shape[1], np.uint32)
        for row in w[m0:m0 + flush]:
            lo += row & np.uint32(0x00FF00FF)                     # bytes 0 and 2
            hi += (row >> np.uint32(8)) & np.uint32(0x00FF00FF)   # bytes 1 and 3
        counts += np.stack([lo & 0xFFFF, hi & 0xFFFF, lo >> 16, hi >> 16]).astype(np.uint64)
    out = (counts > m // 2).astype(np.uint8)                      # count * 2 > M
    return out.T.reshape(-1)[:n]


@pytest.mark.parametrize("m", [1, 2, 3, 256, 257, 258, 300])
def test_majority_model_on_every_byte_value(m):
    rng = np.random.default_rng(m)
    x = rng.integers(0, 256, size=(m, 32, 128), dtype=np.uint8)
    x[:, 0, :8] = 255                                             # the lanes' largest sums
    x[:, 0, 8:16] = 0
    got = model_majority(x.reshape(m, -1)).reshape(32, 128)
    np.testing.assert_array_equal(got, np.asarray(majority_pallas(jnp.asarray(x),
                                                                  interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(j_majority(jnp.asarray(x), use_kernel=False)))
    np.testing.assert_array_equal(got, tk.majority_bundle(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("m,b,d", [(4, 3, 333), (2, 1, 1), (6, 5, 17), (300, 2, 9)])
def test_majority_model_on_odd_widths_and_even_m(m, b, d):
    """N not a multiple of 16 (nor of 4); even M, whose ties give 0."""
    x = np.random.default_rng(m * d).integers(0, 2, size=(m, b, d), dtype=np.uint8)
    x[: m // 2, 0, 0], x[m // 2:, 0, 0] = 1, 0                    # an exact tie: 0
    got = model_majority(x.reshape(m, -1)).reshape(b, d)
    np.testing.assert_array_equal(got, np.asarray(j_majority(jnp.asarray(x), use_kernel=False)))
    assert got[0, 0] == 0


def test_majority_flush_every_257_rows_is_needed():
    """257 rows of 255 fill a 16-bit lane exactly (65535); one more row of 1
    without a flush wraps the lane to 0 and loses the majority."""
    x = np.full((258, 64), 255, np.uint8)
    x[257] = 1
    assert model_majority(x).all()
    assert not model_majority(x, flush=258).any()                 # the wrapped lanes
    assert 257 * 255 == 0xFFFF
