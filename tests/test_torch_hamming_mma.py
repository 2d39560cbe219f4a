"""Plain-PyTorch models of the two tensor-core Hamming kernels of
``src/repro_torch/csrc/hamming.cu``, held bit for bit against the JAX
package's Pallas kernels in interpret mode.

* The search tile: H = |q| + |p| - 2 popc(q AND p), the AND-popcount taken
  as the 1-bit ``mma.sync m16n8k256`` sums it: words padded with zeros to a
  multiple of 8, staged in ring chunks of 32 words, and each 8-word k step's
  words in the k order of the fragment loads (thread t's registers a0/b0 and
  a2/b1 hold words 2t and 2t + 1); |q| and |p| summed over the 16-byte
  chunks as they are staged. The same product on the {0,1} expansions
  (`hv.unpack`) equals it.
* The class-split top-k: each split of ``plan`` ranks its class range by the
  kernel's insertion rule (128-column tiles, columns in order, a column that
  beats the worst entry goes in after every entry of equal or smaller
  distance), and the split lists merge by rank: an entry's position in its
  own list plus, in each other list, the entries lexicographically below it.
"""
import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hypervector as jhv
from repro.kernels.hamming import hamming_search_banked as j_search_banked
from repro.kernels.hamming.kernel import hamming_topk_k_banked_pallas
from repro_torch import convert
from repro_torch.core import hypervector as thv
from repro_torch.kernels.common import popcount32
from repro_torch.kernels.hamming import ops as hops

KC = 32                            # words of a row a ring stage
STEP = 8                           # words a k step (256 bits)
FRAG = [0, 2, 4, 6, 1, 3, 5, 7]    # word at k block i: a0/b0 of thread i < 4, a2/b1 of i - 4
INT_MAX = 2**31 - 1
SMS, WAVES = 132, 2                # an H100 SXM's SMs; the plan's blocks an SM


def _words(seed, shape, kind="random"):
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)
    fill = {"zeros": 0, "ones": 0xFFFFFFFF, "sign bits": 0x80000000}[kind]
    return np.full(shape, fill, dtype=np.uint32)


def _t(a):
    return convert.hv_from_numpy(a, "cpu")


def _eq(port, ref):
    np.testing.assert_array_equal(convert.to_numpy(port), np.asarray(ref))


def model_tile(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """q [G, B, W], p [G, C, W] int32 -> [G, B, C] int32, as the kernel's
    tile computes it."""
    g, b, w = q.shape
    c = p.shape[1]
    pad = (-w) % STEP
    qz = torch.cat([q, q.new_zeros(g, b, pad)], -1)
    pz = torch.cat([p, p.new_zeros(g, c, pad)], -1)
    acc = torch.zeros(g, b, c, dtype=torch.int32)
    cq = torch.zeros(g, b, dtype=torch.int32)
    cp = torch.zeros(g, c, dtype=torch.int32)
    for k0 in range(0, w + pad, KC):
        stop = min(k0 + KC, w + pad)
        for s0 in range(k0, stop, STEP):
            qs, ps = qz[..., s0:s0 + STEP][..., FRAG], pz[..., s0:s0 + STEP][..., FRAG]
            acc += popcount32(qs[:, :, None, :] & ps[:, None, :, :]).sum(-1, dtype=torch.int32)
        for c0 in range(k0, stop, 4):
            cq += popcount32(qz[..., c0:c0 + 4]).sum(-1, dtype=torch.int32)
            cp += popcount32(pz[..., c0:c0 + 4]).sum(-1, dtype=torch.int32)
    return cq[:, :, None] + cp[:, None, :] - 2 * acc


def split_topk(dist: np.ndarray, k: int, start: int, stop: int):
    """One split's buffers [G, B] of k (dist, col) pairs, by the kernel's
    insertion over 128-column tiles of [start, stop)."""
    g, b, _ = dist.shape
    out = np.empty((g, b, k, 2), dtype=np.int64)
    for gi in range(g):
        for bi in range(b):
            bd, bc = [INT_MAX] * k, [INT_MAX] * k
            for t0 in range(start, stop, hops.CLASS_TILE):
                for col in range(t0, min(t0 + hops.CLASS_TILE, stop)):
                    d = int(dist[gi, bi, col])
                    if d < bd[-1]:
                        pos = sum(1 for x in bd if x <= d)
                        bd.insert(pos, d)
                        bc.insert(pos, col)
                        bd.pop()
                        bc.pop()
            out[gi, bi, :, 0], out[gi, bi, :, 1] = bd, bc
    return out


def merge_splits(lists: list, k: int):
    """The merge kernel: every real entry to its rank among all splits."""
    g, b = lists[0].shape[:2]
    dist = np.full((g, b, k), -1, dtype=np.int64)
    idx = np.full((g, b, k), -1, dtype=np.int64)
    for gi in range(g):
        for bi in range(b):
            keys = [[tuple(e) for e in lst[gi, bi]] for lst in lists]
            for s, own in enumerate(keys):
                for r, key in enumerate(own):
                    if key[1] == INT_MAX:
                        continue
                    rank = r + sum(bisect.bisect_left(other, key)
                                   for o, other in enumerate(keys) if o != s)
                    if rank < k:
                        dist[gi, bi, rank], idx[gi, bi, rank] = key
    return dist, idx


def split_ranges(splits: int, c_real: int) -> list:
    """The class range [start, stop) of every split, in split order: split s
    walks the tiles [s*T//S, (s+1)*T//S) of the T 128-class tiles."""
    t, tile = -(-c_real // hops.CLASS_TILE), hops.CLASS_TILE
    return [(tile * (i * t // splits), min(c_real, tile * ((i + 1) * t // splits)))
            for i in range(splits)]


def model_topk(q, p, k, c_real, splits=None):
    splits = hops.plan(q.shape[0], q.shape[1], c_real, SMS) if splits is None else splits
    dist = model_tile(q, p).numpy()
    return merge_splits([split_topk(dist, k, a, z) for a, z in split_ranges(splits, c_real)], k)


def pallas_topk(q, p, k, c_real):
    """JAX's fused top-k kernel in interpret mode (B padded to its 8-row
    block; C a multiple of 128, columns past c_real masked by the kernel)."""
    g, b, w = q.shape
    bp = -(-b // 8) * 8
    qp = np.concatenate([q, np.zeros((g, bp - b, w), np.uint32)], 1)
    jd, ji = hamming_topk_k_banked_pallas(jnp.asarray(qp), jnp.asarray(p), c_real=c_real, k=k,
                                          interpret=True)
    return np.asarray(jd)[:, :b], np.asarray(ji)[:, :b]


@pytest.mark.parametrize("kind", ["random", "zeros", "ones", "sign bits"])
@pytest.mark.parametrize("g,b,c,w", [(2, 9, 130, 5), (1, 16, 200, 16), (2, 5, 129, 76)])
def test_tile_model_equals_the_pallas_search(kind, g, b, c, w):
    q = _words(g * b + w, (g, b, w), kind)
    p = _words(c + w, (g, c, w), "random" if kind == "random" else kind)
    if kind != "random":            # half the classes random, so the distances vary
        p[:, ::2] = _words(c, (g, (c + 1) // 2, w))
    got = model_tile(_t(q), _t(p))
    _eq(got, j_search_banked(jnp.asarray(q), jnp.asarray(p), interpret=True))
    # the same product on the {0,1} expansions, the bits in the reference's order
    q01, p01 = thv.unpack(_t(q), 32 * w), thv.unpack(_t(p), 32 * w)
    np.testing.assert_array_equal(q01.numpy(), np.asarray(jhv.unpack(jnp.asarray(q), 32 * w)))
    dot = torch.einsum("gbk,gck->gbc", q01.int(), p01.int())
    want = q01.int().sum(-1)[:, :, None] + p01.int().sum(-1)[:, None, :] - 2 * dot
    assert torch.equal(got, want)


def test_fragment_order_is_a_permutation_of_a_k_step():
    assert sorted(FRAG) == list(range(STEP))
    # thread t of a quad: a0/b0 = word 2t (k bits 32t..), a2/b1 = word 2t + 1 (128 + 32t..)
    assert [FRAG[t] for t in range(4)] == [2 * t for t in range(4)]
    assert [FRAG[4 + t] for t in range(4)] == [2 * t + 1 for t in range(4)]


TOPK_CASES = {
    # equal copies of query 0's row straddle the edge of splits 0 and 1
    "ties across a split edge": (2, 8, 768, 8, 8, 768),
    "c_real inside the last split": (2, 8, 768, 4, 5, 700),
    "k past a split's classes": (2, 5, 768, 4, 150, 700),
    "W=5, many equal distances": (1, 8, 512, 5, 20, 512),
}


@pytest.mark.parametrize("splits", [None, 1, 2])
@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_split_topk_model_equals_the_pallas_topk(case, splits):
    g, b, c, w, k, c_real = TOPK_CASES[case]
    q, p = _words(1, (g, b, w)), _words(2, (g, c, w))
    if case.startswith("ties"):
        edge = split_ranges(hops.plan(g, b, c_real, SMS), c_real)[0][1]
        p[:, edge - 4:edge + 4] = q[:, :1]
    tiles = -(-c_real // hops.CLASS_TILE)
    md, mi = model_topk(_t(q), _t(p), k, c_real, None if splits is None else min(splits, tiles))
    jd, ji = pallas_topk(q, p, k, c_real)
    np.testing.assert_array_equal(md, jd)
    np.testing.assert_array_equal(mi, ji)
    if case.startswith("ties"):
        assert (mi[:, 0] == np.arange(edge - 4, edge + 4)).all() and (md[:, 0] == 0).all()
    # the port's plain twin (what the card's result is held to) agrees
    td, ti = hops.hamming_topk_k_banked(_t(q), _t(p), k, c_real=c_real)
    np.testing.assert_array_equal(td.numpy(), md)
    np.testing.assert_array_equal(ti.numpy(), mi)


@pytest.mark.parametrize("g,b,c_real", [(8, 512, 1600), (64, 256, 50), (3, 77, 300),
                                        (1, 64, 1600), (2, 100, 650), (1, 1, 1),
                                        (8, 4096, 12800), (2, 40, 129)])
def test_plan_covers_every_class_once(g, b, c_real):
    splits, tiles = hops.plan(g, b, c_real, SMS), -(-c_real // hops.CLASS_TILE)
    ranges = split_ranges(splits, c_real)
    assert 1 <= splits <= tiles
    assert ranges[0][0] == 0 and ranges[-1][1] == c_real
    assert all(z == a2 for (_, z), (a2, _) in zip(ranges, ranges[1:]))
    assert all(a < z and a % hops.CLASS_TILE == 0 for a, z in ranges)
    if c_real <= hops.CLASS_TILE:
        assert splits == 1
    blocks = g * -(-b // hops.TOPK_BM) * splits
    assert blocks >= WAVES * SMS or splits == tiles
    if splits > 1:   # no fewer splits would do
        assert g * -(-b // hops.TOPK_BM) * (splits - 1) < WAVES * SMS


def test_plan_fills_the_card_twice_at_the_screen_shape():
    splits = hops.plan(8, 512, 1600, SMS)
    assert splits == 5 and 8 * (512 // hops.TOPK_BM) * splits >= 2 * SMS
    # the split count follows the card's SM count
    assert hops.plan(8, 512, 1600, 66) == 3
    with pytest.raises(ValueError):
        hops.plan(1, 0, 10, SMS)
