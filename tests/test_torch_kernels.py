"""The port's four kernel ops on CPU tensors (their plain versions) against
the JAX ops, bit for bit: the bulk through the reference's
``use_kernel=False`` path (pinned equal to interpret-mode Pallas by
tests/test_kernels.py), plus one interpret-mode Pallas case per kernel at a
tiny shape, so the port is held against the Pallas kernel itself."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jcommon
from repro.kernels.assoc_matmul import assoc_matmul as j_assoc
from repro.kernels.hamming import hamming_search as j_search
from repro.kernels.hamming import hamming_topk_banked as j_topk
from repro.kernels.hamming.kernel import hamming_topk_banked_pallas
from repro.kernels.majority import majority_bundle as j_majority
from repro_torch import convert
from repro_torch import kernels as tk
from repro_torch.kernels.common import hamming_blocks, popcount32


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


def _bits(seed, shape):
    return np.random.default_rng(seed).integers(0, 2, size=shape, dtype=np.uint8)


def _t(a):
    return convert.hv_from_numpy(a, "cpu")


def _eq(port, ref):
    np.testing.assert_array_equal(convert.to_numpy(port), np.asarray(ref))


def test_popcount32_covers_every_bit():
    x = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555, 0xAAAAAAAA,
                  0x0F0F0F0F, 0x12345678], dtype=np.uint32)
    want = [bin(int(v)).count("1") for v in x]
    assert popcount32(_t(x)).tolist() == want


@pytest.mark.parametrize("b,c,w", [(1, 1, 1), (5, 130, 3), (16, 300, 16), (9, 4100, 2)])
def test_hamming_search_matches_jax(b, c, w):
    q, p = _words(b * 7 + c, (b, w)), _words(c + w, (c, w))
    _eq(tk.hamming_search(_t(q), _t(p)), j_search(jnp.asarray(q), jnp.asarray(p),
                                                   use_kernel=False))


def test_hamming_search_leading_dims_and_pallas_interpret():
    q, p = _words(1, (2, 3, 4)), _words(2, (20, 4))
    ref = j_search(jnp.asarray(q), jnp.asarray(p), interpret=True)   # the Pallas kernel
    _eq(tk.hamming_search(_t(q), _t(p)), ref)


@pytest.mark.parametrize("g,b,c,w", [(1, 1, 1, 1), (3, 5, 130, 4), (4, 16, 100, 16),
                                     (2, 3, 257, 2)])
def test_hamming_topk_banked_matches_jax(g, b, c, w):
    q, p = _words(g + b, (g, b, w)), _words(c, (g, c, w))
    dist, idx = tk.hamming_topk_banked(_t(q), _t(p))
    jd, ji = j_topk(jnp.asarray(q), jnp.asarray(p), use_kernel=False)
    _eq(dist, jd)
    _eq(idx, ji)


def test_hamming_topk_banked_all_equal_rows_take_first_minimum():
    """Every prototype identical (and so every distance equal) across
    several chunks: the winner is column 0 in every bank."""
    p = np.broadcast_to(_words(5, (2, 1, 3)), (2, 600, 3)).copy()
    q = _words(6, (2, 7, 3))
    dist, idx = tk.hamming_topk_banked(_t(q), _t(p))
    jd, ji = j_topk(jnp.asarray(q), jnp.asarray(p), use_kernel=False)
    _eq(dist, jd)
    _eq(idx, ji)
    assert not idx.any()


def test_hamming_topk_banked_ties_across_chunks():
    """Equal minima at columns 3, 200 and 450 of one bank (chunk size 128):
    the first one wins, as in the reference."""
    w = 2
    q = np.zeros((1, 1, w), np.uint32)
    p = np.full((1, 500, w), 0xFFFFFFFF, np.uint32)
    p[0, [3, 200, 450], 0] = 1        # distance 33 beats 64 everywhere else
    dist, idx = tk.hamming_topk_banked(_t(q), _t(p))
    assert (int(dist), int(idx)) == (33, 3)
    _eq(idx, j_topk(jnp.asarray(q), jnp.asarray(p), use_kernel=False)[1])


def test_hamming_topk_banked_c_real_against_pallas_interpret():
    """c_real < C: padded columns never win. Held against the Pallas kernel in
    interpret mode on padded banks, where the padding is all-equal to the
    queries (distance 0) so it would win if it were not masked."""
    g, b, c_real, w = 2, 8, 100, 2
    bq, bc = 8, 128
    q = _words(7, (g, b, w))
    p = np.concatenate([_words(8, (g, c_real, w)),
                        np.broadcast_to(q[:, :1], (g, bc - c_real, w))], axis=1)
    jd, ji = hamming_topk_banked_pallas(jnp.asarray(q), jnp.asarray(p), c_real=c_real,
                                        bq=bq, bc=bc, interpret=True)
    dist, idx = tk.hamming_topk_banked(_t(q), _t(p), c_real=c_real)
    _eq(dist, jd)
    _eq(idx, ji)
    assert int(idx.max()) < c_real


def test_hamming_topk_banked_unported_modes_raise():
    """The top-k and bank-table modes, once unported, now run and equal
    JAX's; what lies outside the op's contract still raises."""
    qn, pn = _words(1, (1, 2, 1)), _words(2, (1, 4, 1))
    q, p = _t(qn), _t(pn)
    for got, ref in ((tk.hamming_topk_banked(q, p, k=2),
                      j_topk(jnp.asarray(qn), jnp.asarray(pn), k=2, use_kernel=False)),
                     (tk.hamming_topk_banked(q, p, bank_rows=torch.zeros(1, dtype=torch.int32)),
                      j_topk(jnp.asarray(qn), jnp.asarray(pn),
                             bank_rows=jnp.zeros(1, jnp.int32), use_kernel=False))):
        for a, r in zip(got, ref):
            _eq(a, r)
    with pytest.raises(ValueError):
        tk.hamming_topk_banked(q, p, k=5)
    with pytest.raises(ValueError):
        tk.hamming_topk_banked(q, p, bank_rows=torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("b,c,k", [(1, 1, 1), (5, 130, 3), (16, 100, 512), (33, 7, 1000)])
def test_assoc_matmul_matches_jax(b, c, k):
    q, p = _bits(b + k, (b, k)), _bits(c + k, (c, k))
    _eq(tk.assoc_matmul(_t(q), _t(p)), j_assoc(jnp.asarray(q), jnp.asarray(p),
                                               use_kernel=False))


def test_assoc_matmul_banked_is_per_bank_assoc_matmul():
    q, p = _bits(1, (3, 9, 70)), _bits(2, (3, 11, 70))
    got = tk.assoc_matmul_banked(_t(q), _t(p))
    for g in range(3):
        _eq(got[g], j_assoc(jnp.asarray(q[g]), jnp.asarray(p[g]), use_kernel=False))


def test_assoc_matmul_ragged_k_against_pallas_interpret():
    """K = 200 is padded to the Pallas k tile and masked there; the port's
    result equals the kernel's (pads add 0, not +1)."""
    q, p = _bits(3, (2, 5, 200)), _bits(4, (12, 200))
    ref = j_assoc(jnp.asarray(q), jnp.asarray(p), bm=8, interpret=True)
    _eq(tk.assoc_matmul(_t(q), _t(p)), ref)


@pytest.mark.parametrize("k", [500, 33, 512])
def test_assoc_matmul_u8_identity_against_pallas_interpret(k):
    """The kernel's arithmetic: raw {0,1} bytes through a u8 x u8 product,
    the bipolar dot recovered as 4 q.p - 2|q| - 2|p| + K (exact in int64 here,
    int32 on the card), equals the Pallas kernel's at ragged and tile-sized K
    (zero padding past K adds 0 to every term)."""
    q, p = _bits(k, (2, 5, k)), _bits(k + 1, (12, k))
    qi, pi = torch.from_numpy(q).long(), torch.from_numpy(p).long()
    dot = 4 * (qi @ pi.T) - 2 * qi.sum(-1, keepdim=True) - 2 * pi.sum(-1) + k
    ref = j_assoc(jnp.asarray(q), jnp.asarray(p), bm=8, interpret=True)
    np.testing.assert_array_equal(dot.float().numpy(), np.asarray(ref))


def test_assoc_matmul_non_binary_bytes_against_pallas_interpret():
    """Bytes other than 0 and 1 count as 2v - 1, as in the reference: the
    plain version against the Pallas kernel on values 0-3 at a ragged K
    (where JAX's bf16 operands and f32 sums are exact)."""
    rng = np.random.default_rng(11)
    q = rng.integers(0, 4, (2, 7, 500), dtype=np.uint8)
    p = rng.integers(0, 4, (12, 500), dtype=np.uint8)
    ref = j_assoc(jnp.asarray(q), jnp.asarray(p), bm=8, interpret=True)
    _eq(tk.assoc_matmul(_t(q), _t(p)), ref)


@pytest.mark.parametrize("k", [1, 500, 8256])
def test_assoc_matmul_byte_sum_identity_on_any_byte(k):
    """The kernel's arithmetic on any byte: 4 q.p - 2|q| - 2|p| + K with |q|,
    |p| sums of byte values (not counts of set bits), in int32 range up to
    K = 8256 and rounded to f32 once, equals the plain version bit for bit;
    a count of set bits would not (q = [2], p = [1]: 3, not 5)."""
    rng = np.random.default_rng(k)
    q = rng.integers(0, 256, (1, 6, k), dtype=np.uint8)
    p = rng.integers(0, 256, (1, 9, k), dtype=np.uint8)
    q[0, 0], p[0, 0] = 255, 255                     # the largest dot
    qi, pi = torch.from_numpy(q).long(), torch.from_numpy(p).long()
    dot = (4 * (qi @ pi.transpose(1, 2)) - 2 * qi.sum(-1, keepdim=True)
           - 2 * pi.sum(-1)[:, None, :] + k)
    assert int(dot.abs().max()) < 2**31
    _eq(tk.assoc_matmul_banked(_t(q), _t(p)), dot.float().numpy())
    one = tk.assoc_matmul(_t(np.array([[2]], np.uint8)), _t(np.array([[1]], np.uint8)))
    assert one.item() == 3.0


@pytest.mark.parametrize("m,b,d", [(1, 1, 1), (2, 5, 130), (3, 16, 512), (4, 7, 96),
                                   (5, 33, 200)])
def test_majority_bundle_matches_jax(m, b, d):
    x = _bits(m * b + d, (m, b, d))
    _eq(tk.majority_bundle(_t(x)), j_majority(jnp.asarray(x), use_kernel=False))


def test_majority_bundle_against_pallas_interpret():
    x = _bits(9, (4, 3, 2, 40))       # even M (ties -> 0) and two leading dims
    _eq(tk.majority_bundle(_t(x)), j_majority(jnp.asarray(x), interpret=True))


def test_block_policy_matches_reference():
    for b, c in [(1, 1), (8, 4095), (8, 4096), (300, 102400)]:
        assert hamming_blocks(b, c) == jcommon.hamming_blocks(b, c)


def test_wrappers_count_only_kernel_launches():
    tk.reset_launch_counts()
    tk.hamming_search(_t(_words(1, (2, 1))), _t(_words(2, (3, 1))))
    tk.majority_bundle(_t(_bits(1, (3, 2, 8))))
    assert tk.launch_counts() == dict.fromkeys(tk.WRAPPERS, 0)   # CPU: plain versions


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        tk.hamming_search(_t(_bits(1, (2, 4))), _t(_words(1, (3, 4))))
    with pytest.raises(ValueError):
        tk.hamming_topk_banked(_t(_words(1, (2, 2, 1))), _t(_words(1, (3, 4, 1))))
    with pytest.raises(ValueError):
        tk.hamming_topk_banked(_t(_words(1, (1, 2, 1))), _t(_words(1, (1, 4, 1))), c_real=5)
    with pytest.raises(TypeError):
        tk.assoc_matmul_banked(_t(_words(1, (1, 2, 1))), _t(_words(1, (1, 4, 1))))
