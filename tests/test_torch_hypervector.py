"""The port's HDC algebra (repro_torch.core.hypervector) against the JAX
reference on shared inputs: bit for bit, reusing the property cases of
tests/test_hdc_core.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:  # pragma: no cover - exercised only where hypothesis is installed
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline: the vendored deterministic subset
    from _propcheck import given, settings, strategies as st

from repro.core import hypervector as jhv
from repro_torch import convert
from repro_torch.core import hypervector as thv

dims32 = st.integers(min_value=1, max_value=12).map(lambda k: k * 32)
seeds = st.integers(min_value=0, max_value=2**31 - 1)


def _bits(seed, shape):
    return np.random.default_rng(seed).integers(0, 2, size=shape, dtype=np.uint8)


def _t(a):
    return convert.hv_from_numpy(np.asarray(a), "cpu")


def _eq(port, ref):
    np.testing.assert_array_equal(
        convert.to_numpy(port, words=port.dtype == torch.int32), np.asarray(ref))


@settings(max_examples=8, deadline=None)
@given(seeds, dims32)
def test_pack_unpack_roundtrip_matches_jax(seed, d):
    x = _bits(seed, (5, d))
    _eq(thv.pack(_t(x)), jhv.pack(jnp.asarray(x)))
    assert np.array_equal(convert.to_numpy(thv.unpack(thv.pack(_t(x)), d)), x)


def test_pack_bit31_does_not_overflow():
    x = np.zeros((3, 64), np.uint8)
    x[0, 31] = 1                      # only the top bit of word 0
    x[1, :] = 1                       # every bit: 0xFFFFFFFF words
    x[2, 31::32] = 1                  # top bit of every word
    words = thv.pack(_t(x))
    assert words.dtype == torch.int32
    _eq(words, jhv.pack(jnp.asarray(x)))
    assert int(words[0, 0]) == -2**31 and int(words[1, 0]) == -1
    assert np.array_equal(convert.to_numpy(thv.unpack(words, 64)), x)


@pytest.mark.parametrize("shift", [0, 1, 31, 32, 33, "d-1", -5, "2d+3"])
@pytest.mark.parametrize("d", [64, 96, 256])
def test_permute_packed_matches_jax(shift, d):
    s = {"d-1": d - 1, "2d+3": 2 * d + 3}.get(shift, shift)
    x = _bits(d + 7, (4, d))
    _eq(thv.permute_packed(thv.pack(_t(x)), s),
        jhv.permute_packed(jhv.pack(jnp.asarray(x)), s))
    _eq(thv.permute(_t(x), s), jhv.permute(jnp.asarray(x), s))


@settings(max_examples=4, deadline=None)
@given(seeds, dims32, st.integers(min_value=2, max_value=8))
def test_permute_batch_matches_jax(seed, d, m):
    x = _bits(seed, (m, d))
    shifts = np.random.default_rng(seed + 1).integers(-2 * d, 2 * d, size=m)
    ref = jhv.permute_batch(jnp.asarray(x), jnp.asarray(shifts))
    _eq(thv.permute_batch(_t(x), torch.from_numpy(shifts)), ref)
    _eq(thv.permute_batch_packed(thv.pack(_t(x)), shifts), jhv.pack(ref))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
def test_majority_packed_matches_jax(m):
    x = _bits(m, (m, 6, 128))
    ref = jhv.majority(jnp.asarray(x))
    _eq(thv.majority(_t(x)), ref)
    _eq(thv.majority_packed(thv.pack(_t(x))), jhv.majority_packed(jhv.pack(jnp.asarray(x))))
    _eq(thv.majority_packed(thv.pack(_t(x))), jhv.pack(ref))


def test_majority_even_m_ties_resolve_to_zero():
    x = np.zeros((4, 1, 64), np.uint8)
    x[:2] = 1                         # every lane: count 2 of 4, a tie
    x[:3, 0, :32] = 1                 # first word: count 3 of 4
    got = convert.to_numpy(thv.majority(_t(x)))
    assert got[0, :32].all() and not got[0, 32:].any()
    _eq(thv.majority_packed(thv.pack(_t(x))), jhv.pack(jnp.asarray(got)))


@settings(max_examples=4, deadline=None)
@given(seeds, dims32)
def test_hamming_distance_packed_matches_jax(seed, d):
    q, p = _bits(seed, (7, d)), _bits(seed + 1, (9, d))
    ref = jhv.hamming_distance_packed(jhv.pack(jnp.asarray(q)), jhv.pack(jnp.asarray(p)))
    _eq(thv.hamming_distance_packed(thv.pack(_t(q)), thv.pack(_t(p))), ref)
    sim = jhv.hamming_similarity(jnp.asarray(q), jnp.asarray(p))
    _eq(thv.hamming_similarity(_t(q), _t(p)), sim)


def test_bind_matches_jax():
    a, b = _bits(1, (3, 96)), _bits(2, (3, 96))
    _eq(thv.bind(_t(a), _t(b)), jhv.bind(jnp.asarray(a), jnp.asarray(b)))


def test_flip_bits_packed_equals_flip_bits_on_one_generator():
    """The "exact" packed BSC packs the same unpacked draw: on the same
    generator state, unpack(flip_bits_packed(pack(x))) == flip_bits(x)."""
    x = _t(_bits(3, (16, 256)))
    ber = torch.tensor([0.0, 0.01, 0.2, 0.5]).repeat(4)[:, None]
    a = thv.flip_bits(torch.Generator().manual_seed(9), x, ber)
    b = thv.flip_bits_packed(torch.Generator().manual_seed(9), thv.pack(x), ber)
    assert torch.equal(thv.unpack(b, 256), a)
    assert torch.equal(a[0::4], x[0::4])          # ber 0 flips nothing
    rate = (a[2::4] ^ x[2::4]).float().mean().item()
    assert abs(rate - 0.2) < 5 * (0.2 * 0.8 / (4 * 256)) ** 0.5


def test_random_hv_device_rule():
    g = torch.Generator().manual_seed(0)
    x = thv.random_hv(g, 4, 64, device="cpu")
    assert x.dtype == torch.uint8 and set(x.unique().tolist()) <= {0, 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            thv.random_hv(g, 4, 64)
