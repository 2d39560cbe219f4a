"""The port's model building blocks against `repro.models.layers` on shared
numpy inputs, in f32: rmsnorm (``1 + gain``), rotate-half RoPE at both of
gemma3's thetas, the gated MLP (silu and tanh-gelu) and the decode attention
over a cache with empty slots and a window. atol = rtol = 1e-5 (f32; only
the order of sums and the libm of the two frameworks differ)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_rmsnorm_scales_by_one_plus_gain():
    rng = _rng(0)
    x, g = _f32(rng, 2, 5, 48, scale=3.0), _f32(rng, 48, scale=0.1)
    got = tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-6).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(g))),
                               **TOL)
    # zero gain is the plain RMS norm (not a zero output)
    z = tl.rmsnorm(torch.from_numpy(x), torch.zeros(48)).numpy()
    np.testing.assert_allclose(np.sqrt((z * z).mean(-1)), 1.0, atol=1e-4)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("d", [16, 64])
def test_apply_rope_rotate_half(theta, d):
    rng = _rng(int(theta) % 97 + d)
    x = _f32(rng, 2, 9, 3, d)
    pos = (rng.integers(0, 4000, (2, 9))).astype(np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.float32(theta))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError):
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections=(2, 3, 3))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(act):
    rng = _rng(len(act))
    x = _f32(rng, 2, 7, 32)
    wg, wu, wd = _f32(rng, 32, 80, scale=0.2), _f32(rng, 32, 80, scale=0.2), _f32(rng, 80, 32,
                                                                                 scale=0.1)
    got = tl.gated_mlp(*(torch.from_numpy(a) for a in (x, wg, wu, wd)), act).numpy()
    want = jl.gated_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wd)), act)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("window,cur_pos", [(-1, 20), (8, 20), (8, 29), (5, 3)])
def test_decode_attention_empty_slots_and_window(window, cur_pos):
    """A 32-slot cache holding positions 0..cur_pos with slots past it empty
    (-1), and a ring layout (slot = pos % 16) for the windowed cases."""
    rng = _rng(window + cur_pos + 100)
    b, h, kh, d, sc = 2, 6, 2, 32, 32
    q, kc, vc = _f32(rng, b, 1, h, d), _f32(rng, b, sc, kh, d), _f32(rng, b, sc, kh, d)
    slot_pos = np.full((sc,), -1, np.int32)
    if window > 0:       # ring of 16 slots; the rest stay empty
        for p in range(max(0, cur_pos - 15), cur_pos + 1):
            slot_pos[p % 16] = p
    else:
        slot_pos[:cur_pos + 1] = np.arange(cur_pos + 1)
    got = tl.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, slot_pos)), cur_pos,
                              window=window).numpy()
    want = jl.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, slot_pos)),
                               jnp.int32(cur_pos), window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_expand_kv_and_largest_divisor():
    k = _f32(_rng(3), 2, 5, 2, 4)
    np.testing.assert_array_equal(tl._expand_kv(torch.from_numpy(k), 3).numpy(),
                                  np.asarray(jl._expand_kv(jnp.asarray(k), 3)))
    for n, cap in [(1024, 512), (1000, 512), (97, 64), (1500, 1024), (1, 8)]:
        assert tl._largest_divisor(n, cap) == jl._largest_divisor(n, cap)
    np.testing.assert_allclose(
        tl.act_fn("gelu")(torch.linspace(-4, 4, 33)).numpy(),
        np.asarray(jl.act_fn("gelu")(jnp.linspace(-4, 4, 33))), **TOL)
