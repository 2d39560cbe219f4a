"""The port's model building blocks against `repro.models.layers` on shared
numpy inputs, in f32: rmsnorm (``1 + gain``), layernorm, rotate-half RoPE
at both of gemma3's thetas, M-RoPE over (t, h, w) sections, the gated MLP
(silu and tanh-gelu) and the decode attention over a cache with empty slots
and a window. atol = rtol = 1e-5 (f32; only the order of sums and the libm
of the two frameworks differ); M-RoPE at VLM positions within 1e-6."""
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
    # M-RoPE sections want one position stream a section: [B, S] positions refused
    half = d // 2
    sections = (half // 4, half // 4, half - 2 * (half // 4))
    with pytest.raises(ValueError, match="one stream a section"):
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections=sections)


def test_layernorm_matches_jax():
    rng = _rng(3)
    x, g, b = _f32(rng, 2, 5, 48, scale=3.0) + 1.5, _f32(rng, 48) + 1, _f32(rng, 48, scale=0.5)
    for eps in (1e-5, 1e-6):
        got = tl.layernorm(*(torch.from_numpy(a) for a in (x, g, b)), eps).numpy()
        want = jl.layernorm(*(jnp.asarray(a) for a in (x, g, b)), eps)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # unit gain, zero bias: zero mean and unit variance a row
    z = tl.layernorm(torch.from_numpy(x), torch.ones(48), torch.zeros(48)).numpy()
    np.testing.assert_allclose(z.mean(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(z.var(-1), 1.0, atol=1e-3)


@pytest.mark.parametrize("theta,d,sections", [(1_000_000.0, 128, (16, 24, 24)),
                                              (10_000.0, 32, (4, 6, 6)),
                                              (1_000_000.0, 16, (2, 3, 3))])
def test_apply_rope_mrope_sections_match_jax(theta, d, sections):
    """M-RoPE against the reference's `apply_rope(sections=)` within 1e-6, on
    (t, h, w) positions of an image grid then text, as Qwen2-VL's prefix
    gives them, and on three unequal streams; text tokens (t = h = w) are
    1-D RoPE. Positions of the wrong width and sections that miss D/2 are
    refused."""
    rng = _rng(d)
    x = _f32(rng, 2, 40, 3, d)
    grid = np.stack([np.zeros(16), np.repeat(np.arange(4), 4), np.tile(np.arange(4), 4)], -1)
    text = np.repeat((16 + np.arange(24))[:, None], 3, -1)
    pos_img = np.broadcast_to(np.concatenate([grid, text])[None], (2, 40, 3)).astype(np.int32)
    pos_any = rng.integers(0, 300, (2, 40, 3)).astype(np.int32)
    for pos in (pos_img, pos_any):
        got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections).numpy()
        want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.float32(theta), sections)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)
    xt = torch.from_numpy(x[:, 16:])
    text_only = tl.apply_rope(xt, torch.from_numpy(pos_img[:, 16:]), theta, sections)
    one_d = tl.apply_rope(xt, torch.from_numpy(pos_img[:, 16:, 0]), theta)
    np.testing.assert_allclose(text_only.numpy(), one_d.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="one stream a section"):
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos_img[..., :2]), theta, sections)
    with pytest.raises(ValueError, match="frequency slots"):
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos_img), theta,
                      (sections[0] + 1,) + sections[1:])


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
