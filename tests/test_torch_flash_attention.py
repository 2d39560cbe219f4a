"""The port's attention forward on CPU tensors (its plain twin, the path the
CUDA kernel is held against on the card) against the JAX package: the Pallas
kernel in interpret mode at tests/test_kernels.py's four shapes, the model's
blockwise ``layers.flash_attention`` with ``q_offset > 0``, Sq < Skv and a
ragged length, and naive softmax attention. f32, atol = rtol = 2e-5: only the
order of the sums differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as j_flash_fwd
from repro.models import layers as jlayers
from repro_torch import kernels as tk
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, b, sq, skv, h, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, kh, d), dtype=np.float32),
            rng.standard_normal((b, skv, kh, d), dtype=np.float32))


def _port(q, k, v, **kw):
    return flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()


@pytest.mark.parametrize(
    "s,h,kh,d,win,causal,bq,bk",
    [(256, 4, 2, 32, -1, True, 64, 64),
     (256, 4, 1, 64, 64, True, 64, 128),
     (128, 6, 6, 16, -1, False, 64, 64),
     (512, 2, 2, 128, 128, True, 128, 256)],
)
def test_twin_matches_pallas_interpret(s, h, kh, d, win, causal, bq, bk):
    q, k, v = _qkv(s + h + d, 2, s, s, h, kh, d)
    want = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                       window=win, block_q=bq, block_k=bk, interpret=True)
    got = _port(q, k, v, causal=causal, window=win, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "sq,skv,q_offset,h,kh,d,win,causal",
    [(64, 192, 128, 4, 2, 32, -1, True),      # a prefill chunk over its cache prefix
     (64, 192, 128, 4, 1, 64, 48, True),      # ... with a window
     (32, 96, 40, 2, 2, 16, -1, False),       # non-causal, offset ignored but for windows
     (100, 100, 0, 4, 2, 32, 24, True),       # ragged length: blocks clip to 50 / 100
     (97, 97, 0, 3, 1, 64, -1, True)],        # a prime length: blocks of 1 in the reference
)
def test_twin_matches_layers_flash_attention(sq, skv, q_offset, h, kh, d, win, causal):
    q, k, v = _qkv(sq * 7 + skv + q_offset, 2, sq, skv, h, kh, d)
    want = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=win, q_offset=q_offset,
                                   block_q=32, block_k=64)
    got = _port(q, k, v, causal=causal, window=win, q_offset=q_offset, block_q=32,
                block_k=64)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _naive(q, k, v, causal, window, q_offset=0):
    """Softmax attention written out, as tests/test_models.py's oracle."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    kf = np.repeat(k, h // kh, axis=2).astype(np.float64)
    vf = np.repeat(v, h // kh, axis=2).astype(np.float64)
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kf) / np.sqrt(d)
    qp = q_offset + np.arange(sq)[:, None]
    kp = np.arange(k.shape[1])[None, :]
    ok = kp <= qp if causal else np.ones((sq, k.shape[1]), bool)
    if window > 0:
        ok &= (qp - kp) < window
    sc = np.where(ok[None, None], sc, -1e30)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vf)


@pytest.mark.parametrize("sq,skv,q_offset,win,causal",
                         [(128, 128, 0, -1, True), (128, 128, 0, 40, True),
                          (48, 160, 112, 64, True), (77, 77, 0, -1, False)])
def test_twin_matches_naive_softmax(sq, skv, q_offset, win, causal):
    q, k, v = _qkv(sq + skv + 3, 2, sq, skv, 4, 2, 32)
    got = _port(q, k, v, causal=causal, window=win, q_offset=q_offset, block_q=32, block_k=32)
    np.testing.assert_allclose(got, _naive(q, k, v, causal, win, q_offset), **TOL)


def test_wrapper_checks_and_cpu_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 8, 8, 2, 1, 16))
    tk.reset_launch_counts()
    out = flash_attention_fwd(q, k, v)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert tk.launch_counts() == dict.fromkeys(tk.WRAPPERS, 0)   # CPU: the plain version
    # the plain version takes any head dim (the kernel's D in HEAD_DIMS is
    # checked for CUDA tensors only): deepseek's smoke config has D = 18
    q18, k18, v18 = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 2, 1, 18))
    np.testing.assert_allclose(flash_attention_fwd(q18, k18, v18).numpy(),
                               _naive(*(t.numpy() for t in (q18, k18, v18)), True, -1), **TOL)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="query heads"):
        flash_attention_fwd(q[:, :, :1], k.expand(1, 8, 2, 16).contiguous(),
                            v.expand(1, 8, 2, 16).contiguous())


def test_bf16_twin_rounds_once_at_the_output():
    """bf16 inputs: scores and statistics in f32, P cast to bf16 for P.V (as
    the reference casts it); against the f32 twin on the same (bf16-exact)
    inputs within bf16's output rounding."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(5, 2, 64, 64, 4, 2, 32))
    got = flash_fwd_ref(q, k, v, window=16, block_q=32, block_k=32)
    want = flash_fwd_ref(q.float(), k.float(), v.float(), window=16, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2, rtol=2e-2)


def test_fully_masked_rows_take_the_mean_of_every_value():
    """q_offset = -64, causal, Sq = Skv = 128: queries 0-63 sit before key 0
    and see no key. The reference gives such a row exp(0) = 1 on every key,
    the mean of V over all Skv keys; the twin (and the kernel, which visits
    every kv tile for a block holding such a row) gives the same."""
    q, k, v = _qkv(11, 2, 128, 128, 4, 2, 64)      # chip_smoke.py phase 2 holds the kernel here
    want = np.asarray(jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=True, q_offset=-64, block_q=32,
                                              block_k=64))
    got = _port(q, k, v, causal=True, q_offset=-64, block_q=32, block_k=64)
    np.testing.assert_allclose(got, want, **TOL)
    mean_v = np.repeat(v, 2, axis=2).mean(1, keepdims=True)        # [B, 1, H, D]
    np.testing.assert_allclose(got[:, :64], np.broadcast_to(mean_v, got[:, :64].shape),
                               **TOL)


@pytest.mark.parametrize("causal,win", [(True, -1), (True, 48), (False, -1)])
def test_kimi_head_dim_112_against_pallas_interpret(causal, win):
    """Kimi-K2's head dim, 7168 / 64 = 112: the Pallas kernel takes any D, and
    so does the twin the D = 112 kernel is held against on the card."""
    q, k, v = _qkv(112 + win, 2, 128, 128, 4, 2, 112)
    want = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                       window=win, block_q=64, block_k=64, interpret=True)
    got = _port(q, k, v, causal=causal, window=win, block_q=64, block_k=64)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,win", [(True, -1), (False, -1)])
def test_zamba2_head_dim_80_against_pallas_interpret(causal, win):
    """Zamba2's head dim, 2560 / 32 = 80 (32 heads over 32): the twin the
    D = 80 kernel is held against on the card, against the Pallas kernel."""
    q, k, v = _qkv(80 + int(causal), 2, 128, 128, 4, 4, 80)
    want = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                       window=win, block_q=64, block_k=64, interpret=True)
    got = _port(q, k, v, causal=causal, window=win, block_q=64, block_k=64)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_head_dims_of_the_forward_and_the_backward_kernels():
    """Both kernels are built for the same head dims, D = 80 (Zamba2's) and
    D = 112 (Kimi-K2's) among them: the case labels of each CUDA source's
    launch switch are `HEAD_DIMS`, and the wrapper's check (the one it runs
    on CUDA tensors, called here without one) takes each for either kernel.
    A D neither is built for (96) is refused for both before any launch."""
    import re
    from pathlib import Path

    from repro_torch.kernels.flash_attention import ops

    csrc = Path(ops.__file__).resolve().parents[2] / "csrc"
    for src, fn in (("flash_attention.cu", "flash_attention_fwd_launch"),
                    ("flash_attention_bwd.cu", "flash_attention_bwd_launch")):
        text = (csrc / src).read_text()
        body = text[text.index(f'extern "C" int {fn}('):]
        cases = tuple(int(c) for c in re.findall(r"case (\d+): return", body))
        assert cases == ops.HEAD_DIMS, (src, cases)
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        for d in ops.HEAD_DIMS:
            ops._check_head_dim(name, d)
        with pytest.raises(ValueError, match="not in the kernel's"):
            ops._check_head_dim(name, 96)
