"""The port's attention backward on CPU tensors (the plain twin the CUDA
backward kernel is held against on the card, and autograd through
`FlashAttention`) against the JAX package: ``jax.grad`` of the model's
``layers.flash_attention``, whose custom VJP is `_flash_vjp_bwd`, at
tests/test_models.py's four shapes and with ``q_offset``; the forward's
log-sum-exp against `_flash_fwd_impl`'s; and a row that sees no key. f32,
atol = rtol = 2e-5: the blocks are the reference's, only the order of some
sums differs. The twin's ``p_bf16`` arithmetic: P and dS rounded to bf16
against `_flash_vjp_bwd` under the reference's FLASH_P_BF16, and split into
bf16 hi + lo (the bf16 kernel's) against the f32 twin. The f64 backward
`flash_bwd_exact` against the same ``jax.grad``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch import kernels as tk
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import (NEG_INF, flash_bwd_exact, flash_bwd_ref,
                                                     flash_fwd_ref)
from repro_torch.models import layers as tlayers

TOL = dict(atol=2e-5, rtol=2e-5)
BLOCKS = dict(block_q=64, block_k=64)



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test runs torch on one intra-op thread, restored after: the suite
    runs several worker processes at once, and these tests' many small ops
    slow down by two orders of magnitude when every process spreads them
    over all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _inputs(seed, b, sq, skv, h, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, kh, d), dtype=np.float32),
            rng.standard_normal((b, skv, kh, d), dtype=np.float32),
            rng.standard_normal((b, sq, h, d), dtype=np.float32))


def _jax_grads(q, k, v, ct, **kw):
    def f(q, k, v):
        return jnp.sum(jlayers.flash_attention(q, k, v, **kw) * ct)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port_autograd(q, k, v, ct, **kw):
    tq, tk_, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tlayers.flash_attention(tq, tk_, tv, **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk_, tv)]


def _port_twin(q, k, v, ct, **kw):
    tq, tk_, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = flash_fwd_ref(tq, tk_, tv, return_lse=True, **kw)
    return [g.numpy() for g in flash_bwd_ref(tq, tk_, tv, out, lse, tct, **kw)]


CASES = [  # tests/test_models.py's four shapes, then prefill chunks over a cache prefix
    (256, 256, 0, 4, 2, 32, -1, True),
    (256, 256, 0, 4, 1, 32, 64, True),
    (128, 128, 0, 6, 6, 16, -1, False),
    (512, 512, 0, 2, 2, 64, 128, True),
    (64, 192, 128, 4, 2, 32, -1, True),
    (64, 192, 128, 4, 1, 64, 48, True),
]


@pytest.mark.parametrize("sq,skv,q_offset,h,kh,d,win,causal", CASES)
def test_backward_matches_jax_grad(sq, skv, q_offset, h, kh, d, win, causal):
    q, k, v, ct = _inputs(sq + skv + h * d + q_offset, 2, sq, skv, h, kh, d)
    kw = dict(causal=causal, window=win, q_offset=q_offset, **BLOCKS)
    want = _jax_grads(q, k, v, ct, **kw)
    for got in (_port_twin(q, k, v, ct, **kw), _port_autograd(q, k, v, ct, **kw)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("sq,skv,q_offset,h,kh,d,win,causal", CASES)
def test_forward_lse_matches_flash_fwd_impl(sq, skv, q_offset, h, kh, d, win, causal):
    q, k, v, _ = _inputs(sq * 3 + skv + d, 2, sq, skv, h, kh, d)
    want_out, want_lse = jlayers._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(win), causal, q_offset, 64, 64)
    out, lse = flash_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                             window=win, q_offset=q_offset, return_lse=True, **BLOCKS)
    assert lse.shape == (2, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)


@pytest.mark.parametrize("q_offset,win,causal", [(-64, -1, True), (-40, 32, True),
                                                 (100, 24, False)])
def test_row_that_sees_no_key_matches_jax_grad(q_offset, win, causal):
    """Causal rows before key 0 (and windowed rows past the last key) see no
    key: the forward gives them the mean of V, and their lse is -1e30
    (m + log l rounds back to m in f32), so the backward takes P = 1 on every
    key, as the reference's custom VJP does."""
    q, k, v, ct = _inputs(abs(q_offset) + 7, 2, 128, 128, 4, 2, 32)
    kw = dict(causal=causal, window=win, q_offset=q_offset, **BLOCKS)
    _, lse = flash_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)), return_lse=True, **kw)
    qp = q_offset + np.arange(128)
    blind = (qp < 0) if causal else (qp - 127 >= win)
    assert blind.any()
    assert (lse.numpy()[:, :, blind] == np.float32(NEG_INF)).all()
    want = _jax_grads(q, k, v, ct, **kw)
    for got in (_port_twin(q, k, v, ct, **kw), _port_autograd(q, k, v, ct, **kw)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **TOL)
    # dV of a blind row's keys is the sum of its dO over all keys (P = 1)
    if causal and win < 0:
        tq, tk_, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
        out, lse = flash_fwd_ref(tq, tk_, tv, return_lse=True, **kw)
        only_blind = tct * torch.from_numpy(blind)[None, :, None, None]
        _, _, dv = flash_bwd_ref(tq, tk_, tv, out, lse, only_blind, **kw)
        want_dv = only_blind.reshape(2, 128, 2, 2, 32).sum((1, 3))       # [B, KH, D]
        np.testing.assert_allclose(dv.numpy(), want_dv[:, None].expand(2, 128, 2, 32).numpy(),
                                   **TOL)


BLIND = [(-64, -1, True), (-40, 32, True), (100, 24, False)]   # rows that see no key
P_BF16_CASES = ([c for c in CASES]
                + [(128, 128, off, 4, 2, 32, win, causal) for off, win, causal in BLIND])


def _twin_and_reference(sq, skv, q_offset, h, kh, d, win, causal, p_bf16, monkeypatch):
    """The port's twin with ``p_bf16`` and the reference's `_flash_vjp_bwd`
    with FLASH_P_BF16 = True, on the same inputs and the same forward (the
    twin's out and lse), as numpy (dq, dk, dv) pairs."""
    q, k, v, ct = _inputs(sq + skv + h * d + q_offset + 5, 2, sq, skv, h, kh, d)
    tq, tk_, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    kw = dict(causal=causal, window=win, q_offset=q_offset, **BLOCKS)
    out, lse = flash_fwd_ref(tq, tk_, tv, return_lse=True, **kw)
    got = flash_bwd_ref(tq, tk_, tv, out, lse, tct, p_bf16=p_bf16, **kw)
    monkeypatch.setattr(jlayers, "FLASH_P_BF16", True)
    res = tuple(jnp.asarray(a) for a in (q, k, v, out.numpy(), lse.numpy())) + (jnp.int32(win),)
    want = jlayers._flash_vjp_bwd(causal, q_offset, 64, 64, res, jnp.asarray(ct))[:3]
    return [(g.numpy(), np.asarray(w)) for g, w in zip(got, want)]


@pytest.mark.parametrize("sq,skv,q_offset,h,kh,d,win,causal", P_BF16_CASES)
def test_bf16_operand_twin_matches_flash_p_bf16(sq, skv, q_offset, h, kh, d, win, causal,
                                                monkeypatch):
    """``p_bf16=1`` (P and dS rounded to bf16, and the gradient products'
    dO, k and q) against the reference's backward under FLASH_P_BF16, on
    the same out and lse: within 2e-4 of each gradient's largest entry (a P
    or dS entry that the f32 sums' order rounds to the other bf16 neighbour
    moves an output by one bf16 ulp of that term; measured: up to 7.6e-5),
    where the f32 twin is more than 5x that off (measured: 1.7e-3 to
    6.0e-3), so the rounding is what agrees."""
    for got, want in _twin_and_reference(sq, skv, q_offset, h, kh, d, win, causal, 1,
                                         monkeypatch):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())
    off = max(np.abs(got - want).max() / np.abs(want).max() for got, want in
              _twin_and_reference(sq, skv, q_offset, h, kh, d, win, causal, 0, monkeypatch))
    assert off > 5 * 2e-4, off


@pytest.mark.parametrize("sq,skv,q_offset,h,kh,d,win,causal", P_BF16_CASES)
def test_split_twin_carries_f32_p(sq, skv, q_offset, h, kh, d, win, causal):
    """``p_bf16=2`` (P and dS as bf16 hi + lo, the bf16 kernel's arithmetic)
    on bf16-exact inputs held in f32: within 2e-5 of each gradient's largest
    entry of the f32 twin (hi + lo carries 16 significant bits)."""
    q, k, v, ct = (torch.from_numpy(a).bfloat16().float()
                   for a in _inputs(sq + skv + d, 2, sq, skv, h, kh, d))
    kw = dict(causal=causal, window=win, q_offset=q_offset, **BLOCKS)
    out, lse = flash_fwd_ref(q, k, v, return_lse=True, **kw)
    want = flash_bwd_ref(q, k, v, out, lse, ct, **kw)
    def off(p_bf16):
        got = flash_bwd_ref(q, k, v, out, lse, ct, p_bf16=p_bf16, **kw)
        return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))

    assert off(2) <= 2e-5
    assert off(1) > 2e-4                          # P and dS rounded to bf16 alone
    with pytest.raises(ValueError, match="p_bf16"):
        flash_bwd_ref(q, k, v, out, lse, ct, p_bf16=3, **kw)


@pytest.mark.parametrize("sq,skv,q_offset,h,kh,d,win,causal", P_BF16_CASES)
def test_exact_backward_matches_jax_grad(sq, skv, q_offset, h, kh, d, win, causal):
    """`flash_bwd_exact`, the f64 yardstick of the bf16 kernel on the card,
    against ``jax.grad`` through the reference's attention (f32) at TOL,
    rows that see no key included."""
    q, k, v, ct = _inputs(sq + skv + h * d + q_offset + 9, 2, sq, skv, h, kh, d)
    kw = dict(causal=causal, window=win, q_offset=q_offset)
    want = _jax_grads(q, k, v, ct, **kw, **BLOCKS)
    got = flash_bwd_exact(*(torch.from_numpy(a) for a in (q, k, v, ct)), **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, **TOL)


def test_bf16_backward_rounds_once_at_the_output():
    """bf16 inputs: every product in f32, the gradients cast to bf16 once,
    against the f32 twin on the same (bf16-exact) inputs."""
    q, k, v, ct = (torch.from_numpy(a).bfloat16() for a in _inputs(3, 2, 128, 128, 4, 2, 32))
    kw = dict(causal=True, window=48, **BLOCKS)
    out, lse = flash_fwd_ref(q, k, v, return_lse=True, **kw)
    got = flash_bwd_ref(q, k, v, out, lse, ct, **kw)
    want = flash_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse, ct.float(), **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=2e-2, rtol=2e-2)


def test_autograd_function_and_wrapper_checks():
    q, k, v, ct = (torch.from_numpy(a) for a in _inputs(11, 1, 64, 64, 4, 2, 16))
    tk.reset_launch_counts()
    # no input needs a gradient: the serve paths' forward, no log-sum-exp
    calls = []
    orig = tlayers.flash_attention_fwd
    tlayers.flash_attention_fwd = lambda *a, **kw: calls.append(kw) or orig(*a, **kw)
    try:
        tlayers.flash_attention(q, k, v)
        with torch.no_grad():
            tlayers.flash_attention(q.requires_grad_(), k, v)
    finally:
        tlayers.flash_attention_fwd = orig
        q.requires_grad_(False)
    assert len(calls) == 2 and not any(c.get("return_lse") for c in calls)
    # only q needs a gradient: k and v get none, the non-tensor arguments none
    qg = q.clone().requires_grad_()
    out = FlashAttention.apply(qg, k, v, True, -1, 0, 64, 64)
    (out * ct).sum().backward()
    assert qg.grad is not None and qg.grad.shape == q.shape
    assert tk.launch_counts() == dict.fromkeys(tk.WRAPPERS, 0)     # CPU: the plain twins
    out, lse = flash_fwd_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[:, :1], ct)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, lse, ct[:, :8])
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, out.double(), lse, ct)
