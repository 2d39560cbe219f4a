"""Public ops: the fused attention forward (causal / sliding-window GQA with
an online softmax), its backward, and the autograd function that joins them.

A wrapper given CPU tensors runs the plain version in `ref.py`; given CUDA
tensors it launches the kernel of ``csrc/flash_attention.cu`` or
``csrc/flash_attention_bwd.cu`` (and counts the launch) or raises; given
fake tensors it makes the kernel's outputs and records its cost
(`fwd_cost`, `bwd_cost`; `kernels.common.fake_launch`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
import functools

from repro_torch.kernels.common import check_contiguous, dispatch, is_fake, record_launch
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, flash_fwd_ref

# Head dims both kernels are instantiated for (csrc/flash_attention.cu and
# csrc/flash_attention_bwd.cu; in bf16, D = 80 and 112 run in the D = 128
# tiles).
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID = 65535   # grid y limit


@functools.lru_cache(maxsize=1024)
def attention_pairs(sq: int, skv: int, causal: bool, window: int, q_offset: int) -> int:
    """The (query, key) pairs of one head that the mask keeps: the work these
    inputs need (query i at position q_offset + i; a row that sees no key
    takes the mean of V over all Skv keys, as the reference gives it)."""
    n = 0
    for i in range(sq):
        qp = q_offset + i
        hi = min(skv, qp + 1) if causal else skv
        lo = max(0, qp - window + 1) if window > 0 else 0
        n += hi - lo if hi > lo else skv
    return n


def _kind(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def fwd_cost(b: int, sq: int, skv: int, h: int, kh: int, d: int, causal: bool, window: int,
             q_offset: int, dtype: torch.dtype) -> tuple[int, int, str]:
    """(bytes, operations, kind) of the forward: q, k, v read and the output
    written once; 4 operations a kept (query, key) pair and head dimension
    (the S and P V products), at the inputs' type."""
    es = dtype.itemsize
    return (es * 2 * b * d * (sq * h + skv * kh),
            4 * b * h * d * attention_pairs(sq, skv, bool(causal), int(window), int(q_offset)),
            _kind(dtype))


def bwd_cost(b: int, sq: int, skv: int, h: int, kh: int, d: int, causal: bool, window: int,
             q_offset: int, dtype: torch.dtype) -> tuple[int, int, str]:
    """(bytes, operations, kind) of the backward: q, out, dout, dq and k, v,
    dk, dv read or written once, and the f32 log-sum-exp; 10 operations a
    kept pair and head dimension (S and dP recomputed, dQ, dK, dV)."""
    es = dtype.itemsize
    return (es * (4 * b * sq * h * d + 4 * b * skv * kh * d) + 4 * b * h * sq,
            10 * b * h * d * attention_pairs(sq, skv, bool(causal), int(window), int(q_offset)),
            _kind(dtype))


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name}: {arg} must be [B, S, heads, D], got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name}: q, k, v must share one of {DTYPES}, "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, _, h, d = q.shape
    kh = k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if kh == 0 or h % kh:
        raise ValueError(f"{name}: {h} query heads over {kh} kv heads")


def _check_head_dim(name: str, d: int) -> None:
    """D must be one the kernels are built for (`HEAD_DIMS`)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in the kernel's {HEAD_DIMS}")


def _check_launch(name: str, d: int, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take: D in `HEAD_DIMS` and dense 16-byte aligned
    memory."""
    _check_head_dim(name, d)
    check_contiguous(name, *tensors)
    for t in tensors:
        if not is_fake(t) and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = -1, q_offset: int = 0,
                        block_q: int = 512, block_k: int = 1024, return_lse: bool = False):
    """q [B, Sq, H, D]; k, v [B, Skv, KH, D] with H % KH == 0 -> [B, Sq, H, D]
    in q's dtype (f32 or bf16); with ``return_lse`` also the log-sum-exp
    [B, H, Sq] f32 that `flash_attention_bwd` takes (the serve paths ask for
    none, and the kernel then writes none). Query i sits at position
    ``q_offset + i``. ``block_q``/``block_k`` tile the plain version only;
    the kernel picks its own tiles and takes any Sq and Skv, and D in
    `HEAD_DIMS` (the plain version takes any D)."""
    _check_qkv("flash_attention_fwd", q, k, v)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    window, q_offset = int(window), int(q_offset)
    mode = dispatch("flash_attention_fwd", q, k, v)
    if mode == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                             block_q=block_q, block_k=block_k, return_lse=return_lse)
    _check_launch("flash_attention_fwd", d, q, k, v)
    if (sq > MAX_GRID * 64 or b * h > 2**31 - 1 or skv >= 2**30
            or abs(q_offset) >= 2**30 or abs(window) >= 2**30):
        raise ValueError("flash_attention_fwd: sizes beyond the kernel's grid or int positions")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() and mode == "fake":
        record_launch("flash_attention_fwd",
                      fwd_cost(b, sq, skv, h, kh, d, causal, window, q_offset, q.dtype))
    elif out.numel():
        _build.launch("flash_attention_fwd_launch", q, k, v, out, lse,
                      b, sq, skv, h, kh, d, int(bool(causal)), window, q_offset,
                      int(q.dtype == torch.bfloat16))
        flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: int = -1, q_offset: int = 0, block_q: int = 512,
                        block_k: int = 1024):
    """The gradients (dq [B, Sq, H, D], dk, dv [B, Skv, KH, D]) of
    `flash_attention_fwd` with respect to q, k, v, from its ``out`` and
    ``lse`` and the output's gradient ``dout``, in the inputs' dtype. The
    kernel takes what the forward kernel takes, D in `HEAD_DIMS`;
    ``block_q``/``block_k`` tile the plain version only."""
    _check_qkv("flash_attention_bwd", q, k, v)
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    if out.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: out is {out.dtype}, q {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be [B, H, Sq] = {(b, h, sq)} f32, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    window, q_offset = int(window), int(q_offset)
    dout = dout.to(q.dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    mode = dispatch("flash_attention_bwd", q, k, v, out, lse, dout)
    if mode == "cpu":
        return flash_bwd_ref(q, k, v, out, lse, dout, block_q=block_q, block_k=block_k, **kw)
    dout = dout.contiguous()
    _check_launch("flash_attention_bwd", d, q, k, v, out, lse, dout)
    if (sq > MAX_GRID * 32 or skv > MAX_GRID * 32 or b * sq * h > 2**31 - 1
            or skv >= 2**30 or abs(q_offset) >= 2**30 or abs(window) >= 2**30):
        raise ValueError("flash_attention_bwd: sizes beyond the kernel's grid or int positions")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if dq.numel() and mode == "fake":
        record_launch("flash_attention_bwd",
                      bwd_cost(b, sq, skv, h, kh, d, causal, window, q_offset, q.dtype))
    elif dq.numel():
        _build.launch("flash_attention_bwd_launch", q, k, v, out, dout, lse, delta,
                      dq, dk, dv, b, sq, skv, h, kh, d,
                      int(bool(causal)), window, q_offset, int(q.dtype == torch.bfloat16))
        flash_attention_bwd.launches += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward kernel (with the log-sum-exp)
    and, in the backward, the backward kernel (their twins on the CPU). The
    counterpart of the reference's ``_flash`` custom VJP. It saves
    (q, k, v, out, lse); ``causal``, ``window``, ``q_offset`` and the twin's
    block sizes get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_q, block_k):
        kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=block_q,
                  block_k=block_k)
        out, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
