"""Public op: the fused attention forward (causal / sliding-window GQA with
an online softmax).

A wrapper given CPU tensors runs the plain version in `ref.py`; given CUDA
tensors it launches the kernel of ``csrc/flash_attention.cu`` (and counts the
launch) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_contiguous, dispatch
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

# Head dims the kernel is instantiated for (csrc/flash_attention.cu).
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID = 65535   # grid y limit; a block holds 64 query rows


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = -1, q_offset: int = 0,
                        block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Skv, KH, D] with H % KH == 0 -> [B, Sq, H, D]
    in q's dtype (f32 or bf16). Query i sits at position ``q_offset + i``.
    ``block_q``/``block_k`` tile the plain version only; the kernel picks its
    own tiles and takes any Sq and Skv, and D in `HEAD_DIMS` (the plain
    version takes any D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be [B, S, heads, D], "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention_fwd: q, k, v must share one of {DTYPES}, "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_attention_fwd: {h} query heads over {kh} kv heads")
    window, q_offset = int(window), int(q_offset)
    if dispatch("flash_attention_fwd", q, k, v) == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                             block_q=block_q, block_k=block_k)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in the kernel's {HEAD_DIMS}")
    check_contiguous("flash_attention_fwd", q, k, v)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention_fwd: tensors must be 16-byte aligned")
    if (sq > MAX_GRID * 64 or b * h > 2**31 - 1 or skv >= 2**30
            or abs(q_offset) >= 2**30 or abs(window) >= 2**30):
        raise ValueError("flash_attention_fwd: sizes beyond the kernel's grid or int positions")
    out = torch.empty_like(q)
    if out.numel():
        _build.launch("flash_attention_fwd_launch", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, sq, skv, h, kh, d, int(bool(causal)),
                      window, q_offset, int(q.dtype == torch.bfloat16))
        flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
