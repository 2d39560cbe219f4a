"""Public ops: packed Hamming search and the fused per-bank top-1.

Packed words are int32 tensors holding the reference's uint32 bits. A wrapper
given CPU tensors runs the plain version in `ref.py`; given CUDA tensors it
launches the kernel of ``csrc/hamming.cu`` (and counts the launch) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check, check_contiguous, dispatch
from repro_torch.kernels.hamming.ref import hamming_search_ref, hamming_topk_banked_ref

# Largest word count whose query and prototype tiles fit one block's shared
# memory (227 KB; csrc/hamming.cu, smem_bytes): d up to 11,520 bits.
MAX_WORDS = 360
MAX_GRID_Y = 65535


def hamming_search(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Hamming distances between packed queries [.., W] and prototypes [C, W]
    -> int32 [.., C]."""
    lead, w = q.shape[:-1], q.shape[-1]
    qf = q.reshape(-1, w)
    check("hamming_search q", qf, torch.int32, 2)
    check("hamming_search protos", protos, torch.int32, 2)
    if protos.shape[1] != w:
        raise ValueError(f"word counts differ: {tuple(q.shape)} vs {tuple(protos.shape)}")
    b, c = qf.shape[0], protos.shape[0]
    if dispatch("hamming_search", qf, protos) == "cpu":
        return hamming_search_ref(qf, protos).reshape(lead + (c,))
    check_contiguous("hamming_search", qf, protos)
    if w > MAX_WORDS or b > MAX_GRID_Y * 32:
        raise ValueError(f"hamming_search: W={w} or B={b} beyond the kernel's limits")
    out = torch.empty((b, c), dtype=torch.int32, device=q.device)
    if b and c:
        _build.launch("hamming_search_launch", qf.data_ptr(), protos.data_ptr(),
                      out.data_ptr(), b, c, w)
        hamming_search.launches += 1
    return out.reshape(lead + (c,))


hamming_search.launches = 0


def hamming_topk_banked(
    q: torch.Tensor,
    protos: torch.Tensor,
    *,
    k: int | None = None,
    bank_rows: torch.Tensor | None = None,
    c_real: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused per-bank top-1 Hamming search: q [G, B, W], protos [G, C, W]
    int32 -> (min_dist [G, B], argmin [G, B]) int32, over bank g's own
    prototypes, ties to the lowest class index. Columns at or past
    ``c_real`` (default C) never win.

    The reference's top-k (``k``) and bank-table (``bank_rows``) modes are
    not ported yet and raise.
    """
    if k is not None or bank_rows is not None:
        raise NotImplementedError(
            "hamming_topk_banked: the top-k and bank_rows modes are not "
            "ported yet (k=None, bank_rows=None only)")
    check("hamming_topk_banked q", q, torch.int32, 3)
    check("hamming_topk_banked protos", protos, torch.int32, 3)
    g, b, w = q.shape
    if protos.shape[0] != g or protos.shape[2] != w:
        raise ValueError(f"bank shapes differ: {tuple(q.shape)} vs {tuple(protos.shape)}")
    c = protos.shape[1]
    c_real = c if c_real is None else c_real
    if not 0 < c_real <= c:
        raise ValueError(f"c_real={c_real} outside (0, {c}]")
    if dispatch("hamming_topk_banked", q, protos) == "cpu":
        return hamming_topk_banked_ref(q, protos, c_real)
    check_contiguous("hamming_topk_banked", q, protos)
    if w > MAX_WORDS or g > MAX_GRID_Y:
        raise ValueError(f"hamming_topk_banked: W={w} or G={g} beyond the kernel's limits")
    dist = torch.empty((g, b), dtype=torch.int32, device=q.device)
    idx = torch.empty((g, b), dtype=torch.int32, device=q.device)
    if g and b:
        _build.launch("hamming_topk_banked_launch", q.data_ptr(), protos.data_ptr(),
                      dist.data_ptr(), idx.data_ptr(), g, b, c, w, c_real)
        hamming_topk_banked.launches += 1
    return dist, idx


hamming_topk_banked.launches = 0
