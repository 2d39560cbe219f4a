"""Public ops: sparse-query vs packed-prototype Hamming search and its fused
per-bank top-1 (counterpart of `repro/kernels/sparse/ops.py`).

Queries are sorted int32 index lists padded with ``SENTINEL``; prototypes
are packed int32 words. A wrapper given CPU tensors runs the plain version
in `ref.py`; given CUDA tensors it launches the kernels of
``csrc/sparse.cu`` (and counts the launch) or raises, also where the
kernels refuse the shape (a prototype row past their shared-memory budget,
a grid too tall). Query entries must be indices in [0, 32*W) or SENTINEL;
the kernels never dereference anything else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check, check_contiguous, dispatch
from repro_torch.kernels.sparse.ref import sparse_search_ref, sparse_topk_banked_ref


def sparse_search(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Hamming distances between sparse queries q [B, k] and packed
    prototypes [C, W] -> int32 [B, C]; equal to `hamming_search` on the
    packed densified queries."""
    check("sparse_search q", q, torch.int32, 2)
    check("sparse_search protos", protos, torch.int32, 2)
    b, k = q.shape
    c, w = protos.shape
    if dispatch("sparse_search", q, protos) == "cpu":
        return sparse_search_ref(q, protos)
    check_contiguous("sparse_search", q, protos)
    out = torch.empty((b, c), dtype=torch.int32, device=q.device)
    if b and c:
        pop = torch.empty((c,), dtype=torch.int32, device=q.device)
        _build.launch("sparse_search_launch", q.data_ptr(), protos.data_ptr(),
                      pop.data_ptr(), out.data_ptr(), b, c, w, k)
        sparse_search.launches += 1
    return out


sparse_search.launches = 0


def sparse_topk_banked(
    q: torch.Tensor, protos: torch.Tensor, *, c_real: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused per-bank sparse top-1: q [G, B, k] int32 index lists, protos
    [G, C, W] int32 words -> (min_dist [G, B], argmin [G, B]) int32, over
    bank g's own prototypes, ties to the lowest class index; columns at or
    past ``c_real`` (default C) never win. Equal to `hamming_topk_banked`
    on the packed densified queries."""
    check("sparse_topk_banked q", q, torch.int32, 3)
    check("sparse_topk_banked protos", protos, torch.int32, 3)
    g, b, k = q.shape
    if protos.shape[0] != g:
        raise ValueError(f"bank counts differ: {tuple(q.shape)} vs {tuple(protos.shape)}")
    c, w = protos.shape[1], protos.shape[2]
    c_real = c if c_real is None else c_real
    if not 0 < c_real <= c:
        raise ValueError(f"c_real={c_real} outside (0, {c}]")
    if dispatch("sparse_topk_banked", q, protos) == "cpu":
        return sparse_topk_banked_ref(q, protos, c_real)
    check_contiguous("sparse_topk_banked", q, protos)
    dist = torch.empty((g, b), dtype=torch.int32, device=q.device)
    idx = torch.empty((g, b), dtype=torch.int32, device=q.device)
    if g and b:
        pop = torch.empty((g * c,), dtype=torch.int32, device=q.device)
        _build.launch("sparse_topk_banked_launch", q.data_ptr(), protos.data_ptr(),
                      pop.data_ptr(), dist.data_ptr(), idx.data_ptr(), g, b, c, w, k,
                      c_real)
        sparse_topk_banked.launches += 1
    return dist, idx


sparse_topk_banked.launches = 0
