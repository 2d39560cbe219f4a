"""Public ops: packed Hamming search (flat and per bank) and the fused
per-bank top-1 and top-k.

Packed words are int32 tensors holding the reference's uint32 bits. A wrapper
given CPU tensors runs the plain version in `ref.py`; given CUDA tensors it
launches the kernel of ``csrc/hamming.cu`` (and counts the launch) or raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, check, check_contiguous, dispatch
from repro_torch.kernels.hamming.ref import (
    hamming_search_banked_ref,
    hamming_search_ref,
    hamming_topk_banked_ref,
    hamming_topk_k_banked_ref,
)

# Largest word count whose query and prototype tiles fit one block's shared
# memory in the top-1 kernel (227 KB; csrc/hamming.cu, smem_bytes): d up to
# 11,520 bits. The search and the top-k stream the words: any W.
MAX_WORDS = 360
MAX_GRID = 65535   # grid y / z limit; a search block holds 64 or 128 queries
# The top-k kernel's largest k (csrc/hamming.cu, MAX_K): its merge holds
# k/32 buffered ranks a lane in registers, and its k-rank buffers take
# 512 bytes a rank (64 queries) of the block's shared memory.
MAX_K = 256
# csrc/hamming.cu's top-k tiles (TOPK_BM and BN there), and the plan's target
TOPK_BM = 64       # queries a top-k block
CLASS_TILE = 128   # classes a tile
WAVES = 2          # blocks the plan asks of every SM


@functools.lru_cache(maxsize=256)      # every launch asks for its plan
def plan(g: int, b: int, c_real: int, sms: int) -> int:
    """The fused top-k's class splits for g banks of b queries over c_real
    classes on a card of ``sms`` SMs: split s of S walks the class tiles
    [s*T//S, (s+1)*T//S) of the T 128-class tiles under c_real
    (csrc/hamming.cu, hamming_topk_k_kernel). The fewest splits (at most one
    a tile) whose blocks give every SM WAVES blocks; one split when the
    (bank, query tile) pairs already do, or when c_real fits one tile."""
    if g < 1 or b < 1 or c_real < 1:
        raise ValueError(f"hamming top-k plan: G={g}, B={b}, c_real={c_real} must be >= 1")
    return min(cdiv(c_real, CLASS_TILE), cdiv(WAVES * sms, g * cdiv(b, TOPK_BM)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if b > MAX_GRID * 32:
        raise ValueError(f"hamming_search: B={b} beyond the kernel's limits")
    out = torch.empty((b, c), dtype=torch.int32, device=q.device)
    if b and c:
        _build.launch("hamming_search_banked_launch", qf.data_ptr(), protos.data_ptr(),
                      out.data_ptr(), 1, b, c, w)
        hamming_search.launches += 1
    return out.reshape(lead + (c,))


hamming_search.launches = 0


def hamming_search_banked(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Per-bank Hamming distances: q [G, B, W], protos [G, C, W] int32 ->
    [G, B, C] int32, bank g's queries against bank g's prototypes only: every
    IMC core's full search in one launch."""
    check("hamming_search_banked q", q, torch.int32, 3)
    check("hamming_search_banked protos", protos, torch.int32, 3)
    g, b, w = q.shape
    if protos.shape[0] != g or protos.shape[2] != w:
        raise ValueError(f"bank shapes differ: {tuple(q.shape)} vs {tuple(protos.shape)}")
    c = protos.shape[1]
    if dispatch("hamming_search_banked", q, protos) == "cpu":
        return hamming_search_banked_ref(q, protos)
    check_contiguous("hamming_search_banked", q, protos)
    if g > MAX_GRID or b > MAX_GRID * 32:
        raise ValueError(f"hamming_search_banked: G={g} or B={b} beyond the kernel's limits")
    out = torch.empty((g, b, c), dtype=torch.int32, device=q.device)
    if g and b and c:
        _build.launch("hamming_search_banked_launch", q.data_ptr(), protos.data_ptr(),
                      out.data_ptr(), g, b, c, w)
        hamming_search_banked.launches += 1
    return out


hamming_search_banked.launches = 0


def _banks(name: str, q: torch.Tensor, protos: torch.Tensor,
           bank_rows: torch.Tensor | None, c_real: int | None) -> int:
    """Shape checks shared by the fused top-1 and top-k; returns c_real."""
    check(f"{name} q", q, torch.int32, 3)
    check(f"{name} protos", protos, torch.int32, 3)
    g, _, w = q.shape
    if protos.shape[2] != w:
        raise ValueError(f"word counts differ: {tuple(q.shape)} vs {tuple(protos.shape)}")
    if bank_rows is None:
        if protos.shape[0] != g:
            raise ValueError(f"bank counts differ: {tuple(q.shape)} vs {tuple(protos.shape)}")
    elif tuple(bank_rows.shape) != (g,) or bank_rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"bank_rows must be an int tensor of shape ({g},), got "
                         f"{bank_rows.dtype} {tuple(bank_rows.shape)}")
    c = protos.shape[1]
    c_real = c if c_real is None else c_real
    if not 0 < c_real <= c:
        raise ValueError(f"c_real={c_real} outside (0, {c}]")
    return c_real


def hamming_topk_k_banked(
    q: torch.Tensor, protos: torch.Tensor, k: int, *, c_real: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused per-bank top-k: q [G, B, W], protos [G, C, W] int32 ->
    (dists, idxs), each [G, B, k] int32, rank-sorted ascending by
    (distance, class index), over bank g's own prototypes; columns at or past
    ``c_real`` (default C) never rank. ``1 <= k <= c_real``; on the card also
    ``k <= MAX_K``, else it raises (there is no fallback). On the card the
    class axis is split over blocks by `plan`; with more than one split the
    split lists go through a [splits, G, B, k] scratch and a merge kernel,
    both inside the one counted launch."""
    c_real = _banks("hamming_topk_k_banked", q, protos, None, c_real)
    g, b, w = q.shape
    if not 1 <= k <= c_real:
        raise ValueError(f"k={k} outside [1, {c_real}]")
    if dispatch("hamming_topk_k_banked", q, protos) == "cpu":
        return hamming_topk_k_banked_ref(q, protos, k, c_real)
    check_contiguous("hamming_topk_k_banked", q, protos)
    if k > MAX_K:
        raise ValueError(f"hamming_topk_k_banked: k={k} exceeds the kernel's limit "
                         f"MAX_K={MAX_K}")
    if g > MAX_GRID:
        raise ValueError(f"hamming_topk_k_banked: G={g} > {MAX_GRID}")
    dist = torch.empty((g, b, k), dtype=torch.int32, device=q.device)
    idx = torch.empty((g, b, k), dtype=torch.int32, device=q.device)
    if g and b:
        splits = plan(g, b, c_real, _sm_count(q.device.index))
        # the split lists (dist, idx) before their merge; none for one split
        scratch = [torch.empty((splits, g, b, k), dtype=torch.int32, device=q.device)
                   if splits > 1 else None for _ in range(2)]
        _build.launch("hamming_topk_k_banked_launch", q.data_ptr(), protos.data_ptr(),
                      dist.data_ptr(), idx.data_ptr(),
                      *(None if t is None else t.data_ptr() for t in scratch),
                      g, b, protos.shape[1], w, c_real, k, splits)
        hamming_topk_k_banked.launches += 1
    return dist, idx


hamming_topk_k_banked.launches = 0


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

    ``k`` asks for the top-k instead: (dists, idxs) each [G, B, k], rank r
    the r-th first minimum (`hamming_topk_k_banked`; ``1 <= k <= c_real``).
    ``bank_rows`` [G] makes protos a [T, C, W] bank table: bank g searches
    table row ``bank_rows[g]`` (rows may repeat). On the card the G rows are
    gathered before the launch; the plain version gathers per class chunk.
    """
    c_real = _banks("hamming_topk_banked", q, protos, bank_rows, c_real)
    rows = () if bank_rows is None else (bank_rows,)
    if dispatch("hamming_topk_banked", q, protos, *rows) == "cpu":
        if k is None:
            return hamming_topk_banked_ref(q, protos, c_real, bank_rows)
        return hamming_topk_k_banked_ref(q, protos, k, c_real, bank_rows)
    if bank_rows is not None:
        protos = protos.index_select(0, bank_rows)                # [G, C, W]
    if k is not None:
        return hamming_topk_k_banked(q, protos, k, c_real=c_real)
    check_contiguous("hamming_topk_banked", q, protos)
    g, b, w = q.shape
    if w > MAX_WORDS or g > MAX_GRID:
        raise ValueError(f"hamming_topk_banked: W={w} or G={g} beyond the kernel's limits")
    dist = torch.empty((g, b), dtype=torch.int32, device=q.device)
    idx = torch.empty((g, b), dtype=torch.int32, device=q.device)
    if g and b:
        _build.launch("hamming_topk_banked_launch", q.data_ptr(), protos.data_ptr(),
                      dist.data_ptr(), idx.data_ptr(), g, b, protos.shape[1], w, c_real)
        hamming_topk_banked.launches += 1
    return dist, idx


hamming_topk_banked.launches = 0
