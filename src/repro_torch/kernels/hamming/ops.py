"""Public ops: packed Hamming search (flat and per bank) and the fused
per-bank top-1 and top-k.

Packed words are int32 tensors holding the reference's uint32 bits. A wrapper
given CPU tensors runs the plain version in `ref.py`; given CUDA tensors it
launches the kernel of ``csrc/hamming.cu`` (and counts the launch) or raises;
given fake tensors it makes the kernel's outputs and records its cost
(`search_cost`, `topk_cost`; `kernels.common.fake_launch`).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (FAKE_SMS, cdiv, check, check_contiguous, dispatch,
                                        fake_launch, record_launch)
from repro_torch.kernels.hamming.ref import (
    hamming_search_banked_ref,
    hamming_search_ref,
    hamming_topk_banked_ref,
    hamming_topk_k_banked_ref,
)

# The kernels stream the words through shared memory: any W.
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


@functools.lru_cache(maxsize=256)      # every launch asks for its plan
def plan_top1(g: int, b: int, c_real: int, sms: int) -> tuple[int, int]:
    """The fused top-1's (query tile, class splits) for g banks of b queries
    over c_real classes on a card of ``sms`` SMs (csrc/hamming.cu,
    hamming_top1_kernel; split s of S walks the tiles [s*T//S, (s+1)*T//S) as
    in `plan`). 128-query tiles where, split down to one class tile a block,
    they still give every SM WAVES blocks; else 64. Then the splits that take
    the least time as waves x (class tiles a block + 1, a block's fixed cost:
    the ring's first fill and the reduction), the fewest splits among
    equals: a split count just past a whole wave would leave a second wave
    of a few blocks and double the time. One split when c_real fits one
    tile."""
    if g < 1 or b < 1 or c_real < 1:
        raise ValueError(f"hamming top-1 plan: G={g}, B={b}, c_real={c_real} must be >= 1")
    tiles, slots = cdiv(c_real, CLASS_TILE), WAVES * sms
    bm = 128 if g * cdiv(b, 128) * tiles >= slots else 64
    pairs = g * cdiv(b, bm)
    splits = min(range(1, min(tiles, MAX_GRID) + 1),
                 key=lambda s: (cdiv(pairs * s, slots) * (cdiv(tiles, s) + 1), s))
    return bm, splits


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(mode: str, t: torch.Tensor) -> int:
    return FAKE_SMS if mode == "fake" else _sm_count(t.device.index)


def search_cost(g: int, b: int, c: int, w: int) -> tuple[int, int, str]:
    """(bytes, operations, kind) of the search of g banks of b queries
    against c classes of w words: every query and class word read once,
    the int32 distances written; 2 operations a bit product (AND + popcount
    on the 1-bit tensor cores)."""
    return 4 * g * (b + c) * w + 4 * g * b * c, 2 * g * b * c * 32 * w, "b1"


def topk_cost(g: int, b: int, c_real: int, w: int, k: int = 1,
              table_rows: int | None = None) -> tuple[int, int, str]:
    """(bytes, operations, kind) of the fused top-1 (k = 1) or top-k of g
    banks: the queries and each bank's c_real classes read once, k (distance,
    index) pairs a query written. With ``table_rows`` (T) the banks are rows
    ``bank_rows`` of a [T, C, W] table: the table's T * c_real classes and
    the g row ids are read instead."""
    classes = g * c_real if table_rows is None else table_rows * c_real
    extra = 0 if table_rows is None else 4 * g
    return (4 * (g * b + classes) * w + extra + 8 * g * b * k, 2 * g * b * c_real * 32 * w,
            "b1")


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
    mode = dispatch("hamming_search", qf, protos)
    if mode == "cpu":
        return hamming_search_ref(qf, protos).reshape(lead + (c,))
    check_contiguous("hamming_search", qf, protos)
    if b > MAX_GRID * 32:
        raise ValueError(f"hamming_search: B={b} beyond the kernel's limits")
    out = torch.empty((b, c), dtype=torch.int32, device=q.device)
    if b and c and mode == "fake":
        record_launch("hamming_search", search_cost(1, b, c, w))
    elif b and c:
        _build.launch("hamming_search_banked_launch", qf, protos, out, 1, b, c, w)
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
    mode = dispatch("hamming_search_banked", q, protos)
    if mode == "cpu":
        return hamming_search_banked_ref(q, protos)
    check_contiguous("hamming_search_banked", q, protos)
    if g > MAX_GRID or b > MAX_GRID * 32:
        raise ValueError(f"hamming_search_banked: G={g} or B={b} beyond the kernel's limits")
    out = torch.empty((g, b, c), dtype=torch.int32, device=q.device)
    if g and b and c and mode == "fake":
        record_launch("hamming_search_banked", search_cost(g, b, c, w))
    elif g and b and c:
        _build.launch("hamming_search_banked_launch", q, protos, out, g, b, c, w)
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
    mode = dispatch("hamming_topk_k_banked", q, protos)
    if mode == "cpu":
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
        splits = plan(g, b, c_real, _sms(mode, q))
        # the split lists (dist, idx) before their merge; none for one split
        scratch = [torch.empty((splits, g, b, k), dtype=torch.int32, device=q.device)
                   if splits > 1 else None for _ in range(2)]
        if mode == "fake":
            record_launch("hamming_topk_k_banked", topk_cost(g, b, c_real, w, k))
        else:
            _build.launch("hamming_topk_k_banked_launch", q, protos, dist, idx, *scratch,
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
    On the card the class axis is split over blocks by `plan_top1`; with
    more than one split the split results go through a [splits, G, B]
    scratch and a merge kernel, both inside the one counted launch.
    """
    c_real = _banks("hamming_topk_banked", q, protos, bank_rows, c_real)
    rows = () if bank_rows is None else (bank_rows,)
    mode = dispatch("hamming_topk_banked", q, protos, *rows)
    if mode == "cpu":
        if k is None:
            return hamming_topk_banked_ref(q, protos, c_real, bank_rows)
        return hamming_topk_k_banked_ref(q, protos, k, c_real, bank_rows)
    if mode == "fake" and bank_rows is not None:
        # the whole call, the rows' gather included, as one cost
        name = "hamming_topk_banked" if k is None else "hamming_topk_k_banked"
        with fake_launch(name, topk_cost(q.shape[0], q.shape[1], c_real, q.shape[2], k or 1,
                                         table_rows=protos.shape[0])):
            return hamming_topk_banked(q, protos.index_select(0, bank_rows), k=k,
                                       c_real=c_real)
    if bank_rows is not None:
        protos = protos.index_select(0, bank_rows)                # [G, C, W]
    if k is not None:
        return hamming_topk_k_banked(q, protos, k, c_real=c_real)
    check_contiguous("hamming_topk_banked", q, protos)
    g, b, w = q.shape
    if g > MAX_GRID:
        raise ValueError(f"hamming_topk_banked: G={g} > {MAX_GRID}")
    dist = torch.empty((g, b), dtype=torch.int32, device=q.device)
    idx = torch.empty((g, b), dtype=torch.int32, device=q.device)
    if g and b:
        bm, splits = plan_top1(g, b, c_real, _sms(mode, q))
        # the split results (dist, idx) before their merge; none for one split
        scratch = [torch.empty((splits, g, b), dtype=torch.int32, device=q.device)
                   if splits > 1 else None for _ in range(2)]
        if mode == "fake":
            record_launch("hamming_topk_banked", topk_cost(g, b, c_real, w))
        else:
            _build.launch("hamming_topk_banked_launch", q, protos, dist, idx, *scratch,
                          g, b, protos.shape[1], w, c_real, bm, splits)
            hamming_topk_banked.launches += 1
    return dist, idx


hamming_topk_banked.launches = 0
