"""Public ops: sparse-query vs packed-prototype Hamming search and its fused
per-bank top-1 (counterpart of `repro/kernels/sparse/ops.py`).

Queries are int32 index lists, each SORTED ascending and padded at the end
with ``SENTINEL``, their entries in [0, 32*W); prototypes are packed int32
words. The kernels rely on the order: they walk each list once and stop at
its first SENTINEL (an unsorted list gives wrong distances on the card).
A wrapper given fake tensors makes the kernel's outputs and records its
cost (`search_cost`, `topk_cost`; `kernels.common.fake_launch`).
A wrapper given CPU tensors runs the plain version in `ref.py`; given CUDA
tensors it launches the kernels of ``csrc/sparse.cu`` (and counts the
launch) or raises, also where the kernels refuse the shape (W of 2^26 words
or more, where a bit index leaves int32; a grid too tall). Any row width
below that works: the kernels stream a row through shared memory in
segments, laid out by `plan`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, check, check_contiguous, dispatch, record_launch
from repro_torch.kernels.sparse.ref import sparse_search_ref, sparse_topk_banked_ref

# csrc/sparse.cu's constants
WARPS = 16                 # a block's warps (512 threads)
CLASS_TILE = 128           # classes a block holds at once, 4 a lane
STAGES = 2                 # segments landing at once
SMEM_MAX = 232448          # 227 KB: the most shared memory an H100 block can use
MAX_W = 1 << 26            # rows of MAX_W words or more: a bit index leaves int32
# the plan's choices
SMEM_BUDGET = 213 * 1024   # a block's shared memory: one block an SM
SMS = 132                  # H100 SXM streaming multiprocessors
MAX_SPLITS = 8             # splits of a walk over W, unless fewer blocks leave SMs idle


def search_cost(b: int, c: int, w: int, k: int, live: int | None = None
                ) -> tuple[int, int, str]:
    """(bytes, operations, kind) of b index lists of k slots against c
    packed classes of w words: the lists and the classes read once, the
    int32 distances written; one gathered bit test a live index and class
    (``live`` indices in all, by default every slot: a fake tensor holds no
    data to count). Gathers have no tensor-core peak: bound by the bytes."""
    live = b * k if live is None else live
    return 4 * (b * k + c * w + b * c), live * c, "gather"


def topk_cost(g: int, b: int, c: int, w: int, k: int, c_real: int | None = None,
              live: int | None = None) -> tuple[int, int, str]:
    """(bytes, operations, kind) of the fused sparse top-1 of g banks: the
    lists and each bank's c classes read once, the (distance, index) pairs
    written; operations as `search_cost` over the c_real (default c)
    classes that rank."""
    live = g * b * k if live is None else live
    return (4 * g * (b * k + c * w) + 8 * g * b, live * (c if c_real is None else c_real),
            "gather")


def landing_stride(wseg: int) -> int:
    """Row stride (words) of the landing buffers (csrc/sparse.cu
    `landing_stride`): wseg + 4, so that a quarter-warp's 16-byte reads of 8
    neighbouring rows in the transpose fall in distinct banks."""
    return wseg + 4


@dataclass(frozen=True)
class Plan:
    """How a launch cuts the work: ``qpw`` queries a warp (16*qpw a block);
    segments of ``wseg`` words (a multiple of 8) of ``rows`` classes (a
    tile), landed row-major at ``landing_stride(wseg)`` words a row in STAGES
    buffers and transposed to one word-major buffer at ``stride`` words a
    word row (the tile's classes, rounded up to a multiple of 4 for 16-byte
    reads); and ``splits`` blocks sharing one (query tile, class tile) over
    W (`sparse_search` only)."""
    qpw: int
    wseg: int
    stride: int
    rows: int
    splits: int = 1

    @property
    def smem(self) -> int:
        """Shared memory of a block: the landing ring, the word-major buffer
        and the tile's |p| counters (csrc/sparse.cu `launch`)."""
        return 4 * (STAGES * self.rows * landing_stride(self.wseg) + self.wseg * self.stride
                    + CLASS_TILE)

    def segments(self, w: int) -> list[tuple[int, int]]:
        """The segments [w0, w1) of a row of w words, in walk order."""
        return [(w0, min(w, w0 + self.wseg)) for w0 in range(0, w, self.wseg)]

    def split_segments(self, w: int) -> list[list[tuple[int, int]]]:
        """The segments each of the ``splits`` blocks walks (the kernel's
        floor partition of the segment count)."""
        seg = self.segments(w)
        n = len(seg)
        return [seg[s * n // self.splits:(s + 1) * n // self.splits]
                for s in range(self.splits)]


@functools.lru_cache(maxsize=256)      # every launch asks for its plan
def plan(b: int, c: int, w: int, *, banks: int = 1, search: bool = False) -> Plan:
    """The launch plan for b queries a bank against c classes (c_real for the
    top-1) of w words over ``banks`` banks. The widest query tile (up to 128)
    that the batch fills, since each block re-stages its class tile; the
    longest segment (a multiple of 8 words) whose buffers fit SMEM_BUDGET;
    and, for the full search, the walk over W split among blocks until the
    blocks fill the card (the trials' single bank of 2000 queries makes 16
    query tiles)."""
    if not 0 < w < MAX_W or c <= 0:
        raise ValueError(f"sparse kernels: W={w}, C={c} outside their range")
    rows = min(c, CLASS_TILE)
    stride = cdiv(rows, 4) * 4
    # the buffers take ~4*(STAGES*rows + stride) bytes a word of segment
    wseg = min(cdiv(w, 8), SMEM_BUDGET // (4 * (STAGES * rows + stride)) // 8 + 1) * 8
    while wseg > 8 and Plan(1, wseg, stride, rows).smem > SMEM_BUDGET:
        wseg -= 8
    qpw = 1
    while qpw < 8 and WARPS * qpw < b:
        qpw *= 2
    splits = 1
    if search:
        # the split whose waves of blocks over the SMs take the least time,
        # ceil(blocks * s / SMS) / s, the fewest splits on a tie
        blocks = banks * cdiv(b, WARPS * qpw) * cdiv(c, CLASS_TILE)
        splits = min(range(1, min(cdiv(w, wseg), max(MAX_SPLITS, SMS // blocks)) + 1),
                     key=lambda s: (cdiv(blocks * s, SMS) / s, s))
    return Plan(qpw, wseg, stride, rows, splits)


def sparse_search(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Hamming distances between sparse queries q [B, k] (sorted,
    SENTINEL-padded) and packed prototypes [C, W] -> int32 [B, C]; equal to
    `hamming_search` on the packed densified queries."""
    check("sparse_search q", q, torch.int32, 2)
    check("sparse_search protos", protos, torch.int32, 2)
    b, k = q.shape
    c, w = protos.shape
    mode = dispatch("sparse_search", q, protos)
    if mode == "cpu":
        return sparse_search_ref(q, protos)
    check_contiguous("sparse_search", q, protos)
    if not (b and c):
        return torch.empty((b, c), dtype=torch.int32, device=q.device)
    pl = plan(b, c, w, search=True)
    # split walks add their partial distances into a zeroed output
    out = (torch.zeros if pl.splits > 1 else torch.empty)(
        (b, c), dtype=torch.int32, device=q.device)
    if mode == "fake":
        record_launch("sparse_search", search_cost(b, c, w, k))
        return out
    _build.launch("sparse_search_launch", q, protos, out,
                  b, c, w, k, pl.qpw, pl.wseg, pl.stride, pl.splits)
    sparse_search.launches += 1
    return out


sparse_search.launches = 0


def sparse_topk_banked(
    q: torch.Tensor, protos: torch.Tensor, *, c_real: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused per-bank sparse top-1: q [G, B, k] int32 sorted index lists, protos
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
    mode = dispatch("sparse_topk_banked", q, protos)
    if mode == "cpu":
        return sparse_topk_banked_ref(q, protos, c_real)
    check_contiguous("sparse_topk_banked", q, protos)
    dist = torch.empty((g, b), dtype=torch.int32, device=q.device)
    idx = torch.empty((g, b), dtype=torch.int32, device=q.device)
    if g and b:
        pl = plan(b, c_real, w, banks=g)
        if mode == "fake":
            record_launch("sparse_topk_banked", topk_cost(g, b, c, w, k, c_real))
        else:
            _build.launch("sparse_topk_banked_launch", q, protos, dist, idx,
                          g, b, c, w, k, c_real, pl.qpw, pl.wseg, pl.stride)
            sparse_topk_banked.launches += 1
    return dist, idx


sparse_topk_banked.launches = 0
