"""Plain PyTorch versions of the packed Hamming kernels (int32 words holding
the reference's uint32 bits). The CPU tests and `chip_smoke.py`'s comparison
phases use them; the serve path on the card never does."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import hamming_blocks, popcount32

# Budget for one chunk's [.., chunk, W] XOR intermediate, in elements: the
# plain versions never hold more than this at once, whatever C is.
CHUNK_ELEMS = 1 << 26


def _chunk(rows: int, w: int, c: int) -> int:
    """Classes per chunk: the reference's block policy, shrunk so that
    ``rows * chunk * w`` stays within CHUNK_ELEMS."""
    _, bc = hamming_blocks(rows, c)
    return max(1, min(bc, CHUNK_ELEMS // max(1, rows * w)))


def hamming_search_ref(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Packed Hamming distances: q [B, W] int32, protos [C, W] int32 ->
    [B, C] int32, by XOR + SWAR popcount, streamed over class chunks."""
    b, w = q.shape
    c = protos.shape[0]
    step = _chunk(b, w, c)
    out = [
        popcount32(q[:, None, :] ^ protos[None, i:i + step, :]).sum(-1, dtype=torch.int32)
        for i in range(0, c, step)
    ]
    return torch.cat(out, dim=-1) if out else q.new_zeros((b, 0))


def hamming_search_banked_ref(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Per-bank packed Hamming distances: q [G, B, W], protos [G, C, W]
    int32 -> [G, B, C] int32, bank g's queries against bank g's prototypes
    only, streamed over class chunks."""
    g, b, w = q.shape
    c = protos.shape[1]
    step = _chunk(g * b, w, c)
    out = [
        popcount32(q[:, :, None, :] ^ protos[:, None, i:i + step, :]).sum(-1, dtype=torch.int32)
        for i in range(0, c, step)
    ]
    return torch.cat(out, dim=-1) if out else q.new_zeros((g, b, 0))


def _tile(protos: torch.Tensor, start: int, stop: int,
          bank_rows: torch.Tensor | None) -> torch.Tensor:
    """Class columns [start, stop) of every bank: [G, stop - start, W]; with
    ``bank_rows`` the table rows it names, gathered one chunk at a time so the
    expanded [G, C, W] view never exists."""
    chunk = protos[:, start:stop, :]
    return chunk if bank_rows is None else chunk.index_select(0, bank_rows)


def hamming_topk_banked_ref(
    q: torch.Tensor, protos: torch.Tensor, c_real: int | None = None,
    bank_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bank fused top-1: q [G, B, W], protos [G, C, W] int32 ->
    (min_dist, argmin), each [G, B] int32. With ``bank_rows`` [G], protos is
    a [T, C, W] table and bank g searches table row ``bank_rows[g]``.

    Streams class chunks through a running (min, argmin) carry, so the
    [G, B, C, W] XOR never exists past one chunk. Columns at or past
    ``c_real`` (default C) are poisoned to 2^30 and never win; ties go to the
    first minimum (argmin is first-match inside a chunk, and the strict ``<``
    merge keeps the earlier chunk), as `_topk_banked_kernel` does.
    """
    g, b, w = q.shape
    c = protos.shape[1]
    c_real = c if c_real is None else c_real
    step = _chunk(g * b, w, c)
    best_v = best_i = None
    for start in range(0, c, step):
        chunk = _tile(protos, start, start + step, bank_rows)
        dist = popcount32(q[:, :, None, :] ^ chunk[:, None, :, :]).sum(-1, dtype=torch.int32)
        col = start + torch.arange(chunk.shape[1], device=q.device, dtype=torch.int32)
        dist = torch.where(col < c_real, dist, torch.full_like(dist, 2**30))
        v = dist.min(dim=-1).values
        i = start + torch.argmin(dist, dim=-1).to(torch.int32)
        if best_v is None:
            best_v, best_i = v, i
        else:
            better = v < best_v
            best_i = torch.where(better, i, best_i)
            best_v = torch.where(better, v, best_v)
    return best_v, best_i


def hamming_topk_k_banked_ref(
    q: torch.Tensor, protos: torch.Tensor, k: int, c_real: int | None = None,
    bank_rows: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bank fused top-k: q [G, B, W], protos [G, C, W] int32 ->
    (dists, idxs), each [G, B, k] int32, rank-sorted ascending by
    (distance, class index): rank r is the r-th first minimum. Only the
    first ``c_real`` (default C) columns rank; with ``bank_rows`` [G], protos
    is a [T, C, W] table searched as in `hamming_topk_banked_ref`.

    Streams class chunks (each at least k wide) through a [G, B, k] carry.
    Every candidate carries the int64 key ``dist * 2^32 + col``, unique and
    ordered as (dist, col), so the k smallest keys are one well-defined set in
    one order whatever `torch.topk` does with ties, and no key can overflow:
    this equals both of the reference's streamed branches (its int32
    ``dist*C + col`` key and its two-key sort).
    """
    g, b, w = q.shape
    c_real = protos.shape[1] if c_real is None else c_real
    if not 1 <= k <= c_real:
        raise ValueError(f"k={k} outside [1, {c_real}]")
    step = max(k, _chunk(g * b, w, c_real))
    best = None                                         # [G, B, <=k] int64 keys
    for start in range(0, c_real, step):
        chunk = _tile(protos, start, min(start + step, c_real), bank_rows)
        dist = popcount32(q[:, :, None, :] ^ chunk[:, None, :, :]).sum(-1, dtype=torch.int64)
        col = start + torch.arange(chunk.shape[1], device=q.device, dtype=torch.int64)
        keys = (dist << 32) + col
        cand = keys if best is None else torch.cat([best, keys], -1)
        best = torch.topk(cand, min(k, cand.shape[-1]), dim=-1, largest=False).values
    return (best >> 32).to(torch.int32), (best & 0xFFFFFFFF).to(torch.int32)
