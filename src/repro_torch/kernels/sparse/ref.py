"""Plain PyTorch versions of the sparse-query search kernels (the
``use_kernel=False`` path of `repro/kernels/sparse/ops.py`): the O(k)
gather-overlap ``|q| + popcount(p) - 2*overlap``, streamed over class chunks
so that neither a dense query nor the full [G, B, C] distances exist at
once. The CPU tests and `chip_smoke.py`'s comparison phases use them; the
serve and the trials on the card never do."""
from __future__ import annotations

import torch

from repro_torch.core.sparse import SENTINEL
from repro_torch.kernels.common import hamming_blocks, popcount32

# Budget for one chunk's [G, B, k, chunk] gather, in elements.
CHUNK_ELEMS = 1 << 26
POISON = 2**30


def _chunk(rows: int, k: int, c: int) -> int:
    """Classes per chunk: the reference's block policy, shrunk so that the
    gather of ``rows`` queries of ``k`` slots stays within CHUNK_ELEMS."""
    _, bc = hamming_blocks(rows, c)
    return max(1, min(bc, CHUNK_ELEMS // max(1, rows * k)))


def _dist_chunk(q: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """Distances of one class chunk, bank by bank: q [G, B, k] int32 index
    lists, chunk [G, C', W] int32 words -> [G, B, C'] int32."""
    v = q != SENTINEL
    w = torch.where(v, q >> 5, 0).to(torch.int64)
    b = torch.where(v, q & 31, 0)
    banks = torch.arange(q.shape[0], device=q.device)[:, None, None]
    sel = chunk.transpose(1, 2)[banks, w]                # [G, B, k, C']
    ov = (((sel >> b[..., None]) & 1) * v[..., None]).sum(-2, dtype=torch.int32)
    pop = popcount32(chunk).sum(-1, dtype=torch.int32)   # [G, C']
    cnt = v.sum(-1, dtype=torch.int32)                   # [G, B]
    return cnt[..., None] + pop[:, None, :] - 2 * ov


def sparse_search_ref(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Full distances: q [B, k] int32 sorted SENTINEL-padded, protos [C, W]
    int32 -> [B, C] int32."""
    b, k = q.shape
    c = protos.shape[0]
    step = _chunk(b, k, c)
    out = [_dist_chunk(q[None], protos[None, i:i + step])[0] for i in range(0, c, step)]
    return torch.cat(out, dim=-1) if out else q.new_zeros((b, 0))


def sparse_topk_banked_ref(
    q: torch.Tensor, protos: torch.Tensor, c_real: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bank fused top-1: q [G, B, k], protos [G, C, W] int32 ->
    (min_dist, argmin), each [G, B] int32, ties to the first minimum.

    A running (min, argmin) carry with a strict ``<`` merge over class
    chunks: the reference's two-reduction carry, which it takes where its
    int32 key ``dist*C + col`` would overflow ((d+1)*C >= 2^31, as at 6400
    classes and d = 2^20) and which gives the key's answer everywhere.
    Columns at or past ``c_real`` (default C) are poisoned to 2^30."""
    g, b, k = q.shape
    c = protos.shape[1]
    c_real = c if c_real is None else c_real
    step = _chunk(g * b, k, c)
    best_v = best_i = None
    for start in range(0, c, step):
        dist = _dist_chunk(q, protos[:, start:start + step])
        col = start + torch.arange(dist.shape[-1], device=q.device, dtype=torch.int32)
        dist = torch.where(col < c_real, dist, POISON)
        v = dist.min(dim=-1).values
        i = start + torch.argmin(dist, dim=-1).to(torch.int32)
        if best_v is None:
            best_v, best_i = v, i
        else:
            better = v < best_v
            best_i = torch.where(better, i, best_i)
            best_v = torch.where(better, v, best_v)
    return best_v, best_i
