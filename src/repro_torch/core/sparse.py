"""Ultra-sparse hypervectors as fixed-capacity sorted index lists
(counterpart of `repro/core/sparse.py`).

An HV at d up to 2^20 and ~0.1% density is stored as the sorted int32 list
of its set indices, padded to a fixed capacity ``k_max`` with ``SENTINEL``
(2^31 - 1). Every op is O(k_max log k_max) and independent of d, as in the
reference:

* **bind**    sorted-merge symmetric difference (XOR on index sets);
* **bundle**  run counts over the sorted union + strict majority
  (``count*2 > m``, even ties to 0, abstaining voters are empty lists);
* **permute** index add mod d + re-sort (cyclic shift rho^s);
* **flip_bits_sparse** BSC as per-index drop + fresh-index insertion, with
  its dense oracle `flip_bits_sparse_ref` on the same draws.

**Saturation** keeps the k_max smallest indices everywhere (`sparsify`'s
truncation); the empty HV is all-SENTINEL. Randomness goes through an
explicit `torch.Generator`; the draw schedule is `_noise_draws`, a function
of its own so a caller (the tests) can put JAX's draws in its place.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.kernels.common import popcount32

SENTINEL = 2**31 - 1

# Budget of one chunk of `random_sparse`'s dense draw, in elements: a
# codebook of 6400 rows at d = 2^20 would be 27 GB of floats in one draw.
DRAW_ELEMS = 1 << 26


def valid(idx: torch.Tensor) -> torch.Tensor:
    """Boolean mask of live entries (True where the slot holds an index)."""
    return idx != SENTINEL


def count(idx: torch.Tensor) -> torch.Tensor:
    """Number of set indices per HV: int32 [...] from idx [..., k_max]."""
    return valid(idx).sum(-1, dtype=torch.int32)


def _sorted(x: torch.Tensor, k_max: int) -> torch.Tensor:
    return torch.sort(x, dim=-1).values[..., :k_max].contiguous()


def sparsify(bits: torch.Tensor, k_max: int) -> torch.Tensor:
    """Dense uint8 {0,1} [..., d] -> sorted index list int32 [..., k_max]
    (at most d slots), keeping the k_max smallest set indices.

    Each set bit's rank among the set bits of its row is its slot, so no
    sort over d is needed; ranks past k_max go to a scratch slot that is
    sliced away."""
    d = bits.shape[-1]
    width = min(k_max, d)
    on = bits != 0
    rank = torch.cumsum(on, dim=-1, dtype=torch.int64) - 1
    slot = torch.where(on & (rank < width), rank, torch.full_like(rank, width))
    out = torch.full(bits.shape[:-1] + (width + 1,), SENTINEL, dtype=torch.int32,
                     device=bits.device)
    iota = torch.arange(d, dtype=torch.int32, device=bits.device).expand(bits.shape)
    out.scatter_(-1, slot, iota)
    return out[..., :width].contiguous()


def densify(idx: torch.Tensor, d: int) -> torch.Tensor:
    """Sorted index list int32 [..., k_max] -> dense uint8 {0,1} [..., d];
    SENTINEL slots land in a scratch column d that is sliced away."""
    pos = torch.clamp(idx, max=d).to(torch.int64)
    out = torch.zeros(idx.shape[:-1] + (d + 1,), dtype=torch.uint8, device=idx.device)
    out.scatter_(-1, pos, 1)
    return out[..., :d].contiguous()


def random_sparse(generator: torch.Generator, num: int, dim: int, k_max: int,
                  density: float, device: str | torch.device | None = "cuda"
                  ) -> torch.Tensor:
    """`num` i.i.d. sparse HVs [num, k_max] int32: each bit set i.i.d. w.p.
    `density`, sparsified. The dense draw runs once, at setup, in row chunks
    of at most DRAW_ELEMS elements."""
    dev = _device.resolve(device)
    rows = max(1, DRAW_ELEMS // max(dim, 1))
    chunks = [
        sparsify((torch.rand((min(rows, num - r), dim), generator=generator, device=dev)
                  < density).to(torch.uint8), k_max)
        for r in range(0, num, rows)
    ]
    if not chunks:
        return torch.empty((0, min(k_max, dim)), dtype=torch.int32, device=dev)
    return torch.cat(chunks)


def _compact(idx: torch.Tensor, keep: torch.Tensor, k_max: int) -> torch.Tensor:
    """Keep masked entries, push the rest to SENTINEL, re-sort, truncate."""
    return _sorted(torch.where(keep, idx, SENTINEL), k_max)


def _neighbours(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(previous, next) entry along the last axis, with -1 / -2 at the ends
    (values no index takes)."""
    lead = s.shape[:-1] + (1,)
    prev = torch.cat([torch.full(lead, -1, dtype=s.dtype, device=s.device), s[..., :-1]], -1)
    nxt = torch.cat([s[..., 1:], torch.full(lead, -2, dtype=s.dtype, device=s.device)], -1)
    return prev, nxt


def bind(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sparse bind: symmetric difference of the index sets, [..., k_max]."""
    k_max = a.shape[-1]
    merged = torch.sort(torch.cat([a, b], -1), dim=-1).values
    prev, nxt = _neighbours(merged)
    # indices are unique within one HV: present once == differs from both sides
    keep = (merged != prev) & (merged != nxt) & valid(merged)
    return _compact(merged, keep, k_max)


def bundle(stack: torch.Tensor, m: int | torch.Tensor | None = None) -> torch.Tensor:
    """Sparse majority over the second-to-last axis: int32 [..., M, k_max] ->
    [..., k_max]. An index survives iff it appears in more than half of the
    `m` voters (default M); abstaining voters are all-SENTINEL lists, a
    dense all-zero vote.

    Run lengths come from a sort and two scans: a forward running max of run
    starts and a backward running min of run ends."""
    m_stack, k_max = stack.shape[-2], stack.shape[-1]
    m = m_stack if m is None else m
    n = m_stack * k_max
    s = torch.sort(stack.reshape(stack.shape[:-2] + (n,)), dim=-1).values
    prev, nxt = _neighbours(s)
    start, end = s != prev, s != nxt
    pos = torch.arange(n, dtype=torch.int32, device=s.device).expand(s.shape)
    first = torch.cummax(torch.where(start, pos, -1), dim=-1).values
    last = torch.flip(torch.cummin(torch.flip(torch.where(end, pos, n), [-1]),
                                   dim=-1).values, [-1])
    cnt = last - first + 1
    keep = start & valid(s) & (cnt * 2 > m)
    return _compact(s, keep, k_max)


def permute(idx: torch.Tensor, shift: int, d: int) -> torch.Tensor:
    """Cyclic permutation rho^shift: index add mod d, re-sorted."""
    shifted = torch.where(valid(idx), (idx + int(shift)) % d, SENTINEL)
    return _sorted(shifted, idx.shape[-1])


def _union(a: torch.Tensor, b: torch.Tensor, k_max: int) -> torch.Tensor:
    """Sorted set union of two SENTINEL-padded lists, truncated to k_max."""
    merged = torch.sort(torch.cat([a, b], -1), dim=-1).values
    prev, _ = _neighbours(merged)
    return _compact(merged, (merged != prev) & valid(merged), k_max)


def _noise_draws(generator: torch.Generator, shape: tuple, ber, d: int, k_max: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The draw schedule of the sparse BSC and its dense oracle: (drop [shape]
    bool, pos [shape] int32 in [0, d), acc [shape] bool). ``ber`` is a float
    or a tensor broadcasting against `shape`. Each of the k_max insertion
    candidates is accepted w.p. min(1, ber*d/k_max), so the expected count of
    fresh bits matches the dense BSC's ~ber*d until capacity saturates."""
    dev = generator.device
    ber = torch.as_tensor(ber, dtype=torch.float32, device=dev)
    drop = torch.rand(shape, generator=generator, device=dev) < ber
    pos = torch.randint(0, d, shape, generator=generator, device=dev, dtype=torch.int32)
    p_ins = torch.clamp(ber * (d / max(k_max, 1)), max=1.0)
    acc = torch.rand(shape, generator=generator, device=dev) < p_ins
    return drop, pos, acc


def apply_noise(idx: torch.Tensor, drop: torch.Tensor, pos: torch.Tensor,
                acc: torch.Tensor) -> torch.Tensor:
    """The sparse BSC on given draws: live indices survive unless dropped,
    accepted candidates are inserted (a candidate on a survivor is absorbed,
    one on a just-dropped index re-inserts it)."""
    survivors = torch.where(valid(idx) & ~drop, idx, SENTINEL)
    inserts = torch.where(acc, pos, SENTINEL)
    return _union(survivors, inserts, idx.shape[-1])


def flip_bits_sparse(generator: torch.Generator, idx: torch.Tensor, ber, d: int
                     ) -> torch.Tensor:
    """Sparse BSC: idx int32 [..., k_max] -> [..., k_max]; drop each set
    index w.p. `ber`, insert fresh ones (see `_noise_draws`)."""
    return apply_noise(idx, *_noise_draws(generator, tuple(idx.shape), ber, d,
                                          idx.shape[-1]))


def flip_bits_sparse_ref(generator: torch.Generator, bits: torch.Tensor, ber,
                         k_max: int) -> torch.Tensor:
    """Dense oracle of `flip_bits_sparse` on the same draws: bits uint8
    [..., d] -> [..., d], equal to ``densify(flip_bits_sparse(g,
    sparsify(bits, k_max), ber, d), d)`` on an equally seeded generator."""
    d = bits.shape[-1]
    idx = sparsify(bits, k_max)
    drop, pos, acc = _noise_draws(generator, tuple(idx.shape), ber, d, idx.shape[-1])
    kept = densify(torch.where(valid(idx) & ~drop, idx, SENTINEL), d)
    inserted = densify(torch.where(acc, pos, SENTINEL), d)
    return densify(sparsify(kept | inserted, k_max), d)


def overlap(idx: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """|q AND p| of sparse queries idx int32 [..., k_max] and packed
    prototypes words int32 [C, W] -> int32 [..., C]: gather the word holding
    each index and test its bit (no dense query)."""
    v = valid(idx)
    w = torch.where(v, idx >> 5, 0).to(torch.int64)
    b = torch.where(v, idx & 31, 0)
    sel = words.T[w]                                   # [..., k_max, C]
    hit = ((sel >> b[..., None]) & 1) * v[..., None]
    return hit.sum(-2, dtype=torch.int32)


def hamming_from_overlap(idx: torch.Tensor, words: torch.Tensor,
                         ov: torch.Tensor) -> torch.Tensor:
    """Hamming distance |q XOR p| = |q| + |p| - 2|q AND p|: int32 [..., C]."""
    pop = popcount32(words).sum(-1, dtype=torch.int32)
    return count(idx)[..., None] + pop - 2 * ov
