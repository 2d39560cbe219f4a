"""Binary hyperdimensional-computing algebra (counterpart of
`repro/core/hypervector.py`).

Two representations, as in the reference:

* **unpacked**: ``uint8`` tensors of {0, 1}.
* **packed**: ``int32`` tensors of d/32 words holding the reference's uint32
  bits in the same little-endian order (bit j of word w is dimension
  32*w + j). torch's uint32 has no shifts, so words are int32; every right
  shift is logical (masked after ``>>``), and shifts that can carry past bit
  31 run in int64 and wrap back, so nothing relies on signed overflow.

Randomness goes through an explicit `torch.Generator` where the reference
takes a `jax.random` key. The packed BSC packs the *same* unpacked Bernoulli
draw as `flip_bits`, so packed and unpacked pipelines agree on one generator.
Where the tests replay JAX's randomness, a function also takes its draw as
an argument (`majority`'s tie bits, `bernoulli_words`'s planes).
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.kernels.common import popcount32

WORD = 32
_FULL = -1  # all 32 bits set, as int32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned value in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def random_hv(generator: torch.Generator, num: int, dim: int,
              device: str | torch.device | None = "cuda") -> torch.Tensor:
    """`num` i.i.d. random binary hypervectors of dimension `dim` (uint8)."""
    dev = _device.resolve(device)
    return torch.randint(0, 2, (num, dim), generator=generator, device=dev,
                         dtype=torch.uint8)


def bind(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Binding = elementwise XOR (either representation)."""
    return a ^ b


def permute(hv: torch.Tensor, shift: int) -> torch.Tensor:
    """Cyclic permutation rho^shift along the last (dimension) axis."""
    return torch.roll(hv, int(shift), dims=-1)


def permute_batch(hvs: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-row cyclic shifts: hvs [..., M, d], shifts [M] -> [..., M, d]."""
    d = hvs.shape[-1]
    ar = torch.arange(d, device=hvs.device)
    idx = (ar[None, :] - shifts.to(hvs.device, torch.int64)[:, None]) % d
    return torch.gather(hvs, -1, idx.expand(hvs.shape))


def _tie_bits(generator, tie, shape, dev) -> torch.Tensor | None:
    """The random tie-break bits [..., d] (uint8): ``tie`` as given, else a
    fair coin per bit from ``generator``, else None (ties resolve to 0)."""
    if tie is not None:
        return tie.to(torch.uint8)
    if generator is None:
        return None
    return (torch.rand(shape, generator=generator, device=dev) < 0.5).to(torch.uint8)


def majority(hvs: torch.Tensor, generator: torch.Generator | None = None,
             tie: torch.Tensor | None = None) -> torch.Tensor:
    """Bitwise majority over axis 0 of [M, ..., d] uint8. Even-M ties
    resolve to 0 (strict ``count*2 > M``), the repo-wide rule, unless a
    ``generator`` or the ``tie`` bits [..., d] are given: then a random
    hypervector decides the ties (the classical tie-break, never on the
    serve path). Odd M never ties."""
    m = hvs.shape[0]
    counts = hvs.to(torch.int32).sum(0)
    strict = (counts * 2 > m).to(torch.uint8)
    tie = None if m % 2 else _tie_bits(generator, tie, counts.shape, hvs.device)
    if tie is None:
        return strict
    return torch.where(counts * 2 == m, tie, strict)


def hamming_similarity(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Normalized similarity 1 - hamming/d in [0, 1]: q [..., d], protos
    [C, d] -> [..., C], through the bipolar dot product."""
    d = q.shape[-1]
    qb = 2.0 * q.to(torch.float32) - 1.0
    pb = 2.0 * protos.to(torch.float32) - 1.0
    return (qb @ pb.T + d) / (2.0 * d)


def _bernoulli(generator: torch.Generator, p, shape, dev) -> torch.Tensor:
    """Bernoulli(p) mask of `shape` (p broadcasts against it)."""
    return torch.rand(shape, generator=generator, device=dev) < p


def flip_bits(generator: torch.Generator, hv: torch.Tensor, ber) -> torch.Tensor:
    """Binary symmetric channel: flip each bit independently w.p. `ber`
    (a float or a tensor broadcasting against `hv`)."""
    flips = _bernoulli(generator, ber, hv.shape, hv.device)
    return hv ^ flips.to(hv.dtype)


def _per_rx(ber_per_rx: torch.Tensor, ndim: int) -> torch.Tensor:
    """ber [N] -> [N, 1, ..., 1] broadcasting against [N] + a rank-`ndim` HV."""
    return ber_per_rx.reshape((ber_per_rx.shape[0],) + (1,) * ndim)


def flip_bits_per_rx(generator: torch.Generator, hv: torch.Tensor,
                     ber_per_rx: torch.Tensor) -> torch.Tensor:
    """Per-receiver BSC: hv [..., d] against ber_per_rx [N] -> [N, ..., d],
    copy r flipped at ``ber_per_rx[r]``."""
    n = ber_per_rx.shape[0]
    return flip_bits(generator, hv[None].expand((n,) + tuple(hv.shape)),
                     _per_rx(ber_per_rx, hv.dim()))


# ---------------------------------------------------------------------------
# packed representation
# ---------------------------------------------------------------------------

def pack(hv: torch.Tensor) -> torch.Tensor:
    """uint8 {0,1} [..., d] -> int32 words [..., d//32], little-endian."""
    d = hv.shape[-1]
    if d % WORD:
        raise ValueError(f"dim {d} must be a multiple of {WORD}")
    bits = hv.reshape(hv.shape[:-1] + (d // WORD, WORD)).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=hv.device) << torch.arange(
        WORD, device=hv.device)
    return _i32((bits * weights).sum(-1))


def unpack(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of `pack`: int32 words [..., W] -> uint8 [..., dim]."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1     # arithmetic >>, then bit 0
    return bits.reshape(packed.shape[:-1] + (dim,)).to(torch.uint8)


def random_hv_packed(generator: torch.Generator, num: int, dim: int,
                     device: str | torch.device | None = "cuda") -> torch.Tensor:
    """`num` i.i.d. random hypervectors drawn directly as 32-bit words
    [num, dim//32] int32: every bit a fair coin, as `random_hv`, but a
    different stream than ``pack(random_hv(...))``."""
    if dim % WORD:
        raise ValueError(f"dim {dim} must be a multiple of {WORD}")
    return _random_words(generator, (num, dim // WORD), _device.resolve(device))


def _random_words(generator: torch.Generator, shape, dev) -> torch.Tensor:
    """Uniform 32-bit words (int32 with the same bits), as `jax.random.bits`."""
    return torch.randint(-2**31, 2**31, tuple(shape), generator=generator, device=dev,
                         dtype=torch.int32)


def bind_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Packed binding: word-wise XOR (packing commutes with `bind`)."""
    return a ^ b


def hamming_distance_packed(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Packed Hamming distance by XOR + popcount: q [..., W], protos [C, W]
    -> int32 [..., C]."""
    return popcount32(q[..., None, :] ^ protos).sum(-1, dtype=torch.int32)


def permute_packed(hvp: torch.Tensor, shift: int) -> torch.Tensor:
    """Cyclic permutation rho^shift on packed words [..., W]: a roll by
    shift//32 words plus a shift by shift%32 bits with the carry from the
    previous word. Equals pack(permute(unpack(hvp), shift))."""
    w = hvp.shape[-1]
    s = int(shift) % (w * WORD)
    ws, bs = s // WORD, s % WORD
    rolled = torch.roll(hvp, ws, dims=-1)
    if bs == 0:
        return rolled
    prev = torch.roll(rolled, 1, dims=-1)
    u = _u32(rolled)
    carry = _u32(prev) >> (WORD - bs)              # logical: unsigned value
    return _i32(((u << bs) & 0xFFFFFFFF) | carry)


def permute_batch_packed(hvps: torch.Tensor, shifts) -> torch.Tensor:
    """Per-row cyclic shifts on packed rows: hvps [M, W], shifts [M] -> [M, W]."""
    return torch.stack([permute_packed(row, int(s)) for row, s in zip(hvps, shifts)])


def _bitsliced_counts(hvs: torch.Tensor) -> list[torch.Tensor]:
    """Bit-planes (LSB first) of the per-lane popcount over axis 0, by a
    carry-save ripple adder over the M words (no unpacking)."""
    planes: list[torch.Tensor] = []
    for k in range(hvs.shape[0]):
        carry = hvs[k]
        for i in range(len(planes)):
            planes[i], carry = planes[i] ^ carry, planes[i] & carry
        if len(planes) < (k + 1).bit_length():  # else carry is provably 0
            planes.append(carry)
    return planes


def _bitsliced_gt(planes: list[torch.Tensor], t) -> torch.Tensor:
    """(count > t) per bit lane, from LSB-first count planes; the threshold
    ``t`` is an int or an int32 tensor broadcasting against the planes (one
    threshold per lane), t < 2^len(planes): its bits are spread to 0 /
    all-ones words and compared plane by plane from the top."""
    gt = torch.zeros_like(planes[0])
    eq = torch.full_like(planes[0], _FULL)
    for i in reversed(range(len(planes))):
        tb = -((t >> i) & 1)                         # 0 or all-ones
        gt = gt | (eq & planes[i] & ~tb)
        eq = eq & ~(planes[i] ^ tb)
    return gt


def majority_packed(hvs: torch.Tensor, generator: torch.Generator | None = None,
                    tie: torch.Tensor | None = None) -> torch.Tensor:
    """Packed majority over axis 0: [M, ..., W] int32 -> [..., W], by the
    bit-sliced carry-save adder and a bitwise comparator. Ties as `majority`:
    even-M ties resolve to 0 unless a ``generator`` or unpacked ``tie`` bits
    [..., d] are given; the random tie bits are drawn unpacked and packed, so
    ``unpack(majority_packed(pack(x), g))`` equals ``majority(x, g)`` on one
    generator state."""
    m = hvs.shape[0]
    planes = _bitsliced_counts(hvs)
    gt = _bitsliced_gt(planes, m // 2)
    d = hvs.shape[-1] * WORD
    tie = None if m % 2 else _tie_bits(generator, tie, hvs.shape[1:-1] + (d,), hvs.device)
    if tie is None:
        return gt
    eq = _bitsliced_gt(planes, m // 2 - 1) & ~gt     # count == m/2
    return gt | (eq & pack(tie))


def majority_packed_masked(hvs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Strict packed majority over the masked subset of axis 0: hvs
    [M, ..., W] int32, mask [M, ...] bool (a prefix of hvs' leading dims, or
    broadcasting against them) -> [..., W]. Masked-out members count as zero
    words, and the threshold is the live count n = sum(mask) per lane:
    ``count*2 > n``, so even-n ties resolve to 0, as `majority_packed`; an
    empty selection gives all-zero words."""
    if hvs.shape[0] < 1 or mask.shape[0] != hvs.shape[0]:
        raise ValueError(f"mask {tuple(mask.shape)} does not select over hvs "
                         f"{tuple(hvs.shape)}")
    mask = mask.reshape(tuple(mask.shape) + (1,) * (hvs.dim() - mask.dim()))
    live = -mask.to(torch.int32)                     # 0 or all-ones per member
    planes = _bitsliced_counts(hvs & live)
    n = mask.sum(0, dtype=torch.int32)               # [..., 1] live count
    # n//2 <= M//2 < 2^len(planes) == 2^bit_length(M): the threshold fits
    return _bitsliced_gt(planes, n // 2)


def flip_bits_packed(generator: torch.Generator, hvp: torch.Tensor, ber) -> torch.Tensor:
    """Packed BSC, bit-exact against `flip_bits` on the same generator state:
    the Bernoulli mask is drawn in the unpacked layout [..., d] (the draw
    `flip_bits` makes) and packed before the XOR."""
    d = hvp.shape[-1] * WORD
    flips = _bernoulli(generator, ber, hvp.shape[:-1] + (d,), hvp.device)
    return hvp ^ pack(flips.to(torch.uint8))


def flip_bits_per_rx_packed(generator: torch.Generator, hvp: torch.Tensor,
                            ber_per_rx: torch.Tensor) -> torch.Tensor:
    """Per-receiver packed BSC: hvp [..., W] against ber_per_rx [N] ->
    [N, ..., W], the same mask draw as `flip_bits_per_rx`, packed."""
    n = ber_per_rx.shape[0]
    return flip_bits_packed(generator, hvp[None].expand((n,) + tuple(hvp.shape)),
                            _per_rx(ber_per_rx, hvp.dim()))


def bernoulli_words(generator: torch.Generator | None, p, shape, precision: int = 16,
                    planes: torch.Tensor | None = None) -> torch.Tensor:
    """Bernoulli(p) bit masks drawn directly as packed int32 words [*shape].

    ``precision`` fair bit-planes [precision, *shape] (``planes`` if given,
    else drawn from ``generator``) form a ``precision``-bit uniform per bit
    lane, and a bit-sliced comparator against round(p * 2^precision) sets
    the lanes whose uniform lies below it: ``precision`` random bits per
    mask bit instead of the 32 of a float draw, and no unpacked
    intermediate. p (a float or a tensor broadcasting against ``shape``) is
    quantized to 2^-precision, so this is the "bitplane" noise mode, not
    bit-exact against `flip_bits`."""
    shape = tuple(shape)
    if planes is None:
        dev = p.device if isinstance(p, torch.Tensor) else generator.device
        planes = _random_words(generator, (precision,) + shape, dev)
    elif tuple(planes.shape) != (precision,) + shape:
        raise ValueError(f"planes {tuple(planes.shape)} != {(precision,) + shape}")
    pf = torch.as_tensor(p, dtype=torch.float32, device=planes.device)
    t = torch.clamp(torch.round(pf * 2**precision), 0, 2**precision - 1).to(torch.int32)
    lt = torch.zeros(shape, dtype=torch.int32, device=planes.device)
    eq = torch.full(shape, _FULL, dtype=torch.int32, device=planes.device)
    for i in reversed(range(precision)):
        tb = -((t >> i) & 1)                         # 0 or all-ones
        lt = lt | (eq & ~planes[i] & tb)
        eq = eq & ~(planes[i] ^ tb)
    return lt
