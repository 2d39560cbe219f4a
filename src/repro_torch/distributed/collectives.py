"""The per-receiver binary symmetric channel of the OTA serve and the sparse
index-list wire (counterpart of `ota_noise`, `ota_noise_packed` and
`sparse_index_allgather` in `repro/distributed/collectives.py`).

One GPU carries the whole ``model`` axis in this port, so the reference's
collectives reduce to local sums and reshapes inside `core.scaleout`; the
multi-GPU collectives over `torch.distributed` are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import hypervector as hv


def ota_noise(generator: torch.Generator, bits: torch.Tensor, ber) -> torch.Tensor:
    """BSC at rate `ber` (float, or a tensor broadcasting against `bits`) on
    uint8 {0,1} bits."""
    return hv.flip_bits(generator, bits, ber)


def ota_noise_packed(generator: torch.Generator, words: torch.Tensor, ber,
                     mode: str = "exact", planes: int = 16) -> torch.Tensor:
    """BSC on packed int32 words [..., W].

    ``mode="exact"`` packs the same Bernoulli draw `ota_noise` makes on the
    unpacked bits, so the packed pipeline equals the unpacked one on the same
    generator. ``mode="bitplane"`` draws the mask directly as words through
    a bit-sliced comparator over ``planes`` random bit-planes
    (`hv.bernoulli_words`): ``planes`` random bits per mask bit instead of
    32, no unpacked intermediate, the BER quantized to 2^-planes."""
    if mode == "exact":
        return hv.flip_bits_packed(generator, words, ber)
    if mode == "bitplane":
        return words ^ hv.bernoulli_words(generator, ber, words.shape, precision=planes)
    raise ValueError(f"unknown packed noise mode {mode!r}")


def sparse_index_allgather(idx: torch.Tensor) -> torch.Tensor:
    """The index-list wire of the sparse OTA majority on one GPU: idx int32
    [..., S, e, k_max] (every model shard's ``e`` encoder slots, all local)
    -> [..., S*e, k_max], slot s*e + j holding shard s's slot j, the
    reference's shard-major order. With the model axis of size S = 1 there
    is nothing to gather: this is the slot-flattening reshape."""
    return idx.reshape(idx.shape[:-3] + (idx.shape[-3] * idx.shape[-2], idx.shape[-1]))
