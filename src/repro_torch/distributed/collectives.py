"""The per-receiver binary symmetric channel of the OTA serve (counterpart
of `ota_noise` / `ota_noise_packed` in `repro/distributed/collectives.py`).

One GPU carries the whole ``model`` axis in this port, so the reference's
collectives reduce to local sums inside `core.scaleout`; the multi-GPU
collectives over `torch.distributed` are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import hypervector as hv


def ota_noise(generator: torch.Generator, bits: torch.Tensor, ber) -> torch.Tensor:
    """BSC at rate `ber` (float, or a tensor broadcasting against `bits`) on
    uint8 {0,1} bits."""
    return hv.flip_bits(generator, bits, ber)


def ota_noise_packed(generator: torch.Generator, words: torch.Tensor, ber,
                     mode: str = "exact") -> torch.Tensor:
    """BSC on packed int32 words [..., W].

    ``mode="exact"`` packs the same Bernoulli draw `ota_noise` makes on the
    unpacked bits, so the packed pipeline equals the unpacked one on the same
    generator. The reference's ``"bitplane"`` mode is not ported yet."""
    if mode == "exact":
        return hv.flip_bits_packed(generator, words, ber)
    if mode == "bitplane":
        raise NotImplementedError("ota_noise_packed(mode='bitplane') is not ported yet")
    raise ValueError(f"unknown packed noise mode {mode!r}")
