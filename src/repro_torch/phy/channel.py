"""Pluggable PHY channel tiers of the OTA serve (counterpart of
`repro/phy/channel.py`).

The precharacterization travels as a `ChannelState` (a dataclass of tensors
where the reference has a pytree). Ported tiers: ``ideal`` (error-free) and
``bsc`` (per-core binary symmetric channel at the Eq. 1 BER, the paper's
abstraction). The physical ``symbol`` tier is not ported yet:
``get_channel("symbol")`` raises NotImplementedError.

Tiers are looked up through a registry, so a test or an out-of-tree tier can
``register_channel(..., override=True)`` without editing this module.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import ota
from repro_torch.distributed import collectives


@dataclasses.dataclass(frozen=True)
class ChannelState:
    """Precharacterized channel state ([N] = RX cores leading)."""

    ber: torch.Tensor        # [N] f32 — Eq. (1) per-RX BER
    valid: torch.Tensor      # [N] bool — decision regions are a 2-means fit
    h: torch.Tensor          # [N, M] c64 — channel matrix
    phase_idx: torch.Tensor  # [M, 2] i32 — jointly optimized TX phase pairs
    symbols: torch.Tensor    # [N, 2^M] c64 — noiseless received constellation
    c0: torch.Tensor         # [N] c64 — maj=0 decision-region centroid
    c1: torch.Tensor         # [N] c64 — maj=1 decision-region centroid
    n0: torch.Tensor         # [] f32 — AWGN noise density

    FIELDS = ("ber", "valid", "h", "phase_idx", "symbols", "c0", "c1", "n0")

    @property
    def n_rx(self) -> int:
        return self.ber.shape[0]

    @property
    def m_tx(self) -> int:
        return self.h.shape[1]



def state_from_ota(res: ota.OTAResult, h: torch.Tensor) -> ChannelState:
    """Package an `ota.OTAResult` and its channel matrix as a ChannelState."""
    c0, c1 = ota.majority_centroids(res.symbols, ota.majority_labels(h.shape[1], h.device))
    return ChannelState(
        ber=res.ber_per_rx.to(torch.float32),
        valid=res.valid_per_rx.to(torch.bool),
        h=h.to(torch.complex64),
        phase_idx=res.phase_idx.to(torch.int32),
        symbols=res.symbols.to(torch.complex64),
        c0=c0.to(torch.complex64),
        c1=c1.to(torch.complex64),
        n0=torch.tensor(res.n0, dtype=torch.float32, device=h.device),
    )


def state_from_ber(ber: torch.Tensor, m_tx: int) -> ChannelState:
    """Minimal state for the ``ideal``/``bsc`` tiers from a bare BER table:
    zero physics and ``valid`` all-False, as in the reference."""
    ber = ber.to(torch.float32)
    n, dev = ber.shape[0], ber.device
    return ChannelState(
        ber=ber,
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        h=torch.zeros((n, m_tx), dtype=torch.complex64, device=dev),
        phase_idx=torch.zeros((m_tx, 2), dtype=torch.int32, device=dev),
        symbols=torch.zeros((n, 2 ** m_tx), dtype=torch.complex64, device=dev),
        c0=torch.zeros((n,), dtype=torch.complex64, device=dev),
        c1=torch.zeros((n,), dtype=torch.complex64, device=dev),
        n0=torch.ones((), dtype=torch.float32, device=dev),
    )


def combo_index(bits: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """TX bit combo index along `axis`: bits [.., M, ..] {0,1} -> int32 [..],
    LSB-first as `ota.bit_combos`."""
    m = bits.shape[axis]
    shape = [1] * bits.dim()
    shape[axis] = m
    weights = (1 << torch.arange(m, dtype=torch.int32, device=bits.device)).reshape(shape)
    return (bits.to(torch.int32) * weights).sum(axis, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the Channel interface + tiers
# ---------------------------------------------------------------------------

class Channel:
    """One fidelity tier of the OTA link inside the serve step.

    `rx_copies` returns every core's received copy of the bundled query
    ``reduced`` [B, d] uint8 (or [B, W] int32 words when ``packed``):
    [n_cores, B, d|W]. Core ``rx_base + i`` reads ``state.ber[i]``; the
    tier draws its noise from ``generator``."""

    name: str = "?"
    wire: str = "votes"

    def rx_copies(self, generator, reduced, state: ChannelState, rx_base, n_cores: int,
                  *, packed: bool, dim: int, noise: str) -> torch.Tensor:
        raise NotImplementedError


class IdealChannel(Channel):
    """Error-free link: every core receives the exact majority bundle."""

    name = "ideal"
    wire = "votes"

    def rx_copies(self, generator, reduced, state, rx_base, n_cores,
                  *, packed, dim, noise):
        return reduced[None].expand((n_cores,) + tuple(reduced.shape))


class BSCChannel(Channel):
    """Per-RX binary symmetric channel at the precharacterized BER (Eq. 1).

    All cores draw in one call: one [n_cores, B, d] uniform draw compared
    with ``state.ber[rx_base + i]`` per core, the same draw in both
    representations (the packed tier packs it), so packed and unpacked
    serves agree on one generator."""

    name = "bsc"
    wire = "votes"

    def rx_copies(self, generator, reduced, state, rx_base, n_cores,
                  *, packed, dim, noise):
        ber = state.ber[rx_base:rx_base + n_cores]
        copies = reduced[None].expand((n_cores,) + tuple(reduced.shape))
        p = ber.reshape((n_cores,) + (1,) * reduced.dim())
        if packed:
            return collectives.ota_noise_packed(generator, copies, p, mode=noise)
        return collectives.ota_noise(generator, copies, p)


CHANNELS: dict[str, Channel] = {}
_NOT_PORTED = {"symbol": "the physical symbol tier is not ported yet"}


def register_channel(channel: Channel, *, override: bool = False) -> Channel:
    """Register a `Channel` tier under ``channel.name`` for `get_channel`;
    re-registering a taken name raises unless ``override=True``."""
    name = getattr(channel, "name", None)
    if not isinstance(name, str) or not name or name == "?":
        raise ValueError(f"channel must define a non-empty .name, got {name!r}")
    if not callable(getattr(channel, "rx_copies", None)):
        raise TypeError(f"channel {name!r} does not implement rx_copies()")
    if name in CHANNELS and not override:
        raise ValueError(f"channel tier {name!r} already registered; pass "
                         "override=True to replace it")
    CHANNELS[name] = channel
    return channel


for _tier in (IdealChannel(), BSCChannel()):
    register_channel(_tier)
del _tier


def get_channel(name: str) -> Channel:
    if name in CHANNELS:
        return CHANNELS[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"channel {name!r}: {_NOT_PORTED[name]}")
    raise ValueError(f"unknown channel tier {name!r}; available: {sorted(CHANNELS)}")
