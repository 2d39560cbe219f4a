"""Pluggable PHY channel tiers of the OTA serve (counterpart of
`repro/phy/channel.py`).

The precharacterization travels as a `ChannelState` (a dataclass of tensors
where the reference has a pytree). Three tiers: ``ideal`` (error-free),
``bsc`` (per-core binary symmetric channel at the Eq. 1 BER, the paper's
abstraction) and ``symbol`` (the physics: each core looks its received
symbol up in the constellation by the TX bit combo, adds complex AWGN and
decides against its two decision-region centroids).

The symbol tier's wire is the combo index ``sum_m bit_m * 2^m`` per
dimension: the received field depends on the TX bits only through it, so
summing the per-TX contributions (one psum over the model axis in the
reference, a local sum on one GPU) and indexing the precomputed
constellation equals summing the complex fields.

Tiers are looked up through a registry, so a test or an out-of-tree tier can
``register_channel(..., override=True)`` without editing this module.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hypervector as hv, ota


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


RX_FIELDS = ("ber", "valid", "h", "symbols", "c0", "c1")   # the RX-leading leaves


def shard_state(state: ChannelState, rx_base: int, n_cores: int) -> ChannelState:
    """The state of cores [rx_base, rx_base + n_cores): the RX-leading
    leaves cut to those rows, ``phase_idx`` and ``n0`` whole (the
    counterpart of the reference's ``state_spec``, which shards the same
    leaves over the model axis)."""
    if rx_base < 0 or rx_base + n_cores > state.n_rx:
        raise ValueError(f"cores [{rx_base}, {rx_base + n_cores}) outside the state's "
                         f"{state.n_rx}")
    return dataclasses.replace(state, **{f: getattr(state, f)[rx_base:rx_base + n_cores]
                                         for f in RX_FIELDS})


def state_shape_structs(n_rx: int, m_tx: int, device="meta") -> ChannelState:
    """An empty `ChannelState` of ``n_rx`` cores and ``m_tx`` TXs on
    ``device`` (meta by default; fake under a FakeTensorMode): the shapes
    and dtypes of `state_from_ber` / `state_from_ota`, for the dry run's
    cells without the EM pipeline (the reference's ``state_shape_structs``)."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    return ChannelState(
        ber=empty((n_rx,), torch.float32), valid=empty((n_rx,), torch.bool),
        h=empty((n_rx, m_tx), torch.complex64), phase_idx=empty((m_tx, 2), torch.int32),
        symbols=empty((n_rx, 2 ** m_tx), torch.complex64),
        c0=empty((n_rx,), torch.complex64), c1=empty((n_rx,), torch.complex64),
        n0=empty((), torch.float32))


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

    ``wire`` names what the encoders reduce: ``"votes"`` (the bipolar
    majority votes; `rx_copies` gets the thresholded bundle ``reduced``
    [B, d] uint8, or [B, W] int32 words when ``packed``) or ``"combo"``
    (`rx_copies` gets the TX bit-combo index [B, d] int32 and decodes the
    physics). `rx_copies` returns every core's received copy
    [n_cores, B, d|W]. The state holds these cores (`shard_state` cuts a
    rank's from the whole): core i is its row i and RX ``rx_base + i`` of
    the whole link, the index a tier that replays noise by core uses. The tier
    draws its noise from ``generator``; ``noise`` and ``planes`` are the
    packed BSC's mask mode and bitplane precision.

    Across model ranks the serve also passes ``n_all``, the link's cores in
    all. The built-in tiers draw over the global rows [n_all, ...] (all
    ``n_cores`` rows when it is absent, as on one rank) on the rank's
    generator and keep rows [rx_base, rx_base + n_cores) (`_span`,
    `_draw_rows`): core g's noise is a function of (generator, g) alone,
    whatever the model split, as the reference's ``fold_in(key, g)`` is. The
    serve passes ``n_all`` only across ranks, so a tier that replays noise
    by core index (``rx_base + i``) and serves one rank need not take it."""

    name: str = "?"
    wire: str = "votes"

    def rx_copies(self, generator, reduced, state: ChannelState, rx_base, n_cores: int,
                  *, packed: bool, dim: int, noise: str, planes: int = 16,
                  n_all: int | None = None) -> torch.Tensor:
        raise NotImplementedError


def _span(rx_base: int, n_cores: int, n_all: int | None) -> tuple[int, int]:
    """(first row kept, rows drawn) of a draw over the link's cores: this
    rank's rows [rx_base, rx_base + n_cores) of ``n_all``, or all
    ``n_cores`` rows when the serve passes no ``n_all`` (one rank)."""
    return (0, n_cores) if n_all is None else (rx_base, n_all)


def _draw_rows(x: torch.Tensor, base: int, n: int, dim: int = 0) -> torch.Tensor:
    """Rows [base, base + n) along ``dim`` of a draw over the global cores
    (the draw itself on one rank); `phy.process.draw_rows`, kept here so
    that the channel does not import the process module."""
    return x if x.shape[dim] == n else x.narrow(dim, base, n)


class IdealChannel(Channel):
    """Error-free link: every core receives the exact majority bundle."""

    name = "ideal"
    wire = "votes"

    def rx_copies(self, generator, reduced, state, rx_base, n_cores,
                  *, packed, dim, noise, planes=16, n_all=None):
        return reduced[None].expand((n_cores,) + tuple(reduced.shape))


class BSCChannel(Channel):
    """Per-RX binary symmetric channel at the precharacterized BER (Eq. 1).

    All cores draw in one call: one [n_cores, B, d] uniform draw compared
    with ``state.ber[i]`` per core, the same draw in both
    representations (the packed tier packs it), so packed and unpacked
    serves agree on one generator. ``noise="bitplane"`` (packed only) draws
    the masks as words instead (`hv.bernoulli_words`, ``planes`` bits).
    With ``n_all`` the draw spans the global cores and the rank keeps its
    rows, so each core's copy equals the one-rank serve's."""

    name = "bsc"
    wire = "votes"

    def rx_copies(self, generator, reduced, state, rx_base, n_cores,
                  *, packed, dim, noise, planes=16, n_all=None):
        ber = state.ber[:n_cores]
        copies = reduced[None].expand((n_cores,) + tuple(reduced.shape))
        p = ber.reshape((n_cores,) + (1,) * reduced.dim())
        base, n_all = _span(rx_base, n_cores, n_all)
        rows = (n_all,) + tuple(reduced.shape)
        dev = reduced.device
        if packed and noise == "bitplane":
            words = _draw_rows(hv._random_words(generator, (planes,) + rows, dev),
                               base, n_cores, dim=1)
            return copies ^ hv.bernoulli_words(None, p, copies.shape, precision=planes,
                                               planes=words)
        if packed and noise != "exact":
            raise ValueError(f"unknown packed noise mode {noise!r}")
        if packed:
            rows = rows[:-1] + (dim,)
        flips = _draw_rows(torch.rand(rows, generator=generator, device=dev), base, n_cores) < p
        return copies ^ (hv.pack(flips.to(torch.uint8)) if packed else flips.to(copies.dtype))


class SymbolChannel(Channel):
    """Physical OTA: constellation superposition, AWGN, decision regions.

    ``reduced`` is the combo index [B, d] int32. Core i looks up its
    noiseless symbol ``symbols[i][combo]``, adds complex AWGN at
    ``n0`` and decides against its (c0, c1) (`ota.awgn_decide`): the
    reference's `ota.simulate_ota_bundle` over cores x batch x dimensions.
    It decodes bits and packs them when ``packed``: the same bits either way.

    Rows with ``valid=False`` carry no usable decision regions (a failed
    2-means fit, or a `state_from_ber` state with zero physics); they fall
    back to the analytic-BER abstraction, the exact majority with BSC flips
    at ``state.ber``, instead of decoding constant bits that would poison
    the vote. `draws` fixes the order on the one generator: the AWGN first,
    then the fallback flips, which are drawn whether or not a row is invalid
    (the reference skips them by a branch on ``all(valid)``; reading that on
    the host would cost a sync every call). So a valid row's bits do not
    depend on the fallback."""

    name = "symbol"
    wire = "combo"

    def draws(self, generator, state, rx_base, n_cores, shape, n_all=None):
        """One call's randomness: the AWGN's standard normals (real,
        imaginary) and the fallback's flip mask (bool), each
        [n_cores, *shape]; with ``n_all`` drawn over the global cores
        [n_all, *shape] in the same order and cut to this rank's rows. A
        test overrides this to replay JAX's draws."""
        base, n = _span(rx_base, n_cores, n_all)
        full = (n,) + tuple(shape)
        dev = state.symbols.device
        nr, ni = ota.awgn_draws(generator, full, dev)
        u = torch.rand(full, generator=generator, device=dev)
        nr, ni, u = (_draw_rows(x, base, n_cores) for x in (nr, ni, u))
        ber = state.ber[:n_cores].reshape((n_cores,) + (1,) * len(shape))
        return nr, ni, u < ber

    def rx_copies(self, generator, reduced, state, rx_base, n_cores,
                  *, packed, dim, noise, planes=16, n_all=None):
        rows = slice(0, n_cores)
        lead = (n_cores,) + (1,) * reduced.dim()
        extra = {} if n_all is None else {"n_all": n_all}
        nr, ni, flips = self.draws(generator, state, rx_base, n_cores, reduced.shape, **extra)
        combo = reduced.to(torch.int64)
        sym = state.symbols[rows][:, combo]                   # [n, B, d]
        bits = ota.awgn_decide(None, sym, state.c0[rows].reshape(lead),
                               state.c1[rows].reshape(lead), state.n0, noise=(nr, ni))
        exact = ota.majority_labels(state.m_tx, reduced.device)[combo]   # [B, d]
        fallback = exact[None] ^ flips.to(torch.uint8)
        bits = torch.where(state.valid[rows].reshape(lead), bits, fallback)
        return hv.pack(bits) if packed else bits


CHANNELS: dict[str, Channel] = {}


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


for _tier in (IdealChannel(), BSCChannel(), SymbolChannel()):
    register_channel(_tier)
del _tier


def get_channel(name: str) -> Channel:
    try:
        return CHANNELS[name]
    except KeyError:
        raise ValueError(f"unknown channel tier {name!r}; "
                         f"available: {sorted(CHANNELS)}") from None
