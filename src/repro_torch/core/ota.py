"""Over-the-air (OTA) majority computation — constellation engineering
(counterpart of `repro/core/ota.py`; see there for the mechanism).

M transmitters each send their bit as one of two phases of an 8-phase
codebook; receiver r sees y_r(b) = sum_m H[r, m] exp(j phi_m(b_m)) and
decodes the majority by the two-centroid decision regions. TX phases are
chosen jointly for all receivers to minimise the mean Eq. 1 BER,
0.5 erfc(0.5 d_c / sqrt(N0)). Float32/complex64 throughout, as the
reference; the exhaustive search scores every assignment in one batched
pass on the device and reads the winner back once.
"""
from __future__ import annotations

import dataclasses

import torch

N_PHASES = 8  # 45-degree discretization (Sec. IV)


# ---------------------------------------------------------------------------
# enumeration helpers
# ---------------------------------------------------------------------------

def bit_combos(m: int, device=None) -> torch.Tensor:
    """All 2^m TX bit combinations, [2^m, m] uint8 (LSB = TX 0)."""
    b = torch.arange(2 ** m, device=device)
    return ((b[:, None] >> torch.arange(m, device=device)) & 1).to(torch.uint8)


def majority_labels(m: int, device=None) -> torch.Tensor:
    """maj(b) for every bit combination, [2^m] uint8."""
    combos = bit_combos(m, device)
    return (2 * combos.to(torch.int32).sum(-1) > m).to(torch.uint8)


def phase_codebook(device=None) -> torch.Tensor:
    return 2.0 * torch.pi * torch.arange(N_PHASES, device=device, dtype=torch.float32) / N_PHASES


def ordered_phase_pairs(device=None) -> torch.Tensor:
    """All ordered pairs (i0, i1), i0 != i1, of codebook indices: [56, 2]."""
    i = torch.arange(N_PHASES, device=device)
    a, b = torch.meshgrid(i, i, indexing="ij")
    pairs = torch.stack([a.reshape(-1), b.reshape(-1)], dim=-1)
    return pairs[a.reshape(-1) != b.reshape(-1)]


# ---------------------------------------------------------------------------
# constellation synthesis + decision metrics
# ---------------------------------------------------------------------------

def rx_constellations(h: torch.Tensor, phase_idx: torch.Tensor) -> torch.Tensor:
    """Received superposition symbols per RX and bit combo.

    h: [N, M] complex64; phase_idx: [..., M, 2] codebook indices (bit 0/1).
    Returns y: [..., N, 2^M] complex64 (a leading batch of assignments gives
    a leading batch of constellations)."""
    m = h.shape[1]
    combos = bit_combos(m, h.device).bool()                       # [B, M]
    tx_phase = phase_codebook(h.device)[phase_idx]                # [..., M, 2]
    sel = torch.where(combos, tx_phase[..., None, :, 1], tx_phase[..., None, :, 0])
    tx_sym = torch.polar(torch.ones_like(sel), sel)               # [..., B, M]
    return torch.einsum("nm,...bm->...nb", h, tx_sym)


def majority_centroids(y: torch.Tensor, maj: torch.Tensor, mask: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Centroids (c0, c1) of the two majority decision regions: y [..., B]
    symbols, maj [B] labels -> [...] each. ``mask`` [B] bool restricts the
    fit to a sub-constellation (the combos that still occur when encoders
    are erased, `faults.recenter_state`); None, or all True, fits every
    combo."""
    m1 = maj.bool()
    m0 = ~m1
    if mask is not None:
        mask = mask.to(torch.bool)
        m0, m1 = m0 & mask, m1 & mask
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    c0 = torch.where(m0, y, zero).sum(-1) / m0.sum()
    c1 = torch.where(m1, y, zero).sum(-1) / m1.sum()
    return c0, c1


def per_symbol_ber(y, c0, c1, maj, n0) -> torch.Tensor:
    """Per-RX BER of nearest-centroid decoding `y` [..., B] against the given
    centroids: each symbol's Gaussian tail beyond its signed margin to the
    bisector of c0/c1, averaged over the 2^M combos."""
    axis = c1 - c0
    axis = axis / torch.clamp(axis.abs(), min=1e-12)
    mid = 0.5 * (c0 + c1)
    t = torch.real((y - mid[..., None]) * torch.conj(axis[..., None]))
    t_correct = torch.where(maj.bool(), t, -t)
    return (0.5 * torch.special.erfc(t_correct / n0 ** 0.5)).mean(-1)


def decision_metrics(y: torch.Tensor, maj: torch.Tensor, n0: float,
                     method: str = "centroid") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-RX BER and validity of the majority decision regions.

    y: [..., N, B] symbols; maj: [B]. A region set is valid when every symbol
    is strictly closer to its own centroid; invalid ones decode at chance
    (BER 0.5). "centroid" is Eq. 1 on the centroid distance, "symbol" the
    per-symbol refinement."""
    m1 = maj.bool()
    c0, c1 = majority_centroids(y, maj)
    d0 = (y - c0[..., None]).abs()
    d1 = (y - c1[..., None]).abs()
    own_closer = torch.where(m1, d1 < d0, d0 < d1)
    valid = own_closer.all(-1)
    if method == "centroid":
        ber = 0.5 * torch.special.erfc(0.5 * (c1 - c0).abs() / n0 ** 0.5)
    elif method == "symbol":
        ber = per_symbol_ber(y, c0, c1, maj, n0)
    else:
        raise ValueError(f"unknown method {method!r}")
    return torch.where(valid, ber, torch.full_like(ber, 0.5)), valid


# ---------------------------------------------------------------------------
# joint TX-phase optimization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OTAResult:
    phase_idx: torch.Tensor   # [M, 2] chosen codebook indices
    ber_per_rx: torch.Tensor  # [N]
    valid_per_rx: torch.Tensor
    symbols: torch.Tensor     # [N, 2^M] constellation of the winner
    n0: float

    @property
    def avg_ber(self) -> torch.Tensor:
        return self.ber_per_rx.mean()

    @property
    def max_ber(self) -> torch.Tensor:
        return self.ber_per_rx.max()


def _score_assignments(h, phase_idx_batch, maj, n0, method) -> torch.Tensor:
    """phase_idx_batch [A, M, 2] -> mean-over-RX BER [A], in one batch."""
    ber, _ = decision_metrics(rx_constellations(h, phase_idx_batch), maj, n0, method)
    return ber.mean(-1)


def _result(h, phase_idx, maj, n0, method) -> OTAResult:
    y = rx_constellations(h, phase_idx)
    ber, valid = decision_metrics(y, maj, n0, method)
    return OTAResult(phase_idx=phase_idx, ber_per_rx=ber, valid_per_rx=valid,
                     symbols=y, n0=n0)


def optimize_phases_exhaustive(h: torch.Tensor, n0: float,
                               method: str = "centroid") -> OTAResult:
    """Exhaustive gauge-reduced joint search (feasible for M <= 3).

    TX 0's bit-0 phase is pinned to index 0 (a global rotation leaves every
    distance unchanged), so M = 3 has 7 * 56 * 56 = 21,952 assignments,
    enumerated in the reference's mixed-radix order (TX 0 most significant)
    and scored in one batched pass; the first minimum wins, as in the
    reference's chunked scan."""
    m = h.shape[1]
    dev = h.device
    pairs = ordered_phase_pairs(dev)                                   # [56, 2]
    tx0 = torch.stack([torch.zeros(N_PHASES - 1, dtype=torch.int64, device=dev),
                       torch.arange(1, N_PHASES, device=dev)], -1)     # [7, 2]
    spaces = [tx0] + [pairs] * (m - 1)
    grids = torch.meshgrid(*[torch.arange(s.shape[0], device=dev) for s in spaces],
                           indexing="ij")
    batch = torch.stack([spaces[k][grids[k].reshape(-1)] for k in range(m)], 1)
    scores = _score_assignments(h, batch, majority_labels(m, dev), n0, method)
    phase_idx = batch[torch.argmin(scores)]
    return _result(h, phase_idx, majority_labels(m, dev), n0, method)


def optimize_phases_coordinate(h: torch.Tensor, n0: float, generator: torch.Generator,
                               sweeps: int = 4, method: str = "centroid") -> OTAResult:
    """Coordinate-descent joint search for any M (used for M > 3): one TX's
    phase pair at a time over its 56 candidates, the others held fixed."""
    m = h.shape[1]
    dev = h.device
    pairs = ordered_phase_pairs(dev)
    maj = majority_labels(m, dev)
    init = torch.randint(0, N_PHASES, (m, 2), generator=generator, device=dev)
    init[:, 1] = (init[:, 0] + 1 + init[:, 1] % (N_PHASES - 1)) % N_PHASES
    phase_idx = init
    for _ in range(sweeps):
        for tx in range(m):
            cand = phase_idx[None].repeat(pairs.shape[0], 1, 1)
            cand[:, tx] = pairs
            phase_idx = cand[torch.argmin(_score_assignments(h, cand, maj, n0, method))]
    return _result(h, phase_idx, maj, n0, method)


# ---------------------------------------------------------------------------
# end-to-end OTA transmission (empirical cross-check of Eq. 1)
# ---------------------------------------------------------------------------

def awgn_draws(generator: torch.Generator, shape, device=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The standard normals (real, imaginary) [*shape] f32 of one AWGN
    draw, real parts first, as `awgn_decide` scales them."""
    nr = torch.randn(tuple(shape), generator=generator, device=device)
    ni = torch.randn(tuple(shape), generator=generator, device=device)
    return nr, ni


def awgn_decide(generator: torch.Generator | None, sym: torch.Tensor, c0: torch.Tensor,
                c1: torch.Tensor, n0, noise: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """Physical receiver decode: complex AWGN, then the nearest of the two
    majority-region centroids.

    sym [...] complex64 noiseless received symbols; c0/c1 broadcast against
    it (`majority_centroids`); n0 the noise density. The noise has variance
    n0/2 per component (Eq. 1's error model): ``sqrt(n0/2) * (nr + j ni)``
    with (nr, ni) standard normals, ``noise`` if given (the tests replay
    JAX's), else `awgn_draws` from ``generator``. Note that
    ``torch.randn(dtype=complex64)`` has variance 1/2 per component, which is
    why the draw is two real tensors. Returns uint8 bits: 1 where the noisy
    symbol lies strictly closer to c1. The one decode definition shared by
    `simulate_ota_bundle`, the classifier's symbol trials, the serve's
    symbol tier and the process monitor."""
    nr, ni = noise if noise is not None else awgn_draws(generator, sym.shape, sym.device)
    scale = torch.sqrt(torch.as_tensor(n0, dtype=torch.float32, device=sym.device) / 2.0)
    r = sym + torch.complex(nr, ni) * scale
    return ((r - c1).abs() < (r - c0).abs()).to(torch.uint8)


def simulate_ota_bundle(generator: torch.Generator | None, queries: torch.Tensor,
                        h: torch.Tensor, phase_idx: torch.Tensor, n0,
                        noise: tuple[torch.Tensor, torch.Tensor] | None = None
                        ) -> torch.Tensor:
    """Physically simulate the OTA majority (the paper's Fig. 3b dataflow):
    per dimension, all M TXs send their bit at once and each RX adds AWGN
    and decodes by its decision regions. queries [M, d] uint8, h [N, M],
    phase_idx [M, 2] -> every receiver's decoded view of maj(queries)
    [N, d] uint8; ``noise`` as in `awgn_decide`, [N, d] each."""
    m = queries.shape[0]
    y = rx_constellations(h, phase_idx)                          # [N, 2^M]
    c0, c1 = majority_centroids(y, majority_labels(m, h.device))
    weights = 1 << torch.arange(m, device=queries.device)
    combo = (queries.to(torch.int64) * weights[:, None]).sum(0)  # [d]
    return awgn_decide(generator, y[:, combo], c0[:, None], c1[:, None], n0, noise)


def default_n0(h: torch.Tensor, snr_db: float = 7.0) -> float:
    """Noise density giving mean per-link SNR `snr_db` (the calibration knob;
    7 dB lands the 3 TX / 64 RX cavity at avg BER 0.010)."""
    p_rx = float((h.abs() ** 2).mean())
    return p_rx / (10.0 ** (snr_db / 10.0))
