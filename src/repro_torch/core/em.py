"""Parametric electromagnetic model of the in-package wireless channel
(counterpart of `repro/core/em.py`; see there for the physics).

The arithmetic follows the reference's float32/complex64 steps one for one,
so the channel matrix agrees with it to float32 rounding; sums still run in
another order, which near the cavity's resonant poles is worth ~1e-5
relative (the tests allow 1e-4).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import device as _device

C_MM_PER_S = 2.998e11  # speed of light in mm/s


@dataclasses.dataclass(frozen=True)
class PackageGeometry:
    """Fig. 5 parameters (mm); the same fields and defaults as the reference."""

    L1: float = 30.0
    L2: float = 29.7
    lid_height: float = 0.5
    tx_spacing: float = 3.75
    tx_edge_offset: float = 1.5
    freq_hz: float = 59.96e9
    path_loss_exp: float = 1.0
    wall_reflection: float = -0.7
    n_reflections: int = 1
    rx_keepout: float = 7.5
    cavity_q: float = 400.0
    model: str = "cavity"
    antinode_snap: bool = True

    @property
    def wavelength_mm(self) -> float:
        return C_MM_PER_S / self.freq_hz  # ~5 mm at 60 GHz


def tx_positions(geom: PackageGeometry, n_tx: int,
                 device: str | torch.device | None = "cuda") -> torch.Tensor:
    """TX antennas along the left edge, centered vertically, spacing s: [M, 2]."""
    dev = _device.resolve(device)
    y0 = geom.L2 / 2 - (n_tx - 1) * geom.tx_spacing / 2
    ys = y0 + geom.tx_spacing * torch.arange(n_tx, device=dev, dtype=torch.float32)
    xs = torch.full((n_tx,), geom.tx_edge_offset, device=dev, dtype=torch.float32)
    return torch.stack([xs, ys], dim=-1)


def rx_positions(geom: PackageGeometry, n_rx: int,
                 device: str | torch.device | None = "cuda") -> torch.Tensor:
    """RX antennas on a near-square grid right of the TXs: [N, 2]."""
    dev = _device.resolve(device)
    cols = int(math.ceil(math.sqrt(n_rx)))
    rows = int(math.ceil(n_rx / cols))
    x0 = geom.rx_keepout + 1.0
    xs = torch.linspace(x0, geom.L1 - 1.0, cols, device=dev, dtype=torch.float32)
    ys = torch.linspace(1.0, geom.L2 - 1.0, rows, device=dev, dtype=torch.float32)
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    if geom.antinode_snap:
        # distance from the nearest nodal line of the dominant (12,0) mode
        period = geom.L1 / 12.0
        d = torch.remainder(gx, period) - period / 2.0
        thr = 0.2
        nudge = torch.where(d.abs() < thr, torch.sign(d + 1e-9) * (thr - d.abs()),
                            torch.zeros_like(d))
        gx = gx + nudge
    pos = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    return pos[:n_rx]


def _ray_gain(dist: torch.Tensor, geom: PackageGeometry) -> torch.Tensor:
    """Complex gain of one ray: amplitude (lambda/4 pi d)^(gamma/2), phase
    -2 pi d/lambda."""
    lam = geom.wavelength_mm
    amp = (lam / (4.0 * math.pi * torch.clamp(dist, min=0.5))) ** (geom.path_loss_exp / 2.0)
    phase = -2.0 * math.pi * dist / lam
    return torch.polar(amp, phase)


def channel_matrix_cavity(geom: PackageGeometry, n_tx: int, n_rx: int,
                          device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Modal (Green's function) channel of the lidded package: [N, M]
    complex64, H[r, t] = sum_pq phi_pq(rx_r) phi_pq(tx_t) / (k_pq^2 -
    k0^2 (1 + j/Q))."""
    dev = _device.resolve(device)
    txp = tx_positions(geom, n_tx, dev)
    rxp = rx_positions(geom, n_rx, dev)
    lam = geom.wavelength_mm
    k0 = 2.0 * math.pi / lam
    p_max = int(2.0 * k0 * geom.L1 / math.pi) + 1
    q_max = int(2.0 * k0 * geom.L2 / math.pi) + 1
    kx = torch.arange(p_max + 1, device=dev, dtype=torch.float32) * math.pi / geom.L1
    ky = torch.arange(q_max + 1, device=dev, dtype=torch.float32) * math.pi / geom.L2
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2                      # [P, Q]
    pole = complex(k0 ** 2, k0 ** 2 / geom.cavity_q)              # k0^2 (1 + j/Q)
    denom = torch.complex(k2 - pole.real, torch.full_like(k2, -pole.imag))

    def phi(pos):  # [K, 2] -> [K, P, Q]
        cx = torch.cos(pos[:, 0:1] * kx[None, :])
        cy = torch.cos(pos[:, 1:2] * ky[None, :])
        return cx[:, :, None] * cy[:, None, :]

    phi_tx = phi(txp).to(torch.complex64)
    phi_rx = phi(rxp).to(torch.complex64)
    h = torch.einsum("npq,mpq->nm", phi_rx / denom[None], phi_tx)
    return (h / (k0 ** 2 * geom.L1 * geom.L2)).to(torch.complex64) * 1e3


def channel_matrix_ray(geom: PackageGeometry, n_tx: int, n_rx: int,
                       device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Ray/image-source channel (LOS + first-order wall images): [N, M]."""
    dev = _device.resolve(device)
    txp = tx_positions(geom, n_tx, dev)
    rxp = rx_positions(geom, n_rx, dev)
    diff = rxp[:, None, :] - txp[None, :, :]                      # [N, M, 2]
    g = _ray_gain(torch.linalg.norm(diff, dim=-1), geom)
    if geom.n_reflections >= 1:
        flip_x = torch.tensor([-1.0, 1.0], device=dev)
        flip_y = torch.tensor([1.0, -1.0], device=dev)
        images = torch.stack([                                    # [4, M, 2]
            flip_x * txp,                                               # x=0
            torch.tensor([2.0 * geom.L1, 0.0], device=dev) + flip_x * txp,  # x=L1
            flip_y * txp,                                               # y=0
            torch.tensor([0.0, 2.0 * geom.L2], device=dev) + flip_y * txp,  # y=L2
        ])
        d_img = torch.linalg.norm(rxp[:, None, None, :] - images[None], dim=-1)
        g = g + geom.wall_reflection * _ray_gain(d_img, geom).sum(1)
    return g.to(torch.complex64)


def channel_matrix(geom: PackageGeometry, n_tx: int, n_rx: int,
                   device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Dispatch on geom.model: "cavity" (default, resonant package) or "ray"."""
    if geom.model == "cavity":
        return channel_matrix_cavity(geom, n_tx, n_rx, device)
    return channel_matrix_ray(geom, n_tx, n_rx, device)


def snr_per_rx(h: torch.Tensor, n0) -> torch.Tensor:
    """Per-receiver mean link SNR in dB: mean over TXs of |H[r, t]|^2 / N0."""
    p = (h.abs() ** 2).mean(-1)
    return 10.0 * torch.log10(p / n0)


def analytic_ber_band(h: torch.Tensor, n0, ber: torch.Tensor, *, slack_db: float = 6.0,
                      fade_slack: float = 0.5, floor: float = 0.02,
                      cap: float = 0.5) -> torch.Tensor:
    """Per-RX acceptance ceiling [N] f32 for the empirical flip rate that
    the living-channel monitor (`repro_torch.phy.process`) estimates:

        hi[r] = min(max(ber[r] * 10^((slack_db + fade_slack * max(0,
                snr_mean - snr[r])) / 10), floor), cap)

    the characterized BER widened by a fixed slack plus headroom for
    receivers in deep fades (`snr_per_rx` below the mean), floored so
    near-error-free receivers do not trip on the shot noise of a short
    guard block, capped so noisy ones are re-fit before their flips poison
    the vote, and clipped to [0, 0.5]."""
    snr = snr_per_rx(h, n0)
    rel = torch.clamp(snr.mean() - snr, min=0.0)
    mult = 10.0 ** ((slack_db + fade_slack * rel) / 10.0)
    hi = torch.clamp(torch.clamp(ber * mult, min=floor), max=cap)
    return torch.clamp(hi, 0.0, 0.5).to(torch.float32)
