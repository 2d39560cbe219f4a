"""Plain reference of the multi-tenant OTA serve, in PyTorch operations only.

It imports nothing of the program under test. From the benchmark's inputs
(the tenants' packed codebooks, each request's encoder classes and the seed
of its noise generator) it works out every answer again:

1. the channel: the lidded package's modal channel matrix, the noise
   density at the configured SNR, the exhaustive joint TX-phase search and
   every core's Eq. 1 BER (a frozen copy of that float32 arithmetic, below);
2. the M-way strict majority of the request's M query hypervectors;
3. each core's binary symmetric channel at that core's BER, drawn on the
   request's own generator in the noise mode the configuration states:
   ``exact`` (one float32 uniform a bit, a flip where it lies below the
   BER) or ``bitplane`` (``planes`` fair 32-bit words a bit lane, read as a
   planes-bit uniform, a flip where it lies below round(BER * 2^planes));
4. each core's search of its own block of the tenant's classes, and the
   top-1 over every core: the highest similarity d - 2 * Hamming, ties to
   the lowest class.

The noise is the stream the configuration states: one draw of the stated
shape on a generator seeded with the request's seed, so the comparison with
the program is exact. ``lower=True`` computes the noise one precision below
the one stated (the control): bfloat16 for the exact float32 comparison,
half the bit planes for the bitplane comparator.

Similarities are dot products of +-1 vectors; every partial sum is an
integer of magnitude at most d, so float16 products with float32 or float16
accumulation are exact for d <= 2048 (float32 is used beyond, and on the
CPU).
"""
from __future__ import annotations

import math

import torch

WORD = 32
CORE_BLOCK = 64             # cores searched at once: a block's +-1 copies at scale take ~134 MB

# ---------------------------------------------------------------------------
# the channel: a frozen copy of the port's EM model and Eq. 1 (float32)
# ---------------------------------------------------------------------------

C_MM_PER_S = 2.998e11
# the package of the paper's Fig. 5 (mm, Hz), the port's default geometry
GEOMETRY = dict(L1=30.0, L2=29.7, tx_spacing=3.75, tx_edge_offset=1.5, freq_hz=59.96e9,
                rx_keepout=7.5, cavity_q=400.0)
N_PHASES = 8


def _tx_positions(n_tx: int, dev) -> torch.Tensor:
    g = GEOMETRY
    y0 = g["L2"] / 2 - (n_tx - 1) * g["tx_spacing"] / 2
    ys = y0 + g["tx_spacing"] * torch.arange(n_tx, device=dev, dtype=torch.float32)
    xs = torch.full((n_tx,), g["tx_edge_offset"], device=dev, dtype=torch.float32)
    return torch.stack([xs, ys], dim=-1)


def _rx_positions(n_rx: int, dev) -> torch.Tensor:
    g = GEOMETRY
    cols = int(math.ceil(math.sqrt(n_rx)))
    rows = int(math.ceil(n_rx / cols))
    xs = torch.linspace(g["rx_keepout"] + 1.0, g["L1"] - 1.0, cols, device=dev,
                        dtype=torch.float32)
    ys = torch.linspace(1.0, g["L2"] - 1.0, rows, device=dev, dtype=torch.float32)
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    # away from the nodal lines of the dominant (12, 0) mode
    period = g["L1"] / 12.0
    d = torch.remainder(gx, period) - period / 2.0
    thr = 0.2
    gx = gx + torch.where(d.abs() < thr, torch.sign(d + 1e-9) * (thr - d.abs()),
                          torch.zeros_like(d))
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)[:n_rx]


def channel_matrix(n_tx: int, n_rx: int, dev) -> torch.Tensor:
    """The cavity's modal channel [n_rx, n_tx] complex64."""
    g = GEOMETRY
    txp, rxp = _tx_positions(n_tx, dev), _rx_positions(n_rx, dev)
    lam = C_MM_PER_S / g["freq_hz"]
    k0 = 2.0 * math.pi / lam
    p_max = int(2.0 * k0 * g["L1"] / math.pi) + 1
    q_max = int(2.0 * k0 * g["L2"] / math.pi) + 1
    kx = torch.arange(p_max + 1, device=dev, dtype=torch.float32) * math.pi / g["L1"]
    ky = torch.arange(q_max + 1, device=dev, dtype=torch.float32) * math.pi / g["L2"]
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2
    pole = complex(k0 ** 2, k0 ** 2 / g["cavity_q"])
    denom = torch.complex(k2 - pole.real, torch.full_like(k2, -pole.imag))

    def phi(pos):
        cx = torch.cos(pos[:, 0:1] * kx[None, :])
        cy = torch.cos(pos[:, 1:2] * ky[None, :])
        return cx[:, :, None] * cy[:, None, :]

    h = torch.einsum("npq,mpq->nm", phi(rxp).to(torch.complex64) / denom[None],
                     phi(txp).to(torch.complex64))
    return (h / (k0 ** 2 * g["L1"] * g["L2"])).to(torch.complex64) * 1e3


def _combos(m: int, dev) -> torch.Tensor:
    b = torch.arange(2 ** m, device=dev)
    return ((b[:, None] >> torch.arange(m, device=dev)) & 1).to(torch.uint8)


def _majority_labels(m: int, dev) -> torch.Tensor:
    return (2 * _combos(m, dev).to(torch.int32).sum(-1) > m).to(torch.uint8)


def _constellations(h: torch.Tensor, phase_idx: torch.Tensor) -> torch.Tensor:
    """[..., M, 2] phase indices -> received symbols [..., N, 2^M]."""
    combos = _combos(h.shape[1], h.device).bool()
    phases = 2.0 * torch.pi * torch.arange(N_PHASES, device=h.device,
                                           dtype=torch.float32) / N_PHASES
    tx_phase = phases[phase_idx]
    sel = torch.where(combos, tx_phase[..., None, :, 1], tx_phase[..., None, :, 0])
    return torch.einsum("nm,...bm->...nb", h, torch.polar(torch.ones_like(sel), sel))


def _eq1_ber(y: torch.Tensor, maj: torch.Tensor, n0: float) -> torch.Tensor:
    """Eq. 1 on the two decision-region centroids, 0.5 where the regions do
    not separate every symbol."""
    m1 = maj.bool()
    m0 = ~m1
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    c0 = torch.where(m0, y, zero).sum(-1) / m0.sum()
    c1 = torch.where(m1, y, zero).sum(-1) / m1.sum()
    d0 = (y - c0[..., None]).abs()
    d1 = (y - c1[..., None]).abs()
    valid = torch.where(m1, d1 < d0, d0 < d1).all(-1)
    ber = 0.5 * torch.special.erfc(0.5 * (c1 - c0).abs() / n0 ** 0.5)
    return torch.where(valid, ber, torch.full_like(ber, 0.5))


def core_ber(m_tx: int, n_rx: int, snr_db: float, dev) -> torch.Tensor:
    """Every core's Eq. 1 BER [n_rx] float32 under the jointly optimised TX
    phases (exhaustive, TX 0's bit-0 phase pinned; the first minimum of the
    mean BER wins)."""
    if m_tx > 3:
        raise ValueError("the exhaustive phase search covers M <= 3")
    h = channel_matrix(m_tx, n_rx, dev)
    n0 = float((h.abs() ** 2).mean()) / (10.0 ** (snr_db / 10.0))
    i = torch.arange(N_PHASES, device=dev)
    a, b = torch.meshgrid(i, i, indexing="ij")
    pairs = torch.stack([a.reshape(-1), b.reshape(-1)], -1)[a.reshape(-1) != b.reshape(-1)]
    tx0 = torch.stack([torch.zeros(N_PHASES - 1, dtype=torch.int64, device=dev),
                       torch.arange(1, N_PHASES, device=dev)], -1)
    spaces = [tx0] + [pairs] * (m_tx - 1)
    grids = torch.meshgrid(*[torch.arange(s.shape[0], device=dev) for s in spaces],
                           indexing="ij")
    batch = torch.stack([spaces[k][grids[k].reshape(-1)] for k in range(m_tx)], 1)
    maj = _majority_labels(m_tx, dev)
    scores = _eq1_ber(_constellations(h, batch), maj, n0).mean(-1)
    best = batch[torch.argmin(scores)]
    return _eq1_ber(_constellations(h, best), maj, n0).to(torch.float32)


# ---------------------------------------------------------------------------
# the serve's semantics
# ---------------------------------------------------------------------------

def unpack(words: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 words [..., W] -> bits [..., dim] uint8; bit j of word w is
    dimension 32 * w + j."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> shifts) & 1).reshape(words.shape[:-1] + (dim,)).to(torch.uint8)


def bundle(q_bits: torch.Tensor) -> torch.Tensor:
    """Strict majority over the M encoders: [B, M, d] -> [B, d]."""
    m = q_bits.shape[-2]
    return (2 * q_bits.to(torch.int32).sum(-2) > m).to(torch.uint8)


def flips_exact(generator, ber: torch.Tensor, b: int, d: int, lower: bool) -> torch.Tensor:
    """The exact BSC's flips [cores, B, d] bool: one float32 uniform a bit,
    drawn as one [cores, B, d] tensor."""
    u = torch.rand((ber.shape[0], b, d), generator=generator, device=ber.device)
    p = ber[:, None, None]
    if lower:
        return u.to(torch.bfloat16) < p.to(torch.bfloat16)
    return u < p


def flips_bitplane(planes_words: torch.Tensor, ber: torch.Tensor, planes: int,
                   lower: bool) -> torch.Tensor:
    """The bitplane BSC's flips [cores, B, d] bool from the drawn plane words
    [planes, cores, B, W] of these cores: lane j of word w reads the uniform
    sum_i bit(plane_i) * 2^i; a flip where it lies below round(ber *
    2^planes). ``lower`` keeps the top half of the planes."""
    keep = planes // 2 if lower else planes
    t = torch.clamp(torch.round(ber * 2.0 ** keep), 0, 2 ** keep - 1).to(torch.int32)
    shifts = torch.arange(WORD, dtype=torch.int32, device=ber.device)
    u = None
    for i in range(planes - keep, planes):
        bit = (planes_words[i][..., None] >> shifts) & 1            # [cores, B, W, 32]
        term = bit << (i - (planes - keep))
        u = term if u is None else u + term
    c, b, w = planes_words.shape[1:]
    return u.reshape(c, b, w * WORD) < t[:, None, None]


def _similarities(copies: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """copies [n, B, d] bits, book [n, c, d] bits -> [n, B, c] int32 d - 2 *
    Hamming, by +-1 dot products."""
    d = copies.shape[-1]
    dt = torch.float16 if copies.is_cuda and d <= 2048 else torch.float32
    qa = 2 * copies.to(dt) - 1
    pa = 2 * book.to(dt) - 1
    return torch.bmm(qa, pa.transpose(1, 2)).round().to(torch.int32)


def top1(copies_fn, book_bits: torch.Tensor, n_cores: int, b: int, block: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The global top-1 of B trials over every core's block of classes.
    ``copies_fn(lo, hi)`` gives cores [lo, hi)'s noisy copies [hi-lo, B, d];
    book_bits [C, d]. Returns (class [B] int32, similarity [B] int32): the
    highest similarity, the lowest class among equals."""
    c, d = book_bits.shape
    c_core = c // n_cores
    best = None
    for lo in range(0, n_cores, block):
        hi = min(lo + block, n_cores)
        sims = _similarities(copies_fn(lo, hi),
                             book_bits[lo * c_core:hi * c_core].reshape(hi - lo, c_core, d))
        cls = (torch.arange(lo * c_core, hi * c_core, device=sims.device)
               .reshape(hi - lo, 1, c_core))
        # one key a (trial, class): similarity first, then the lower class
        key = (sims.to(torch.int64) + d) * c + (c - 1 - cls)
        k = key.amax(dim=(0, 2))
        best = k if best is None else torch.maximum(best, k)
    pred = (c - 1 - best % c).to(torch.int32)
    sim = (best // c - d).to(torch.int32)
    return pred, sim


class Reference:
    """The reference answers of one configuration's requests.

    ``cfg`` is the configuration file's dict; ``books`` the tenants' packed
    codebooks [T, C, W] int32 as the benchmark made them. ``answer`` takes
    one request (its tenant, its encoder classes [B, M] and its noise seed)
    and returns (pred [B] int32, maxsim [B] float32)."""

    def __init__(self, cfg: dict, books: torch.Tensor, lower: bool = False):
        self.cfg = cfg
        self.dev = books.device
        self.books = books
        self.lower = lower
        self.ber = core_ber(cfg["m_tx"], cfg["n_rx_cores"], cfg["snr_db"], self.dev)

    def answer(self, tenant: int, classes: torch.Tensor, noise_seed: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        d, n = cfg["dim"], cfg["n_rx_cores"]
        book = unpack(self.books[tenant], d)                        # [C, d]
        q = bundle(book[classes.to(self.dev).long()])               # [B, d]
        b = q.shape[0]
        g = torch.Generator(device=self.dev).manual_seed(noise_seed)
        if cfg["noise"] == "exact":
            flips = flips_exact(g, self.ber, b, d, self.lower)

            def copies(lo, hi):
                return q[None] ^ flips[lo:hi].to(torch.uint8)
        elif cfg["noise"] == "bitplane":
            planes = cfg["noise_planes"]
            words = torch.randint(-2 ** 31, 2 ** 31, (planes, n, b, d // WORD), generator=g,
                                  device=self.dev, dtype=torch.int32)

            def copies(lo, hi):
                f = flips_bitplane(words[:, lo:hi], self.ber[lo:hi], planes, self.lower)
                return q[None] ^ f.to(torch.uint8)
        else:
            raise ValueError(f"unknown noise mode {cfg['noise']!r}")
        pred, sim = top1(copies, book, n, b, CORE_BLOCK)
        return pred, sim.to(torch.float32) / (2.0 * d) + 0.5
