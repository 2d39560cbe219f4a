"""Scale-out of IMC-based HDC similarity search on one GPU (counterpart of
`repro/core/scaleout.py`, paper Fig. 3b).

The reference maps encoders and IMC cores onto a ``model`` mesh axis inside
``shard_map``. This port runs on one GPU, so that axis has size 1: every
encoder sits in column 0 (``e_per = m_tx``, ``tx = 0``), every core in the one
shard (``cores_per_shard = n_rx_cores``), and the OTA ``psum`` over the axis
(reference line 372) is the local sum over the encoder axis. ``vmap`` over
cores becomes a written-out leading core axis, which is also the bank axis of
the kernels: one launch searches every core.

Dataflow of `make_ota_serve`: encoders vote (sum of bipolar votes, strict
majority), every core receives its own copy through the PHY tier (``ideal``,
``bsc``, or ``symbol``, whose wire is the TX bit-combo index and whose cores
decode the constellation physics), each core searches its class sub-shard —
the fused packed top-1 kernel or the bipolar matmul kernel — and the global
top-1 is taken over the cores. ``m_active`` drops encoders: slots
``g >= m_active`` abstain (vote exactly 0). With a living-channel
``process`` the serve first steps the channel, then serves through the
evolved state and masks quarantined cores out of the top-1. With a fault
model (``faults=``, `repro_torch.faults`) it then steps the faults and
serves through them: erased encoders vote 0 (or radiate bit 0 on the combo
wire), dead cores' copies are zeroed, each bank searches the copy of its
``serve_rows`` core, ``rx_mask`` joins the quarantine, and stuck cells
force the stored (permuted) rows to their rail.
`make_wired_serve` is the wired baseline: bundle by majority at every core
(the majority kernel, or the bit-sliced packed majority), then one search
over all classes (the Hamming or bipolar matmul kernel).
`make_mt_ota_serve` serves N resident slots against a T-tenant store in one
call, each slot as its standalone serve would (the step of
`serving.hdc.HDCEngine`): one bundle over every slot's rows, the fan-out
slot by slot, one banked search over every (slot, core).

``representation="sparse"`` serves ultra-sparse queries as sorted int32
index lists (`core.sparse`) against the unchanged packed prototypes: the
OTA wire is the index-list all-gather (``collective="index_ag"``, the
slot-flattening reshape on one GPU) and a local sparse majority (the dense
``psum`` fallback gives the same lists); the per-core BSC is the O(k)
drop+insert channel, and the top-1 the gather-overlap ``sparse_topk_banked``
kernel.
``"auto"`` picks sparse or packed from the density crossover
(`resolve_representation`).

``coarse_group > 0`` turns each core's search into the two-level
coarse-to-fine screen: every block of ``coarse_group`` class rows collapses
to its strict-majority summary, the summaries are screened (the fused top-k
kernel packed, the bipolar matmul kernel and a tie-safe top-k unpacked), and
only the ``coarse_keep`` surviving groups' rows are rescored exactly, in
ascending class order, so the answer equals the flat scan's whenever the
flat winner survives the screen.

Randomness: an explicit `torch.Generator` replaces the reference's key, so
the BSC and AWGN noise is not the reference's bits; the tests hold the noisy
serve by replaying JAX-drawn draws through a registered tier (dense) or in
place of `sparse._noise_draws` (sparse).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import device as _device, phy
from repro_torch.core import em, hypervector as hv, ota, sparse
from repro_torch.distributed import collectives
from repro_torch.kernels.assoc_matmul import assoc_matmul, assoc_matmul_banked
from repro_torch.kernels.common import popcount32
from repro_torch.kernels.hamming import hamming_search, hamming_topk_banked
from repro_torch.kernels.majority import majority_bundle
from repro_torch.kernels.sparse import sparse_topk_banked


@dataclasses.dataclass(frozen=True)
class ScaleOutConfig:
    """The reference's configuration (same defaults — the paper's 6400
    classes over 64 cores, d = 512, M = 3, 7 dB, batch 256) minus
    ``use_kernels`` (the port dispatches on the tensors' device instead).
    Combinations the reference rejects raise ValueError here, as there; the
    multi-GPU collectives, not ported yet, raise NotImplementedError.

    ``channel`` is the PHY tier: ``"ideal"``, ``"bsc"`` (the default, the
    paper's Eq. 1 abstraction) or ``"symbol"`` (the physics; it needs a real
    ChannelState from `precharacterize_state` and ``collective="psum"``).
    ``noise`` is the packed BSC's mask source: ``"exact"`` packs the
    unpacked draw (packed == unpacked on one generator), ``"bitplane"``
    draws the mask words directly at ``noise_planes`` bits of precision (the
    BER quantized to 2^-noise_planes). ``m_active`` drops to the first
    m_active encoders (the others abstain; odd, in [1, m_tx], vote-wire
    tiers only; checked when a serve is built); shapes are unchanged, and a
    permuted serve's columns past m_active mean nothing.

    ``coarse_group`` > 0 switches on the coarse-to-fine screen (groups of
    that many class rows per summary; baseline bundling only, checked when a
    serve is built) and ``coarse_keep`` is its number of surviving groups
    per (core, query), clamped to the group count. ``k_max`` is the sparse
    index-list capacity (``sparse``/``auto`` only): at most k_max set indices
    per HV, results saturating to the k_max smallest."""

    n_classes: int = 6400
    dim: int = 512
    m_tx: int = 3
    n_rx_cores: int = 64
    snr_db: float = 7.0
    permuted: bool = False
    batch: int = 256
    collective: str = "psum"
    representation: str = "unpacked"
    noise: str = "exact"
    noise_planes: int = 16
    channel: str = "bsc"
    coarse_group: int = 0
    coarse_keep: int = 8
    k_max: int = 0
    m_active: int | None = None

    @property
    def packed(self) -> bool:
        return self.representation == "packed"

    @property
    def sparse(self) -> bool:
        return self.representation == "sparse"

    @property
    def m_act(self) -> int:
        return self.m_tx if self.m_active is None else self.m_active

    @property
    def words(self) -> int:
        return self.dim // hv.WORD

    def __post_init__(self):
        if self.representation not in ("unpacked", "packed", "sparse", "auto"):
            raise ValueError(f"unknown representation {self.representation!r}")
        if self.representation in ("sparse", "auto"):
            rejected = [
                (self.k_max <= 0, f"needs k_max > 0 (the sparse index-list "
                 f"capacity); got k_max={self.k_max}"),
                (self.permuted, "requires baseline bundling (permuted TX "
                 "signatures would need per-bank sparse searches)"),
                (bool(self.coarse_group), "does not compose with the "
                 "coarse-to-fine screen (group summaries are dense bundles)"),
                (self.collective not in ("index_ag", "psum", "psum_packed"),
                 f"has no wire format for collective={self.collective!r}; use "
                 "'index_ag' or the dense fallbacks 'psum'/'psum_packed'"),
                (self.channel not in ("ideal", "bsc"), f"has no channel="
                 f"{self.channel!r} tier (the symbol tier decodes dense fields)"),
            ]
            for bad, what in rejected:
                if bad:
                    raise ValueError(f"representation={self.representation!r} {what}")
        elif self.collective == "index_ag":
            raise ValueError(
                "collective='index_ag' is the sparse index-list wire; "
                f"representation={self.representation!r} has no index lists")
        if self.collective not in ("psum", "index_ag"):
            raise NotImplementedError(
                f"ScaleOutConfig: collective={self.collective!r} is not ported yet (only "
                "'psum' and the sparse 'index_ag' are; the one-GPU model axis has no "
                "wire to pack)")
        if self.dim % hv.WORD:
            raise ValueError(f"dim={self.dim} must be a multiple of {hv.WORD}")
        if self.n_classes % self.n_rx_cores:
            raise ValueError(f"n_classes={self.n_classes} must divide evenly over "
                             f"n_rx_cores={self.n_rx_cores}")


# ---------------------------------------------------------------------------
# density crossover (representation="auto")
# ---------------------------------------------------------------------------

# Sparse wins below this query density (k_max / dim): the wire-parity point,
# where k_max int32 indices cost as much as d/32 packed words.
DEFAULT_CROSSOVER = {"density": 1.0 / 32.0}


def resolve_representation(cfg: ScaleOutConfig) -> ScaleOutConfig:
    """Materialize ``representation="auto"``: "sparse" with the
    ``index_ag`` wire when ``k_max / dim`` lies below the crossover density,
    else "packed". The reference gives packed its ``psum_packed`` wire; on one
    GPU the vote is a local sum either way, so the port gives it ``psum``.
    Other configs pass through untouched."""
    if cfg.representation != "auto":
        return cfg
    if cfg.k_max / cfg.dim < DEFAULT_CROSSOVER["density"]:
        return dataclasses.replace(cfg, representation="sparse", collective="index_ag")
    return dataclasses.replace(cfg, representation="packed", collective="psum")


def precharacterize_state(cfg: ScaleOutConfig, geom: em.PackageGeometry | None = None,
                          device: str | torch.device | None = "cuda") -> phy.ChannelState:
    """Channel precharacterization -> `phy.ChannelState` (the paper's offline
    CST + MATLAB step): channel matrix, noise density at ``cfg.snr_db``, the
    joint phase search (exhaustive for M <= 3) and its Eq. 1 per-core BER."""
    dev = _device.resolve(device)
    geom = geom or em.PackageGeometry()
    h = em.channel_matrix(geom, cfg.m_tx, cfg.n_rx_cores, dev)
    n0 = ota.default_n0(h, cfg.snr_db)
    if cfg.m_tx <= 3:
        res = ota.optimize_phases_exhaustive(h, n0)
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        res = ota.optimize_phases_coordinate(h, n0, g)
    return phy.state_from_ota(res, h)


def precharacterize(cfg: ScaleOutConfig, device: str | torch.device | None = "cuda"
                    ) -> torch.Tensor:
    """Per-core Eq. 1 BER [n_rx_cores], the summary of `precharacterize_state`."""
    return precharacterize_state(cfg, device=device).ber


# ---------------------------------------------------------------------------
# serve-step stages (one model shard: tx = 0, every core local)
# ---------------------------------------------------------------------------

def _ota_bundle(cfg: ScaleOutConfig, chan: phy.Channel, q_mine: torch.Tensor,
                fstate=None) -> torch.Tensor:
    """The OTA collective over the encoders: q_mine [B, M, d|W] -> bundled
    query [B, d|W], or the combo index [B, d] int32 on the combo wire.

    Vote wire: each active encoder votes +-1 per dimension and the
    abstaining slots ``g >= m_act`` vote exactly 0; the sum over the encoder
    axis is the reference's ``psum`` over the model axis, and ``tally > 0``
    is the strict majority (even-M ties -> 0). Combo wire: the sum of
    ``bit_g * 2^g`` over the encoders, the received field's index into the
    constellation.

    ``fstate`` (a `faults.FaultState`) erases the slots of ``dead_tx |
    vote_drop``: on the vote wire an erased slot votes exactly 0, so
    ``tally > 0`` is the majority of the live voters (even live counts tie
    to 0); on the combo wire an erased encoder is a stuck carrier, its bit
    forced 0 (`faults.recenter_state` re-fits the decoder)."""
    q_bits = hv.unpack(q_mine, cfg.dim) if cfg.packed else q_mine
    if fstate is not None:
        erased = (fstate.dead_tx | fstate.vote_drop)[:, None]              # [M, 1]
        if chan.wire == "combo":
            q_bits = torch.where(erased, 0, q_bits)
        else:
            slot = torch.arange(cfg.m_tx, device=erased.device)[:, None]
            live = (slot < cfg.m_act) & ~erased
    if chan.wire == "combo":
        return phy.combo_index(q_bits, axis=-2)
    votes = 2 * q_bits.to(torch.int8) - 1
    votes = votes[..., :cfg.m_act, :] if fstate is None else torch.where(live, votes, 0)
    bundled = (votes.sum(-2, dtype=torch.int8) > 0).to(torch.uint8)
    return hv.pack(bundled) if cfg.packed else bundled


def _rx_fanout(cfg: ScaleOutConfig, chan: phy.Channel, q_bundled: torch.Tensor,
               state: phy.ChannelState, generator) -> torch.Tensor:
    """Per-core decode through the PHY tier: [n_cores, B, d|W]."""
    return chan.rx_copies(generator, q_bundled, state, rx_base=0,
                          n_cores=cfg.n_rx_cores, packed=cfg.packed, dim=cfg.dim,
                          noise=cfg.noise, planes=cfg.noise_planes)


def _sparse_bundle(cfg: ScaleOutConfig, queries: torch.Tensor) -> torch.Tensor:
    """The OTA vote on sparse index lists: queries [B, 1, M, k_max] ->
    bundled [B, k_max], the sparse strict majority over the gathered lists.
    Abstaining slots (``g >= m_act``) are emptied to all-SENTINEL, a dense
    all-zero vote, and the threshold runs at m_act. The reference's ``psum``
    fallback densifies, votes and re-sparsifies, which gives the same lists;
    it differs only on a multi-GPU wire, so on one GPU both collectives take
    this path."""
    stack = collectives.sparse_index_allgather(queries)       # [B, M, k_max]
    active = torch.arange(stack.shape[-2], device=stack.device)[:, None] < cfg.m_act
    stack = torch.where(active, stack, sparse.SENTINEL)
    return sparse.bundle(stack, m=cfg.m_act)


def _sparse_rx_fanout(cfg: ScaleOutConfig, q_bundled: torch.Tensor,
                      state: phy.ChannelState, generator) -> torch.Tensor:
    """Per-core sparse decode: [n_cores, B, k_max]. ``ideal`` broadcasts the
    bundle; ``bsc`` runs the drop+insert channel at each core's BER, every
    core's draws in one call."""
    n = cfg.n_rx_cores
    copies = q_bundled[None].expand((n,) + tuple(q_bundled.shape))
    if cfg.channel == "ideal":
        return copies
    ber = state.ber[:n].reshape(n, 1, 1)
    return sparse.flip_bits_sparse(generator, copies, ber, cfg.dim)


def _apply_stuck(rows: torch.Tensor, stuck, d: int, packed: bool) -> torch.Tensor:
    """Force stuck stored bits to their rail, per physical core: rows
    [T, n_core, ..., W|d] (the core axis second), stuck = (stuck0, stuck1)
    [n_core, W] int32 column masks, unpacked little-endian for bit rows. A
    stuck column hits every row its core stores, permuted banks included,
    so callers apply this after permuting. Zero masks change no bit."""
    if stuck is None:
        return rows
    s0, s1 = stuck if packed else hv.unpack(torch.stack(stuck), d)
    shape = (1, s0.shape[0]) + (1,) * (rows.dim() - 3) + (s0.shape[-1],)
    return (rows & ~s0.reshape(shape)) | s1.reshape(shape)


def _apply_rx_faults(fstate, q_rx: torch.Tensor, qmask: torch.Tensor | None):
    """Dead-core zeroing, the failover gather and the bank mask: q_rx
    [N, n_core, B, d|W]. A dead core's copy is zeroed, then bank i's query
    is core ``serve_rows[i]``'s copy (identity: no remap), and ``rx_mask``
    joins the quarantine mask so banks with no healthy server never win.
    The healthy state changes no value."""
    dead = fstate.dead_rx[None, :, None, None]
    q_rx = torch.where(dead, 0, q_rx).index_select(1, fstate.serve_rows)
    return q_rx, fstate.rx_mask if qmask is None else qmask | fstate.rx_mask


def _group_summaries(cfg: ScaleOutConfig, banks: torch.Tensor) -> torch.Tensor:
    """Per-bank coarse summaries: banks [T, C_core, d|W] -> [T, n_grp, d|W],
    each contiguous block of ``coarse_group`` rows collapsed to its strict
    majority (even group sizes tie to 0), recomputed from the resident rows
    on every call."""
    gs = cfg.coarse_group
    t, c_core, last = banks.shape
    members = banks.reshape(t, c_core // gs, gs, last).movedim(2, 0)  # [gs, T, n_grp, -]
    return hv.majority_packed(members) if cfg.packed else hv.majority(members)


def _survivor_rows(cfg: ScaleOutConfig, gidx: torch.Tensor) -> torch.Tensor:
    """Surviving groups [G, B, keep] -> their class rows [G, B, keep*gs] in
    ascending order."""
    gs = cfg.coarse_group
    g, b, keep = gidx.shape
    gidx = torch.sort(gidx, dim=-1).values
    rows = gidx[..., None] * gs + torch.arange(gs, dtype=torch.int32, device=gidx.device)
    return rows.reshape(g, b, keep * gs)


def _candidates(banks: torch.Tensor, rows: torch.Tensor,
                bank_rows: torch.Tensor | None) -> torch.Tensor:
    """Gather every (bank, query)'s survivor rows: [G, B, R, d|W], read
    straight from the bank table when ``bank_rows`` names its rows."""
    g = rows.shape[0]
    bidx = (torch.arange(g, device=rows.device) if bank_rows is None
            else bank_rows.to(torch.int64))
    return banks[bidx[:, None, None], rows.to(torch.int64)]


def _coarse_fine_packed(cfg: ScaleOutConfig, banks: torch.Tensor, q: torch.Tensor,
                        bank_rows: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level packed search: the top-keep screen over the group summaries
    (one fused top-k launch), then an exact rescore of only the surviving
    rows. banks [T, C_core, W] (T == G without ``bank_rows``), q [G, B, W]
    -> (dist, row) of each bank's winner, both [G, B] int32.

    The rescore minimizes the one int32 key ``dist*c_core + row`` over rows
    in ascending order, so ties go to the lowest class row as in the flat
    scan (`_validate_coarse` keeps the key inside int32)."""
    c_core = banks.shape[1]
    keep = min(cfg.coarse_keep, c_core // cfg.coarse_group)
    summ = _group_summaries(cfg, banks)                       # [T, n_grp, W]
    _, gidx = hamming_topk_banked(q.contiguous(), summ, k=keep, bank_rows=bank_rows)
    rows = _survivor_rows(cfg, gidx)                          # [G, B, keep*gs]
    cand = _candidates(banks, rows, bank_rows)                # [G, B, keep*gs, W]
    dist = popcount32(q[:, :, None, :] ^ cand).sum(-1, dtype=torch.int32)
    key = (dist * c_core + rows).min(-1).values               # one-key first minimum
    return key // c_core, key % c_core


def _screen_topk(csims: torch.Tensor, keep: int) -> torch.Tensor:
    """The ``keep`` best groups [G, B, keep] of the summary similarities
    csims [G, B, n_grp] (integer-valued f32), ties to the lower group, the
    order of `jax.lax.top_k`: selected on the unique integer key
    ``sim*n_grp + (n_grp-1-group)``, since `torch.topk` orders equal values
    arbitrarily."""
    n_grp = csims.shape[-1]
    col = torch.arange(n_grp, device=csims.device)
    key = csims.to(torch.int64) * n_grp + (n_grp - 1 - col)
    return torch.topk(key, keep, dim=-1).indices.to(torch.int32)


def _coarse_fine_unpacked(cfg: ScaleOutConfig, banks: torch.Tensor, q: torch.Tensor,
                          bank_rows: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpacked coarse-to-fine: the screen through the summaries' bipolar
    dots (the matmul kernel, one launch), then the surviving rows rescored.
    banks [T, C_core, d] uint8, q [G, B, d] -> (val f32, row int32) of each
    bank's winner, both [G, B].

    The reference rescores with an f32 bipolar einsum over the gathered rows;
    its values are the integers d - 2*hamming, computed here from the XOR of
    the gathered bits (no f32 copies of the [G, B, keep*gs, d] candidates),
    so the (max, first argmax) over rows in ascending order is the same."""
    d = banks.shape[-1]
    keep = min(cfg.coarse_keep, banks.shape[1] // cfg.coarse_group)
    summ = _group_summaries(cfg, banks)                       # [T, n_grp, d]
    summ_g = summ if bank_rows is None else summ.index_select(0, bank_rows)
    csims = assoc_matmul_banked(q.contiguous(), summ_g.contiguous())  # [G, B, n_grp]
    rows = _survivor_rows(cfg, _screen_topk(csims, keep))
    cand = _candidates(banks, rows, bank_rows)                # [G, B, keep*gs, d]
    sims = d - 2 * (q[:, :, None, :] ^ cand).sum(-1, dtype=torch.int32)
    star = torch.argmax(sims, -1)                             # first max among survivors
    row = torch.gather(rows, -1, star[..., None])[..., 0]
    return sims.max(-1).values.to(torch.float32), row


def _shard_top1(cfg: ScaleOutConfig, q_rx: torch.Tensor, store: torch.Tensor,
                rows: torch.Tensor | None = None, qmask: torch.Tensor | None = None,
                stuck=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Every core of every slot searches its class sub-shard (with the M
    permuted banks when ``cfg.permuted``), in one kernel launch for every
    (slot, core[, permuted bank]). q_rx [N, n_core, B, d|W|k_max]; store
    [T, C, d|W]: slot s searches tenant bank ``rows[s]`` (int32 [N]) through
    the kernels' ``bank_rows`` indirection (packed, coarse) or a gather of
    those rows (unpacked), or, with ``rows=None``, bank s itself (T == N: no
    indirection and no gather; the standalone serve is N = 1). Returns (val,
    idx): the winner's similarity (d - 2*dist, int32 packed / f32 unpacked)
    and global class index, [N, B] or [N, B, M]. Ties go to the lowest
    class: first minimum inside a core, then the first core, per slot.
    ``qmask`` [n_core] bool quarantines cores after the kernel (every slot
    rides the one link): their winner's distance becomes d + 1 (packed) or
    its similarity -2d (unpacked), so they never win. ``stuck`` (stuck0,
    stuck1) [n_core, W] forces the stored bits of each core to their rail
    (`_apply_stuck`), on the whole T-tenant store after the permutation and
    before any kernel or coarse summary reads it."""
    n, n_core, b, q_last = q_rx.shape
    t, c, last = store.shape
    d = cfg.dim
    c_core = c // n_core
    store_c = store.reshape(t, n_core, c_core, last)
    core_rows = None
    if rows is not None:
        core_ids = torch.arange(n_core, dtype=rows.dtype, device=rows.device)
        core_rows = (rows[:, None] * n_core + core_ids).reshape(-1)       # [N*n_core]
    if cfg.permuted:
        m = cfg.m_tx
        rho = hv.permute_packed if cfg.packed else hv.permute
        # permute the T-tenant store once a call, not once a slot
        banks = torch.stack([rho(store_c, s) for s in range(m)], 2)    # [T, n_core, M, c, -]
        banks = _apply_stuck(banks, stuck, d, cfg.packed)
        q_rep = q_rx[:, :, None].expand(n, n_core, m, b, last).reshape(n * n_core * m, b, last)
        if cfg.packed:
            bank_rows = None if core_rows is None else (
                core_rows[:, None] * m
                + torch.arange(m, dtype=rows.dtype, device=rows.device)).reshape(-1)
            dmin, amin = hamming_topk_banked(
                q_rep, banks.reshape(t * n_core * m, c_core, last), bank_rows=bank_rows)
            dmin = dmin.reshape(n, n_core, m, b).permute(0, 3, 1, 2)   # [N, B, n_core, M]
            amin = amin.reshape(n, n_core, m, b).permute(0, 3, 1, 2)
            if qmask is not None:
                dmin = torch.where(qmask[None, None, :, None], d + 1, dmin)
            val = d - 2 * dmin.min(2).values                           # [N, B, M]
            core_star = torch.argmin(dmin, 2)
            idx_in_core = torch.gather(amin, 2, core_star[:, :, None, :])[:, :, 0, :]
        else:
            if rows is not None:
                banks = banks.index_select(0, rows)                    # [N, n_core, M, c, d]
            sims = assoc_matmul_banked(q_rep, banks.reshape(n * n_core * m, c_core, last))
            sims = sims.reshape(n, n_core, m, b, c_core).permute(0, 3, 1, 2, 4)
            val_c = sims.max(-1).values                                # [N, B, n_core, M]
            idx_c = torch.argmax(sims, -1).to(torch.int32)
            if qmask is not None:
                val_c = torch.where(qmask[None, None, :, None], -2.0 * d, val_c)
            val = val_c.max(2).values                                  # [N, B, M]
            core_star = torch.argmax(val_c, 2)
            idx_in_core = torch.gather(idx_c, 2, core_star[:, :, None, :])[:, :, 0, :]
    elif cfg.packed or cfg.sparse:
        table = _apply_stuck(store_c, stuck, d, True).reshape(t * n_core, c_core, last)
        q_flat = q_rx.reshape(n * n_core, b, q_last).contiguous()
        if cfg.coarse_group:
            dmin, amin = _coarse_fine_packed(cfg, table, q_flat, bank_rows=core_rows)
        elif cfg.sparse:                  # the multi-tenant serve refuses sparse: rows is None
            dmin, amin = sparse_topk_banked(q_flat, table)
        else:
            dmin, amin = hamming_topk_banked(q_flat, table, bank_rows=core_rows)
        dmin = dmin.reshape(n, n_core, b).transpose(1, 2)              # [N, B, n_core]
        amin = amin.reshape(n, n_core, b).transpose(1, 2)
        if qmask is not None:
            dmin = torch.where(qmask[None, None, :], d + 1, dmin)
        val = d - 2 * dmin.min(-1).values                              # [N, B]
        core_star = torch.argmin(dmin, -1)
        idx_in_core = torch.gather(amin, 2, core_star[..., None])[..., 0]
    else:
        store_c = _apply_stuck(store_c, stuck, d, False)
        q_flat = q_rx.reshape(n * n_core, b, last).contiguous()
        if cfg.coarse_group:
            vg, rg = _coarse_fine_unpacked(cfg, store_c.reshape(t * n_core, c_core, last),
                                           q_flat, bank_rows=core_rows)
            val_c = vg.reshape(n, n_core, b).transpose(1, 2)           # [N, B, n_core]
            idx_c = rg.reshape(n, n_core, b).transpose(1, 2)
        else:
            banks = store_c if rows is None else store_c.index_select(0, rows)
            sims = assoc_matmul_banked(q_flat, banks.reshape(n * n_core, c_core, last))
            sims = sims.reshape(n, n_core, b, c_core).transpose(1, 2)  # [N, B, n_core, c]
            val_c = sims.max(-1).values
            idx_c = torch.argmax(sims, -1).to(torch.int32)
        if qmask is not None:
            val_c = torch.where(qmask[None, None, :], -2.0 * d, val_c)
        val = val_c.max(-1).values                                     # [N, B]
        core_star = torch.argmax(val_c, -1)
        idx_in_core = torch.gather(idx_c, 2, core_star[..., None])[..., 0]
    idx = (core_star * c_core + idx_in_core).to(torch.int32)
    return val, idx


def _gather_top1(cfg: ScaleOutConfig, val: torch.Tensor, idx: torch.Tensor):
    """Global top-1 over the model shards — here the one shard — and the
    similarity normalized to [0, 1]."""
    return idx, val / (2.0 * cfg.dim) + 0.5


def _validate_channel(cfg: ScaleOutConfig, chan: phy.Channel) -> None:
    """Serve-build validation of the combo wire and the M-drop (ValueError),
    with the reference's messages."""
    if chan.wire == "combo":
        if cfg.collective != "psum":
            raise ValueError(
                f"channel={cfg.channel!r} replaces the vote reduction with the "
                f"combo-index psum; collective={cfg.collective!r} does not "
                "apply (use collective='psum')")
        if cfg.m_tx > 16:
            raise ValueError(f"channel={cfg.channel!r}: the constellation table is "
                             f"[N, 2^M]; m_tx={cfg.m_tx} > 16")
    if cfg.m_act != cfg.m_tx:
        if chan.wire == "combo":
            raise ValueError(
                f"m_active={cfg.m_act} needs a vote-wire tier; "
                f"channel={cfg.channel!r} transmits the full {cfg.m_tx}-TX "
                "combo field (its constellation assumes every TX superposes)")
        if not 1 <= cfg.m_act <= cfg.m_tx:
            raise ValueError(f"m_active={cfg.m_act} outside [1, {cfg.m_tx}]")
        if cfg.m_act % 2 == 0:
            raise ValueError(f"m_active={cfg.m_act} must be odd (majority votes tie)")


def _validate_coarse(cfg: ScaleOutConfig) -> None:
    """Serve-build validation of the coarse-to-fine screen (ValueError)."""
    if not cfg.coarse_group:
        return
    if cfg.permuted:
        raise ValueError("coarse_group requires baseline bundling (permuted banks would "
                         "need one summary set per TX signature)")
    c_core = cfg.n_classes // cfg.n_rx_cores      # divides: ScaleOutConfig checks
    if cfg.coarse_group < 2 or c_core % cfg.coarse_group:
        raise ValueError(f"coarse_group={cfg.coarse_group} must be >= 2 and divide the "
                         f"per-core class count {c_core}")
    if cfg.coarse_keep < 1:
        raise ValueError(f"coarse_keep={cfg.coarse_keep} must be >= 1")
    if (cfg.dim + 1) * c_core >= 2**31:
        raise ValueError(f"rescore key (dim+1)*c_core = {(cfg.dim + 1) * c_core} would "
                         "overflow int32 — shard wider (more RX cores) or shrink dim")


def _check_inputs(cfg: ScaleOutConfig, dev: torch.device, protos, queries, state,
                  fstate=None) -> None:
    _device.check_on(dev, protos=protos, queries=queries, ber=state.ber)
    want = torch.int32 if cfg.packed or cfg.sparse else torch.uint8
    last = cfg.words if cfg.packed or cfg.sparse else cfg.dim
    q_last = cfg.k_max if cfg.sparse else last
    if protos.dtype != want or queries.dtype != want:
        raise TypeError(f"{cfg.representation} serve takes {want} protos and queries")
    if tuple(protos.shape) != (cfg.n_classes, last):
        raise ValueError(f"protos {tuple(protos.shape)} != {(cfg.n_classes, last)}")
    if queries.dim() != 4 or queries.shape[1] != 1 or queries.shape[2:] != (cfg.m_tx, q_last):
        raise ValueError(f"queries {tuple(queries.shape)} != [B, 1, {cfg.m_tx}, {q_last}] "
                         "(one model shard)")
    if state.n_rx != cfg.n_rx_cores:
        raise ValueError(f"state has {state.n_rx} cores, cfg {cfg.n_rx_cores}")
    if state.m_tx != cfg.m_tx:
        raise ValueError(f"state characterizes {state.m_tx} TXs, cfg {cfg.m_tx}")
    if fstate is not None:
        _device.check_on(dev, dead_rx=fstate.dead_rx, stuck0=fstate.stuck0)
        got = (fstate.n_rx, fstate.m_slots, fstate.words)
        if got != (cfg.n_rx_cores, cfg.m_tx, cfg.words):
            raise ValueError(f"fault state (n_rx, m_slots, words) {got} != "
                             f"{(cfg.n_rx_cores, cfg.m_tx, cfg.words)} (faults.healthy_for)")


def make_ota_serve(cfg: ScaleOutConfig, device: str | torch.device | None = "cuda",
                   process=None, faults=None) -> Callable[..., tuple[torch.Tensor, ...]]:
    """Build the OTA serve step.

    fn(protos [C, d|W], queries [B, 1, M, d|W], state phy.ChannelState,
       generator) -> (pred, maxsim); pred int32 [B] (baseline) or [B, M]
    (permuted), maxsim f32 in [0, 1].

    Unpacked tensors are uint8 {0,1}; packed ones int32 words (``hv.pack``).
    Encoder g transmits rho^g of its query when ``cfg.permuted``; encoders
    ``g >= cfg.m_active`` abstain. The PHY tier is ``cfg.channel``
    (``ideal``, ``bsc`` or ``symbol``; the noise comes from ``generator``);
    ``symbol`` needs a real state (`precharacterize_state`), replaces the
    vote by the combo index and decodes the physics at every core, bits
    packed afterwards when the serve is packed. The per-core search is the
    fused top-1 kernel (packed) or the bipolar matmul kernel (unpacked), one
    launch for all cores and banks; with ``cfg.coarse_group`` it is the
    coarse-to-fine screen (the fused top-k kernel or the matmul kernel over
    the group summaries, then an exact rescore of the survivors).
    ``coarse_group`` with permuted bundling, shapes the screen cannot tile,
    the symbol tier with another collective or with ``m_active``, and an
    even or out-of-range ``m_active`` raise ValueError here.

    ``process`` (a `phy.ChannelProcess`) serves a living channel: the
    built fn becomes

        fn(protos, queries, pstate phy.ProcessState, generator,
           process_generators phy.ProcessGenerators) -> (pred, maxsim, pstate')

    Each call first steps the channel (`process.step` on
    ``process_generators``), then serves through the evolved
    ``pstate.chan`` with the cores of ``pstate.quarantine`` masked out of
    the top-1. With `phy.StaticProcess` the predictions equal the
    process-free serve's on the same generator, bit for bit.

    ``faults`` (a `faults.FaultModel`) serves through injected hard faults
    (see `repro_torch.faults`): the fn takes the fault state and the fault
    process's generator after the other inputs and returns the evolved
    state last,

        fn(protos, queries, state, generator, fstate, fault_generator)
          -> (pred, maxsim, fstate')
        fn(protos, queries, pstate, generator, process_generators, fstate,
           fault_generator) -> (pred, maxsim, pstate', fstate')

    Each call steps the channel, then the faults, then serves. The fault
    step draws only from ``fault_generator``, so with `faults.healthy_for`
    under `faults.StaticFaults` the predictions equal the fault-free
    serve's bit for bit.

    Sparse (``cfg.representation="sparse"``, or ``"auto"`` resolved to it):
    queries are index lists [B, 1, M, k_max] int32 against packed
    prototypes [C, W] int32, searched by the ``sparse_topk_banked`` kernel;
    predictions equal the packed serve's on the ideal channel whenever no
    bundle saturates k_max. With sparse, ``process`` and ``faults`` raise
    ValueError, as in the reference.
    """
    cfg = resolve_representation(cfg)
    if cfg.sparse and (process is not None or faults is not None):
        raise ValueError("representation='sparse' does not compose with living-channel "
                         "processes or fault injection; use representation='packed'")
    dev = _device.resolve(device)
    chan = phy.get_channel(cfg.channel)
    _validate_channel(cfg, chan)
    _validate_coarse(cfg)

    def serve_core(protos, queries, state, generator, qmask=None, fstate=None):
        _check_inputs(cfg, dev, protos, queries, state, fstate)
        if cfg.sparse:
            q_bundled = _sparse_bundle(cfg, queries)
            q_rx = _sparse_rx_fanout(cfg, q_bundled, state, generator)
            val, idx = _shard_top1(cfg, q_rx[None], protos[None])
            return _gather_top1(cfg, val[0], idx[0])
        pred, maxsim = _serve_slots(cfg, chan, protos[None], queries[None], None, state,
                                    [generator], qmask, fstate)
        return pred[0], maxsim[0]

    return _evolving(process, faults, serve_core)


def _serve_slots(cfg: ScaleOutConfig, chan: phy.Channel, store: torch.Tensor,
                 queries: torch.Tensor, rows: torch.Tensor | None, state: phy.ChannelState,
                 generators: list, qmask: torch.Tensor | None = None, fstate=None):
    """The dense serve of N slots: queries [N, B, 1, M, d|W] against store
    [T, C, d|W] (bank ``rows[s]``, or bank s when ``rows`` is None), slot s
    on ``generators[s]`` -> (pred, maxsim), [N, B] or [N, B, M].

    The bundle runs once over the slot-flattened [N*B] rows, elementwise over
    rows, so each row tallies as in a one-slot serve; the PHY fan-out runs
    slot by slot on ``generators[s]`` (merging the slots' draws would change
    every slot's noise); the search keeps the per-slot reduction order.
    ``fstate`` applies one fault state to every slot (they ride the same
    hardware): the erasures in the bundle, the dead-core zeroing and the
    failover gather on the fan-out's copies, the stuck cells in the
    search."""
    n, b = queries.shape[:2]
    q_mine = queries[:, :, 0].reshape((n * b,) + tuple(queries.shape[3:]))  # [N*B, M, d|W]
    if cfg.permuted:                      # TX g transmits rho^g(q_g)
        rho = hv.permute_packed if cfg.packed else hv.permute
        q_mine = torch.stack([rho(q_mine[:, g], g) for g in range(cfg.m_tx)], 1)
    q_bundled = _ota_bundle(cfg, chan, q_mine, fstate)
    q_bundled = q_bundled.reshape((n, b) + tuple(q_bundled.shape[1:]))
    copies = [_rx_fanout(cfg, chan, q_bundled[s], state, generators[s]) for s in range(n)]
    q_rx = copies[0][None] if n == 1 else torch.stack(copies)   # [N, n_core, B, d|W]
    stuck = None
    if fstate is not None:
        q_rx, qmask = _apply_rx_faults(fstate, q_rx, qmask)
        stuck = (fstate.stuck0, fstate.stuck1)
    val, idx = _shard_top1(cfg, q_rx, store, rows, qmask, stuck)
    return _gather_top1(cfg, val, idx)


def _evolving(process, faults, serve_core):
    """The serve a builder returns: ``serve_core`` itself, or its form that
    first steps a living channel and/or a fault model,

        fn(*inputs, state | pstate, generator(s)[, process_generators]
           [, fstate, fault_generator]) -> (pred, maxsim[, pstate'][, fstate'])

    The channel steps first, then the faults (one step for every slot),
    then the serve runs through the evolved ``pstate.chan`` with the cores
    of ``pstate.quarantine`` masked out of the top-1, and through the
    evolved fault state."""
    if process is None and faults is None:
        return serve_core

    def fn(*args):
        fstate = qmask = None
        if faults is not None:
            *args, fstate, fault_generator = args
        if process is not None:
            *args, process_generators = args
        *inputs, state, generators = args
        evolved = ()
        if process is not None:
            pstate = process.step(process_generators, state)
            state, qmask, evolved = pstate.chan, pstate.quarantine, (pstate,)
        if faults is not None:
            fstate = faults.step(fault_generator, fstate)
            evolved += (fstate,)
        return tuple(serve_core(*inputs, state, generators, qmask, fstate)) + evolved

    return fn


def _check_mt_inputs(cfg: ScaleOutConfig, dev: torch.device, store, queries, rows,
                     state, generators, fstate) -> None:
    if store.dim() != 3 or queries.dim() != 5:
        raise ValueError(f"store {tuple(store.shape)} and queries {tuple(queries.shape)} must "
                         "be [T, C, d|W] and [N, B, 1, M, d|W]")
    _check_inputs(cfg, dev, store[0], queries[0], state, fstate)
    _device.check_on(dev, rows=rows)
    n = queries.shape[0]
    if rows.dtype != torch.int32 or tuple(rows.shape) != (n,):
        raise ValueError(f"rows must be int32 [{n}], got {rows.dtype} {tuple(rows.shape)}")
    if len(generators) != n:
        raise ValueError(f"{len(generators)} generators for {n} slots")


def make_mt_ota_serve(cfg: ScaleOutConfig, device: str | torch.device | None = "cuda",
                      process=None, faults=None) -> Callable[..., tuple[torch.Tensor, ...]]:
    """Build the multi-tenant slot-batched OTA serve step.

    fn(store [T, C, d|W], queries [N, B, 1, M, d|W], rows [N] int32,
       state phy.ChannelState, generators: list of N torch.Generator)
      -> (pred, maxsim), each [N, B] (baseline) or [N, B, M] (permuted).

    One call serves N resident slots against a T-tenant store; slot s
    searches tenant bank ``rows[s]`` (each in [0, T): the caller keeps the
    rows, as `serving.hdc.TenantRegistry` does) with its own generator.

    Per-slot identity with `make_ota_serve`: the bundle runs once over the
    slot-flattened [N*B] rows, elementwise over rows, so each row tallies as
    in its standalone serve; the PHY fan-out runs slot by slot on
    ``generators[s]`` (the counterpart of the reference's vmap over per-slot
    keys; merging the slots' draws would change every slot's noise); and
    the search keeps the standalone per-slot reduction order. So row s of
    the output equals a standalone serve of slot s's queries against its
    tenant's codebook on a generator in the state of ``generators[s]``, bit
    for bit.

    The search is one launch for every (slot, core[, permuted bank]): the
    fused top-1 with bank index ``rows[s]*n_core + core`` (baseline) or
    ``(rows[s]*n_core + core)*M + m`` (permuted, the T-tenant store
    permuted once a call), the bipolar matmul over N*n_core(*M) gathered
    banks (unpacked), or the coarse-to-fine screen with ``bank_rows``.

    ``process`` serves a living channel: the fn becomes

        fn(store, queries, rows, pstate, generators, process_generators)
          -> (pred, maxsim, pstate')

    with one process step a serve step (every slot rides the one link) and
    the cores of ``pstate.quarantine`` masked out of the top-1.

    ``faults`` threads one fault state for every slot, as in
    `make_ota_serve` (one fault step a serve step, on ``fault_generator``):

        fn(store, queries, rows, state, generators, fstate, fault_generator)
          -> (pred, maxsim, fstate')
        fn(store, queries, rows, pstate, generators, process_generators,
           fstate, fault_generator) -> (pred, maxsim, pstate', fstate')

    The stuck cells hit the whole T-tenant store (one crossbar per core:
    every tenant's rows on it share the core's faults), as a masked copy
    before the launch. Row s still equals a standalone fault-aware serve of
    slot s under the same fault state.

    The sparse and ``"auto"`` representations raise ValueError, as in the
    reference."""
    if cfg.representation in ("sparse", "auto"):
        raise ValueError(
            "the multi-tenant serve does not support the sparse "
            "representation (slot-batched bank indirection is a dense-store "
            "contract); use representation='packed'")
    dev = _device.resolve(device)
    chan = phy.get_channel(cfg.channel)
    _validate_channel(cfg, chan)
    _validate_coarse(cfg)

    def serve_core(store, queries, rows, state, generators, qmask=None, fstate=None):
        _check_mt_inputs(cfg, dev, store, queries, rows, state, generators, fstate)
        return _serve_slots(cfg, chan, store, queries, rows, state, generators, qmask, fstate)

    return _evolving(process, faults, serve_core)


def make_wired_serve(cfg: ScaleOutConfig, device: str | torch.device | None = "cuda"
                     ) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """Wired-baseline dataflow: every core receives all M queries over the
    NoC and bundles them itself (error-free wires), then searches all
    classes. Same signature and outputs as `make_ota_serve` with baseline
    bundling; the state and generator ride along unused.

    Unpacked: the majority kernel, then the bipolar matmul kernel. Packed:
    the bit-sliced carry-save majority, then the Hamming search kernel.
    Sparse queries have no wired serve and raise, as in the reference."""
    cfg = resolve_representation(cfg)
    if cfg.sparse:
        raise ValueError("the wired serve has no sparse representation; use "
                         "representation='packed'")
    dev = _device.resolve(device)

    def fn(protos, queries, state, generator=None):
        _check_inputs(cfg, dev, protos, queries, state)
        d = cfg.dim
        q_act = queries[:, 0].transpose(0, 1)[: cfg.m_tx].contiguous()  # [M, B, d|W]
        if cfg.packed:
            q_bundled = hv.majority_packed(q_act)
            sims = d - 2 * hamming_search(q_bundled, protos)
        else:
            q_bundled = majority_bundle(q_act)
            sims = assoc_matmul(q_bundled, protos)            # [B, C]
        val = sims.max(-1).values
        idx = torch.argmax(sims, -1).to(torch.int32)
        return _gather_top1(cfg, val, idx)

    return fn


def make_hdc_train(cfg: ScaleOutConfig, device: str | torch.device | None = "cuda"
                   ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One-shot HDC training: bundle every class's examples into its
    prototype. fn(examples [B, d|W], labels [B] int) -> protos [C, d|W]: the
    bipolar per-class sums, thresholded at > 0; labels outside [0, C) add
    nothing. Packed examples are unpacked for the tally and the prototypes
    are packed again."""
    dev = _device.resolve(device)

    def fn(examples, labels):
        _device.check_on(dev, examples=examples, labels=labels)
        ex = hv.unpack(examples, cfg.dim) if cfg.packed else examples
        bipolar = 2 * ex.to(torch.int32) - 1                  # [B, d]
        keep = (labels >= 0) & (labels < cfg.n_classes)
        sums = torch.zeros((cfg.n_classes, cfg.dim), dtype=torch.int32, device=dev)
        sums.index_add_(0, labels[keep].to(torch.int64), bipolar[keep])
        protos = (sums > 0).to(torch.uint8)
        return hv.pack(protos) if cfg.packed else protos

    return fn


# ---------------------------------------------------------------------------
# host-level helpers (inputs + single-device oracle)
# ---------------------------------------------------------------------------

def make_queries(generator: torch.Generator, cfg: ScaleOutConfig, protos: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Random trial queries from the unpacked codebook ``protos`` [C, d]:
    classes [B, M] int64 and queries [B, 1, M, d] uint8 (packed to
    [B, 1, M, W] int32 words for a packed cfg). For a sparse cfg the same
    classes draw gives index lists [B, 1, M, k_max] int32; ``protos`` may
    then also be the codebook's index lists [C, k_max] int32 (`sparsify`
    of it), which spares a dense codebook at d = 2^20."""
    cfg = resolve_representation(cfg)
    classes = torch.randint(0, cfg.n_classes, (cfg.batch, cfg.m_tx),
                            generator=generator, device=protos.device)
    if cfg.sparse:
        codes = protos if protos.dtype == torch.int32 else sparse.sparsify(protos, cfg.k_max)
        if codes.shape[-1] != cfg.k_max:
            raise ValueError(f"index lists hold {codes.shape[-1]} slots, cfg.k_max={cfg.k_max}")
        return classes, codes[classes].reshape(cfg.batch, 1, cfg.m_tx, cfg.k_max)
    q = protos[classes].reshape(cfg.batch, 1, cfg.m_tx, cfg.dim)
    return classes, (hv.pack(q) if cfg.packed else q)


def serve_reference(cfg: ScaleOutConfig, protos: torch.Tensor,
                    queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Noise-free single-device oracle of the serve step, in the unpacked
    representation (packed protos or queries are unpacked first, sparse
    index-list queries densified). It matches the sparse serve whenever no
    bundle saturates k_max."""
    cfg = resolve_representation(cfg)
    if cfg.sparse and queries.dtype == torch.int32:
        queries = sparse.densify(queries, cfg.dim)
    elif queries.dtype == torch.int32:
        queries = hv.unpack(queries, cfg.dim)
    if protos.dtype == torch.int32:
        protos = hv.unpack(protos, cfg.dim)
    b, m = queries.shape[0], cfg.m_act
    q_act = queries.reshape(b, -1, cfg.dim)[:, :m, :]
    pb = lambda x: 2.0 * x.to(torch.float32) - 1.0  # noqa: E731
    if cfg.permuted:
        shifts = torch.arange(m, device=queries.device)
        q_act = hv.permute_batch(q_act, shifts)
        bundled = hv.majority(q_act.transpose(0, 1))
        banks = torch.stack([hv.permute(protos, s) for s in range(cfg.m_tx)], 0)
        sims = torch.einsum("bd,mcd->bmc", pb(bundled), pb(banks))
    else:
        bundled = hv.majority(q_act.transpose(0, 1))
        sims = torch.einsum("bd,cd->bc", pb(bundled), pb(protos))
    pred = torch.argmax(sims, -1).to(torch.int32)
    return pred, sims.max(-1).values / (2.0 * cfg.dim) + 0.5
