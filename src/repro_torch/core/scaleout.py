"""Scale-out of IMC-based HDC similarity search (counterpart of
`repro/core/scaleout.py`, paper Fig. 3b), on one GPU or over ranks.

The reference maps encoders and IMC cores onto a ``model`` mesh axis and
trials onto the ``data`` (and ``pod``) axes inside ``shard_map``. Here a
builder takes ``mesh=`` (a `distributed.mesh.RankMesh`) and each rank of the
mesh calls the built function on its own inputs (`shard_inputs` cuts them
from the global ones, the reference's ``in_specs``): model rank ``tx`` holds
classes [tx*C/S, (tx+1)*C/S), the ``n_rx_cores/S`` cores that store them
and the encoder slots ``tx*e_per .. tx*e_per + e_per - 1`` (``e_per =
ceil(M/S)``; slots ``g >= m_tx`` are empty and abstain), and each data rank
its share of the batch. The OTA bundle is a collective over the model
ranks (`distributed.collectives`): the int8 vote all-reduce (``psum``), the
guard-bit packed all-reduce (``psum_packed``), the reduce-scatter and
all-gather (``rs_ag``), or the index-list all-gather of sparse queries
(``index_ag``); the global top-1 is an all-gather of every model rank's
(value, index). Without a mesh (one rank) the model axis has size 1:
every encoder sits in column 0 (``e_per = m_tx``, ``tx = 0``), every core in
the one shard, and each collective is its rank's own value. ``vmap`` over
cores becomes a written-out leading core axis, which is also the bank axis
of the kernels: one launch searches every core of the rank.

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
slot-flattening reshape on one rank) and a local sparse majority; the dense
``psum``/``psum_packed`` wires densify, vote and re-sparsify across model
ranks, which gives the same lists (on one rank they take the index path,
with no wire to choose); the per-core BSC is the O(k)
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
place of `sparse._noise_draws` (sparse). Over model ranks the serve is
mesh-layout invariant, as the reference's is: every model rank of a data
row draws over the global cores on a generator seeded alike and keeps its
cores' rows, so core g's noise depends on (generator, g) alone and a 1xS
noisy serve equals the one-rank serve bit for bit. A data row draws on its
own generator for its rows of the batch (the caller's choice; the
reference folds the data position into its key).

Living channels (``process=``) and faults (``faults=``) run on any mesh the
serve takes: each model rank holds its cores' rows of the process and fault
state (`phy.shard_pstate`, `faults.shard_fstate`; `shard_inputs` cuts both)
and steps them at ``rx_base = tx * cores`` (the reference's ``pstate_spec``
and ``fstate_spec`` in its shard_map), which gives the one-rank state's rows
bit for bit; the fault state's TX leaves are whole on every rank, so each
column derives the global live-voter count without a collective.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import device as _device, faults as _faults, phy, spans
from repro_torch.core import em, hypervector as hv, ota, sparse
from repro_torch.distributed import collectives
from repro_torch.kernels.assoc_matmul import assoc_matmul, assoc_matmul_banked
from repro_torch.kernels.common import popcount32
from repro_torch.kernels.hamming import hamming_search, hamming_topk_banked
from repro_torch.kernels.majority import majority_bundle
from repro_torch.kernels.sparse import sparse_topk_banked
from repro_torch.distributed.mesh import RankMesh


@dataclasses.dataclass(frozen=True)
class ScaleOutConfig:
    """The reference's configuration (same defaults — the paper's 6400
    classes over 64 cores, d = 512, M = 3, 7 dB, batch 256) minus
    ``use_kernels`` (the port dispatches on the tensors' device instead).
    Combinations the reference rejects raise ValueError here, as there.

    ``collective`` is the OTA vote's wire over the model ranks: ``"psum"``
    (the int8 all-reduce), ``"psum_packed"`` (the guard-bit packed
    all-reduce, slot-aware fields), ``"rs_ag"`` (reduce-scatter the packed
    votes, threshold the local d/S block, all-gather its bits) or
    ``"index_ag"`` (the sparse index lists' all-gather). All give the same
    tally; on one rank nothing is sent.

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
        if self.collective not in ("psum", "psum_packed", "rs_ag", "index_ag"):
            raise ValueError(f"unknown collective {self.collective!r}")
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
# `set_crossover_table` installs a measured one.
DEFAULT_CROSSOVER = {"density": 1.0 / 32.0}
_crossover_table = dict(DEFAULT_CROSSOVER)


def set_crossover_table(table: dict | None) -> None:
    """Install a measured crossover fit ({"density": float}); None restores
    DEFAULT_CROSSOVER."""
    global _crossover_table
    _crossover_table = dict(DEFAULT_CROSSOVER if table is None else table)


def resolve_representation(cfg: ScaleOutConfig) -> ScaleOutConfig:
    """Materialize ``representation="auto"``: "sparse" with the
    ``index_ag`` wire when ``k_max / dim`` lies below the crossover density,
    else "packed" with the guard-bit ``psum_packed`` wire. Other configs
    pass through untouched."""
    if cfg.representation != "auto":
        return cfg
    rep = "sparse" if cfg.k_max / cfg.dim < _crossover_table["density"] else "packed"
    coll = "index_ag" if rep == "sparse" else "psum_packed"
    return dataclasses.replace(cfg, representation=rep, collective=coll)


def precharacterize_state(cfg: ScaleOutConfig, geom: em.PackageGeometry | None = None,
                          device: str | torch.device | None = "cuda") -> phy.ChannelState:
    """Channel precharacterization -> `phy.ChannelState` (the paper's offline
    CST + MATLAB step): channel matrix, noise density at ``cfg.snr_db``, the
    joint phase search (exhaustive for M <= 3) and its Eq. 1 per-core BER.
    The ``ota.precharacterize`` set-up span, recorded in every process."""
    dev = _device.resolve(device)
    with spans.span("ota.precharacterize", always=True):
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
# this rank's place on the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Shard:
    """Where one rank's part of a serve sits: column ``tx`` of a model axis
    of ``model_size`` ranks (``model_group`` their process group, None for
    one rank), its ``e_per`` encoder slots (global ids ``tx*e_per + j``) and
    ``cores`` IMC cores, and the process groups of the data axes of more
    than one rank (pod first) over ``data_size`` data ranks in all. Its
    first ``n_tx`` slots hold encoders (``g < m_tx``) and its first
    ``n_live`` vote (``g < m_act``): the rest abstain, which folds the M-drop
    into the same mechanism as the empty slots."""

    model_size: int
    tx: int
    e_per: int
    cores: int
    model_group: object
    data_groups: tuple
    data_size: int
    n_tx: int
    n_live: int

    @property
    def ranks(self) -> int:
        return self.model_size * self.data_size


def _dp_axes(mesh: RankMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dpos(mesh: RankMesh | None) -> tuple[int, int]:
    """(flat data-parallel position of this rank (pod-major), data ranks)."""
    pos, size = 0, 1
    for ax in () if mesh is None else _dp_axes(mesh):
        pos = pos * mesh.axis_size(ax) + mesh.index(ax)
        size *= mesh.axis_size(ax)
    return pos, size


def _shard_of(cfg: ScaleOutConfig, mesh: RankMesh | None) -> _Shard:
    """This rank's `_Shard` of ``cfg`` on ``mesh`` (None: one rank). The
    cores must divide over the model ranks."""
    if mesh is None:
        s, tx, group, dgroups = 1, 0, None, ()
    else:
        if "model" not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no 'model' axis")
        s, tx, group = mesh.axis_size("model"), mesh.index("model"), mesh.group("model")
        dgroups = tuple(mesh.group(a) for a in _dp_axes(mesh) if mesh.axis_size(a) > 1)
    if cfg.n_rx_cores % s:
        raise ValueError(f"n_rx_cores={cfg.n_rx_cores} must divide over the {s} model ranks")
    e_per = -(-cfg.m_tx // s)
    mine = lambda m: min(max(m - tx * e_per, 0), e_per)  # noqa: E731  (slots g < m here)
    return _Shard(model_size=s, tx=tx, e_per=e_per, cores=cfg.n_rx_cores // s,
                  model_group=group, data_groups=dgroups, data_size=_dpos(mesh)[1],
                  n_tx=mine(cfg.m_tx), n_live=mine(cfg.m_act))


def _validate_wire(cfg: ScaleOutConfig, sh: _Shard) -> None:
    """The rs_ag layout: each model rank's d/S block must pack whole words
    (packed) or bytes (unpacked) for the all-gather (reference lines 386,
    396)."""
    if cfg.collective == "rs_ag":
        unit = hv.WORD if cfg.packed else 8
        if cfg.dim % (sh.model_size * unit):
            raise ValueError(f"collective='rs_ag' needs dim={cfg.dim} divisible by "
                             f"{sh.model_size} model ranks x {unit} bits")


# ---------------------------------------------------------------------------
# serve-step stages (one rank's shard; every stage is elementwise over rows)
# ---------------------------------------------------------------------------

def _pack_bytes(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} bits [..., n] -> uint8 [..., n/8], little-endian in a byte."""
    w = bits.reshape(tuple(bits.shape[:-1]) + (-1, 8))
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (w << shifts).sum(-1, dtype=torch.uint8)


def _unpack_bytes(b: torch.Tensor, d: int) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=b.device)
    return ((b[..., None] >> shifts) & 1).reshape(tuple(b.shape[:-1]) + (d,))


def _ota_bundle(cfg: ScaleOutConfig, chan: phy.Channel, sh: _Shard, q_mine: torch.Tensor,
                fstate=None) -> torch.Tensor:
    """The OTA collective over the model ranks: this column's encoder slots
    q_mine [R, e_per, d|W] -> the bundled query [R, d|W], or the combo index
    [R, d] int32 on the combo wire.

    Vote wire: each live slot votes +-1 per dimension and the abstaining
    slots ``g >= m_act`` vote exactly 0; the tally is the sum over every
    rank's slots (``cfg.collective``), and ``tally > 0`` the strict majority
    (even-M ties -> 0). ``rs_ag`` tallies this rank's d/S block, thresholds
    it and all-gathers the bits (words packed, bytes unpacked). Combo wire:
    the sum of ``bit_g * 2^g`` over the encoders, sent in the smallest int
    that holds 2^m_tx - 1, the received field's index into the
    constellation.

    ``fstate`` (a `faults.FaultState`; its TX leaves whole, [S*e_per]) erases
    the slots of ``dead_tx | vote_drop``: on the vote wire an erased slot
    votes exactly 0, so ``tally > 0`` is the majority of the live voters
    (even live counts tie to 0), and the guard-bit wires bias by this
    rank's live count and subtract the global one, both read from the whole
    TX leaves; on the combo wire an erased encoder is a stuck carrier, its
    bit forced 0 (`faults.recenter_state` re-fits the decoder)."""
    q_bits = hv.unpack(q_mine, cfg.dim) if cfg.packed else q_mine
    g = sh.model_group
    erased = erased_all = None
    if fstate is not None:
        erased_all = fstate.dead_tx | fstate.vote_drop                     # [S*e_per]
        erased = erased_all[sh.tx * sh.e_per:(sh.tx + 1) * sh.e_per, None]  # this column's
    if chan.wire == "combo":
        if erased is not None:
            q_bits = torch.where(erased, 0, q_bits)
        # encoder g weighs 2^g: this column's weigh 2^(tx*e_per + j)
        partial = phy.combo_index(q_bits[..., :sh.n_tx, :], axis=-2)
        if sh.tx:
            partial = partial << (sh.tx * sh.e_per)
        cdt = torch.int8 if cfg.m_tx <= 7 else torch.int16 if cfg.m_tx <= 15 else torch.int32
        return collectives.all_reduce(partial, g, wire_dtype=cdt)
    votes = 2 * q_bits.to(torch.int8) - 1
    live = None
    if erased is None:
        votes = votes[..., :sh.n_live, :]
    else:                                       # global slot ids tx*e_per + j
        gid = sh.tx * sh.e_per + torch.arange(sh.e_per, device=erased.device)[:, None]
        live = (gid < cfg.m_act) & ~erased
        votes = torch.where(live, votes, 0)
    votes = votes.sum(-2, dtype=torch.int8)
    if cfg.collective == "psum":
        bundled = (collectives.all_reduce(votes, g) > 0).to(torch.uint8)
        return hv.pack(bundled) if cfg.packed else bundled
    # guard-bit fields sized for m_act voters; each rank biases by its own
    # live count, and erased voters lower the total the unpack subtracts
    local, total = sh.n_live, None
    if live is not None:
        local = total = live.sum()               # one rank: every slot is local
        if sh.model_size > 1:
            slot = torch.arange(erased_all.shape[0], device=erased_all.device)
            total = ((slot < cfg.m_act) & ~erased_all).sum()
    slots = dict(group_size=sh.model_size, e_per=sh.e_per, n_active=cfg.m_act,
                 local_active=local, total_active=total)
    if cfg.collective == "rs_ag":
        part = collectives.packed_vote_psum_scatter(votes, g, **slots)   # [R, d/S]
        bits = (part > 0).to(torch.uint8)
        if cfg.packed:       # the gathered words are the bundled packed query
            return collectives.all_gather_last(hv.pack(bits), g)
        return _unpack_bytes(collectives.all_gather_last(_pack_bytes(bits), g), cfg.dim)
    bundled = (collectives.packed_vote_allreduce(votes, g, **slots) > 0).to(torch.uint8)
    return hv.pack(bundled) if cfg.packed else bundled


def _rx_fanout(cfg: ScaleOutConfig, chan: phy.Channel, sh: _Shard, q_bundled: torch.Tensor,
               state: phy.ChannelState, generator) -> torch.Tensor:
    """Per-core decode through the PHY tier: this rank's cores' copies
    [cores, R, d|W], core i being RX ``tx*cores + i``. Across model ranks
    the tier gets the global core count (``n_all``) and draws over every
    core, so each core's noise is the one-rank serve's; on one rank it gets
    none, so a replay tier written for one rank needs no ``n_all``."""
    extra = {"n_all": sh.cores * sh.model_size} if sh.model_size > 1 else {}
    return chan.rx_copies(generator, q_bundled, state, rx_base=sh.tx * sh.cores,
                          n_cores=sh.cores, packed=cfg.packed, dim=cfg.dim,
                          noise=cfg.noise, planes=cfg.noise_planes, **extra)


def _sparse_bundle(cfg: ScaleOutConfig, chan: phy.Channel, sh: _Shard,
                   q_mine: torch.Tensor) -> torch.Tensor:
    """The OTA vote on sparse index lists: this column's slots q_mine
    [R, e_per, k_max] -> bundled [R, k_max].

    ``index_ag`` gathers every rank's lists (shard-major, global encoder
    order), empties the abstaining slots (``g >= m_act``) to all-SENTINEL,
    a dense all-zero vote, and takes the sparse strict majority at m_act.
    ``psum``/``psum_packed`` across model ranks densify the lists, run the
    dense vote wire of `_ota_bundle` and re-sparsify, which gives the same
    lists; on one rank there is no wire, and they take the index path."""
    if cfg.collective == "index_ag" or sh.model_group is None:
        stack = collectives.sparse_index_allgather(q_mine, sh.model_group)  # [R, S*e, k]
        active = torch.arange(stack.shape[-2], device=stack.device)[:, None] < cfg.m_act
        stack = torch.where(active, stack, sparse.SENTINEL)
        return sparse.bundle(stack, m=cfg.m_act)
    bits = _ota_bundle(cfg, chan, sh, sparse.densify(q_mine, cfg.dim))
    return sparse.sparsify(bits, cfg.k_max)


def _sparse_rx_fanout(cfg: ScaleOutConfig, sh: _Shard, q_bundled: torch.Tensor,
                      state: phy.ChannelState, generator) -> torch.Tensor:
    """Per-core sparse decode: [cores, R, k_max]. ``ideal`` broadcasts the
    bundle; ``bsc`` runs the drop+insert channel at each core's BER (the
    state holds this rank's cores), every core's draws in one call. Across
    model ranks the draws span the global cores [cores * S, R, k_max] (every
    rank's slab compared with this rank's BERs, a view on one rank) and the
    rank keeps its own rows: each core's noise is the one-rank serve's."""
    n = sh.cores
    copies = q_bundled[None].expand((n,) + tuple(q_bundled.shape))
    if cfg.channel == "ideal":
        return copies
    n_all = n * sh.model_size
    ber = state.ber[:n].reshape(n, 1, 1).expand(sh.model_size, n, 1, 1).reshape(n_all, 1, 1)
    draws = sparse._noise_draws(generator, (n_all,) + tuple(copies.shape[1:]), ber,
                                cfg.dim, copies.shape[-1])
    return sparse.apply_noise(copies, *(phy.channel._draw_rows(x, sh.tx * n, n)
                                        for x in draws))


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


def _apply_rx_faults(fstate, q_rx: torch.Tensor, qmask: torch.Tensor | None,
                     rx_base: int = 0):
    """Dead-core zeroing, the failover gather and the bank mask: q_rx
    [N, n_core, B, d|W], this rank's cores from global id ``rx_base``. A
    dead core's copy is zeroed, then bank i's query is core
    ``serve_rows[i]``'s copy (global ids, made local by subtracting
    ``rx_base``: failover stays inside a shard; identity: no remap), and
    ``rx_mask`` joins the quarantine mask so banks with no healthy server
    never win. The healthy state changes no value."""
    dead = fstate.dead_rx[None, :, None, None]
    rows = fstate.serve_rows - rx_base if rx_base else fstate.serve_rows
    q_rx = torch.where(dead, 0, q_rx).index_select(1, rows)
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
                stuck=None, tx: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Every core of every slot searches its class sub-shard (with the M
    permuted banks when ``cfg.permuted``), in one kernel launch for every
    (slot, core[, permuted bank]). q_rx [N, n_core, B, d|W|k_max]; store
    [T, C, d|W]: slot s searches tenant bank ``rows[s]`` (int32 [N]) through
    the kernels' ``bank_rows`` indirection (packed, coarse) or a gather of
    those rows (unpacked), or, with ``rows=None``, bank s itself (T == N: no
    indirection and no gather; the standalone serve is N = 1). Returns (val,
    idx): the winner's similarity (d - 2*dist, int32 packed / f32 unpacked)
    and global class index (this rank's store holds classes from ``tx*C``
    on, C its class count), [N, B] or [N, B, M]. Ties go to the lowest
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
        # contiguous: on the ideal tier q_rx is a stride-0 expand, which the
        # reshape keeps as a view, and the kernels take dense tensors only
        q_rep = q_rx[:, :, None].expand(n, n_core, m, b, last).reshape(
            n * n_core * m, b, last).contiguous()
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
    return val, idx + tx * c if tx else idx


def _gather_top1(cfg: ScaleOutConfig, sh: _Shard, val: torch.Tensor, idx: torch.Tensor):
    """Global top-1 over the model ranks, an all-gather of every rank's
    (value, index): the highest value wins and among equal values the first
    rank, whose classes come first, so ties go to the lowest class. Returns
    (pred, the similarity normalized to [0, 1])."""
    if sh.model_group is not None:
        vals = collectives.all_gather(val, sh.model_group)        # [S, ...]
        idxs = collectives.all_gather(idx, sh.model_group)
        star = torch.argmax(vals, 0)                              # the first maximum
        idx = torch.gather(idxs, 0, star[None])[0]
        val = vals.max(0).values
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


def _check_inputs(cfg: ScaleOutConfig, sh: _Shard, dev: torch.device, protos, queries,
                  state, fstate=None) -> None:
    _device.check_on(dev, protos=protos, queries=queries, ber=state.ber)
    want = torch.int32 if cfg.packed or cfg.sparse else torch.uint8
    last = cfg.words if cfg.packed or cfg.sparse else cfg.dim
    q_last = cfg.k_max if cfg.sparse else last
    if protos.dtype != want or queries.dtype != want:
        raise TypeError(f"{cfg.representation} serve takes {want} protos and queries")
    c_l = cfg.n_classes // sh.model_size
    if tuple(protos.shape) != (c_l, last):
        raise ValueError(f"protos {tuple(protos.shape)} != {(c_l, last)} (this rank's classes)")
    if queries.dim() != 4 or queries.shape[1] != 1 or queries.shape[2:] != (sh.e_per, q_last):
        raise ValueError(f"queries {tuple(queries.shape)} != [B, 1, {sh.e_per}, {q_last}] "
                         "(this rank's model column)")
    if state.n_rx != sh.cores:
        raise ValueError(f"state has {state.n_rx} cores, this rank {sh.cores} "
                         f"(cfg {cfg.n_rx_cores} over {sh.model_size} model ranks)")
    if state.m_tx != cfg.m_tx:
        raise ValueError(f"state characterizes {state.m_tx} TXs, cfg {cfg.m_tx}")
    if fstate is not None:
        _device.check_on(dev, dead_rx=fstate.dead_rx, stuck0=fstate.stuck0)
        got = (fstate.n_rx, fstate.m_slots, fstate.words)
        want = (sh.cores, sh.model_size * sh.e_per, cfg.words)
        if got != want:
            raise ValueError(f"fault state (n_rx, m_slots, words) {got} != {want} (this "
                             "rank's cores: faults.healthy_for at model_size, shard_fstate)")


def make_ota_serve(cfg: ScaleOutConfig, device: str | torch.device | None = "cuda",
                   process=None, faults=None, mesh: RankMesh | None = None
                   ) -> Callable[..., tuple[torch.Tensor, ...]]:
    """Build the OTA serve step.

    fn(protos [C, d|W], queries [B, 1, M, d|W], state phy.ChannelState,
       generator) -> (pred, maxsim); pred int32 [B] (baseline) or [B, M]
    (permuted), maxsim f32 in [0, 1].

    With ``mesh`` (a `distributed.mesh.RankMesh` with a ``model`` axis and
    optional ``data``/``pod`` axes) every rank of the mesh calls fn with its
    own inputs, as `shard_inputs` cuts them: its classes [C/S, d|W], its
    rows of the batch and its model column of the queries [B/D, 1, e_per,
    d|W] (``e_per = ceil(M/S)``, the layout of `make_queries` at
    ``model_size=S``), its cores' state (`phy.shard_state`) and its own
    generator; it returns its rows' (pred, maxsim), the same on every model
    rank. The bundle is ``cfg.collective`` over the model ranks and the
    top-1 an all-gather over them; on ideal (or on a tier that replays noise
    by core) the answers equal the one-rank serve's, bit for bit.

    Unpacked tensors are uint8 {0,1}; packed ones int32 words (``hv.pack``).
    Encoder g transmits rho^g of its query when ``cfg.permuted``; encoders
    ``g >= cfg.m_active`` abstain. The PHY tier is ``cfg.channel``
    (``ideal``, ``bsc`` or ``symbol``; the noise comes from ``generator``);
    ``symbol`` needs a real state (`precharacterize_state`), replaces the
    vote by the combo index and decodes the physics at every core, bits
    packed afterwards when the serve is packed. The per-core search is the
    fused top-1 kernel (packed) or the bipolar matmul kernel (unpacked), one
    launch for all the rank's cores and banks; with ``cfg.coarse_group`` it
    is the coarse-to-fine screen (the fused top-k kernel or the matmul
    kernel over the group summaries, then an exact rescore of the
    survivors). ``coarse_group`` with permuted bundling, shapes the screen
    cannot tile, the symbol tier with another collective or with
    ``m_active``, an even or out-of-range ``m_active``, cores that do not
    divide over the model ranks and an ``rs_ag`` layout that does not tile
    raise ValueError here.

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
    serve's bit for bit. With ``mesh``, ``pstate`` and ``fstate`` are this
    rank's rows (`shard_inputs`, or `phy.shard_pstate` and
    `faults.shard_fstate`), stepped at ``rx_base = tx * cores`` on
    generators seeded alike on every rank (the process and fault
    generators are the same on every rank; only the serve's noise
    generator is the rank's own): the evolved rows equal the one-rank
    rollout's, and with noise replayed by core the answers equal the
    one-rank serve's.

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
    sh = _shard_of(cfg, mesh)
    chan = phy.get_channel(cfg.channel)
    _validate_channel(cfg, chan)
    _validate_coarse(cfg)
    _validate_wire(cfg, sh)

    def serve_core(protos, queries, state, generator, qmask=None, fstate=None):
        _check_inputs(cfg, sh, dev, protos, queries, state, fstate)
        if cfg.sparse:
            q_bundled = _sparse_bundle(cfg, chan, sh, queries[:, 0])
            q_rx = _sparse_rx_fanout(cfg, sh, q_bundled, state, generator)
            val, idx = _shard_top1(cfg, q_rx[None], protos[None], tx=sh.tx)
            return _gather_top1(cfg, sh, val[0], idx[0])
        pred, maxsim = _serve_slots(cfg, chan, sh, protos[None], queries[None], None, state,
                                    [generator], qmask, fstate)
        return pred[0], maxsim[0]

    return _evolving(cfg, sh, process, faults, serve_core)


def _serve_slots(cfg: ScaleOutConfig, chan: phy.Channel, sh: _Shard, store: torch.Tensor,
                 queries: torch.Tensor, rows: torch.Tensor | None, state: phy.ChannelState,
                 generators: list, qmask: torch.Tensor | None = None, fstate=None):
    """The dense serve of N slots on one rank: queries [N, B, 1, e_per, d|W]
    against store [T, C_l, d|W] (bank ``rows[s]``, or bank s when ``rows``
    is None), slot s on ``generators[s]`` -> (pred, maxsim), [N, B] or
    [N, B, M].

    The bundle runs once over the slot-flattened [N*B] rows, elementwise over
    rows, so each row tallies as in a one-slot serve; the PHY fan-out runs
    slot by slot on ``generators[s]`` (merging the slots' draws would change
    every slot's noise); the search keeps the per-slot reduction order.
    ``fstate`` applies one fault state to every slot (they ride the same
    hardware): the erasures in the bundle, the dead-core zeroing and the
    failover gather on the fan-out's copies, the stuck cells in the
    search. The bundle, the fan-out and the search are the ``ota.bundle``,
    ``ota.fanout`` and ``ota.search`` spans, each with its device time."""
    n, b = queries.shape[:2]
    dev = store.device
    q_mine = queries[:, :, 0].reshape((n * b,) + tuple(queries.shape[3:]))  # [N*B, e, d|W]
    if cfg.permuted:                      # TX g transmits rho^g(q_g)
        rho = hv.permute_packed if cfg.packed else hv.permute
        q_mine = torch.stack([rho(q_mine[:, j], sh.tx * sh.e_per + j)
                              for j in range(sh.e_per)], 1)
    with spans.span("ota.bundle", dev):
        q_bundled = _ota_bundle(cfg, chan, sh, q_mine, fstate)
    q_bundled = q_bundled.reshape((n, b) + tuple(q_bundled.shape[1:]))
    with spans.span("ota.fanout", dev):
        copies = [_rx_fanout(cfg, chan, sh, q_bundled[s], state, generators[s])
                  for s in range(n)]
        q_rx = copies[0][None] if n == 1 else torch.stack(copies)   # [N, cores, B, d|W]
    stuck = None
    if fstate is not None:
        q_rx, qmask = _apply_rx_faults(fstate, q_rx, qmask, sh.tx * sh.cores)
        stuck = (fstate.stuck0, fstate.stuck1)
    with spans.span("ota.search", dev):
        val, idx = _shard_top1(cfg, q_rx, store, rows, qmask, stuck, tx=sh.tx)
        return _gather_top1(cfg, sh, val, idx)


def _evolving(cfg: ScaleOutConfig, sh: _Shard, process, faults, serve_core):
    """The serve a builder returns: ``serve_core`` itself, or its form that
    first steps a living channel and/or a fault model,

        fn(*inputs, state | pstate, generator(s)[, process_generators]
           [, fstate, fault_generator]) -> (pred, maxsim[, pstate'][, fstate'])

    The channel steps first, then the faults (one step for every slot),
    each on this rank's rows at ``rx_base = tx * cores`` of the global
    ``n_rx_cores``, then the serve runs through the evolved ``pstate.chan``
    with the cores of ``pstate.quarantine`` masked out of the top-1, and
    through the evolved fault state."""
    rows = dict(rx_base=sh.tx * sh.cores, n_rx=cfg.n_rx_cores)
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
            pstate = process.step(process_generators, state, **rows)
            state, qmask, evolved = pstate.chan, pstate.quarantine, (pstate,)
        if faults is not None:
            fstate = faults.step(fault_generator, fstate, **rows)
            evolved += (fstate,)
        return tuple(serve_core(*inputs, state, generators, qmask, fstate)) + evolved

    return fn


def _check_mt_inputs(cfg: ScaleOutConfig, sh: _Shard, dev: torch.device, store, queries, rows,
                     state, generators, fstate) -> None:
    if store.dim() != 3 or queries.dim() != 5:
        raise ValueError(f"store {tuple(store.shape)} and queries {tuple(queries.shape)} must "
                         "be [T, C, d|W] and [N, B, 1, e_per, d|W]")
    _check_inputs(cfg, sh, dev, store[0], queries[0], state, fstate)
    _device.check_on(dev, rows=rows)
    n = queries.shape[0]
    if rows.dtype != torch.int32 or tuple(rows.shape) != (n,):
        raise ValueError(f"rows must be int32 [{n}], got {rows.dtype} {tuple(rows.shape)}")
    if len(generators) != n:
        raise ValueError(f"{len(generators)} generators for {n} slots")


def make_mt_ota_serve(cfg: ScaleOutConfig, device: str | torch.device | None = "cuda",
                      process=None, faults=None, mesh: RankMesh | None = None
                      ) -> Callable[..., tuple[torch.Tensor, ...]]:
    """Build the multi-tenant slot-batched OTA serve step.

    fn(store [T, C, d|W], queries [N, B, 1, M, d|W], rows [N] int32,
       state phy.ChannelState, generators: list of N torch.Generator)
      -> (pred, maxsim), each [N, B] (baseline) or [N, B, M] (permuted).

    One call serves N resident slots against a T-tenant store; slot s
    searches tenant bank ``rows[s]`` (each in [0, T): the caller keeps the
    rows, as `serving.hdc.TenantRegistry` does) with its own generator.
    With ``mesh`` each rank passes its classes of every tenant [T, C/S,
    d|W], its rows and model column of every slot's queries [N, B/D, 1,
    e_per, d|W] (`shard_inputs` with ``slots=True``), its cores' state and
    its own N generators, as in `make_ota_serve`.

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
    slot s under the same fault state. With ``mesh`` both states are this
    rank's rows, as in `make_ota_serve`.

    The sparse and ``"auto"`` representations raise ValueError, as in the
    reference."""
    if cfg.representation in ("sparse", "auto"):
        raise ValueError(
            "the multi-tenant serve does not support the sparse "
            "representation (slot-batched bank indirection is a dense-store "
            "contract); use representation='packed'")
    dev = _device.resolve(device)
    sh = _shard_of(cfg, mesh)
    chan = phy.get_channel(cfg.channel)
    _validate_channel(cfg, chan)
    _validate_coarse(cfg)
    _validate_wire(cfg, sh)

    def serve_core(store, queries, rows, state, generators, qmask=None, fstate=None):
        _check_mt_inputs(cfg, sh, dev, store, queries, rows, state, generators, fstate)
        return _serve_slots(cfg, chan, sh, store, queries, rows, state, generators, qmask,
                            fstate)

    return _evolving(cfg, sh, process, faults, serve_core)


def make_wired_serve(cfg: ScaleOutConfig, device: str | torch.device | None = "cuda",
                     mesh: RankMesh | None = None
                     ) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """Wired-baseline dataflow: every core receives all M queries over the
    NoC and bundles them itself (error-free wires), then searches its
    classes. Same signature, inputs (``mesh`` included) and outputs as
    `make_ota_serve` with baseline bundling; the state and generator ride
    along unused. Over ranks the NoC broadcast is an all-gather of every
    model rank's query slots, M*d bytes a trial where the OTA vote sends d.

    Unpacked: the majority kernel, then the bipolar matmul kernel. Packed:
    the bit-sliced carry-save majority, then the Hamming search kernel.
    Sparse queries have no wired serve and raise, as in the reference."""
    cfg = resolve_representation(cfg)
    if cfg.sparse:
        raise ValueError("the wired serve has no sparse representation; use "
                         "representation='packed'")
    dev = _device.resolve(device)
    sh = _shard_of(cfg, mesh)

    def fn(protos, queries, state, generator=None):
        _check_inputs(cfg, sh, dev, protos, queries, state)
        d, last = cfg.dim, queries.shape[-1]
        q_all = collectives.all_gather(queries[:, 0], sh.model_group)   # [S, B, e, d|W]
        q_act = q_all.transpose(1, 2).reshape(-1, queries.shape[0], last)[: cfg.m_tx]
        q_act = q_act.contiguous()                                       # [M, B, d|W]
        if cfg.packed:
            q_bundled = hv.majority_packed(q_act)
            sims = d - 2 * hamming_search(q_bundled, protos)
        else:
            q_bundled = majority_bundle(q_act)
            sims = assoc_matmul(q_bundled, protos)            # [B, C_l]
        val = sims.max(-1).values
        idx = torch.argmax(sims, -1).to(torch.int32)
        return _gather_top1(cfg, sh, val, idx + sh.tx * protos.shape[0] if sh.tx else idx)

    return fn


def make_hdc_train(cfg: ScaleOutConfig, device: str | torch.device | None = "cuda",
                   mesh: RankMesh | None = None
                   ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One-shot HDC training: bundle every class's examples into its
    prototype. fn(examples [B, d|W], labels [B] int) -> protos [C, d|W]: the
    bipolar per-class sums, thresholded at > 0; labels outside [0, C) add
    nothing. Packed examples are unpacked for the tally and the prototypes
    are packed again. With ``mesh`` each rank passes its rows of the batch
    (`shard_batch`) and gets its model rank's classes [C/S, d|W]; the class
    sums are all-reduced over the data axes, the learning counterpart of
    the OTA reduction."""
    dev = _device.resolve(device)
    sh = _shard_of(cfg, mesh)
    c_l = cfg.n_classes // sh.model_size
    lo = sh.tx * c_l

    def fn(examples, labels):
        _device.check_on(dev, examples=examples, labels=labels)
        ex = hv.unpack(examples, cfg.dim) if cfg.packed else examples
        bipolar = 2 * ex.to(torch.int32) - 1                  # [B, d]
        keep = (labels >= lo) & (labels < lo + c_l)
        sums = torch.zeros((c_l, cfg.dim), dtype=torch.int32, device=dev)
        # every row added, those of other ranks' classes as zeros into row 0:
        # no data-dependent shape (a masked select waits for the host)
        rows = torch.where(keep, labels - lo, 0)
        sums.index_add_(0, rows.to(torch.int64), bipolar * keep[:, None].to(torch.int32))
        for g in sh.data_groups:
            sums = collectives.all_reduce(sums, g)
        protos = (sums > 0).to(torch.uint8)
        return hv.pack(protos) if cfg.packed else protos

    return fn


# ---------------------------------------------------------------------------
# host-level helpers (inputs + single-device oracle)
# ---------------------------------------------------------------------------

def make_queries(generator: torch.Generator, cfg: ScaleOutConfig, protos: torch.Tensor,
                 model_size: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Random trial queries from the unpacked codebook ``protos`` [C, d]:
    classes [B, M] int64 and queries [B, S, e_per, d] uint8 (packed to
    [B, S, e_per, W] int32 words for a packed cfg), S = ``model_size`` and
    ``e_per = ceil(M/S)``: encoder g = s*e_per + j sits in column s, and the
    slots g >= M hold zeros (they abstain in the serve, as do g >= m_active).
    At S = 1 this is [B, 1, M, d]. For a sparse cfg the same classes draw
    gives index lists [B, S, e_per, k_max] int32, the empty slots
    all-SENTINEL; ``protos`` may then also be the codebook's index lists
    [C, k_max] int32 (`sparsify` of it), which spares a dense codebook at
    d = 2^20."""
    cfg = resolve_representation(cfg)
    e_per = -(-cfg.m_tx // model_size)
    pad = model_size * e_per - cfg.m_tx
    classes = torch.randint(0, cfg.n_classes, (cfg.batch, cfg.m_tx),
                            generator=generator, device=protos.device)
    if cfg.sparse:
        codes = protos if protos.dtype == torch.int32 else sparse.sparsify(protos, cfg.k_max)
        if codes.shape[-1] != cfg.k_max:
            raise ValueError(f"index lists hold {codes.shape[-1]} slots, cfg.k_max={cfg.k_max}")
        q = torch.nn.functional.pad(codes[classes], (0, 0, 0, pad), value=sparse.SENTINEL)
        return classes, q.reshape(cfg.batch, model_size, e_per, cfg.k_max)
    q = torch.nn.functional.pad(protos[classes], (0, 0, 0, pad))
    q = q.reshape(cfg.batch, model_size, e_per, cfg.dim)
    return classes, (hv.pack(q) if cfg.packed else q)


def shard_batch(mesh: RankMesh | None, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a global batch along ``axis``: the data ranks
    split it in order of their flat position (pod-major)."""
    pos, size = _dpos(mesh)
    n = x.shape[axis]
    if n % size:
        raise ValueError(f"batch of {n} does not split over {size} data ranks")
    return x.narrow(axis, pos * (n // size), n // size)


def shard_state_of(cfg: ScaleOutConfig, mesh: RankMesh | None, state):
    """This rank's cores' rows of a global state: a `phy.ChannelState`
    (`phy.shard_state`), a `phy.ProcessState` (`phy.shard_pstate`) or a
    `faults.FaultState` (`faults.shard_fstate`); None passes through."""
    if state is None:
        return None
    sh = _shard_of(cfg, mesh)
    cut = (phy.shard_pstate if isinstance(state, phy.ProcessState)
           else _faults.shard_fstate if isinstance(state, _faults.FaultState)
           else phy.shard_state)
    return cut(state, sh.tx * sh.cores, sh.cores)


def shard_inputs(cfg: ScaleOutConfig, mesh: RankMesh | None, protos: torch.Tensor,
                 queries: torch.Tensor, state=None, *, slots: bool = False, fstate=None):
    """This rank's inputs of a serve (the reference's ``in_specs``) from the
    global ones: its model rank's classes of ``protos`` [C, d|W] (of every
    tenant of a store [T, C, d|W] with ``slots``), its rows and model column
    of ``queries`` [B, S, e_per, ...] (of every slot's [N, B, S, e_per, ...]
    with ``slots``; `make_queries` at ``model_size=S``) and its cores' rows
    of ``state``, a channel or process state (`shard_state_of`; None passes
    through). Returns (protos, queries, state), and the rank's rows of a
    fault state last when ``fstate`` is given (global: `faults.healthy_for`
    at ``model_size=S``)."""
    sh = _shard_of(cfg, mesh)
    lead = 1 if slots else 0
    c_l = cfg.n_classes // sh.model_size
    protos = protos.narrow(lead, sh.tx * c_l, c_l)
    if queries.shape[lead + 1] != sh.model_size:
        raise ValueError(f"queries {tuple(queries.shape)} have {queries.shape[lead + 1]} "
                         f"model columns, the mesh {sh.model_size}")
    queries = shard_batch(mesh, queries, lead).narrow(lead + 1, sh.tx, 1)
    out = (protos, queries, shard_state_of(cfg, mesh, state))
    return out if fstate is None else out + (shard_state_of(cfg, mesh, fstate),)


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
