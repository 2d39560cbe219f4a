"""The OTA majority as collectives over `torch.distributed` (counterpart of
`repro/distributed/collectives.py`): the per-receiver binary symmetric
channel, the guard-bit packed vote all-reduce and reduce-scatter, the sparse
index-list all-gather, the majority all-reduce and the sign-majority vote of
the gradients; and the tensor-parallel autograd ops of sharded training
(`copy_to_group`, `reduce_from_group`, `gather_from_group`, `vocab_embed`),
the explicit collectives that stand where the reference's GSPMD inserts
its own. Their wire dtypes: an activation all-reduce travels in f32 for a
bf16 tensor (`_wire_of`), a parameter's all-gather and its gradient's
reduce-scatter in the tensor's own dtype.

Every collective takes a ``group``: a `torch.distributed` process group over
the ranks of one mesh axis (`repro_torch.distributed.mesh.RankMesh.group`), or
``None`` for an axis of one rank, where nothing is sent and the reduction
is the rank's own value. The backend is the group's: NCCL across GPUs, gloo
for ranks that share one GPU or run on the CPU. Both take the payload on
the tensor's own device (gloo takes CUDA tensors for all three operations
used here), so no payload is staged by this module.

A per-process counter adds up the bytes each call moves, as operand plus
result bytes: an all-reduce of N bytes counts 2N, an all-gather of N bytes
over S ranks N + S*N, a reduce-scatter of N bytes N + N/S (the counting of
`repro/analysis/hlo_cost.py`). `wire_bytes` reads the total,
`wire_bytes_by_op` the bytes of each collective type (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``, as the reference's HLO
names them) and
`wire_bytes_by_axis` those of each mesh axis (the axis whose group carried
the call, as `distributed.mesh.make_mesh` labels its groups with
`label_group`; ``"other"`` for a group it did not make), and
`reset_wire_bytes` sets all three to 0. It counts the serve's collectives only:
the step barrier's host-side helpers (`gather_rows`, `SharedClock`), the
SPMD counterpart of the reference's single controller, are not counted.

Packed lanes are uint32 words in the reference. Neither gloo nor NCCL
reduces torch.uint32, so the lanes travel as int32 with the same bits: the
int32 sum wraps modulo 2^32, which is the uint32 sum bit for bit (a lane's
fields never carry into each other, so the true sum is below 2^32).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core import hypervector as hv

_by_op: dict[str, int] = {}      # bytes moved by this process's collectives, by type
_by_axis: dict[str, int] = {}    # ... and by the mesh axis of the group that carried them
_axis_of: dict = {}              # process group -> its mesh axis (`label_group`)


def label_group(group, axis: str) -> None:
    """Name the mesh axis ``group`` runs along, for `wire_bytes_by_axis`
    (`distributed.mesh.make_mesh` labels every group it makes)."""
    _axis_of[group] = axis


def _count(op: str, nbytes: int, group) -> None:
    _by_op[op] = _by_op.get(op, 0) + nbytes
    axis = _axis_of.get(group, "other")
    _by_axis[axis] = _by_axis.get(axis, 0) + nbytes


def wire_bytes() -> int:
    """Bytes this process's collectives moved since the last reset."""
    return sum(_by_op.values())


def wire_bytes_by_op() -> dict[str, int]:
    """`wire_bytes` by collective type: {"all-reduce": n, "all-gather": n,
    "reduce-scatter": n, "all-to-all": n} (types that moved nothing are
    left out)."""
    return dict(_by_op)


def wire_bytes_by_axis() -> dict[str, int]:
    """`wire_bytes` by the mesh axis of the carrying group ("pod", "data",
    "model", or "other" for an unlabelled group)."""
    return dict(_by_axis)


def reset_wire_bytes() -> int:
    """Set the byte counters to 0; returns the total they held."""
    held = wire_bytes()
    _by_op.clear()
    _by_axis.clear()
    return held


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ranks(group) -> int:
    """Ranks in ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, wire_dtype: torch.dtype | None = None
               ) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks, in x's dtype, sent as
    ``wire_dtype`` (default x's): a new tensor, x is left as it was."""
    if group is None:
        return x
    buf = x.to(wire_dtype or x.dtype, copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    _count("all-reduce", 2 * _nbytes(buf), group)
    return buf.to(x.dtype)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: [S, *x.shape]."""
    if group is None:
        return x[None]
    flat = x.reshape(-1).contiguous()
    out = torch.empty((ranks(group) * flat.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    _count("all-gather", _nbytes(flat) + _nbytes(out), group)
    return out.reshape((-1,) + tuple(x.shape))


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather tiled along the last axis: [..., n] -> [..., S*n], rank s's
    block at [s*n, (s+1)*n)."""
    g = all_gather(x, group)                                   # [S, ..., n]
    return g.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (-1,))


def reduce_scatter_last(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks scattered along the last axis: [..., n] ->
    this rank's contiguous block [..., n/S] of the sum."""
    if group is None:
        return x
    s = ranks(group)
    n = x.shape[-1]
    if n % s:
        raise ValueError(f"reduce-scatter of {n} elements over {s} ranks does not tile")
    inp = x.reshape(tuple(x.shape[:-1]) + (s, n // s)).movedim(-2, 0).contiguous()
    out = torch.empty((inp.numel() // s,), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, inp.reshape(-1), group=group)
    _count("reduce-scatter", _nbytes(inp) + _nbytes(out), group)
    return out.reshape(tuple(inp.shape[1:]))


# ---------------------------------------------------------------------------
# the step barrier's host-side helpers (not counted as wire bytes)
# ---------------------------------------------------------------------------

def gather_rows(xs: list, group) -> list:
    """Every rank's rows of each tensor of ``xs`` (each [n, ...], n the same
    for all) concatenated in rank order: [S*n, ...] each (``group=None``:
    the tensors themselves). A model rank's [N/S] leaves of the process or
    fault state become the global [N] ones, so every rank takes the
    host-side decisions of the step barrier on the same values. The leaves
    travel as their bytes in one all-gather (bool as uint8)."""
    if group is None:
        return list(xs)
    n = xs[0].shape[0]
    flat = [(x.to(torch.uint8) if x.dtype == torch.bool else x).reshape(n, -1).contiguous()
            for x in xs]
    byts = [f.view(torch.uint8) for f in flat]
    wire = torch.cat(byts, 1)
    out = torch.empty((ranks(group) * n, wire.shape[1]), dtype=torch.uint8, device=wire.device)
    dist.all_gather_into_tensor(out, wire, group=group)
    got, lo = [], 0
    for x, f, b in zip(xs, flat, byts):
        part = out[:, lo:lo + b.shape[1]].contiguous().view(f.dtype)
        part = part.reshape((-1,) + tuple(x.shape[1:]))
        got.append(part.to(torch.bool) if x.dtype == torch.bool else part)
        lo += b.shape[1]
    return got


class SharedClock:
    """A clock every rank reads alike: each call returns rank 0's reading of
    ``clock`` (a float), broadcast over ``group`` (the world when None). The
    scheduler on ranks reads it, so its admissions, requeues, deadline
    evictions and timestamps are the same on every rank (the ranks then
    call the same collectives in the same order). Every rank must call it
    the same number of times."""

    def __init__(self, clock, group=None):
        self.clock = clock
        self.group = group

    def __call__(self) -> float:
        dev = "cuda" if dist.get_backend(self.group) == "nccl" else "cpu"
        t = torch.tensor([self.clock()], dtype=torch.float64, device=dev)
        dist.broadcast(t, src=dist.get_global_rank(self.group, 0) if self.group else 0,
                       group=self.group)
        return float(t[0])


# ---------------------------------------------------------------------------
# the per-receiver binary symmetric channel
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# guard-bit packed vote all-reduce
#
# The int8 vote all-reduce sends 1 byte per dimension though the tally only
# spans [-S*e_per, S*e_per]. Bias each vote to non-negative, give every field
# enough bits that the summed field cannot carry into its neighbour, pack k
# fields per 32-bit lane, reduce the lanes once, unpack, un-bias: the tally
# equals the int8 one bit for bit at 32/(8k) of its bytes.
# ---------------------------------------------------------------------------

def vote_field_spec(group_size: int, e_per: int = 1, pow2_fields: bool = False,
                    n_active: int | None = None) -> tuple[int, int]:
    """(field_bits, fields_per_lane) of the guard-bit packed vote reduction.

    ``group_size`` ranks each contribute a vote in [-e_per, e_per], so the
    biased tally spans [0, 2*group_size*e_per] and needs ``ceil(log2(span +
    1))`` bits; ``k = 32 // field_bits`` fields fill a lane, rounded down to
    a power of two with ``pow2_fields`` (the reduce-scatter needs whole lanes
    to tile the ranks). With ``n_active`` only that many voters are live in
    the whole group, so the span is [-n_active, n_active] whatever the
    group's width (the slot-aware fields: 3 bits, k = 10 at M = 3); the
    callers then bias each rank by its own live count."""
    span = 2 * (group_size * e_per if n_active is None else n_active)
    fbits = max(1, span.bit_length())
    k = 32 // fbits
    if k < 1:
        raise ValueError(f"vote span {span} does not fit a 32-bit lane")
    if pow2_fields:
        k = 1 << (k.bit_length() - 1)
    return fbits, k


def _to_i32(lanes: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(lanes >= 2**31, lanes - 2**32, lanes).to(torch.int32)


def _pack_vote_fields(votes: torch.Tensor, bias, fbits: int, k: int) -> torch.Tensor:
    """Bias int votes [..., d] by ``bias`` (non-negative: an int or a tensor
    broadcasting against the votes' leading axes) and pack k fields per
    int32 lane: [..., ceil(d/k)]. Field i of lane j holds element j*k + i at
    bit i*fbits; the d % k padding holds the bias, a zero vote."""
    d = votes.shape[-1]
    pad = (-d) % k
    biased = votes.to(torch.int64) + torch.as_tensor(bias, dtype=torch.int64,
                                                     device=votes.device)
    if pad:
        fill = torch.as_tensor(bias, dtype=torch.int64, device=votes.device)
        fill = fill.expand(tuple(votes.shape[:-1]) + (pad,))
        biased = torch.cat([biased, fill], dim=-1)
    blocks = biased.reshape(tuple(biased.shape[:-1]) + (-1, k))
    shifts = torch.arange(k, dtype=torch.int64, device=votes.device) * fbits
    return _to_i32((blocks << shifts).sum(-1))


def _unpack_vote_fields(lanes: torch.Tensor, d: int, bias, fbits: int, k: int
                        ) -> torch.Tensor:
    """Inverse of `_pack_vote_fields` after the reduction: the int32 tally
    [..., d], ``bias`` being the accumulated offset of a field."""
    u = lanes.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(k, dtype=torch.int64, device=lanes.device) * fbits
    fields = (u[..., None] >> shifts) & ((1 << fbits) - 1)
    flat = fields.reshape(tuple(lanes.shape[:-1]) + (-1,))[..., :d]
    return (flat - torch.as_tensor(bias, dtype=torch.int64, device=lanes.device)
            ).to(torch.int32)


def _biases(group_size: int, e_per: int, n_active, local_active, total_active):
    """(this rank's bias, the accumulated bias the unpack subtracts)."""
    if n_active is None:
        return e_per, group_size * e_per
    if local_active is None:
        raise ValueError("slot-aware packing needs local_active")
    return local_active, n_active if total_active is None else total_active


def packed_vote_allreduce(votes: torch.Tensor, group, *, group_size: int | None = None,
                          e_per: int = 1, n_active: int | None = None, local_active=None,
                          total_active=None) -> torch.Tensor:
    """Guard-bit packed vote all-reduce: int votes [..., d] -> int32 tally
    [..., d], equal to the int8 all-reduce of the votes bit for bit, while
    ``ceil(d/k)`` 32-bit lanes travel instead of d bytes.

    Slot-aware fields (``n_active`` + ``local_active``): when only
    ``n_active`` voters of the whole group are live (the others vote exactly
    0), the fields shrink to the [-n_active, n_active] span and each rank
    biases by ``local_active``, its own live count (an int or a 0-d
    tensor). The caller's contract: |votes| <= local_active elementwise and
    the group's sum of local_active is n_active. ``total_active`` replaces
    n_active as the subtracted bias when fewer voters are live than the
    fields were sized for (erased voters); the wire format does not change.

    ``group_size`` defaults to the group's size; on ``group=None`` (one
    rank) the votes are packed and unpacked with nothing sent."""
    s = ranks(group) if group_size is None else group_size
    fbits, k = vote_field_spec(s, e_per, n_active=n_active)
    bias, total_bias = _biases(s, e_per, n_active, local_active, total_active)
    lanes = all_reduce(_pack_vote_fields(votes, bias, fbits, k), group)
    return _unpack_vote_fields(lanes, votes.shape[-1], total_bias, fbits, k)


def packed_vote_psum_scatter(votes: torch.Tensor, group, *, group_size: int | None = None,
                             e_per: int = 1, n_active: int | None = None, local_active=None,
                             total_active=None) -> torch.Tensor:
    """Guard-bit packed reduce-scatter of votes along their last axis: this
    rank's contiguous tally block [..., d/S] int32, equal to the int8
    reduce-scatter's bit for bit. The fields per lane are rounded down to a
    power of two so whole lanes tile the ranks; where d does not divide into
    k*S the votes are reduce-scattered as they are (int8 while the span fits
    int8, else int32), with no saving. ``n_active``, ``local_active`` and
    ``total_active`` are those of `packed_vote_allreduce`."""
    s = ranks(group) if group_size is None else group_size
    d = votes.shape[-1]
    fbits, k = vote_field_spec(s, e_per, pow2_fields=True, n_active=n_active)
    if d % (k * s):
        wire = votes if s * e_per <= 127 else votes.to(torch.int32)
        return reduce_scatter_last(wire, group).to(torch.int32)
    bias, total_bias = _biases(s, e_per, n_active, local_active, total_active)
    part = reduce_scatter_last(_pack_vote_fields(votes, bias, fbits, k), group)
    return _unpack_vote_fields(part, d // s, total_bias, fbits, k)


def sparse_index_allgather(idx: torch.Tensor, group) -> torch.Tensor:
    """The index-list wire of the sparse OTA majority: this rank's ``e``
    encoder slots idx int32 [..., e, k_max] -> every rank's [..., S*e,
    k_max], slot s*e + j holding rank s's slot j (the reference's
    shard-major order, global encoder ids ``tx*e + j``)."""
    g = all_gather(idx, group)                                 # [S, ..., e, k]
    g = g.movedim(0, -3)                                       # [..., S, e, k]
    return g.reshape(tuple(g.shape[:-3]) + (-1, g.shape[-1]))


def majority_allreduce(bits: torch.Tensor, group, *, generator: torch.Generator | None = None,
                       ber=None) -> torch.Tensor:
    """OTA majority over the group's ranks: uint8 {0,1} bits -> the strict
    majority (even group sizes tie to 0), one int32 all-reduce of the
    bipolar votes. With ``ber`` the received copy goes through this rank's
    BSC, drawn from ``generator``."""
    votes = all_reduce(2 * bits.to(torch.int32) - 1, group)
    out = (votes > 0).to(torch.uint8)
    if ber is not None:
        if generator is None:
            raise ValueError("majority_allreduce: OTA noise needs a generator")
        out = ota_noise(generator, out, ber)
    return out


def sign_allreduce(x: torch.Tensor, group=None, *, generator: torch.Generator | None = None,
                   ber: float | None = None) -> torch.Tensor:
    """Majority-vote sign aggregation of a gradient, in x's dtype: the sign
    of the f32 sum of every rank's sign(x), in {-1, 0, +1} (on one rank,
    ``group=None``, its own sign). With ``ber`` the received vote goes
    through the OTA channel: each element flips sign with probability
    ``ber``, drawn from ``generator`` as `ota_noise` draws its flips (a zero
    stays zero). ``group`` may be a tuple of groups (the pod and data axes),
    the vote then summing over all of them. The votes travel as int8 (the
    tally of at most 127 ranks fits; int32 beyond), 1 byte an element where
    the reference's psum carries f32: the same tally, a quarter of the
    bytes."""
    groups = tuple(group) if isinstance(group, (tuple, list)) else (group,)
    n = math.prod(ranks(g) for g in groups)
    votes = torch.sign(x).to(torch.int8 if n <= 127 else torch.int32)
    out = torch.sign(all_reduce_groups(votes, groups))
    if ber is not None:
        if generator is None:
            raise ValueError("sign_allreduce: OTA noise needs a generator")
        out = torch.where(hv._bernoulli(generator, ber, out.shape, out.device), -out, out)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# collectives along a dimension, and the tensor-parallel autograd ops
# ---------------------------------------------------------------------------

def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    return torch.cat(all_gather(x, group).unbind(0), dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over the group's ranks, this rank's contiguous block of ``dim``
    (of size x.shape[dim] / S)."""
    if group is None:
        return x
    return reduce_scatter_last(x.movedim(dim, -1), group).movedim(-1, dim).contiguous()


def all_to_all_dim(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    """Re-cut ``x`` over the group: ``split_dim`` into S contiguous blocks,
    block j sent to rank j, and the blocks received concatenated along
    ``cat_dim`` in rank order (a cache cut by heads becomes one cut by
    sequence: [.., S_seq, KH/S, ..] -> [.., S_seq/S, KH, ..])."""
    if group is None:
        return x
    s = ranks(group)
    n = x.shape[split_dim]
    if n % s:
        raise ValueError(f"all-to-all of {n} entries over {s} ranks does not tile")
    inp = torch.stack(x.chunk(s, split_dim)).contiguous()          # [S, ..., n/S, ...]
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    _count("all-to-all", _nbytes(inp) + _nbytes(out), group)
    return torch.cat(out.unbind(0), cat_dim)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum over the group's ranks (a new tensor)."""
    if group is None:
        return x
    buf = x.clone().contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    _count("all-reduce", 2 * _nbytes(buf), group)
    return buf


def _wire_of(x: torch.Tensor) -> torch.dtype:
    """The wire dtype of an activation all-reduce: f32 for a half-precision
    tensor. Each rank's partial is already rounded once to the model's
    dtype by its matmul; the sum of the S partials is then rounded once
    more, as one rank's product rounds its f32 accumulator once, where a
    bf16 wire would round at every step of the reduction, in an order the
    backend picks."""
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: the input of a
    column-split projection, whose ranks each add their part of the input's
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, _wire_of(g)), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the output of a
    row-split projection, each rank holding a partial sum."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group, _wire_of(x))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather forward along ``dim``, reduce-scatter backward: a
    parameter cut over the data ranks, gathered whole for the step; its
    gradient arrives summed over the ranks, this rank's piece only. The
    reduce-scatter travels in the gradient's dtype (the reference's
    GSPMD reduce-scatter does too)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def sum_both_ways(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, whose backward sums the gradient
    over the group too: partial sums (or a mean's shares) that every rank
    then uses for its own part of the work, so each rank's gradient of them
    is a part of the whole."""
    return copy_to_group(reduce_from_group(x, group), group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """`_CopyToGroup` (x itself when ``group`` is None)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """`_ReduceFromGroup` (x itself when ``group`` is None)."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """`_GatherFromGroup` (x itself when ``group`` is None)."""
    return x if group is None else _GatherFromGroup.apply(x, dim, group)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, start: int, group
                ) -> torch.Tensor:
    """Embedding lookup in a vocabulary cut over ``group``: ``table`` holds
    rows [start, start + V_l) of the vocabulary; each rank looks up the
    tokens it holds (zero rows for the others) and the sum over the group
    (`reduce_from_group`) is the whole lookup. Its backward reaches only
    the rows this rank holds."""
    if group is None:
        return table[tokens]
    local = tokens.long() - start
    ok = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(ok, local, 0)] * ok[..., None].to(table.dtype)
    return reduce_from_group(rows, group)


def cut_group(tp, local: int, whole: int):
    """The model group of ``tp`` (a `TensorParallel`, or None) when a width
    is cut over it (the rank's shard holds ``local`` of ``whole``), else
    None."""
    return tp.group if tp is not None and local < whole else None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """Where a rank sits for the model's layers: the ``group`` of its model
    axis (None for one model rank) with its coordinate ``rank`` there, and
    the process groups ``data_groups`` of the data axes its rows are cut
    over (pod first), over which the loss counts its tokens (the global
    batch's mean), with its flat place ``data_index`` there. ``infer``
    marks an inference step: an MoE dispatch group that straddles data
    ranks is then gathered whole over them (`moe.apply`), where training
    refuses it."""

    group: object = None
    rank: int = 0
    data_groups: tuple = ()
    data_index: int = 0
    infer: bool = False


def all_reduce_groups(x: torch.Tensor, groups, wire_dtype: torch.dtype | None = None
                      ) -> torch.Tensor:
    """The sum of ``x`` over the product of ``groups`` (one all-reduce
    each; groups that are None are skipped)."""
    for g in groups:
        x = all_reduce(x, g, wire_dtype)
    return x
