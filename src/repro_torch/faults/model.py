"""Hard-fault injection for the OTA serve: the chaos layer (counterpart of
`repro/faults/model.py`; see there for the physics).

The PHY processes model soft degradation that a re-fit recovers. This module
models the failures no re-fit recovers, which the paper's scale-out (64 to
1024 IMC cores) makes a certainty:

* **wire faults**: ``dead_tx`` (permanent) and ``vote_drop`` (this step's,
  redrawn by the fault model) erase encoder slots. On the vote wire an
  erased slot votes exactly 0, so ``tally > 0`` is the majority of the live
  voters (even live counts tie to 0). On the combo wire an erased encoder
  is a stuck carrier: its bit is forced 0, and `recenter_state` re-fits the
  decision centroids over the combos that still occur.
* **node faults**: ``dead_rx`` cores answer nothing (their received copy
  is zeroed). ``serve_rows`` is the failover: bank i is searched with the
  query copy of core ``serve_rows[i]`` (`plan_failover` deals dead banks
  round-robin over the healthy cores); ``rx_mask`` drops banks that no
  healthy core can serve from the top-1.
* **memory faults**: ``stuck0``/``stuck1`` are per-core packed column masks
  forcing stored prototype bits to 0/1 (applied to the stored, permuted
  rows); `sample_word_dropout` loses whole words.

Every leaf is a tensor on the serve's device; packed masks are int32 words
with the bits of the reference's uint32. With `healthy_state` every
application in the serve is a value identity, so the fault-aware serve
equals the fault-free one bit for bit.

Randomness. The reference folds a fixed fault key by ``t``. The port's
models and samplers draw from the fault process's own `torch.Generator`,
so fault evolution never consumes the serve or process streams; ``draws=``
takes the draws from outside instead (the tests replay JAX's). ``t`` stays
on the device, and no step reads a value back to the host.

Over ranks (the counterpart of the reference's ``fstate_spec``) a model rank
holds its own cores' rows of ``dead_rx``, ``stuck0``, ``stuck1``,
``serve_rows`` and ``rx_mask`` (`shard_fstate`) and the whole ``dead_tx``,
``vote_drop`` and ``t``: every column needs the global live-voter count.
``serve_rows`` keeps global core ids (failover never leaves a shard, so a
rank's rows name its own cores). A model steps its rows with
``step(..., rx_base=, n_rx=)``: the draws span the global rows, made on
generators seeded alike on every rank, and the rank keeps its own, so its
rows equal the one-rank state's. On one rank the model axis has size 1:
``m_slots = m_tx`` and one shard holds every core (``cores_per_shard =
n_rx_cores``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import hypervector as hv, ota
from repro_torch.distributed import collectives
from repro_torch.phy.channel import ChannelState
from repro_torch.phy.process import draw_rows


@dataclasses.dataclass(frozen=True)
class FaultState:
    """Every injected hard fault, [N] RX leading. ``m_slots`` covers every
    encoder slot; ``serve_rows`` holds core ids (identity: no remap)."""

    dead_tx: torch.Tensor     # [m_slots] bool — permanently dark encoder slots
    vote_drop: torch.Tensor   # [m_slots] bool — this step's transient erasures
    dead_rx: torch.Tensor     # [N] bool — dark IMC cores (answer no query)
    stuck0: torch.Tensor      # [N, W] int32 words — prototype bits stuck at 0
    stuck1: torch.Tensor      # [N, W] int32 words — prototype bits stuck at 1
    serve_rows: torch.Tensor  # [N] int32 — failover: bank i served by this core
    rx_mask: torch.Tensor     # [N] bool — banks with no healthy server
    t: torch.Tensor           # [] int32 — fault-process time

    FIELDS = ("dead_tx", "vote_drop", "dead_rx", "stuck0", "stuck1", "serve_rows",
              "rx_mask", "t")

    @property
    def n_rx(self) -> int:
        return self.dead_rx.shape[0]

    @property
    def m_slots(self) -> int:
        return self.dead_tx.shape[0]

    @property
    def words(self) -> int:
        return self.stuck0.shape[-1]


def healthy_state(n_rx: int, m_slots: int, words: int,
                  device: str | torch.device | None = "cuda") -> FaultState:
    """The all-healthy FaultState: serving through it equals the fault-free
    serve bit for bit."""
    dev = _device.resolve(device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return FaultState(
        dead_tx=zeros((m_slots,), torch.bool),
        vote_drop=zeros((m_slots,), torch.bool),
        dead_rx=zeros((n_rx,), torch.bool),
        stuck0=zeros((n_rx, words), torch.int32),
        stuck1=zeros((n_rx, words), torch.int32),
        serve_rows=torch.arange(n_rx, dtype=torch.int32, device=dev),
        rx_mask=zeros((n_rx,), torch.bool),
        t=zeros((), torch.int32),
    )


def healthy_for(cfg, device: str | torch.device | None = "cuda", *,
                model_size: int = 1) -> FaultState:
    """`healthy_state` sized for a `ScaleOutConfig` on a model axis of
    ``model_size`` ranks: ``m_slots = model_size * ceil(M / model_size)``,
    every encoder slot of the serve (the empty ones abstain). The global
    state: `shard_fstate` cuts a rank's rows."""
    m_slots = model_size * -(-cfg.m_tx // model_size)
    return healthy_state(cfg.n_rx_cores, m_slots, cfg.words, device)


def fstate_shape_structs(n_rx: int, m_slots: int, words: int, device="meta") -> FaultState:
    """An empty `FaultState` on ``device`` (meta by default; fake under a
    FakeTensorMode): the shapes and dtypes of `healthy_state` (the stuck
    masks int32 words, the reference's uint32 bits), for the dry run's
    ``serve_faulty`` cells (the reference's ``fstate_shape_structs``)."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    return FaultState(
        dead_tx=empty((m_slots,), torch.bool), vote_drop=empty((m_slots,), torch.bool),
        dead_rx=empty((n_rx,), torch.bool), stuck0=empty((n_rx, words), torch.int32),
        stuck1=empty((n_rx, words), torch.int32), serve_rows=empty((n_rx,), torch.int32),
        rx_mask=empty((n_rx,), torch.bool), t=empty((), torch.int32))


RX_LEAVES = ("dead_rx", "stuck0", "stuck1", "serve_rows", "rx_mask")   # [N]-leading


def shard_fstate(fstate: FaultState, rx_base: int, n_cores: int) -> FaultState:
    """The fault state of cores [rx_base, rx_base + n_cores): the RX-leading
    leaves cut to those rows (``serve_rows`` keeps global core ids),
    ``dead_tx``, ``vote_drop`` and ``t`` whole (the counterpart of the
    reference's ``fstate_spec``)."""
    if rx_base < 0 or rx_base + n_cores > fstate.n_rx:
        raise ValueError(f"cores [{rx_base}, {rx_base + n_cores}) outside the state's "
                         f"{fstate.n_rx}")
    return dataclasses.replace(fstate, **{f: getattr(fstate, f)[rx_base:rx_base + n_cores]
                                          for f in RX_LEAVES})


def gather_fstate(fstate: FaultState, group) -> FaultState:
    """Every model rank's rows of ``fstate`` in rank order (the global
    state; ``group=None``: the state itself), for the failover planning at
    the step barrier. Every rank of the group must call it."""
    if group is None:
        return fstate
    got = collectives.gather_rows([getattr(fstate, f) for f in RX_LEAVES], group)
    return dataclasses.replace(fstate, **dict(zip(RX_LEAVES, got)))


def _coerce(ref: torch.Tensor, name: str, val) -> torch.Tensor:
    if ref.dtype == torch.bool and not isinstance(val, torch.Tensor):
        arr = np.asarray(val)
        if arr.dtype != np.bool_ or arr.shape != tuple(ref.shape):
            mask = np.zeros(tuple(ref.shape), bool)   # an index list
            mask[arr.astype(np.int64)] = True
            arr = mask
        val = arr
    elif not isinstance(val, torch.Tensor):
        arr = np.array(val, order="C")
        val = arr.view(np.int32) if arr.dtype == np.uint32 else arr   # words keep their bits
    val = torch.as_tensor(val).to(device=ref.device, dtype=ref.dtype)
    if val.shape != ref.shape:
        raise ValueError(f"{name}: shape {tuple(val.shape)} != the state's {tuple(ref.shape)}")
    return val


def inject(fstate: FaultState, **leaves) -> FaultState:
    """Replace fault leaves, coerced to the state's dtypes and device.

    ``inject(f, dead_rx=[0, 3])`` takes index lists for the bool masks
    (dead_tx, vote_drop, dead_rx, rx_mask) or full arrays/tensors for any
    leaf; numpy uint32 words become int32 words with the same bits. Shapes
    must match the state's."""
    return dataclasses.replace(fstate, **{
        name: _coerce(getattr(fstate, name), name, val) for name, val in leaves.items()})


# ---------------------------------------------------------------------------
# memory-fault samplers
# ---------------------------------------------------------------------------

def _need(generator: torch.Generator | None) -> torch.Generator:
    """A draw's generator: fault sampling never falls back on torch's global one."""
    if generator is None:
        raise ValueError("this fault draw needs a torch.Generator (or pass the draws)")
    return generator


def sample_stuck_cells(generator: torch.Generator | None, n_rx: int, words: int,
                       density: float, *, masks=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(stuck0, stuck1) [N, W] int32 masks at total cell density ``density``,
    split evenly between the two rails and disjoint (a cell has one
    conductance): two `hv.bernoulli_words` draws at density/2, the second
    cleared where the first is set. ``masks`` = the two raw draws, for
    replay."""
    if masks is None:
        g = _need(generator)
        masks = tuple(hv.bernoulli_words(g, density / 2.0, (n_rx, words)) for _ in range(2))
    s0, s1 = masks
    return s0, s1 & ~s0


def sample_word_dropout(generator: torch.Generator | None, n_rx: int, words: int,
                        p_word: float, *, drop: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-word dropout as a stuck-at-0 mask [N, W] int32: each stored
    word is lost (all 32 bits 0, a dead word line) with probability
    ``p_word``; every word is 0 or -1 (all bits). OR it into ``stuck0``.
    ``drop`` [N, W] bool, for replay."""
    if drop is None:
        g = _need(generator)
        drop = torch.rand((n_rx, words), generator=g, device=g.device) < p_word
    return -drop.to(torch.int32)


# ---------------------------------------------------------------------------
# failover planning (host side; the FaultController's remap action)
# ---------------------------------------------------------------------------

def plan_failover(fstate: FaultState, cores_per_shard: int) -> FaultState:
    """Re-deal every dead core's class bank onto healthy cores of its shard.

    Dead banks go round-robin over the shard's healthy cores (each healthy
    core keeps serving its own bank too); a shard with no healthy core
    left gets its banks ``rx_mask``-ed out of the top-1. Failover never
    crosses a shard. Host-side numpy: the result feeds the same serve,
    whose ``serve_rows`` and ``rx_mask`` are plain inputs."""
    dead = fstate.dead_rx.cpu().numpy()
    n = dead.shape[0]
    if n % cores_per_shard:
        raise ValueError(f"{n} cores do not split into shards of {cores_per_shard}")
    rows = np.arange(n, dtype=np.int32)
    mask = np.zeros(n, bool)
    for lo in range(0, n, cores_per_shard):
        sl = slice(lo, lo + cores_per_shard)
        healthy = np.flatnonzero(~dead[sl])
        if healthy.size == 0:
            mask[sl] = True
            continue
        for j, i in enumerate(np.flatnonzero(dead[sl])):
            rows[lo + i] = lo + healthy[j % healthy.size]
    return inject(fstate, serve_rows=rows, rx_mask=mask)


# ---------------------------------------------------------------------------
# combo-wire (symbol tier) erasure support
# ---------------------------------------------------------------------------

def live_combo_mask(dead_slots, m_tx: int) -> torch.Tensor:
    """[2^M] bool: the combos that can occur on the wire when the erased
    encoders radiate their bit-0 phase (their combo bit forced 0)."""
    dead = torch.as_tensor(dead_slots, dtype=torch.bool)[:m_tx]
    combos = ota.bit_combos(m_tx, dead.device).bool()         # [B, M]
    return ~(combos & dead[None, :]).any(-1)


def live_majority_labels(dead_slots, m_tx: int) -> torch.Tensor:
    """maj(b) over the live encoders' bits only, [2^M] uint8: what the
    erasure-aware receiver decodes (even live counts tie to 0)."""
    live = (~torch.as_tensor(dead_slots, dtype=torch.bool)[:m_tx]).to(torch.int32)
    combos = ota.bit_combos(m_tx, live.device).to(torch.int32)
    counts = (combos * live[None, :]).sum(-1)
    return (2 * counts > live.sum()).to(torch.uint8)


def recenter_state(state: ChannelState, dead_slots) -> ChannelState:
    """Erasure-aware re-fit of the symbol tier's decision regions: c0/c1
    re-fit (`ota.majority_centroids` with a mask) over the combos that
    occur, labelled by the live majority. The caller runs it; the serve
    does not."""
    dead = torch.as_tensor(dead_slots, dtype=torch.bool, device=state.symbols.device)
    maj = live_majority_labels(dead, state.m_tx)
    mask = live_combo_mask(dead, state.m_tx)
    c0, c1 = ota.majority_centroids(state.symbols, maj, mask=mask)
    return dataclasses.replace(state, c0=c0.to(torch.complex64), c1=c1.to(torch.complex64))


# ---------------------------------------------------------------------------
# fault models (the evolution laws) and their registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One stochastic evolution law of the injected faults between serve
    steps. ``step(generator, f, draws=None)`` advances the state one step,
    drawing from ``generator`` (the fault process's own) or taking
    ``draws``; the serve calls it once a step, every slot sharing it."""

    name = "?"

    def init(self, n_rx: int, m_slots: int, words: int,
             device: str | torch.device | None = "cuda") -> FaultState:
        return healthy_state(n_rx, m_slots, words, device)

    def step(self, generator: torch.Generator | None, f: FaultState, *,
             draws: dict | None = None, rx_base: int = 0,
             n_rx: int | None = None) -> FaultState:
        """One step. On a model rank ``f`` holds rows [rx_base, rx_base +
        cores) of ``n_rx`` cores (`shard_fstate`); row draws span them all."""
        return dataclasses.replace(f, t=f.t + 1)


@dataclasses.dataclass(frozen=True)
class StaticFaults(FaultModel):
    """Frozen faults: `step` only advances ``t`` and draws nothing, so
    through `healthy_state` the serve equals the fault-free serve."""

    name = "static"


@dataclasses.dataclass(frozen=True)
class TransientVoteFaults(StaticFaults):
    """Per-step wire erasures: each encoder slot's vote drops out of this
    step's superposition with probability ``p_drop``, redrawn every step.
    ``draws={"vote_drop": [m_slots] bool}`` replays a draw. Node and memory
    leaves pass through. Every rank draws the same [m_slots] (its
    ``vote_drop`` is whole)."""

    name = "transient_votes"
    p_drop: float = 0.05

    def step(self, generator, f, *, draws=None, rx_base=0, n_rx=None):
        drop = (draws or {}).get("vote_drop")
        if drop is None:
            g = _need(generator)
            drop = torch.rand(f.vote_drop.shape, generator=g, device=g.device) < self.p_drop
        return dataclasses.replace(f, vote_drop=drop.to(device=f.t.device, dtype=torch.bool),
                                   t=f.t + 1)


@dataclasses.dataclass(frozen=True)
class WearoutFaults(FaultModel):
    """Permanent accumulation: each core dies with probability ``p_die`` a
    step and each stored cell sticks with probability ``stuck_rate`` a step
    (split evenly between the rails; faults only accrue). The controller's
    remap, not this model, updates ``serve_rows``/``rx_mask``.
    ``draws={"die": [N] bool, "stuck0": [N, W], "stuck1": [N, W] words}``
    replays a step's draws (global rows on a model rank)."""

    name = "wearout"
    p_die: float = 0.001
    stuck_rate: float = 1e-4

    def step(self, generator, f, *, draws=None, rx_base=0, n_rx=None):
        draws = draws or {}
        n, words = f.n_rx, f.words
        n_all = n if n_rx is None else n_rx
        if draws:
            die, s0, s1 = draws["die"], draws["stuck0"], draws["stuck1"]
        else:
            g = _need(generator)
            die = torch.rand((n_all,), generator=g, device=g.device) < self.p_die
            s0, s1 = (hv.bernoulli_words(g, self.stuck_rate / 2.0, (n_all, words))
                      for _ in range(2))
        die, s0, s1 = (draw_rows(x, rx_base, n) for x in (die, s0, s1))
        stuck0 = f.stuck0 | s0
        return dataclasses.replace(f, dead_rx=f.dead_rx | die, stuck0=stuck0,
                                   stuck1=(f.stuck1 | s1) & ~stuck0, t=f.t + 1)


FAULTS: dict[str, type] = {}


def register_fault_model(cls: type, *, override: bool = False) -> type:
    """Register a `FaultModel` subclass under ``cls.name`` for
    `get_fault_model` (usable as a class decorator); a taken name raises
    unless ``override=True``."""
    name = getattr(cls, "name", None)
    if not isinstance(name, str) or not name or name == "?":
        raise ValueError(f"fault model must define a non-empty .name, got {name!r}")
    if not callable(getattr(cls, "step", None)):
        raise TypeError(f"fault model {name!r} does not implement step()")
    if name in FAULTS and not override:
        raise ValueError(f"fault model {name!r} already registered; pass override=True "
                         "to replace it")
    FAULTS[name] = cls
    return cls


for _f in (StaticFaults, TransientVoteFaults, WearoutFaults):
    register_fault_model(_f)
del _f


def get_fault_model(name: str, **kwargs) -> FaultModel:
    """Instantiate a registered fault model by name (kwargs to its constructor)."""
    try:
        cls = FAULTS[name]
    except KeyError:
        raise ValueError(f"unknown fault model {name!r}; available: {sorted(FAULTS)}") from None
    return cls(**kwargs)
