"""HDC-as-a-service: the similarity-search backend of the slot ring
(counterpart of `repro/serving/hdc.py`).

The paper's end state, a wireless-on-chip similarity-search fabric serving
heavy traffic from many users, maps onto the continuous-batching machinery
of `repro_torch.serving.slotring` and `scheduler.SlotScheduler`:

* `TenantRegistry`: many classifier *tenants* resident at once. Each
  tenant's prototype bank is one row of ONE store [max_tenants, C, d|W] on
  the device; onboarding and eviction write or free one row, so the serve
  step never changes shape.
* `HDCEngine`: a `SlotRingEngine` whose state is the per-slot query
  batches, tenant store rows and generators, and whose step is ONE
  `scaleout.make_mt_ota_serve` call: one bundle over every slot's rows,
  the PHY fan-out slot by slot, and one banked search launch over every
  (slot, core[, permuted bank]). Every slot COMPLETES each step, so the
  emission is the (pred, maxsim) pair itself.
* `HDCScheduler`: requests name a tenant, admission scatters the query
  batches into the free slots in one call, and every running slot finishes
  at the step barrier, where the results come to the host once.
* `LinkController` and `AdaptiveHDCEngine`: a living channel served with a
  closed-loop controller at the barrier (EM re-fits, quarantine, fleet-mode
  switches between prebuilt serve variants).
* `FaultController` and `FaultTolerantHDCEngine`: the adaptive engine
  serving through a `faults.FaultState` as well; the controller promotes a
  core quarantined for ``remap_after`` barriers to dead and re-deals its
  bank (`faults.plan_failover`).

Per-slot results equal a standalone `make_ota_serve` of that request
against its tenant's codebook on a generator seeded alike, bit for bit (see
`make_mt_ota_serve`); under faults, a standalone fault-aware serve under
the same fault state.

On a mesh (``mesh=``, a `distributed.mesh.RankMesh`; the reference's
engines take a ``Mesh``) every rank runs the same engine and scheduler on
its shard: the registry holds its classes of every tenant, a slot its data
rows and model column of the queries, the adaptive engines its cores' rows
of the process and fault state, and each step is the multi-rank
`make_mt_ota_serve`. A slot's noise generator on a rank is `rank_generator`
of the request's, the same on every model rank of a data row (the
request's own when the data axes hold one rank, so a 1xS engine completes
every request as the one-rank engine does). At the barrier the rows of the batch are gathered over
the data ranks, so every rank completes the whole batch, and the
controllers decide on the global process and fault state, gathered over the
model ranks (`phy.gather_pstate`, `faults.gather_fstate`): every rank takes
the same action and keeps its own rows of the result. With the scheduler's
shared clock (`collectives.SharedClock`) every rank makes the same
admissions, evictions, re-fits, quarantines, fleet-mode switches and
failover remaps, so the ranks call the same collectives in the same order.

The multi-centroid bank (`multicentroid_bank`, `centroid_to_class`) turns a
codebook into C*k_c class-major rows, served by a `ScaleOutConfig` with
``n_classes = C * k_c``; a prediction ``p`` maps back to class ``p // k_c``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as _device, faults, phy, spans
from repro_torch.core import classifier, hypervector as hv, scaleout
from repro_torch.core.scaleout import ScaleOutConfig, make_mt_ota_serve
from repro_torch.distributed import collectives
from repro_torch.distributed.mesh import RankMesh
from repro_torch.serving import slotring
from repro_torch.serving.scheduler import SlotScheduler


@dataclasses.dataclass
class HDCRequest:
    rid: int
    tenant: Any                  # tenant id (registry key)
    queries: torch.Tensor        # [B, S, e_per, d|W] (S model columns; one rank: [B, 1, M, d|W])
    generator: torch.Generator   # the request's PHY noise stream
    t_submit: float


@dataclasses.dataclass
class HDCCompletion:
    rid: int
    tenant: Any
    pred: np.ndarray             # [B] int32 (baseline) or [B, M] (permuted)
    maxsim: np.ndarray
    t_submit: float
    t_admit: float
    t_finish: float
    status: str = "ok"           # "ok" | "evicted" (deadline-expired slot)
    step: int | None = None      # the scheduler step that served it (`SlotScheduler.step_id`)

    @property
    def latency(self) -> float:
        """Submit-to-finish wall time (includes queueing)."""
        return self.t_finish - self.t_submit


def multicentroid_bank(generator: torch.Generator | None, protos: torch.Tensor, k_c: int,
                       cfg: ScaleOutConfig, **train_kwargs) -> torch.Tensor:
    """Expand a [C, d] uint8 or [C, W] int32 codebook into a class-major
    [C*k_c, d|W] centroid bank (`classifier.train_multicentroid`), in the
    representation ``cfg`` serves: packed int32 words, or unpacked bits.
    Among equidistant centroids a serve picks the lowest flat row, which is
    the lowest (class, centroid) pair, so the tie rule carries over."""
    cents = classifier.train_multicentroid(generator, protos, k_c, **train_kwargs)
    c, _, w = cents.shape
    bank = cents.reshape(c * k_c, w)
    return bank if cfg.packed else hv.unpack(bank, cfg.dim)


def centroid_to_class(pred: torch.Tensor, k_c: int) -> torch.Tensor:
    """Class-major centroid predictions (of a `multicentroid_bank` serve) ->
    class labels, elementwise on any shape."""
    return pred // k_c


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def rank_generator(generator: torch.Generator, mesh: RankMesh | None) -> torch.Generator:
    """This rank's noise generator for a request drawn on ``generator``.
    Every model rank of a data row gets the same one, since the serve's
    noise draws span the global cores and each rank keeps its own
    (`core.scaleout`): on one rank, or on a mesh whose data axes hold one
    rank, the request's generator itself, so a 1xS engine draws what the
    one-rank engine draws; with more than one data rank a new generator on
    its device, seeded with a 63-bit digest (BLAKE2b) of the request
    generator's state and this rank's data position. Deterministic, so a
    standalone serve on the same derivation draws the same bits; the
    request's generator is not drawn from then. The reference's per-query
    noise is per data position too (its key is folded by it)."""
    dpos, dsize = scaleout._dpos(mesh)
    if dsize == 1:
        return generator
    coords = np.array([dpos], np.int64).tobytes()
    digest = hashlib.blake2b(generator.get_state().cpu().numpy().tobytes() + coords,
                             digest_size=8).digest()
    seed = int.from_bytes(digest, "little") >> 1
    return torch.Generator(device=generator.device).manual_seed(seed)


class TenantRegistry:
    """Resident per-tenant prototype banks in one store on the device.

    ``store`` is [max_tenants, n_classes, d|W] (int32 words packed, uint8
    bits unpacked); with ``mesh`` it holds this model rank's classes of
    every tenant, [max_tenants, n_classes/S, d|W] (the reference's store
    sharded ``P(None, "model", None)``). ``onboard`` takes a tenant's whole
    bank and copies this rank's classes into a free row; ``evict`` frees a
    row; an evicted row keeps its stale contents, which is safe because no
    slot maps to it until onboarding overwrites it. Every rank onboards and
    evicts alike, so the rows agree."""

    def __init__(self, cfg: ScaleOutConfig, max_tenants: int,
                 device: str | torch.device | None = "cuda", mesh: RankMesh | None = None):
        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        self.cfg = cfg
        self.max_tenants = max_tenants
        sh = scaleout._shard_of(cfg, mesh)
        self._classes = cfg.n_classes // sh.model_size
        self._lo = sh.tx * self._classes
        last = cfg.words if cfg.packed else cfg.dim
        dtype = torch.int32 if cfg.packed else torch.uint8
        self.store = torch.zeros((max_tenants, self._classes, last), dtype=dtype,
                                 device=_device.resolve(device))
        self.rows: dict[Any, int] = {}
        self._free: list[int] = list(range(max_tenants))

    def onboard(self, tenant_id, protos: torch.Tensor) -> int:
        """Install a tenant's whole [C, d|W] prototype bank (this rank keeps
        its classes); returns its store row."""
        if tenant_id in self.rows:
            raise ValueError(f"tenant {tenant_id!r} already onboarded")
        if not self._free:
            raise ValueError(f"registry full ({self.max_tenants} tenants); evict first")
        want = (self.cfg.n_classes,) + tuple(self.store.shape[2:])
        if tuple(protos.shape) != want or protos.dtype != self.store.dtype:
            raise ValueError(f"prototype bank must be {want} {self.store.dtype}, got "
                             f"{tuple(protos.shape)} {protos.dtype}")
        row = self._free.pop(0)
        self.store[row].copy_(protos[self._lo:self._lo + self._classes])
        self.rows[tenant_id] = row
        return row

    def evict(self, tenant_id) -> None:
        """Free a tenant's row (contents stay until the row is reused)."""
        if tenant_id not in self.rows:
            raise ValueError(f"tenant {tenant_id!r} not onboarded")
        self._free.append(self.rows.pop(tenant_id))


class HDCEngine(slotring.SlotRingEngine):
    """Slot-ring HDC backend: N resident query batches, one multi-tenant OTA
    serve a step.

    State: ``queries`` [N, B, 1, M, d|W], ``row`` [N] int32 (the tenant's
    store row) and ``generator`` (a list of N `torch.Generator`). An empty
    slot holds a fixed placeholder generator and searches row 0; its result
    is never collected. Every step serves all N slots (one shape a step),
    and each admission's generator serves exactly one step: after the step
    every slot holds the placeholder again, so a finished request's
    generator is never drawn from again. ``params`` for `step` is (store,
    channel state), read fresh each step, so onboarding between steps needs
    no rebuild.

    With ``mesh`` (S model ranks, D data ranks) ``chan_state`` is the global
    state and the engine keeps its cores' rows; a request's queries are
    [B, S, e_per, d|W] (`scaleout.make_queries` at ``model_size=S``, the
    reference's query shape) and a slot holds this rank's [B/D, 1, e_per,
    d|W] of them, drawn on `rank_generator` of the request's generator; a
    step's answers are gathered over the data ranks, [N, B] on every rank."""

    def __init__(self, cfg: ScaleOutConfig, chan_state: phy.ChannelState, *,
                 num_slots: int, max_tenants: int,
                 device: str | torch.device | None = "cuda", mesh: RankMesh | None = None):
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.mesh = mesh
        self._shard = sh = scaleout._shard_of(cfg, mesh)
        self.chan_state = self._rows_of(chan_state)
        self.registry = TenantRegistry(cfg, max_tenants, self.device, mesh)
        self._serve = self._build_serve(cfg)
        self._qshape = (cfg.batch, sh.model_size, sh.e_per,
                        cfg.words if cfg.packed else cfg.dim)
        self._qdtype = torch.int32 if cfg.packed else torch.uint8
        self._placeholder = torch.Generator(device=self.device).manual_seed(0)
        super().__init__(num_slots)

    def _rows_of(self, state):
        """This rank's cores' rows of a global channel, process or fault
        state (the state itself on one rank)."""
        return state if self.mesh is None else scaleout.shard_state_of(self.cfg, self.mesh,
                                                                       state)

    def _build_serve(self, cfg: ScaleOutConfig):
        """The serve function for ``cfg`` (the adaptive engine builds its
        process form, and one per fleet mode)."""
        return make_mt_ota_serve(cfg, device=self.device, mesh=self.mesh)

    @property
    def params(self):
        """(store, channel state), fetched fresh each step."""
        return self.registry.store, self.chan_state

    def init_state(self) -> dict:
        n, (b, _, e_per, last) = self.num_slots, self._qshape
        mine = (b // self._shard.data_size, 1, e_per, last)
        return {
            "queries": torch.zeros((n,) + mine, dtype=self._qdtype, device=self.device),
            "row": torch.zeros((n,), dtype=torch.int32, device=self.device),
            "generator": [self._placeholder] * n,
        }

    def _admit_impl(self, state, slots, queries, rows, generators):
        return slotring.slot_update(
            state, {"queries": queries, "row": rows, "generator": generators}, slots)

    def _check_queries(self, queries: torch.Tensor) -> None:
        _device.check_on(self.device, queries=queries)
        if tuple(queries.shape) != self._qshape or queries.dtype != self._qdtype:
            raise ValueError(f"queries must be {self._qshape} {self._qdtype}, got "
                             f"{tuple(queries.shape)} {queries.dtype}")

    def _tenant_row(self, tenant_id) -> int:
        row = self.registry.rows.get(tenant_id)
        if row is None:
            raise ValueError(f"tenant {tenant_id!r} not onboarded")
        return row

    def admit_many(self, state, queries: list, tenant_ids: list, slots: list,
                   generators: list) -> dict:
        """Admit K requests' query batches into ``slots``, bound to their
        tenants' current store rows and their generators (this rank's,
        `rank_generator`): one ``index_copy_`` scatter per state tensor
        (`slot_update`), not one call a request (the ``hdc.admit`` span)."""
        with spans.span("hdc.admit"):
            rows = [self._tenant_row(t) for t in tenant_ids]
            for q in queries:
                self._check_queries(q)
            q = torch.stack(queries)
            if self.mesh is not None:                    # this rank's rows and model column
                q = scaleout.shard_batch(self.mesh, q, 1).narrow(2, self._shard.tx, 1)
            return self.admit(state, slots, q, rows,
                              [rank_generator(g, self.mesh) for g in generators])

    def _serve_slots(self, params, state):
        store, chan_state = params
        return self._serve(store, state["queries"], state["row"], chan_state,
                           state["generator"])

    def _whole_batch(self, pred: torch.Tensor, maxsim: torch.Tensor):
        """[N, B/D] answers of this rank's rows -> [N, B], gathered over the
        data axes (pod-major), the same on every rank."""
        for g in reversed(self._shard.data_groups):      # data, then pod
            pred, maxsim = (x.transpose(0, 1) for x in collectives.gather_rows(
                [pred.transpose(0, 1), maxsim.transpose(0, 1)], g))
        return pred, maxsim

    def _step_impl(self, params, state):
        with spans.span("hdc.serve"):
            out = self._whole_batch(*self._serve_slots(params, state))
            state["generator"][:] = [self._placeholder] * self.num_slots
            return state, out


@dataclasses.dataclass(frozen=True)
class LinkControllerConfig:
    """Hysteresis knobs of the closed-loop link controller.

    Per-RX actions (cheapest first): ``patience`` consecutive steps with the
    guard monitor's flip-rate estimate above the analytic band trigger an EM
    re-fit of that receiver's decision regions; a re-fit whose refreshed BER
    is STILL above ``quarantine_ber`` (or that failed outright) is a *bad*
    re-fit, and ``quarantine_after`` consecutive bad re-fits quarantine the
    core (its classes drop out of the top-1). Quarantined cores keep
    evolving, being monitored and re-fit; ``release_after`` consecutive
    re-fits below ``release_ber`` release them. The split thresholds keep a
    core oscillating around one of them from flapping.

    Fleet action: when the quarantined fraction reaches ``drop_frac`` the
    controller degrades the whole link (bundling width to ``m_floor``, odd,
    the other TXs abstaining; the vote collective to ``alt_collective`` if
    set) and restores the build-time mode once the fraction falls back
    below."""

    patience: int = 2
    band_kwargs: dict | None = None
    quarantine_ber: float = 0.25
    quarantine_after: int = 3
    release_ber: float = 0.10
    release_after: int = 2
    drop_frac: float = 0.25
    m_floor: int = 1
    alt_collective: str | None = None


class LinkController:
    """Host-side closed-loop link adaptation, run at the step barrier.

    Everything here is numpy over values the scheduler's ``_collect`` has
    already synchronized. Its outputs are a modified process state (re-fit
    and quarantine masks folded in) and an optional fleet-mode flag that the
    engine maps to a prebuilt serve variant. Decisions and their step
    indices accumulate in ``trace``."""

    def __init__(self, cfg: LinkControllerConfig, pstate: phy.ProcessState):
        self.cfg = cfg
        self.band = _host(phy.monitor_band(pstate, **(cfg.band_kwargs or {})))
        n = self.band.shape[0]
        self._over = np.zeros(n, np.int32)    # consecutive out-of-band steps
        self._bad = np.zeros(n, np.int32)     # consecutive bad re-fits
        self._good = np.zeros(n, np.int32)    # consecutive good re-fits
        self.quarantined = np.zeros(n, bool)
        self.degraded = False
        self.trace: list[dict] = []
        self._t = 0

    @property
    def n_refits(self) -> int:
        return sum(len(e["rows"]) for e in self.trace if e["action"] == "refit")

    def act(self, pstate: phy.ProcessState):
        """One barrier decision. Returns (pstate', degraded | None): the
        second is not None only on the step the fleet mode flips."""
        cfg = self.cfg
        kw = cfg.band_kwargs or {}
        dev = pstate.est.device
        self._t += 1
        self._over = np.where(_host(pstate.est) > self.band, self._over + 1, 0)
        refit = self._over >= cfg.patience
        if refit.any():
            pstate = phy.recharacterize(pstate, torch.from_numpy(refit).to(dev))
            # refresh the band of the re-fit rows only: a global recompute
            # would fold every other row's drifting BER into its band
            self.band = np.where(refit, _host(phy.monitor_band(pstate, **kw)), self.band)
            self._over[refit] = 0
            self.trace.append({"t": self._t, "action": "refit",
                               "rows": np.nonzero(refit)[0].tolist()})
            # a freshly characterized core whose BER is still bad is
            # physically degraded (fade, interferer), not stale
            ber, valid = _host(pstate.chan.ber), _host(pstate.chan.valid)
            bad_now = refit & (~valid | (ber > cfg.quarantine_ber))
            good_now = refit & valid & (ber < cfg.release_ber)
            self._bad = np.where(bad_now, self._bad + 1, np.where(refit, 0, self._bad))
            self._good = np.where(good_now, self._good + 1, np.where(refit, 0, self._good))
            newq = (~self.quarantined) & (self._bad >= cfg.quarantine_after)
            rel = self.quarantined & (self._good >= cfg.release_after)
            if newq.any() or rel.any():
                self.quarantined = (self.quarantined | newq) & ~rel
                pstate = phy.set_quarantine(pstate, torch.from_numpy(self.quarantined).to(dev))
                if newq.any():
                    self.trace.append({"t": self._t, "action": "quarantine",
                                       "rows": np.nonzero(newq)[0].tolist()})
                if rel.any():
                    self.trace.append({"t": self._t, "action": "release",
                                       "rows": np.nonzero(rel)[0].tolist()})
        frac = float(self.quarantined.mean())
        want = frac >= cfg.drop_frac
        switched = None
        if want != self.degraded:
            self.degraded = switched = want
            self.trace.append({"t": self._t, "action": "m_drop" if want else "m_restore",
                               "quarantined_frac": frac})
        return pstate, switched


class AdaptiveHDCEngine(HDCEngine):
    """HDCEngine over a LIVING channel with a closed-loop link controller.

    The serve is the process form of `make_mt_ota_serve`: each step first
    evolves the channel one tick of ``process`` on ``process_generators``,
    then serves every slot against the evolved channel with quarantined
    cores masked out of the top-1. The evolved state is staged by the step
    and committed at the scheduler's barrier (`on_barrier`), where the
    `LinkController` re-fits, quarantines and switches the fleet mode;
    fleet-mode switches swap between serve functions built through
    `step_variant`, keyed on (m_active, collective).

    Needs ``process.guard_dims > 0``: the guard-symbol monitor is the only
    observation, so without it the controller never acts.

    With ``mesh`` the process starts from the global ``chan_state`` and the
    engine keeps its cores' rows, stepped on ``process_generators`` seeded
    alike on every rank; at the barrier the controller acts on the global
    state gathered over the model ranks (`phy.gather_pstate`), the same on
    every rank, and each rank keeps its rows of the result."""

    def __init__(self, cfg: ScaleOutConfig, chan_state: phy.ChannelState, *, process,
                 num_slots: int, max_tenants: int,
                 process_generators: phy.ProcessGenerators | None = None,
                 controller: LinkControllerConfig | None = None,
                 device: str | torch.device | None = "cuda", mesh: RankMesh | None = None):
        dev = _device.resolve(device)
        self.process = process
        pstate = process.init(chan_state)
        self.process_generators = (phy.process_generators(0, dev) if process_generators is None
                                   else process_generators)
        self.controller = self._make_controller(controller, pstate)
        alt = self.controller.cfg.alt_collective
        if alt is not None:                              # an unknown collective raises here
            dataclasses.replace(cfg, collective=alt)
        self._pending: phy.ProcessState | None = None
        super().__init__(cfg, chan_state, num_slots=num_slots, max_tenants=max_tenants,
                         device=dev, mesh=mesh)
        self.pstate = self._rows_of(pstate)
        self._variants[(cfg.m_act, cfg.collective)] = self._serve

    def _make_controller(self, controller: LinkControllerConfig | None,
                         pstate: phy.ProcessState) -> LinkController:
        """The controller (the fault-tolerant engine makes a `FaultController`)."""
        return LinkController(controller or LinkControllerConfig(), pstate)

    def _build_serve(self, cfg: ScaleOutConfig):
        return make_mt_ota_serve(cfg, device=self.device, process=self.process, mesh=self.mesh)

    @property
    def params(self):
        """(store, process state): the evolving state replaces the static
        engine's channel state."""
        return self.registry.store, self.pstate

    def _serve_slots(self, params, state):
        store, pstate = params
        pred, maxsim, self._pending = self._serve(
            store, state["queries"], state["row"], pstate, state["generator"],
            self.process_generators)
        return pred, maxsim

    def _global(self, state, gather):
        """The global state of this rank's rows (``gather`` over the model
        ranks; the state itself on one rank)."""
        return state if self.mesh is None else gather(state, self._shard.model_group)

    def on_barrier(self):
        """Commit the step's evolved process state and let the controller
        act on settled values (on ranks: the global state, and each rank
        keeps its rows); what it rewrites (re-fit centroids, the quarantine
        mask) reaches the NEXT step through ``params``."""
        if self._pending is None:
            return
        self.pstate, self._pending = self._pending, None
        pstate, switched = self.controller.act(self._global(self.pstate, phy.gather_pstate))
        self.pstate = self._rows_of(pstate)
        if switched is not None:
            self._apply_fleet_mode(switched)

    def _apply_fleet_mode(self, degraded: bool) -> None:
        cc = self.controller.cfg
        if phy.get_channel(self.cfg.channel).wire != "votes":
            return  # combo wire: no M-drop or vote-collective alternatives
        if degraded:
            m = cc.m_floor if cc.m_floor % 2 == 1 else max(cc.m_floor - 1, 1)
            coll = cc.alt_collective or self.cfg.collective
        else:
            m, coll = self.cfg.m_tx, self.cfg.collective
        live = dataclasses.replace(self.cfg, m_active=None if m == self.cfg.m_tx else m,
                                   collective=coll)
        self._serve = self.step_variant((live.m_act, live.collective),
                                        lambda: self._build_serve(live))
        self.controller.trace.append({"t": self.controller._t, "action": "link_mode",
                                      "m_active": live.m_act, "collective": live.collective})


@dataclasses.dataclass(frozen=True)
class FaultControllerConfig(LinkControllerConfig):
    """`LinkControllerConfig` plus the promotion from quarantine to failover:
    ``remap_after`` consecutive barriers spent quarantined declare a core
    dead in the `faults.FaultState` and fail its bank over onto healthy
    cores. Promotion is one-way (a remapped bank is served elsewhere, so a
    release would race the failover), hence ``remap_after`` sits above
    ``release_after``."""

    remap_after: int = 3


class FaultController(LinkController):
    """`LinkController` that escalates persistent quarantine to failover.
    `promote` runs after the soft loop at each barrier and counts the
    barriers each core has spent quarantined; at ``remap_after`` the core
    joins ``dead_rx`` and `faults.plan_failover` re-deals the shard (the
    same serve: ``serve_rows``/``rx_mask`` are inputs). Trace action:
    ``"remap"``."""

    def __init__(self, cfg: FaultControllerConfig, pstate: phy.ProcessState):
        super().__init__(cfg, pstate)
        self._q_barriers = np.zeros(self.band.shape[0], np.int32)

    def promote(self, fstate: faults.FaultState, cores_per_shard: int) -> faults.FaultState:
        """One barrier's promotion; returns the fault state the next step
        serves under."""
        self._q_barriers = np.where(self.quarantined, self._q_barriers + 1, 0).astype(np.int32)
        dead = _host(fstate.dead_rx)
        newly_dead = (self._q_barriers >= self.cfg.remap_after) & ~dead
        if not newly_dead.any():
            return fstate
        fstate = faults.plan_failover(faults.inject(fstate, dead_rx=dead | newly_dead),
                                      cores_per_shard)
        self.trace.append({"t": self._t, "action": "remap",
                           "rows": np.nonzero(newly_dead)[0].tolist()})
        return fstate


class FaultTolerantHDCEngine(AdaptiveHDCEngine):
    """`AdaptiveHDCEngine` that also threads a live `faults.FaultState`.

    The serve is the process and faults form of `make_mt_ota_serve`: each
    step evolves the channel and the faults one tick (the fault model on
    ``fault_generator``), serves every slot erasure-aware with dead cores'
    banks failed over, and stages both evolved states. `on_barrier`
    commits them, runs the inherited soft loop, then lets the
    `FaultController` promote persistently quarantined cores. Fleet-mode
    variants are fault serves too (`_build_serve`). With the healthy state
    under `faults.StaticFaults` it serves as `AdaptiveHDCEngine` does, bit
    for bit.

    With ``mesh`` ``fstate`` is the global state (`faults.healthy_for` at
    ``model_size=S`` by default) and the engine keeps its cores' rows,
    stepped on ``fault_generator`` seeded alike on every rank; the
    controller promotes on the global state gathered over the model ranks
    (`faults.gather_fstate`) with shards of ``n_rx_cores / S`` cores, so a
    failover never leaves its rank."""

    def __init__(self, cfg: ScaleOutConfig, chan_state: phy.ChannelState, *, process,
                 fault_model: faults.FaultModel, num_slots: int, max_tenants: int,
                 process_generators: phy.ProcessGenerators | None = None,
                 fault_generator: torch.Generator | None = None,
                 fstate: faults.FaultState | None = None,
                 controller: FaultControllerConfig | None = None,
                 device: str | torch.device | None = "cuda", mesh: RankMesh | None = None):
        dev = _device.resolve(device)
        self.fault_model = fault_model
        s = scaleout._shard_of(cfg, mesh).model_size
        fstate = faults.healthy_for(cfg, dev, model_size=s) if fstate is None else fstate
        self.fault_generator = (torch.Generator(device=dev).manual_seed(1)
                                if fault_generator is None else fault_generator)
        self._pending_fstate: faults.FaultState | None = None
        super().__init__(cfg, chan_state, process=process, num_slots=num_slots,
                         max_tenants=max_tenants, process_generators=process_generators,
                         controller=controller, device=dev, mesh=mesh)
        self.fstate = self._rows_of(fstate)

    def _make_controller(self, controller, pstate):
        return FaultController(controller or FaultControllerConfig(), pstate)

    def _build_serve(self, cfg: ScaleOutConfig):
        return make_mt_ota_serve(cfg, device=self.device, process=self.process,
                                 faults=self.fault_model, mesh=self.mesh)

    def _serve_slots(self, params, state):
        store, pstate = params
        pred, maxsim, self._pending, self._pending_fstate = self._serve(
            store, state["queries"], state["row"], pstate, state["generator"],
            self.process_generators, self.fstate, self.fault_generator)
        return pred, maxsim

    def on_barrier(self):
        """Commit both evolved states, run the soft loop, then promote on
        the global fault state, shard by shard of ``n_rx_cores / S`` cores
        (one shard on one rank)."""
        if self._pending_fstate is not None:
            self.fstate, self._pending_fstate = self._pending_fstate, None
        super().on_barrier()
        fstate = self.controller.promote(self._global(self.fstate, faults.gather_fstate),
                                         self._shard.cores)
        self.fstate = self._rows_of(fstate)


class HDCScheduler(SlotScheduler):
    """Tenant-aware request queue over an `HDCEngine`.

    Every running slot finishes at each step barrier (an HDC request is one
    serve, not a token loop), so continuous batching here means: free slots
    refill from the age-ordered queue every step, and one step serves
    however many tenants are resident. On a mesh every rank runs the same
    scheduler: each submits the same requests in the same order (queries
    in the global layout, ``generator`` the request's own), and the
    shared clock makes every decision and completion the same on every
    rank (`SlotScheduler`)."""

    def __init__(self, engine: HDCEngine, clock: Callable[[], float] = time.monotonic,
                 *, max_slot_steps: int | None = None, max_requeues: int = 1):
        super().__init__(engine, None, clock, max_slot_steps=max_slot_steps,
                         max_requeues=max_requeues)

    def submit(self, tenant_id, queries: torch.Tensor, *,
               generator: torch.Generator | None = None) -> int:
        """Queue one trial batch [B, S, e_per, d|W] ([B, 1, M, d|W] on one
        rank; `HDCEngine`) for ``tenant_id``.
        ``generator`` is the request's PHY noise stream (default: a generator
        on the engine's device seeded with the request id)."""
        if tenant_id not in self.engine.registry.rows:
            raise ValueError(f"tenant {tenant_id!r} not onboarded")
        rid = self._next_rid
        self._next_rid += 1
        if generator is None:
            generator = torch.Generator(device=self.engine.device).manual_seed(rid)
        req = HDCRequest(rid, tenant_id, queries, generator, self.clock())
        self.buckets[self._bucket_key(req)].append(req)   # one shape: one bucket
        return rid

    def _step_params(self):
        return self.engine.params

    def _fail_eviction(self, slot: int, record):
        """Deadline eviction (an HDC slot completes every step, so this only
        fires if the step loop itself stalls): empty result, status marks it."""
        req, t_admit = record
        return HDCCompletion(req.rid, req.tenant, np.zeros((0,), np.int32),
                             np.zeros((0,), np.float32), req.t_submit, t_admit,
                             self.clock(), status="evicted")

    def _admit_batch(self, batch: list) -> list:
        """Every matched (request, slot) pair in ONE `HDCEngine.admit_many`
        call. An HDC admission finishes nothing."""
        for req, _ in batch:
            # the tenant may have been evicted between submit and admission
            if req.tenant not in self.engine.registry.rows:
                raise RuntimeError(
                    f"tenant {req.tenant!r} evicted with request {req.rid} queued")
        self.state = self.engine.admit_many(
            self.state, [r.queries for r, _ in batch], [r.tenant for r, _ in batch],
            [s for _, s in batch], [r.generator for r, _ in batch])
        t_admit = self.clock()
        for req, slot in batch:
            self.running[slot] = (req, t_admit)
        return []

    def _collect(self, emitted) -> list:
        pred, maxsim = emitted
        with spans.span("sched.barrier"):
            p = _host(pred)             # the step barrier: one copy to the host each
            s = _host(maxsim)
            self.engine.on_barrier()    # adaptive engines: commit the evolved state, act
            spans.count("hdc.slots", self.engine.num_slots)
            spans.count("hdc.slots_live", len(self.running))
        finished = []
        t_finish = self.clock()     # every running slot finishes at the barrier
        for slot in sorted(self.running):
            req, t_admit = self.running.pop(slot)
            done = HDCCompletion(req.rid, req.tenant, p[slot], s[slot], req.t_submit,
                                 t_admit, t_finish, step=self.step_id)
            self.results[req.rid] = done
            self.free.append(slot)
            finished.append(done)
        return finished
