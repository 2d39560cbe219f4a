"""Time-varying PHY: channel processes and online re-characterization
(counterpart of `repro/phy/process.py`; see there for the physics).

A process evolves the OTA link between serve steps:

    pstate = process.init(chan_state)           # wrap the characterization
    pstate = process.step(generators, pstate)   # evolve one serve step

`ProcessState` carries both sides of a drifting link. The channel truth:
``chan.h`` and ``chan.symbols`` are re-derived every step from the drifting
degrees of freedom (``phase``, ``fade``, the interferer tone), and
``chan.ber`` is the true flip rate of decoding the live constellation
against the receiver's possibly stale centroids (`ota.per_symbol_ber`).
The receiver's knowledge: ``c0``/``c1``/``valid`` stay what the last
characterization fit, and ``est`` is an EW-MA of the flip rate the receiver
observes on ``guard_dims`` guard symbols a step (known majority truth, the
same `ota.awgn_decide` as the data path). When ``est`` leaves the analytic
band (`em.analytic_ber_band`), `recharacterize` re-fits the decision
regions from the live constellation.

Randomness. The reference folds (key, t, row, sub-stream) into threefry
keys; the port cannot reproduce threefry and keeps the two properties the
reference pins instead: the guard monitor never changes the physics
trajectory (``h``, ``symbols``, ``ber``), and a rollout resumed from an
intermediate state with its generators' state continues exactly like the
uninterrupted one. Both follow from one `torch.Generator` per sub-stream
(`ProcessGenerators`: evolve, inject, guard), all made from one seed by
`process_generators`. ``step(draws=...)`` takes the draws from outside
instead (the tests replay JAX's).

Nothing in a step or a rollout reads a value back to the host: ``t``,
``t % block`` and the adaptive loop's trips stay on the device, and the
reference's ``lax.cond`` around the re-fit becomes a masked
`recharacterize` that always runs (every leaf is selected by the trip mask,
so the result is the same).

`StaticProcess.step` advances only ``t`` and draws nothing: serving through
it equals the static-state serve bit for bit.

Over ranks (the counterpart of the reference's ``pstate_spec``) a model rank
holds only its own cores' rows of every RX-leading leaf (`shard_pstate`) and
steps them with ``step(..., rx_base=, n_rx=)``. Every draw is made for the
global [N, ...] rows on generators seeded alike on every rank, and the rank
keeps rows [rx_base, rx_base + cores): the rank's rows then equal the
one-rank rollout's, and data replicas evolve alike (the reference folds the
global row id into its keys, `row_keys`, for the same invariance). At the
paper's 64 cores the extra draws are negligible.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import em, ota
from repro_torch.distributed import collectives
from repro_torch.phy.channel import RX_FIELDS, ChannelState, shard_state, state_shape_structs


@dataclasses.dataclass(frozen=True)
class ProcessState:
    """Channel truth and receiver knowledge ([N] = RX cores leading).

    ``chan`` is the live `ChannelState` the serve consumes; the rest are the
    process's degrees of freedom and the monitor's surface."""

    chan: ChannelState          # live channel state (what the serve tiers consume)
    base_h: torch.Tensor        # [N, M] c64 — characterized anchor channel (t = 0)
    phase: torch.Tensor         # [N, M] f32 — accumulated drift rotation of base_h
    fade: torch.Tensor          # [N] f32 — block-fading amplitude scale (1 nominal)
    igain: torch.Tensor         # [N] c64 — off-mesh interferer coupling (0 unused)
    est: torch.Tensor           # [N] f32 — EW-MA empirical flip-rate estimate
    quarantine: torch.Tensor    # [N] bool — cores excluded from the top-1
    t: torch.Tensor             # [] i32 — process time (serve steps since init)

    FIELDS = ("chan", "base_h", "phase", "fade", "igain", "est", "quarantine", "t")

    @property
    def n_rx(self) -> int:
        return self.chan.n_rx

    @property
    def m_tx(self) -> int:
        return self.chan.m_tx


@dataclasses.dataclass(frozen=True)
class ProcessGenerators:
    """One generator per sub-stream of a process, so that adding an
    observer (the guard monitor) never moves the physics stream."""

    evolve: torch.Generator
    inject: torch.Generator
    guard: torch.Generator

    def get_state(self) -> tuple[torch.Tensor, ...]:
        """The three generators' states, for `set_state` (resume a rollout)."""
        return tuple(g.get_state() for g in (self.evolve, self.inject, self.guard))

    def set_state(self, states) -> None:
        for g, st in zip((self.evolve, self.inject, self.guard), states):
            g.set_state(st)


def process_generators(seed: int, device: str | torch.device = "cuda") -> ProcessGenerators:
    """The evolve, inject and guard generators on ``device``, seeded with
    three 62-bit seeds drawn from one CPU generator seeded with ``seed``, so
    that no two seeds share a sub-stream."""
    seeds = torch.randint(0, 2**62, (3,), generator=torch.Generator().manual_seed(seed))
    return ProcessGenerators(*(torch.Generator(device=device).manual_seed(int(s))
                               for s in seeds))


RX_LEAVES = ("base_h", "phase", "fade", "igain", "est", "quarantine")  # [N]-leading, besides chan


def pstate_shape_structs(n_rx: int, m_tx: int, device="meta") -> ProcessState:
    """An empty `ProcessState` on ``device`` (meta by default; fake under a
    FakeTensorMode): the shapes and dtypes of `ChannelProcess.init`, for
    the dry run's ``serve_adaptive`` cells without the EM pipeline (the
    reference's ``pstate_shape_structs``)."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    return ProcessState(
        chan=state_shape_structs(n_rx, m_tx, device),
        base_h=empty((n_rx, m_tx), torch.complex64), phase=empty((n_rx, m_tx), torch.float32),
        fade=empty((n_rx,), torch.float32), igain=empty((n_rx,), torch.complex64),
        est=empty((n_rx,), torch.float32), quarantine=empty((n_rx,), torch.bool),
        t=empty((), torch.int32))


def shard_pstate(pstate: ProcessState, rx_base: int, n_cores: int) -> ProcessState:
    """The process state of cores [rx_base, rx_base + n_cores): ``chan`` cut
    by `phy.shard_state` and the RX-leading leaves to those rows, ``t``
    whole (the counterpart of the reference's ``pstate_spec``)."""
    return dataclasses.replace(
        pstate, chan=shard_state(pstate.chan, rx_base, n_cores),
        **{f: getattr(pstate, f)[rx_base:rx_base + n_cores] for f in RX_LEAVES})


def gather_pstate(pstate: ProcessState, group) -> ProcessState:
    """Every model rank's rows of ``pstate`` in rank order (the global
    state; ``group=None``: the state itself), for the host-side decisions
    of the step barrier. Every rank of the group must call it."""
    if group is None:
        return pstate
    got = collectives.gather_rows([getattr(pstate.chan, f) for f in RX_FIELDS]
                                  + [getattr(pstate, f) for f in RX_LEAVES], group)
    chan = dataclasses.replace(pstate.chan, **dict(zip(RX_FIELDS, got)))
    return dataclasses.replace(pstate, chan=chan, **dict(zip(RX_LEAVES, got[len(RX_FIELDS):])))


def draw_rows(x: torch.Tensor, rx_base: int, n: int) -> torch.Tensor:
    """Rows [rx_base, rx_base + n) of a draw over the global rows (the
    whole draw on one rank): what a model rank keeps of it."""
    return x if rx_base == 0 and x.shape[0] == n else x[rx_base:rx_base + n]


def _cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex product from real products and sums. Each real op rounds
    once, so the result does not depend on how many rows a call holds: on
    the CPU torch's complex product takes a vector path or a fused scalar
    tail by the tensor's length, which gives a row other bits on a rank's
    shard than in the one-rank state."""
    re = a.real * b.real - a.imag * b.imag
    im = a.real * b.imag + a.imag * b.real
    return torch.complex(re, im)


def _constellations(h: torch.Tensor, phase_idx: torch.Tensor) -> torch.Tensor:
    """`ota.rx_constellations` row by row: y [N, 2^M] = sum over m of
    h[:, m] * exp(j phi_m(b_m)), summed in TX order with `_cmul`, so a row's
    symbols are the same bits whatever rows the state holds (a batched
    complex product picks its algorithm by shape)."""
    combos = ota.bit_combos(h.shape[1], h.device).bool()               # [B, M]
    tx_phase = ota.phase_codebook(h.device)[phase_idx]                 # [M, 2]
    sel = torch.where(combos, tx_phase[:, 1], tx_phase[:, 0])
    tx_sym = torch.polar(torch.ones_like(sel), sel)                    # [B, M]
    y = _cmul(h[:, None, 0], tx_sym[None, :, 0])
    for m in range(1, h.shape[1]):
        y = y + _cmul(h[:, None, m], tx_sym[None, :, m])
    return y


def _need(generator: torch.Generator | None) -> torch.Generator:
    """A draw's generator: a process never falls back on torch's global one."""
    if generator is None:
        raise ValueError("this process step draws: pass its ProcessGenerators "
                         "(process_generators) or the draws")
    return generator


# ---------------------------------------------------------------------------
# the ChannelProcess interface + processes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChannelProcess:
    """One stochastic evolution law of the OTA link between serve steps.

    Subclasses override `_evolve` (advance the drift) and optionally
    `_inject` (add an external field); the `step` template re-derives the
    live symbols (`ota.rx_constellations`, row by row), recomputes the true per-RX flip
    rate against the receiver's current centroids and updates the guard
    monitor. Rows with ``valid=False`` carry no physics: their BER and
    estimate pass through unchanged.

    ``guard_dims`` guard symbols per step feed the monitor (EW-MA weight
    ``alpha``); 0 disables it.

    ``draws`` of `step`, for replay, is a dict with any of ``"evolve"`` (the
    subclass's draw: the phase increments [N, M], the new fades [N]) and
    ``"guard"`` (combos [N, G] int64 and the AWGN's standard normals
    (real, imaginary) [N, G] each); what it lacks is drawn. On a model rank
    (``rx_base``, and ``n_rx`` the global core count) the state holds rows
    [rx_base, rx_base + cores) (`shard_pstate`); draws, made or replayed,
    span the global N rows and the rank keeps its own, so its rows evolve
    as the one-rank state's do."""

    name = "?"
    guard_dims: int = 64
    alpha: float = 0.25

    def init(self, state: ChannelState) -> ProcessState:
        n, m = state.n_rx, state.m_tx
        dev = state.ber.device
        return ProcessState(
            chan=state,
            base_h=state.h,
            phase=torch.zeros((n, m), dtype=torch.float32, device=dev),
            fade=torch.ones((n,), dtype=torch.float32, device=dev),
            igain=torch.zeros((n,), dtype=torch.complex64, device=dev),
            est=state.ber.to(torch.float32),
            quarantine=torch.zeros((n,), dtype=torch.bool, device=dev),
            t=torch.zeros((), dtype=torch.int32, device=dev),
        )

    # --- subclass hooks ---------------------------------------------------
    # ``span`` = (rx_base, global N): a hook draws for all N rows and keeps
    # the state's rows [rx_base, rx_base + p.n_rx) (`draw_rows`)

    def _evolve(self, generator, p: ProcessState, draw=None, span=None):
        """Advance (phase [N, M], fade [N]) one step."""
        return p.phase, p.fade

    def _inject(self, generator, y: torch.Tensor, p: ProcessState) -> torch.Tensor:
        """Add an external field to the live constellation y [N, B]."""
        return y

    # --- the template -----------------------------------------------------
    def step(self, generators: ProcessGenerators | None, p: ProcessState, *,
             draws: dict | None = None, rx_base: int = 0,
             n_rx: int | None = None) -> ProcessState:
        draws = draws or {}
        m = p.chan.m_tx
        span = (rx_base, p.n_rx if n_rx is None else n_rx)
        phase, fade = self._evolve(generators and generators.evolve, p, draws.get("evolve"),
                                   span)
        h = (_cmul(p.base_h, torch.exp(1j * phase)) * fade[:, None]).to(torch.complex64)
        y = _constellations(h, p.chan.phase_idx)
        y = self._inject(generators and generators.inject, y, p).to(torch.complex64)
        maj = ota.majority_labels(m, y.device)
        ber_true = ota.per_symbol_ber(y, p.chan.c0, p.chan.c1, maj, p.chan.n0)
        ber = torch.where(p.chan.valid, ber_true, p.chan.ber).to(torch.float32)
        chan = dataclasses.replace(p.chan, h=h, symbols=y, ber=ber)
        est = self._observe(generators and generators.guard, chan, p.est, draws.get("guard"),
                            span)
        return dataclasses.replace(p, chan=chan, phase=phase, fade=fade, est=est, t=p.t + 1)

    def _observe(self, generator, chan: ChannelState, est: torch.Tensor,
                 draw=None, span=None) -> torch.Tensor:
        """Guard-symbol monitor: EW-MA of the decode-vs-truth flip rate."""
        if self.guard_dims <= 0:
            return est
        n, b = chan.symbols.shape
        base, n_all = span or (0, n)
        dev = chan.symbols.device
        if draw is None:
            g = _need(generator)
            combos = torch.randint(0, b, (n_all, self.guard_dims), generator=g, device=dev)
            draw = (combos,) + ota.awgn_draws(g, (n_all, self.guard_dims), dev)
        combos, nr, ni = (draw_rows(x, base, n) for x in draw)
        sym = torch.gather(chan.symbols, 1, combos)
        dec = ota.awgn_decide(None, sym, chan.c0[:, None], chan.c1[:, None], chan.n0,
                              noise=(nr, ni))
        maj = ota.majority_labels(chan.m_tx, dev)
        rate = (dec != maj[combos]).to(torch.float32).mean(-1)
        rate = torch.where(chan.valid, rate, est)            # no physics to observe
        return ((1.0 - self.alpha) * est + self.alpha * rate).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class StaticProcess(ChannelProcess):
    """Frozen channel, the paper's once-and-forever characterization: `step`
    advances only ``t`` and draws nothing, so serving through it equals the
    static-state serve bit for bit."""

    name = "static"
    guard_dims: int = 0

    def step(self, generators, p, *, draws=None, rx_base=0, n_rx=None):
        return dataclasses.replace(p, t=p.t + 1)


@dataclasses.dataclass(frozen=True)
class PhaseDriftProcess(ChannelProcess):
    """LO phase noise: a random walk of ``sigma`` rad/step rotating each
    receiver's channel row as a whole (stale centroids degrade, a re-fit
    recovers exactly), plus ``tx_sigma`` independent per-(RX, TX) jitter
    that distorts the constellation itself. The draw is the increment
    [N, M]: ``sigma * n_rx[:, None] + tx_sigma * n_tx``, per-RX normals
    first."""

    name = "phase_drift"
    sigma: float = 0.08
    tx_sigma: float = 0.0

    def _evolve(self, generator, p, draw=None, span=None):
        n, m = p.phase.shape
        base, n_all = span or (0, n)
        if draw is None:
            g = _need(generator)
            d = self.sigma * torch.randn((n_all,), generator=g, device=p.phase.device)
            dtx = self.tx_sigma * torch.randn((n_all, m), generator=g, device=p.phase.device)
            draw = d[:, None] + dtx
        return p.phase + draw_rows(draw, base, n), p.fade


@dataclasses.dataclass(frozen=True)
class BlockFadingProcess(ChannelProcess):
    """Block fading: per-RX log-normal amplitude scale, redrawn every
    ``block`` steps; ``sigma_db`` is the std of 20*log10 of the scale. A
    fade is drawn every step (so the stream does not depend on ``t``) and
    taken where ``t % block == 0``, on the device."""

    name = "block_fading"
    sigma_db: float = 4.0
    block: int = 8

    def _evolve(self, generator, p, draw=None, span=None):
        n = p.fade.shape[0]
        base, n_all = span or (0, n)
        if draw is None:
            z = torch.randn((n_all,), generator=_need(generator), device=p.fade.device)
            draw = (10.0 ** (self.sigma_db * z / 20.0)).to(torch.float32)
        return p.phase, torch.where(p.t % self.block == 0, draw_rows(draw, base, n), p.fade)


@dataclasses.dataclass(frozen=True)
class InterfererProcess(ChannelProcess):
    """Off-mesh interferer: a CW aggressor at ``pos`` (mm, may lie outside
    the package) leaking ``amp * igain * exp(j * omega * t)`` into every
    combo symbol of each receiver's field. `init` takes the per-RX coupling
    from the `em` ray model, scaled so that ``amp`` is in units of the mean
    link amplitude. Deterministic: it draws nothing."""

    name = "interferer"
    amp: float = 0.6
    omega: float = 0.7
    pos: tuple = (15.0, -6.0)
    geom: em.PackageGeometry | None = None

    def init(self, state: ChannelState) -> ProcessState:
        p = super().init(state)
        geom = self.geom if self.geom is not None else em.PackageGeometry()
        dev = state.h.device
        rxp = em.rx_positions(geom, state.n_rx, dev)
        pos = torch.tensor(self.pos, dtype=torch.float32, device=dev)
        g = em._ray_gain(torch.linalg.norm(rxp - pos[None], dim=-1), geom)
        scale = state.h.abs().mean() / torch.clamp(g.abs().mean(), min=1e-12)
        return dataclasses.replace(p, igain=(g * scale).to(torch.complex64))

    def _inject(self, generator, y, p):
        tone = torch.exp(1j * self.omega * p.t.to(torch.float32))
        return y + _cmul(self.amp * p.igain[:, None], tone)


# ---------------------------------------------------------------------------
# online re-characterization + controller helpers
# ---------------------------------------------------------------------------

def recharacterize(pstate: ProcessState, mask: torch.Tensor | None = None) -> ProcessState:
    """EM re-fit of the decision regions from the live constellation: for
    the rows of ``mask`` (default all), ``c0, c1 = majority_centroids`` and
    the BER and validity per symbol against the new boundary
    (`ota.decision_metrics(method="symbol")`); the estimate restarts at the
    re-fit BER. Other rows pass through unchanged."""
    chan = pstate.chan
    maj = ota.majority_labels(chan.m_tx, chan.symbols.device)
    c0n, c1n = ota.majority_centroids(chan.symbols, maj)
    bern, validn = ota.decision_metrics(chan.symbols, maj, chan.n0, method="symbol")
    if mask is None:
        mask = torch.ones(chan.ber.shape, dtype=torch.bool, device=chan.ber.device)
    mask = mask.to(torch.bool)
    chan2 = dataclasses.replace(
        chan,
        c0=torch.where(mask, c0n, chan.c0).to(torch.complex64),
        c1=torch.where(mask, c1n, chan.c1).to(torch.complex64),
        ber=torch.where(mask, bern, chan.ber).to(torch.float32),
        valid=torch.where(mask, validn, chan.valid),
    )
    est = torch.where(mask, chan2.ber, pstate.est).to(torch.float32)
    return dataclasses.replace(pstate, chan=chan2, est=est)


def set_quarantine(pstate: ProcessState, mask: torch.Tensor) -> ProcessState:
    """Replace the mask [N] bool of cores excluded from the top-1."""
    return dataclasses.replace(pstate, quarantine=mask.to(torch.bool))


def monitor_band(pstate: ProcessState, **kw) -> torch.Tensor:
    """Acceptance ceiling [N] for ``est`` from the current receiver
    knowledge: `em.analytic_ber_band` over the live channel and the
    last-characterized BER (``kw`` are its slack, floor and cap)."""
    chan = pstate.chan
    return em.analytic_ber_band(chan.h, chan.n0, chan.ber, **kw)


# ---------------------------------------------------------------------------
# rollouts
# ---------------------------------------------------------------------------

def rollout(process: ChannelProcess, pstate: ProcessState,
            generators: ProcessGenerators | None, n_steps: int
            ) -> tuple[ProcessState, list[ProcessState]]:
    """Evolve ``n_steps`` under ``process``: (final state, the state after
    every step). Resuming from any intermediate state with the generators'
    state of that moment (`ProcessGenerators.get_state`) replays the rest."""
    traj = []
    for _ in range(n_steps):
        pstate = process.step(generators, pstate)
        traj.append(pstate)
    return pstate, traj


def adaptive_rollout(process: ChannelProcess, pstate: ProcessState,
                     generators: ProcessGenerators | None, n_steps: int, *,
                     band: torch.Tensor | None = None, band_kwargs: dict | None = None,
                     patience: int = 2) -> tuple[ProcessState, list[ProcessState], torch.Tensor]:
    """Closed loop: drift, monitor and banded EM re-fit. Each step, the
    valid rows whose estimate has sat above the band for ``patience``
    consecutive steps are re-characterized and their band re-evaluated from
    the re-fit (only theirs: the others' BER is the drifting truth, which
    would ratchet their band up). Returns (final state, the state after
    every step, the re-fit mask [T, N] bool). The re-fit is masked and
    always runs, so the loop never reads the device from the host."""
    band_kwargs = band_kwargs or {}
    bnd = (monitor_band(pstate, **band_kwargs) if band is None else band).to(torch.float32)
    over = torch.zeros(pstate.chan.ber.shape, dtype=torch.int32, device=pstate.est.device)
    traj, trips = [], []
    for _ in range(n_steps):
        pstate = process.step(generators, pstate)
        over = torch.where(pstate.est > bnd, over + 1, 0)
        trip = (over >= patience) & pstate.chan.valid
        pstate = recharacterize(pstate, trip)
        bnd = torch.where(trip, monitor_band(pstate, **band_kwargs), bnd)
        over = torch.where(trip, 0, over)
        traj.append(pstate)
        trips.append(trip)
    return pstate, traj, torch.stack(trips) if trips else torch.zeros(
        (0,) + tuple(over.shape), dtype=torch.bool, device=over.device)


# ---------------------------------------------------------------------------
# registry (mirrors `channel.register_channel`)
# ---------------------------------------------------------------------------

PROCESSES: dict[str, type] = {}


def register_process(cls: type, *, override: bool = False) -> type:
    """Register a `ChannelProcess` subclass under ``cls.name`` for
    `get_process`; re-registering a taken name raises unless
    ``override=True``."""
    name = getattr(cls, "name", None)
    if not isinstance(name, str) or not name or name == "?":
        raise ValueError(f"process must define a non-empty .name, got {name!r}")
    if not callable(getattr(cls, "step", None)):
        raise TypeError(f"process {name!r} does not implement step()")
    if name in PROCESSES and not override:
        raise ValueError(f"channel process {name!r} already registered; pass "
                         "override=True to replace it")
    PROCESSES[name] = cls
    return cls


for _p in (StaticProcess, PhaseDriftProcess, BlockFadingProcess, InterfererProcess):
    register_process(_p)
del _p


def get_process(name: str, **kwargs) -> ChannelProcess:
    """Instantiate a registered process by name (kwargs to its constructor)."""
    try:
        cls = PROCESSES[name]
    except KeyError:
        raise ValueError(f"unknown channel process {name!r}; "
                         f"available: {sorted(PROCESSES)}") from None
    return cls(**kwargs)
