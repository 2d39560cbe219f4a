"""What one rank of a living-channel / fault / HDC-engine test world runs
(imported by the spawned rank processes, so it imports torch and the port
only, never JAX).

`run(mesh, inputs)` runs every case on this rank's shard of the global
inputs and returns {case name: outputs}; with ``mesh=None`` the same code
runs the whole inputs on one rank, which is what the ranks are held to.
`jax_cases(mesh, inputs)` serves the cases held against the reference's
8-device serve.

``inputs`` holds numpy arrays: ``state_*`` (a real 8-RX ChannelState's
fields), ``protos_u`` and ``protos2_u`` [C, d] uint8 (two tenants),
``masks`` [n_rx, B, d] uint8 (flip masks replayed by core, the
``bsc_replay`` tier), ``nr``/``ni``/``flips`` [n_rx, B, d] (the symbol
tier's draws replayed by core, ``symbol_replay``), ``stuck0``/``stuck1``
[n_rx, W] int32 and, per fault scenario, the global failover plan
``<scenario>/serve_rows`` and ``<scenario>/rx_mask`` (made once for shards
of 2 cores, a plan that keeps inside every grid's shards).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import _torch_dist_ranks as ranks
from repro_torch import faults, phy
from repro_torch.core import hypervector as hv, scaleout
from repro_torch.distributed import collectives
from repro_torch.serving import (AdaptiveHDCEngine, FaultControllerConfig,
                                 FaultTolerantHDCEngine, HDCEngine, HDCScheduler,
                                 LinkControllerConfig)
from repro_torch.serving.hdc import rank_generator

CPU = "cpu"
SMALL = dict(n_classes=40, dim=512, m_tx=3, n_rx_cores=8, batch=8)
MODES = [(False, "unpacked"), (False, "packed"), (True, "unpacked"), (True, "packed")]
FAULT_SCENARIOS = {   # global ids: core 5 sits on model rank 1 (1x2) and 2 (1x4)
    "A": dict(dead_rx=[1, 5], dead_tx=[2], stuck=True),
    "B": dict(dead_rx=[1, 6, 7], vote_drop=[1], stuck=False),   # cores 6, 7: a dead shard
}
PROCESSES = {
    "drift": lambda: phy.PhaseDriftProcess(sigma=0.3, tx_sigma=0.05, guard_dims=16),
    "fading": lambda: phy.BlockFadingProcess(sigma_db=6.0, block=2, guard_dims=16),
    "interferer": lambda: phy.InterfererProcess(guard_dims=16),
}
STEPS = 3


def _mode(perm: bool, rep: str) -> str:
    return f"{rep}-{'perm' if perm else 'base'}"


def _place(mesh):
    """(data position, model column, model ranks) of this rank."""
    if mesh is None:
        return 0, 0, 1
    return scaleout._dpos(mesh)[0], mesh.index("model"), mesh.axis_size("model")


def _state(inputs) -> phy.ChannelState:
    return phy.ChannelState(**{f: torch.from_numpy(np.array(inputs[f"state_{f}"]))
                               for f in phy.ChannelState.FIELDS})


def _leaves(p) -> dict:
    """A process or fault state's leaves as numpy (the channel's under chan/)."""
    out = {}
    for f in p.FIELDS:
        x = getattr(p, f)
        if isinstance(x, phy.ChannelState):
            out.update({f"chan/{g}": getattr(x, g).numpy() for g in phy.ChannelState.FIELDS})
        else:
            out[f] = x.numpy()
    return out


def global_fstate(cfg, inputs, scenario: str, model_size: int) -> faults.FaultState:
    """Scenario ``scenario`` on the global fault state of a model axis of
    ``model_size`` ranks, failed over by the pinned plan."""
    sc = FAULT_SCENARIOS[scenario]
    f = faults.healthy_for(cfg, CPU, model_size=model_size)
    leaves = dict(dead_rx=sc["dead_rx"], serve_rows=np.array(inputs[f"{scenario}/serve_rows"]),
                  rx_mask=np.array(inputs[f"{scenario}/rx_mask"]))
    for k in ("dead_tx", "vote_drop"):
        if k in sc:
            leaves[k] = sc[k]
    if sc["stuck"]:
        leaves.update(stuck0=np.array(inputs["stuck0"]), stuck1=np.array(inputs["stuck1"]))
    return faults.inject(f, **leaves)


# ---------------------------------------------------------------------------
# process and fault rollouts
# ---------------------------------------------------------------------------

def rollouts(mesh, inputs) -> dict:
    """Every process of PROCESSES and the wearout and transient-vote fault
    models, STEPS steps from the global initial state cut to this rank's
    rows, on generators seeded alike on every rank: the leaves after every
    step."""
    cfg = scaleout.ScaleOutConfig(**SMALL)
    sh = scaleout._shard_of(cfg, mesh)
    rows = dict(rx_base=sh.tx * sh.cores, n_rx=cfg.n_rx_cores)
    out = {}
    for name, make in PROCESSES.items():
        proc = make()
        p = scaleout.shard_state_of(cfg, mesh, proc.init(_state(inputs)))
        gens = phy.process_generators(5, CPU)
        out[f"process-{name}"] = []
        for _ in range(STEPS):
            p = proc.step(gens, p, **rows)
            out[f"process-{name}"].append(_leaves(p))
    for name, model in (("wearout", faults.WearoutFaults(p_die=0.2, stuck_rate=0.05)),
                        ("transient", faults.TransientVoteFaults(p_drop=0.5))):
        f = scaleout.shard_state_of(cfg, mesh, faults.healthy_for(
            cfg, CPU, model_size=sh.model_size))
        g = torch.Generator().manual_seed(9)
        out[f"faults-{name}"] = []
        for _ in range(STEPS):
            f = model.step(g, f, **rows)
            out[f"faults-{name}"].append(_leaves(f))
    return out


# ---------------------------------------------------------------------------
# the serves with process= and faults=
# ---------------------------------------------------------------------------

def serve_cases() -> list:
    """Each case: name, kind (ota or mt), cfg overrides, process (None or a
    PROCESSES key or "static"), fault scenario (or None), quarantined cores
    and whether the caller re-centres the symbol tier's decoder on the
    erased TXs."""
    cases = [dict(name=f"faults{sc}-{_mode(perm, rep)}-{coll}", kind="ota", faults=sc,
                  cfg=dict(channel="bsc_replay", permuted=perm, representation=rep,
                           collective=coll))
             for sc, colls in (("A", ("psum", "psum_packed", "rs_ag")), ("B", ("psum_packed",)))
             for perm, rep in MODES for coll in colls]
    cases += [dict(name=f"drift-{_mode(perm, rep)}", kind="ota", process="drift",
                   cfg=dict(channel="symbol_replay", permuted=perm, representation=rep))
              for perm, rep in MODES]
    cases += [dict(name="drift-faultsA-packed-base", kind="ota", process="drift", faults="A",
                   cfg=dict(channel="symbol_replay", representation="packed")),
              dict(name="static-faultsA-recentred-unpacked", kind="ota", process="static",
                   faults="A", recentre=True, cfg=dict(channel="symbol_replay")),
              dict(name="quarantine-packed-perm-rs_ag", kind="ota", process="static",
                   quarantine=[2, 5], cfg=dict(channel="bsc_replay", permuted=True,
                                               representation="packed", collective="rs_ag")),
              dict(name="mt-drift-faultsA-packed-base", kind="mt", process="drift", faults="A",
                   cfg=dict(channel="symbol_replay", representation="packed")),
              dict(name="mt-faultsB-unpacked-perm-psum_packed", kind="mt", faults="B",
                   cfg=dict(channel="bsc_replay", permuted=True,
                            collective="psum_packed"))]
    return cases


def _serve_case(mesh, inputs, case) -> dict:
    cfg = scaleout.ScaleOutConfig(**SMALL, **case["cfg"])
    _, tx, s = _place(mesh)
    pack = (lambda b: hv.pack(b)) if cfg.packed else (lambda b: b)
    books = [torch.from_numpy(np.array(inputs[k])) for k in ("protos_u", "protos2_u")]
    state = _state(inputs)
    proc = None
    if case.get("process"):
        proc = phy.StaticProcess() if case["process"] == "static" else PROCESSES[case["process"]]()
        state = proc.init(state)
        if case.get("quarantine"):
            q = torch.zeros(cfg.n_rx_cores, dtype=torch.bool)
            q[case["quarantine"]] = True
            state = phy.set_quarantine(state, q)
    fstate = model = None
    if case.get("faults"):
        fstate, model = global_fstate(cfg, inputs, case["faults"], s), faults.StaticFaults()
    if case["kind"] == "mt":
        rows = [1, 0, 1]
        store = torch.stack([pack(b) for b in books])
        q = torch.stack([scaleout.make_queries(torch.Generator().manual_seed(10 + i), cfg,
                                               books[r], model_size=s)[1]
                         for i, r in enumerate(rows)])
        store, q, st, *fs = scaleout.shard_inputs(cfg, mesh, store, q, state, slots=True,
                                                  fstate=fstate)
        fn = scaleout.make_mt_ota_serve(cfg, device=CPU, process=proc, faults=model, mesh=mesh)
        head = (store, q, torch.tensor(rows, dtype=torch.int32))
        gens = lambda: [torch.Generator().manual_seed(20 + i) for i in range(len(rows))]  # noqa: E731
    else:
        q = scaleout.make_queries(torch.Generator().manual_seed(1), cfg, books[0],
                                  model_size=s)[1]
        protos, q, st, *fs = scaleout.shard_inputs(cfg, mesh, pack(books[0]), q, state,
                                                   fstate=fstate)
        fn = scaleout.make_ota_serve(cfg, device=CPU, process=proc, faults=model, mesh=mesh)
        head = (protos, q)
        gens = lambda: torch.Generator().manual_seed(2)                 # noqa: E731
    if case.get("recentre"):
        dead = (fs[0].dead_tx | fs[0].vote_drop)[:cfg.m_tx]
        st = dataclasses.replace(st, chan=faults.recenter_state(st.chan, dead))
    pgens = phy.process_generators(7, CPU)
    fgen = torch.Generator().manual_seed(8)
    out = dict(pred=[], sim=[], bytes=[])
    for _ in range(2 if proc is not None else 1):                       # two process steps
        args = head + (st, gens())
        if proc is not None:
            args += (pgens,)
        if model is not None:
            args += (fs[0], fgen)
        collectives.reset_wire_bytes()
        pred, sim, *evolved = fn(*args)
        out["bytes"].append(collectives.wire_bytes())
        out["pred"].append(pred.numpy())
        out["sim"].append(sim.numpy())
        if proc is not None:
            st = evolved.pop(0)
        if model is not None:
            fs = [evolved.pop(0)]
    out["pred"], out["sim"] = np.stack(out["pred"]), np.stack(out["sim"])
    if proc is not None:
        out["pstate"] = _leaves(st)
    if model is not None:
        out["fstate"] = _leaves(fs[0])
    return out


# ---------------------------------------------------------------------------
# the three HDC engines and the scheduler
# ---------------------------------------------------------------------------

ENGINE = dict(SMALL, representation="packed", channel="bsc")
TRACE = [0, 1, 1, 0, 1, 0, 0, 1]                   # each request's tenant


def _requests(cfg, books, s: int) -> list:
    """(tenant, queries in the model-column layout of S = ``s``, noise seed)."""
    return [(t, scaleout.make_queries(torch.Generator().manual_seed(100 + i), cfg, books[t],
                                      model_size=s)[1], 1000 + i) for i, t in enumerate(TRACE)]


def _completions(sched, rids) -> list:
    return [(c.rid, c.tenant, c.pred, c.maxsim, c.t_submit, c.t_admit, c.t_finish, c.status)
            for c in (sched.results[r] for r in rids)]


def _drive(eng, books, reqs, clock=None, **kw) -> tuple:
    """Onboard the tenants, submit every request at once on generators
    seeded alike and run to the end: (completions, rids)."""
    for t, b in enumerate(books):
        eng.registry.onboard(t, b)
    sched = HDCScheduler(eng, **({} if clock is None else dict(clock=clock)), **kw)
    rids = [sched.submit(t, q, generator=torch.Generator().manual_seed(seed))
            for t, q, seed in reqs]
    sched.run(timeout=600)
    return sched, rids


def _standalone(cfg, mesh, state, banks, reqs, fstate=None) -> list:
    """Each request's standalone serve on this rank (its rows of the batch,
    on `rank_generator` of the request's generator), fault-aware under a
    static ``fstate`` (global) when given."""
    if fstate is None:
        fn = scaleout.make_ota_serve(cfg, device=CPU, mesh=mesh)
    else:
        f_rows = scaleout.shard_state_of(cfg, mesh, fstate)
        fserve = scaleout.make_ota_serve(cfg, device=CPU, faults=faults.StaticFaults(),
                                         mesh=mesh)
        fn = lambda *a: fserve(*a, f_rows, None)[:2]                    # noqa: E731
    out = []
    for t, q, seed in reqs:
        protos, q_l, st = scaleout.shard_inputs(cfg, mesh, banks[t], q, state)
        g = rank_generator(torch.Generator().manual_seed(seed), mesh)
        pred, sim = fn(protos, q_l, st, g)
        out.append((pred.numpy(), sim.numpy()))
    return out


def _engine_setup(mesh, inputs):
    """(cfg, global state, the two tenants' packed banks, the requests)."""
    cfg = scaleout.ScaleOutConfig(**ENGINE)
    books = [torch.from_numpy(np.array(inputs[k])) for k in ("protos_u", "protos2_u")]
    return cfg, _state(inputs), [hv.pack(b) for b in books], _requests(cfg, books,
                                                                       _place(mesh)[2])


def engines(mesh, inputs) -> dict:
    """The three engines on this rank: HDCEngine and FaultTolerantHDCEngine
    (StaticProcess, StaticFaults, scenario A) against their rank-standalone
    serves, and the adaptive and fault-tolerant engines on a drifting
    channel whose controller re-fits, quarantines, drops the fleet mode and
    remaps: their traces and completions."""
    cfg, state, books, reqs = _engine_setup(mesh, inputs)
    out = {}
    sched, rids = _drive(HDCEngine(cfg, state, num_slots=3, max_tenants=2, device=CPU,
                                   mesh=mesh), books, reqs)
    out["engine"] = dict(done=_completions(sched, rids), steps=sched.steps,
                         standalone=_standalone(cfg, mesh, state, books, reqs))
    fstate = global_fstate(cfg, inputs, "A", _place(mesh)[2])
    ft = FaultTolerantHDCEngine(cfg, state, process=phy.StaticProcess(),
                                fault_model=faults.StaticFaults(), fstate=fstate, num_slots=3,
                                max_tenants=2, device=CPU, mesh=mesh)
    sched, rids = _drive(ft, books, reqs)
    out["ft-static"] = dict(done=_completions(sched, rids), steps=sched.steps,
                            standalone=_standalone(cfg, mesh, state, books, reqs, fstate))
    # a drifting, fading channel: re-fits, quarantines, the fleet mode and remaps
    ctl = dict(patience=1, band_kwargs={"cap": 0.02}, quarantine_ber=0.05,
               quarantine_after=1, release_ber=0.01, release_after=2, drop_frac=0.25,
               m_floor=1, alt_collective="psum_packed")
    for name, kind, extra in (
            ("adaptive", AdaptiveHDCEngine, dict(controller=LinkControllerConfig(**ctl))),
            ("ft-drift", FaultTolerantHDCEngine,
             dict(controller=FaultControllerConfig(**ctl, remap_after=2),
                  fault_model=faults.WearoutFaults(p_die=0.05, stuck_rate=0.01),
                  fault_generator=torch.Generator().manual_seed(4)))):
        eng = kind(cfg, state, process=phy.BlockFadingProcess(sigma_db=8.0, block=1,
                                                              guard_dims=64),
                   num_slots=2, max_tenants=2, device=CPU, mesh=mesh,
                   process_generators=phy.process_generators(3, CPU), **extra)
        sched, rids = _drive(eng, books, reqs)
        out[name] = dict(done=_completions(sched, rids), steps=sched.steps,
                         trace=eng.controller.trace, pstate=_leaves(eng.pstate),
                         fstate=_leaves(eng.fstate) if hasattr(eng, "fstate") else None)
    return out


def skewed_scheduler(mesh, inputs) -> dict:
    """An HDCEngine run whose ranks read clocks skewed apart (rank r's runs
    r * 1000 s ahead, at (r + 1) x its speed), with a slot deadline and a
    timeout: the completions, timestamps included."""
    import torch.distributed as dist

    cfg, state, books, reqs = _engine_setup(mesh, inputs)
    r = dist.get_rank() if mesh is not None else 0
    ticks = [0]

    def clock():
        ticks[0] += 1
        return 1000.0 * r + 0.125 * (r + 1) * ticks[0]

    sched, rids = _drive(HDCEngine(cfg, state, num_slots=3, max_tenants=2, device=CPU,
                                   mesh=mesh), books, reqs, clock=clock, max_slot_steps=1)
    return dict(done=_completions(sched, rids), steps=sched.steps)


def run(mesh, inputs: dict) -> dict:
    """Every case on this rank (``mesh=None``: on one rank, the whole
    inputs): {name: outputs}, plus this rank's coordinates."""
    dpos, tx, _ = _place(mesh)
    b = scaleout.shard_batch(mesh, torch.arange(SMALL["batch"]))
    rows = slice(int(b[0]), int(b[-1]) + 1)
    phy.register_channel(ranks.ReplayChannel(torch.from_numpy(np.array(inputs["masks"]))[:, rows]),
                         override=True)
    phy.register_channel(ranks.SymbolReplay(*(torch.from_numpy(np.array(inputs[k]))[:, rows]
                                              for k in ("nr", "ni", "flips"))), override=True)
    out = {"coords": (dpos, tx)}
    out.update(rollouts(mesh, inputs))
    for case in serve_cases():
        out[case["name"]] = _serve_case(mesh, inputs, case)
    out.update(engines(mesh, inputs))
    out["scheduler"] = skewed_scheduler(mesh, inputs)
    return out


# ---------------------------------------------------------------------------
# against the reference's 8-device serve
# ---------------------------------------------------------------------------

def jax_cases(mesh, inputs: dict, cases: list) -> dict:
    """The 2x4 serves under StaticProcess and StaticFaults on the
    reference's inputs: its queries (``<name>/queries``), its codebook, its
    flip masks replayed by core and its fault leaves (``jax/dead_rx``,
    ``jax/dead_tx``, ``jax/stuck0``, ``jax/stuck1``, ``jax/serve_rows``,
    ``jax/rx_mask``, global, for m_slots = 4). {name: (pred, maxsim)}."""
    dpos, tx, s = _place(mesh)
    b = scaleout.shard_batch(mesh, torch.arange(inputs["masks"].shape[1]))
    rows = slice(int(b[0]), int(b[-1]) + 1)
    phy.register_channel(ranks.ReplayChannel(torch.from_numpy(np.array(inputs["masks"]))[:, rows]),
                         override=True)
    state = phy.state_from_ber(torch.from_numpy(np.array(inputs["ber"])), 3)
    out = {"coords": (dpos, tx)}
    for name, kw in cases:
        cfg = scaleout.ScaleOutConfig(**kw)
        f = faults.inject(faults.healthy_for(cfg, CPU, model_size=s), **{
            k: np.array(inputs[f"jax/{k}"]) for k in ("dead_rx", "dead_tx", "stuck0", "stuck1",
                                                      "serve_rows", "rx_mask")})
        book = torch.from_numpy(np.array(inputs["protos_u"]))
        q = torch.from_numpy(np.array(inputs[f"{name}/queries"]))
        proc = phy.StaticProcess()
        protos, q, pst, fst = scaleout.shard_inputs(cfg, mesh, hv.pack(book) if cfg.packed
                                                    else book, q, proc.init(state), fstate=f)
        fn = scaleout.make_ota_serve(cfg, device=CPU, process=proc,
                                     faults=faults.StaticFaults(), mesh=mesh)
        pred, sim, *_ = fn(protos, q, pst, torch.Generator().manual_seed(2), None, fst, None)
        out[name] = dict(pred=pred.numpy(), sim=sim.numpy())
    return out
