"""The port's living channels (repro_torch.phy.process, the process serve
and classifier.run_drift_sweep) against the JAX package at a small size:
16 RX cores, M = 3, d = 512.

A process step is held against JAX's on JAX's own draws (the phase
increments, the fades, the guard combos and the guard AWGN, made from the
reference's per-row keys), step after step: ``h`` and ``symbols`` within
rtol 1e-5 (a complex64 exp and einsum, summed in another order), the BERs
within 1e-5 absolute (their erfc), ``est`` within 1e-6 (the guard decode's
bits are equal, so only the EW-MA's rounding differs). The port's own
randomness is held to the two properties the reference pins: a guard
monitor never changes the physics trajectory, and a rollout resumed from
an intermediate state with its generators' state continues as the
uninterrupted one. StaticProcess serves equal process-free serves bit for
bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import phy as jphy
from repro_torch import convert, phy as tphy
from repro_torch.faults import StaticFaults, healthy_for
from repro_torch.core import classifier as tclf, hypervector as thv, scaleout as tscale

CPU = "cpu"
SMALL = dict(n_classes=32, dim=512, m_tx=3, n_rx_cores=16, batch=8)


@pytest.fixture(scope="module")
def states():
    """A real 3 TX / 16 RX characterization (the port's search), as (JAX
    state, port state) on the same leaves."""
    tstate = tscale.precharacterize_state(tscale.ScaleOutConfig(**SMALL), device=CPU)
    jstate = jphy.ChannelState(*(jnp.asarray(a) for a in convert.to_numpy(tstate).values()))
    return jstate, tstate


def _jax_leaves(p):
    """A JAX ProcessState as the dict `convert.pstate_from_numpy` takes."""
    out = {f: np.asarray(getattr(p, f)) for f in tphy.ProcessState.FIELDS if f != "chan"}
    out["chan"] = {f: np.asarray(getattr(p.chan, f)) for f in tphy.ChannelState.FIELDS}
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_step_draws(proc, key, t, n, m, b):
    """The draws of JAX's `proc.step(key, p)` at time t, from its per-row
    keys fold_in(fold_in(key, t), row) and their sub-stream folds."""
    kr = jphy.row_keys(key, jnp.int32(t), 0, n)
    draws = {}
    if isinstance(proc, tphy.PhaseDriftProcess):
        def inc(k):
            k_rx, k_tx = jax.random.split(jax.random.fold_in(k, 0))
            return proc.sigma * jax.random.normal(k_rx, ()) + proc.tx_sigma * jax.random.normal(
                k_tx, (m,))
        draws["evolve"] = _t(jax.vmap(inc)(kr))
    elif isinstance(proc, tphy.BlockFadingProcess):
        def fade(k):
            z = jax.random.normal(jax.random.fold_in(k, 0), ())
            return (10.0 ** (proc.sigma_db * z / 20.0)).astype(jnp.float32)
        draws["evolve"] = _t(jax.vmap(fade)(kr))
    if proc.guard_dims > 0:
        def guard(k):
            kg, kn = jax.random.split(jax.random.fold_in(k, 2))
            kr2, ki2 = jax.random.split(kn)
            return (jax.random.randint(kg, (proc.guard_dims,), 0, b),
                    jax.random.normal(kr2, (proc.guard_dims,)),
                    jax.random.normal(ki2, (proc.guard_dims,)))
        combos, nr, ni = jax.vmap(guard)(kr)
        draws["guard"] = (_t(np.asarray(combos).astype(np.int64)), _t(nr), _t(ni))
    return draws


def _close(port, ref, what):
    """Hold a port ProcessState against a JAX one within the stated tolerances."""
    ref = _jax_leaves(ref)
    for f, tol in (("h", 1e-5), ("symbols", 1e-5)):
        r = ref["chan"][f]
        np.testing.assert_allclose(getattr(port.chan, f).numpy(), r, rtol=tol,
                                   atol=tol * np.abs(r).max(), err_msg=f"{what} {f}")
    np.testing.assert_allclose(port.chan.ber.numpy(), ref["chan"]["ber"], rtol=0, atol=1e-5,
                               err_msg=f"{what} ber")
    np.testing.assert_allclose(port.est.numpy(), ref["est"], rtol=0, atol=1e-6,
                               err_msg=f"{what} est")
    for f in ("phase", "fade"):
        np.testing.assert_allclose(getattr(port, f).numpy(), ref[f], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{what} {f}")
    np.testing.assert_array_equal(port.chan.valid.numpy(), ref["chan"]["valid"])
    assert int(port.t) == int(ref["t"])


PROCS = {
    "phase_drift": dict(sigma=0.3, tx_sigma=0.05, guard_dims=32),
    "block_fading": dict(sigma_db=4.0, block=2, guard_dims=32),
    "interferer": dict(amp=0.6, omega=0.7, guard_dims=32),
    "static": dict(),
}


@pytest.mark.parametrize("name", sorted(PROCS))
def test_process_step_matches_jax_on_replayed_draws(states, name):
    jstate, tstate = states
    jproc, tproc = jphy.get_process(name, **PROCS[name]), tphy.get_process(name, **PROCS[name])
    jp, tp = jproc.init(jstate), tproc.init(tstate)
    _close(tp, jp, f"{name} init")
    key = jax.random.PRNGKey(1)
    for t in range(3):
        draws = _jax_step_draws(tproc, key, t, 16, 3, 8)
        jp = jproc.step(key, jp)
        tp = tproc.step(None, tp, draws=draws)
        _close(tp, jp, f"{name} step {t}")
    if name != "static":
        assert not torch.equal(tp.chan.symbols, tstate.symbols)


def test_recharacterize_and_monitor_band_match_jax(states):
    jstate, _ = states
    proc = jphy.PhaseDriftProcess(sigma=0.3, guard_dims=16)
    drifted, _ = jphy.rollout(proc, proc.init(jstate), jax.random.PRNGKey(1), 6)
    tp = convert.pstate_from_numpy(_jax_leaves(drifted), CPU)
    _close(tp, drifted, "carried across")
    mask = np.arange(16) % 3 == 0
    for m in (None, mask):
        ref = jphy.recharacterize(drifted, None if m is None else jnp.asarray(m))
        got = tphy.recharacterize(tp, None if m is None else _t(m))
        _close(got, ref, "recharacterize")
        np.testing.assert_allclose(got.chan.c0.numpy(), np.asarray(ref.chan.c0), rtol=1e-5)
        np.testing.assert_allclose(got.chan.c1.numpy(), np.asarray(ref.chan.c1), rtol=1e-5)
        for kw in ({}, {"cap": 0.05}):
            np.testing.assert_allclose(tphy.monitor_band(got, **kw).numpy(),
                                       np.asarray(jphy.monitor_band(ref, **kw)),
                                       rtol=0, atol=1e-6)
    # the state carries back: to_numpy of the port's state is JAX's leaves
    back = convert.to_numpy(got)
    np.testing.assert_array_equal(back["quarantine"], np.asarray(ref.quarantine))
    assert back["t"] == 6 and back["chan"]["symbols"].dtype == np.complex64


def test_invalid_rows_keep_their_ber_and_registry():
    synth = tphy.state_from_ber(torch.full((4,), 0.07), 3)
    proc = tphy.PhaseDriftProcess(sigma=0.5, guard_dims=8)
    p0 = proc.init(synth)
    final, traj = tphy.rollout(proc, p0, tphy.process_generators(0, CPU), 3)
    assert len(traj) == 3 and int(final.t) == 3
    assert torch.equal(final.chan.ber, torch.full((4,), 0.07))
    assert torch.equal(final.est, p0.est)
    assert sorted(tphy.PROCESSES) == ["block_fading", "interferer", "phase_drift", "static"]
    assert tphy.get_process("phase_drift", sigma=0.2).sigma == 0.2
    with pytest.raises(ValueError, match="unknown channel process"):
        tphy.get_process("solar_flare")
    with pytest.raises(ValueError, match="already registered"):
        tphy.register_process(tphy.StaticProcess)
    with pytest.raises(ValueError, match="ProcessGenerators"):
        proc.step(None, p0)


# ---------------------------------------------------------------------------
# the port's own randomness
# ---------------------------------------------------------------------------

def _leaves(p):
    return [p.chan.h, p.chan.symbols, p.chan.ber, p.chan.c0, p.chan.c1, p.chan.valid,
            p.phase, p.fade, p.est, p.quarantine, p.t]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def test_guard_monitor_never_moves_the_physics(states):
    _, tstate = states
    runs = []
    for guard in (0, 64):
        proc = tphy.PhaseDriftProcess(sigma=0.2, tx_sigma=0.05, guard_dims=guard)
        _, traj = tphy.rollout(proc, proc.init(tstate), tphy.process_generators(3, CPU), 5)
        runs.append(traj)
    for a, b in zip(*runs):
        for x, y in ((a.chan.h, b.chan.h), (a.chan.symbols, b.chan.symbols),
                     (a.chan.ber, b.chan.ber), (a.phase, b.phase)):
            assert torch.equal(x, y)
    assert not torch.equal(runs[0][-1].est, runs[1][-1].est)


@pytest.mark.parametrize("name", ["phase_drift", "block_fading"])
def test_resumed_rollout_continues_the_uninterrupted_one(states, name):
    _, tstate = states
    proc = tphy.get_process(name, **PROCS[name])
    full, _ = tphy.rollout(proc, proc.init(tstate), tphy.process_generators(5, CPU), 6)
    gens = tphy.process_generators(5, CPU)
    mid, _ = tphy.rollout(proc, proc.init(tstate), gens, 3)
    # resume in a new state object and new generators, from their saved state
    mid = convert.pstate_from_numpy(convert.to_numpy(mid), CPU)
    resumed = tphy.process_generators(99, CPU)
    resumed.set_state(gens.get_state())
    end, _ = tphy.rollout(proc, mid, resumed, 3)
    assert _same(end, full)


def _cond_style(proc, p, gens, n, patience, band_kwargs):
    """The reference's loop: re-fit only when a row trips (a host branch)."""
    bnd = tphy.monitor_band(p, **band_kwargs)
    over = torch.zeros(p.chan.ber.shape, dtype=torch.int32)
    traj = []
    for _ in range(n):
        p = proc.step(gens, p)
        over = torch.where(p.est > bnd, over + 1, 0)
        trip = (over >= patience) & p.chan.valid
        if bool(trip.any()):
            p = tphy.recharacterize(p, trip)
            bnd = torch.where(trip, tphy.monitor_band(p, **band_kwargs), bnd)
        over = torch.where(trip, 0, over)
        traj.append(p)
    return traj


def test_adaptive_rollout_masked_refit_equals_the_branch(states):
    _, tstate = states
    proc = tphy.PhaseDriftProcess(sigma=0.15, alpha=0.5, guard_dims=64)
    kw = {"cap": 0.05}
    _, traj, trips = tphy.adaptive_rollout(proc, proc.init(tstate),
                                           tphy.process_generators(2, CPU), 12,
                                           patience=2, band_kwargs=kw)
    ref = _cond_style(proc, proc.init(tstate), tphy.process_generators(2, CPU), 12, 2, kw)
    assert all(_same(a, b) for a, b in zip(traj, ref))
    t = trips.numpy()
    assert t.shape == (12, 16) and t.any()
    assert not (t[1:] & t[:-1]).any()        # patience 2: never on consecutive steps
    assert any(not row.any() for row in t)    # and some steps re-fit nothing


# ---------------------------------------------------------------------------
# the process serve and the drift sweep
# ---------------------------------------------------------------------------

def _serve_inputs(cfg, classes=None):
    """Prototypes and queries of one serve; ``classes`` [B, M] fixes the
    queries' classes (else they are drawn)."""
    protos = tclf.make_codebook(torch.Generator().manual_seed(0),
                                tclf.HDCTaskConfig(n_classes=cfg.n_classes, dim=cfg.dim),
                                device=CPU)
    if classes is None:
        _, q = tscale.make_queries(torch.Generator().manual_seed(1), cfg, protos)
    else:
        q = protos[classes].reshape(cfg.batch, 1, cfg.m_tx, cfg.dim)
        q = thv.pack(q) if cfg.packed else q
    return (thv.pack(protos) if cfg.packed else protos), q


@pytest.mark.parametrize("channel", ["bsc", "symbol"])
@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_static_process_serve_equals_the_process_free_serve(states, channel, rep):
    _, tstate = states
    for permuted in (False, True):
        cfg = tscale.ScaleOutConfig(**SMALL, channel=channel, representation=rep,
                                    permuted=permuted)
        state = tstate if channel == "symbol" else tphy.state_from_ber(
            torch.full((16,), 0.05), 3)
        protos, q = _serve_inputs(cfg)
        serve = tscale.make_ota_serve(cfg, device=CPU)
        pserve = tscale.make_ota_serve(cfg, device=CPU, process=tphy.StaticProcess())
        pstate = tphy.StaticProcess().init(state)
        g, pg = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
        for _ in range(3):
            want = serve(protos, q, state, g)
            pred, sim, pstate = pserve(protos, q, pstate, pg, tphy.process_generators(0, CPU))
            assert torch.equal(pred, want[0]) and torch.equal(sim, want[1])
        assert int(pstate.t) == 3
        assert all(torch.equal(getattr(pstate.chan, f), getattr(state, f))
                   for f in tphy.ChannelState.FIELDS)


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_quarantine_excludes_the_core_classes(states, rep):
    _, tstate = states
    per_core = SMALL["n_classes"] // SMALL["n_rx_cores"]
    for permuted in (False, True):
        cfg = tscale.ScaleOutConfig(**SMALL, channel="symbol", representation=rep,
                                    permuted=permuted)
        # every TX sends core 0's classes in the first rows
        classes = (torch.arange(24).reshape(8, 3) * 5) % 32
        classes[:2] = torch.tensor([[0], [1]])
        protos, q = _serve_inputs(cfg, classes)
        pserve = tscale.make_ota_serve(cfg, device=CPU, process=tphy.StaticProcess())
        p0 = tphy.StaticProcess().init(tstate)
        gens = tphy.process_generators(0, CPU)
        open_, _, _ = pserve(protos, q, p0, torch.Generator().manual_seed(5), gens)
        assert bool((open_ < per_core).any())     # core 0's classes do win unmasked
        quar = tphy.set_quarantine(p0, torch.arange(16) == 0)
        pred, _, _ = pserve(protos, q, quar, torch.Generator().manual_seed(5), gens)
        assert bool((pred >= per_core).all()), pred


def test_process_serve_steps_then_serves(states):
    """A drifting process serve: the state advances each call, and the call
    serves through the evolved channel (equal to the process-free serve on
    the state the step produced); its fault-threading form on the healthy
    fault state steps and answers alike."""
    _, tstate = states
    cfg = tscale.ScaleOutConfig(**SMALL, channel="symbol")
    protos, q = _serve_inputs(cfg)
    proc = tphy.PhaseDriftProcess(sigma=0.2, guard_dims=16)
    pserve = tscale.make_ota_serve(cfg, device=CPU, process=proc)
    p0 = proc.init(tstate)
    gens = tphy.process_generators(1, CPU)
    saved = gens.get_state()
    pred, sim, p1 = pserve(protos, q, p0, torch.Generator().manual_seed(6), gens)
    gens.set_state(saved)
    stepped = proc.step(gens, p0)
    assert _same(stepped, p1) and int(p1.t) == 1
    want = tscale.make_ota_serve(cfg, device=CPU)(protos, q, stepped.chan,
                                                  torch.Generator().manual_seed(6))
    assert torch.equal(pred, want[0]) and torch.equal(sim, want[1])
    with pytest.raises(ValueError, match="sparse"):
        tscale.make_ota_serve(tscale.ScaleOutConfig(**SMALL, representation="sparse",
                                                    k_max=64), device=CPU, process=proc)
    # with a fault model on the healthy state: the same step, the same answers
    fserve = tscale.make_ota_serve(cfg, device=CPU, process=proc, faults=StaticFaults())
    gens.set_state(saved)
    fpred, fsim, f1, fstate = fserve(protos, q, p0, torch.Generator().manual_seed(6), gens,
                                     healthy_for(cfg, CPU), None)
    assert _same(f1, p1) and torch.equal(fpred, pred) and torch.equal(fsim, sim)
    assert int(fstate.t) == 1


def test_drift_sweep_closed_loop_recovers():
    """The reference test's scenario on the port's own generators: phase
    drift costs the open loop >= 3 accuracy points in the tail, the banded
    monitor and EM re-fit recover to within 1 point of no drift."""
    cfg16 = tscale.ScaleOutConfig(n_classes=64, dim=512, m_tx=3, n_rx_cores=16, batch=8)
    state = tscale.precharacterize_state(cfg16, device=CPU)
    tcfg = tclf.HDCTaskConfig(n_classes=64, dim=512, n_trials=128)
    proc = tphy.PhaseDriftProcess(sigma=0.15, alpha=0.5, guard_dims=128)
    n_steps, tail = 25, 8
    base = tclf.run_drift_sweep(7, tcfg, 3, state, tphy.StaticProcess(), 1, device=CPU)
    static = tclf.run_drift_sweep(7, tcfg, 3, state, proc, n_steps, device=CPU)
    adapt = tclf.run_drift_sweep(7, tcfg, 3, state, proc, n_steps, adaptive=True, patience=1,
                                 band_kwargs={"cap": 0.05}, device=CPU)
    baseline = base["acc"][0]
    drop = 100.0 * (baseline - np.mean(static["acc"][-tail:]))
    gap = 100.0 * (baseline - np.mean(adapt["acc"][-tail:]))
    assert drop >= 3.0, (drop, static["acc"])
    assert gap <= 1.0, (gap, adapt["acc"])
    assert adapt["n_refits"] > 0 and static["n_refits"] == 0
    assert len(adapt["acc"]) == n_steps and adapt["refits"].shape == (n_steps, 16)
