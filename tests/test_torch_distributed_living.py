"""Living channels, fault injection and the HDC service across ranks (gloo
ranks on the CPU) against one rank: 40 classes over 8 cores, d = 512,
M = 3, B = 8 on (data, model) grids of 1x2, 1x4 and 2x2 ranks.

Each model rank holds its cores' rows of the process and fault state
(`phy.shard_pstate`, `faults.shard_fstate`) and steps them at its
``rx_base``; the draws span the global rows on generators seeded alike.
Bit for bit:

* three processes (drift, fading, interferer) and the wearout model over
  3 steps: every rank's rows == the one-rank rows, data replicas equal;
  the transient vote erasures whole and alike on every rank;
* the process and fault serves on noise replayed by core == the one-rank
  serve in the four modes x psum / psum_packed / rs_ag (fault scenario A:
  cores 1 and 5 dead and failed over, core 5 on model rank > 0, stuck
  cells, TX 2 dead; B: a whole shard dead, TX 1's vote dropped), the
  symbol tier through a drifting process (also with faults and with the
  decoder re-centred on the rank's shard), a quarantine, and the
  multi-tenant serve with both states per slot, the evolved states'
  rows included;
* the three HDC engines: `HDCEngine` and `FaultTolerantHDCEngine` (static
  faults, scenario A) complete every request as its rank-standalone serve
  on `rank_generator`, and the adaptive and fault-tolerant engines on a
  fading channel take the one-rank engine's controller trace (re-fits,
  quarantines, the fleet-mode drop and failover remaps), every rank's
  completion list being the same; on 1x2 and 1x4 every engine's
  completions equal the one-rank engine's (the noise draws are
  mesh-layout invariant);
* a scheduler whose ranks read skewed clocks completes alike on every rank,
  timestamps included (`collectives.SharedClock`).

And the 2x4 serve under StaticProcess + StaticFaults equals the
reference's 8-device serve with process= and faults= (run in a subprocess
with 8 host devices, as tests/test_torch_distributed.py does) on ideal and
on JAX's own flip masks replayed by core.

Every world of ranks starts once for the module (`launch.mesh.spawn`, a
``file://`` store under pytest's temporary directory, a join timeout)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_dist_living_ranks as lranks
from repro_torch import faults
from repro_torch.core import scaleout
from repro_torch.launch import mesh as tmesh

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
GRIDS = [(1, 2), (1, 4), (2, 2)]
GRID_IDS = lambda g: f"{g[0]}x{g[1]}"                       # noqa: E731
CASES = [c["name"] for c in lranks.serve_cases()]


@pytest.fixture(scope="module")
def inputs():
    """Every rank's global inputs, made from a seed with numpy (the failover
    plans for shards of 2 cores, which keep inside every grid's shards)."""
    rng = np.random.default_rng(0)
    cfg = scaleout.ScaleOutConfig(**lranks.SMALL)
    n, b, d = cfg.n_rx_cores, cfg.batch, cfg.dim
    state = scaleout.precharacterize_state(cfg, device="cpu")
    ber = np.linspace(0.0, 0.3, n).astype(np.float32)
    out = dict(protos_u=rng.integers(0, 2, (cfg.n_classes, d), dtype=np.uint8),
               protos2_u=rng.integers(0, 2, (cfg.n_classes, d), dtype=np.uint8),
               masks=(rng.random((n, b, d)) < ber[:, None, None]).astype(np.uint8),
               nr=rng.standard_normal((n, b, d), dtype=np.float32),
               ni=rng.standard_normal((n, b, d), dtype=np.float32),
               flips=rng.random((n, b, d)) < 0.05,
               stuck0=(rng.random((n, cfg.words * 32)) < 0.02),
               stuck1=(rng.random((n, cfg.words * 32)) < 0.02))
    s0 = np.packbits(out["stuck0"], axis=-1, bitorder="little").view(np.int32)
    s1 = np.packbits(out["stuck1"], axis=-1, bitorder="little").view(np.int32) & ~s0
    out.update(stuck0=s0, stuck1=s1)
    for name, sc in lranks.FAULT_SCENARIOS.items():
        f = faults.plan_failover(faults.inject(faults.healthy_for(cfg, "cpu"),
                                               dead_rx=sc["dead_rx"]), 2)
        out[f"{name}/serve_rows"], out[f"{name}/rx_mask"] = f.serve_rows.numpy(), f.rx_mask.numpy()
    out.update({f"state_{f}": getattr(state, f).numpy() for f in state.FIELDS})
    return out


@pytest.fixture(scope="module")
def one(inputs):
    return lranks.run(None, inputs)


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """grid -> every rank's results, each grid's ranks started once."""
    cache = {}

    def get(grid):
        if grid not in cache:
            try:
                cache[grid] = tmesh.spawn(lranks.run, grid, (inputs,), timeout=120,
                                          store_dir=tmp_path_factory.mktemp("ranks"))
            except (RuntimeError, TimeoutError) as e:
                cache[grid] = e
        if isinstance(cache[grid], Exception):
            raise cache[grid]
        return cache[grid]

    return get


def model_rows(results, get) -> np.ndarray:
    """The global [N, ...] leaf of the ranks' rows: every data replica of a
    model column alike, the columns' rows in order."""
    by = {r["coords"]: get(r) for r in results}
    n_data, n_model = 1 + max(d for d, _ in by), 1 + max(t for _, t in by)
    for t in range(n_model):
        for d in range(n_data):
            np.testing.assert_array_equal(by[(d, t)], by[(0, t)],
                                          err_msg=f"data replica {d} of column {t}")
    return np.concatenate([by[(0, t)] for t in range(n_model)])


def data_rows(results, get, axis: int) -> np.ndarray:
    """The global answer of the ranks' rows of the batch (``axis``): every
    model rank of a data row alike, the data rows in order."""
    by = {r["coords"]: get(r) for r in results}
    n_data, n_model = 1 + max(d for d, _ in by), 1 + max(t for _, t in by)
    for d in range(n_data):
        for t in range(n_model):
            np.testing.assert_array_equal(by[(d, t)], by[(d, 0)], err_msg=f"model rank {t}")
    return np.concatenate([by[(d, 0)] for d in range(n_data)], axis=axis)


def whole(leaf: str) -> bool:
    """Leaves every rank holds whole: the time, the fault state's TX side and
    the channel's phase assignment and noise density."""
    return leaf in ("t", "dead_tx", "vote_drop", "chan/phase_idx", "chan/n0")


def check_state(results, get, want: dict, what: str) -> None:
    """Every leaf of a process or fault state: the ranks' rows (or the whole
    leaf) == the one-rank state's; the TX leaves over the M real slots."""
    for leaf, w in want.items():
        if whole(leaf):
            for r in results:
                got = get(r)[leaf]
                got = got[:len(w)] if leaf in ("dead_tx", "vote_drop") else got
                np.testing.assert_array_equal(got, w, err_msg=f"{what} {leaf}")
        else:
            np.testing.assert_array_equal(model_rows(results, lambda r: get(r)[leaf]), w,
                                          err_msg=f"{what} {leaf}")


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("name", [f"process-{p}" for p in lranks.PROCESSES] + ["faults-wearout"])
def test_rank_rows_evolve_as_the_one_rank_state(worlds, one, grid, name):
    results = worlds(grid)
    for k, want in enumerate(one[name]):
        check_state(results, lambda r: r[name][k], want, f"{grid} {name} step {k + 1}")


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_transient_vote_erasures_are_whole_and_alike(worlds, grid):
    """The erasures span every encoder slot of the mesh, drawn alike."""
    results = worlds(grid)
    for k in range(lranks.STEPS):
        drops = [r["faults-transient"][k]["vote_drop"] for r in results]
        assert drops[0].shape == (4,)                          # S * ceil(3 / S) slots
        for d in drops:
            np.testing.assert_array_equal(d, drops[0])


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("name", CASES)
def test_process_and_fault_serves_equal_one_rank(worlds, one, grid, name):
    results = worlds(grid)
    axis = 2 if name.startswith("mt") else 1                   # [steps, (N,) B, ...]
    for key in ("pred", "sim"):
        np.testing.assert_array_equal(data_rows(results, lambda r: r[name][key], axis),
                                      one[name][key], err_msg=f"{grid} {name} {key}")
    for st in ("pstate", "fstate"):
        if st in one[name]:
            check_state(results, lambda r: r[name][st], one[name][st], f"{grid} {name} {st}")
    assert all(min(r[name]["bytes"]) > 0 for r in results)


def test_dead_core_on_a_later_rank_is_failed_over_inside_it(inputs):
    """Scenario A's core 5 lies on model rank 1 of 1x2 and rank 2 of 1x4; its
    bank is served by core 4 of the same rank, a global id the serve makes
    local."""
    assert inputs["A/serve_rows"].tolist() == [0, 0, 2, 3, 4, 4, 6, 7]
    assert inputs["B/rx_mask"].tolist() == [False] * 6 + [True, True]


def check_one_rank_completions(results, want: list, what: str) -> None:
    """Every rank's completions carry the one-rank engine's answers: the
    same requests, tenants, predictions, maxsims and status (the
    timestamps are each run's own clock)."""
    for r in results:
        done = r[what.split()[-1]]["done"]
        assert len(done) == len(want)
        for a, b in zip(done, want):
            assert (a[0], a[1], a[-1]) == (b[0], b[1], b[-1]), what
            np.testing.assert_array_equal(a[2], b[2], err_msg=f"{what} rid {a[0]} pred")
            np.testing.assert_array_equal(a[3], b[3], err_msg=f"{what} rid {a[0]} sim")


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("name", ["engine", "ft-static"])
def test_engine_completes_as_the_rank_standalone_serve(worlds, one, grid, name):
    """Every rank completes the same requests alike (the whole batch,
    gathered over the data ranks), each == its standalone serve on this
    rank's `rank_generator` (fault-aware under scenario A for ft-static);
    on 1xS grids, where every rank draws on the request's own generator,
    each completion also == the one-rank engine's."""
    results = worlds(grid)
    if grid[0] == 1:
        check_one_rank_completions(results, one[name]["done"], f"{grid} {name}")
    done = results[0][name]["done"]
    assert len(done) == len(lranks.TRACE) and all(c[-1] == "ok" for c in done)
    for r in results:
        assert r[name]["steps"] == results[0][name]["steps"]
        for a, b in zip(r[name]["done"], done):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    for i, c in enumerate(done):
        for j, key in enumerate(("pred", "sim")):
            want = data_rows(results, lambda r: r[name]["standalone"][i][j], 0)
            np.testing.assert_array_equal(c[2 + j], want, err_msg=f"{grid} {name} rid {i} {key}")


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("name", ["adaptive", "ft-drift"])
def test_controller_trace_equals_the_one_rank_engine(worlds, one, grid, name):
    """On a fading channel the controller re-fits, quarantines, drops the
    fleet mode (a rebuilt serve on the mesh) and, fault-tolerant, remaps:
    the same actions at the same barriers as the one-rank engine, the
    committed states' rows its states', and the same completions on every
    rank; on 1xS grids, whose ranks draw on the request's own generator,
    the adaptive engine's completions are the one-rank engine's too (the
    fault-tolerant engine's failover remaps keep inside a rank's shard,
    where one rank's may cross it, so its answers after a remap differ)."""
    results = worlds(grid)
    if grid[0] == 1 and name == "adaptive":
        check_one_rank_completions(results, one[name]["done"], f"{grid} {name}")
    trace = one[name]["trace"]
    acts = {e["action"] for e in trace}
    assert {"refit", "quarantine", "m_drop", "link_mode"} <= acts
    assert name != "ft-drift" or "remap" in acts
    for r in results:
        assert r[name]["trace"] == trace
        assert r[name]["steps"] == one[name]["steps"]
        for a, b in zip(r[name]["done"], results[0][name]["done"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    check_state(results, lambda r: r[name]["pstate"], one[name]["pstate"], f"{grid} {name}")
    if one[name]["fstate"] is not None:
        # the failover plan keeps inside each rank's shard of 8 / S cores
        want = dict(one[name]["fstate"])
        f = faults.inject(faults.healthy_for(scaleout.ScaleOutConfig(**lranks.ENGINE), "cpu"),
                          dead_rx=want["dead_rx"])
        f = faults.plan_failover(f, lranks.SMALL["n_rx_cores"] // grid[1])
        want.update(serve_rows=f.serve_rows.numpy(), rx_mask=f.rx_mask.numpy())
        check_state(results, lambda r: r[name]["fstate"], want, f"{grid} {name} fstate")


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_scheduler_on_skewed_clocks_completes_alike_on_every_rank(worlds, grid):
    results = worlds(grid)
    done = results[0]["scheduler"]["done"]
    assert len(done) == len(lranks.TRACE)
    stamps = [c[4:7] for c in done]
    assert all(t < 1000.0 for s in stamps for t in s)          # rank 0's clock
    for r in results:
        for a, b in zip(r["scheduler"]["done"], done):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the 2x4 serve under StaticProcess + StaticFaults against the reference's
# ---------------------------------------------------------------------------

JAX_SMALL = dict(n_classes=256, dim=256, m_tx=3, n_rx_cores=8, batch=16)
JAX_CASES = [(f"{ch}-{lranks._mode(perm, rep)}-{coll}",
              dict(JAX_SMALL, channel=ch, permuted=perm, representation=rep, collective=coll))
             for ch in ("ideal", "bsc") for perm, rep in lranks.MODES
             for coll in ("psum", "psum_packed")]

JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import faults, phy
from repro.compat import make_mesh
from repro.core import hypervector as hv, scaleout
CASES, out_path = {cases!r}, sys.argv[1]
mesh = make_mesh((2, 4), ("data", "model"))
small = CASES[0][1]
n, b, d = small["n_rx_cores"], small["batch"], small["dim"]
protos = hv.random_hv(jax.random.PRNGKey(0), small["n_classes"], d)
ber = jnp.array([0.0, 0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.45], jnp.float32)
state = phy.state_from_ber(ber, 3)
key = jax.random.PRNGKey(2)
b_l = b // 2
masks = np.zeros((n, b, d), np.uint8)
for r in range(2):                      # data row r: fold_in(key, r), core g: fold_in(., g)
    for g in range(n):
        k = jax.random.fold_in(jax.random.fold_in(key, r), g)
        masks[g, r * b_l:(r + 1) * b_l] = np.asarray(
            jax.random.bernoulli(k, ber[g], (b_l, d)), np.uint8)
cfg0 = scaleout.ScaleOutConfig(**small, use_kernels=False)
s0, s1 = faults.sample_stuck_cells(jax.random.PRNGKey(6), n, cfg0.words, 0.04)
f = faults.inject(faults.healthy_for(cfg0, 4), dead_rx=[1, 5], dead_tx=[1],
                  stuck0=np.asarray(s0), stuck1=np.asarray(s1))
f = faults.plan_failover(f, 2)
out = dict(protos_u=np.asarray(protos), masks=masks, ber=np.asarray(ber))
out.update({{f"jax/{{k}}": np.asarray(getattr(f, k)) for k in
            ("dead_rx", "dead_tx", "stuck0", "stuck1", "serve_rows", "rx_mask")}})
proc, fm = phy.StaticProcess(), faults.StaticFaults()
pstate = proc.init(state)
for name, kw in CASES:
    cfg = scaleout.ScaleOutConfig(**kw, use_kernels=False)
    _, q = scaleout.make_queries(jax.random.PRNGKey(1), cfg, protos, 4)
    out[name + "/queries"] = np.asarray(q)
    p = hv.pack(protos) if cfg.packed else protos
    fn = scaleout.make_ota_serve(mesh, cfg, process=proc, faults=fm)
    pred, sim, _, _ = fn(p, q, pstate, key, jax.random.PRNGKey(3), f, jax.random.PRNGKey(4))
    out[name + "/pred"], out[name + "/sim"] = np.asarray(pred), np.asarray(sim)
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_job(tmp_path_factory):
    """The reference's 8-device run, started with the module so that it
    runs while the other worlds serve: (process, output path)."""
    path = tmp_path_factory.mktemp("jax8") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC)
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT).format(
        cases=JAX_CASES), str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax8(jax_job):
    """The reference's answers on its 8-device (2, 4) mesh with its inputs,
    flip masks and fault leaves, from a subprocess with 8 host devices."""
    proc, path = jax_job
    try:
        _, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    with np.load(path) as z:
        return {k: (z[k].view(np.int32) if z[k].dtype == np.uint32 else z[k]) for k in z.files}


@pytest.fixture(scope="module")
def grid24(jax8, tmp_path_factory):
    cases = [(name, dict(kw, channel="bsc_replay" if kw["channel"] == "bsc" else "ideal"))
             for name, kw in JAX_CASES]
    return tmesh.spawn(lranks.jax_cases, (2, 4), (jax8, cases), timeout=180,
                       store_dir=tmp_path_factory.mktemp("ranks"))


def test_reference_fault_plan_crosses_model_ranks(jax8):
    """The pinned plan: core 5 (model rank 2 of 4) served by core 4 of its
    own rank, TX 1 (model rank 1) dead."""
    assert jax8["jax/serve_rows"].tolist() == [0, 0, 2, 3, 4, 4, 6, 7]
    assert jax8["jax/dead_tx"].tolist() == [False, True, False, False]


@pytest.mark.parametrize("name", [n for n, _ in JAX_CASES])
def test_2x4_static_process_and_faults_serve_equals_the_reference(jax8, grid24, name):
    for key in ("pred", "sim"):
        np.testing.assert_array_equal(data_rows(grid24, lambda r: r[name][key], 0),
                                      jax8[f"{name}/{key}"], err_msg=f"{name} {key}")
