"""Sharded training on gloo ranks (CPU) against one rank and against the
reference: the four dense smoke configs (f32) on (data, model) grids of
1x2, 2x1, 2x2 and 4x2 ranks (the non-dense families' training on ranks is
tests/test_torch_distributed_nondense.py's).

* Every rank's shard of every parameter and optimizer leaf, for all ten
  smoke configs, has the shape
  the reference's `NamedSharding.shard_shape` gives on the same mesh (its
  `build_train_fns` shardings, AdamW and signum, computed in a subprocess
  with 8 host devices started with the module), and the rank's parameter
  and optimizer bytes are those of its resolved shards.
* AdamW on 1x2, 2x1 and 2x2 equals one rank: the step-1 loss and gradient
  norm to rtol 1e-5, and so steps 2 and 3 taken from one rank's state,
  three free-running steps' losses to rtol 1e-3, the gradient leaf by
  leaf (after step 1, and after steps 2 and 3 from one rank's state),
  replicated leaves equal on every rank, and the parameters after three
  steps (free-running, from one rank's state after step 2, and after
  steps 2 and 3 on the grid from one rank's state after step 1).
* The reference's two pins on 4x2 (tests/test_distributed.py): AdamW
  (smollm smoke, seq 64, global batch 8, lr 1e-3) within 5e-3 of one rank
  after 5 steps, and within 5e-3 of JAX's own 4x2 run from JAX's initial
  parameters on JAX's batches; signum at BER 0.01 (tinyllama smoke, seq
  128, global batch 8, lr 3e-4) lowers the loss by >= 0.4 in 20 steps.
* One signum step on 2x1 at BER 0 equals JAX's vote over the two data
  shards wherever both shards' gradients are clear of zero.
* A checkpoint written on 2x2 restores on one rank and on 1x2, and the
  Trainer's resumed run equals the restored state continued in memory, bit
  for bit; a Trainer killed on 1x2 and resumed equals an uninterrupted one.

Every world of ranks starts once for the module (`launch.mesh.spawn`, a
``file://`` store under pytest's temporary directory, a join timeout).
Rank code in tests/_torch_dist_train_ranks.py (torch only)."""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_train_ranks as tranks
from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.models import get_model as j_get_model
from repro.models.base import init_params as j_init_params
from repro.train import optimizer as jopt
from repro_torch.launch import mesh as tmesh

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
GRIDS = [(1, 2), (2, 1), (2, 2), (4, 2)]
GRID_IDS = lambda g: f"{g[0]}x{g[1]}"                       # noqa: E731
CASES = {(1, 1): ["ckpt-resume"],
         (1, 2): ["shapes", "losses", "ckpt-resume", "crash"],
         (2, 1): ["shapes", "losses", "sign-jax"],
         (2, 2): ["shapes", "losses", "ckpt-write"],
         (4, 2): ["shapes", "pin-adamw", "pin-adamw-jax", "pin-sign"]}

JAX8 = """
import pickle, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.data import SyntheticLM, DataConfig
from repro.models import get_model
from repro.models.base import param_shapes
from repro.train.loop import build_train_fns
from repro.train.optimizer import OptConfig

def paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in p): v for p, v in flat}

out = {"shapes": {}}
devs = np.array(jax.devices())
for grid in %(grids)r:
    mesh = Mesh(devs[:grid[0] * grid[1]].reshape(grid), ("data", "model"))
    for arch in %(archs)r:
        cfg = configs.get_smoke(arch)
        model = get_model(cfg)
        shapes = param_shapes(model.specs)
        for kind in ("adamw", "sign_majority"):
            fns = build_train_fns(model, mesh, OptConfig(kind=kind), jit=False)
            p = {k: s.shard_shape(tuple(x.shape)) for (k, s), x in
                 zip(paths(fns.param_shardings).items(), paths(shapes).values())}
            st = jax.eval_shape(lambda: fns.init(jax.random.PRNGKey(0))[1])
            o = {k: s.shard_shape(tuple(x.shape)) for (k, s), x in
                 zip(paths(fns.opt_shardings).items(), paths(st).values())}
            out["shapes"][(grid, arch, kind)] = {"params": p, "opt": o}

mesh = Mesh(devs.reshape(4, 2), ("data", "model"))
cfg = configs.get_smoke("smollm_360m")
model = get_model(cfg)
pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=64, global_batch=8))
key = jax.random.PRNGKey(0)
fns = build_train_fns(model, mesh, OptConfig(lr=1e-3, warmup=2, total_steps=10))
params, opt_state = fns.init(key)
params = jax.device_put(params, fns.param_shardings)
opt_state = jax.device_put(opt_state, fns.opt_shardings)
losses = []
for step in range(5):
    params, opt_state, m = fns.step(params, opt_state, pipe.batch(step), key)
    losses.append(float(m["loss"]))
out["adamw_4x2"] = losses
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    """The reference's shard shapes and its 4x2 AdamW losses, from a
    subprocess with 8 host devices (started with the module, read when a
    test needs it)."""
    path = str(tmp_path_factory.mktemp("jax8") / "out.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    code = textwrap.dedent(JAX8 % dict(grids=GRIDS, archs=tranks.ALL))
    proc = subprocess.Popen([sys.executable, "-c", code, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = {}

    def get():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            with open(path, "rb") as f:
                got.update(pickle.load(f))
        return got

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs(jax8):
    """JAX's initial smollm parameters and its first 5 batches (the 4x2 pin
    from JAX's init), and JAX's tinyllama parameters and one batch for the
    signum step, with JAX's vote on the two data shards."""
    jcfg = jconfigs.get_smoke("smollm_360m")
    params = j_init_params(jax.random.PRNGKey(0), j_get_model(jcfg).specs)
    pipe = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq=64, global_batch=8))
    batches = [_np(pipe.batch(s)) for s in range(5)]

    tcfg = jconfigs.get_smoke("tinyllama_1_1b")
    tmodel = j_get_model(tcfg)
    opt = jopt.OptConfig(**tranks.SIGN)
    sp = j_init_params(jax.random.PRNGKey(1), tmodel.specs)
    batch = JSyntheticLM(JDataConfig(vocab=tcfg.vocab, seq=64, global_batch=4)).batch(0)
    grad = jax.jit(jax.grad(lambda p, b: tmodel.loss_fn(p, b)[0]))
    halves = [grad(sp, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}) for i in (0, 1)]
    votes = jax.tree.map(lambda a, b: jnp.sign(jnp.sign(a) + jnp.sign(b)), *halves)
    sp2, _, _ = jopt.sign_update(opt, votes, jopt.sign_init(opt, sp), sp)
    return dict(jax_params=_np(params), jax_batches=batches, sign_params=_np(sp),
                sign_batch=_np(batch), sign_after=_np(sp2), sign_grads=[_np(h) for h in halves])


@pytest.fixture(scope="module")
def one(inputs):
    """One rank's answers, on one CPU thread as each rank runs: the
    deepseek smoke config's gradient moves by ~6e-5 of a leaf's largest
    entry between one and eight threads, more than the ranks' own
    reduction order moves it."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return tranks.run(None, dict(inputs, cases=["shapes", "losses", "pin-adamw"]), None)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(inputs, one, tmp_path_factory):
    """grid -> every rank's results, each grid's ranks started once (2x2
    first: it writes the checkpoint the others restore). The ranks get one
    rank's global states after steps 1 and 2 of the sharded-AdamW case,
    to take steps 2 and 3 from."""
    cache = {}
    tmp = str(tmp_path_factory.mktemp("train"))
    rank_inputs = {k: v for k, v in inputs.items() if k in ("jax_params", "jax_batches",
                                                           "sign_params", "sign_batch")}
    rank_inputs["one_states"] = {a: one["losses"][a]["states"] for a in tranks.DENSE}

    def get(grid):
        if grid != (2, 2) and "ckpt-resume" in CASES[grid]:
            get((2, 2))
        if grid not in cache:
            try:
                cache[grid] = tmesh.spawn(tranks.run, grid,
                                          (dict(rank_inputs, cases=CASES[grid]), tmp),
                                          timeout=600, store_dir=tmp_path_factory.mktemp("r"))
            except (RuntimeError, TimeoutError) as e:
                cache[grid] = e
        if isinstance(cache[grid], Exception):
            raise cache[grid]
        return cache[grid]

    return get


def _paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("arch", tranks.ALL)
@pytest.mark.parametrize("kind", ["adamw", "sign_majority"])
def test_shard_shapes_are_the_references(worlds, jax8, grid, arch, kind):
    want = jax8()["shapes"][(grid, arch, kind)]
    for r in worlds(grid):
        got = r["shapes"][(arch, kind)]
        assert got["params"] == want["params"], (r["coords"], arch, kind)
        assert got["opt"] == want["opt"], (r["coords"], arch, kind)
        held, resolved = got["bytes"]
        assert held == resolved, (r["coords"], held, resolved)


@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2)], ids=GRID_IDS)
@pytest.mark.parametrize("arch", tranks.DENSE)
def test_sharded_adamw_equals_one_rank(worlds, one, grid, arch):
    """Every rank reports the global step's loss and gradient norm. Step 1
    to rtol 1e-5 (the same parameters and batch; only the reduction order
    differs), and so are steps 2 and 3 taken on the grid from one rank's
    own state after steps 1 and 2. The three free-running steps' losses to
    rtol 1e-3; their norms are not compared: the step-1 states differ in
    rounding (up to 1.4e-6), a gradient entry within rounding of zero
    whose sign then flips becomes a full lr-sized AdamW step, and the
    trajectories part (measured on this suite's grids: the step-2 norm
    within 7.8e-5 of one rank's, the step-3 norm up to 1.27e-2 off on
    smollm 1x2 and 2x2, whose 3 heads over 1 kv head stay whole on every
    model rank). Every copy of a parameter piece holds the same bits on
    every rank that holds it, after every step. The gradient itself, leaf
    by leaf: the global first moment after step 1 (0.1 x the clipped
    gradient), and after steps 2 and 3 from one rank's state, equals one
    rank's to 1e-4 of the leaf's largest entry (measured: up to 1.7e-5),
    so a gradient wrong only in size (a missing data average, a
    replicated leaf summed twice or not at all) fails here though AdamW's
    step would hide it. The global parameters after three steps: every
    entry within 2e-3 of one rank's (one AdamW step's sign flip at lr 1e-3
    moves an entry by up to 2 lr) free-running (measured: 1.2e-3, and up
    to 0.74% of smollm's attention entries beyond 1e-4); and at most 1e-3
    of a leaf's entries beyond 1e-4 after step 3 from one rank's state
    after step 2 (measured: none, at most 6.9e-5), and after steps 2 and
    3 both on the grid from one rank's state after step 1, the grid
    carrying its own moments and step count from step to step (measured:
    at most 3.1e-5 of a leaf, at most 2.6e-4; a step count held back at
    step 3 puts 80-95% of a leaf beyond 1e-4)."""
    want = one["losses"][arch]
    ranks = worlds(grid)
    for r in ranks:
        got = r["losses"][arch]
        for key in ("losses", "gnorms"):
            np.testing.assert_allclose(got[key][0], want[key][0], rtol=1e-5,
                                       err_msg=f"{grid} {arch} {key}")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3,
                                   err_msg=f"{grid} {arch} losses")
        assert len(got["same"]) == len(want["losses"]) - 1, (grid, arch)
        for s, same in enumerate(got["same"], start=1):
            for key, name in (("loss", "losses"), ("gnorm", "gnorms")):
                np.testing.assert_allclose(same[key], want[name][s], rtol=1e-5,
                                           err_msg=f"{grid} {arch} step {s + 1} {key}")
    copies = 0
    for s in range(len(want["losses"])):
        held = {}
        for r in ranks:
            for key, x in r["losses"][arch]["pieces"][s].items():
                if key in held:
                    copies += 1
                    assert np.array_equal(x, held[key]), (grid, arch, s + 1, key)
                held.setdefault(key, x)
    assert copies or grid[1] == 1, (grid, arch)
    got = ranks[0]["losses"][arch]
    moments = [(1, got["m"][0])] + [(s + 1, same["m"]) for s, same in
                                    enumerate(got["same"], start=1)]
    for step, m in moments:
        w_step = want["m"][step - 1]
        assert m.keys() == w_step.keys()
        for path, w in w_step.items():
            np.testing.assert_allclose(m[path], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{grid} {arch} step {step} {path}")
    off = {path: np.abs(got["params"][path] - w) for path, w in want["params"].items()}
    assert got["params"].keys() == want["params"].keys()
    assert all(x.max() <= 2e-3 for x in off.values()), (
        grid, arch, {p: float(x.max()) for p, x in off.items()})
    for name, params in (("same", got["same"][-1]["params"]), ("carried", got["carried"])):
        assert params.keys() == want["params"].keys(), (grid, arch, name)
        for path, w in want["params"].items():
            x = np.abs(params[path] - w)
            assert x.max() <= 2e-3 and (x > 1e-4).mean() <= 1e-3, (
                grid, arch, name, path, x.max(), (x > 1e-4).mean())


def test_4x2_adamw_pin_equals_one_rank(worlds, one):
    """tests/test_distributed.py:413-446 on the port: 5 steps of 4x2 AdamW
    within 5e-3 of one rank."""
    want = one["pin-adamw"]["losses"][-1]
    for r in worlds((4, 2)):
        assert abs(r["pin-adamw"]["losses"][-1] - want) < 5e-3


def test_4x2_adamw_pin_equals_jax_4x2(worlds, jax8):
    """From JAX's initial parameters on JAX's batches, the port's 4x2 AdamW
    after 5 steps is within 5e-3 of the reference's own 4x2 run."""
    want = jax8()["adamw_4x2"]
    for r in worlds((4, 2)):
        got = r["pin-adamw-jax"]["losses"]
        assert abs(got[-1] - want[-1]) < 5e-3, (got, want)


def test_4x2_signum_at_ber_001_lowers_the_loss(worlds):
    """tests/test_distributed.py:384-410 on the port: signum on 4x2 at BER
    0.01 lowers the loss by 0.4 in 20 steps (every rank reports the data
    mean)."""
    for r in worlds((4, 2)):
        losses = r["pin-sign"]["losses"]
        assert losses[-1] < losses[0] - 0.4, losses


def test_signum_step_on_2x1_equals_jax_vote(worlds, inputs):
    """One signum step on 2x1 at BER 0 from JAX's parameters on JAX's batch
    (each data rank its two rows) equals JAX's sign update on the vote of
    the two shards' gradient signs, wherever both shards' gradients are
    clear of zero (1e-3 of the leaf's largest |g|) or exactly zero (each
    shard's mask covering most of the leaf, as the one-rank test's does)."""
    want, (g0, g1) = _paths(inputs["sign_after"]), [_paths(g) for g in inputs["sign_grads"]]
    for r in worlds((2, 1)):
        for path, got in r["sign-jax"]["params"].items():
            ca, cb = (((np.abs(g) > 1e-3 * np.abs(g).max()) | (g == 0))
                      for g in (g0[path], g1[path]))
            assert ca.mean() > 0.5 and cb.mean() > 0.5, path   # each shard's, as one rank's
            clear = ca & cb
            np.testing.assert_allclose(got[clear], want[path][clear], rtol=1e-6, atol=1e-9,
                                       err_msg=path)


@pytest.mark.parametrize("layout", ["one", "1x2"])
def test_2x2_checkpoint_restores_and_continues_on_another_layout(worlds, layout):
    """The 2x2 ranks' global state is what a restore gives on one rank and
    on 1x2; the Trainer resumed from it equals the restored state stepped
    on in memory, bit for bit (one rank in a process of its own, one CPU
    thread, as the ranks run)."""
    written = worlds((2, 2))[0]["ckpt-write"]["state"]
    for r in worlds((1, 1) if layout == "one" else (1, 2)):
        got = r["ckpt-resume"]
        for key in ("restored", "memory", "trainer"):
            assert got[key].keys() == written.keys()
        for path, w in written.items():
            np.testing.assert_array_equal(got["restored"][path], w, err_msg=path)
            np.testing.assert_array_equal(got["trainer"][path], got["memory"][path],
                                          err_msg=path)
        assert len(got["losses"]) == 2


def test_trainer_crash_and_resume_on_ranks(worlds):
    for r in worlds((1, 2)):
        got = r["crash"]
        assert got["crashed"]
        assert got["resumed"] == got["whole"][2:] and got["same"]


def test_launcher_trains_on_two_ranks_and_resumes_on_four(tmp_path, capfd):
    """``launch.train --ranks 2 --device cpu --smoke`` trains on a 1x2 mesh,
    and a rerun with ``--ranks 4`` resumes its checkpoint on 2x2."""
    from repro_torch.launch import train as launch_train

    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    assert launch_train.main(argv + ["--steps", "2", "--ranks", "2"]) == 0
    out = capfd.readouterr().out
    assert "mesh=1x2 (data, model)" in out and "final loss" in out
    assert "2 steps on 2 ranks on cpu" in out
    assert launch_train.main(argv + ["--steps", "3", "--ranks", "4"]) == 0
    out = capfd.readouterr().out
    assert "mesh=2x2 (data, model)" in out and "1 steps on 4 ranks on cpu" in out
