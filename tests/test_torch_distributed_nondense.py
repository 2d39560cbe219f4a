"""Sharded training of the non-dense families on gloo ranks (CPU), against
one rank and against the reference: the six non-dense smoke configs (f32:
mixtral and kimi MoE, falcon-mamba SSM, zamba2 hybrid, whisper enc-dec,
qwen2-vl VLM) on (data, model) grids of 1x2, 2x1 and 2x2 ranks, from JAX's
initial parameters on JAX's token batches (whisper with numpy frames,
qwen2-vl with numpy patch embeddings and JAX's M-RoPE positions).

* On every grid, three AdamW steps equal one port rank's: the step-1 loss
  and gradient norm to rtol 1e-5 (the same parameters and batch; only the
  reduction order differs), the three losses to rtol 1e-3, as
  tests/test_torch_distributed_train.py holds the dense decoders.
* On 2x2, the same three steps equal the reference's own 2x2
  `build_train_fns` (subprocesses with 8 host devices, started with the
  module): step 1's loss within 1e-5 relative, steps 2-3 within 1e-3, as
  test_torch_train.py's test_adamw_steps_match_jax holds one rank, and
  step 1's gradient norm within 1e-3: the reference's own step-1 norm
  moves by up to 1.5e-4 between its 1x1, 1x2, 2x1 and 2x2 meshes on these
  batches (qwen2-vl 107.182-107.198, kimi 79.960-79.968) and whisper's by
  5.1e-4 on test_adamw_steps_match_jax's (measured).
* The MoE load-balancing aux on 2x1, with the two halves of the batch
  routed to different experts: the data ranks' shares sum to the aux of
  the whole batch on one rank, and so do their router gradients, where
  the mean of each rank's own aux is far off; a dispatch group that would
  straddle the two data ranks raises, naming the shapes.

Every world of ranks starts once for the module (`launch.mesh.spawn`, a
``file://`` store under pytest's temporary directory, a join timeout).
Rank code in tests/_torch_dist_nondense_ranks.py (torch only)."""
import concurrent.futures
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import _torch_dist_nondense_ranks as nranks
from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.models import get_model as j_get_model
from repro.models import vlm as jvlm
from repro.models.base import init_params as j_init_params
from repro_torch.launch import mesh as tmesh

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
GRIDS = [(1, 2), (2, 1), (2, 2)]
GRID_IDS = lambda g: f"{g[0]}x{g[1]}"                       # noqa: E731
CASES = {(1, 2): ["train"], (2, 1): ["train", "aux", "straddle"], (2, 2): ["train"]}
BATCH, SEQ, SV, GRID = 4, 64, 16, (4, 4)

JAX22 = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.models import get_model
from repro.train.loop import build_train_fns
from repro.train.optimizer import OptConfig, adamw_init

with open(sys.argv[1], "rb") as f:
    inputs = pickle.load(f)
mesh = Mesh(np.array(jax.devices())[:4].reshape(2, 2), ("data", "model"))
opt = OptConfig(**%(opt)r)
out = {}
for arch in sys.argv[3:]:
    fns = build_train_fns(get_model(configs.get_smoke(arch)), mesh, opt)
    p = jax.tree.map(jnp.asarray, inputs["params"][arch])
    p = jax.device_put(p, fns.param_shardings)
    s = jax.device_put(adamw_init(opt, p), fns.opt_shardings)
    losses, gnorms = [], []
    for b in inputs["batches"][arch]:
        p, s, m = fns.step(p, s, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    out[arch] = dict(losses=losses, gnorms=gnorms)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _batches(arch: str) -> list:
    """JAX's token batches for three steps, with frames (whisper) or patch
    embeddings and M-RoPE positions (qwen2-vl) drawn with numpy."""
    cfg = jconfigs.get_smoke(arch)
    pipe = JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH))
    out = []
    for step in range(nranks.STEPS):
        b = {k: np.asarray(v) for k, v in pipe.batch(step).items()}
        rng = np.random.default_rng(100 + step)
        if cfg.kind == "encdec":
            b["frames"] = rng.standard_normal((BATCH, cfg.enc_seq, cfg.d_model)).astype(
                np.float32)
        if cfg.kind == "vlm":
            b["patch_embeds"] = rng.standard_normal((BATCH, SV, cfg.d_model)).astype(np.float32)
            b["positions"] = np.asarray(jvlm.default_positions(BATCH, SV, SEQ, GRID))
        out.append(b)
    return out


@pytest.fixture(scope="module")
def inputs():
    """JAX's initial parameters (key 0, as its `build_train_fns` init draws
    them) and the three batches of every non-dense smoke config."""
    return dict(
        params={a: jax.tree.map(np.asarray, j_init_params(
            jax.random.PRNGKey(0), j_get_model(jconfigs.get_smoke(a)).specs))
            for a in nranks.NONDENSE},
        batches={a: _batches(a) for a in nranks.NONDENSE})


@pytest.fixture(scope="module")
def jax22(inputs, tmp_path_factory):
    """The reference's three 2x2 AdamW steps of each config from the same
    parameters on the same batches, from three subprocesses with 8 host
    devices, two configs each (started with the module, read when a test
    needs it)."""
    d = tmp_path_factory.mktemp("jax22")
    src = str(d / "in.pkl")
    with open(src, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    code = textwrap.dedent(JAX22 % dict(opt=nranks.ADAMW))
    procs = [(subprocess.Popen([sys.executable, "-c", code, src, str(d / f"out{i}.pkl"),
                                *nranks.NONDENSE[i::3]], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True), str(d / f"out{i}.pkl"))
             for i in range(3)]
    got = {}

    def get():
        if not got:
            for proc, dst in procs:
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-4000:]
                with open(dst, "rb") as f:
                    got.update(pickle.load(f))
        return got

    yield get
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def one(inputs, jax22):
    """One port rank's three steps of every config, on one CPU thread as
    each rank runs (after the reference's subprocess has started)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return nranks.run(None, dict(inputs, cases=["train"]))["train"]
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(inputs, jax22, tmp_path_factory):
    """grid -> every rank's results: the three grids' ranks all start at
    once, beside the reference's subprocess, each grid's once."""
    pool = concurrent.futures.ThreadPoolExecutor(len(GRIDS))
    futures = {g: pool.submit(tmesh.spawn, nranks.run, g, (dict(inputs, cases=CASES[g]),),
                              timeout=600, store_dir=tmp_path_factory.mktemp("r"))
               for g in GRIDS}
    yield lambda grid: futures[grid].result()
    pool.shutdown(wait=True)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("arch", nranks.NONDENSE)
def test_sharded_adamw_equals_one_rank(worlds, one, grid, arch):
    """Every rank reports the global step's loss and gradient norm: step 1
    to rtol 1e-5 of one rank's, the three losses to rtol 1e-3; every rank
    reports the same losses."""
    want = one[arch]
    ranks = worlds(grid)
    for r in ranks:
        got = r["train"][arch]
        for key in ("losses", "gnorms"):
            np.testing.assert_allclose(got[key][0], want[key][0], rtol=1e-5,
                                       err_msg=f"{grid} {arch} {key} {r['coords']}")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3,
                                   err_msg=f"{grid} {arch} losses")
        assert got["losses"] == ranks[0]["train"][arch]["losses"], (grid, arch)


@pytest.mark.parametrize("arch", nranks.NONDENSE)
def test_2x2_adamw_equals_jax_2x2(worlds, jax22, arch):
    """The port's 2x2 ranks against the reference's own 2x2 step on the
    same parameters and batches."""
    want = jax22()[arch]
    for r in worlds((2, 2)):
        got = r["train"][arch]
        np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=1e-5,
                                   err_msg=f"{arch} step 1 loss")
        np.testing.assert_allclose(got["gnorms"][0], want["gnorms"][0], rtol=1e-3,
                                   err_msg=f"{arch} step 1 gnorm")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3,
                                   err_msg=f"{arch} losses")


def test_moe_aux_over_data_ranks_is_the_global_batchs(worlds):
    """On 2x1, with rows 0-1 leaning to expert 0 and rows 2-3 to expert 1:
    each data rank's output rows are the whole batch's on one rank, the
    aux shares sum to the whole batch's aux (both means over the global
    tokens) and the router gradients sum to its gradient; the mean of the
    ranks' own auxes (each over its half) is at least 10% off, so a
    per-rank aux would fail here."""
    cfg, p, x = nranks.unbalanced_moe()
    out, aux, g_router, _ = nranks.aux_and_grads(p, cfg, x)
    ranks = worlds((2, 1))
    for r in ranks:
        got = r["aux"]
        i = r["coords"][0]
        np.testing.assert_allclose(got["out"], out[2 * i:2 * i + 2].numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-6)
        np.testing.assert_allclose(got["g_router"], g_router.numpy(), rtol=1e-5,
                                   atol=1e-7 * float(g_router.abs().max()))
        assert abs(got["per_rank"] - float(aux)) > 0.1 * float(aux), (got["per_rank"], aux)


def test_moe_refuses_groups_that_straddle_data_ranks(worlds):
    """B 2 x S 60 at group_size 40 on two data ranks: the reference routes
    the global 120 tokens in groups of 40, one of which spans rows of both
    ranks; the port refuses, naming the shapes (ROADMAP §3)."""
    for r in worlds((2, 1)):
        msg = r["straddle"]
        assert "120" in msg and "groups of 40" in msg and "1 x 60" in msg, msg
