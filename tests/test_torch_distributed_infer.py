"""Sharded inference on gloo ranks (CPU), against JAX's one-device prefill
and decode, against one port rank and against the reference's GSPMD
lowering: the smoke configs of tinyllama (dense), mixtral and kimi (MoE),
falcon-mamba (SSM), zamba2 (hybrid), whisper (enc-dec) and qwen2-vl (VLM),
f32, with parameters drawn by numpy from a seed and converted with
`repro_torch.convert`, on (data, model) grids of 1x2, 2x1 and 2x2 ranks.

* (a) Each family prefills B 4 x 12 tokens (whisper over 64 numpy frames,
  qwen2-vl behind 16 numpy patch embeddings of a 4 x 4 grid) at a capacity
  of 32 slots (qwen2-vl 64), then decodes 8 more tokens: on a model-cut
  cache the decode crosses from rank 0's half of the slots into rank 1's.
  Mixtral prefills 120 tokens into its 64-slot ring (the window) and
  decodes 12, which writes slots 56-63 on rank 1 and wraps to 0-3 on rank
  0. Every step's logits, gathered over the vocabulary and the data ranks,
  lie within TOL of JAX's one-device ``prefill_fn`` / ``decode_fn`` (the
  one-rank port-vs-JAX tolerance of tests/test_torch_transformer.py and its
  siblings; the ranks sit within ~3e-5 of one port rank).
* (b) Each rank's cache, after the prefill and after the last step, is its
  rules-engine slice of one port rank's: the K/V within 1e-4 of their
  scale (f32 sums in another order), slot_pos equal.
* (c) The merged decode attention over a cache cut in two over the model
  ranks equals the whole cache's on one rank where rank 0 holds no visible
  slot, where no slot is visible anywhere (the mean over all slots, as on
  one rank), and where a window leaves rank 1 out.
* (d) An MoE decode group of 16 tokens spanning 2 data ranks, at a capacity
  that drops assignments, routes exactly as one rank (its output rows
  equal).
* (e) B = 1 (the long_500k shape, whole on both data ranks of 2x1) prefill
  and decode of kimi (MoE) and falcon-mamba (Mamba) equal one rank's.
* (f) The dry run's per-rank argument bytes of a smoke prefill and decode
  cell on a fake 2x4 world equal the reference's
  ``memory_analysis().argument_size_in_bytes`` under the same shardings on
  8 host devices (a JAX subprocess started with the module); both sides'
  collective bytes are printed (``-s``), not held: GSPMD's choice of wire
  differs from the explicit merge.
* A decode on ranks at per-row positions is refused, naming the reason,
  and a rank's parameter shards own their storage (a view of the whole
  leaf kept it alive: phase 25 read a Kimi-K2 rank 2.2 GiB over its
  shards).

Every world of ranks starts once for the module (`launch.mesh.spawn`, all
three at once, a join timeout). Rank code in tests/_torch_dist_infer_ranks.py
(torch only)."""
import concurrent.futures
import functools
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_infer_ranks as iranks
from repro import configs as jconfigs
from repro.models import get_model as j_get_model
from repro.models import vlm as jvlm
from repro.models.base import ParamSpec as JParamSpec
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import make_mesh
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import get_model, moe
from repro_torch.models.base import abstract_params, param_axes, param_shapes
from repro_torch.tree import tree_flatten, tree_map

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
GRIDS = [(1, 2), (2, 1), (2, 2)]
GRID_IDS = lambda g: f"{g[0]}x{g[1]}"                       # noqa: E731
ARCHS = ("tinyllama_1_1b", "mixtral_8x22b", "kimi_k2", "falcon_mamba_7b", "zamba2_2_7b",
         "whisper_tiny", "qwen2_vl_7b")
B1 = ("kimi_k2", "falcon_mamba_7b")               # (e): B = 1 on 2x1
CASES = {(1, 2): ["attention", "per_row"], (2, 1): ["moe"], (2, 2): []}
TOL = dict(atol=1e-4, rtol=1e-4)
SV, GRID = 16, (4, 4)
# (f): a smoke cell of the dry run, prefill B 8 x 64 and a decode over 64 slots
SMOKE = dict(arch="tinyllama_1_1b", seq=64, batch=8)

JAX8 = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import compat, configs
from repro.analysis import hlo_cost
from repro.configs.shapes import Cell, input_specs
from repro.distributed.sharding import spec_for_shape, tree_shardings, use_rules
from repro.models import get_model
from repro.models.base import param_axes, param_shapes
from repro.train.loop import merged_rules

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
cfg = configs.get_smoke(%(arch)r)
model = get_model(cfg)
rules = merged_rules(cfg)
b, s = %(batch)d, %(seq)d
out = {}
with compat.set_mesh(mesh), use_rules(rules):
    p_shapes = param_shapes(model.specs)
    p_sh = tree_shardings(mesh, p_shapes, param_axes(model.specs), rules)
    _, shapes, axes = input_specs(cfg, Cell("smoke", s, b, "prefill"))
    b_sh = {k: NamedSharding(mesh, spec_for_shape(axes[k], shapes[k].shape, rules, mesh))
            for k in shapes}
    comp = jax.jit(model.prefill_fn, in_shardings=(p_sh, b_sh)).lower(p_shapes,
                                                                      shapes).compile()
    out["prefill"] = comp
    c_shapes, c_axes = model.cache_specs_fn(b, s)
    c_sh = tree_shardings(mesh, c_shapes, c_axes, rules)
    tok_sh = NamedSharding(mesh, spec_for_shape(("batch",), (b,), rules, mesh))
    comp = jax.jit(model.decode_fn, in_shardings=(p_sh, c_sh, tok_sh, NamedSharding(mesh, P())),
                   donate_argnums=(1,)).lower(
        p_shapes, c_shapes, jax.ShapeDtypeStruct((b,), jnp.int32),
        jax.ShapeDtypeStruct((), jnp.int32)).compile()
    out["decode"] = comp
res = {k: dict(args=c.memory_analysis().argument_size_in_bytes,
               coll={k2: int(v) for k2, v in hlo_cost.analyze(c.as_text()).collective.items()})
       for k, c in out.items()}
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""


def draw_params(specs, seed: int) -> dict:
    """A numpy tree shaped as ``specs`` (the reference's ParamSpecs), in each
    leaf's dtype: normals at the spec's scale, every projection at fan-in
    over its contraction (the attention's over d for wq/wk/wv and over
    H x hd for wo, so no softmax is near-hard), zeros-initialised leaves
    drawn at 0.1 (0.5 for the f32 SSM leaves), ones-initialised (D) at
    1 +- 0.1."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        z = rng.standard_normal(spec.shape).astype(np.float32)
        if spec.init == "normal":
            a = z * spec.scale
        elif spec.init == "fan_in":
            if "head_dim" in spec.axes:
                fan = (spec.shape[-3] if spec.axes[-1] == "head_dim"
                       else spec.shape[-3] * spec.shape[-2])
            else:
                fan = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            a = z / np.sqrt(fan)
        elif spec.init == "ones":
            a = 1 + 0.1 * z
        else:
            a = z * (0.5 if spec.dtype == np.float32 else 0.1)
        return np.asarray(jnp.asarray(a, spec.dtype))

    return jax.tree.map(draw, specs, is_leaf=lambda x: isinstance(x, JParamSpec))


def _run(arch: str, b: int = 4, s: int = 12, pad: int = 32, steps: int = 8, seed: int = 0
         ) -> dict:
    """A run's numpy inputs: the prompt batch (with its frames or patch
    embeddings and M-RoPE positions), its capacity, the first decode
    position and the next tokens [B, steps]."""
    cfg = jconfigs.get_smoke(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + steps)).astype(np.int32)
    batch, start = {"tokens": toks[:, :s]}, s
    if cfg.kind == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.kind == "vlm":
        batch["patch_embeds"] = rng.standard_normal((b, SV, cfg.d_model)).astype(np.float32)
        batch["positions"] = np.asarray(jvlm.default_positions(b, SV, s, GRID))
        start = s + SV
    return dict(arch=arch, batch=batch, pad_to=pad, start=start, next=toks[:, s:])


def _runs() -> dict:
    runs = {}
    for arch in ARCHS:
        if arch == "mixtral_8x22b":           # past its 64-slot window: the ring
            runs[arch] = _run(arch, s=120, pad=128, steps=12)
        elif arch == "qwen2_vl_7b":           # 16 patches + 12 tokens, 64 slots
            runs[arch] = _run(arch, pad=64)
        else:
            runs[arch] = _run(arch)
    for arch in B1:
        runs[arch + "_b1"] = _run(arch, b=1, steps=4, seed=7)
    return runs


@pytest.fixture(scope="module")
def inputs():
    params = {a: draw_params(j_get_model(jconfigs.get_smoke(a)).specs, 1) for a in ARCHS}
    return dict(params=params, runs=_runs())


@pytest.fixture(scope="module", autouse=True)
def jax8(tmp_path_factory):
    """The reference's argument bytes and collective bytes of the smoke
    prefill and decode on a 2x4 mesh, from a subprocess with 8 host devices
    (started with the module, read when a test needs it)."""
    path = str(tmp_path_factory.mktemp("jax8") / "out.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX8 % SMOKE), path],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = {}

    def get():
        if not got:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            with open(path, "rb") as f:
                got.update(pickle.load(f))
        return got

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """grid -> every rank's results: the three grids' ranks all start at
    once, each grid's once; 2x1 also runs the B = 1 runs."""
    def grid_inputs(g):
        runs = {k: v for k, v in inputs["runs"].items()
                if not k.endswith("_b1") or g == (2, 1)}
        return dict(inputs, runs=runs, cases=CASES[g])

    pool = concurrent.futures.ThreadPoolExecutor(len(GRIDS))
    futures = {g: pool.submit(tmesh.spawn, iranks.run, g, (grid_inputs(g),),
                              timeout=600, store_dir=tmp_path_factory.mktemp("r"))
               for g in GRIDS}
    yield lambda grid: futures[grid].result()
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def one(inputs, worlds):
    """One port rank's runs, on one CPU thread as each rank runs (after the
    ranks have started)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return iranks.run(None, dict(inputs, cases=[]))
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_logits(name: str) -> np.ndarray:
    """JAX's one-device prefill at the run's capacity, then its decodes of
    the run's next tokens: logits [steps + 1, B, V]."""
    run = _runs()[name]
    jm = j_get_model(jconfigs.get_smoke(run["arch"]))
    p = jax.tree.map(jnp.asarray, draw_params(jm.specs, 1))
    lg, cache = jax.jit(functools.partial(jm.prefill_fn, pad_to=run["pad_to"]))(
        p, {k: jnp.asarray(v) for k, v in run["batch"].items()})
    out = [np.asarray(lg)]
    decode = jax.jit(jm.decode_fn)
    for i in range(run["next"].shape[1]):
        lg, cache = decode(p, cache, jnp.asarray(run["next"][:, i]),
                           jnp.int32(run["start"] + i))
        out.append(np.asarray(lg))
    return np.stack(out)


def _close_scaled(got, want, tol=1e-4, what=""):
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_jax(worlds, grid, arch):
    """(a) every rank's gathered logits of the prefill and of each decode
    step against JAX's one-device run."""
    want = _jax_logits(arch)
    for r in worlds(grid):
        got = np.stack(r[arch]["logits"])
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"{grid} {arch} {r['coords']}")


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_cache_is_its_slice_of_one_rank(worlds, one, grid, arch):
    """(b) each rank's cache after the prefill and after the last decode is
    its rules-engine slice of one rank's; on a model-cut K/V cache the
    pieces are smaller than the whole."""
    ranks = worlds(grid)
    cut = False
    for r in ranks:
        res = r[arch]
        for when in ("prefill_cache", "cache"):
            for name, piece in res[when].items():
                whole = one[arch][when][name]
                want = whole[tuple(slice(a, b) for a, b in res["slices"][name])]
                assert piece.shape == want.shape, (grid, arch, name, piece.shape, want.shape)
                cut |= piece.size < whole.size
                if piece.dtype.kind in "iu":
                    np.testing.assert_array_equal(piece, want, err_msg=f"{grid} {arch} {name}")
                else:
                    _close_scaled(piece, want, what=f"{grid} {arch} {when} {name}")
    assert cut, (grid, arch, "no leaf of the cache is cut")


@pytest.mark.parametrize("case", ["rank 0 empty", "none visible", "window"])
def test_merged_attention_equals_one_rank(worlds, case):
    """(c) the partial softmaxes merged over the model ranks."""
    for r in worlds((1, 2)):
        cut, whole = r["attention"][case]
        np.testing.assert_allclose(cut, whole, atol=1e-6, rtol=1e-5, err_msg=case)


def test_moe_group_spanning_data_ranks_routes_as_one_rank(worlds):
    """(d) 16 decode tokens in one dispatch group over 2 data ranks, 4 slots
    an expert for 32 assignments: the one rank drops some, and each data
    rank's output rows equal its rows of one rank's."""
    cfg, p, x = iranks.straddling_moe()
    r = moe.route(p["router"], cfg, x.reshape(1, 16, -1))
    assert not bool(r.keep.all()), "the capacity drops nothing: the case tests no drop"
    want, _ = moe.apply(p, cfg, x)
    for rank in worlds((2, 1)):
        lo, hi = rank["moe"]["rows"]
        np.testing.assert_allclose(rank["moe"]["out"], want[lo:hi].numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", B1)
def test_b1_decode_on_data_ranks_equals_one_rank(worlds, one, arch):
    """(e) B = 1 whole on both data ranks: one rank's logits, and JAX's."""
    name = arch + "_b1"
    want = np.stack(one[name]["logits"])
    for r in worlds((2, 1)):
        np.testing.assert_allclose(np.stack(r[name]["logits"]), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want, _jax_logits(name), **TOL)


def test_per_row_positions_are_refused_on_ranks(worlds):
    for r in worlds((1, 2)):
        assert "int position" in r["per_row"] and "engine" in r["per_row"], r["per_row"]


def test_shards_own_their_storage():
    """Every leaf of a rank's shards holds storage of its own size: a cut
    leaf is copied out of the whole one (rows or columns alike), a whole
    leaf is the leaf itself."""
    cfg = configs.get_smoke("kimi_k2")
    model = get_model(cfg)
    whole = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                     abstract_params(model.specs))
    with tmesh.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        plc = sharding.tree_placements(mesh, param_shapes(model.specs), param_axes(model.specs),
                                       sharding.merged_rules(cfg))
        mine = sharding.shard_tree(whole, plc, mesh)
    cut = 0
    for (path, x), (_, p) in zip(tree_flatten(mine), tree_flatten(plc)):
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size(), path
        cut += bool(p.cuts)
    assert cut > 0


@pytest.fixture(scope="module")
def smoke_infer():
    cfg = configs.get_smoke(SMOKE["arch"])
    b, s = SMOKE["batch"], SMOKE["seq"]
    out = {}
    with dryrun._world((2, 4)) as mesh:
        out["prefill"] = dryrun.count_infer(cfg, "prefill", {"tokens": ((b, s), torch.int32)},
                                            mesh, "cpu")
        out["decode"] = dryrun.count_infer(cfg, "decode", {"token": ((b,), torch.int32)},
                                           mesh, "cpu", seq=s)
    for rec in out.values():
        rec.pop("_oc")
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_infer_argument_bytes_equal_the_references(jax8, smoke_infer, kind):
    """(f) the rank's parameters, cache piece and batch rows against the
    reference's argument bytes; both sides' collective bytes printed."""
    rec, want = smoke_infer[kind], jax8()[kind]
    print(f"{kind} {SMOKE} on 2x4: collective bytes a rank, port "
          f"{rec['cost_per_rank']['collective']}, reference (hlo_cost) {want['coll']}")
    assert rec["memory_per_rank"]["arguments"] == want["args"], (rec["memory_per_rank"], want)
    kinds = rec["memory_per_rank"]["arguments_by_kind"]
    assert set(kinds) == ({"parameters", "batch"} if kind == "prefill"
                          else {"parameters", "cache", "batch"})
