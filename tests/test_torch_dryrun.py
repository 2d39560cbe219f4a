"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's.

* `configs.shapes`: `Cell`, `CELLS`, `VLM_VISION`, `cell_applicable` and
  `input_specs` on all 10 architectures x 4 cells: kinds, names, shapes,
  dtypes and logical axes equal the reference's ``ShapeDtypeStruct``s (no
  compile); the three shape helpers (`phy.state_shape_structs`,
  `phy.pstate_shape_structs`, `faults.fstate_shape_structs`) give the
  reference's shapes and dtypes (uint32 words as int32 with the same bits).
* The production meshes over a fake world: rank 0's coordinates, every
  axis's group, and the wire counter's axis labels.
* One smoke config's training step (tinyllama, seq 64, global batch 8) on a
  fake 2x4 world, as rank 0: its argument bytes equal
  ``memory_analysis().argument_size_in_bytes`` of the reference's jitted
  step under the same shardings, and its FLOPs lie within
  FLOPS_RTOL of the reference's ``hlo_cost.analyze`` (see there for why
  they differ); one small ``ScaleOutConfig`` serve, packed and unpacked, on
  a fake 2x4 world: its wire bytes by collective type equal the reference's
  ``hlo_cost`` on the same mesh. The reference's numbers come from one JAX
  subprocess with 8 host devices, started with the module.
* ZeRO-1 on a pod mesh (the fault the dry run found, ROADMAP.md §3): one
  AdamW step of two smoke configs on 2x2x2 gloo ranks equals one rank's,
  and the dry run's count of the same step on a fake 2x2x2 world sends
  what each gloo rank sent, axis by axis.
* The sweep's table: 2 meshes x (10 architectures x 4 cells + 21 HDC
  cells), ``skipped`` exactly where the reference skips and every other
  model cell counted (no record short of a count); and the CLI's records
  of ``tinyllama-1.1b train_4k`` and ``decode_32k`` and ``hdc-scaleout
  serve_packed`` on 16x16.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _torch_dryrun_ranks as dranks
from repro import configs as jconfigs, faults as jfaults, phy as jphy
from repro.configs import shapes as jshapes
from repro_torch import configs, faults, phy
from repro_torch.configs import shapes
from repro_torch.core import scaleout
from repro_torch.distributed import collectives
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import get_model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import build_train_fns
from repro_torch.train.optimizer import OptConfig
from repro_torch.tree import tree_leaves

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
SMOKE = dict(arch="tinyllama_1_1b", seq=64, batch=8)
SERVE = dict(n_classes=512, dim=1024, m_tx=3, n_rx_cores=8, batch=64)
# FLOPs: the port counts its attention kernels' work over the (query, key)
# pairs the causal mask keeps (S(S+1)/2, `attention_pairs`); the
# reference's XLA flash computes whole masked blocks (S^2 at S = 64, one
# block). Every other product is the same matmul on both sides, so the
# port's count lies a few percent under the reference's.
FLOPS_RTOL = 0.10

JAX8 = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import compat, configs, phy
from repro.analysis import hlo_cost
from repro.configs.shapes import Cell, input_specs
from repro.core import scaleout
from repro.distributed.sharding import spec_for_shape, use_rules
from repro.models import get_model
from repro.models.base import param_shapes
from repro.train.loop import build_train_fns, merged_rules
from repro.train.optimizer import OptConfig

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
out = {}
cfg = configs.get_smoke(%(arch)r)
model = get_model(cfg)
_, shapes, axes = input_specs(cfg, Cell("smoke", %(seq)d, %(batch)d, "train"))
rules = merged_rules(cfg)
with compat.set_mesh(mesh), use_rules(rules):
    b_sh = {k: NamedSharding(mesh, spec_for_shape(axes[k], shapes[k].shape, rules, mesh))
            for k in shapes}
    fns = build_train_fns(model, mesh, OptConfig(kind="adamw", state_dtype=jnp.float32),
                          jit=False)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    _, o_struct = jax.eval_shape(fns.init, key)
    step = jax.jit(fns.step, in_shardings=(fns.param_shardings, fns.opt_shardings, b_sh,
                                           NamedSharding(mesh, P())), donate_argnums=(0, 1))
    comp = step.lower(param_shapes(model.specs), o_struct, shapes, key).compile()
out["train"] = dict(args=comp.memory_analysis().argument_size_in_bytes,
                    flops=hlo_cost.analyze(comp.as_text()).flops)
for rep in ("unpacked", "packed"):
    c = scaleout.ScaleOutConfig(**%(serve)r, use_kernels=False, representation=rep)
    last, dt = (c.words, jnp.uint32) if c.packed else (c.dim, jnp.uint8)
    fn = scaleout.make_ota_serve(mesh, c)
    comp = fn.lower(jax.ShapeDtypeStruct((c.n_classes, last), dt),
                    jax.ShapeDtypeStruct((c.batch, 4, 1, last), dt),
                    phy.state_shape_structs(c.n_rx_cores, c.m_tx),
                    jax.ShapeDtypeStruct((2,), jnp.uint32)).compile()
    coll = hlo_cost.analyze(comp.as_text()).collective
    out[rep] = {k: v for k, v in coll.items() if k not in ("total", "count")}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def jax8(tmp_path_factory):
    """The reference's argument bytes, FLOPs and serve collectives on a 2x4
    mesh, from a subprocess with 8 host devices (started with the module,
    read when a test needs it)."""
    path = str(tmp_path_factory.mktemp("jax8") / "out.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    code = textwrap.dedent(JAX8 % dict(SMOKE, serve=SERVE))
    proc = subprocess.Popen([sys.executable, "-c", code, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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


def _dtype_name(dt) -> str:
    name = str(dt).split(".")[-1]
    return {"uint32": "int32", "bool_": "bool"}.get(name, name)   # packed words: int32 bits


# ---------------------------------------------------------------------------
# configs.shapes and the shape helpers
# ---------------------------------------------------------------------------

def test_cells_equal_the_references():
    assert list(shapes.CELLS) == list(jshapes.CELLS)
    for name, cell in shapes.CELLS.items():
        j = jshapes.CELLS[name]
        assert (cell.name, cell.seq, cell.batch, cell.kind) == (j.name, j.seq, j.batch, j.kind)
    assert shapes.VLM_VISION == jshapes.VLM_VISION


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_equal_the_references(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name in shapes.CELLS:
        assert shapes.cell_applicable(cfg, shapes.CELLS[name]) == jshapes.cell_applicable(
            jcfg, jshapes.CELLS[name])
        kind, got, axes = shapes.input_specs(cfg, shapes.CELLS[name])
        jkind, want, jaxes = jshapes.input_specs(jcfg, jshapes.CELLS[name])
        assert kind == jkind and list(got) == list(want) and axes == jaxes, (arch, name)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (arch, name, k)
            assert _dtype_name(t.dtype) == _dtype_name(np.dtype(want[k].dtype)), (arch, name, k)


@pytest.mark.parametrize("which", ["state", "pstate", "fstate"])
def test_shape_helpers_equal_the_references(which):
    got, want = {
        "state": (phy.state_shape_structs(64, 3), jphy.state_shape_structs(64, 3)),
        "pstate": (phy.pstate_shape_structs(64, 3), jphy.pstate_shape_structs(64, 3)),
        "fstate": (faults.fstate_shape_structs(64, 4, 16),
                   jfaults.fstate_shape_structs(64, 4, 16)),
    }[which]

    def pairs(port, ref, prefix=""):
        """(path, port leaf, reference leaf), walking the port's fields."""
        for f in port.FIELDS:
            a, b = getattr(port, f), getattr(ref, f)
            if hasattr(a, "FIELDS"):
                yield from pairs(a, b, f"{prefix}{f}.")
            else:
                yield prefix + f, a, b

    seen = list(pairs(got, want))
    assert len(seen) == len(jax.tree_util.tree_leaves(want))
    for path, g, w in seen:
        assert tuple(g.shape) == tuple(w.shape), path
        assert _dtype_name(g.dtype) == _dtype_name(np.dtype(w.dtype)), path
        assert g.device.type == "meta"


# ---------------------------------------------------------------------------
# the production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(multi_pod):
    shape, axes = tmesh.PRODUCTION[multi_pod]
    with tmesh.fake_world(256 * (2 if multi_pod else 1)):
        mesh = tmesh.make_production_mesh(multi_pod)
        assert mesh.axis_names == axes and mesh.shape == shape
        assert mesh.coords == (0,) * len(shape)
        collectives.reset_wire_bytes()
        x = torch.ones(8)
        for ax in axes:
            assert torch.distributed.get_world_size(mesh.group(ax)) == mesh.axis_size(ax)
            collectives.all_reduce(x, mesh.group(ax))
        assert collectives.wire_bytes_by_axis() == {ax: 64 for ax in axes}
        assert collectives.wire_bytes_by_op() == {"all-reduce": 64 * len(axes)}
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# against the reference's compiled step and serve on 2x4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_train():
    cfg = configs.get_smoke(SMOKE["arch"])
    bs = ((SMOKE["batch"], SMOKE["seq"]), torch.int32)
    with dryrun._world((2, 4)) as mesh:
        rec = dryrun.count_train(cfg, {"tokens": bs, "targets": bs}, mesh, "cpu")
    rec.pop("_oc")
    return rec


def test_train_step_argument_bytes_equal_the_references(jax8, smoke_train):
    assert smoke_train["memory_per_rank"]["arguments"] == jax8()["train"]["args"]
    kinds = smoke_train["memory_per_rank"]["arguments_by_kind"]
    assert set(kinds) == {"parameters", "optimizer", "batch"}
    assert kinds["batch"] == 2 * 4 * (SMOKE["batch"] // 2) * SMOKE["seq"]


def test_train_step_flops_near_the_references(jax8, smoke_train):
    got, want = smoke_train["cost_per_rank"]["flops"], jax8()["train"]["flops"]
    assert abs(got / want - 1) <= FLOPS_RTOL, (got, want)
    assert got < want          # the kept pairs only (see FLOPS_RTOL)
    kernels = smoke_train["cost_per_rank"]["kernels"]
    cfg = configs.get_smoke(SMOKE["arch"])
    n = cfg.n_layers
    assert kernels["flash_attention_fwd"]["launches"] == (2 if cfg.remat else 1) * n
    assert kernels["flash_attention_bwd"]["launches"] == n


@pytest.mark.parametrize("rep", ["unpacked", "packed"])
def test_serve_collective_bytes_equal_the_references(jax8, rep):
    cfg = scaleout.ScaleOutConfig(**SERVE, representation=rep)
    with dryrun._world((2, 4)) as mesh:
        rec = dryrun.count_serve("ota", cfg, mesh, "cpu")
    oc = rec.pop("_oc")
    assert oc.wire_by_op == {k: int(v) for k, v in jax8()[rep].items()}
    kernel = "hamming_topk_banked" if rep == "packed" else "assoc_matmul"
    assert list(oc.kernels) == [kernel] and oc.kernels[kernel]["launches"] == 1


# ---------------------------------------------------------------------------
# ZeRO-1 on a pod mesh
# ---------------------------------------------------------------------------

POD_ARCHS = ("smollm_360m", "tinyllama_1_1b")


@pytest.fixture(scope="module")
def pod_ranks():
    """Every rank's step of each POD_ARCHS config on one 2x2x2 gloo world."""
    return tmesh.spawn(dranks.adamw_steps, (2, 2, 2), (POD_ARCHS,), timeout=240)


@pytest.mark.parametrize("arch", POD_ARCHS)
def test_pod_mesh_adamw_equals_one_rank(arch, pod_ranks):
    """Both smoke configs' 2-layer leaves put ``fsdp`` on ``pod`` alone (2
    layers do not divide pod x data), smollm's ``embed`` on ``data`` too.
    Held as test_torch_distributed_train.py holds a step: the loss to rtol
    1e-5; the first moment after the step (0.1 x the clipped gradient),
    leaf by leaf, to 1e-4 of the leaf's largest entry; the parameters within
    2e-3 (an AdamW step's sign flip of a gradient entry within rounding of
    zero moves an entry by up to 2 lr) and at most 1e-3 of a leaf's entries
    beyond 1e-4. The gradient norm to 5e-5: its squares are summed over
    three mesh axes in another order than one rank's (measured 1.4e-5 on
    tinyllama; the ZeRO-1 that summed such a leaf's gradient over ``pod``
    alone was 4.0e-4 off, and raised on smollm).

    Then the update's wire bytes by axis, leaf by leaf, on a fake 2x2x2
    world: over a data axis that a parameter and its moments cut alike
    (smollm's ``data`` on every leaf) only the clipping norm's f32 scalar
    goes (an all-reduce, 8 bytes an axis), and a leaf whose two placements
    agree all-reduces its gradient piece over the other data axis and
    nothing more (the ZeRO-1 that gathered such a leaf whole first sent
    its piece over ``data`` and back)."""
    one = dranks.adamw_step(None, arch)
    ranks = [r[arch] for r in pod_ranks]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["gnorm"], one["gnorm"], rtol=5e-5)
    got = ranks[0]["leaves"]
    assert got.keys() == one["leaves"].keys()
    for path, want in one["leaves"].items():
        if path.startswith("1/m/"):
            np.testing.assert_allclose(got[path], want, rtol=0,
                                       atol=1e-4 * float(np.abs(want).max()), err_msg=path)
        elif path.startswith("0/"):
            off = np.abs(got[path] - want)
            assert off.max() <= 2e-3 and (off > 1e-4).mean() <= 1e-3, (path, off.max())
    cfg = configs.get_smoke(arch)
    bs = ((8, 32), torch.int32)
    with dryrun._world((2, 2, 2)) as mesh:
        rec = dryrun.count_train(cfg, {"tokens": bs, "targets": bs}, mesh, "cpu")
    rec.pop("_oc")
    assert rec["cost_per_rank"]["collective_by_axis"] == ranks[0]["wire"]
    assert set(ranks[0]["wire"]) == {"pod", "data", "model"}
    norm = 8
    agree = 0
    with dryrun._world((2, 2, 2)) as mesh, FakeTensorMode():
        fns = build_train_fns(get_model(cfg), OptConfig(), mesh=mesh, device="cpu")
        pps, zps = tree_leaves(fns.placements[0]), tree_leaves(fns.placements[1]["m"])
        for pp, zp in zip(pps, zps):
            g, p = (torch.empty(pp.local_shape(mesh)) for _ in range(2))
            state = opt_lib.adamw_init(OptConfig(), {"w": torch.empty(zp.local_shape(mesh))})
            collectives.reset_wire_bytes()
            opt_lib.adamw_update(OptConfig(), {"w": g}, state, {"w": p},
                                 opt_lib.Zero1(mesh, {"w": pp}, {"w": zp}))
            by_axis = collectives.wire_bytes_by_axis()
            pcuts = {d: axes for d, axes in pp.cuts}
            shared = {a for d, axes in zp.cuts for a in axes if a in pcuts.get(d, ())}
            for a in shared - {"model"}:
                assert by_axis[a] == norm, (pp.cuts, zp.cuts, by_axis)
            if pp.cuts == zp.cuts:
                agree += 1
                assert by_axis == {a: norm + (2 * g.nbytes if a not in pp.axes() and a != "model"
                                              else 0) for a in ("pod", "data", "model")}
    assert agree == {"smollm_360m": 2, "tinyllama_1_1b": 3}[arch]


# ---------------------------------------------------------------------------
# the sweep's table and the CLI
# ---------------------------------------------------------------------------

def test_sweep_covers_every_cell_with_the_references_skips():
    """Every job of the sweep, once; the reference's skips exactly, with its
    reasons, and no other record short of a count: the model cells the
    reference lowers are all counted (the prefill and decode cells through
    `count_infer`, traced below on the smoke config and in the CLI's decode
    record; the 48 production traces are the host sweep's and phase 25's)."""
    jobs = dryrun.all_jobs()
    assert len(jobs) == len(set(jobs)) == 2 * (10 * 4 + 21)
    hdc = [c for a, c, mp in jobs if a == "hdc-scaleout" and not mp]
    assert hdc == list(dryrun.HDC_CELLS) and "serve_sparse" in hdc
    counted = []
    for arch, cell, multi_pod in jobs:
        if arch == "hdc-scaleout":
            continue
        jcfg = jconfigs.get_config(arch)
        ok, why = jshapes.cell_applicable(jcfg, jshapes.CELLS[cell])
        if not ok:
            rec = dryrun.count_cell(arch, cell, multi_pod)
            assert rec["status"] == "skipped" and rec["why"] == why, (arch, cell)
            assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
        else:
            counted.append((arch, cell, multi_pod))
    assert len(counted) == 2 * (10 * 4 - 6)      # long_500k runs on the 4 sub-quadratic
    assert not hasattr(dryrun, "NOT_PORTED")
    rec = dryrun.count_cell("hdc-scaleout", "serve_sparse_packed", False)
    assert rec["status"] == "skipped" and "no _packed variant" in rec["why"]


def test_a_trace_for_the_card_needs_cuda(tmp_path, capsys, monkeypatch):
    """Fake CPU tensors stand for the card only when asked for: "cuda"
    where torch has no CUDA raises (the CLI's record is an error naming
    ``--device cpu``); with no ``--device`` the CLI traces on what torch
    has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.count_cell("tinyllama-1.1b", "train_4k", False, device="cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.run_custom(dict(kind="ota", cfg=SERVE, mesh=[1]), "cuda")
    out = str(tmp_path)
    assert dryrun.main(["--arch", "hdc-scaleout", "--cell", "serve_packed", "--out", out,
                        "--device", "cuda"]) == 1
    rec = json.loads((tmp_path / "pod1" / "hdc-scaleout__serve_packed.json").read_text())
    assert rec["status"] == "error" and "--device cpu" in rec["error"]
    assert dryrun.default_device() == "cpu"
    capsys.readouterr()


def test_cli_records(tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "hdc-scaleout", "--cell", "serve_packed", "--out", out]) == 0
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--cell", "train_4k", "--out", out]) == 0
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--cell", "decode_32k", "--out", out]) == 0
    capsys.readouterr()
    recs = {p.name: json.loads(p.read_text()) for p in (tmp_path / "pod1").glob("*.json")}
    for name in ("hdc-scaleout__serve_packed.json", "tinyllama-1.1b__train_4k.json",
                 "tinyllama-1.1b__decode_32k.json"):
        r = recs[name]
        assert r["status"] == "ok" and r["mesh"] == "16x16" and r["chips"] == 256
        assert r["traced_on"] == "cpu" and "standing for the card" in r["notes"][0]
        m, c = r["memory_per_rank"], r["cost_per_rank"]
        assert 0 < m["arguments"] <= m["peak_bytes"] < 80 * 2**30
        assert c["flops"] > 0 and c["hbm_bytes"] > 0
        assert c["collective"]["total"] == sum(c["collective_by_axis"].values()) > 0
        assert set(r["roofline_s"]) >= {"compute", "memory", "collective", "dominant"}
    train = recs["tinyllama-1.1b__train_4k.json"]
    assert train["model_flops_global"] == 6.0 * train["params"] * 256 * 4096
    assert train["cost_per_rank"]["kernels"]["flash_attention_bwd"]["launches"] == 22
    decode = recs["tinyllama-1.1b__decode_32k.json"]
    assert decode["kind"] == "decode" and decode["model_flops_global"] == \
        2.0 * decode["params"] * 128
    # TinyLlama-1.1B's cache on rank 0: 8 rows of 32768 / 16 slots, all 4 kv heads
    assert decode["memory_per_rank"]["arguments_by_kind"]["cache"] == \
        2 * 22 * 8 * 2048 * 4 * 64 * 2 + 32768 * 4
    serve = recs["hdc-scaleout__serve_packed.json"]
    assert serve["cost_per_rank"]["kernels"]["hamming_topk_banked"]["launches"] == 1
    assert serve["cost_per_rank"]["collective_bytes_per_trial"] == \
        serve["cost_per_rank"]["collective"]["total"] / 4096
