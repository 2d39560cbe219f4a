"""The dry run: what one rank of the production meshes holds, moves and
sends, counted without allocating (counterpart of `repro/launch/dryrun.py`).

The reference lowers and compiles every (architecture x cell) on 512
placeholder CPU devices and reads the compiled program. The port's
counterpart of "lower and compile" is "trace one call on fake tensors":
each cell's step runs once under ``FakeTensorMode`` (no memory is
allocated, no kernel launches), from rank 0's view of the production mesh
built over a fake process group as wide as it (`launch.mesh.fake_world`,
`make_production_mesh`: (16, 16) or (2, 16, 16)), inside
`analysis.op_cost.OpCost`. The kernels take their fake branch and record
their ``cost()``; the collectives run on the fake group and count their
wire bytes. So each record holds, per rank:

* ``memory_per_rank``: the arguments' bytes (parameters, optimizer state,
  the rank's batch rows; a decode's cache piece; for a serve its classes,
  queries and state), the
  peak of the live bytes over the call, its temporaries, and every
  category at the peak (the counterpart of ``memory_analysis()``);
* ``cost_per_rank``: FLOPs (aten products by dtype and the kernels'
  operations by kind), device-memory bytes (operand plus result bytes of
  every aten op, the kernels' own bytes), the kernels' launches, and the
  wire bytes by collective type and by mesh axis;
* ``roofline_s`` at the H100's peaks (`analysis.roofline`): counts at the
  datasheet's rates, not timings;
* ``model_flops_global`` and ``useful_flops_ratio`` (the model cells).

Cells: `configs.shapes.CELLS` for the ten architectures (an AdamW step for
``train_4k``; the prefill of ``prefill_32k``; one decode step over a full
cache for ``decode_32k`` and ``long_500k``, both through
`train.loop.build_infer_fns`), and the reference's 21 HDC cells. Statuses:
``ok``; ``skipped`` where the reference skips (``long_500k`` on the
full-attention architectures, ``serve_sparse_packed``); and ``error`` with
the traceback. The reference's XLA lowering switches
(``--flash-vjp``, ``--uneven-heads``, ``--expand-kv``, ``REPRO_FLASH_P_BF16``,
``REPRO_REDUCE_BF16``) have no counterpart: the port has one attention
backward, the kernel, and no GSPMD.

``--device`` is the device the fake tensors lie on: "cuda" (the default
where torch has CUDA) or "cpu" (the default where it has none: a CPU build
aborts on a fake CUDA tensor's autograd). Asking for "cuda" where torch has
no CUDA raises. Every record says what it was traced on (``traced_on``).
Fake CPU tensors stand for the card: the kernels' fake branch does not
depend on the device, but `moe._bmm_acc` and `mamba._dot_f32` widen their
bf16 products to f32 on the CPU where the card uses ``out_dtype``, so those
products count as f32 there.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --cell train_4k
  python -m repro_torch.launch.dryrun --arch hdc-scaleout --cell serve_packed --multi-pod
  python -m repro_torch.launch.dryrun --all --jobs 8   # 2 meshes x (40 + 21) records
  python -m repro_torch.launch.dryrun --custom jobs.json --out result.json
  python -m repro_torch.launch.dryrun --table          # the records as markdown
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")
HDC_CELLS = ("serve", "serve_psumpacked", "serve_rsag", "serve_symbol", "serve_topk",
             "serve_adaptive", "serve_faulty", "serve_wired", "serve_hdc_multitenant",
             "train", "serve_packed", "serve_psumpacked_packed", "serve_rsag_packed",
             "serve_symbol_packed", "serve_topk_packed", "serve_adaptive_packed",
             "serve_faulty_packed", "serve_wired_packed", "serve_hdc_multitenant_packed",
             "train_packed", "serve_sparse")
SLOTS = TENANTS = 8          # the multi-tenant cell: 8 resident tenants x 8 slots
BF16_STATE_ABOVE = 2e11      # parameters above which AdamW's moments are bf16


def default_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def trace_notes(device: str) -> list:
    """What a trace on ``device`` stands for; raises for "cuda" where this
    build of torch has no CUDA (it cannot make fake tensors there)."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this torch has no CUDA: trace on fake CPU tensors (--device cpu)")
    if kind == "cpu":
        return ["traced on fake CPU tensors standing for the card: the kernels' costs are "
                "the card's; moe._bmm_acc and mamba._dot_f32 take the CPU's f32-widened "
                "branch"]
    return []


def _mesh_name(shape) -> str:
    return "x".join(str(s) for s in shape)


@contextlib.contextmanager
def _world(shape):
    """This rank's (rank 0) mesh of ``shape`` over a fake world, or None
    for one rank."""
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch.mesh import AXES, fake_world

    shape = tuple(shape)
    if math.prod(shape) == 1:
        yield None
        return
    with fake_world(math.prod(shape)):
        yield make_mesh(shape, AXES[-len(shape):])


def _roofline(oc, chips: int = 1) -> dict:
    from repro_torch.analysis import roofline

    rl = roofline.roofline_terms(oc.flops, oc.hbm_bytes, oc.wire_bytes, chips,
                                 ops_by_kind=oc.ops_by_kind)
    return dict(compute=rl.compute_s, memory=rl.memory_s, collective=rl.collective_s,
                dominant=rl.dominant, bound=rl.bound_s,
                at="H100 SXM datasheet peaks (analysis.roofline); counts, not timings")


def _costs(oc) -> dict:
    return dict(flops=oc.flops, flops_by_kind=oc.ops_by_kind,
                aten_flops_by_dtype=dict(oc.flops_by_kind), hbm_bytes=oc.hbm_bytes,
                kernels=oc.kernels, aten_ops=sum(oc.calls_by_op.values()),
                top_aten_ops=oc.top_ops(),
                collective=dict(oc.wire_by_op, total=oc.wire_bytes),
                collective_by_axis=oc.wire_by_axis)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def count_train(cfg, batch: dict, mesh, device: str) -> dict:
    """One traced AdamW step of ``cfg`` on this rank's shards: ``batch`` is
    {name: (global shape, dtype)}, cut to the rank's rows as the step cuts
    them. The moments in bf16 above `BF16_STATE_ABOVE` parameters, as the
    reference's dry run keeps them (`repro/launch/dryrun.py:93`). Returns
    the record's counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.op_cost import OpCost
    from repro_torch.models import count_params, get_model
    from repro_torch.models.base import abstract_params
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import _data_place, build_train_fns
    from repro_torch.tree import tree_leaves, tree_unflatten

    model = get_model(cfg)
    n_params = count_params(model.specs)
    state_dtype = torch.bfloat16 if n_params > BF16_STATE_ABOVE else torch.float32
    opt = opt_lib.OptConfig(state_dtype=state_dtype)
    fns = build_train_fns(model, opt, mesh=mesh, device=device)
    pp, op = fns.placements
    like = abstract_params(model.specs)
    _, data = _data_place(fns.mesh)
    t0 = time.perf_counter()
    with FakeTensorMode():
        def local(p, x):
            shape = p.local_shape(fns.mesh) if fns.mesh is not None else p.shape
            return torch.empty(shape, dtype=x.dtype, device=device)

        params = tree_unflatten(like, [local(p, x) for p, x in
                                       zip(tree_leaves(pp), tree_leaves(like))])
        shard_like = tree_unflatten(like, [torch.empty(local(p, x).shape, dtype=x.dtype,
                                                       device="meta")
                                           for p, x in zip(tree_leaves(op["m"]),
                                                           tree_leaves(like))])
        opt_state = opt_lib.adamw_init(opt, shard_like, device=device)
        rows = {}
        for k, (shape, dtype) in batch.items():
            if shape[0] % data:
                raise ValueError(f"global batch {shape[0]} does not split over {data} "
                                 "data ranks")
            rows[k] = torch.empty((shape[0] // data,) + tuple(shape[1:]), dtype=dtype,
                                  device=device)
        with OpCost() as oc:
            arg = dict(parameters=oc.track(params, "parameters"),
                       optimizer=oc.track(opt_state, "optimizer"),
                       batch=oc.track(rows, "batch"))
            out = fns.step(params, opt_state, rows, None, local=True)
            del out
    return dict(params=n_params, state_dtype=str(state_dtype).split(".")[-1],
                memory_per_rank=dict(arguments=sum(arg.values()), arguments_by_kind=arg,
                                     **oc.memory()),
                cost_per_rank=_costs(oc), roofline_s=_roofline(oc),
                t_count_s=time.perf_counter() - t0, _oc=oc)


def count_infer(cfg, kind: str, batch: dict, mesh, device: str, seq: int | None = None,
                pad_to: int | None = None) -> dict:
    """One traced prefill (``kind`` "prefill": ``batch`` {name: (global
    shape, dtype)}, at ``pad_to`` capacity) or one decode step (``kind``
    "decode": ``batch`` {"token": ((B,), int32)} at position ``seq`` - 1
    over a cache of ``seq`` slots, every slot full) of ``cfg`` on this
    rank's shards (`train.loop.build_infer_fns`): the rank's rows of the
    batch, its piece of the cache as the rules engine cuts it. The
    arguments' categories: parameters, cache (decode), batch (the rank's
    rows, and the decode's int32 position as the reference's 0-d
    argument). Returns the record's counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.op_cost import OpCost
    from repro_torch.models import count_params, get_model
    from repro_torch.models.base import abstract_params
    from repro_torch.train.loop import build_infer_fns
    from repro_torch.tree import tree_leaves, tree_unflatten

    model = get_model(cfg)
    n_params = count_params(model.specs)
    fns = build_infer_fns(model, mesh=mesh, device=device)
    like = abstract_params(model.specs)
    b = next(iter(batch.values()))[0][0]
    rows = fns.rows(torch.empty((b,), device="meta")).shape[0]
    cplc = fns.cache_placements(b, seq) if kind == "decode" else None
    cache_like = model.init_cache_fn(b, seq, device="meta") if kind == "decode" else None
    t0 = time.perf_counter()
    with FakeTensorMode():
        def local(p, x):
            shape = p.local_shape(fns.mesh) if fns.mesh is not None else p.shape
            return torch.empty(shape, dtype=x.dtype, device=device)

        params = tree_unflatten(like, [local(p, x) for p, x in
                                       zip(tree_leaves(fns.placements), tree_leaves(like))])
        mine = {k: torch.empty((rows,) + tuple(shape[1:]), dtype=dtype, device=device)
                for k, (shape, dtype) in batch.items()}
        if kind == "decode":
            cache = tree_unflatten(cache_like, [local(p, x) for p, x in
                                                zip(tree_leaves(cplc), tree_leaves(cache_like))])
            pos = torch.empty((), dtype=torch.int32, device=device)
        with OpCost() as oc:
            arg = dict(parameters=oc.track(params, "parameters"))
            if kind == "decode":
                arg["cache"] = oc.track(cache, "cache")
                arg["batch"] = oc.track([mine["token"], pos], "batch")
                out = fns.decode(params, cache, mine["token"], seq - 1, global_batch=b)
            else:
                arg["batch"] = oc.track(mine, "batch")
                out = fns.prefill(params, mine, pad_to, global_batch=b)
            del out
    return dict(params=n_params,
                memory_per_rank=dict(arguments=sum(arg.values()), arguments_by_kind=arg,
                                     **oc.memory()),
                cost_per_rank=_costs(oc), roofline_s=_roofline(oc),
                t_count_s=time.perf_counter() - t0, _oc=oc)


def count_cell(arch: str, cell_name: str, multi_pod: bool, device: str = "cuda",
               capacity_factor: float | None = None) -> dict:
    """The record of one (architecture x cell) on a production mesh (the
    counterpart of the reference's ``lower_cell``)."""
    from repro_torch import configs
    from repro_torch.analysis import roofline
    from repro_torch.configs.shapes import CELLS, cell_applicable, input_specs
    from repro_torch.launch.mesh import PRODUCTION

    shape, _ = PRODUCTION[multi_pod]
    chips = math.prod(shape)
    head = dict(arch=arch, cell=cell_name, mesh=_mesh_name(shape), chips=chips)
    if arch in ("hdc-scaleout", "hdc_scaleout"):
        return _count_hdc(cell_name, multi_pod, device)
    cfg = configs.get_config(arch)
    cell = CELLS[cell_name]
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        return dict(head, status="skipped", why=why)
    if capacity_factor is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                              capacity_factor=capacity_factor))
    notes = trace_notes(device)
    _, shapes, _ = input_specs(cfg, cell)
    batch = {k: (tuple(v.shape), v.dtype) for k, v in shapes.items()}
    t0 = time.perf_counter()
    with _world(shape) as mesh:
        if cell.kind == "train":
            rec = count_train(cfg, batch, mesh, device)
        else:
            if cell.kind == "decode":
                batch = {"token": ((cell.batch,), torch.int32)}
            rec = count_infer(cfg, cell.kind, batch, mesh, device, seq=cell.seq)
    oc = rec.pop("_oc")
    rec["t_count_s"] = time.perf_counter() - t0
    mf = roofline.model_flops(cfg, cell, rec["params"])
    extra = dict(opt="adamw") if cell.kind == "train" else dict(kind=cell.kind)
    return dict(head, status="ok", traced_on=device, notes=notes, rank=0, **extra,
                **rec, model_flops_global=mf,
                useful_flops_ratio=mf / max(oc.flops * chips, 1.0))


# ---------------------------------------------------------------------------
# the HDC cells
# ---------------------------------------------------------------------------

def hdc_config(cell_name: str):
    """The reference's `ScaleOutConfig` of an HDC cell (`_lower_hdc`): 102,400
    classes over 1024 cores, d = 2048 (2^20 sparse), M = 3, 4096 trials a
    call (512 a slot multi-tenant), bitplane noise."""
    from repro_torch.core import scaleout

    packed = cell_name.endswith("_packed")
    base = cell_name[: -len("_packed")] if packed else cell_name
    collective = {"serve_rsag": "rs_ag", "serve_psumpacked": "psum_packed"}.get(base, "psum")
    mt = base == "serve_hdc_multitenant"
    sparse_cell = base == "serve_sparse"
    return base, packed, scaleout.ScaleOutConfig(
        n_classes=102_400, dim=1_048_576 if sparse_cell else 2048,
        m_tx=3, n_rx_cores=1024, batch=512 if mt else 4096,
        collective="index_ag" if sparse_cell else collective,
        representation="sparse" if sparse_cell else "packed" if packed else "unpacked",
        k_max=2048 if sparse_cell else 0, noise="bitplane",
        channel="symbol" if base in ("serve_symbol", "serve_adaptive") else "bsc",
        **({"coarse_group": 10, "coarse_keep": 4} if base == "serve_topk" else {}))


def count_serve(kind: str, cfg, mesh, device: str, *, slots: int = 0, tenants: int = 0
                ) -> dict:
    """One traced call of an HDC serve on this rank's inputs: ``kind`` is
    "ota", "wired", "train", "adaptive" (a `PhaseDriftProcess` tick ahead of
    the serve), "faulty" (`StaticFaults`) or "mt" (``slots`` slots over
    ``tenants`` tenants). Returns the record's counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import faults, phy
    from repro_torch.analysis.op_cost import OpCost
    from repro_torch.core import scaleout

    sh = scaleout._shard_of(cfg, mesh)
    _, data = scaleout._dpos(mesh)
    b = cfg.batch // data
    c_l = cfg.n_classes // sh.model_size
    last = cfg.words if cfg.packed or cfg.sparse else cfg.dim
    q_last = cfg.k_max if cfg.sparse else last
    hv_dtype = torch.int32 if cfg.packed or cfg.sparse else torch.uint8
    t0 = time.perf_counter()
    with FakeTensorMode():
        def empty(*shape, dtype=hv_dtype):
            return torch.empty(shape, dtype=dtype, device=device)

        def gen():
            return torch.Generator(device=device)

        if kind == "train":
            fn = scaleout.make_hdc_train(cfg, device=device, mesh=mesh)
            args = dict(examples=empty(b, last), labels=empty(b, dtype=torch.int32))
            call = lambda: fn(args["examples"], args["labels"])             # noqa: E731
        elif kind == "mt":
            fn = scaleout.make_mt_ota_serve(cfg, device=device, mesh=mesh)
            args = dict(store=empty(tenants, c_l, last),
                        queries=empty(slots, b, 1, sh.e_per, q_last),
                        rows=empty(slots, dtype=torch.int32),
                        state=phy.state_shape_structs(sh.cores, cfg.m_tx, device))
            gens = [gen() for _ in range(slots)]
            call = lambda: fn(args["store"], args["queries"], args["rows"],  # noqa: E731
                              args["state"], gens)
        else:
            args = dict(protos=empty(c_l, last), queries=empty(b, 1, sh.e_per, q_last))
            if kind == "wired":
                fn = scaleout.make_wired_serve(cfg, device=device, mesh=mesh)
            else:
                fn = scaleout.make_ota_serve(
                    cfg, device=device, mesh=mesh,
                    process=phy.PhaseDriftProcess(guard_dims=64) if kind == "adaptive" else None,
                    faults=faults.StaticFaults() if kind == "faulty" else None)
            if kind == "adaptive":
                args["state"] = phy.pstate_shape_structs(sh.cores, cfg.m_tx, device)
                pg = phy.ProcessGenerators(gen(), gen(), gen())
                call = lambda: fn(args["protos"], args["queries"],          # noqa: E731
                                  args["state"], gen(), pg)
            elif kind == "faulty":
                args["state"] = phy.state_shape_structs(sh.cores, cfg.m_tx, device)
                args["fstate"] = faults.fstate_shape_structs(
                    sh.cores, sh.model_size * sh.e_per, cfg.words, device)
                call = lambda: fn(args["protos"], args["queries"], args["state"],  # noqa: E731
                                  gen(), args["fstate"], gen())
            else:
                args["state"] = phy.state_shape_structs(sh.cores, cfg.m_tx, device)
                call = lambda: fn(args["protos"], args["queries"], args["state"],  # noqa: E731
                                  gen())
        with OpCost() as oc:
            arg = {k: oc.track([getattr(v, f) for f in v.FIELDS] if hasattr(v, "FIELDS")
                               else v, k) for k, v in args.items()}
            out = call()
            del out
    n_trials = cfg.batch * (slots if kind == "mt" else 1)
    costs = _costs(oc)
    costs.update(collective_bytes_per_trial=oc.wire_bytes / n_trials,
                 hbm_bytes_per_trial=oc.hbm_bytes / n_trials)
    return dict(memory_per_rank=dict(arguments=sum(arg.values()), arguments_by_kind=arg,
                                     **oc.memory()),
                cost_per_rank=costs, roofline_s=_roofline(oc),
                t_count_s=time.perf_counter() - t0, _oc=oc)


def _count_hdc(cell_name: str, multi_pod: bool, device: str = "cuda") -> dict:
    """The record of one HDC cell on a production mesh (the counterpart of
    the reference's ``_lower_hdc``)."""
    from repro_torch.launch.mesh import PRODUCTION

    shape, _ = PRODUCTION[multi_pod]
    head = dict(arch="hdc-scaleout", cell=cell_name, mesh=_mesh_name(shape),
                chips=math.prod(shape))
    if cell_name not in HDC_CELLS and cell_name != "serve_sparse_packed":
        return dict(head, status="skipped", why="cells: " + " | ".join(HDC_CELLS))
    if cell_name == "serve_sparse_packed":
        return dict(head, status="skipped",
                    why="serve_sparse has no _packed variant — sparse is its own "
                        "representation (packed prototype words, int32 index-list queries)")
    base, _, cfg = hdc_config(cell_name)
    kind = {"serve_wired": "wired", "train": "train", "serve_adaptive": "adaptive",
            "serve_faulty": "faulty", "serve_hdc_multitenant": "mt"}.get(base, "ota")
    notes = trace_notes(device)
    mt = kind == "mt"
    with _world(shape) as mesh:
        rec = count_serve(kind, cfg, mesh, device, slots=SLOTS if mt else 0,
                          tenants=TENANTS if mt else 0)
    rec.pop("_oc")
    config = dict(classes=cfg.n_classes, dim=cfg.dim, m_tx=cfg.m_tx, rx_cores=cfg.n_rx_cores,
                  batch=cfg.batch, representation=cfg.representation,
                  collective=cfg.collective, channel=cfg.channel, noise=cfg.noise)
    if cfg.sparse:
        config["k_max"] = cfg.k_max
    if cfg.coarse_group:
        config.update(coarse_group=cfg.coarse_group, coarse_keep=cfg.coarse_keep)
    if mt:
        config.update(slots=SLOTS, tenants=TENANTS)
    return dict(head, status="ok", traced_on=device, notes=notes, rank=0, config=config,
                **rec)


# ---------------------------------------------------------------------------
# custom jobs (chip_smoke.py's phase 25: a measured run's own shapes)
# ---------------------------------------------------------------------------

def _custom_cfg(job: dict):
    """The job's model config: its architecture's, cut to its first
    ``layers`` layers (their windows with them; whole groups of a hybrid's)
    and, for the MoE, to ``experts`` routed experts."""
    from repro_torch import configs

    cfg = configs.get_config(job["arch"])
    if job.get("layers"):
        cut = {"n_layers": job["layers"]}
        if cfg.window_pattern is not None:
            cut["window_pattern"] = cfg.window_pattern[:job["layers"]]
        cfg = dataclasses.replace(cfg, **cut)
    if job.get("experts"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                              n_experts=job["experts"]))
    return cfg


def _infer_batch(cfg, job: dict) -> dict:
    """A prefill job's batch: {name: (global shape, dtype)}, tokens [B, seq]
    and, where the family reads them, the config's enc_seq frames or
    ``vision`` patch embeddings with their M-RoPE positions."""
    b, s, sv = job["batch"], job["seq"], job.get("vision", 0)
    out = {"tokens": ((b, s), torch.int32)}
    if cfg.kind == "encdec":
        out["frames"] = ((b, cfg.enc_seq, cfg.d_model), cfg.dtype)
    if cfg.kind == "vlm":
        out["patch_embeds"] = ((b, sv, cfg.d_model), cfg.dtype)
        out["positions"] = ((b, sv + s, 3), torch.int32)
    return out


def run_custom(job: dict, device: str) -> dict:
    """One job of ``--custom``: {"kind": "train", "arch", "layers" (optional
    depth cut), "batch", "seq", "mesh": [data, model]} (an AdamW step);
    {"kind": "prefill", "arch", "layers", "experts" (optional), "batch",
    "seq", "vision" (VLM patches), "pad_to", "mesh"} or {"kind": "decode",
    ..., "batch", "seq" (the cache's slots; the step at seq - 1), "mesh"};
    or {"kind": "ota" | "wired" | "train_hdc" | ..., "cfg": {ScaleOutConfig
    fields}, "mesh": [...]}; each traced as rank 0 of that mesh."""
    from repro_torch.core import scaleout

    notes = trace_notes(device)
    shape = tuple(job.get("mesh", (1,)))
    with _world(shape) as mesh:
        if job["kind"] == "train":
            bs = (job["batch"], job["seq"])
            rec = count_train(_custom_cfg(job),
                              {"tokens": (bs, torch.int32), "targets": (bs, torch.int32)},
                              mesh, device)
        elif job["kind"] == "prefill":
            cfg = _custom_cfg(job)
            rec = count_infer(cfg, "prefill", _infer_batch(cfg, job), mesh, device,
                              pad_to=job.get("pad_to"))
        elif job["kind"] == "decode":
            rec = count_infer(_custom_cfg(job), "decode",
                              {"token": ((job["batch"],), torch.int32)}, mesh, device,
                              seq=job["seq"])
        else:
            kind = "train" if job["kind"] == "train_hdc" else job["kind"]
            rec = count_serve(kind, scaleout.ScaleOutConfig(**job["cfg"]), mesh, device)
    rec.pop("_oc")
    return dict(job=job, status="ok", mesh=_mesh_name(shape), traced_on=device, notes=notes,
                **rec)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def out_path(out: str, arch: str, cell: str, multi_pod: bool) -> str:
    d = os.path.abspath(os.path.join(out, "pod2" if multi_pod else "pod1"))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch.replace('/', '_')}__{cell}.json")


def run_one(arch: str, cell: str, multi_pod: bool, *, out: str = OUT, force: bool = False,
            device: str = "cuda", capacity_factor: float | None = None) -> dict:
    """The record of one cell, from ``out`` when it holds one (unless
    ``force``), else counted and written there; a failure is an ``error``
    record with its traceback."""
    path = out_path(out, arch, cell, multi_pod)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        rec = count_cell(arch, cell, multi_pod, device=device,
                         capacity_factor=capacity_factor)
    except Exception as e:      # the record names the failure
        rec = dict(arch=arch, cell=cell, status="error",
                   mesh="2x16x16" if multi_pod else "16x16",
                   error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def all_jobs() -> list[tuple[str, str, bool]]:
    from repro_torch import configs
    from repro_torch.configs.shapes import CELLS

    jobs = []
    for multi_pod in (False, True):
        for arch in configs.ARCHS:
            for cell in CELLS:
                jobs.append((arch.replace("_", "-"), cell, multi_pod))
        for cell in HDC_CELLS:
            jobs.append(("hdc-scaleout", cell, multi_pod))
    return jobs


def sweep(args) -> int:
    """Every job of `all_jobs`, each in a subprocess of its own under
    ``args.timeout`` (a cell past it is an ``error`` record), ``args.jobs``
    at once."""
    jobs = all_jobs()
    pending = [j for j in jobs
               if args.force or not os.path.exists(out_path(args.out, *j))]
    print(f"{len(jobs)} cells total, {len(pending)} to run, jobs={args.jobs}", flush=True)
    procs: list = []
    done = 0
    while pending or procs:
        while pending and len(procs) < args.jobs:
            arch, cell, mp = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--cell", cell, "--out", args.out, "--device", args.device, "--force"]
            if mp:
                cmd.append("--multi-pod")
            p = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            procs.append((p, (arch, cell, mp), time.monotonic()))
        for p, meta, t0 in procs[:]:
            late = time.monotonic() - t0 > args.timeout
            if p.poll() is None and not late:
                continue
            if late and p.poll() is None:
                p.kill()
                p.wait()
                arch, cell, mp = meta
                with open(out_path(args.out, arch, cell, mp), "w") as f:
                    json.dump(dict(arch=arch, cell=cell, status="error",
                                   mesh="2x16x16" if mp else "16x16",
                                   error=f"timeout: not counted within {args.timeout} s"),
                              f, indent=1)
            procs.remove((p, meta, t0))
            done += 1
            arch, cell, mp = meta
            path = out_path(args.out, arch, cell, mp)
            status = "?"
            if os.path.exists(path):
                with open(path) as f:
                    status = json.load(f).get("status")
            print(f"[{done}/{len(jobs)}] {arch} {cell} {'pod2' if mp else 'pod1'}: {status}",
                  flush=True)
        time.sleep(0.2)
    recs = []
    for arch, cell, mp in jobs:
        path = out_path(args.out, arch, cell, mp)
        with open(path) as f:
            recs.append(json.load(f))
    bad = [r for r in recs if r.get("status") == "error"]
    print(f"done: {len(recs)} records, " + ", ".join(
        f"{s} {sum(r.get('status') == s for r in recs)}"
        for s in ("ok", "skipped", "error")), flush=True)
    for r in bad:
        print(f"  ERROR: {r['arch']} {r['cell']} {r['mesh']}: {r.get('error')}", flush=True)
    return 0


def table(out: str = OUT) -> str:
    """The records under ``out`` as two markdown tables, the model cells'
    (a row per architecture, a column per cell and mesh) and the HDC
    cells' (a row per cell, its packed variant beside it, a column per
    mesh): per rank, the peak GiB, TFLOP (model cells) or wire and device
    bytes a trial (HDC), wire GB (the pod axis's apart), and the roofline
    bound with its dominant term. Counts at the H100 SXM's datasheet peaks,
    not timings."""
    recs = {}
    for arch, cell, mp in all_jobs():
        path = out_path(out, arch, cell, mp)
        if os.path.exists(path):
            with open(path) as f:
                recs[(arch, cell, mp)] = json.load(f)

    def one(r, hdc: bool) -> str:
        if r is None:
            return "not run"
        if r.get("status") != "ok":
            return r.get("status", "?") + ("" if r.get("status") != "error" else
                                           f": {r.get('error', '')[:60]}")
        m, c, rl = r["memory_per_rank"], r["cost_per_rank"], r["roofline_s"]
        wire = c["collective"]["total"]
        pod = c["collective_by_axis"].get("pod", 0)
        bound = (f"{rl['bound'] * 1e3:.4g} ms" if hdc else f"{rl['bound']:.4g} s") + \
            f" {rl['dominant'][:4]}"
        if hdc:
            return (f"{m['peak_bytes'] / 2**30:.3g} / {c['collective_bytes_per_trial']:.4g} B / "
                    f"{c['hbm_bytes_per_trial'] / 1e3:.4g} kB / {bound}")
        return (f"{m['peak_bytes'] / 2**30:.3g} / {c['flops'] / 1e12:.4g} / "
                f"{wire / 1e9:.4g}" + (f" ({pod / 1e9:.3g} pod)" if pod else "") + f" / {bound}")

    from repro_torch import configs
    cells = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    rows = ["| arch (GiB / TFLOP / wire GB / bound) | " + " | ".join(
                f"{c} {m}" for c in cells for m in ("16x16", "2x16x16")) + " |",
            "|---|" + "---|" * 2 * len(cells)]
    for arch in configs.ARCHS:
        a = arch.replace("_", "-")
        rows.append(f"| {a} | " + " | ".join(one(recs.get((a, c, mp)), False)
                                             for c in cells for mp in (False, True)) + " |")
    rows += ["", "| HDC cell (GiB / wire a trial / device bytes a trial / bound) | "
             "unpacked 16x16 | unpacked 2x16x16 | packed 16x16 | packed 2x16x16 |",
             "|---|---|---|---|---|"]
    for cell in HDC_CELLS:
        if cell.endswith("_packed"):
            continue
        rows.append(f"| {cell} | " + " | ".join(
            one(recs.get(("hdc-scaleout", c, mp)), True) if c in HDC_CELLS else "skipped"
            for c in (cell, cell + "_packed") for mp in (False, True)) + " |")
    status = collections.Counter(r.get("status") for r in recs.values())
    rows += ["", f"{len(recs)} of {len(all_jobs())} records: " + ", ".join(
        f"{k} {v}" for k, v in sorted(status.items()))]
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Count each production cell's per-rank "
                                 "memory, FLOPs, bytes and wire bytes on fake tensors.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--multi-pod", action="store_true", help="the (2, 16, 16) mesh")
    ap.add_argument("--all", action="store_true", help="all archs x cells x both meshes")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a cell of --all may take")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT,
                    help="records go to OUT/<pod1|pod2>/<arch>__<cell>.json (--custom: a file)")
    ap.add_argument("--device", default=None,
                    help="the device the fake tensors lie on: cuda (the default where torch "
                         "has CUDA) or cpu (the default where it has none)")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--custom", default=None,
                    help="a JSON list of jobs (run_custom) counted in this process")
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as markdown tables")
    args = ap.parse_args(argv)
    args.device = args.device or default_device()
    if args.table:
        print(table(args.out))
        return 0
    if args.custom:
        with open(args.custom) as f:
            jobs = json.load(f)
        recs = []
        for job in jobs:
            try:
                recs.append(run_custom(job, args.device))
            except Exception as e:      # the record names the failure
                recs.append(dict(job=job, status="error", error=f"{type(e).__name__}: {e}",
                                 traceback=traceback.format_exc()[-4000:]))
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1, default=str)
        print(json.dumps([{k: r.get(k) for k in ("status", "mesh", "error")} for r in recs]))
        return int(any(r["status"] == "error" for r in recs))
    if args.all:
        return sweep(args)
    if not (args.arch and args.cell):
        ap.error("give --arch and --cell, --all, or --custom")
    rec = run_one(args.arch, args.cell, args.multi_pod, out=args.out, force=args.force,
                  device=args.device, capacity_factor=args.capacity_factor)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}, indent=1,
                     default=str))
    if rec["status"] == "error":
        print(rec.get("traceback", ""), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
