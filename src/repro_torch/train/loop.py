"""Single-GPU training (counterpart of `repro/train/loop.py`): the train
step and the fault-tolerant host runner; and, beside the train step, the
prefill and decode on ranks (`build_infer_fns`, the counterpart of the
reference's GSPMD inference that its dry run lowers).

Two gradient modes, as in the reference:

* "adamw"          -- autograd over the model's loss (the attention's
                      gradient through the hand-written backward kernel),
                      then AdamW.
* "sign_majority"  -- the paper's OTA collective applied to training: the
                      gradients' signs majority-voted by `sign_allreduce`,
                      optionally through the OTA BER channel, then signum.

Microbatches accumulate f32 gradients divided by ``microbatch``, the loss is
their mean and the metrics are the last microbatch's, as the reference's
lax.scan gives them.

On a rank mesh (``mesh=``, a (data, model) `RankMesh`, optionally with a
pod axis) the step is the reference's GSPMD step written out: every
parameter is placed by the rules engine (`distributed.sharding`; heads,
kv heads, MLP and vocabulary on ``model``, ``embed`` on ``data`` where a
config overrides it), the layers run tensor-parallel on the rank's shards
(`collectives.TensorParallel`), and each data rank takes rows
[i*B/D, (i+1)*B/D) of the global batch. AdamW sums the gradients over the
data ranks (each rank's loss is its share of the global mean) and updates
ZeRO-1 (`optimizer.Zero1`); signum votes each rank's local gradient
through `sign_allreduce` over the data ranks at ``ota_ber``, under the
`strip_dp` rules, each data rank's noise on its own generator, and reports
the data mean of the loss. With one rank the step is the one-GPU step.

The `Trainer` adds checkpoint/restart (atomic keep-k; on ranks the global
leaves, gathered and written one at a time, restored onto any mesh), O(1)
data skip-ahead on resume and a failure-injection hook.

Randomness, a difference by design: the reference passes one PRNG key to
every step (and folds no leaf into it), so its BER flips fall on the same
positions every step and on every leaf of one shape. A torch generator is
used up by drawing, so the port seeds step t's OTA noise from (seed, t) and
draws the leaves' flips one after another from it: a resumed run replays
the flips of an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.device import resolve
from repro_torch.distributed import collectives, sharding
from repro_torch.models.base import abstract_params, init_params, param_axes, param_shapes
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainFns:
    step: Callable          # (params, opt_state, batch, generator) -> (params, opt_state, metrics)
    #                         (``local=True``: the batch is this data rank's rows already)
    init: Callable          # (seed) -> (params, opt_state): this rank's shards
    abstract: Callable      # () -> (params, opt_state) as global meta tensors: the structure
    device: torch.device
    mesh: object = None     # the RankMesh (None: one rank)
    placements: object = None   # (params, opt_state) trees of sharding.Placement
    data_index: int = 0     # this rank's flat position on the data axes
    shard_params: Callable | None = None   # (global params) -> (params, opt_state): this rank's


def _data_place(mesh) -> tuple[int, int]:
    """(flat data position, data ranks) over the pod and data axes."""
    pos, size = 0, 1
    for ax in sharding.DP_AXES:
        if mesh is not None and ax in mesh.axis_names:
            pos = pos * mesh.axis_size(ax) + mesh.index(ax)
            size *= mesh.axis_size(ax)
    return pos, size


def _rows(batch: dict, mesh, pos: int) -> dict:
    size = _data_place(mesh)[1]
    if size == 1:
        return batch
    b = next(iter(batch.values())).shape[0]
    if b % size:
        raise ValueError(f"global batch {b} does not split over {size} data ranks")
    n = b // size
    return {k: v[pos * n:(pos + 1) * n] for k, v in batch.items()}


def step_generator(seed: int, step: int, device, data_index: int = 0) -> torch.Generator:
    """The generator of step ``step``'s OTA noise: a pure function of
    (seed, step, data index), so a resumed run draws what an uninterrupted
    one drew and each data rank draws its own (data index 0 is one rank's)."""
    s = seed * 1_000_003 + step
    if data_index:
        s = s * 1_000_003 + data_index
    return torch.Generator(device=device).manual_seed(s % (2**63))


def data_gather(mesh, placements, gather=collectives.all_gather_dim) -> Callable:
    """(params) -> the parameters whole over the data ranks: each leaf cut
    over them (``embed: data`` in a config's rules) gathered with
    ``gather`` (`collectives.gather_from_group` for training, whose
    backward reduce-scatters the gradient; the plain all-gather for
    inference), the others as they are."""
    cuts = [p.cut_over(sharding.DP_AXES) for p in tree_leaves(placements)]

    def fn(params):
        if mesh is None or not any(cuts):
            return params
        return tree_unflatten(params, [sharding.gather_cut(x, cut, mesh, gather)
                                       for x, cut in zip(tree_leaves(params), cuts)])

    return fn


def build_train_fns(model, opt_cfg: opt_lib.OptConfig, *, mesh=None, microbatch: int = 1,
                    ota_ber: float | None = None, device="cuda") -> TrainFns:
    """The train step and initializers of ``model`` on ``device`` (the card
    unless the caller asks for another; raises without CUDA). The step
    updates the parameters and the optimizer state in place (see
    `train.optimizer`) and returns them with its metrics ({"loss", "ce",
    "aux", "lr"} and "gnorm" for AdamW), all 0-dim tensors on the device.

    With ``mesh`` (a `distributed.mesh.RankMesh` of more than one rank)
    every rank of the mesh builds and calls the step alike: ``init`` gives
    its shards of the parameters and optimizer state (`TrainFns.placements`
    place them), the step takes the global batch and cuts its data rows,
    and the metrics are the global step's on every rank. A rank that holds
    its rows of the batch already (the dry run, `launch.dryrun`) passes
    ``local=True``."""
    dev = resolve(device)
    if opt_cfg.kind not in ("adamw", "sign_majority"):
        raise ValueError(opt_cfg.kind)
    if microbatch < 1:
        raise ValueError(f"microbatch {microbatch} < 1")
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    rules = sharding.merged_rules(model.cfg)
    if opt_cfg.kind == "sign_majority":
        rules = sharding.strip_dp(rules)
    axes, shapes = param_axes(model.specs), param_shapes(model.specs)
    pp = sharding.tree_placements(mesh, shapes, axes, rules)
    zp = sharding.tree_placements(mesh, shapes, sharding.zero1_axes(axes), rules)
    scalar = sharding.placement((), (), mesh, rules)
    opt_plc = ({"m": zp, "v": zp, "step": scalar} if opt_cfg.kind == "adamw"
               else {"mom": zp, "step": scalar})
    dpos, _ = _data_place(mesh)
    dgroups = tuple(mesh.group(a) for a in sharding.DP_AXES
                    if mesh is not None and a in mesh.axis_names)
    tp = None
    if mesh is not None:
        has_model = "model" in mesh.axis_names
        tp = collectives.TensorParallel(mesh.group("model") if has_model else None,
                                        mesh.index("model") if has_model else 0, dgroups)
    # the parameters whole over the data ranks: an all-gather of each leaf
    # cut over them, whose backward reduce-scatters its gradient
    gather_data = data_gather(mesh, pp, collectives.gather_from_group)

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        if tp is None:
            loss, metrics = model.loss_fn(live, batch)
        else:
            loss, metrics = model.loss_fn(gather_data(live), batch, tp=tp)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def accumulate(params, batch):
        if microbatch == 1:
            return value_and_grad(params, batch)
        b = batch["tokens"].shape[0]
        if b % microbatch:
            raise ValueError(f"batch {b} does not split into {microbatch} microbatches")
        n = b // microbatch
        g_acc, l_acc, metrics = None, 0.0, None
        for i in range(microbatch):
            loss, metrics, grads = value_and_grad(
                params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            if g_acc is None:
                g_acc = tree_map(lambda g: g.float() / microbatch, grads)
            else:
                tree_map(lambda a, g: a.add_(g.float() / microbatch), g_acc, grads)
            l_acc = l_acc + loss / microbatch
        return l_acc, metrics, g_acc

    def global_metrics(loss, metrics):
        """The global step's loss and metrics from this data rank's shares
        (the sum of the shares of the global mean)."""
        if not dgroups:
            return loss, metrics
        return (collectives.all_reduce_groups(loss, dgroups),
                {k: collectives.all_reduce_groups(v, dgroups) for k, v in metrics.items()})

    zero1 = opt_lib.Zero1(mesh, pp, zp) if mesh is not None else None
    def rows(batch, local):
        return batch if local else _rows(batch, mesh, dpos)

    if opt_cfg.kind == "adamw":
        def step(params, opt_state, batch, generator=None, *, local=False):
            loss, metrics, grads = accumulate(params, rows(batch, local))
            loss, metrics = global_metrics(loss, metrics)
            params, opt_state, om = opt_lib.adamw_update(opt_cfg, grads, opt_state, params,
                                                         zero1)
            return params, opt_state, {"loss": loss, **metrics, **om}

        opt_init = opt_lib.adamw_init
    else:
        vote_group = dgroups if len(dgroups) > 1 else (dgroups[0] if dgroups else None)

        def step(params, opt_state, batch, generator=None, *, local=False):
            loss, metrics, grads = accumulate(params, rows(batch, local))
            loss, metrics = global_metrics(loss, metrics)
            votes = tree_map(lambda g: collectives.sign_allreduce(
                g, group=vote_group, generator=generator, ber=ota_ber), grads)
            del grads
            params, opt_state, om = opt_lib.sign_update(opt_cfg, votes, opt_state, params)
            return params, opt_state, {"loss": loss, **metrics, **om}

        opt_init = opt_lib.sign_init

    def init(seed: int):
        return shard_params(init_params(model.specs,
                                        torch.Generator(device=dev).manual_seed(seed), dev))

    def shard_params(params):
        """This rank's shards of global parameters, and a fresh optimizer
        state on them (every rank draws the global tree alike, so the
        shards are those of one rank's parameters)."""
        if mesh is None:
            return params, opt_init(opt_cfg, params)
        mine = sharding.shard_tree(params, pp, mesh)
        like = tree_unflatten(params, [torch.empty(z.local_shape(mesh), dtype=x.dtype,
                                                   device="meta")
                                       for x, z in zip(tree_leaves(params), tree_leaves(zp))])
        return mine, opt_init(opt_cfg, like, device=dev)

    def abstract():
        params = abstract_params(model.specs)
        return params, opt_init(opt_cfg, params)

    return TrainFns(step, init, abstract, dev, mesh, (pp, opt_plc), dpos, shard_params)


# ---------------------------------------------------------------------------
# inference on ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InferFns:
    prefill: Callable       # (params, batch, pad_to=None, *, global_batch=None)
    #                         -> (logits [b, V_l], cache)
    decode: Callable        # (params, cache, token [B], pos: int, *, global_batch=None)
    #                         -> (logits [b, V_l], cache)
    init_cache: Callable    # (batch, seq) -> this rank's piece of an empty cache
    cache_placements: Callable   # (batch, seq) -> the cache's tree of sharding.Placement
    rows: Callable          # (tensor [B, ...]) -> this rank's rows of a global batch
    gather_logits: Callable  # (logits [b, V_l]) -> [b, V]: whole over the vocabulary
    shard_params: Callable  # (global params) -> this rank's shards
    device: torch.device
    mesh: object = None
    placements: object = None    # the parameters' tree of sharding.Placement


def build_infer_fns(model, *, mesh=None, device="cuda") -> InferFns:
    """The prefill and the decode of ``model`` on this rank of ``mesh`` (a
    `distributed.mesh.RankMesh`; None or one rank: the model's own
    functions), the counterpart of the reference's GSPMD
    ``jax.jit(prefill_fn / decode_fn, in_shardings=...)``. Every rank of
    the mesh calls them alike, with the global batch (token batch [B, S] and
    its extras, or the decode's tokens [B]; or, with ``global_batch=B``,
    this rank's rows of it, as the dry run passes them) and an int
    position: each takes the rows of its data ranks where B divides them
    (the rules' ``batch`` axis; a B = 1 batch is whole on every data
    rank), its parameter shards (placed by the rules engine, the leaves cut
    over the data ranks gathered whole for the call, without autograd) and
    its piece of the cache, and returns its rows' logits cut over the
    vocabulary (`gather_logits` makes them whole) and its piece of the
    cache (`cache_placements`: the model's ``cache_axes`` through the rules
    engine; `init_cache` allocates an empty one). MoE dispatch groups that
    straddle data ranks are gathered whole over them
    (``TensorParallel.infer``)."""
    dev = resolve(device)
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    rules = sharding.merged_rules(model.cfg)
    pp = sharding.tree_placements(mesh, param_shapes(model.specs), param_axes(model.specs),
                                  rules)
    gather = data_gather(mesh, pp)
    has_model = mesh is not None and "model" in mesh.axis_names
    group = mesh.group("model") if has_model else None

    def rows_of(b: int):
        """(tp, this rank's slice of a global batch of b rows)."""
        if mesh is None:
            return None, slice(None)
        plc = sharding.placement(("batch",), (b,), mesh, rules)
        cut = plc.cut_over(sharding.DP_AXES)
        tp = collectives.TensorParallel(
            group, mesh.index("model") if has_model else 0,
            tuple(mesh.group(a) for a in (cut[1] if cut else ())), plc.index(mesh, 0), True)
        return tp, plc.slices(mesh)[0]

    def prefill(params, batch, pad_to=None, *, global_batch=None):
        b = next(iter(batch.values())).shape[0]
        tp, mine = rows_of(b if global_batch is None else global_batch)
        if global_batch is None:
            batch = {k: v[mine] for k, v in batch.items()}
        return model.prefill_fn(gather(params), batch, pad_to, tp=tp)

    def decode(params, cache, token, pos, *, global_batch=None):
        tp, mine = rows_of(token.shape[0] if global_batch is None else global_batch)
        if global_batch is None:
            token = token[mine]
        return model.decode_fn(gather(params), cache, token, pos, tp=tp)

    def cache_placements(batch: int, seq: int):
        like = model.init_cache_fn(batch, seq, device="meta")
        return sharding.tree_placements(mesh, tree_map(lambda t: tuple(t.shape), like),
                                        model.cache_axes, rules)

    def init_cache(batch: int, seq: int):
        like = model.init_cache_fn(batch, seq, device="meta")
        plc = tree_leaves(cache_placements(batch, seq))
        out = tree_unflatten(like, [torch.zeros(p.local_shape(mesh) if mesh else p.shape,
                                                dtype=t.dtype, device=dev)
                                    for t, p in zip(tree_leaves(like), plc)])
        if "slot_pos" in out:
            out["slot_pos"].fill_(-1)           # every slot empty
        return out

    def gather_logits(logits):
        if group is None or logits.shape[-1] == model.cfg.vocab:
            return logits
        return collectives.all_gather_dim(logits, logits.dim() - 1, group)

    return InferFns(prefill, decode, init_cache, cache_placements,
                    lambda t: t[rows_of(t.shape[0])[1]], gather_logits,
                    lambda params: sharding.shard_tree(params, pp, mesh), dev, mesh, pp)


# ---------------------------------------------------------------------------
# fault-tolerant host runner
# ---------------------------------------------------------------------------

def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep: int = 3
    log_every: int = 10


class Trainer:
    """The host runner: resumes from the latest checkpoint in
    ``tcfg.ckpt_dir`` (the data pipeline skips ahead in O(1)), checkpoints
    every ``ckpt_every`` steps and at the end, and can inject a failure.
    ``step_seconds`` holds each step's host-clock time in the last `run`
    (batch, step and reading the loss back).

    On ranks (``fns`` built on a mesh) every rank runs the loop alike: the
    checkpoint holds the global leaves, gathered over the mesh leaf by leaf
    and written by rank 0 alone, and a restore copies each rank's shards
    out of them, so a run resumes on any mesh. The mesh is the step's (``fns.mesh``)."""

    def __init__(self, fns: TrainFns, pipeline, tcfg: TrainerConfig):
        self.fns = fns
        self.pipeline = pipeline
        self.tcfg = tcfg
        self.step_seconds: list[float] = []

    def run(self, seed: int, fail_at: int | None = None, quiet: bool = False):
        tcfg, fns = self.tcfg, self.fns
        mesh = fns.mesh
        talk = not quiet and (mesh is None or dist.get_rank() == 0)
        start = latest_step(tcfg.ckpt_dir)
        if start is not None:
            (params, opt_state), extra = restore_checkpoint(
                tcfg.ckpt_dir, start, fns.abstract(), device=fns.device,
                placements=fns.placements, mesh=mesh)
            step0 = int(extra["data_step"])
        else:
            params, opt_state = fns.init(seed)
            step0 = 0

        losses, self.step_seconds = [], []
        for step in range(step0, tcfg.steps):
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.pipeline.batch(step)
            params, opt_state, metrics = fns.step(
                params, opt_state, batch,
                step_generator(seed, step, fns.device, fns.data_index))
            losses.append(float(metrics["loss"]))
            self.step_seconds.append(time.perf_counter() - t0)
            if talk and (step % tcfg.log_every == 0 or step == tcfg.steps - 1):
                print(f"step {step:5d}  loss {losses[-1]:.4f}  lr {float(metrics['lr']):.2e}",
                      flush=True)
            if (step + 1) % tcfg.ckpt_every == 0 or step == tcfg.steps - 1:
                save_checkpoint(tcfg.ckpt_dir, step + 1, (params, opt_state),
                                extra={"data_step": step + 1}, keep=tcfg.keep,
                                placements=fns.placements, mesh=mesh)
        return params, opt_state, losses
