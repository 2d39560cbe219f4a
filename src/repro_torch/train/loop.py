"""Single-GPU training (counterpart of `repro/train/loop.py`): the train
step and the fault-tolerant host runner.

Two gradient modes, as in the reference:

* "adamw"          -- autograd over the model's loss (the attention's
                      gradient through the hand-written backward kernel),
                      then AdamW.
* "sign_majority"  -- the paper's OTA collective applied to training: the
                      gradients' signs majority-voted by `sign_allreduce`,
                      optionally through the OTA BER channel, then signum.

Microbatches accumulate f32 gradients divided by ``microbatch``, the loss is
their mean and the metrics are the last microbatch's, as the reference's
lax.scan gives them. One GPU is one data rank: no mesh and no shardings (the
multi-rank slice brings them back, ROADMAP §1 item 1).

The `Trainer` adds checkpoint/restart (atomic keep-k), O(1) data skip-ahead
on resume and a failure-injection hook.

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

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.device import resolve
from repro_torch.distributed import collectives
from repro_torch.distributed.mesh import one_rank
from repro_torch.models.base import abstract_params, init_params
from repro_torch.train import optimizer as opt_lib
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainFns:
    step: Callable          # (params, opt_state, batch, generator) -> (params, opt_state, metrics)
    init: Callable          # (seed) -> (params, opt_state)
    abstract: Callable      # () -> (params, opt_state) as meta tensors: the structure
    device: torch.device


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s OTA noise: a pure function of
    (seed, step), so a resumed run draws what an uninterrupted one drew."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + step) % (2**63))


def build_train_fns(model, opt_cfg: opt_lib.OptConfig, *, microbatch: int = 1,
                    ota_ber: float | None = None, device="cuda") -> TrainFns:
    """The train step and initializers of ``model`` on ``device`` (the card
    unless the caller asks for another; raises without CUDA). The step
    updates the parameters and the optimizer state in place (see
    `train.optimizer`) and returns them with its metrics ({"loss", "ce",
    "aux", "lr"} and "gnorm" for AdamW), all 0-dim tensors on the device."""
    dev = resolve(device)
    if opt_cfg.kind not in ("adamw", "sign_majority"):
        raise ValueError(opt_cfg.kind)
    if microbatch < 1:
        raise ValueError(f"microbatch {microbatch} < 1")

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss_fn(live, batch)
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

    if opt_cfg.kind == "adamw":
        def step(params, opt_state, batch, generator=None):
            loss, metrics, grads = accumulate(params, batch)
            params, opt_state, om = opt_lib.adamw_update(opt_cfg, grads, opt_state, params)
            return params, opt_state, {"loss": loss, **metrics, **om}

        opt_init = opt_lib.adamw_init
    else:
        def step(params, opt_state, batch, generator=None):
            loss, metrics, grads = accumulate(params, batch)
            votes = tree_map(lambda g: collectives.sign_allreduce(
                g, generator=generator, ber=ota_ber), grads)
            del grads
            params, opt_state, om = opt_lib.sign_update(opt_cfg, votes, opt_state, params)
            return params, opt_state, {"loss": loss, **metrics, **om}

        opt_init = opt_lib.sign_init

    def init(seed: int):
        params = init_params(model.specs, torch.Generator(device=dev).manual_seed(seed), dev)
        return params, opt_init(opt_cfg, params)

    def abstract():
        params = abstract_params(model.specs)
        return params, opt_init(opt_cfg, params)

    return TrainFns(step, init, abstract, dev)


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
    """Single-process runner: resumes from the latest checkpoint in
    ``tcfg.ckpt_dir`` (the data pipeline skips ahead in O(1)), checkpoints
    every ``ckpt_every`` steps and at the end, and can inject a failure.
    ``step_seconds`` holds each step's host-clock time in the last `run`
    (batch, step and reading the loss back)."""

    def __init__(self, fns: TrainFns, pipeline, tcfg: TrainerConfig):
        one_rank("Trainer")
        self.fns = fns
        self.pipeline = pipeline
        self.tcfg = tcfg
        self.step_seconds: list[float] = []

    def run(self, seed: int, fail_at: int | None = None, quiet: bool = False):
        tcfg = self.tcfg
        start = latest_step(tcfg.ckpt_dir)
        if start is not None:
            (params, opt_state), extra = restore_checkpoint(
                tcfg.ckpt_dir, start, self.fns.abstract(), device=self.fns.device)
            step0 = int(extra["data_step"])
        else:
            params, opt_state = self.fns.init(seed)
            step0 = 0

        losses, self.step_seconds = [], []
        for step in range(step0, tcfg.steps):
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.pipeline.batch(step)
            params, opt_state, metrics = self.fns.step(
                params, opt_state, batch, step_generator(seed, step, self.fns.device))
            losses.append(float(metrics["loss"]))
            self.step_seconds.append(time.perf_counter() - t0)
            if not quiet and (step % tcfg.log_every == 0 or step == tcfg.steps - 1):
                print(f"step {step:5d}  loss {losses[-1]:.4f}  lr {float(metrics['lr']):.2e}",
                      flush=True)
            if (step + 1) % tcfg.ckpt_every == 0 or step == tcfg.steps - 1:
                save_checkpoint(tcfg.ckpt_dir, step + 1, (params, opt_state),
                                extra={"data_step": step + 1}, keep=tcfg.keep)
        return params, opt_state, losses
