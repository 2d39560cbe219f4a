"""Optimizers (counterpart of `repro/train/optimizer.py`): AdamW with a
configurable state dtype, and majority-vote signSGD, the paper's OTA
bundling applied to gradients.

`sign_update` consumes gradients that were already majority-voted by
`distributed.collectives.sign_allreduce` (values in {-1, 0, +1}) and applies
momentum + sign (signum). The arithmetic is the reference's, in f32: global
norm clipping, bias correction and decoupled weight decay for AdamW.

Unlike the reference's pure functions, the updates work in place: they
write the new parameters into the ``params`` tensors and the new moments
into the state's tensors, and return the same tree objects, so a step holds
no second copy of the parameters or of the optimizer state (at
TinyLlama-1.1B's width that is 2.2 GB of bf16 parameters and 8.8 GB of f32
moments). ZeRO-1's ``zero1_axes`` shards state over data ranks and waits for
the multi-rank slice, with ``distributed/sharding.py`` (ROADMAP §1 item 1).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | sign_majority
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    state_dtype: torch.dtype = torch.float32
    momentum: float = 0.9           # sign_majority
    grad_clip: float = 1.0


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to 0.1 ``lr`` at
    ``total_steps``; f32, on the step's device (``step`` an int or an int
    tensor)."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(cfg: OptConfig, params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=_device(params))}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state: dict, params):
    """One AdamW step, in place: returns (params, state, {"lr", "gnorm"})
    with the parameters and moments written into the given tensors and
    ``state["step"]`` a new tensor. Gradients (any float dtype) are clipped
    to ``grad_clip`` global norm in f32."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
                          tree_leaves(params)):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, dict(state, step=step), {"lr": lr, "gnorm": gnorm}


# ---------------------------------------------------------------------------
# majority-vote signSGD (signum)
# ---------------------------------------------------------------------------

def sign_init(cfg: OptConfig, params) -> dict:
    return {"mom": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                                  device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=_device(params))}


@torch.no_grad()
def sign_update(cfg: OptConfig, votes, state: dict, params):
    """votes: majority-voted gradient signs in {-1, 0, +1} (after
    `sign_allreduce`). One signum step, in place as `adamw_update`: returns
    (params, state, {"lr"})."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    for g, m, p in zip(tree_leaves(votes), tree_leaves(state["mom"]), tree_leaves(params)):
        m32 = cfg.momentum * m.float() + (1 - cfg.momentum) * g.float()
        delta = torch.sign(m32) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
    return params, dict(state, step=step), {"lr": lr}
