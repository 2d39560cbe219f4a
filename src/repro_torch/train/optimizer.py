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
moments). A large leaf is updated in slices along its first dimension
(`ADAM_CHUNK` elements at a time; the update is elementwise, so the bits
are the same), which bounds the f32 temporaries of the update: whole, the
stacked [14, 3584, 18944] MLP leaves of Qwen2-VL-7B at 14 layers take
3.5 GiB a temporary and put the step past 80 GB.

On a rank mesh (`Zero1`) AdamW is ZeRO-1: each rank holds its piece of m and
v as `distributed.sharding.zero1_axes` places them, takes the matching
piece of the gradient reduced over the data ranks (a reduce-scatter, or the
piece of what the parameter's own all-gather backward reduce-scattered),
updates that piece of the parameter and all-gathers it over the data ranks
into its parameter shard. Over a data axis that a parameter and its
moments cut alike nothing is gathered or narrowed: the piece is already
the other's block there. The clipping norm counts every element once
across the model group and the data pieces, so it is one rank's norm.
Signum's momentum sits where the parameter does (`strip_dp`: no data
axis) and its update is local.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import DP_AXES, Placement, gather_cut
from repro_torch.tree import tree_leaves, tree_map

ADAM_CHUNK = 1 << 26      # elements of a leaf one AdamW slice updates at once


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

def adamw_init(cfg: OptConfig, params, device=None) -> dict:
    """Zero moments shaped as ``params`` (on ``device``, default the
    parameters')."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=device or p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device or _device(params))}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


@dataclasses.dataclass(frozen=True)
class Zero1:
    """Where AdamW's pieces sit on a rank mesh: the parameters'
    placements ``params`` and the moments' ``state`` (trees of
    `Placement`s, as the parameters)."""

    mesh: object
    params: object
    state: object


def _data_groups(mesh, axes) -> list:
    return [mesh.group(a) for a in axes]


def _dp_cuts(pl: Placement) -> list:
    """The cuts of ``pl`` over data axes, [(dimension, axes)] in its order
    (on a pod mesh a leaf may have two: ``fsdp`` on the layer axis over
    ``pod`` alone where the layers do not divide pod x data, and ``embed``
    over ``data``)."""
    return [(d, axes) for d, axes in pl.cuts if any(a in DP_AXES for a in axes)]


def _shared(src: Placement, dst: Placement) -> dict:
    """{dimension: the leading data axes its cut in ``src`` and in ``dst``
    share}: over those a piece placed by one is already the other's block
    (a dimension's cut nests its axes major first)."""
    cuts = dict(_dp_cuts(dst))
    out = {}
    for d, axes in _dp_cuts(src):
        k = 0
        while k < min(len(axes), len(cuts.get(d, ()))) and axes[k] == cuts[d][k]:
            k += 1
        out[d] = axes[:k]
    return out


def _gather_unshared(x: torch.Tensor, src: Placement, dst: Placement, mesh) -> torch.Tensor:
    """``x`` (a piece placed by ``src``) gathered over the data axes of
    ``src``'s cuts that ``dst`` does not share."""
    kept = _shared(src, dst)
    for d, axes in reversed(_dp_cuts(src)):
        x = gather_cut(x, (d, axes[len(kept[d]):]), mesh)
    return x


def _unshared_cuts(src: Placement, dst: Placement) -> list:
    """[(dimension, axis)]: ``dst``'s data cuts beyond what ``src`` shares,
    major axis first."""
    kept = _shared(src, dst)
    return [(d, a) for d, axes in _dp_cuts(dst) for a in axes[len(kept.get(d, ())):]]


def _narrow(x: torch.Tensor, d: int, a: str, mesh) -> torch.Tensor:
    n = x.shape[d] // mesh.axis_size(a)
    return x.narrow(d, mesh.index(a) * n, n)


def _move(x: torch.Tensor, src: Placement, dst: Placement, mesh) -> torch.Tensor:
    """``x`` (a piece placed by ``src`` over the data axes) as ``dst``
    places it: gathered over the data axes the two do not share, then
    narrowed to this rank's block of ``dst``'s."""
    x = _gather_unshared(x, src, dst, mesh)
    for d, a in _unshared_cuts(src, dst):
        x = _narrow(x, d, a, mesh)
    return x


def _zero1_grad(g: torch.Tensor, pp: Placement, zp: Placement, mesh) -> torch.Tensor:
    """The gradient's piece of the moments' placement, summed over the data
    ranks. A parameter cut over data axes has its gradient summed over those
    already (its all-gather's backward); it is gathered over those the
    moments do not cut alike. Then, along each data cut of the moments
    beyond the shared axes, major axis first, an axis not yet summed is
    reduce-scattered and a summed one narrowed to this rank's block; the
    data axes left are all-reduced."""
    done = {a for _, axes in _dp_cuts(pp) for a in axes}
    g = _gather_unshared(g, pp, zp, mesh)
    for d, a in _unshared_cuts(pp, zp):
        if a in done:
            g = _narrow(g, d, a, mesh)
        else:
            g = collectives.reduce_scatter_dim(g, d, mesh.group(a))
            done.add(a)
    return collectives.all_reduce_groups(
        g, _data_groups(mesh, [a for a in DP_AXES if a in mesh.axis_names and a not in done]))


def _zero1_norm(pieces: list, zps: list, mesh) -> torch.Tensor:
    """sqrt of the sum of squares of the global gradient: each rank adds the
    pieces it owns (`Placement.owns`), then one sum over every mesh axis."""
    own = [torch.sum(torch.square(g.float())) for g, zp in zip(pieces, zps) if zp.owns(mesh)]
    dev = pieces[0].device
    tot = sum(own) if own else torch.zeros((), dtype=torch.float32, device=dev)
    return torch.sqrt(collectives.all_reduce_groups(tot, _data_groups(mesh, mesh.axis_names)))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state: dict, params, zero1: Zero1 | None = None):
    """One AdamW step, in place: returns (params, state, {"lr", "gnorm"})
    with the parameters and moments written into the given tensors and
    ``state["step"]`` a new tensor. Gradients (any float dtype) are clipped
    to ``grad_clip`` global norm in f32. With ``zero1`` the gradients are
    this rank's unreduced shards and the moments its ZeRO-1 pieces (see the
    module's docstring)."""
    if zero1 is not None:
        return _adamw_zero1(cfg, grads, state, params, zero1)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc = _bias_corrections(cfg, step)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
                          tree_leaves(params)):
        _adam_slices(cfg, g, m, v, p, p, scale, lr, bc)
    return params, dict(state, step=step), {"lr": lr, "gnorm": gnorm}


def _bias_corrections(cfg: OptConfig, step) -> tuple[torch.Tensor, torch.Tensor]:
    return 1 - torch.pow(cfg.b1, step.float()), 1 - torch.pow(cfg.b2, step.float())


def _adam_leaf(cfg: OptConfig, g, m, v, p, scale, lr, bc) -> torch.Tensor:
    """One leaf's AdamW update in f32 (``bc`` the step's bias corrections):
    writes the new moments into ``m`` and ``v`` and returns the new
    parameter (f32)."""
    bc1, bc2 = bc
    g = g.float() * scale
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
    delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) + cfg.weight_decay * p.float()
    m.copy_(m32)
    v.copy_(v32)
    return p.float() - lr * delta


def _adam_slices(cfg: OptConfig, g, m, v, p, out, scale, lr, bc) -> None:
    """`_adam_leaf` on slices of at most `ADAM_CHUNK` elements along the
    leaf's first dimension, each new parameter slice written into ``out``
    (``p`` itself, or a tensor of its shape)."""
    rows = max(1, ADAM_CHUNK // max(1, p[0].numel())) if p.dim() else 1
    for i in range(0, p.shape[0] if p.dim() else 1, rows):
        s = slice(i, i + rows) if p.dim() else ...
        out[s].copy_(_adam_leaf(cfg, g[s], m[s], v[s], p[s], scale, lr, bc))


def _adamw_zero1(cfg: OptConfig, grads, state: dict, params, zero1: Zero1):
    mesh = zero1.mesh
    pps, zps = tree_leaves(zero1.params), tree_leaves(zero1.state)
    ps = tree_leaves(params)
    gs = [_zero1_grad(g, pp, zp, mesh) for g, pp, zp in zip(tree_leaves(grads), pps, zps)]
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = _zero1_norm(gs, zps, mesh)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc = _bias_corrections(cfg, step)
    for g, m, v, p, pp, zp in zip(gs, tree_leaves(state["m"]), tree_leaves(state["v"]), ps,
                                  pps, zps):
        if _dp_cuts(pp) == _dp_cuts(zp):
            _adam_slices(cfg, g, m, v, p, p, scale, lr, bc)
            continue
        pz = _move(p, pp, zp, mesh)
        new = torch.empty(pz.shape, dtype=p.dtype, device=pz.device)
        _adam_slices(cfg, g, m, v, pz, new, scale, lr, bc)
        # the updated piece back into the parameter shard (where the two
        # placements agree the update wrote ``p`` in place above)
        p.copy_(_move(new, zp, pp, mesh))
    return params, dict(state, step=step), {"lr": lr, "gnorm": gnorm}


# ---------------------------------------------------------------------------
# majority-vote signSGD (signum)
# ---------------------------------------------------------------------------

def sign_init(cfg: OptConfig, params, device=None) -> dict:
    return {"mom": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                                  device=device or p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=device or _device(params))}


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
