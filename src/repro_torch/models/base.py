"""Spec-first parameters (counterpart of `repro/models/base.py`).

A model declares its parameters as a nested dict of `ParamSpec`s;
`init_params` draws the same tree of tensors and `param_axes` gives each
leaf's logical sharding axes (one name or None a dimension, the
reference's), which `distributed.sharding` resolves to a placement on a
rank mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names, len == len(shape)
    init: str = "normal"                  # normal | zeros | ones | fan_in
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec: shape {self.shape} and axes {self.axes} differ "
                             "in length")


def _leaves(specs: Any, prefix: tuple = ()):
    """(key path, spec) pairs in sorted key order, as `jax.tree.flatten`
    orders a dict."""
    if isinstance(specs, ParamSpec):
        yield prefix, specs
        return
    for k in sorted(specs):
        yield from _leaves(specs[k], prefix + (k,))


# A leaf whose f32 draw would take more bytes than this is drawn slice by
# slice along its leading axes (see `_init_one`).
DRAW_BYTES = 2 << 30


def _init_one(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    """One leaf: zeros, ones, or normals drawn in f32, scaled, then cast.

    A leaf whose f32 draw would pass `DRAW_BYTES` (Mixtral-8x22B's stacked
    expert weights are 38.7 GB in f32 at 12 layers) is drawn into a
    preallocated leaf of its own dtype, a run of its leading slices at a
    time: only one run, at most `DRAW_BYTES`, is f32 at once. Its bits are
    not a one-shot draw's; every smaller leaf is the one-shot draw, bit for
    bit."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        s = spec.scale
    elif spec.init == "fan_in":
        s = 1.0 / math.sqrt(spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
    else:
        raise ValueError(spec.init)
    shape = tuple(spec.shape)
    if math.prod(shape) * 4 <= DRAW_BYTES:
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x.mul_(s)).to(spec.dtype)     # drawn in f32, then cast
    # the fewest leading axes whose slices fit, then as many slices a draw as fit
    lead = next(j for j in range(1, len(shape) + 1)
                if math.prod(shape[j:]) * 4 <= DRAW_BYTES)
    rest = shape[lead:]
    out = torch.empty(shape, dtype=spec.dtype, device=device)
    rows = out.view((math.prod(shape[:lead]),) + rest)
    step = max(1, DRAW_BYTES // (math.prod(rest) * 4))
    for r0 in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - r0)
        x = torch.randn((n,) + rest, generator=generator, device=device, dtype=torch.float32)
        rows[r0:r0 + n] = x.mul_(s)           # cast into the leaf
    return out


def init_params(specs: Any, generator: torch.Generator, device=None) -> dict:
    """Draw every leaf of `specs` from `generator` (f32 normals, scaled, then
    cast to the leaf's dtype), leaf by leaf in sorted key order; `device`
    defaults to the generator's."""
    device = generator.device if device is None else torch.device(device)
    out: dict = {}
    for path, spec in _leaves(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _init_one(spec, generator, device)
    return out


def abstract_params(specs: Any) -> dict:
    """The tree `init_params` draws, as meta tensors: shapes and dtypes
    without storage (the structure a checkpoint restores into)."""
    return _tree_of(specs, lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"))


def _tree_of(specs: Any, fn) -> dict:
    out: dict = {}
    for path, spec in _leaves(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn(spec)
    return out


def param_axes(specs: Any) -> dict:
    """Each leaf's logical axes tuple, in the tree of `specs`."""
    return _tree_of(specs, lambda s: s.axes)


def param_shapes(specs: Any) -> dict:
    """Each leaf's shape tuple, in the tree of `specs`."""
    return _tree_of(specs, lambda s: tuple(s.shape))


def count_params(specs: Any) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(specs))
