"""Spec-first parameters (counterpart of `repro/models/base.py`).

A model declares its parameters as a nested dict of `ParamSpec`s;
`init_params` draws the same tree of tensors. The JAX spec's logical
sharding axes are not carried: nothing on one GPU reads them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"                  # normal | zeros | ones | fan_in
    scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16


def _leaves(specs: Any, prefix: tuple = ()):
    """(key path, spec) pairs in sorted key order, as `jax.tree.flatten`
    orders a dict."""
    if isinstance(specs, ParamSpec):
        yield prefix, specs
        return
    for k in sorted(specs):
        yield from _leaves(specs[k], prefix + (k,))


def _init_one(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
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
    x = torch.randn(spec.shape, generator=generator, device=device, dtype=torch.float32)
    return (x.mul_(s)).to(spec.dtype)     # drawn in f32, then cast


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
    out: dict = {}
    for path, spec in _leaves(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(spec.shape, dtype=spec.dtype, device="meta")
    return out


def count_params(specs: Any) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(specs))
