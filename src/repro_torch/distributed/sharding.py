"""Logical-axis sharding rules on a rank mesh (counterpart of
`repro/distributed/sharding.py`).

Model code declares each parameter with *logical* axis names (``embed``,
``heads``, ``vocab``, ...; `models.base.param_axes`). A rule table maps
logical axes to mesh axes, and `resolve` turns one leaf's axes and shape
into a partition spec, dropping a mesh axis that the mesh lacks, that the
spec already uses, or that does not divide the dimension (``__uneven__``
lists the logical axes that may shard unevenly; trailing Nones are
trimmed). The table and the engine are the reference's, kept here as the
port's own copy.

Where the reference hands a spec to GSPMD, a rank here holds a `Placement`:
which dimensions are cut over which mesh axes, and this rank's slice of
each. `shard_tree` cuts a global tree into this rank's shards and
`gather_tree` puts the global tree back together (checkpoints, tests). The
reference's activation constraints (``shard(x, ...)``) have no counterpart:
the model's layers call explicit collectives instead
(`distributed.collectives`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

from repro_torch.distributed import collectives
from repro_torch.tree import tree_flatten, tree_unflatten

# logical axis -> mesh axis | tuple of mesh axes | None (replicated)
AxisRules = Mapping[str, Any]

DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",   # dropped automatically when kv_heads % model != 0
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "moe_groups": ("pod", "data"),
    "state": None,
    "inner": "model",
    "conv": None,
    "classes": "model",
    "hv_dim": None,
    "tx": None,
    "fsdp": ("pod", "data"),
}

DP_AXES = ("pod", "data")


def resolve(logical_axes: Sequence[str | None], shape: Sequence[int] | None,
            axis_sizes: Mapping[str, int] | None, rules: AxisRules) -> tuple:
    """The partition spec of one leaf: a tuple with one entry a dimension
    (None, a mesh axis name, or a tuple of them), trailing Nones trimmed;
    the reference's ``_resolve``. ``shape`` or ``axis_sizes`` None skips
    the divisibility (resp. presence) check."""
    uneven_ok = set(rules.get("__uneven__", ()))
    used: set[str] = set()
    out: list = []
    for i, name in enumerate(logical_axes):
        if name is None:
            out.append(None)
            continue
        if name == "__uneven__":
            raise KeyError("__uneven__ is a rules option, not a logical axis")
        if name not in rules:
            raise KeyError(f"unknown logical axis {name!r}")
        mapped = rules[name]
        if mapped is None:
            out.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        keep: list[str] = []
        for ax in axes:
            if axis_sizes is not None and ax not in axis_sizes:
                continue
            if ax in used:
                continue
            size = None if axis_sizes is None else axis_sizes[ax]
            if shape is not None and size is not None:
                cur = math.prod(axis_sizes[k] for k in keep)
                if shape[i] % (cur * size) != 0 and not (name in uneven_ok
                                                         and shape[i] >= cur * size):
                    continue
            keep.append(ax)
            used.add(ax)
        out.append(None if not keep else keep[0] if len(keep) == 1 else tuple(keep))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def merged_rules(cfg) -> dict:
    """DEFAULT_RULES with the config's ``rules_override`` on top."""
    return dict(DEFAULT_RULES) | dict(getattr(cfg, "rules_override", {}) or {})


def strip_dp(rules: Mapping) -> dict:
    """The rules of the sign-majority mode: the pod and data mesh axes
    removed from every rule (parameters, and so gradients, stay whole over
    the data ranks), the batch kept data-parallel and ``fsdp`` None, so
    `zero1_axes` puts no data axis on the momentum."""
    def strip(v):
        if v is None:
            return None
        axes = (v,) if isinstance(v, str) else tuple(v)
        kept = tuple(a for a in axes if a not in DP_AXES)
        return kept[0] if len(kept) == 1 else (kept or None)
    out = {k: strip(v) for k, v in rules.items()}
    out["batch"] = DP_AXES
    out["moe_groups"] = DP_AXES
    out["fsdp"] = None
    return out


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _map_axes(fn, tree):
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a tree of logical axes: {tree!r}")


def zero1_axes(param_axes):
    """Optimizer-state logical axes: the parameter's axes with the first
    replicated dimension of every >= 2-D leaf mapped to ``fsdp`` (the
    reference's; `resolve` drops it where it does not divide, and for the
    stacked [L, ...] leaves the first replicated dimension is the layer
    axis)."""
    def one(axes):
        axes = list(axes)
        for i, a in enumerate(axes):
            if a is None and len(axes) >= 2:
                axes[i] = "fsdp"
                break
        return tuple(axes)

    return _map_axes(one, param_axes)


# ---------------------------------------------------------------------------
# placements on a rank mesh
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `RankMesh` (``{}`` for None, one rank)."""
    return {} if mesh is None else dict(zip(mesh.axis_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Placement:
    """One leaf on a rank mesh: its global ``shape``, its resolved ``spec``,
    and ``cuts``, the (dimension, mesh axes) pairs of the dimensions it is
    cut along (a dimension cut over several axes takes the first as the
    major one, as a NamedSharding does)."""

    shape: tuple[int, ...]
    spec: tuple
    cuts: tuple[tuple[int, tuple[str, ...]], ...]

    def pieces(self, mesh, dim: int) -> int:
        return math.prod(mesh.axis_size(a) for d, axes in self.cuts if d == dim for a in axes)

    def index(self, mesh, dim: int) -> int:
        """This rank's piece of dimension ``dim``."""
        i = 0
        for d, axes in self.cuts:
            if d == dim:
                for a in axes:
                    i = i * mesh.axis_size(a) + mesh.index(a)
        return i

    def local_shape(self, mesh) -> tuple[int, ...]:
        return tuple(n // (self.pieces(mesh, i) if mesh is not None else 1)
                     for i, n in enumerate(self.shape))

    def axes(self) -> set[str]:
        return {a for _, axes in self.cuts for a in axes}

    def cut_over(self, names) -> tuple[int, tuple[str, ...]] | None:
        """(dimension, axes) of the cut that uses a mesh axis of ``names``
        (the data axes), or None."""
        for d, axes in self.cuts:
            if any(a in names for a in axes):
                return d, axes
        return None

    def owns(self, mesh) -> bool:
        """Whether this rank holds the first copy of its piece: coordinate
        0 on every mesh axis the leaf is not cut over (every piece counted
        once when each owner adds its own)."""
        used = self.axes()
        return mesh is None or all(mesh.index(a) == 0 for a in mesh.axis_names
                                   if a not in used)

    def slices(self, mesh) -> tuple[slice, ...]:
        """This rank's piece of the global leaf as a tuple of slices (for a
        tensor or a mapped array)."""
        out = [slice(None)] * len(self.shape)
        for d, _ in self.cuts:
            n = self.shape[d] // self.pieces(mesh, d)
            out[d] = slice(self.index(mesh, d) * n, (self.index(mesh, d) + 1) * n)
        return tuple(out)

    def shard(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's piece of the global ``x`` (a view)."""
        return x[self.slices(mesh)]

    def gather(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """The global leaf from this rank's piece: an all-gather over every
        cut (every rank of the mesh must call it)."""
        for cut in self.cuts:
            x = gather_cut(x, cut, mesh)
        return x


def gather_cut(x: torch.Tensor, cut, mesh, gather=collectives.all_gather_dim) -> torch.Tensor:
    """All-gather one cut (dimension, mesh axes) of ``x`` back to the whole
    dimension, the inner axis first; ``cut`` None returns ``x``. ``gather``
    is the collective (``collectives.gather_from_group`` to reduce-scatter
    the gradient in the backward)."""
    if cut is None:
        return x
    d, axes = cut
    for a in reversed(axes):
        x = gather(x, d, mesh.group(a))
    return x


def placement(logical_axes, shape, mesh, rules: AxisRules) -> Placement:
    """The `Placement` of one leaf on ``mesh`` (None: one rank, no cuts)."""
    spec = resolve(logical_axes, shape, axis_sizes(mesh) if mesh is not None else None,
                   rules) if mesh is not None else ()
    cuts = tuple((i, (e,) if isinstance(e, str) else tuple(e))
                 for i, e in enumerate(spec) if e is not None)
    return Placement(tuple(shape), spec, cuts)


def tree_placements(mesh, shapes, axes, rules: AxisRules) -> dict:
    """A `Placement` for every leaf of ``shapes`` (a tree of shape tuples)
    with the logical axes of the matching leaf of ``axes``."""
    def walk(s, a):
        if isinstance(s, dict):
            return {k: walk(s[k], a[k]) for k in s}
        return placement(a, s, mesh, rules)
    return walk(shapes, axes)


def _pairs(tree: Any, placements: Any) -> list:
    leaves = [leaf for _, leaf in tree_flatten(tree)]
    plc = [p for _, p in tree_flatten(placements)]
    if len(leaves) != len(plc):
        raise ValueError(f"{len(leaves)} leaves against {len(plc)} placements")
    return list(zip(leaves, plc))


def shard_tree(tree: Any, placements: Any, mesh) -> Any:
    """This rank's shards of a global tree: a leaf cut over the mesh as a
    copy of its own (a view would keep the whole leaf's storage alive,
    contiguous or not), a whole leaf as it is; the leaves themselves on one
    rank."""
    if mesh is None:
        return tree

    def own(x, p):
        y = p.shard(x, mesh)
        return y.clone(memory_format=torch.contiguous_format) if p.cuts else y.contiguous()

    return tree_unflatten(tree, [own(x, p) for x, p in _pairs(tree, placements)])


def gather_tree(tree: Any, placements: Any, mesh) -> Any:
    """The global tree from every rank's shards (collective over the whole
    mesh; the tree itself on one rank)."""
    if mesh is None:
        return tree
    return tree_unflatten(tree, [p.gather(x, mesh) for x, p in _pairs(tree, placements)])


def local_bytes(placements: Any, dtypes: Any, mesh) -> int:
    """The bytes of this rank's shards of a tree: its placements' local
    shapes at the matching leaves' dtypes (``dtypes`` a tree of tensors or
    dtypes)."""
    total = 0
    for x, p in _pairs(dtypes, placements):
        dt = x if isinstance(x, torch.dtype) else x.dtype
        total += math.prod(p.local_shape(mesh)) * torch.empty((), dtype=dt).element_size()
    return total

