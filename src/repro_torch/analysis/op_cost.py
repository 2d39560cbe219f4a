"""What one traced call costs, counted on fake tensors (the counterpart of
`repro/analysis/hlo_cost.py`; there is no HLO in the port, so the name does
not pretend otherwise).

The reference lowers and compiles a cell and reads the optimized HLO: the
FLOPs of its dots, the bytes its top-level ops move, its collectives'
bytes, and ``compiled.memory_analysis()``. The port traces one call of the
cell's step under ``FakeTensorMode`` (no memory is allocated and no kernel
runs) inside `OpCost`, a ``TorchDispatchMode`` that sees every aten op the
call dispatches, and counts:

* **FLOPs** by ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
  baddbmm, convolutions, and so the einsums, which reach the dispatcher as
  those), by the dtype of the product ("bf16", "f32", or "other"), plus the
  operations each of the port's kernels records through its ``cost()``
  (`kernels.common.fake_launch`). A Python loop of layers dispatches its
  ops once an iteration, so there is no trip count to recover.
* **Device-memory bytes**, as operand plus result bytes of each aten op:
  eager does not fuse, so this is what eager moves. Views move nothing; an
  allocation (``empty*``) moves nothing; a fill writes its result once; a
  copy reads its source and writes its destination; a gather
  (``index_select``, ``gather``, ``embedding``, ``index``) counts 2 x its
  result and an ``index_put_`` / ``scatter`` / ``index_add_`` 2 x its
  update, as `hlo_cost.py:355-385` counts them; an operand counts at most
  its storage's bytes (a broadcast view reads its storage once). A kernel's
  fake branch counts its ``cost()`` bytes and not the aten ops that make its
  outputs.
* **Live bytes**: every storage the trace creates is followed until it is
  freed (the same Python references that free it in eager free it here), on
  top of the arguments registered with `track`. The peak of the live total,
  and the bytes of each category at that peak: the arguments' own
  categories (parameters, optimizer state, batch, state, ...) and the
  temporaries by when they were made ("forward" before the first backward
  op, "backward" inside the autograd engine, "update" after it).
* **Wire bytes**, by collective type and by mesh axis, from the
  collectives' own counter (`distributed.collectives.wire_bytes_by_op`,
  ``_by_axis``), read over the traced call.

The caching allocator rounds each block up to 512 bytes and may hold freed
blocks; `OpCost` counts the bytes the tensors hold.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.distributed import collectives
from repro_torch.kernels import common

_aten = torch.ops.aten
_ALLOC = {_aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default,
          _aten.new_empty.default, _aten.new_empty_strided.default}
_ALIAS = {_aten.detach.default, _aten.alias.default, _aten._unsafe_view.default,
          _aten.lift_fresh.default}
_GATHER = {"index_select", "gather", "embedding", "index"}
_SCATTER = {"index_put_", "index_put", "_index_put_impl_", "scatter", "scatter_",
            "scatter_add", "scatter_add_", "index_add", "index_add_", "scatter_reduce",
            "scatter_reduce_"}
_FILL = {"fill_", "zero_", "fill", "zeros", "zeros_like", "ones", "ones_like", "full",
         "full_like", "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):     # a tensor without storage
        return n


def _kind(dtype: torch.dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "f32"}.get(dtype, "other")


class OpCost(TorchDispatchMode):
    """Counts what the calls inside the block dispatch (see the module's
    docstring). Enter it inside a ``FakeTensorMode``; `track` the arguments
    first. Read `flops`, `ops_by_kind`, `hbm_bytes`, `kernels`, `peak_bytes`,
    `peak_categories`, `wire_by_op` and `wire_by_axis` after the block."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops_by_kind: dict[str, float] = collections.defaultdict(float)
        self.kernel_ops: dict[str, float] = collections.defaultdict(float)
        self.hbm_bytes = 0
        self.bytes_by_op: dict[str, int] = collections.defaultdict(int)
        self.calls_by_op: dict[str, int] = collections.defaultdict(int)
        self.kernels: dict[str, dict] = {}
        self._kernel_depth = 0
        # live memory
        self._seen = WeakIdKeyDictionary()
        self._live: dict[str, int] = collections.defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_categories: dict[str, int] = {}
        self.arg_categories: set[str] = set()
        self._backward_seen = False
        self.wire_by_op: dict[str, int] = {}
        self.wire_by_axis: dict[str, int] = {}
        self._recording = None

    # -- the block --------------------------------------------------------
    def __enter__(self):
        collectives.reset_wire_bytes()
        self._recording = common.recording(self)
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._recording.__exit__(*exc)
        self.wire_by_op = collectives.wire_bytes_by_op()
        self.wire_by_axis = collectives.wire_bytes_by_axis()
        return out

    # -- the kernels' fake branch (kernels.common.fake_launch) -------------
    def kernel(self, name: str, nbytes: int, ops: int, kind: str) -> None:
        self._kernel_depth += 1
        if self._kernel_depth > 1:          # a wrapper calling another: counted once
            return
        k = self.kernels.setdefault(name, dict(launches=0, bytes=0, ops=0, kind=kind))
        k["launches"] += 1
        k["bytes"] += nbytes
        k["ops"] += ops
        self.hbm_bytes += nbytes
        self.kernel_ops[kind] += ops

    def kernel_done(self) -> None:
        self._kernel_depth -= 1

    # -- live memory ------------------------------------------------------
    def track(self, tree, category: str) -> int:
        """Register the tensors of ``tree`` as arguments of ``category``
        (those already followed keep theirs); returns their new bytes."""
        self.arg_categories.add(category)
        before = self.live_bytes
        for t in _tensors(tree):
            self._follow(t, category)
        self._peak()
        return self.live_bytes - before

    def _follow(self, t: torch.Tensor, category: str) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        nb = st.nbytes()
        self._seen[st] = category
        self._live[category] += nb
        self.live_bytes += nb
        weakref.finalize(st, self._free, category, nb)

    def _free(self, category: str, nb: int) -> None:
        self._live[category] -= nb
        self.live_bytes -= nb

    def _peak(self) -> None:
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_categories = {k: v for k, v in self._live.items() if v}

    def _temporary(self) -> str:
        if torch._C._current_graph_task_id() != -1:
            self._backward_seen = True
            return "backward"
        return "update" if self._backward_seen else "forward"

    # -- aten ops ---------------------------------------------------------
    def _bytes(self, func, args, kwargs, out) -> int:
        name = func._overloadpacket.__name__
        if func in _ALLOC or func in _ALIAS or func.is_view:
            return 0
        outs = _tensors(out)
        if name in _GATHER:
            return 2 * sum(_nbytes(t) for t in outs)
        if name in _SCATTER:
            upd = kwargs.get("values", kwargs.get("src", kwargs.get("source")))
            if upd is None:
                rest = [a for a in args[1:] if isinstance(a, torch.Tensor)]
                upd = rest[-1] if rest else None
            return 2 * (_nbytes(upd) if isinstance(upd, torch.Tensor) else 0)
        if name in _FILL:
            return sum(_nbytes(t) for t in outs)
        if name == "copy_":
            return _nbytes(args[0]) + _nbytes(args[1])
        return sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._kernel_depth == 0 and func.namespace == "aten":
            packet = func._overloadpacket
            name = packet.__name__
            self.calls_by_op[name] += 1
            if packet in self._flop_registry:
                first = next(iter(_tensors(args)), None)
                # the products' out_dtype overloads (cuBLAS's f32 out of bf16,
                # `moe._bmm_acc`) pass the dtype where the formulas take shapes
                fargs = tuple(a for a in args if not isinstance(a, torch.dtype))
                fkw = {k: v for k, v in kwargs.items() if k != "out_dtype"}
                f = self._flop_registry[packet](*fargs, **fkw, out_val=out)
                self.flops_by_kind[_kind(first.dtype) if first is not None else "other"] += f
            nb = self._bytes(func, args, kwargs, out)
            self.hbm_bytes += nb
            self.bytes_by_op[name] += nb
        cat = self._temporary()
        for t in _tensors(out):
            self._follow(t, cat)
        self._peak()
        return out

    # -- totals -----------------------------------------------------------
    @property
    def flops(self) -> float:
        """Every operation counted: the aten products' FLOPs and the
        kernels' operations."""
        return sum(self.flops_by_kind.values()) + sum(self.kernel_ops.values())

    @property
    def ops_by_kind(self) -> dict[str, float]:
        out = collections.defaultdict(float)
        for src in (self.flops_by_kind, self.kernel_ops):
            for k, v in src.items():
                out[k] += v
        return dict(out)

    @property
    def wire_bytes(self) -> int:
        return sum(self.wire_by_op.values())

    def memory(self) -> dict:
        """The live-bytes summary: the arguments' bytes at the peak, the
        temporaries' and the total, and every category at the peak."""
        args = sum(v for k, v in self.peak_categories.items() if k in self.arg_categories)
        return dict(peak_bytes=self.peak_bytes, arguments_at_peak=args,
                    temporaries_at_peak=self.peak_bytes - args,
                    categories_at_peak=dict(self.peak_categories))

    def top_ops(self, n: int = 12) -> list:
        """The ``n`` aten ops that moved the most bytes: (name, calls, bytes)."""
        top = sorted(self.bytes_by_op.items(), key=lambda kv: -kv[1])[:n]
        return [(k, self.calls_by_op[k], v) for k, v in top]
