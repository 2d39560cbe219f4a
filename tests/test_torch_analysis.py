"""repro_torch.analysis against the reference's repro.analysis, and the
kernels' fake branch and ``cost()``.

* `roofline.active_params` and `model_flops` equal the reference's on every
  architecture and cell at the reference's `count_params`; `roofline_terms`
  and `dominant` on hand values (tests/test_analysis.py's counterparts).
* `op_cost.OpCost` on fake tensors: one matmul (FLOPs and bytes), a loop
  and a nested loop of matmuls (FLOPs) equal `hlo_cost.analyze` of the JAX
  twin (tests/test_analysis.py:10, :43, :58).
* Each family's ``cost()`` at PERF.md §6's table shapes gives that row's
  bound at the H100's peaks, to 4 significant figures.
* Every wrapper given fake tensors returns its kernel's output shapes and
  dtypes (those of its plain version on the same shapes) and records its
  ``cost()``; a fake tensor at the launch raises; mixed fake and real
  tensors raise.
"""
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.analysis import hlo_cost, roofline as jroofline
from repro.configs.shapes import CELLS as JCELLS
from repro.models import get_model as j_get_model
from repro.models.base import count_params as j_count_params
from repro_torch import configs, kernels as tk
from repro_torch.analysis import op_cost, roofline
from repro_torch.configs.shapes import CELLS
from repro_torch.kernels import _build, common
from repro_torch.kernels.assoc_matmul import ops as assoc_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.hamming import ops as hamming_ops
from repro_torch.kernels.majority import ops as majority_ops
from repro_torch.kernels.sparse import ops as sparse_ops
from repro_torch.models import count_params, get_model


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_roofline_terms_and_dominant():
    r = roofline.roofline_terms(989e12 * 2, 3.35e12, 450e9 * 3, chips=1)
    assert abs(r.compute_s - 2.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 3.0) < 1e-9
    assert r.dominant == "collective" and r.bound_s == r.collective_s
    # each kind at its own peak; kinds with no peak add nothing to compute
    r2 = roofline.roofline_terms(0, 3.35e12 * 4, 0, chips=2,
                                 ops_by_kind={"bf16": 989e12, "b1": 15684e12, "int8": 1979e12,
                                              "f32": 67e12, "gather": 1e30})
    assert abs(r2.compute_s - 2.0) < 1e-9 and abs(r2.memory_s - 2.0) < 1e-9
    assert r2.collective_s == 0.0


def test_kernel_bound_by_bytes_or_operations():
    assert roofline.kernel_bound(3.35e12, 989e12, "bf16") == (1.0, "bytes")
    assert roofline.kernel_bound(3.35e12, 2 * 989e12, "bf16") == (2.0, "operations")
    assert roofline.kernel_bound(3.35e12, 1e30, "gather") == (1.0, "bytes")


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_active_params_and_model_flops_match_reference(arch):
    jcfg = jconfigs.get_config(arch)
    n = j_count_params(j_get_model(jcfg).specs)
    cfg = configs.get_config(arch)
    assert count_params(get_model(cfg).specs) == n
    assert roofline.active_params(cfg, n) == jroofline.active_params(jcfg, n)
    for name in JCELLS:
        assert roofline.model_flops(cfg, CELLS[name], n) == jroofline.model_flops(
            jcfg, JCELLS[name], n), name


# ---------------------------------------------------------------------------
# op_cost against the reference's hlo_cost
# ---------------------------------------------------------------------------

def _hlo(f, *shapes):
    comp = jax.jit(f).lower(*[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]).compile()
    return hlo_cost.analyze(comp.as_text())


def test_matmul_flops_and_bytes_equal_hlo_cost():
    want = _hlo(lambda a, b: a @ b, (256, 512), (512, 128))
    with FakeTensorMode():
        a, b = torch.empty(256, 512), torch.empty(512, 128)
        with op_cost.OpCost() as oc:
            oc.track((a, b), "arguments")
            a @ b
    assert oc.flops == want.flops == 2 * 256 * 512 * 128
    assert oc.hbm_bytes == want.hbm_bytes
    mem = oc.memory()
    assert mem["arguments_at_peak"] == 4 * (256 * 512 + 512 * 128)
    assert mem["temporaries_at_peak"] == 4 * 256 * 128


@pytest.mark.parametrize("op", ["bmm", "mm"])
def test_out_dtype_products_count_their_flops(op):
    """The card's f32-out-of-bf16 products (cuBLAS's ``out_dtype``, the MoE
    experts' `moe._bmm_acc`) count as their plain twin does: the dtype
    argument is no shape (the bmm formula once raised on it)."""
    with FakeTensorMode():
        a = torch.empty(4, 8, 16, dtype=torch.bfloat16)
        b = torch.empty(4, 16, 32, dtype=torch.bfloat16)
        if op == "mm":
            a, b = a[0], b[0]
        fn = getattr(torch, op)
        with op_cost.OpCost() as wide:
            out = fn(a, b, out_dtype=torch.float32)
        with op_cost.OpCost() as plain:
            fn(a, b)
    assert out.dtype == torch.float32
    assert wide.flops == plain.flops == 2 * a.numel() * b.shape[-1]
    assert dict(wide.flops_by_kind) == {"bf16": wide.flops}


def test_loop_flops_equal_hlo_cost_trip_count():
    def body(c, _):
        return jnp.tanh(c @ c), None

    want = _hlo(lambda x: jax.lax.scan(body, x, None, length=7)[0], (128, 128))
    with FakeTensorMode():
        x = torch.empty(128, 128)
        with op_cost.OpCost() as oc:
            for _ in range(7):
                x = torch.tanh(x @ x)
    assert oc.flops == want.flops == 7 * 2 * 128**3


def test_nested_loop_flops_equal_hlo_cost():
    def inner(c, _):
        return jnp.tanh(c @ c), None

    def outer(c, _):
        return jax.lax.scan(inner, c, None, length=3)[0], None

    want = _hlo(lambda x: jax.lax.scan(outer, x, None, length=5)[0], (64, 64))
    with FakeTensorMode():
        x = torch.empty(64, 64)
        with op_cost.OpCost() as oc:
            for _ in range(5):
                for _ in range(3):
                    x = torch.tanh(x @ x)
    assert oc.flops == want.flops == 15 * 2 * 64**3


def test_views_gathers_and_live_bytes():
    with FakeTensorMode():
        w = torch.empty(100, 16, requires_grad=True)
        idx = torch.empty(8, dtype=torch.int64)
        with op_cost.OpCost() as oc:
            oc.track(w, "parameters")
            rows = w.index_select(0, idx)               # a gather: 2 x its result
            before = oc.hbm_bytes
            rows.view(2, 4, 16).transpose(0, 1)          # views move nothing
            assert oc.hbm_bytes == before == 2 * 8 * 16 * 4
            loss = rows.sum()
            (g,) = torch.autograd.grad(loss, [w])
            del rows, loss
    mem = oc.memory()
    assert mem["categories_at_peak"]["parameters"] == 100 * 16 * 4
    assert "backward" in mem["categories_at_peak"]
    assert oc.live_bytes >= 100 * 16 * 4            # the parameters and the gradient


# ---------------------------------------------------------------------------
# each family's cost() at PERF.md §6's table shapes (bound, ms)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
TABLE = [  # (row, cost, bound in ms: PERF.md §6's, to 4 figures where it prints 3)
    ("1 top-1 G=64", hamming_ops.topk_cost(64, 256, 100, 16), 0.0004744),  # 0.000474
    ("2 search wired", hamming_ops.search_cost(1, 256, 6400, 16), 0.002083),
    ("3 assoc_matmul G=64", assoc_ops.cost(64, 256, 100, 512), 0.005439),
    ("4 majority", majority_ops.cost(3, 256 * 512), 0.0001565),            # 0.000157
    ("5 banked search", hamming_ops.search_cost(8, 512, 12800, 64), 0.07074),
    ("6 top-k screen", hamming_ops.topk_cost(8, 512, 1600, 64, 8), 0.001712),
    ("7 sparse search", sparse_ops.search_cost(2000, 100, 32768, 2048), 0.009042),
    ("8 sparse top-1", sparse_ops.topk_cost(64, 256, 100, 32768, 2048), 0.2905),
    ("9 attention", flash_ops.fwd_cost(8, 1024, 1024, 32, 4, 64, True, -1, 0, BF16), 0.03478),
    ("9 mixtral", flash_ops.fwd_cost(8, 1024, 1024, 48, 8, 128, True, 4096, 0, BF16), 0.1043),
    ("9 kimi D=112", flash_ops.fwd_cost(8, 1024, 1024, 64, 8, 112, True, -1, 0, BF16), 0.1217),
    ("10 backward", flash_ops.bwd_cost(8, 1024, 1024, 32, 4, 64, True, -1, 0, BF16), 0.08694),
    ("10 D=112", flash_ops.bwd_cost(4, 1024, 1024, 64, 8, 112, True, -1, 0, BF16), 0.1521),
]


@pytest.mark.parametrize("row,cost,want", TABLE, ids=[t[0] for t in TABLE])
def test_cost_gives_the_tables_bound(row, cost, want):
    s, _ = roofline.kernel_bound(*cost)
    assert float(f"{s * 1e3:.4g}") == pytest.approx(want, rel=1e-9), (row, s * 1e3)


def test_worked_examples():
    """The two worked numbers: row 9 at B 8, S 1024, H 32, D 64, causal is
    4 B H 524,800 D operations; row 2 is 6,979,584 bytes."""
    assert flash_ops.attention_pairs(1024, 1024, True, -1, 0) == 524_800
    assert flash_ops.fwd_cost(8, 1024, 1024, 32, 4, 64, True, -1, 0, BF16)[1] == \
        4 * 8 * 32 * 524_800 * 64
    assert hamming_ops.search_cost(1, 256, 6400, 16)[0] == 6_979_584


# ---------------------------------------------------------------------------
# the fake branch of every wrapper
# ---------------------------------------------------------------------------

def _words(*shape):
    return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32)


def _lists(g, b, k, w):
    """Sorted index lists, [b, k] when g is None, else [g, b, k]."""
    q = torch.sort(torch.randint(0, 32 * w, ((g or 1) * b, k), dtype=torch.int32), -1).values
    return q.reshape(b, k) if g is None else q.reshape(g, b, k)


def _bf(*shape):
    return torch.randn(shape).to(torch.bfloat16)


CASES = {  # wrapper -> (call on inputs, inputs, the cost it must record)
    "hamming_search": (lambda q, p: tk.hamming_search(q, p), (_words(6, 3), _words(40, 3)),
                       hamming_ops.search_cost(1, 6, 40, 3)),
    "hamming_search_banked": (lambda q, p: tk.hamming_search_banked(q, p),
                              (_words(2, 6, 3), _words(2, 40, 3)),
                              hamming_ops.search_cost(2, 6, 40, 3)),
    "hamming_topk_banked": (lambda q, p: tk.hamming_topk_banked(q, p, c_real=30),
                            (_words(2, 6, 3), _words(2, 40, 3)),
                            hamming_ops.topk_cost(2, 6, 30, 3)),
    "hamming_topk_k_banked": (lambda q, p: tk.hamming_topk_banked(q, p, k=4),
                              (_words(2, 6, 3), _words(2, 40, 3)),
                              hamming_ops.topk_cost(2, 6, 40, 3, 4)),
    "hamming_topk_banked bank_rows": (
        lambda q, p, r: tk.hamming_topk_banked(q, p, bank_rows=r),
        (_words(3, 6, 3), _words(5, 40, 3), torch.tensor([4, 0, 4], dtype=torch.int32)),
        hamming_ops.topk_cost(3, 6, 40, 3, table_rows=5)),
    "assoc_matmul": (lambda q, p: tk.assoc_matmul_banked(q, p),
                     (torch.randint(0, 2, (2, 6, 50), dtype=torch.uint8),
                      torch.randint(0, 2, (2, 9, 50), dtype=torch.uint8)),
                     assoc_ops.cost(2, 6, 9, 50)),
    "majority_bundle": (lambda x: tk.majority_bundle(x),
                        (torch.randint(0, 2, (3, 4, 50), dtype=torch.uint8),),
                        majority_ops.cost(3, 200)),
    "sparse_search": (lambda q, p: tk.sparse_search(q, p), (_lists(None, 6, 5, 4), _words(9, 4)),
                      sparse_ops.search_cost(6, 9, 4, 5)),
    "sparse_topk_banked": (lambda q, p: tk.sparse_topk_banked(q, p, c_real=7),
                           (_lists(2, 6, 5, 4), _words(2, 9, 4)),
                           sparse_ops.topk_cost(2, 6, 9, 4, 5, 7)),
    "flash_attention_fwd": (lambda q, k, v: tk.flash_attention_fwd(q, k, v, window=5,
                                                                   return_lse=True),
                            (_bf(2, 12, 4, 16), _bf(2, 12, 2, 16), _bf(2, 12, 2, 16)),
                            flash_ops.fwd_cost(2, 12, 12, 4, 2, 16, True, 5, 0, BF16)),
    "flash_attention_bwd": (lambda q, k, v, o, lse, do: tk.flash_attention_bwd(
                                q, k, v, o, lse, do, causal=False),
                            (_bf(2, 12, 4, 16), _bf(2, 9, 2, 16), _bf(2, 9, 2, 16),
                             _bf(2, 12, 4, 16), torch.randn(2, 4, 12), _bf(2, 12, 4, 16)),
                            flash_ops.bwd_cost(2, 12, 9, 4, 2, 16, False, -1, 0, BF16)),
}


class _Recorder:
    def __init__(self):
        self.seen, self.depth = [], 0

    def kernel(self, name, nbytes, ops, kind):
        self.depth += 1
        if self.depth == 1:
            self.seen.append((name, (nbytes, ops, kind)))

    def kernel_done(self):
        self.depth -= 1


@pytest.mark.parametrize("name", list(CASES))
def test_fake_branch_shapes_and_cost(name):
    call, inputs, cost = CASES[name]
    want = call(*inputs)                         # the plain version on the CPU
    want = want if isinstance(want, tuple) else (want,)
    launches = tk.launch_counts()
    with FakeTensorMode() as mode:
        fakes = [mode.from_tensor(x) for x in inputs]
        with common.recording(_Recorder()) as rec:
            got = call(*fakes)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(g.shape), g.dtype) for g in got] == [(tuple(w.shape), w.dtype) for w in want]
    assert all(common.is_fake(g) for g in got)
    kernel = name.split()[0]
    assert rec.seen == [(kernel, cost)]
    assert tk.launch_counts() == launches        # a fake branch is no launch


def test_fake_tensor_at_the_launch_raises():
    with FakeTensorMode():
        x = torch.empty(4, dtype=torch.int32)
        with pytest.raises(RuntimeError, match="fake tensor"):
            _build.launch("majority_bundle_launch", x, x, 1, 4)


def test_mixed_fake_and_real_tensors_raise():
    real = _words(2, 6, 3)
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(_words(2, 40, 3))
    with pytest.raises(ValueError, match="fake and real"):
        tk.hamming_search_banked(real, fake)


def test_attention_pairs_cover_windows_and_offsets():
    """The closed loop of `attention_pairs` on small hand cases."""
    assert flash_ops.attention_pairs(4, 4, True, -1, 0) == 10
    assert flash_ops.attention_pairs(4, 4, False, -1, 0) == 16
    assert flash_ops.attention_pairs(4, 4, True, 2, 0) == 1 + 2 + 2 + 2
    # rows that see no key take the mean over all keys
    assert flash_ops.attention_pairs(2, 3, True, -1, -2) == 3 + 3
    assert math.isclose(flash_ops.fwd_cost(1, 4, 4, 1, 1, 8, True, -1, 0,
                                           torch.float32)[1], 4 * 10 * 8)
