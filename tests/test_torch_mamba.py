"""The port's Mamba blocks and the SSM decoder (falcon-mamba) against the
JAX package on the CPU, f32: the causal conv and its decode step, the
chunked selective scan and SSD (chunk 16, S = 64 and an odd S = 37 that
pads, a non-zero initial state) against `repro.models.mamba`'s and against
the port's own sequential oracles, both blocks and both decodes, then the
whole SSM model on falcon-mamba's smoke config (loss, prefill and its cache,
decode, decode == a prefill of S + 1), the static engine against JAX's and
the continuous engine against static generates. Weights are JAX's, carried
across by ``convert.params_from_numpy``; inputs come from numpy seeds.

Tolerances: the reference's own atol = rtol = 1e-4 for the scans against
their oracles (tests/test_models.py) and for the port against JAX. The
two differ in the order of f32 sums (a Hillis-Steele scan in place of
``lax.associative_scan``'s tree, torch's matmuls in place of XLA's) and in
softplus: `F.softplus` returns x above its threshold of 20 where
``jax.nn.softplus`` adds log1p(exp(-x)), under 3e-9 relative."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ssm_common import check_loss_and_grads, numpy_params, pair
from repro import configs as jconfigs
from repro.models import get_model as j_get_model
from repro.models import mamba as jmamba
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.distributed.collectives import TensorParallel
from repro_torch.models import get_model, init_params, mamba
from repro_torch.serving import ContinuousEngine, Engine, Scheduler, ServeConfig
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

ARCH = "falcon_mamba_7b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test, as tests/test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _tokens(seed, b, s, vocab):
    return _rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jitted(kind):
    """JAX's block (with and without a state) and decode of one kind, jitted
    once for the module."""
    arch, _, block, decode = BLOCKS[kind]
    jcfg = jconfigs.get_smoke(arch)
    jb, jd = getattr(jmamba, block), getattr(jmamba, decode)
    return (jax.jit(lambda p, x: jb(p, jcfg, x)),
            jax.jit(lambda p, x, st: jb(p, jcfg, x, st)),
            jax.jit(lambda p, x, c, h: jd(p, jcfg, x, c, h)))


# ---------------------------------------------------------------------------
# the conv and the scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 37])
def test_causal_conv_and_its_step_match_jax(s):
    """The conv over S steps, and the decode step against the conv's last
    output on the K-1 inputs before it (the state, zero-padded in front)."""
    r = _rng(s)
    x = r.standard_normal((2, s, 12)).astype(np.float32)
    w = r.standard_normal((12, 4)).astype(np.float32)
    b = r.standard_normal((12,)).astype(np.float32)
    want = jmamba.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = mamba.causal_conv1d(*_t(x, w, b))
    _close(got, want)
    state = r.standard_normal((2, 3, 12)).astype(np.float32)
    j_state, j_out = jmamba.conv_step(jnp.asarray(state), jnp.asarray(x[:, -1]), jnp.asarray(w),
                                      jnp.asarray(b))
    t_state, t_out = mamba.conv_step(*_t(state, x[:, -1], w, b))
    _close(t_out, j_out)
    np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))
    # the step on the last K-1 inputs equals the conv's last output
    pad = np.concatenate([np.zeros((2, 3, 12), np.float32), x], 1)[:, -4:-1]
    _, out = mamba.conv_step(*_t(pad, x[:, -1], w, b))
    _close(out, got[:, -1])


def _scan_inputs(seed, s, din=24, n=8):
    r = _rng(seed)
    u = r.standard_normal((2, s, din)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((2, s, din)))).astype(np.float32) * 0.5
    A = -np.exp(0.5 * r.standard_normal((din, n))).astype(np.float32)
    B, C = (r.standard_normal((2, s, n)).astype(np.float32) for _ in range(2))
    D = r.standard_normal((din,)).astype(np.float32)
    h0 = r.standard_normal((2, din, n)).astype(np.float32)
    return u, dt, A, B, C, D, h0


@pytest.mark.parametrize("s", [64, 37])
def test_selective_scan_matches_jax_and_its_oracle(s):
    """Chunk 16: S = 64 is four whole chunks, 37 pads to 48 with dt = 0
    steps; h0 is non-zero."""
    args = _scan_inputs(s, s)
    jy, jh = jax.jit(functools.partial(jmamba.selective_scan, chunk=16))(
        *map(jnp.asarray, args))
    ty, th = mamba.selective_scan(*_t(*args), chunk=16)
    ry, rh = mamba.selective_scan_ref(*_t(*args))
    assert ty.shape == (2, s, 24) and th.shape == (2, 24, 8)
    _close(ty, jy)
    _close(th, jh)
    _close(ty, ry)
    _close(th, rh)


def _ssd_inputs(seed, s, nh=4, p=8, g=2, n=6):
    r = _rng(seed)
    x = r.standard_normal((2, s, nh, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((2, s, nh)))).astype(np.float32) * 0.5
    A = -np.exp(0.5 * r.standard_normal((nh,))).astype(np.float32)
    B, C = (r.standard_normal((2, s, g, n)).astype(np.float32) for _ in range(2))
    D = r.standard_normal((nh,)).astype(np.float32)
    h0 = r.standard_normal((2, nh, n, p)).astype(np.float32)
    return x, dt, A, B, C, D, h0


@pytest.mark.parametrize("s", [64, 37])
def test_ssd_matches_jax_and_its_oracle(s):
    """The SSD matmul form at chunk 16 with two groups broadcast to four
    heads, against JAX's `ssd` and the port's sequential `ssd_ref`."""
    args = _ssd_inputs(s, s)
    jy, jh = jax.jit(functools.partial(jmamba.ssd, chunk=16))(*map(jnp.asarray, args))
    ty, th = mamba.ssd(*_t(*args), chunk=16)
    ry, rh = mamba.ssd_ref(*_t(*args))
    assert ty.shape == (2, s, 4, 8) and th.shape == (2, 4, 6, 8)
    _close(ty, jy)
    _close(th, jh)
    _close(ty, ry)
    _close(th, rh)


def test_oracles_in_f64_agree_with_f32():
    """The sequential oracles run in h0's dtype: in f64 (chip_smoke.py's
    yardstick) they return f64 and agree with the f32 runs."""
    args = _scan_inputs(3, 20)
    y32, _ = mamba.selective_scan_ref(*_t(*args))
    t = _t(*args)
    y64, h64 = mamba.selective_scan_ref(*t[:-1], t[-1].double())
    assert y64.dtype == h64.dtype == torch.float64
    _close(y32, y64.float())
    args = _ssd_inputs(4, 20)
    t = _t(*args)
    y32, _ = mamba.ssd_ref(*t)
    y64, _ = mamba.ssd_ref(*t[:-1], t[-1].double())
    assert y64.dtype == torch.float64
    _close(y32, y64.float())


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

BLOCKS = {"mamba1": (ARCH, jmamba.mamba1_specs, "mamba1_block", "mamba1_decode"),
          "mamba2": ("zamba2_2_7b", jmamba.mamba2_specs, "mamba2_block", "mamba2_decode")}


@pytest.mark.parametrize("s", [37, 2])
@pytest.mark.parametrize("kind", BLOCKS)
def test_block_and_decode_match_jax(kind, s):
    """The block on S steps from a zero state (S = 2 < K-1 pads the conv
    state), then from the returned SSM state on three more steps (the
    block's conv starts from zeros, as the reference's does), and three
    decodes on those steps from both returned states, each against JAX's;
    the decodes also against the block's outputs at those steps of the
    whole S + 3."""
    arch, spec_fn, block, decode = BLOCKS[kind]
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = numpy_params(spec_fn(jcfg, 0), len(kind) + s)
    tp = convert.params_from_numpy(jp, "cpu")
    x = _rng(s).standard_normal((2, s + 3, jcfg.d_model)).astype(np.float32)
    jb, jb_state, jd = _jitted(kind)
    tb, td = getattr(mamba, block), getattr(mamba, decode)
    j_out, (j_conv, j_ssm) = jb(jp, jnp.asarray(x[:, :s]))
    t_out, (t_conv, t_ssm) = tb(tp, tcfg, torch.from_numpy(x[:, :s]))
    _close(t_out, j_out)
    _close(t_conv, j_conv)
    _close(t_ssm, j_ssm)
    j_more, _ = jb_state(jp, jnp.asarray(x[:, s:]), j_ssm)
    t_more, _ = tb(tp, tcfg, torch.from_numpy(x[:, s:]), t_ssm)
    _close(t_more, j_more)
    t_whole, _ = tb(tp, tcfg, torch.from_numpy(x))
    for i in range(3):
        xi = x[:, s + i:s + i + 1]
        j_y, j_conv, j_ssm = jd(jp, jnp.asarray(xi), j_conv, j_ssm)
        t_y, t_conv, t_ssm = td(tp, tcfg, torch.from_numpy(xi), t_conv, t_ssm)
        _close(t_y, j_y)
        _close(t_conv, j_conv)
        _close(t_ssm, j_ssm)
        _close(t_y[:, 0], t_whole[:, s + i])


def test_f32_leaves_cross_as_f32_in_a_bf16_tree():
    """`convert.params_from_numpy` carries a bf16 model's tree (JAX's f32
    weights rounded to bf16 where the reference's spec is bf16) with its
    f32 leaves (A_log, D, dt_bias) as f32 and the rest as bf16, bit for
    bit, in the leaves, shapes and dtypes that the port's own init draws."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.bfloat16)
    jdtypes = {tuple(str(k.key) for k in path): spec.dtype
               for path, spec in jax.tree_util.tree_flatten_with_path(
                   j_get_model(jcfg).specs,
                   is_leaf=lambda x: hasattr(x, "dtype") and hasattr(x, "axes"))[0]}
    jp32 = pair(ARCH)[1]

    def cast(path, a):
        return np.asarray(jnp.asarray(a, jdtypes[tuple(str(k.key) for k in path)]))

    jp = jax.tree_util.tree_map_with_path(cast, jp32)
    tp = convert.params_from_numpy(jp, "cpu")
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=torch.bfloat16)
    want = init_params(get_model(tcfg).specs, torch.Generator().manual_seed(0))
    seen = set()
    for (path, t), (wpath, w) in zip(tree_flatten(tp), tree_flatten(want)):
        assert path == wpath and t.dtype == w.dtype and t.shape == w.shape, path
        seen.add((path[-1], t.dtype))
        j = functools.reduce(lambda n, k: n[k], path, jp)
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
    assert {("A_log", torch.float32), ("D", torch.float32), ("dt_bias", torch.float32),
            ("in_proj", torch.bfloat16)} <= seen


def test_bf16_block_matches_jax_bf16():
    """A bf16 block (x_proj's output and dt_proj in f32, the SSM state f32)
    on bf16 weights against JAX's bf16 block, within a few bf16 roundings
    of the output (the two round at the same places, after sums in another
    order)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=torch.bfloat16)
    jp = numpy_params(jmamba.mamba1_specs(jcfg, 0), 9)
    tp = convert.params_from_numpy(jp, "cpu")
    x = _rng(9).standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    j_out, _ = jax.jit(lambda p, x: jmamba.mamba1_block(p, jcfg, x))(
        jp, jnp.asarray(x, jnp.bfloat16))
    t_out, (_, t_ssm) = mamba.mamba1_block(tp, tcfg, torch.from_numpy(x).bfloat16())
    assert t_out.dtype == torch.bfloat16 and t_ssm.dtype == torch.float32
    _close(t_out.float(), np.asarray(j_out).astype(np.float32), dict(atol=0.05, rtol=0.02))


# ---------------------------------------------------------------------------
# the SSM model
# ---------------------------------------------------------------------------

def test_loss_prefill_cache_and_decode_match_jax():
    """loss_fn within 1e-5 relative; prefill's last logits and its cache
    (conv [L, B, K-1, din], ssm [L, B, din, N]) within TOL; three decode
    steps' logits and caches within TOL; decode(prefill(x), t) against
    prefill(x ‖ t) within 5e-3, the reference's bound."""
    jm, jp, tm, tp = pair(ARCH)
    b, s, steps = 2, 37, 3
    toks = _tokens(7, b, s + steps, tm.cfg.vocab)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want, _ = jax.jit(jm.loss_fn)(jp, jax.tree.map(jnp.asarray, batch))
    got, met = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(met["aux"]) == 0
    j_lg, j_cache = jax.jit(jm.prefill_fn)(jp, {"tokens": jnp.asarray(toks[:, :s])})
    t_lg, t_cache = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pad_to=64)
    _close(t_lg, j_lg)
    assert set(t_cache) == {"conv", "ssm"}
    for name in t_cache:
        assert t_cache[name].shape == j_cache[name].shape
        assert t_cache[name].dtype == (torch.float32)
        _close(t_cache[name], j_cache[name])
    j_decode = jax.jit(jm.decode_fn)
    for i in range(steps):
        nxt = toks[:, s + i]
        j_step, j_cache = j_decode(jp, j_cache, jnp.asarray(nxt), jnp.int32(s + i))
        t_step, t_cache = tm.decode_fn(tp, t_cache, torch.from_numpy(nxt), s + i)
        _close(t_step, j_step)
        for name in t_cache:
            _close(t_cache[name], j_cache[name])
    t_full, _ = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert float((t_step - t_full).abs().max()) < 5e-3


def test_decode_writes_the_state_in_place():
    """The decode step writes the new conv and SSM states into the cache's
    own tensors (their addresses kept), as the KV decodes write K/V."""
    _, _, tm, tp = pair(ARCH)
    cache = tm.init_cache_fn(2, 16, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    _, out = tm.decode_fn(tp, cache, torch.tensor([3, 5], dtype=torch.int32), 0)
    assert {k: v.data_ptr() for k, v in out.items()} == ptrs
    assert all(not torch.equal(out[k], before[k]) for k in ptrs)


def test_static_engine_tokens_equal_jax():
    """Greedy `Engine.generate`, B 2 x prompt 24 x 8 new, token for token
    against JAX's `Engine`."""
    jm, jp, tm, tp = pair(ARCH)
    toks = _tokens(21, 2, 24, tm.cfg.vocab)
    want = np.asarray(JEngine(jm, JServeConfig(max_new=8)).generate(
        jp, {"tokens": jnp.asarray(toks)}))
    got = Engine(tm, ServeConfig(max_new=8)).generate(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got.numpy(), want)


def test_model_refuses_chunked_prefill_and_ranks():
    """The model has no chunked prefill and the engine refuses one; the
    training loss on a one-rank `TensorParallel` is the plain loss bit for
    bit (training across ranks: test_torch_distributed_nondense.py)."""
    _, _, tm, tp = pair(ARCH)
    assert tm.prefill_chunk_fn is None
    with pytest.raises(ValueError, match="no chunked prefill"):
        ContinuousEngine(tm, ServeConfig(max_new=4), num_slots=2, max_prompt_len=32,
                         prefill_chunk=8, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, tm.cfg.vocab, (2, 12)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    assert torch.equal(tm.loss_fn(tp, batch, tp=TensorParallel())[0], tm.loss_fn(tp, batch)[0])


@pytest.mark.parametrize("slots", [1, 3])
def test_continuous_completions_equal_static_generates(slots):
    """More requests than slots (slots reused): every completion equals its
    static B = 1 generate, the state rows of an admitted slot replaced
    whole (conv and SSM states over axis 1)."""
    _, _, tm, tp = pair(ARCH)
    lengths = (9, 21, 2, 14, 30, 9)
    prompts = [_rng(70 + i).integers(0, tm.cfg.vocab, (n,)).astype(np.int32)
               for i, n in enumerate(lengths)]
    scfg = ServeConfig(max_new=5)
    eng = ContinuousEngine(tm, scfg, num_slots=slots, max_prompt_len=max(lengths),
                           device="cpu")
    state = eng.init_state()
    assert set(state["cache"]) == {"conv", "ssm"}
    assert state["cache"]["ssm"].shape[1] == slots
    sched = Scheduler(eng, tp)
    rids = [sched.submit(torch.from_numpy(p)) for p in prompts]
    sched.run(timeout=600)
    for rid, p in zip(rids, prompts):
        want = Engine(tm, scfg).generate(tp, {"tokens": torch.from_numpy(p)[None]})[0]
        assert sched.poll(rid).tokens == want.tolist()


class _OnTheCard(torch.Tensor):
    """A meta tensor that reports itself on the card, so that `_dot_f32`
    takes its card branch here (``mm`` with ``out_dtype`` has a meta
    kernel); its results keep the class."""

    @property
    def is_cuda(self):
        return True


def test_dot_f32_is_differentiable_on_the_card():
    """On the card `_dot_f32` writes f32 out of bf16 through ``mm``'s
    ``out_dtype``, which has no derivative: training Falcon-Mamba-7B on an
    H100 raised "derivative for aten::mm is not implemented" in x_proj.
    Where autograd records it widens instead: the gradients of both
    operands exist, in their own dtype; without a gradient it keeps the
    cuBLAS path."""
    x, w = (torch.empty(shape, dtype=torch.bfloat16, device="meta").as_subclass(_OnTheCard)
            for shape in ((2, 5, 8), (8, 3)))
    with torch.no_grad():
        assert mamba._dot_f32(x, w).dtype == torch.float32
    with pytest.raises(RuntimeError, match="derivative for aten::mm"):
        torch.mm(x.reshape(-1, 8).requires_grad_(), w, out_dtype=torch.float32).sum().backward()
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    out = mamba._dot_f32(xg, wg)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 3)
    gx, gw = torch.autograd.grad(out.sum(), (xg, wg))
    assert (gx.shape, gx.dtype, gw.shape, gw.dtype) == (x.shape, x.dtype, w.shape, w.dtype)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(remat):
    """loss_fn and the gradient of every leaf against ``jax.value_and_grad``
    of the reference's loss_fn, with remat off and on (each layer under
    checkpoint), through the chunked selective scan (S = 37 pads its last chunk): the
    loss within 1e-5 relative, each leaf within 1e-4 of its largest |g|."""
    check_loss_and_grads(ARCH, remat, seed=12)


def test_remat_gives_the_same_loss_and_gradients():
    """With remat each layer runs under torch.utils.checkpoint: the same loss
    and the same gradient of every leaf as without, through the chunked
    scan (S = 37 pads its last chunk); and the loss is the serving path's
    bit for bit (the scan's differentiable steps do its arithmetic)."""
    _, _, tm, tp = pair(ARCH)
    toks = torch.from_numpy(_tokens(8, 2, 38, tm.cfg.vocab))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    out = []
    for remat in (False, True):
        model = get_model(dataclasses.replace(tm.cfg, remat=remat))
        leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(tp)]
        loss, _ = model.loss_fn(tree_unflatten(tp, leaves), batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    assert all(float(g.abs().max()) > 0 for g in out[0][1])
    assert torch.equal(tm.loss_fn(tp, batch)[0], out[0][0].detach())
