"""The port's MoE decoder against the JAX package on the CPU, f32: the MoE
block (`repro_torch.models.moe.apply` against `repro.models.moe.apply`) on
the mixtral and kimi smoke configs (kimi with its shared expert), at a
drop-heavy capacity, with a zero router (every probability ties) and with a
token count that is no multiple of the group size; then the whole model on
both smoke configs (prefill, cache, decode, the ring past mixtral's window
of 64, the loss and every gradient), the engines, the refusals and the
sliced draw of large leaves. Weights are JAX's, carried across by
``convert.params_from_numpy``; inputs come from numpy seeds."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as j_get_model
from repro.models import init_params as j_init_params
from repro.models import moe as jmoe
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Engine as JEngine
from repro.serving import Scheduler as JScheduler
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.models import base, get_model, init_params
from repro_torch.models import moe
from repro_torch.distributed.collectives import TensorParallel
from repro_torch.models import transformer as ttfm
from repro_torch.serving import ContinuousEngine, Engine, Scheduler, ServeConfig
from repro_torch.tree import tree_flatten, tree_leaves

MOE = ("mixtral_8x22b", "kimi_k2")
TOL = dict(atol=1e-4, rtol=1e-4)          # as tests/test_torch_transformer.py
# the MoE block alone: f32 sums in another order, and the same routing
OUT_TOL, AUX_TOL = 1e-5, 1e-6
# gradients: each leaf's within this share of its largest |g| (the dense
# decoder's bound at the conditioned init, tests/test_torch_train.py)
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test, as tests/test_torch_train.py: the suite
    runs several workers at once, and small ops on every core slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **moe_replace):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    if moe_replace:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_replace))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_replace))
    return jcfg, tcfg


def _conditioned(tree, cfg):
    """JAX's tree (numpy) with the attention projections at fan-in over the
    axes they contract (tests/test_torch_train.py's `_conditioned`): at the
    reference's init the smoke widths' attention is near-hard, and
    gradients of two implementations that round apart part by ~3e-4."""
    a, d, h, kh = tree["blocks"]["attn"], cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    scale = {"wq": math.sqrt(h / d), "wk": math.sqrt(kh / d), "wv": math.sqrt(kh / d),
             "wo": 1 / math.sqrt(h)}
    return {**tree, "blocks": {**tree["blocks"], "attn": {
        k: (v * np.float32(scale[k]) if k in scale else v) for k, v in a.items()}}}


@functools.lru_cache(maxsize=None)
def _pair(arch, conditioned=False):
    """(JAX model, JAX params, port model, port params) with JAX's weights."""
    jcfg, tcfg = _cfgs(arch)
    jm = j_get_model(jcfg)
    jp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(1), jm.specs))
    if conditioned:
        jp = _conditioned(jp, jcfg)
    return jm, jp, get_model(tcfg), convert.params_from_numpy(jp, "cpu")


def _close_scaled(got, want, tol=1e-4):
    """max |got - want| <= tol * max |want| (tests/test_torch_transformer.py:
    the K/V cache inherits f32 sum-order differences through the
    reference init's sharp softmax)."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _block_params(jcfg, zero_router=False):
    jp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jmoe.moe_specs(jcfg, 0)))
    if zero_router:
        jp["router"] = np.zeros_like(jp["router"])
    return jp


CASES = {   # name -> (MoESettings changes, (B, S), zero router)
    "default": ({}, (2, 24), False),
    "drop-heavy": ({"capacity_factor": 0.5}, (2, 24), False),
    "zero router": ({}, (2, 24), True),
    "t not a multiple of the group": ({"group_size": 8}, (3, 7), False),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_jax(arch, case):
    """out within 1e-5 and aux within 1e-6 of `repro.models.moe.apply`, and
    the routing (experts, gates, positions, drops) equal to the reference's
    own arithmetic on its probabilities."""
    changes, (b, s), zero = CASES[case]
    jcfg, tcfg = _cfgs(arch, **changes)
    jp = _block_params(jcfg, zero)
    x = np.random.default_rng(len(case)).standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    j_out, j_aux = jax.jit(lambda p, x: jmoe.apply(p, jcfg, x))(jp, jnp.asarray(x))
    tp = convert.params_from_numpy(jp, "cpu")
    t_out, t_aux = moe.apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=AUX_TOL, rtol=0)

    m = tcfg.moe
    t = b * s
    tg = moe.group_tokens(t, m.group_size)
    r = moe.route(tp["router"], tcfg, torch.from_numpy(x).reshape(t // tg, tg, -1))
    j_probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(x).reshape(t // tg, tg, -1),
                                        jnp.asarray(jp["router"])), axis=-1)
    j_gate, j_idx = jax.lax.top_k(j_probs, m.top_k)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(r.gate.numpy(), np.asarray(
        j_gate / jnp.maximum(j_gate.sum(-1, keepdims=True), 1e-9)), atol=1e-6)
    # the reference's slot-major cumsum (moe.py:83-91), in numpy
    idx = np.asarray(j_idx)
    g, e, k = t // tg, m.n_experts, m.top_k
    ohp = np.eye(e, dtype=np.int64)[idx.transpose(0, 2, 1).reshape(g, k * tg)]
    pos = ((np.cumsum(ohp, 1) - ohp) * ohp).sum(-1).reshape(g, k, tg).transpose(0, 2, 1)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), pos < r.capacity)
    assert r.capacity == jmoe._capacity(tg, k, e, m.capacity_factor)
    if case == "zero router":
        # every probability ties: experts 0..k-1, in that order, for every
        # token; expert j keeps the first C tokens of its group, all in slot j
        assert (r.idx.numpy() == np.arange(k)).all()
        np.testing.assert_array_equal(r.keep.numpy(),
                                      np.broadcast_to((np.arange(tg) < r.capacity)[:, None],
                                                      (g, tg, k)))
        assert not r.keep.all()
    if case == "drop-heavy":
        assert 0 < int((~r.keep).sum()) < r.keep.numel()
    if case.startswith("t not"):
        assert (tg, g) == (7, 3)


def test_moe_block_on_one_rank_tensor_parallel_is_plain_and_straddling_groups_raise(
        monkeypatch):
    """A one-rank `TensorParallel` (no model group, no data ranks) gives the
    plain block's output and aux bit for bit; with two data ranks, B 1 x S
    60 a rank at group_size 40 raises (the global 120 tokens route in
    groups of 40, one of which would span both ranks' rows)."""
    tcfg = configs.get_smoke("mixtral_8x22b")
    p = init_params(moe.moe_specs(tcfg, 0), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32))
    want = moe.apply(p, tcfg, x)
    got = moe.apply(p, tcfg, x, tp=TensorParallel())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cfg40 = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, group_size=40))
    monkeypatch.setattr(moe, "data_ranks", lambda tp: 2)
    with pytest.raises(ValueError, match=r"120 tokens \(2 x 60\) route in groups of 40"):
        moe.apply(p, cfg40, torch.zeros(1, 60, tcfg.d_model), tp=TensorParallel())


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_prefill_cache_and_decode_match_jax(arch):
    """Prefill's last logits within TOL and its K/V cache within 1e-4 of its
    scale, slot_pos equal, three decode steps against JAX's, and
    decode(prefill(x), t) against prefill(x ‖ t) within 5e-3."""
    jm, jp, tm, tp = _pair(arch)
    b, s, steps = 2, 40, 3
    toks = _tokens(len(arch), b, s + steps, tm.cfg.vocab)
    pad_to = s + steps + 1
    j_lg, j_cache = jax.jit(functools.partial(jm.prefill_fn, pad_to=pad_to))(
        jp, {"tokens": jnp.asarray(toks[:, :s])})
    t_lg, t_cache = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pad_to=pad_to)
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), **TOL)
    for name in ("k", "v"):
        assert t_cache[name].shape == j_cache[name].shape
        _close_scaled(t_cache[name].numpy(), j_cache[name])
    np.testing.assert_array_equal(t_cache["slot_pos"].numpy(), np.asarray(j_cache["slot_pos"]))
    j_decode = jax.jit(jm.decode_fn)
    for i in range(steps):
        nxt = toks[:, s + i]
        j_step, j_cache = j_decode(jp, j_cache, jnp.asarray(nxt), jnp.int32(s + i))
        t_step, t_cache = tm.decode_fn(tp, t_cache, torch.from_numpy(nxt), s + i)
        np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step), **TOL)
        np.testing.assert_array_equal(t_cache["slot_pos"].numpy(),
                                      np.asarray(j_cache["slot_pos"]))
    t_full, _ = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert float((t_step - t_full).abs().max()) < 5e-3


def test_ring_cache_decoded_past_the_window_matches_jax():
    """Mixtral's smoke config is windowed at 64 on every layer: S = 96 fills a
    64-slot ring and four decodes wrap it further, with the MoE block
    between the ring decodes, step for step against JAX's decode."""
    jm, jp, tm, tp = _pair("mixtral_8x22b")
    b, s, extra = 2, 96, 4
    toks = _tokens(11, b, s + extra, tm.cfg.vocab)
    _, j_cache = jax.jit(jm.prefill_fn)(jp, {"tokens": jnp.asarray(toks[:, :s])})
    _, t_cache = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :s])})
    assert t_cache["k"].shape[2] == 64
    np.testing.assert_array_equal(t_cache["slot_pos"].numpy(), np.asarray(j_cache["slot_pos"]))
    _close_scaled(t_cache["k"].numpy(), j_cache["k"])
    _close_scaled(t_cache["v"].numpy(), j_cache["v"])
    j_decode = jax.jit(jm.decode_fn)
    for i in range(extra):
        tok = toks[:, s + i]
        j_lg, j_cache = j_decode(jp, j_cache, jnp.asarray(tok), jnp.int32(s + i))
        t_lg, t_cache = tm.decode_fn(tp, t_cache, torch.from_numpy(tok), s + i)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), **TOL)
        np.testing.assert_array_equal(t_cache["slot_pos"].numpy(),
                                      np.asarray(j_cache["slot_pos"]))
    t_ref, _ = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert float((t_lg - t_ref).abs().max()) < 5e-3


def _paired(port_tree, jax_tree):
    """(path, port leaf, JAX leaf as numpy) over the port's leaves."""
    jl = {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    return [(p, t, jl[tuple(str(k) for k in p)]) for p, t in tree_flatten(port_tree)]


class _OnTheCard(torch.Tensor):
    """A meta tensor that reports itself on the card, so that `_bmm_acc`
    takes its card branch here (``bmm`` with ``out_dtype`` has a meta
    kernel); its results keep the class."""

    @property
    def is_cuda(self):
        return True


def test_expert_products_are_differentiable_on_the_card():
    """On the card `moe._bmm_acc` writes f32 out of bf16 through ``bmm``'s
    ``out_dtype``, which has no derivative, so an MoE training step on the
    card would raise "derivative for aten::bmm is not implemented" in the
    experts' gate and up products. Where autograd records it widens
    instead: both gradients exist, in their operands' dtype; without a
    gradient it keeps the cuBLAS path."""
    a, b = (torch.empty(shape, dtype=torch.bfloat16, device="meta").as_subclass(_OnTheCard)
            for shape in ((2, 5, 8), (2, 8, 3)))
    with torch.no_grad():
        assert moe._bmm_acc(a, b).dtype == torch.float32
    with pytest.raises(RuntimeError, match="derivative for aten::bmm"):
        torch.bmm(a.detach().requires_grad_(), b, out_dtype=torch.float32).sum().backward()
    ag, bg = a.detach().requires_grad_(), b.detach().requires_grad_()
    out = moe._bmm_acc(ag, bg)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 3)
    ga, gb = torch.autograd.grad(out.sum(), (ag, bg))
    assert (ga.shape, ga.dtype, gb.shape, gb.dtype) == (a.shape, a.dtype, b.shape, b.dtype)


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_every_gradient_match_jax(arch):
    """loss_fn's ce + aux (aux summed over the layers) within 1e-5 relative
    and every leaf's gradient, the router's included, within GRAD_TOL of the
    leaf's largest |g| of ``jax.grad`` of the reference's loss, at the
    conditioned init (see `_conditioned`)."""
    jm, jp, tm, tp = _pair(arch, conditioned=True)
    toks = _tokens(5, 2, 33, tm.cfg.vocab)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (want, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    params = convert.params_from_numpy(jp, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    got, met = tm.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"].detach()), float(jmet["aux"]), atol=AUX_TOL)
    assert float(met["aux"].detach()) > 0
    paths = []
    for (path, _, jg), g in zip(_paired(params, jgrads), grads):
        paths.append(path)
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(g.numpy(), jg, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=str(path))
    assert ("blocks", "mlp", "router") in paths
    assert float(dict(zip(paths, grads))[("blocks", "mlp", "router")].abs().max()) > 0


def test_remat_carries_the_aux_loss():
    """With remat each layer runs under torch.utils.checkpoint, which returns
    the layer's aux loss too: the same loss, aux and gradients as without."""
    cfg = configs.get_smoke("kimi_k2")
    toks = torch.from_numpy(_tokens(6, 2, 17, cfg.vocab))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    out = []
    for remat in (False, True):
        model = get_model(dataclasses.replace(cfg, remat=remat))
        params = init_params(model.specs, torch.Generator().manual_seed(0))
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        loss, met = model.loss_fn(params, batch)
        out.append((loss, met["aux"], torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert float(out[0][1]) > 0
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_static_engine_tokens_equal_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(21, 2, 16, tm.cfg.vocab)
    want = np.asarray(JEngine(jm, JServeConfig(max_new=5)).generate(
        jp, {"tokens": jnp.asarray(toks)}))
    got = Engine(tm, ServeConfig(max_new=5)).generate(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got.numpy(), want)


def test_model_has_no_chunked_prefill_and_the_engine_refuses_it():
    _, _, tm, _ = _pair("mixtral_8x22b")
    assert tm.prefill_chunk_fn is None
    assert get_model(configs.get_smoke("kimi_k2")).prefill_chunk_fn is None
    with pytest.raises(ValueError, match="no chunked prefill"):
        ContinuousEngine(tm, ServeConfig(max_new=4), num_slots=2, max_prompt_len=32,
                         prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="dense-decoder only"):
        ttfm.run_stack_chunk({}, tm.cfg, torch.zeros(1, 4, tm.cfg.d_model),
                             torch.zeros(1, 4, dtype=torch.int32), {}, 0)


@pytest.mark.parametrize("arch,slots", [("mixtral_8x22b", 16), ("kimi_k2", 8)])
def test_per_slot_decode_routes_each_slot_alone(arch, slots):
    """One prompt admitted into all N slots of both engines, then one port
    decode at per-slot positions [N] against JAX's vmapped B = 1 decode: the
    logits and the cache within TOL. Each slot routes as a group of its
    own; the N alike tokens as one group (C < N) would drop the experts of
    all but the first C."""
    jm, jp, tm, tp = _pair(arch)
    p = _tokens(60, 1, 13, tm.cfg.vocab)
    scfg = dict(max_new=3)
    jeng = JContinuousEngine(jm, JServeConfig(**scfg), num_slots=slots, max_prompt_len=13)
    teng = ContinuousEngine(tm, ServeConfig(**scfg), num_slots=slots, max_prompt_len=13,
                            device="cpu")
    js, ts = jeng.init_state(), teng.init_state()
    for slot in range(slots):
        js, jt = jeng.prefill_into_slot(jp, js, {"tokens": jnp.asarray(p)}, slot)
        ts, tt = teng.prefill_into_slot(tp, ts, {"tokens": torch.from_numpy(p)}, slot)
        assert tt == jt

    def decode_one(params, cache, tok, pos):
        return jm.decode_fn(params, cache, tok, pos)

    j_lg, j_cache = jax.jit(jax.vmap(decode_one, in_axes=(None, 0, 0, 0)))(
        jp, js["cache"], js["tok"][:, None], js["pos"])
    t_lg, t_cache = tm.decode_fn(tp, ts["cache"], ts["tok"], ts["pos"])
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg)[:, 0], **TOL)
    for name in ("k", "v"):             # JAX [N, L, 1, Sc, KH, hd]; port [L, N, Sc, KH, hd]
        _close_scaled(t_cache[name].numpy(),
                      np.asarray(j_cache[name])[:, :, 0].transpose(1, 0, 2, 3, 4))


@pytest.mark.parametrize("arch,slots", [("mixtral_8x22b", 4), ("mixtral_8x22b", 16),
                                        ("kimi_k2", 8)])
def test_continuous_completions_equal_static_generates(arch, slots):
    """Whole-prompt admissions into N slots: every completion equals its
    static B = 1 generate and JAX's ContinuousEngine's, and both engines take
    the same steps. A continuous decode step is the reference's vmap of B = 1
    decodes, so each slot's token is routed as a group of its own (C = 4, no
    drop). At N = 16 on mixtral and N = 8 on kimi, one group of the N slot
    tokens would have C < N (asserted), and the first N prompts are one
    prompt, whose copies decode alike and route alike: in one group their
    experts would drop for their neighbours."""
    jm, jp, tm, tp = _pair(arch)
    m = tm.cfg.moe
    if slots > 4:
        assert moe._capacity(moe.group_tokens(slots, m.group_size), m.top_k, m.n_experts,
                             m.capacity_factor) < slots
    lengths = (13,) * slots + (8, 21, 8, 30)
    prompts = [np.random.default_rng(50 + n).integers(0, tm.cfg.vocab, (n,)).astype(np.int32)
               for n in lengths]
    scfg = ServeConfig(max_new=6)
    eng = ContinuousEngine(tm, scfg, num_slots=slots, max_prompt_len=max(lengths), device="cpu")
    jeng = JContinuousEngine(jm, JServeConfig(max_new=6), num_slots=slots,
                             max_prompt_len=max(lengths))
    sched, jsched = Scheduler(eng, tp), JScheduler(jeng, jp)
    rids = [sched.submit(torch.from_numpy(p)) for p in prompts]
    jrids = [jsched.submit(jnp.asarray(p)) for p in prompts]
    sched.run(timeout=600)
    jsched.run(timeout=600)
    assert sched.steps == jsched.steps
    for rid, jrid, p in zip(rids, jrids, prompts):
        want = Engine(tm, scfg).generate(tp, {"tokens": torch.from_numpy(p)[None]})[0]
        assert sched.poll(rid).tokens == want.tolist()
        assert sched.poll(rid).tokens == [int(t) for t in jsched.poll(jrid).tokens]


# ---------------------------------------------------------------------------
# the init at full width
# ---------------------------------------------------------------------------

def test_large_leaves_draw_slice_by_slice(monkeypatch):
    """A leaf under `base.DRAW_BYTES` draws the bits of a one-shot
    ``torch.randn`` on the same seed, scaled and cast, as before; with the
    size lowered, a larger leaf is drawn a run of leading slices at a time
    into a preallocated leaf: its shape and dtype, and its std within 5%."""
    small = base.ParamSpec((64, 48), (None, None), "fan_in", dtype=torch.bfloat16)
    got = init_params({"w": small}, torch.Generator().manual_seed(3))["w"]
    want = torch.randn((64, 48), generator=torch.Generator().manual_seed(3)).mul_(
        1 / math.sqrt(64)).to(torch.bfloat16)
    assert torch.equal(got, want)
    monkeypatch.setattr(base, "DRAW_BYTES", 8 * 1024)
    spec = base.ParamSpec((3, 4, 64, 40), (None,) * 4, "fan_in", dtype=torch.bfloat16)
    w = init_params({"w": spec}, torch.Generator().manual_seed(4))["w"]
    assert w.shape == (3, 4, 64, 40) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * math.sqrt(64) - 1) < 0.05
    # a row alone past the size: drawn a run of single entries at a time
    row = base.ParamSpec((2, 4096), (None, None), "normal", 0.02, dtype=torch.float32)
    r = init_params({"w": row}, torch.Generator().manual_seed(5))["w"]
    assert r.shape == (2, 4096) and abs(float(r.std()) / 0.02 - 1) < 0.05
    assert not torch.equal(r[0], r[1])
