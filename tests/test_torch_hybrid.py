"""The port's hybrid decoder (zamba2: a Mamba-2 backbone and one shared
attention block) against the JAX package on the CPU, f32, on zamba2's smoke
config (2 groups of 2 Mamba-2 layers, 4 heads of 16): the parameter tree
and cache layouts, the shared block, loss, prefill and its cache, decode,
decode == a prefill of S + 1, a per-slot decode at per-row positions
against JAX's vmapped B = 1 decodes, the static engine against JAX's, and
the continuous engine's completions against static generates. Weights are
drawn with numpy from the reference's specs and carried across by
``convert.params_from_numpy``.

Tolerances: atol = rtol = 1e-4 (tests/test_torch_transformer.py's), the
K/V cache within 1e-4 of its scale; f32 sums in another order, and
`F.softplus`'s threshold (under 3e-9 relative to ``jax.nn.softplus``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ssm_common import check_loss_and_grads, pair
from repro import configs as jconfigs
from repro.models import get_model as j_get_model
from repro.models import hybrid as jhybrid
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs
from repro_torch.distributed.collectives import TensorParallel
from repro_torch.models import get_model, hybrid, param_shapes
from repro_torch.serving import ContinuousEngine, Engine, Scheduler, ServeConfig
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

ARCH = "zamba2_2_7b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test, as tests/test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _close_scaled(got, want, tol=1e-4):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("get", ["get_config", "get_smoke"])
def test_specs_and_cache_layouts_are_the_references(get):
    """hybrid_specs: every leaf's path, shape and logical axes, the Mamba-2
    leaves stacked [G, per, ...]; the cache's shapes, dtypes and axes as
    `hybrid_cache_specs` gives them, at the published config and the smoke
    one."""
    jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(configs, get)(ARCH)
    jspecs = j_get_model(jcfg).specs
    jleaves = {tuple(str(k.key) for k in p): (tuple(s.shape), tuple(s.axes))
               for p, s in jax.tree_util.tree_flatten_with_path(
                   jspecs, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    tspecs = get_model(tcfg).specs
    tleaves = {p: (tuple(s.shape), tuple(s.axes)) for p, s in tree_flatten(tspecs)}
    assert tleaves == jleaves
    assert param_shapes(tspecs)["groups"]["mamba"]["in_proj"][:2] == (
        jcfg.n_layers // jcfg.shared_attn_every, jcfg.shared_attn_every)
    jshapes, jaxes = jhybrid.hybrid_cache_specs(jcfg, 3, 40)
    tshapes, taxes = hybrid.hybrid_cache_specs(tcfg, 3, 40)
    assert taxes == {k: tuple(v) for k, v in jaxes.items()}
    assert {k: s for k, (s, _) in tshapes.items()} == {k: v.shape for k, v in jshapes.items()}
    assert get_model(tcfg).cache_axes == taxes
    cache = get_model(configs.get_smoke(ARCH)).init_cache_fn(3, 40, device="cpu")
    assert (cache["slot_pos"] == -1).all() and cache["ssm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_loss_prefill_cache_and_decode_match_jax():
    """loss_fn within 1e-5 relative; prefill's last logits within TOL, its
    K/V within 1e-4 of their scale, slot_pos equal, conv and SSM states
    within TOL; three decode steps' logits and caches; decode(prefill(x), t)
    against prefill(x ‖ t) within 5e-3, the reference's bound."""
    jm, jp, tm, tp = pair(ARCH)
    b, s, steps = 2, 37, 3
    toks = _tokens(7, b, s + steps, tm.cfg.vocab)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want, _ = jax.jit(jm.loss_fn)(jp, jax.tree.map(jnp.asarray, batch))
    got, met = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(met["aux"]) == 0
    pad_to = s + steps + 1
    j_lg, j_cache = jax.jit(functools.partial(jm.prefill_fn, pad_to=pad_to))(
        jp, {"tokens": jnp.asarray(toks[:, :s])})
    t_lg, t_cache = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pad_to=pad_to)
    _close(t_lg, j_lg)

    def caches_match():
        assert set(t_cache) == set(j_cache)
        for name in t_cache:
            assert t_cache[name].shape == j_cache[name].shape, name
            if name == "slot_pos":
                np.testing.assert_array_equal(t_cache[name].numpy(), np.asarray(j_cache[name]))
            elif name in ("k", "v"):
                _close_scaled(t_cache[name].numpy(), j_cache[name])
            else:
                _close(t_cache[name], j_cache[name])

    caches_match()
    j_decode = jax.jit(jm.decode_fn)
    for i in range(steps):
        nxt = toks[:, s + i]
        j_step, j_cache = j_decode(jp, j_cache, jnp.asarray(nxt), jnp.int32(s + i))
        t_step, t_cache = tm.decode_fn(tp, t_cache, torch.from_numpy(nxt), s + i)
        _close(t_step, j_step)
        caches_match()
    t_full, _ = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert float((t_step - t_full).abs().max()) < 5e-3


def test_one_attention_launch_a_group_in_a_prefill(monkeypatch):
    """The shared block runs the attention forward once a group in a prefill
    (G = 2 on the smoke config; 9 on Zamba2-2.7B) and never in a decode,
    whose attention is the plain `decode_attention`; its head dim is the
    config's (80 at Zamba2-2.7B's widths)."""
    from repro_torch.models import layers

    _, _, tm, tp = pair(ARCH)
    seen = []
    real = hybrid.flash_attention

    def count(q, k, v, **kw):
        seen.append(q.shape[-1])
        return real(q, k, v, **kw)

    monkeypatch.setattr(hybrid, "flash_attention", count)
    toks = torch.from_numpy(_tokens(3, 2, 12, tm.cfg.vocab))
    _, cache = tm.prefill_fn(tp, {"tokens": toks}, pad_to=16)
    assert seen == [tm.cfg.hd] * 2
    tm.decode_fn(tp, cache, toks[:, 0], 12)
    assert len(seen) == 2
    assert configs.get_config(ARCH).hd == 80 and hybrid.flash_attention is count
    assert layers.flash_attention is real


def test_decode_writes_every_state_in_place():
    """A decode step writes K/V, the conv and the SSM states into the cache's
    own tensors (their addresses kept); only slot_pos is new."""
    _, _, tm, tp = pair(ARCH)
    toks = torch.from_numpy(_tokens(4, 2, 9, tm.cfg.vocab))
    _, cache = tm.prefill_fn(tp, {"tokens": toks}, pad_to=12)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    _, out = tm.decode_fn(tp, cache, toks[:, 0], 9)
    assert {k: out[k].data_ptr() == ptrs[k] for k in ptrs} == {
        "k": True, "v": True, "conv": True, "ssm": True, "slot_pos": False}
    assert all(not torch.equal(out[k], before[k]) for k in ptrs)


def test_per_slot_decode_matches_jax_vmap():
    """Prompts of two lengths admitted into three slots of both engines, then
    one decode at per-slot positions [N] (slot_pos [N, Sc]) against JAX's
    vmapped B = 1 decode: logits, K/V, conv and SSM states."""
    jm, jp, tm, tp = pair(ARCH)
    lengths = (8, 21, 8)
    scfg = dict(max_new=3)
    jeng = JContinuousEngine(jm, JServeConfig(**scfg), num_slots=3, max_prompt_len=21)
    teng = ContinuousEngine(tm, ServeConfig(**scfg), num_slots=3, max_prompt_len=21,
                            device="cpu")
    js, ts = jeng.init_state(), teng.init_state()
    assert ts["cache"]["slot_pos"].shape == (3, teng.capacity)
    assert ts["cache"]["conv"].shape[2] == ts["cache"]["k"].shape[1] == 3
    for slot, n in enumerate(lengths):
        p = _tokens(60 + slot, 1, n, tm.cfg.vocab)
        js, jt = jeng.prefill_into_slot(jp, js, {"tokens": jnp.asarray(p)}, slot)
        ts, tt = teng.prefill_into_slot(tp, ts, {"tokens": torch.from_numpy(p)}, slot)
        assert tt == jt

    def decode_one(params, cache, tok, pos):
        return jm.decode_fn(params, cache, tok, pos)

    j_lg, j_cache = jax.jit(jax.vmap(decode_one, in_axes=(None, 0, 0, 0)))(
        jp, js["cache"], js["tok"][:, None], js["pos"])
    t_lg, t_cache = tm.decode_fn(tp, ts["cache"], ts["tok"], ts["pos"])
    _close(t_lg, np.asarray(j_lg)[:, 0])
    # JAX [N, ..., 1, ...] (a B = 1 cache a slot); the port's slot axis in place of B
    for name, axis in (("k", 1), ("v", 1), ("conv", 2), ("ssm", 2)):
        want = np.moveaxis(np.squeeze(np.asarray(j_cache[name]), axis + 1), 0, axis)
        if name in ("k", "v"):
            _close_scaled(t_cache[name].numpy(), want)
        else:
            _close(t_cache[name], want)
    np.testing.assert_array_equal(t_cache["slot_pos"].numpy(), np.asarray(j_cache["slot_pos"]))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(remat):
    """loss_fn and the gradient of every leaf against ``jax.value_and_grad``
    of the reference's loss_fn, with remat off and on (each layer under
    checkpoint), through the shared attention block (the backward's twin at D = 16) and SSD: the
    loss within 1e-5 relative, each leaf within 1e-4 of its largest |g|."""
    check_loss_and_grads(ARCH, remat, seed=12)


def test_remat_gives_the_same_loss_and_gradients():
    """With remat each Mamba-2 layer runs under torch.utils.checkpoint: the
    same loss and the same gradient of every leaf (the shared block's
    attention through the backward's twin) as without."""
    import dataclasses

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


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

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
    """More requests than slots (slots reused, the whole row of every cache
    leaf replaced at admission: K/V and slot_pos, and the conv and SSM
    states over axis 2): every completion equals its static B = 1
    generate."""
    _, _, tm, tp = pair(ARCH)
    lengths = (9, 21, 2, 14, 30, 9)
    prompts = [np.random.default_rng(70 + i).integers(0, tm.cfg.vocab, (n,)).astype(np.int32)
               for i, n in enumerate(lengths)]
    scfg = ServeConfig(max_new=5)
    eng = ContinuousEngine(tm, scfg, num_slots=slots, max_prompt_len=max(lengths),
                           device="cpu")
    sched = Scheduler(eng, tp)
    rids = [sched.submit(torch.from_numpy(p)) for p in prompts]
    sched.run(timeout=600)
    for rid, p in zip(rids, prompts):
        want = Engine(tm, scfg).generate(tp, {"tokens": torch.from_numpy(p)[None]})[0]
        assert sched.poll(rid).tokens == want.tolist()
