"""The port's encoder-decoder (Whisper) against the JAX package on the CPU,
f32, on whisper-tiny's smoke config (2 encoder + 2 decoder layers, 2 heads
of 32, 64 frames): the parameter tree and cache layouts, the sinusoid
positions, loss and every gradient (the non-causal cross-attention with
Sq != Skv through the attention backward's twin), prefill logits and its
caches (self K/V padded, cross K/V not), decode steps, decode == a prefill
of S + 1, a per-slot decode at per-row positions against JAX's vmapped
B = 1 decodes, the static engine against JAX's, and the continuous
engine's completions (each request with its own frames) against static
generates. Weights are JAX's init with the attention projections at fan-in
over their contraction (`_conditioned`), carried across by
``convert.params_from_numpy``; tokens and frames come from numpy seeds.

Tolerances: atol = rtol = 1e-4 (tests/test_torch_hybrid.py's), caches
within 1e-4 of their scale, gradients within 1e-4 of each leaf's largest
entry (tests/test_torch_moe.py's); f32 sums in another order."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as jencdec
from repro.models import get_model as j_get_model
from repro.models import init_params as j_init_params
from repro.models import layers as jlayers
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.launch import serve as launch_serve
from repro_torch.distributed.collectives import TensorParallel
from repro_torch.models import encdec, get_model, init_params, layers
from repro_torch.serving import ContinuousEngine, Engine, Scheduler, ServeConfig
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

ARCH = "whisper_tiny"
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test, as tests/test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conditioned(tree, cfg):
    """JAX's tree (numpy) with every attention projection (the encoder's,
    the decoder's self- and cross-attention) at fan-in over the axes it
    contracts, as tests/test_torch_moe.py conditions the dense stack: at the
    reference's init the attention is near-hard and two implementations
    that round apart part by more than the tolerance."""
    d, h, kh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    scale = {"wq": math.sqrt(h / d), "wk": math.sqrt(kh / d), "wv": math.sqrt(kh / d),
             "wo": 1 / math.sqrt(h)}

    def fix(a):
        return {k: v * np.float32(scale[k]) for k, v in a.items()}

    enc, dec = tree["enc_blocks"], tree["dec_blocks"]
    return {**tree, "enc_blocks": {**enc, "attn": fix(enc["attn"])},
            "dec_blocks": {**dec, "attn": fix(dec["attn"]), "xattn": fix(dec["xattn"])}}


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX model, JAX params as numpy, port model, port params)."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jm = j_get_model(jcfg)
    jp = _conditioned(jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(1), jm.specs)),
                      jcfg)
    return jm, jp, get_model(tcfg), convert.params_from_numpy(jp, "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _close_scaled(got, want, tol=1e-4):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _frames(seed, b, cfg):
    """Stub frontend output [b, enc_seq, d] at unit scale (at the launcher's
    0.02 the sinusoid would swamp the frames and every row look alike)."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _batches(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# layouts and positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("get", ["get_config", "get_smoke"])
def test_specs_and_cache_layouts_are_the_references(get):
    """encdec_specs: every leaf's path, shape and logical axes (the decoder's
    cross-attention and its norm beside the self-attention); the cache's
    shapes, dtypes and axes as `encdec_cache_specs` gives them, ck/cv over
    the config's enc_seq frames, at the published config and the smoke one."""
    jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(configs, get)(ARCH)
    jleaves = {tuple(str(k.key) for k in p): (tuple(s.shape), tuple(s.axes))
               for p, s in jax.tree_util.tree_flatten_with_path(
                   j_get_model(jcfg).specs, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    tleaves = {p: (tuple(s.shape), tuple(s.axes)) for p, s in tree_flatten(
        get_model(tcfg).specs)}
    assert tleaves == jleaves
    jshapes, jaxes = jencdec.encdec_cache_specs(jcfg, 3, 40)
    tshapes, taxes = encdec.encdec_cache_specs(tcfg, 3, 40)
    assert taxes == {k: tuple(v) for k, v in jaxes.items()}
    assert {k: s for k, (s, _) in tshapes.items()} == {k: v.shape for k, v in jshapes.items()}
    assert get_model(tcfg).cache_axes == taxes
    assert tshapes["ck"][0][2] == tcfg.enc_seq == jcfg.enc_seq
    cache = get_model(configs.get_smoke(ARCH)).init_cache_fn(3, 40, device="cpu")
    assert (cache["slot_pos"] == -1).all() and cache["ck"].shape == (2, 3, 64, 2, 32)
    assert get_model(tcfg).prefill_chunk_fn is None


@pytest.mark.parametrize("seq,d", [(64, 64), (1500, 384), (7, 10)])
def test_sinusoid_positions_match_jax(seq, d):
    got = layers.sinusoid_positions(seq, d).numpy()
    want = np.asarray(jlayers.sinusoid_positions(seq, d))
    assert got.shape == want.shape == (seq, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-6 * seq, rtol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_loss_and_every_gradient_match_jax():
    """loss_fn within 1e-5 relative and every leaf's gradient within GRAD_TOL
    of the leaf's largest |g| of ``jax.value_and_grad`` of the reference's
    loss: the encoder's non-causal attention over 64 frames, the decoder's
    causal self-attention and its cross-attention (Sq 31, Skv 64) through
    the attention backward's twin."""
    jm, jp, tm, _ = _pair()
    toks = _tokens(5, 2, 32, tm.cfg.vocab)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "frames": _frames(5, 2, tm.cfg)}
    jb, tb = _batches(batch)
    (want, _), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, jb)
    params = convert.params_from_numpy(jp, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    got, met = tm.loss_fn(params, tb)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(met["aux"]) == 0
    jl = {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    paths = [p for p, _ in tree_flatten(params)]
    assert set(paths) == set(jl)
    for path, g in zip(paths, grads):
        jg = jl[path]
        assert float(np.abs(jg).max()) > 0, path
        np.testing.assert_allclose(g.numpy(), jg, atol=GRAD_TOL * float(np.abs(jg).max()),
                                   rtol=0, err_msg=str(path))


def test_prefill_caches_and_decode_match_jax():
    """Prefill's last logits within TOL; its self K/V (padded to pad_to) and
    cross K/V (64 frames, not padded) within 1e-4 of their scale, slot_pos
    equal; three decode steps' logits and caches against JAX's."""
    jm, jp, tm, tp = _pair()
    b, s, steps = 2, 21, 3
    toks = _tokens(7, b, s + steps, tm.cfg.vocab)
    jb, tb = _batches({"tokens": toks[:, :s], "frames": _frames(7, b, tm.cfg)})
    pad_to = s + steps + 1
    j_lg, j_cache = jax.jit(functools.partial(jm.prefill_fn, pad_to=pad_to))(jp, jb)
    t_lg, t_cache = tm.prefill_fn(tp, tb, pad_to=pad_to)
    _close(t_lg, j_lg)

    def caches_match():
        assert set(t_cache) == set(j_cache) == {"k", "v", "ck", "cv", "slot_pos"}
        for name in t_cache:
            assert t_cache[name].shape == j_cache[name].shape, name
            if name == "slot_pos":
                np.testing.assert_array_equal(t_cache[name].numpy(), np.asarray(j_cache[name]))
            else:
                _close_scaled(t_cache[name].numpy(), j_cache[name])

    caches_match()
    assert t_cache["k"].shape[2] == pad_to and t_cache["ck"].shape[2] == tm.cfg.enc_seq
    j_decode = jax.jit(jm.decode_fn)
    for i in range(steps):
        nxt = toks[:, s + i]
        j_step, j_cache = j_decode(jp, j_cache, jnp.asarray(nxt), jnp.int32(s + i))
        t_step, t_cache = tm.decode_fn(tp, t_cache, torch.from_numpy(nxt), s + i)
        _close(t_step, j_step)
        caches_match()


def test_decode_equals_prefill_of_s_plus_one():
    """decode(prefill(x), t) against prefill(x ‖ t) on the same frames, at
    three consecutive steps, within TOL."""
    _, _, tm, tp = _pair()
    s, steps = 18, 3
    toks = torch.from_numpy(_tokens(9, 2, s + steps, tm.cfg.vocab))
    frames = torch.from_numpy(_frames(9, 2, tm.cfg))
    _, cache = tm.prefill_fn(tp, {"tokens": toks[:, :s], "frames": frames}, pad_to=s + steps)
    for i in range(steps):
        lg, cache = tm.decode_fn(tp, cache, toks[:, s + i], s + i)
        full, _ = tm.prefill_fn(tp, {"tokens": toks[:, :s + i + 1], "frames": frames})
        _close(lg, full)


def test_attention_kernel_calls_a_prefill_and_none_a_decode(monkeypatch):
    """A prefill runs the attention forward once a layer in the encoder
    (non-causal, Sq = Skv = frames) and twice a decoder layer (causal self,
    non-causal cross with Sq = prompt, Skv = frames); a decode step runs
    none (the plain `decode_attention` over both caches). At Whisper-tiny's
    widths that is 12 a generate."""
    _, _, tm, tp = _pair()
    seen = []
    real = encdec.flash_attention

    def count(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(encdec, "flash_attention", count)
    toks = torch.from_numpy(_tokens(3, 2, 12, tm.cfg.vocab))
    frames = torch.from_numpy(_frames(3, 2, tm.cfg))
    _, cache = tm.prefill_fn(tp, {"tokens": toks, "frames": frames}, pad_to=16)
    t = tm.cfg.enc_seq
    assert seen == [(t, t, False)] * 2 + [(12, 12, True), (12, t, False)] * 2
    tm.decode_fn(tp, cache, toks[:, 0], 12)
    assert len(seen) == 6
    full = configs.get_config(ARCH)
    assert full.n_enc_layers + 2 * full.n_layers == 12 and full.hd == 64


def test_decode_writes_self_kv_in_place_and_reads_cross_kv():
    """A decode step writes K/V into the cache's own tensors at the slot;
    the cross K/V stay as the prefill left them; only slot_pos is new."""
    _, _, tm, tp = _pair()
    toks = torch.from_numpy(_tokens(4, 2, 9, tm.cfg.vocab))
    frames = torch.from_numpy(_frames(4, 2, tm.cfg))
    _, cache = tm.prefill_fn(tp, {"tokens": toks, "frames": frames}, pad_to=12)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    before = {k: v.clone() for k, v in cache.items()}
    _, out = tm.decode_fn(tp, cache, toks[:, 0], 9)
    assert {k: out[k].data_ptr() == ptrs[k] for k in ptrs} == {
        "k": True, "v": True, "ck": True, "cv": True, "slot_pos": False}
    assert not torch.equal(out["k"], before["k"]) and not torch.equal(out["v"], before["v"])
    assert torch.equal(out["ck"], before["ck"]) and torch.equal(out["cv"], before["cv"])
    assert out["slot_pos"].tolist() == list(range(10)) + [-1, -1]


def test_per_slot_decode_matches_jax_vmap():
    """Prompts of two lengths, each with its own frames, admitted into three
    slots of both engines, then one decode at per-slot positions [N]
    (slot_pos [N, Sc]) against JAX's vmapped B = 1 decode: logits, self
    K/V, cross K/V (admitted along the batch axis of `cache_axes`)."""
    jm, jp, tm, tp = _pair()
    lengths = (8, 21, 8)
    scfg = dict(max_new=3)
    jeng = JContinuousEngine(jm, JServeConfig(**scfg), num_slots=3, max_prompt_len=21)
    teng = ContinuousEngine(tm, ServeConfig(**scfg), num_slots=3, max_prompt_len=21,
                            device="cpu")
    js, ts = jeng.init_state(), teng.init_state()
    assert ts["cache"]["slot_pos"].shape == (3, teng.capacity)
    assert ts["cache"]["ck"].shape[1] == 3
    for slot, n in enumerate(lengths):
        jb, tb = _batches({"tokens": _tokens(60 + slot, 1, n, tm.cfg.vocab),
                           "frames": _frames(60 + slot, 1, tm.cfg)})
        js, jt = jeng.prefill_into_slot(jp, js, jb, slot)
        ts, tt = teng.prefill_into_slot(tp, ts, tb, slot)
        assert tt == jt

    def decode_one(params, cache, tok, pos):
        return jm.decode_fn(params, cache, tok, pos)

    j_lg, j_cache = jax.jit(jax.vmap(decode_one, in_axes=(None, 0, 0, 0)))(
        jp, js["cache"], js["tok"][:, None], js["pos"])
    t_lg, t_cache = tm.decode_fn(tp, ts["cache"], ts["tok"], ts["pos"])
    _close(t_lg, np.asarray(j_lg)[:, 0])
    # JAX [N, L, 1, ...] (a B = 1 cache a slot); the port's slot axis in place of B
    for name in ("k", "v", "ck", "cv"):
        want = np.moveaxis(np.squeeze(np.asarray(j_cache[name]), 2), 0, 1)
        _close_scaled(t_cache[name].numpy(), want)
    np.testing.assert_array_equal(t_cache["slot_pos"].numpy(), np.asarray(j_cache["slot_pos"]))


def test_remat_gives_the_same_loss_and_gradients():
    """With remat each encoder and decoder layer runs under
    torch.utils.checkpoint: the same loss and the same gradient of every
    leaf as without."""
    import dataclasses

    _, _, tm, tp = _pair()
    toks = torch.from_numpy(_tokens(8, 2, 14, tm.cfg.vocab))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "frames": torch.from_numpy(_frames(8, 2, tm.cfg))}
    out = []
    for remat in (False, True):
        model = get_model(dataclasses.replace(tm.cfg, remat=remat))
        leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(tp)]
        loss, _ = model.loss_fn(tree_unflatten(tp, leaves), batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def test_static_engine_tokens_equal_jax():
    """Greedy `Engine.generate`, B 2 x prompt 16 x 8 new on two clips,
    token for token against JAX's `Engine`."""
    jm, jp, tm, tp = _pair()
    jb, tb = _batches({"tokens": _tokens(21, 2, 16, tm.cfg.vocab),
                       "frames": _frames(21, 2, tm.cfg)})
    want = np.asarray(JEngine(jm, JServeConfig(max_new=8)).generate(jp, jb))
    got = Engine(tm, ServeConfig(max_new=8)).generate(tp, tb)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slots", [1, 3])
def test_continuous_completions_equal_static_generates(slots):
    """More requests than slots, each with its own frames (slots reused, the
    whole row of every cache leaf replaced at admission, the cross K/V
    included): every completion equals its static B = 1 generate."""
    _, _, tm, tp = _pair()
    lengths = (9, 21, 2, 14, 9)
    reqs = [(torch.from_numpy(_tokens(70 + i, 1, n, tm.cfg.vocab)[0]),
             torch.from_numpy(_frames(70 + i, 1, tm.cfg))) for i, n in enumerate(lengths)]
    scfg = ServeConfig(max_new=5)
    eng = ContinuousEngine(tm, scfg, num_slots=slots, max_prompt_len=max(lengths),
                           device="cpu")
    sched = Scheduler(eng, tp)
    rids = [sched.submit(p, extras={"frames": f}) for p, f in reqs]
    sched.run(timeout=600)
    for rid, (p, f) in zip(rids, reqs):
        want = Engine(tm, scfg).generate(tp, {"tokens": p[None], "frames": f})[0]
        assert sched.poll(rid).tokens == want.tolist()


def test_refusals():
    """Chunked prefill, inputs the family does not read, frames the slot's
    cross K/V cannot hold, a batch of two, and the launcher's --stream all
    raise; training on a one-rank `TensorParallel` gives the plain loss bit
    for bit (training across ranks: test_torch_distributed_nondense.py)."""
    _, _, tm, tp = _pair()
    toks = torch.zeros((1, 4), dtype=torch.int32)
    frames = torch.zeros((1, tm.cfg.enc_seq, tm.cfg.d_model))
    batch = {"tokens": toks, "targets": toks,
             "frames": torch.from_numpy(_frames(11, 1, tm.cfg))}
    assert torch.equal(tm.loss_fn(tp, batch, tp=TensorParallel())[0], tm.loss_fn(tp, batch)[0])
    with pytest.raises(ValueError, match="no chunked prefill"):
        ContinuousEngine(tm, ServeConfig(max_new=4), 2, 32, prefill_chunk=8, device="cpu")
    eng = ContinuousEngine(tm, ServeConfig(max_new=4), 2, 8, device="cpu")
    state = eng.init_state()
    with pytest.raises(ValueError, match=r"reads no \['patch_embeds'\]"):
        eng.prefill_into_slot(tp, state, {"tokens": toks, "frames": frames,
                                          "patch_embeds": frames}, 0)
    with pytest.raises(ValueError, match="cross K/V"):
        eng.prefill_into_slot(tp, state, {"tokens": toks, "frames": frames[:, :10]}, 0)
    with pytest.raises(ValueError, match="per request"):
        eng.prefill_into_slot(tp, state, {"tokens": toks.expand(2, 4),
                                          "frames": frames.expand(2, -1, -1)}, 0)
    with pytest.raises(ValueError, match="reads no"):
        Engine(tm, ServeConfig(max_new=2)).generate(tp, {"tokens": toks, "frames": frames,
                                                         "positions": toks})
    with pytest.raises(SystemExit, match="--stream"):
        launch_serve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu", "--stream"])


def test_launcher_builds_frames_and_serves():
    """build_batch draws the stub frames [B, enc_seq, d] in the model's
    dtype beside the tokens; the static launcher serves the smoke config."""
    cfg = configs.get_smoke(ARCH)
    batch = launch_serve.build_batch(cfg, torch.Generator().manual_seed(0), 3, 5)
    assert set(batch) == {"tokens", "frames"}
    assert batch["frames"].shape == (3, cfg.enc_seq, cfg.d_model)
    assert batch["frames"].dtype == cfg.dtype and float(batch["frames"].std()) < 0.05
    toks = launch_serve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    assert tuple(toks.shape) == (2, 3)
    model = get_model(cfg)
    params = init_params(model.specs, torch.Generator().manual_seed(0))
    assert params["enc_blocks"]["attn"]["wq"].shape == (2, 64, 2, 32)
