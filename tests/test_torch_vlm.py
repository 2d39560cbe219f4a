"""The port's VLM (Qwen2-VL: the dense GQA decoder with a vision prefix and
M-RoPE) against the JAX package on the CPU, f32, on qwen2-vl's smoke config
(2 layers, 4 heads over 2 of 32, sections (4, 6, 6)): the parameter tree and
cache layout, `default_positions`, loss and every gradient, prefill logits
and cache (the prefix's K/V ahead of the text's), decode steps under M-RoPE,
decode == a prefill of S + 1, a per-slot decode at per-row positions
against JAX's vmapped B = 1 decodes, the static engine against JAX's, and
the continuous engine's completions (each request with its own image)
against static generates. Weights are JAX's init with the attention
projections at fan-in over their contraction (tests/test_torch_moe.py's
`_conditioned`), carried across by ``convert.params_from_numpy``; tokens
and patch embeddings come from numpy seeds.

Tolerances: atol = rtol = 1e-4 (tests/test_torch_hybrid.py's), the K/V
cache within 1e-4 of its scale, gradients within 1e-4 of each leaf's
largest entry; positions exactly."""
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
from repro.models import vlm as jvlm
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.launch import serve as launch_serve
from repro_torch.distributed.collectives import TensorParallel
from repro_torch.models import get_model, vlm
from repro_torch.serving import ContinuousEngine, Engine, Scheduler, ServeConfig
from repro_torch.tree import tree_flatten, tree_leaves

ARCH = "qwen2_vl_7b"
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = 1e-4
GRID = (4, 4)
SV = GRID[0] * GRID[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test, as tests/test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conditioned(tree, cfg):
    a, d, h, kh = tree["blocks"]["attn"], cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    scale = {"wq": math.sqrt(h / d), "wk": math.sqrt(kh / d), "wv": math.sqrt(kh / d),
             "wo": 1 / math.sqrt(h)}
    return {**tree, "blocks": {**tree["blocks"], "attn": {
        k: (v * np.float32(scale[k]) if k in scale else v) for k, v in a.items()}}}


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


def _request(seed, b, s, cfg, sv=SV, grid=GRID) -> dict:
    """Tokens, a stub image's patch embeddings at unit scale and the default
    M-RoPE positions, as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "patch_embeds": rng.standard_normal((b, sv, cfg.d_model)).astype(np.float32),
            "positions": np.array(jvlm.default_positions(b, sv, s, grid))}


def _batches(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# layouts and positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("get", ["get_config", "get_smoke"])
def test_specs_and_cache_layout_are_the_references(get):
    """vlm_specs: every leaf's path, shape and logical axes (the dense
    decoder's, untied head); the cache's axes the dense decoder's; no
    chunked prefill."""
    jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(configs, get)(ARCH)
    jm = j_get_model(jcfg)
    jleaves = {tuple(str(k.key) for k in p): (tuple(s.shape), tuple(s.axes))
               for p, s in jax.tree_util.tree_flatten_with_path(
                   jm.specs, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    tm = get_model(tcfg)
    assert {p: (tuple(s.shape), tuple(s.axes)) for p, s in tree_flatten(tm.specs)} == jleaves
    jshapes, jaxes = jm.cache_specs_fn(3, 40)
    assert tm.cache_axes == {k: tuple(v) for k, v in jaxes.items()}
    cache = tm.init_cache_fn(3, 40, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jshapes.items()}
    assert tm.prefill_chunk_fn is None and jm.prefill_chunk_fn is None
    assert tm.inputs == ("tokens", "patch_embeds", "positions")


@pytest.mark.parametrize("sv,s_text,grid", [(16, 9, (4, 4)), (6, 5, (2, 3)), (0, 7, (0, 0)),
                                            (256, 3, (16, 16))])
def test_default_positions_equal_the_references(sv, s_text, grid):
    got = vlm.default_positions(2, sv, s_text, grid, device="cpu")
    want = np.asarray(jvlm.default_positions(2, sv, s_text, grid))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (2, sv + s_text, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="grid"):
        vlm.default_positions(1, sv + 1, s_text, grid, device="cpu")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_loss_and_every_gradient_match_jax():
    """loss_fn within 1e-5 relative (the text positions' CE, the prefix
    predicting nothing) and every leaf's gradient within GRAD_TOL of the
    leaf's largest |g| of ``jax.value_and_grad`` of the reference's loss."""
    jm, jp, tm, _ = _pair()
    req = _request(5, 2, 33, tm.cfg)
    req["positions"] = np.array(jvlm.default_positions(2, SV, 32, GRID))
    batch = {**req, "tokens": req["tokens"][:, :-1], "targets": req["tokens"][:, 1:]}
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


def test_prefill_cache_and_decode_match_jax():
    """Prefill's last logits within TOL, its K/V over prefix + text (padded
    to pad_to) within 1e-4 of their scale, slot_pos equal; three decode
    steps at prompt + prefix onwards (every M-RoPE stream at the decode
    position) against JAX's."""
    jm, jp, tm, tp = _pair()
    b, s, steps = 2, 21, 3
    req = _request(7, b, s + steps, tm.cfg)
    jb, tb = _batches({"tokens": req["tokens"][:, :s], "patch_embeds": req["patch_embeds"],
                       "positions": req["positions"][:, :SV + s]})
    pad_to = SV + s + steps + 1
    j_lg, j_cache = jax.jit(functools.partial(jm.prefill_fn, pad_to=pad_to))(jp, jb)
    t_lg, t_cache = tm.prefill_fn(tp, tb, pad_to=pad_to)
    _close(t_lg, j_lg)

    def caches_match():
        assert set(t_cache) == set(j_cache)
        for name in t_cache:
            assert t_cache[name].shape == j_cache[name].shape, name
            if name == "slot_pos":
                np.testing.assert_array_equal(t_cache[name].numpy(), np.asarray(j_cache[name]))
            else:
                _close_scaled(t_cache[name].numpy(), j_cache[name])

    caches_match()
    j_decode = jax.jit(jm.decode_fn)
    for i in range(steps):
        nxt = req["tokens"][:, s + i]
        j_step, j_cache = j_decode(jp, j_cache, jnp.asarray(nxt), jnp.int32(SV + s + i))
        t_step, t_cache = tm.decode_fn(tp, t_cache, torch.from_numpy(nxt), SV + s + i)
        _close(t_step, j_step)
        caches_match()


def test_decode_equals_prefill_of_s_plus_one():
    """decode(prefill(x), t) at position prompt + prefix against prefill(x ‖
    t) with the positions of S + 1 text tokens, three steps, within TOL."""
    _, _, tm, tp = _pair()
    s, steps = 18, 3
    req = {k: torch.from_numpy(v) for k, v in _request(9, 2, s + steps, tm.cfg).items()}
    pe = req["patch_embeds"]
    _, cache = tm.prefill_fn(tp, {"tokens": req["tokens"][:, :s], "patch_embeds": pe,
                                  "positions": req["positions"][:, :SV + s]},
                             pad_to=SV + s + steps)
    for i in range(steps):
        lg, cache = tm.decode_fn(tp, cache, req["tokens"][:, s + i], SV + s + i)
        full, _ = tm.prefill_fn(tp, {"tokens": req["tokens"][:, :s + i + 1], "patch_embeds": pe,
                                     "positions": req["positions"][:, :SV + s + i + 1]})
        _close(lg, full)


def test_per_slot_decode_matches_jax_vmap():
    """Requests of two prompt lengths, each with its own image, admitted
    into three slots of both engines (capacity with max_prefix), then one
    decode at per-slot positions [N] (M-RoPE positions [N, 1, 3]) against
    JAX's vmapped B = 1 decode: logits and K/V."""
    jm, jp, tm, tp = _pair()
    lengths = (8, 21, 8)
    scfg = dict(max_new=3)
    jeng = JContinuousEngine(jm, JServeConfig(**scfg), num_slots=3, max_prompt_len=21,
                             max_prefix=SV)
    teng = ContinuousEngine(tm, ServeConfig(**scfg), num_slots=3, max_prompt_len=21,
                            max_prefix=SV, device="cpu")
    assert teng.capacity == jeng.capacity == 21 + SV + 4
    js, ts = jeng.init_state(), teng.init_state()
    for slot, n in enumerate(lengths):
        jb, tb = _batches(_request(60 + slot, 1, n, tm.cfg))
        js, jt = jeng.prefill_into_slot(jp, js, jb, slot)
        ts, tt = teng.prefill_into_slot(tp, ts, tb, slot)
        assert tt == jt
    assert ts["pos"].tolist() == [SV + n for n in lengths]

    def decode_one(params, cache, tok, pos):
        return jm.decode_fn(params, cache, tok, pos)

    j_lg, j_cache = jax.jit(jax.vmap(decode_one, in_axes=(None, 0, 0, 0)))(
        jp, js["cache"], js["tok"][:, None], js["pos"])
    t_lg, t_cache = tm.decode_fn(tp, ts["cache"], ts["tok"], ts["pos"])
    _close(t_lg, np.asarray(j_lg)[:, 0])
    for name in ("k", "v"):
        want = np.moveaxis(np.squeeze(np.asarray(j_cache[name]), 2), 0, 1)
        _close_scaled(t_cache[name].numpy(), want)
    np.testing.assert_array_equal(t_cache["slot_pos"].numpy(), np.asarray(j_cache["slot_pos"]))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_image", [True, False])
def test_static_engine_tokens_equal_jax(with_image):
    """Greedy `Engine.generate`, B 2 x prompt 16 x 8 new, token for token
    against JAX's `Engine`: with an image (the first decode at 16 + 16)
    and text alone (positions of the text only)."""
    jm, jp, tm, tp = _pair()
    req = _request(21, 2, 16, tm.cfg)
    if not with_image:
        req = {"tokens": req["tokens"],
               "positions": np.array(jvlm.default_positions(2, 0, 16, (0, 0)))}
    jb, tb = _batches(req)
    want = np.asarray(JEngine(jm, JServeConfig(max_new=8)).generate(jp, jb))
    got = Engine(tm, ServeConfig(max_new=8)).generate(tp, tb)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slots", [1, 3])
def test_continuous_completions_equal_static_generates(slots):
    """More requests than slots, each with its own image (slots reused, the
    whole row replaced at admission; two grids, so two prefix lengths):
    every completion equals its static B = 1 generate."""
    _, _, tm, tp = _pair()
    specs = [(9, 16, (4, 4)), (21, 6, (2, 3)), (2, 16, (4, 4)), (14, 6, (2, 3)), (9, 16, (4, 4))]
    reqs = [{k: torch.from_numpy(v) for k, v in _request(70 + i, 1, n, tm.cfg, sv, g).items()}
            for i, (n, sv, g) in enumerate(specs)]
    scfg = ServeConfig(max_new=5)
    eng = ContinuousEngine(tm, scfg, num_slots=slots, max_prompt_len=21, max_prefix=SV,
                           device="cpu")
    sched = Scheduler(eng, tp)
    rids = [sched.submit(r["tokens"][0], extras={k: r[k] for k in ("patch_embeds", "positions")})
            for r in reqs]
    sched.run(timeout=600)
    for rid, r in zip(rids, reqs):
        want = Engine(tm, scfg).generate(tp, r)[0]
        assert sched.poll(rid).tokens == want.tolist()


def test_requeued_request_replays_with_its_image():
    """max_slot_steps 3 under max_new 6: the request is evicted after 3
    steps and requeued; its second admission reads the image and positions
    it was submitted with (its extras ride in the request), so both
    attempts emit the static generate's tokens."""
    _, _, tm, tp = _pair()
    scfg = ServeConfig(max_new=6)
    r = {k: torch.from_numpy(v) for k, v in _request(50, 1, 8, tm.cfg).items()}
    eng = ContinuousEngine(tm, scfg, num_slots=1, max_prompt_len=8, max_prefix=SV,
                           device="cpu")
    sched = Scheduler(eng, tp, max_slot_steps=3, max_requeues=1)
    rid = sched.submit(r["tokens"][0], extras={k: r[k] for k in ("patch_embeds", "positions")})
    attempts = []
    while rid not in sched.results:
        sched.step()
        if sched.running:
            attempts.append(list(sched.running[0][1]))
    done = sched.poll(rid)
    want = Engine(tm, scfg).generate(tp, r)[0].tolist()
    assert done.finish_reason == "evicted" and sched.steps == 6
    assert len(attempts) == 4 and attempts[1] == attempts[3] == want[:3]
    assert done.tokens == want[:4] and not sched.running and sched.free == [0]


def test_refusals():
    """A batch without positions, chunked prefill, positions that miss the
    prefix, a prompt past the capacity, and the launcher's --stream all
    raise; a dense decoder refuses patch_embeds (the reference would take
    them as a prefix: ROADMAP §3); training on a one-rank `TensorParallel`
    gives the plain loss bit for bit (training across ranks:
    test_torch_distributed_nondense.py)."""
    _, _, tm, tp = _pair()
    r = {k: torch.from_numpy(v) for k, v in _request(3, 1, 8, tm.cfg).items()}
    with pytest.raises(ValueError, match="positions"):
        tm.prefill_fn(tp, {"tokens": r["tokens"], "patch_embeds": r["patch_embeds"]})
    batch = {**r, "targets": r["tokens"]}
    assert torch.equal(tm.loss_fn(tp, batch, tp=TensorParallel())[0], tm.loss_fn(tp, batch)[0])
    with pytest.raises(ValueError, match="no chunked prefill"):
        ContinuousEngine(tm, ServeConfig(max_new=4), 2, 32, prefill_chunk=8, device="cpu")
    eng = ContinuousEngine(tm, ServeConfig(max_new=4), 2, 8, max_prefix=SV, device="cpu")
    state = eng.init_state()
    with pytest.raises(ValueError, match="do not cover"):
        eng.prefill_into_slot(tp, state, {**r, "positions": r["positions"][:, SV:]}, 0)
    with pytest.raises(ValueError, match="capacity"):
        big = {k: torch.from_numpy(v) for k, v in _request(3, 1, 9, tm.cfg, 20, (4, 5)).items()}
        eng.prefill_into_slot(tp, state, big, 0)
    with pytest.raises(ValueError, match="max_prefix"):
        ContinuousEngine(tm, ServeConfig(max_new=4), 2, 8, max_prefix=-1, device="cpu")
    dense = get_model(configs.get_smoke("tinyllama_1_1b"))
    with pytest.raises(ValueError, match=r"reads no \['patch_embeds', 'positions'\]"):
        Engine(dense, ServeConfig(max_new=2)).generate(None, r)
    assert eng.supports_chunked_prefill(r) is False
    with pytest.raises(SystemExit, match="--stream"):
        launch_serve.main(["--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu", "--stream"])


def test_launcher_builds_the_image_inputs_and_serves():
    """build_batch draws 16 stub patch embeddings of a 4 x 4 grid and their
    default M-RoPE positions (the reference launcher's), or a 16 x 16 grid's
    256; the static launcher serves the smoke config."""
    cfg = configs.get_smoke(ARCH)
    batch = launch_serve.build_batch(cfg, torch.Generator().manual_seed(0), 3, 5)
    assert set(batch) == {"tokens", "patch_embeds", "positions"}
    assert batch["patch_embeds"].shape == (3, 16, cfg.d_model)
    np.testing.assert_array_equal(batch["positions"].numpy(),
                                  np.asarray(jvlm.default_positions(3, 16, 5, (4, 4))))
    big = launch_serve.build_batch(cfg, torch.Generator().manual_seed(0), 1, 5, (16, 16))
    assert big["positions"].shape == (1, 261, 3) and int(big["positions"][0, 255, 2]) == 15
    toks = launch_serve.main(["--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    assert tuple(toks.shape) == (2, 3)
