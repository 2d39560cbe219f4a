"""The port's dense-decoder stack against the JAX package on the smoke
configs of the four dense decoders (tinyllama, smollm, gemma3, deepseek;
the MoE decoders' counterparts are in tests/test_torch_moe.py, and their
spec trees and configs here),
with JAX's weights carried over by ``convert.params_from_numpy`` and prompts
from numpy seeds: the prefill's last logits within 1e-4 elementwise and its
K/V cache within 1e-4 of its own scale (f32; see `_close_scaled`),
``slot_pos`` equal, one decode step against JAX's, and
``decode(prefill(x), t)`` against ``prefill(x ‖ t)`` within 5e-3 (the bound
tests/test_models.py holds the reference to); and the ring cache of a
pure-window config decoded past its window."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as j_get_model
from repro.models import init_params as j_init_params
from repro.models.base import count_params as j_count_params
from repro_torch import configs, convert
from repro_torch.models import count_params, get_model, init_params
from repro_torch.models import transformer as ttfm

DENSE = ("tinyllama_1_1b", "smollm_360m", "gemma3_1b", "deepseek_coder_33b")
MOE = ("mixtral_8x22b", "kimi_k2")
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(arch, **replace):
    """(JAX model, JAX params, port model, port params) with JAX's weights."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **replace)
    tcfg = dataclasses.replace(configs.get_smoke(arch), **replace)
    jm = j_get_model(jcfg)
    jp = j_init_params(jax.random.PRNGKey(1), jm.specs)
    tm = get_model(tcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _close_scaled(got, want, tol=1e-4):
    """max |got - want| <= tol * max |want|. The reference's init (fan-in
    over the head axis for wq and wk) gives K/V entries up to ~35 and scores
    up to ~160, so layer 1's cache inherits layer 0's attention through a
    very sharp softmax: f32 sum-order differences of ~1e-5 in layer 0's
    projections grow to ~5e-4 on entries of ~1 (1e-5 of the cache's scale)
    between any two f32 implementations. Held to 1e-4 of the scale."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_cache_and_decode_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    b, s = 2, 40
    toks = _tokens(len(arch), b, s + 1, tm.cfg.vocab)
    pad_to = s + 4
    j_lg, j_cache = jax.jit(functools.partial(jm.prefill_fn, pad_to=pad_to))(
        jp, {"tokens": jnp.asarray(toks[:, :s])})
    t_lg, t_cache = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pad_to=pad_to)
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), **TOL)
    for name in ("k", "v"):
        assert t_cache[name].shape == j_cache[name].shape
        _close_scaled(t_cache[name].numpy(), j_cache[name])
    np.testing.assert_array_equal(t_cache["slot_pos"].numpy(), np.asarray(j_cache["slot_pos"]))

    nxt = toks[:, s]
    j_step, _ = jax.jit(jm.decode_fn)(jp, j_cache, jnp.asarray(nxt), jnp.int32(s))
    t_step, t_cache = tm.decode_fn(tp, t_cache, torch.from_numpy(nxt), s)
    np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step), **TOL)
    assert t_cache["slot_pos"][s] == s and (t_cache["slot_pos"][s + 1:] == -1).all()
    t_full, _ = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert float((t_step - t_full).abs().max()) < 5e-3
    # an empty cache of the same layout as the reference's
    j_empty, t_empty = jm.init_cache_fn(b, pad_to), tm.init_cache_fn(b, pad_to, device="cpu")
    for name in ("k", "v", "slot_pos"):
        assert tuple(t_empty[name].shape) == tuple(j_empty[name].shape)
        np.testing.assert_array_equal(t_empty[name].numpy(), np.asarray(j_empty[name]))


def test_ring_cache_decoded_past_the_window_matches_jax():
    """Tinyllama's smoke config with every layer windowed at 64: S = 96 fills
    a 64-slot ring (slot = pos % 64), and three decodes wrap it further."""
    jm, jp, tm, tp = _pair("tinyllama_1_1b", window_pattern=(64, 64))
    b, s, extra = 1, 96, 3
    toks = _tokens(7, b, s + extra, tm.cfg.vocab)
    _, j_cache = jax.jit(jm.prefill_fn)(jp, {"tokens": jnp.asarray(toks[:, :s])})
    _, t_cache = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks[:, :s])})
    assert t_cache["k"].shape[2] == 64
    np.testing.assert_array_equal(t_cache["slot_pos"].numpy(), np.asarray(j_cache["slot_pos"]))
    _close_scaled(t_cache["k"].numpy(), j_cache["k"])
    _close_scaled(t_cache["v"].numpy(), j_cache["v"])
    for i in range(extra):
        tok = toks[:, s + i]
        j_lg, j_cache = jax.jit(jm.decode_fn)(jp, j_cache, jnp.asarray(tok), jnp.int32(s + i))
        t_lg, t_cache = tm.decode_fn(tp, t_cache, torch.from_numpy(tok), s + i)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), **TOL)
        np.testing.assert_array_equal(t_cache["slot_pos"].numpy(),
                                      np.asarray(j_cache["slot_pos"]))
    t_ref, _ = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert float((t_lg - t_ref).abs().max()) < 5e-3


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_specs_match_the_reference_tree(arch):
    """Same key paths, shapes and parameter count as the JAX spec tree, at the
    smoke and the published sizes; the port's own init draws every leaf (the
    MoE decoders' ``mlp.wg`` is the experts' leaf [L, E, d, f], fan-in over
    d as the dense one's)."""
    for jcfg, tcfg in ((jconfigs.get_smoke(arch), configs.get_smoke(arch)),
                       (jconfigs.get_config(arch), configs.get_config(arch))):
        jshapes = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
                   jax.tree_util.tree_flatten_with_path(
                       j_get_model(jcfg).specs,
                       is_leaf=lambda x: hasattr(x, "axes"))[0]}
        tspecs = get_model(tcfg).specs

        def walk(t, pre=""):
            for k, v in t.items():
                yield from (walk(v, f"{pre}['{k}']") if isinstance(v, dict) else
                            [(f"{pre}['{k}']", tuple(v.shape))])

        assert dict(walk(tspecs)) == jshapes
        assert count_params(tspecs) == j_count_params(j_get_model(jcfg).specs)
    params = init_params(get_model(configs.get_smoke(arch)).specs,
                         torch.Generator().manual_seed(0))
    leaves = dict(walk(params))
    assert leaves == dict(walk(get_model(configs.get_smoke(arch)).specs))
    assert params["blocks"]["ln1"].abs().sum() == 0            # zeros: gains start at 0
    w = params["blocks"]["mlp"]["wg"]                           # fan_in: std 1/sqrt(d)
    assert abs(float(w.std()) * configs.get_smoke(arch).d_model ** 0.5 - 1) < 0.05


def test_configs_registry():
    assert configs.get_config("tinyllama-1.1b").n_layers == 22
    assert configs.get_config("tinyllama-1.1b").dtype == torch.bfloat16
    assert configs.get_smoke("gemma3-1b").dtype == torch.float32
    # the enc-dec and VLM configs load, equal to JAX's field for field below
    whisper, qwen = configs.get_config("whisper-tiny"), configs.get_config("qwen2-vl-7b")
    assert (whisper.kind, whisper.n_enc_layers, whisper.enc_seq) == ("encdec", 4, 1500)
    assert (qwen.kind, qwen.mrope_sections, qwen.hd) == ("vlm", (16, 24, 24), 128)
    assert sum(qwen.mrope_sections) == qwen.hd // 2
    assert configs.ENCDEC == ("whisper_tiny",) and configs.VLM == ("qwen2_vl_7b",)
    assert set(DENSE + MOE + configs.SSM + configs.ENCDEC + configs.VLM) == set(configs.ARCHS)
    with pytest.raises(KeyError):
        configs.get_config("llama-9000")
    assert configs.ARCHS == jconfigs.ARCHS
    for arch in configs.ARCHS:
        for j, t in ((jconfigs.get_config(arch), configs.get_config(arch)),
                     (jconfigs.get_smoke(arch), configs.get_smoke(arch))):
            for f in dataclasses.fields(t):
                if f.name in ("moe", "ssm"):   # the two packages' settings, field for field
                    jt, tt = getattr(j, f.name), getattr(t, f.name)
                    assert (tt is None) == (jt is None), (arch, f.name)
                    if tt is not None:
                        assert dataclasses.asdict(tt) == dataclasses.asdict(jt), (arch, f.name)
                elif f.name != "dtype":
                    assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
            assert (t.windows, t.max_window) == (j.windows, j.max_window)
            if t.n_heads:               # falcon-mamba has no heads
                assert t.hd == j.hd
    assert configs.get_config("kimi-k2").hd == 112
    assert configs.get_config("mixtral-8x22b").max_window == 4096
    assert configs.get_config("zamba2-2.7b").hd == 80
    assert configs.get_config("falcon-mamba-7b").ssm.kind == "mamba1"
    for arch in configs.SSM + configs.ENCDEC + configs.VLM:
        get_model(configs.get_config(arch))


def test_empty_cache_defaults_to_the_card(monkeypatch):
    """The KV cache goes where every entry point goes: the card unless the
    caller asks for the CPU, and an error, not the CPU, when no card is
    present (here made absent for the test's duration)."""
    cfg = configs.get_smoke("tinyllama-1.1b")
    model = get_model(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache_fn(2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttfm.init_cache(cfg, 2, 8)
    cache = model.init_cache_fn(2, 8, device="cpu")
    assert all(t.device.type == "cpu" for t in cache.values())
    assert cache["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
