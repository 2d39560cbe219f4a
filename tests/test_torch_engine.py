"""The port's static-batch engine against the JAX package's `Engine`:
greedy tokens equal on the tinyllama and smollm smoke configs at two prompt
lengths, with and without EOS freezing (f32, JAX's weights carried over by
``convert.params_from_numpy``); the bf16 round trip of the converter bit for
bit; temperature sampling from an explicit generator; and the launcher on
the CPU, static and ``--stream``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as j_get_model
from repro.models import init_params as j_init_params
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model
from repro_torch.serving import Engine, ServeConfig


def _pair(arch):
    jm = j_get_model(jconfigs.get_smoke(arch))
    jp = j_init_params(jax.random.PRNGKey(1), jm.specs)
    return jm, jp, get_model(configs.get_smoke(arch)), convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "smollm_360m"])
def test_greedy_tokens_equal_jax_at_two_prompt_lengths_and_with_eos(arch):
    jm, jp, tm, tp = _pair(arch)
    new = 6
    for s in (16, 33):
        toks = np.random.default_rng(s).integers(0, tm.cfg.vocab, (2, s)).astype(np.int32)
        want = np.asarray(JEngine(jm, JServeConfig(max_new=new)).generate(
            jp, {"tokens": jnp.asarray(toks)}))
        got = Engine(tm, ServeConfig(max_new=new)).generate(
            tp, {"tokens": torch.from_numpy(toks)}).numpy()
        np.testing.assert_array_equal(got, want)
        # EOS = row 0's third token: row 0 freezes there, in both engines
        eos = int(want[0, 2])
        want_e = np.asarray(JEngine(jm, JServeConfig(max_new=new, eos_id=eos)).generate(
            jp, {"tokens": jnp.asarray(toks)}))
        got_e = Engine(tm, ServeConfig(max_new=new, eos_id=eos)).generate(
            tp, {"tokens": torch.from_numpy(toks)}).numpy()
        np.testing.assert_array_equal(got_e, want_e)
        first = int(np.argmax(got_e[0] == eos))
        assert (got_e[0, first:] == eos).all()


def test_bf16_params_round_trip_bit_for_bit():
    cfg = dataclasses.replace(jconfigs.get_smoke("tinyllama_1_1b"), dtype=jnp.bfloat16)
    jp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(3), j_get_model(cfg).specs))
    tp = convert.params_from_numpy(jp, "cpu")
    assert tp["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    back = convert.to_numpy(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        b = flat_b[path]
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b.view(np.uint16), a.view(np.uint16))
    # the port computes on the bf16 tensors themselves
    assert torch.equal(tp["embed"].float(), torch.from_numpy(jp["embed"].astype(np.float32)))


def test_temperature_sampling_draws_from_the_generator():
    tm = get_model(configs.get_smoke("tinyllama_1_1b"))
    from repro_torch.models import init_params
    tp = init_params(tm.specs, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, tm.cfg.vocab, (2, 12),
                                     generator=torch.Generator().manual_seed(1))}
    eng = Engine(tm, ServeConfig(max_new=5, temperature=1.0))
    a = eng.generate(tp, batch, torch.Generator().manual_seed(7))
    b = eng.generate(tp, batch, torch.Generator().manual_seed(7))
    assert a.shape == (2, 5) and a.dtype == torch.int32 and torch.equal(a, b)
    assert ((a >= 0) & (a < tm.cfg.vocab)).all()
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(tp, batch)


def test_launch_serve_smoke_on_the_cpu(capsys):
    toks = launch_serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "16", "--max-new", "4"])
    assert toks.shape == (2, 4)
    assert "generated (2, 4) tokens on cpu" in capsys.readouterr().out
    # --stream: the seeded Poisson trace through the continuous engine
    results = launch_serve.main(["--arch", "tinyllama-1.1b", "--stream", "--smoke", "--device",
                                 "cpu", "--requests", "6", "--rate", "1000", "--slots", "2"])
    assert len(results) == 6 and all(len(c.tokens) == 16 for c in results.values())
    out = capsys.readouterr().out
    assert "warm-up: 3 prompt lengths" in out
    assert "6 requests (lens (32, 64, 128), rate 1000.0/s, 2 slots) on cpu" in out
    assert "96 tokens" in out and "tok/s" in out and "decode steps" in out
    assert "request latency p50" in out and "p95" in out and "max" in out
