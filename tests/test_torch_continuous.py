"""The port's continuous LM serving against the JAX package on the smoke
configs (f32, JAX's weights carried over by ``convert.params_from_numpy``,
prompts from numpy seeds): one batched decode step at mixed per-slot
positions against JAX's ``jax.vmap(decode_fn)`` over the same slots (logits
within 1e-4, each slot's k/v within 1e-4 of their scale, slot_pos equal;
on gemma3 past its smoke window of 64, so the per-row window mask is
exercised); ``prefill_chunk_fn`` against JAX's chunk by chunk; the
reference's serving scenarios (tests/test_serving.py:78-202) with the
port's `ContinuousEngine` + `Scheduler` against JAX's and against the port's
static `Engine`, token for token; temperature sampling and a requeued
request's replay on per-slot generators; the engine's refusals and its
device."""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as j_get_model
from repro.models import init_params as j_init_params
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Scheduler as JScheduler
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs, convert
from repro_torch.models import get_model
from repro_torch.serving import (ChunkedPrefill, Completion, ContinuousEngine, Engine,
                                 Request, Scheduler, ServeConfig, slot_update)

TOL = dict(atol=1e-4, rtol=1e-4)          # as tests/test_torch_transformer.py
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX model, JAX params, port model, port params) with JAX's weights."""
    jm = j_get_model(jconfigs.get_smoke(arch))
    jp = j_init_params(jax.random.PRNGKey(1), jm.specs)
    tm = get_model(configs.get_smoke(arch))
    return jm, jp, tm, convert.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _prompts(lengths, vocab, seed0=10):
    return [np.random.default_rng(seed0 + i).integers(0, vocab, (n,)).astype(np.int32)
            for i, n in enumerate(lengths)]


def _close_scaled(got, want, tol=1e-4):
    """max |got - want| <= tol * max |want| (the K/V cache's entries inherit
    f32 sum-order differences through a sharp softmax; see
    tests/test_torch_transformer.py)."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# the model layer: per-slot decode and chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,lengths", [("tinyllama_1_1b", (8, 13, 21)),
                                          ("gemma3_1b", (70, 97, 70))])
def test_per_slot_decode_matches_jax_vmap(arch, lengths):
    """Both engines admit the same prompts into three slots; then one batched
    port decode at per-slot positions [N] against JAX's vmapped decode."""
    jm, jp, tm, tp = _pair(arch)
    new = 3
    scfg = dict(max_new=new)
    prompts = _prompts(lengths, tm.cfg.vocab)
    jeng = JContinuousEngine(jm, JServeConfig(**scfg), num_slots=3,
                             max_prompt_len=max(lengths))
    teng = ContinuousEngine(tm, ServeConfig(**scfg), num_slots=3,
                            max_prompt_len=max(lengths), device=CPU)
    js, ts = jeng.init_state(), teng.init_state()
    for slot, p in enumerate(prompts):
        js, jt = jeng.prefill_into_slot(jp, js, {"tokens": jnp.asarray(p)[None]}, slot)
        ts, tt = teng.prefill_into_slot(tp, ts, {"tokens": torch.from_numpy(p)[None]}, slot)
        assert tt == jt
    np.testing.assert_array_equal(ts["pos"].numpy(), lengths)
    assert ts["cache"]["slot_pos"].shape == (3, teng.capacity)

    def decode_one(cache, tok, pos):
        return jm.decode_fn(jp, cache, tok, pos)

    j_lg, j_cache = jax.jit(jax.vmap(decode_one))(js["cache"], js["tok"][:, None], js["pos"])
    t_lg, t_cache = tm.decode_fn(tp, ts["cache"], ts["tok"], ts["pos"])
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg)[:, 0], **TOL)
    for slot in range(3):
        for name in ("k", "v"):         # JAX [N, L, 1, Sc, KH, hd]; port [L, N, Sc, KH, hd]
            _close_scaled(t_cache[name][:, slot].numpy(), np.asarray(j_cache[name])[slot, :, 0])
        np.testing.assert_array_equal(t_cache["slot_pos"][slot].numpy(),
                                      np.asarray(j_cache["slot_pos"])[slot])
        assert t_cache["slot_pos"][slot, lengths[slot]] == lengths[slot]


def test_per_row_decode_equals_single_position_decodes():
    """The batched per-row step, row by row, equals a B = 1 decode at the
    row's own int position on the row's own cache."""
    _, _, tm, tp = _pair("gemma3_1b")
    lengths, cap = (70, 90), 100
    caches, toks = [], []
    for p in _prompts(lengths, tm.cfg.vocab, seed0=3):
        lg, c = tm.prefill_fn(tp, {"tokens": torch.from_numpy(p)[None]}, pad_to=cap)
        caches.append(c)
        toks.append(torch.argmax(lg, -1).to(torch.int32))
    batched = {"k": torch.cat([c["k"] for c in caches], 1),
               "v": torch.cat([c["v"] for c in caches], 1),
               "slot_pos": torch.stack([c["slot_pos"] for c in caches])}
    lg, out = tm.decode_fn(tp, batched, torch.cat(toks),
                           torch.tensor(lengths, dtype=torch.int32))
    for i, n in enumerate(lengths):
        lg1, out1 = tm.decode_fn(tp, caches[i], toks[i], n)
        np.testing.assert_allclose(lg[i:i + 1].numpy(), lg1.numpy(), **TOL)
        np.testing.assert_allclose(out["k"][:, i].numpy(), out1["k"][:, 0].numpy(), **TOL)
        assert torch.equal(out["slot_pos"][i], out1["slot_pos"])
    with pytest.raises(ValueError, match="per-row slot_pos"):
        tm.decode_fn(tp, caches[0], toks[0], torch.tensor([70], dtype=torch.int32))
    with pytest.raises(ValueError, match="shared slot_pos"):
        tm.decode_fn(tp, batched, torch.cat(toks), 70)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma3_1b"])
def test_prefill_chunk_fn_matches_jax_chunk_by_chunk(arch):
    jm, jp, tm, tp = _pair(arch)
    cap = 24
    toks = _prompts((20,), tm.cfg.vocab, seed0=5)[0][None]
    j_cache = jm.init_cache_fn(1, cap)
    t_cache = tm.init_cache_fn(1, cap, device=CPU)
    j_chunk = jax.jit(jm.prefill_chunk_fn, static_argnums=(3,))
    for start, cs in ((0, 8), (8, 8), (16, 4)):
        chunk = toks[:, start:start + cs]
        j_lg, j_cache = j_chunk(jp, j_cache, jnp.asarray(chunk), start)
        t_lg, t_cache = tm.prefill_chunk_fn(tp, t_cache, torch.from_numpy(chunk), start)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), **TOL)
        for name in ("k", "v"):
            _close_scaled(t_cache[name].numpy(), j_cache[name])
        np.testing.assert_array_equal(t_cache["slot_pos"].numpy(), np.asarray(j_cache["slot_pos"]))
    # the chunks together are the one-shot prefill
    lg, cache = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, pad_to=cap)
    np.testing.assert_allclose(t_lg.numpy(), lg.numpy(), **TOL)
    assert torch.equal(t_cache["slot_pos"], cache["slot_pos"])
    with pytest.raises(ValueError, match="past the cache"):
        tm.prefill_chunk_fn(tp, t_cache, torch.from_numpy(toks[:, :8]), 20)


# ---------------------------------------------------------------------------
# the reference's serving scenarios: port == JAX == the port's static Engine
# ---------------------------------------------------------------------------

def _serve_both(arch, lengths, scfg, slots, prefill_chunk=None, clock=None, seed0=10):
    """The same prompts through JAX's and the port's engine + scheduler.
    Returns (port scheduler, port engine, JAX scheduler, JAX engine, rids,
    prompts)."""
    jm, jp, tm, tp = _pair(arch)
    prompts = _prompts(lengths, tm.cfg.vocab, seed0)
    jeng = JContinuousEngine(jm, JServeConfig(**scfg), num_slots=slots,
                             max_prompt_len=max(lengths), prefill_chunk=prefill_chunk)
    teng = ContinuousEngine(tm, ServeConfig(**scfg), num_slots=slots,
                            max_prompt_len=max(lengths), prefill_chunk=prefill_chunk,
                            device=CPU)
    jsched = JScheduler(jeng, jp, **({} if clock is None else {"clock": clock()}))
    tsched = Scheduler(teng, tp, **({} if clock is None else {"clock": clock()}))
    jr = [jsched.submit(jnp.asarray(p)) for p in prompts]
    tr = [tsched.submit(torch.from_numpy(p)) for p in prompts]
    assert jr == tr
    jsched.run(timeout=600)
    tsched.run(timeout=600)
    for rid in tr:
        got, want = tsched.poll(rid), jsched.poll(rid)
        assert got.tokens == [int(t) for t in want.tokens]
        assert got.finish_reason == want.finish_reason
    assert tsched.steps == jsched.steps
    return tsched, teng, jsched, jeng, tr, prompts


def _static(arch, scfg, prompt):
    _, _, tm, tp = _pair(arch)
    batch = {"tokens": torch.from_numpy(prompt)[None]}
    return Engine(tm, ServeConfig(**scfg)).generate(tp, batch)[0]


def test_continuous_matches_static_on_mixed_length_trace():
    scfg = dict(max_new=4)
    lengths = [8, 12, 8, 16, 12, 8]
    sched, eng, _, jeng, rids, prompts = _serve_both("smollm_360m", lengths, scfg, slots=2)
    assert len(sched.results) == len(prompts)
    for rid, p in zip(rids, prompts):
        got = sched.poll(rid)
        assert isinstance(got, Completion) and got.finish_reason == "length"
        assert got.tokens == _static("smollm_360m", scfg, p).tolist()
        assert got.latency >= 0 and got.prompt_len == len(p)
    assert len(eng._prefill_sigs) == 3 == len(jeng._prefill_sigs)
    assert sched.steps < len(prompts) * (scfg["max_new"] - 1)     # slots reused mid-stream


def test_chunked_prefill_matches_static():
    _, _, tm, _ = _pair("smollm_360m")
    assert tm.prefill_chunk_fn is not None
    scfg = dict(max_new=4)
    lengths = [8, 20, 26, 8, 20]
    sched, eng, _, jeng, rids, prompts = _serve_both("smollm_360m", lengths, scfg, slots=2,
                                                     prefill_chunk=8)
    for rid, p in zip(rids, prompts):
        assert sched.poll(rid).tokens == _static("smollm_360m", scfg, p).tolist()
    assert len(eng._prefill_sigs) == 1
    assert sorted(eng._chunk_sigs) == [(0, 8), (8, 8), (16, 4), (16, 8), (24, 2)]
    assert eng._chunk_sigs == jeng._chunk_sigs and not sched.admitting and sched.active == 0


def test_chunked_admission_reserves_its_slot_and_runs_a_chunk_a_step():
    """A 26-token prompt at chunk 8 holds its slot for 4 chunks: the first at
    reservation, one each later step, admitted on the fourth; the other
    slot decodes meanwhile."""
    _, _, tm, tp = _pair("smollm_360m")
    eng = ContinuousEngine(tm, ServeConfig(max_new=6), num_slots=2, max_prompt_len=26,
                           prefill_chunk=8, device=CPU)
    sched = Scheduler(eng, tp)
    short, long = _prompts((8, 26), tm.cfg.vocab)
    sched.submit(torch.from_numpy(short))
    sched.submit(torch.from_numpy(long))
    sched.step()
    (req, job), = sched.admitting.values()
    assert isinstance(req, Request) and isinstance(job, ChunkedPrefill)
    assert job.start == 8 and not job.done and sched.active == 2 and sched.steps == 1
    sched.step()
    sched.step()
    assert sched.admitting[1][1].start == 24
    sched.step()                           # the last chunk (24, 2), then admitted
    assert not sched.admitting and sorted(sched.running) == [0, 1] and sched.steps == 4


def test_admission_is_age_fair_across_buckets():
    def tick_clock():
        tick = itertools.count()
        return lambda: float(next(tick))

    scfg = dict(max_new=3)
    # long0 (t=0), short (t=1), long1 (t=2), long2 (t=3) on 2 slots
    sched, _, _, _, rids, _ = _serve_both("smollm_360m", [16, 8, 16, 16], scfg, slots=2,
                                          clock=tick_clock, seed0=30)
    t_admit = [sched.poll(r).t_admit for r in rids]
    assert t_admit[0] < t_admit[1] < t_admit[2] < t_admit[3]


def test_continuous_eos_evicts_and_refills_slot():
    _, _, tm, tp = _pair("smollm_360m")
    prompts = _prompts((8, 8, 8), tm.cfg.vocab, seed0=20)
    eos = int(_static("smollm_360m", dict(max_new=2), prompts[0])[1])
    scfg = dict(max_new=6, eos_id=eos)
    sched, _, _, _, rids, _ = _serve_both("smollm_360m", [8, 8, 8], scfg, slots=1, seed0=20)
    first = sched.poll(rids[0])
    assert first.finish_reason == "eos" and first.tokens[-1] == eos and len(first.tokens) <= 6
    for rid, p in zip(rids, prompts):
        got = sched.poll(rid)
        want = _static("smollm_360m", scfg, p).tolist()
        assert got.tokens == want[:len(got.tokens)]
        if got.finish_reason == "eos":
            assert all(t == eos for t in want[len(got.tokens):])


# ---------------------------------------------------------------------------
# sampling on per-slot generators
# ---------------------------------------------------------------------------

def test_temperature_slots_equal_static_generates_seeded_alike():
    _, _, tm, tp = _pair("tinyllama_1_1b")
    scfg = ServeConfig(max_new=6, temperature=1.0)
    prompts = _prompts((8, 12, 8), tm.cfg.vocab, seed0=40)
    for slots in (1, 2):
        eng = ContinuousEngine(tm, scfg, num_slots=slots, max_prompt_len=12, device=CPU)
        sched = Scheduler(eng, tp)
        rids = [sched.submit(torch.from_numpy(p), generator=torch.Generator().manual_seed(7 + i))
                for i, p in enumerate(prompts)]
        sched.run(timeout=600)
        for i, (rid, p) in enumerate(zip(rids, prompts)):
            want = Engine(tm, scfg).generate(tp, {"tokens": torch.from_numpy(p)[None]},
                                             torch.Generator().manual_seed(7 + i))[0]
            assert sched.poll(rid).tokens == want.tolist()
        assert eng.init_state()["generator"] == [None] * slots
        assert sched.state["generator"] == [None] * slots     # finished: drawn no more
    # the default generator is seeded with the request id
    sched = Scheduler(ContinuousEngine(tm, scfg, num_slots=1, max_prompt_len=12, device=CPU), tp)
    rid = sched.submit(torch.from_numpy(prompts[1]))
    sched.run(timeout=600)
    want = Engine(tm, scfg).generate(tp, {"tokens": torch.from_numpy(prompts[1])[None]},
                                     torch.Generator().manual_seed(rid))[0]
    assert sched.poll(rid).tokens == want.tolist()


def test_deadline_evicted_request_replays_its_tokens():
    """max_slot_steps 3 under max_new 6: the request is evicted after 3
    steps, requeued, and its second attempt (evicted again, then failed)
    draws the same tokens as the first: each admission restarts its
    generator from its state at submit."""
    _, _, tm, tp = _pair("tinyllama_1_1b")
    scfg = ServeConfig(max_new=6, temperature=1.0)
    p = _prompts((8,), tm.cfg.vocab, seed0=50)[0]
    eng = ContinuousEngine(tm, scfg, num_slots=1, max_prompt_len=8, device=CPU)
    sched = Scheduler(eng, tp, max_slot_steps=3, max_requeues=1)
    gen = torch.Generator().manual_seed(11)
    rid = sched.submit(torch.from_numpy(p), generator=gen)
    firsts = []
    while rid not in sched.results:
        sched.step()
        if sched.running:
            firsts.append(list(sched.running[0][1]))
    done = sched.poll(rid)
    assert done.finish_reason == "evicted" and sched.steps == 6
    want = Engine(tm, scfg).generate(tp, {"tokens": torch.from_numpy(p)[None]},
                                     torch.Generator().manual_seed(11))[0].tolist()
    assert firsts[1] == want[:3] and done.tokens == want[:4]
    assert sched.state["generator"] == [None] and not sched.running and sched.free == [0]


# ---------------------------------------------------------------------------
# refusals, the device, the state
# ---------------------------------------------------------------------------

def test_engine_refusals_and_device(monkeypatch):
    _, _, tm, tp = _pair("tinyllama_1_1b")
    scfg = ServeConfig(max_new=4)
    with pytest.raises(ValueError, match="max_new"):
        ContinuousEngine(tm, ServeConfig(max_new=0), 1, 8, device=CPU)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousEngine(tm, scfg, 1, 8, prefill_chunk=0, device=CPU)
    window = get_model(dataclasses.replace(configs.get_smoke("gemma3_1b"),
                                           window_pattern=(64,) * 6))
    with pytest.raises(ValueError, match="pure sliding-window"):
        ContinuousEngine(window, scfg, 1, 100, device=CPU)
    with pytest.raises(ValueError, match="full-capacity"):
        ContinuousEngine(window, scfg, 1, 62, prefill_chunk=8, device=CPU)
    eng = ContinuousEngine(tm, scfg, 2, 8, device=CPU)
    state = eng.init_state()
    toks = torch.zeros((1, 8), dtype=torch.int32)
    # a dense decoder reads tokens alone: a vision prefix is refused by name
    with pytest.raises(ValueError, match=r"reads no \['patch_embeds'\]"):
        eng.prefill_into_slot(tp, state, {"tokens": toks, "patch_embeds": toks}, 0)
    with pytest.raises(ValueError, match="capacity"):
        eng.prefill_into_slot(tp, state, {"tokens": torch.zeros((1, 9), dtype=torch.int32)}, 0)
    with pytest.raises(ValueError, match="per request"):
        eng.prefill_into_slot(tp, state, {"tokens": torch.zeros((2, 8), dtype=torch.int32)}, 0)
    with pytest.raises(ValueError, match="max_new"):
        Scheduler(eng, tp).submit(toks[0], max_new=5)
    assert eng.supports_chunked_prefill({"tokens": toks}) is False
    assert {t.device.type for t in state["cache"].values()} == {"cpu"}
    assert state["cache"]["k"].shape == (2, 2, 13, 2, 32) and bool(state["done"].all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousEngine(tm, scfg, 1, 8)


def test_admission_overwrites_the_whole_row_and_copies():
    """A short prompt admitted into a slot that held a longer one leaves no
    stale key visible: slot_pos past the prompt is -1 again, and the row's
    k/v equal a fresh prefill's. The state's tensors keep their addresses
    through a step."""
    _, _, tm, tp = _pair("tinyllama_1_1b")
    eng = ContinuousEngine(tm, ServeConfig(max_new=4), 2, 16, device=CPU)
    state = eng.init_state()
    ptrs = {n: t.data_ptr() for n, t in list(state["cache"].items()) + list(state.items())
            if isinstance(t, torch.Tensor)}
    long, short = _prompts((16, 5), tm.cfg.vocab)
    state, _ = eng.prefill_into_slot(tp, state, {"tokens": torch.from_numpy(long)[None]}, 1)
    state, _ = eng.step(tp, state)
    state, _ = eng.prefill_into_slot(tp, state, {"tokens": torch.from_numpy(short)[None]}, 1)
    _, fresh = tm.prefill_fn(tp, {"tokens": torch.from_numpy(short)[None]}, pad_to=eng.capacity)
    assert torch.equal(state["cache"]["slot_pos"][1], fresh["slot_pos"])
    assert torch.equal(state["cache"]["k"][:, 1], fresh["k"][:, 0])
    assert int(state["pos"][1]) == 5 and not bool(state["done"][1]) and bool(state["done"][0])
    fresh["k"].fill_(7.0)                                  # a copy, never an alias
    assert not bool((state["cache"]["k"][:, 1] == 7.0).any())
    assert ptrs == {n: t.data_ptr() for n, t in list(state["cache"].items()) + list(state.items())
                    if isinstance(t, torch.Tensor)}


def test_slot_update_along_a_named_axis():
    state = {"k": torch.zeros((2, 3, 4)), "n": torch.zeros(3, dtype=torch.int32)}
    buf = torch.ones((2, 1, 4))
    slot_update(state, {"k": buf, "n": [5]}, [2], axes={"k": 1})
    buf.fill_(9.0)
    assert (state["k"][:, 2] == 1).all() and (state["k"][:, :2] == 0).all()
    assert state["n"].tolist() == [0, 0, 5]
