"""The port's training path on the CPU (the plain twins of the attention
kernels) against the JAX package: the chunked loss, the model's loss and
its gradients, lr_at, AdamW and signum updates, train steps from the same
parameters on the same batches, the data pipeline, checkpoints (the
reference's own files among them), the Trainer's crash and resume and the
launcher. Inputs are numpy arrays from a seed, or JAX-drawn arrays carried
through `repro_torch.convert`."""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_test_mesh

from jax.sharding import PartitionSpec as P

from repro import compat, configs as jconfigs
from repro.checkpoint import save_checkpoint as j_save
from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.distributed import collectives as jcollectives
from repro.models import get_model as j_get_model
from repro.models import vlm as jvlm
from repro.models.base import init_params as j_init_params
from repro.train import loss as jloss, optimizer as jopt
from repro.train.loop import build_train_fns as j_build_train_fns
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointError, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import opt_state_from_numpy, params_from_numpy, to_numpy
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed.collectives import sign_allreduce
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import Trainer, TrainerConfig, build_train_fns
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.tree import tree_flatten, tree_leaves

KEY = jax.random.PRNGKey(0)



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test runs torch on one intra-op thread, restored after: the suite
    runs several worker processes at once, and these tests' many small ops
    slow down by two orders of magnitude when every process spreads them
    over all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _mesh():
    return make_test_mesh((1, 1), ("data", "model"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _paired(port_tree, jax_tree):
    """(path, port leaf as numpy, JAX leaf as numpy) over the port's leaves."""
    jl = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    return [(p, to_numpy(t), jl[tuple(str(k) for k in p)]) for p, t in tree_flatten(port_tree)]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _conditioned(tree, cfg):
    """A JAX parameter tree (numpy) with its attention projections at fan-in
    over the axes they contract, as chip_smoke.py's phase 11 draws them.

    The reference's init takes fan-in over axis -2, the head axis of wq
    [d, H, hd]: at the TinyLlama smoke width the scores then have a std of
    about 32 and the attention is near-hard. There a 1e-7 relative change of
    the parameters moves JAX's own gradients by 2.7e-4 of each leaf's largest
    |g| (and one ulp of rounding moves AdamW's first update of an embedding
    row by 2 lr), so no two implementations that round apart agree to 1e-4.
    gemma3 normalizes q and k (qk-norm) and needs none of this."""
    a, d, h, kh = tree["blocks"]["attn"], cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    scale = {"wq": math.sqrt(h / d), "wk": math.sqrt(kh / d), "wv": math.sqrt(kh / d),
             "wo": 1 / math.sqrt(h)}
    return {**tree, "blocks": {**tree["blocks"], "attn": {
        k: (v * np.float32(scale[k]) if k in scale else v) for k, v in a.items()}}}


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,with_mask", [(32, False), (40, True), (512, True)])
def test_chunked_cross_entropy_matches_jax(chunk, with_mask):
    rng = np.random.default_rng(chunk)
    b, s, d, v = 2, 96, 16, 50
    h = rng.standard_normal((b, s, d), dtype=np.float32)
    w = rng.standard_normal((d, v), dtype=np.float32)
    targets = rng.integers(0, v, (b, s)).astype(np.int32)
    targets[rng.random((b, s)) < 0.2] = -1                      # ignore_id
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if with_mask else None

    def jf(h, w):
        return jloss.chunked_cross_entropy(h, w, jnp.asarray(targets), chunk=chunk,
                                           mask=None if mask is None else jnp.asarray(mask))
    want, (gh, gw) = jax.value_and_grad(jf, argnums=(0, 1))(h, w)
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    got = chunked_cross_entropy(th, tw, torch.from_numpy(targets), chunk=chunk,
                                mask=None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=1e-7, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("arch,conditioned,gtol", [("tinyllama_1_1b", True, 1e-4),
                                                   ("gemma3_1b", False, 1e-4),
                                                   ("tinyllama_1_1b", False, 1e-3)])
def test_loss_fn_and_gradients_match_jax(arch, conditioned, gtol):
    """f32 smoke configs (gemma3: sliding windows, sandwich norms, tied
    embeddings): the loss within 1e-5 relative, each leaf's gradient within
    1e-4 of that leaf's largest |g|; TinyLlama at the reference's own init
    within 1e-3, where JAX's own gradients move by 2.7e-4 under a 1e-7
    change of the parameters (see `_conditioned`)."""
    jcfg = jconfigs.get_smoke(arch)
    jmodel = j_get_model(jcfg)
    jparams = _np_tree(j_init_params(KEY, jmodel.specs))
    if conditioned:
        jparams = _conditioned(jparams, jcfg)
    batch = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq=128, global_batch=2)).batch(3)
    (want, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(jparams, batch)

    model = get_model(configs.get_smoke(arch))
    params = params_from_numpy(jparams, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    got, metrics = model.loss_fn(params, _torch_batch(batch))
    grads = torch.autograd.grad(got, leaves)
    assert set(metrics) == {"ce", "aux"} and float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for (path, _, jg), g in zip(_paired(params, jgrads), grads):
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(g.numpy(), jg, atol=gtol * scale, rtol=0, err_msg=str(path))


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}}
    tree = jax.tree.map(lambda s: rng.standard_normal(s, dtype=np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    return tree, rng


def test_lr_schedule_matches_jax():
    cfg = topt.OptConfig(lr=1e-3, warmup=10, total_steps=100)
    jcfg = jopt.OptConfig(lr=1e-3, warmup=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(topt.lr_at(cfg, step)),
                                   float(jopt.lr_at(jcfg, jnp.int32(step))), rtol=1e-6)
    assert float(topt.lr_at(cfg, 0)) == 0.0
    assert float(topt.lr_at(cfg, torch.tensor(100, dtype=torch.int32))) < 2e-4


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax(clip):
    params, rng = _opt_inputs(1)
    grads = jax.tree.map(lambda p: 3 * rng.standard_normal(p.shape, dtype=np.float32), params)
    m = jax.tree.map(lambda p: 0.1 * rng.standard_normal(p.shape, dtype=np.float32), params)
    v = jax.tree.map(lambda p: rng.random(p.shape, dtype=np.float32), params)
    state = {"m": m, "v": v, "step": np.int32(3)}
    kw = dict(lr=1e-3, warmup=2, total_steps=10, grad_clip=clip)
    want_p, want_s, want_m = jopt.adamw_update(jopt.OptConfig(**kw), grads, state, params)
    got_p, got_s, got_m = topt.adamw_update(
        topt.OptConfig(**kw), params_from_numpy(grads, "cpu"),
        opt_state_from_numpy(state, "cpu"), params_from_numpy(params, "cpu"))
    for tree, jtree in ((got_p, want_p), (got_s["m"], want_s["m"]), (got_s["v"], want_s["v"])):
        for path, a, b in _paired(tree, jtree):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12, err_msg=str(path))
    assert int(got_s["step"]) == int(want_s["step"]) == 4
    np.testing.assert_allclose(float(got_m["gnorm"]), float(want_m["gnorm"]), rtol=1e-6)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]), rtol=1e-6)


def test_adamw_update_in_slices_is_bit_identical(monkeypatch):
    """A leaf updated in slices along its first dimension (`ADAM_CHUNK`
    elements at a time, here one row of a [5, 7, 3] leaf, two rows of a
    [9, 4] one) gives the whole leaf's update bit for bit: parameters
    (bf16 and f32) and both moments, over two steps."""
    rng = np.random.default_rng(9)
    shapes = {"a": (5, 7, 3), "b": (9, 4), "c": (6,), "d": ()}

    def tree(dtype):
        return {k: torch.from_numpy(rng.standard_normal(v).astype(np.float32)).to(dtype)
                for k, v in shapes.items()}

    opt = topt.OptConfig(lr=1e-2, warmup=1, total_steps=10)
    params = {**tree(torch.bfloat16), "d": torch.tensor(0.5)}
    grads = [tree(torch.float32) for _ in range(2)]
    runs = []
    for chunk in (topt.ADAM_CHUNK, 8):
        monkeypatch.setattr(topt, "ADAM_CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        st = topt.adamw_init(opt, p)
        for g in grads:
            p, st, _ = topt.adamw_update(opt, g, st, p)
        runs.append(tree_leaves((p, st["m"], st["v"])))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_sign_update_matches_jax():
    params, rng = _opt_inputs(2)
    votes = jax.tree.map(lambda p: np.sign(rng.standard_normal(p.shape)).astype(np.float32),
                         params)
    mom = jax.tree.map(lambda p: 0.1 * rng.standard_normal(p.shape, dtype=np.float32), params)
    state = {"mom": mom, "step": np.int32(6)}
    kw = dict(kind="sign_majority", lr=3e-4, warmup=5, total_steps=40)
    want_p, want_s, _ = jopt.sign_update(jopt.OptConfig(**kw), votes, state, params)
    got_p, got_s, _ = topt.sign_update(topt.OptConfig(**kw), params_from_numpy(votes, "cpu"),
                                       opt_state_from_numpy(state, "cpu"),
                                       params_from_numpy(params, "cpu"))
    for tree, jtree in ((got_p, want_p), (got_s["mom"], want_s["mom"])):
        for path, a, b in _paired(tree, jtree):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12, err_msg=str(path))
    assert int(got_s["step"]) == 7


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _extras(cfg, b: int, s: int, step: int) -> dict:
    """The batch entries beside the tokens: the enc-dec's frames [b,
    enc_seq, d], the VLM's patch embeddings [b, 16, d] (a 4 x 4 grid) and
    M-RoPE positions [b, 16 + s, 3] (JAX's `default_positions`); numpy
    draws at unit scale."""
    rng = np.random.default_rng(200 + step)
    if cfg.kind == "encdec":
        return {"frames": rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    if cfg.kind == "vlm":
        return {"patch_embeds": rng.standard_normal((b, 16, cfg.d_model)).astype(np.float32),
                "positions": np.asarray(jvlm.default_positions(b, 16, s, (4, 4)))}
    return {}


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "mixtral_8x22b", "kimi_k2",
                                  "falcon_mamba_7b", "zamba2_2_7b", "whisper_tiny",
                                  "qwen2_vl_7b"])
def test_adamw_steps_match_jax(arch):
    """Three AdamW steps from JAX's initial parameters on JAX's batches, for
    the dense decoder and the MoE, SSM, hybrid, enc-dec (with frames) and
    VLM (with a vision prefix and M-RoPE positions) ones: step 1's loss
    within 1e-5 relative, steps 2-3 within 1e-3 (AdamW's first update turns
    near-zero gradients into about +-lr, so the parameters may part by 2 lr
    where the two gradients round apart). Step 1's gradient norm within
    1e-4 relative; whisper's within 1e-3, as the reference cannot hold it
    closer itself: its own step-1 norm on this batch spreads over
    4.07363-4.07572 (5.1e-4) on its 1x1, 1x2, 2x1, 2x2, 4x1 and 1x4 meshes
    (measured; the port's 4.07508)."""
    jcfg = jconfigs.get_smoke(arch)
    jmodel = j_get_model(jcfg)
    opt = dict(lr=1e-3, warmup=2, total_steps=10)
    fns = j_build_train_fns(jmodel, _mesh(), jopt.OptConfig(**opt))
    jp, js = fns.init(KEY)
    params = params_from_numpy(_np_tree(jp), "cpu")
    state = opt_state_from_numpy(_np_tree(js), "cpu")
    tfns = build_train_fns(get_model(configs.get_smoke(arch)), topt.OptConfig(**opt),
                           device="cpu")
    pipe = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq=64, global_batch=4))
    for step in range(3):
        batch = dict(pipe.batch(step), **_extras(jcfg, 4, 64, step))
        jp, js, jm = fns.step(jp, js, batch, KEY)
        params, state, m = tfns.step(params, state, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if step == 0 else 1e-3)
        if step == 0:
            np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                                       rtol=1e-3 if arch == "whisper_tiny" else 1e-4)
    assert int(state["step"]) == 3


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma3_1b"])
def test_microbatch_grad_accum_matches_full_batch(arch):
    """The reference's test on its own init and batches; TinyLlama's
    attention projections at fan-in over their contraction (`_conditioned`:
    at the reference's init, rounding apart moves the result by ~1.2e-3)."""
    jcfg = jconfigs.get_smoke(arch)
    jparams = _np_tree(j_init_params(KEY, j_get_model(jcfg).specs))
    if arch == "tinyllama_1_1b":
        jparams = _conditioned(jparams, jcfg)
    model = get_model(configs.get_smoke(arch))
    pipe = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq=64, global_batch=8))
    opt = topt.OptConfig(lr=1e-3, warmup=2, total_steps=10)
    f1 = build_train_fns(model, opt, microbatch=1, device="cpu")
    f4 = build_train_fns(model, opt, microbatch=4, device="cpu")
    p1, p4 = (params_from_numpy(jparams, "cpu") for _ in range(2))
    s1, s4 = topt.adamw_init(opt, p1), topt.adamw_init(opt, p4)
    for step in range(3):
        b = _torch_batch(pipe.batch(step))
        p1, s1, m1 = f1.step(p1, s1, b)
        p4, s4, m4 = f4.step(p4, s4, b)
    d = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(p1), tree_leaves(p4)))
    assert d < 5e-4, d       # the reference's bound


def test_adamw_loss_decreases():
    cfg = configs.get_smoke("gemma3_1b")
    fns = build_train_fns(get_model(cfg), topt.OptConfig(lr=1e-3, warmup=5, total_steps=30),
                          device="cpu")
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=128, global_batch=4), device="cpu")
    params, opt_state = fns.init(0)
    losses = []
    for step in range(15):
        params, opt_state, m = fns.step(params, opt_state, pipe.batch(step))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_sign_majority_step_matches_jax():
    """One rank: the vote is sign(g). One signum step from JAX's parameters
    on JAX's batch equals JAX's wherever JAX's gradient is not near zero
    (1e-3 of the leaf's largest |g|), where the two gradients cannot take
    different signs. JAX's step is composed from its parts, the gradient,
    `sign_allreduce` over a one-device data axis and `sign_update`: its
    trainer's shard_map refuses a 1 x 1 mesh on this JAX (an activation
    constraint names the manual data axis)."""
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    x[::7] = 0.0
    assert torch.equal(sign_allreduce(x), torch.sign(x))
    assert sign_allreduce(x.bfloat16()).dtype == torch.bfloat16

    jcfg = jconfigs.get_smoke("tinyllama_1_1b")
    jmodel = j_get_model(jcfg)
    opt = dict(kind="sign_majority", lr=3e-4, warmup=5, total_steps=40)
    jp = j_init_params(KEY, jmodel.specs)
    js = jopt.sign_init(jopt.OptConfig(**opt), jp)
    batch = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq=64, global_batch=4)).batch(0)
    (jloss_v, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(jp, batch)
    vote = compat.shard_map(lambda g: jcollectives.sign_allreduce(g, "data"),
                            mesh=make_test_mesh((1,), ("data",)), in_specs=P(), out_specs=P())
    jvotes = jax.tree.map(vote, jgrads)
    params = params_from_numpy(_np_tree(jp), "cpu")
    state = opt_state_from_numpy(_np_tree(js), "cpu")
    jp2, _, _ = jopt.sign_update(jopt.OptConfig(**opt), jvotes, js, jp)
    tfns = build_train_fns(get_model(configs.get_smoke("tinyllama_1_1b")),
                           topt.OptConfig(**opt), device="cpu")
    params, state, m = tfns.step(params, state, _torch_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jloss_v), rtol=1e-5)
    for (path, got, want), (_, _, g) in zip(_paired(params, jp2), _paired(params, jgrads)):
        # zero where no token of the batch reaches an embedding row
        clear = (np.abs(g) > 1e-3 * np.abs(g).max()) | (g == 0)
        assert clear.mean() > 0.5, path            # the comparison covers most of the leaf
        np.testing.assert_allclose(got[clear], want[clear], rtol=1e-6, atol=1e-9,
                                   err_msg=str(path))


def test_sign_allreduce_flip_rate_within_5_sigma():
    x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(1))
    ber = 0.01
    out = sign_allreduce(x, generator=torch.Generator().manual_seed(2), ber=ber)
    rate = float((out != torch.sign(x)).double().mean())
    sigma = (ber * (1 - ber) / x.numel()) ** 0.5
    assert abs(rate - ber) < 5 * sigma, (rate, sigma)
    again = sign_allreduce(x, generator=torch.Generator().manual_seed(2), ber=ber)
    assert torch.equal(out, again)                 # the flips are the generator's
    with pytest.raises(ValueError, match="generator"):
        sign_allreduce(x, ber=ber)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

def test_data_pipeline_deterministic_skip_ahead_and_shards():
    cfg = DataConfig(vocab=1000, seq=64, global_batch=8)
    pipe = SyntheticLM(cfg, device="cpu")
    b1 = pipe.batch(17)
    fresh = SyntheticLM(cfg, device="cpu")
    for s in range(5):
        fresh.batch(s)
    assert torch.equal(fresh.batch(17)["tokens"], b1["tokens"])     # O(1) random access
    assert not torch.equal(pipe.batch(18)["tokens"], b1["tokens"])
    assert b1["tokens"].shape == (8, 64) and b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])  # shifted by one
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < cfg.vocab
    h0 = SyntheticLM(cfg, 0, 2, device="cpu").batch(3)["tokens"]
    h1 = SyntheticLM(cfg, 1, 2, device="cpu").batch(3)["tokens"]
    assert h0.shape == (4, 64) and not torch.equal(h0, h1)
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(vocab=10, seq=8, global_batch=5), 0, 2, device="cpu")


def test_data_pipeline_motif_share_and_zipf_head():
    cfg = DataConfig(vocab=1000, seq=256, global_batch=64, seed=3)
    pipe = SyntheticLM(cfg, device="cpu")
    toks, motif = pipe.draw(0)
    n = motif.numel()
    sigma = (cfg.motif_prob * (1 - cfg.motif_prob) / n) ** 0.5
    assert abs(float(motif.double().mean()) - cfg.motif_prob) < 5 * sigma
    # fresh draws: the most likely token at Zipf's rank-1 probability
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64) ** -cfg.zipf_a
    p0 = ranks[0] / ranks.sum()
    fresh = toks[~motif]
    share = float((fresh == 0).double().mean())
    assert abs(share - p0) < 5 * (p0 * (1 - p0) / fresh.numel()) ** 0.5, (share, p0)
    # each row's motif positions repeat its motif every motif_len tokens
    row, m = toks[0], motif[0]
    tiled = torch.full((cfg.motif_len,), -1, dtype=torch.int32)
    for i in torch.nonzero(m).flatten().tolist():
        j = i % cfg.motif_len
        assert int(tiled[j]) in (-1, int(row[i]))
        tiled[j] = row[i]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.tensor(7, dtype=torch.int32)}}


def _like(tree):
    return jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def test_checkpoint_atomic_keep_and_restore(tmp_path):
    d = str(tmp_path / "ck")
    tree = _tree()
    for step in (1, 2, 3, 4):
        save_checkpoint(d, step, tree, extra={"data_step": step}, keep=2)
    assert latest_step(d) == 4
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(d) if p.startswith("step_"))
    assert steps == [3, 4]  # keep-2 pruned
    restored, extra = restore_checkpoint(d, 4, _like(tree), device="cpu")
    assert extra["data_step"] == 4
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].shape == () and int(restored["b"]["c"]) == 7
    assert restored["b"]["c"].dtype == torch.int32


def test_checkpoint_restore_defends_against_corruption(tmp_path):
    """Every failure mode raises CheckpointError naming the step and leaf:
    missing step, bit-flipped leaf (CRC mismatch), truncated leaf, deleted
    leaf file, garbage manifest, a checkpoint that does not cover the
    requested structure; a pre-checksum checkpoint still restores."""
    d = str(tmp_path / "ck")
    tree = _tree()
    like = _like(tree)
    with pytest.raises(CheckpointError, match="no committed checkpoint"):
        restore_checkpoint(d, 1, like, device="cpu")
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(d, step, tree, keep=0)
    leaf = tmp_path / "ck" / "step_1" / "a.npy"
    blob = bytearray(leaf.read_bytes())
    blob[-1] ^= 0xFF
    leaf.write_bytes(bytes(blob))
    with pytest.raises(CheckpointError, match="corrupt"):
        restore_checkpoint(d, 1, like, device="cpu")
    leaf2 = tmp_path / "ck" / "step_2" / "b__c.npy"
    leaf2.write_bytes(leaf2.read_bytes()[:16])
    with pytest.raises(CheckpointError, match="corrupt"):
        restore_checkpoint(d, 2, like, device="cpu")
    os.remove(tmp_path / "ck" / "step_3" / "a.npy")
    with pytest.raises(CheckpointError, match="file missing"):
        restore_checkpoint(d, 3, like, device="cpu")
    (tmp_path / "ck" / "step_4" / "manifest.json").write_text("{not json")
    with pytest.raises(CheckpointError, match="manifest.json unreadable"):
        restore_checkpoint(d, 4, like, device="cpu")
    like2 = {**like, "z": torch.empty(2, device="meta")}
    with pytest.raises(CheckpointError, match="missing leaves"):
        restore_checkpoint(d, 5, like2, device="cpu")
    mpath = tmp_path / "ck" / "step_5" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    for entry in manifest["leaves"]:
        del entry["crc32"]
    mpath.write_text(json.dumps(manifest))
    restored, _ = restore_checkpoint(d, 5, like, device="cpu")
    assert torch.equal(restored["a"], tree["a"])
    # a leaf whose dtype drifted from its manifest record
    manifest["leaves"][0]["dtype"] = "float64"
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(CheckpointError, match="manifest says"):
        restore_checkpoint(d, 5, like, device="cpu")


def test_checkpoint_bf16_round_trip_bit_for_bit(tmp_path):
    bits = torch.randint(-2**15, 2**15, (3, 5, 7), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0)).to(torch.int16)
    tree = ({"w": bits.view(torch.bfloat16), "s": torch.tensor(3, dtype=torch.int32)},
            {"m": torch.randn(4, 2)})
    save_checkpoint(str(tmp_path), 7, tree, extra={"data_step": 7})
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert {e["path"]: e["dtype"] for e in manifest["leaves"]} == {
        "0/s": "int32", "0/w": "bfloat16", "1/m": "float32"}
    got, _ = restore_checkpoint(str(tmp_path), 7, tree, device="cpu")
    assert got[0]["w"].dtype == torch.bfloat16
    assert torch.equal(got[0]["w"].view(torch.int16), bits)
    assert torch.equal(got[1]["m"], tree[1]["m"]) and int(got[0]["s"]) == 3


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    """A checkpoint the reference wrote (f32, int32 and bf16 leaves) restores
    in the port bit for bit, and the port writes the same files byte for
    byte (the reference's own restore refuses its bf16 leaves)."""
    rng = np.random.default_rng(5)
    jtree = {"p": {"w": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
                   "b": jnp.asarray(rng.standard_normal(6), jnp.float32)},
             "step": jnp.int32(12)}
    j_save(str(tmp_path / "ref"), 3, jtree, extra={"data_step": 3})
    like = {"p": {"w": torch.empty((4, 6), dtype=torch.bfloat16, device="meta"),
                  "b": torch.empty(6, device="meta")},
            "step": torch.empty((), dtype=torch.int32, device="meta")}
    got, extra = restore_checkpoint(str(tmp_path / "ref"), 3, like, device="cpu")
    assert extra == {"data_step": 3}
    want = np.asarray(jtree["p"]["w"]).view(np.int16)
    assert np.array_equal(got["p"]["w"].view(torch.int16).numpy(), want)
    assert np.array_equal(got["p"]["b"].numpy(), np.asarray(jtree["p"]["b"]))
    assert got["step"].shape == () and int(got["step"]) == 12
    save_checkpoint(str(tmp_path / "port"), 3, got, extra={"data_step": 3})
    for name in sorted(os.listdir(tmp_path / "ref" / "step_3")):
        assert ((tmp_path / "ref" / "step_3" / name).read_bytes()
                == (tmp_path / "port" / "step_3" / name).read_bytes()), name


# ---------------------------------------------------------------------------
# the Trainer and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,ber", [("adamw", None), ("sign_majority", 0.01)])
def test_trainer_failure_resume_bit_identical(tmp_path, kind, ber):
    cfg = configs.get_smoke("smollm_360m")
    fns = build_train_fns(get_model(cfg), topt.OptConfig(kind=kind, lr=1e-3, warmup=5,
                                                         total_steps=20),
                          ota_ber=ber, device="cpu")
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=64, global_batch=4), device="cpu")
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    tr = Trainer(fns, pipe, TrainerConfig(steps=12, ckpt_every=5, ckpt_dir=d1, log_every=100))
    with pytest.raises(RuntimeError, match="injected failure"):
        tr.run(0, fail_at=8, quiet=True)     # crash mid-run
    p1, s1, l1 = tr.run(0, quiet=True)       # restart resumes from step 5
    assert len(l1) == 7
    tr2 = Trainer(fns, pipe, TrainerConfig(steps=12, ckpt_every=5, ckpt_dir=d2, log_every=100))
    p2, s2, l2 = tr2.run(0, quiet=True)      # no failure
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert torch.equal(a, b)
    assert l1[-1] == l2[-1]
    assert latest_step(d1) == latest_step(d2) == 12


def test_launcher_trains_on_cpu_and_refuses_without_a_card(tmp_path, capsys, monkeypatch):
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert launch_train.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=tinyllama-1.1b" in out and "device=cpu" in out and "final loss" in out
    assert "tokens/s" in out and latest_step(str(tmp_path)) == 3
    assert launch_train.main(argv + ["--device", "cpu"]) == 0
    assert "nothing to do" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(argv)


def test_launcher_trains_moe_on_two_ranks_and_resumes(tmp_path, capfd):
    """``launch.train --arch kimi-k2 --smoke --device cpu --ranks 2`` trains
    on a 1x2 mesh (the experts and the router's columns cut over the model
    ranks), and a rerun with more steps resumes its checkpoint."""
    argv = ["--arch", "kimi-k2", "--smoke", "--device", "cpu", "--ranks", "2", "--batch",
            "2", "--seq", "32", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    assert launch_train.main(argv + ["--steps", "2"]) == 0
    out = capfd.readouterr().out
    assert "arch=kimi-k2" in out and "mesh=1x2 (data, model)" in out and "final loss" in out
    assert "2 steps on 2 ranks on cpu" in out
    assert latest_step(str(tmp_path / "ck")) == 2
    assert launch_train.main(argv + ["--steps", "3"]) == 0
    out = capfd.readouterr().out
    assert "1 steps on 2 ranks on cpu" in out and latest_step(str(tmp_path / "ck")) == 3


def test_remat_changes_no_gradient():
    """cfg.remat recomputes each layer in the backward: the same loss and
    gradients as without it."""
    cfg = configs.get_smoke("gemma3_1b")
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=64, global_batch=2),
                        device="cpu").batch(0)
    out = []
    for remat in (False, True):
        model = get_model(dataclasses.replace(cfg, remat=remat))
        params = build_train_fns(model, topt.OptConfig(), device="cpu").init(0)[0]
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        loss, _ = model.loss_fn(params, batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
