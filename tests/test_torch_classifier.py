"""The port's Table I trial loop (repro_torch.core.classifier) against the
JAX package, trial for trial.

The two packages draw from different generators, so the per-trial flags
are held by replaying JAX's own draws: each trial's classes and its BSC flip
mask (dense) or drop/insert draws (sparse), made from the per-trial keys
exactly as `repro.core.classifier._run_trials` makes them. JAX runs its
``use_kernels=False`` path, which its own tests pin to the Pallas kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import classifier as jclf, sparse as jsparse
from repro_torch import convert
from repro_torch.core import classifier as tclf, hypervector as thv

CPU = "cpu"
C, D, T = 32, 256, 64


def _codebook(seed, c, d, density=0.5):
    return (np.random.default_rng(seed).random((c, d)) < density).astype(np.uint8)


def _jax_draws(keys, c, m, ber, d, representation, k_slots=0):
    """Per-trial classes [T, m] and noise, drawn from each trial's key as
    the reference's `_run_trials` draws them."""
    def one(k):
        k_cls, k_chan = jax.random.split(k)
        classes = jax.random.randint(k_cls, (m,), 0, c)
        if representation == "sparse":
            return classes, jsparse._noise_draws(k_chan, (k_slots,), ber, d, k_slots)
        return classes, jax.random.bernoulli(k_chan, ber, (d,))
    classes, noise = jax.vmap(one)(keys)
    classes = torch.from_numpy(np.asarray(classes).astype(np.int64))
    if representation == "sparse":
        return classes, tuple(torch.from_numpy(np.array(x)) for x in noise)
    return classes, torch.from_numpy(np.array(noise))


def _both(protos, m, ber, bundling, rep, channel, k_max=0, seed=0):
    """(port flags, JAX flags) of one setting on JAX's draws."""
    keys = jax.random.split(jax.random.PRNGKey(seed), T)
    c, d = protos.shape
    k_slots = min(k_max, d)
    jber = 0.0 if channel == "ideal" else ber
    ref = jclf._run_trials(keys, jnp.asarray(protos), m, jnp.float32(jber), bundling, rep,
                           False, "bsc", None, k_max)
    classes, noise = _jax_draws(keys, c, m, jber, d, rep, k_slots)
    got = tclf._run_trials(convert.hv_from_numpy(protos, CPU), m, ber, bundling, rep, T,
                           channel=channel, k_max=k_max,
                           draws=(classes, None if channel == "ideal" else noise))
    return got, np.asarray(ref)


DENSE_MODES = [(rep, bundling, channel) for rep in ("unpacked", "packed")
               for bundling in ("baseline", "permuted") for channel in ("bsc", "ideal")]


@pytest.mark.parametrize("rep,bundling,channel", DENSE_MODES)
def test_run_trials_flags_match_jax_in_every_dense_mode(rep, bundling, channel):
    protos = _codebook(1, C, D)
    for m in (1, 3, 5):
        got, ref = _both(protos, m, 0.08, bundling, rep, channel, seed=m)
        assert got.dtype == torch.bool and got.shape == (T,)
        np.testing.assert_array_equal(got.numpy(), ref)
    if channel == "bsc" and bundling == "baseline":
        assert not ref.all()          # the noise and the bundling both cost trials


@pytest.mark.parametrize("channel", ["bsc", "ideal"])
def test_run_trials_flags_match_jax_sparse(channel):
    """Sparse trials on a low-density codebook (rows inside k_max): the
    flags equal JAX's on its drop/insert draws, and at ber = 0 they equal
    the packed trials."""
    protos = _codebook(2, C, 512, density=16 / 512)
    for m, ber in ((1, 0.02), (3, 0.002)):
        got, ref = _both(protos, m, ber, "baseline", "sparse", channel, k_max=64, seed=m)
        np.testing.assert_array_equal(got.numpy(), ref)
    if channel == "ideal":
        packed, _ = _both(protos, 1, 0.0, "baseline", "packed", "ideal", seed=1)
        sparse, _ = _both(protos, 1, 0.0, "baseline", "sparse", "ideal", k_max=64, seed=1)
        assert torch.equal(sparse, packed) and bool(sparse.all())


def test_tie_heavy_baseline_needs_the_tie_safe_top_m():
    """Integer similarities in 7 values over 100 classes tie at nearly every
    top-5 boundary. `jax.lax.top_k` takes the lower class first; the port's
    decision accepts exactly JAX's sets, which a plain `torch.topk` misses.
    Then whole trials at d = 32, M = 3, where boundary ties are common: the
    flags equal JAX's."""
    import jax.lax

    m = 5
    dots = np.random.default_rng(0).integers(-3, 4, (200, 100)).astype(np.float32)
    jax_sets = torch.from_numpy(np.asarray(jax.lax.top_k(jnp.asarray(dots), m)[1]).astype(np.int64))
    assert bool(tclf._topm_matches(torch.from_numpy(dots), jax_sets, m).all())
    plain = torch.topk(torch.from_numpy(dots), m, dim=-1).indices
    plain_ok = [set(a.tolist()) == set(b.tolist()) for a, b in zip(plain, jax_sets)]
    assert not all(plain_ok)
    got, ref = _both(_codebook(3, 100, 32), 3, 0.0, "baseline", "unpacked", "ideal", seed=4)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1


def test_similarity_profile_matches_jax_trial():
    protos = _codebook(5, C, D)
    key = jax.random.PRNGKey(6)
    k_cls, k_flip = jax.random.split(key)
    classes = jax.random.randint(k_cls, (3,), 0, C)
    mask = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.05, (D,))))
    tc = torch.from_numpy(np.asarray(classes).astype(np.int64))
    tp = convert.hv_from_numpy(protos, CPU)
    for bundling, trial in (("baseline", jclf._trial_baseline),
                            ("permuted", jclf._trial_permuted)):
        _, ref = trial(key, jnp.asarray(protos), 3, 0.05)
        np.testing.assert_array_equal(tclf._profile_sims(tp, tc, mask, bundling).numpy(),
                                      np.asarray(ref))
    cls, sims = tclf.similarity_profile(0, tclf.HDCTaskConfig(), 3, 0.01, "permuted", device=CPU)
    assert tuple(cls.shape) == (3,) and tuple(sims.shape) == (300,)


def test_table1_and_sweep_on_the_port_generator():
    cfg = tclf.HDCTaskConfig(n_trials=48)
    tables = [tclf.table1(0, cfg, 0.01, ms=(1, 3), representation=rep, device=CPU)
              for rep in ("unpacked", "packed")]
    assert tables[0] == tables[1]
    assert set(tables[0]) == {(b, ch) for b in ("baseline", "permuted")
                              for ch in ("ideal", "wireless")}
    assert all(row[0] == 1.0 for row in tables[0].values())
    flags = [tclf.run_trials(0, cfg, 3, 0.01, "permuted", representation=rep, device=CPU)
             for rep in ("unpacked", "packed")]
    assert torch.equal(flags[0], flags[1])
    accs = tclf.accuracy_vs_ber(0, cfg, 3, [0.0, 0.45], device=CPU)
    assert len(accs) == 2 and accs[0] > accs[1]
    sparse_cfg = tclf.HDCTaskConfig(n_classes=32, dim=512, n_trials=32)
    accs = {rep: tclf.run_accuracy(0, sparse_cfg, 1, 0.0, representation=rep, channel="ideal",
                                   density=16 / 512, k_max=64, device=CPU)
            for rep in ("sparse", "packed", "unpacked")}
    assert accs == dict.fromkeys(accs, 1.0)


def test_unsupported_trial_settings_raise():
    cfg = tclf.HDCTaskConfig(n_classes=8, dim=128, n_trials=4)
    with pytest.raises(ValueError):
        tclf.run_accuracy(0, cfg, 1, 0.0, representation="sparse", device=CPU)
    with pytest.raises(ValueError):
        tclf.run_accuracy(0, cfg, 1, 0.0, "permuted", representation="sparse", k_max=8,
                          device=CPU)
    with pytest.raises(ValueError, match="ChannelState"):
        tclf.run_accuracy(0, cfg, 1, 0.0, channel="symbol", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tclf.run_accuracy(0, cfg, 1, 0.0)


# ---------------------------------------------------------------------------
# the multi-centroid memory
# ---------------------------------------------------------------------------

MC_C, MC_D, MC_K, MC_S = 20, 512, 4, 16


def _jax_multicentroid_draws(key, protos_p, k_c, samples_per_class, ber):
    """The samples and initial picks `repro.core.classifier.train_multicentroid`
    draws: one key per class, split into (noise, init)."""
    from repro.core import hypervector as jhv

    def one(class_key, row):
        k_noise, k_init = jax.random.split(class_key)
        samples = jhv.flip_bits_packed(
            k_noise, jnp.broadcast_to(row, (samples_per_class, row.shape[-1])), ber)
        init = jax.random.choice(k_init, samples_per_class, (k_c,), replace=False)
        return samples, init

    samples, init = jax.vmap(one)(jax.random.split(key, protos_p.shape[0]), protos_p)
    return (convert.hv_from_numpy(np.asarray(samples), CPU),
            torch.from_numpy(np.asarray(init).astype(np.int64)))


@pytest.fixture(scope="module")
def multicentroid():
    """(protos [C, d] uint8, JAX's packed centroids, the port's centroids
    trained on JAX's replayed draws, those draws)."""
    from repro.core import hypervector as jhv

    protos = _codebook(11, MC_C, MC_D)
    key = jax.random.PRNGKey(1)
    ref = jclf.train_multicentroid(key, jnp.asarray(protos), MC_K, samples_per_class=MC_S,
                                   ber=0.08)
    draws = _jax_multicentroid_draws(key, jhv.pack(jnp.asarray(protos)), MC_K, MC_S, 0.08)
    got = tclf.train_multicentroid(None, convert.hv_from_numpy(protos, CPU), MC_K,
                                   samples_per_class=MC_S, draws=draws)
    return protos, np.asarray(ref), got, draws


def test_train_multicentroid_matches_jax_on_replayed_draws(multicentroid):
    _, ref, got, _ = multicentroid
    assert got.dtype == torch.int32 and tuple(got.shape) == (MC_C, MC_K, MC_D // 32)
    np.testing.assert_array_equal(convert.to_numpy(got, words=True), ref)


def test_train_multicentroid_own_draws_and_empty_clusters():
    """On its own generator: the same seed gives the same centroids, packed
    or unpacked codebook, and they stay near their class (well under the d/2
    of an unrelated HV). An empty cluster keeps its centroid: seeding two
    centroids on equal samples leaves the second with no member (argmin
    ties go to the first), so it never moves."""
    protos = convert.hv_from_numpy(_codebook(12, MC_C, MC_D), CPU)
    a = tclf.train_multicentroid(torch.Generator().manual_seed(3), protos, MC_K,
                                 samples_per_class=MC_S)
    b = tclf.train_multicentroid(torch.Generator().manual_seed(3), thv.pack(protos), MC_K,
                                 samples_per_class=MC_S)
    assert torch.equal(a, b)
    dist = torch.stack([thv.hamming_distance_packed(a[i], thv.pack(protos)[i:i + 1])
                        for i in range(MC_C)])
    assert int(dist.max()) < MC_D // 4
    samples, init = tclf._multicentroid_draws(torch.Generator().manual_seed(4),
                                             thv.pack(protos), 2, MC_S, 0.08)
    samples[:, 1] = samples[:, 0]
    init[:, 0], init[:, 1] = 0, 1
    cents = tclf.train_multicentroid(None, protos, 2, samples_per_class=MC_S,
                                     draws=(samples, init))
    assert torch.equal(cents[:, 1], samples[:, 1])


def test_multicentroid_predict_matches_jax(multicentroid):
    from repro.core import hypervector as jhv

    protos, ref, got, _ = multicentroid
    pp = jhv.pack(jnp.asarray(protos))
    for seed, ber in ((0, 0.0), (2, 0.1), (5, 0.3)):
        qs = jhv.flip_bits_packed(jax.random.PRNGKey(seed), pp, ber)
        want = jclf.multicentroid_predict(qs, jnp.asarray(ref), use_kernels=False)
        pred = tclf.multicentroid_predict(convert.hv_from_numpy(np.asarray(qs), CPU), got)
        assert pred.dtype == torch.int32
        np.testing.assert_array_equal(pred.numpy(), np.asarray(want))
        if ber <= 0.1:
            assert pred.tolist() == list(range(MC_C))
    # unpacked queries are packed first
    pred = tclf.multicentroid_predict(convert.hv_from_numpy(protos, CPU), got)
    assert pred.tolist() == list(range(MC_C))


@pytest.mark.parametrize("rep", ["packed", "unpacked"])
def test_multicentroid_bank_and_centroid_to_class_match_jax(multicentroid, rep):
    from repro.core.scaleout import ScaleOutConfig as JCfg
    from repro.serving import hdc as jhdc
    from repro_torch.core.scaleout import ScaleOutConfig as TCfg
    from repro_torch.serving import hdc as thdc

    protos, _, _, draws = multicentroid
    kw = dict(n_classes=MC_C * MC_K, dim=MC_D, m_tx=3, n_rx_cores=2, batch=4,
              representation=rep)
    ref = jhdc.multicentroid_bank(jax.random.PRNGKey(1), jnp.asarray(protos), MC_K,
                                  JCfg(**kw), samples_per_class=MC_S)
    got = thdc.multicentroid_bank(None, convert.hv_from_numpy(protos, CPU), MC_K, TCfg(**kw),
                                  samples_per_class=MC_S, draws=draws)
    assert got.dtype == (torch.int32 if rep == "packed" else torch.uint8)
    np.testing.assert_array_equal(convert.to_numpy(got, words=rep == "packed"),
                                  np.asarray(ref))
    pred = np.array([[0, 2], [5, MC_C * MC_K - 1]], np.int32)
    np.testing.assert_array_equal(thdc.centroid_to_class(torch.from_numpy(pred), MC_K).numpy(),
                                  np.asarray(jhdc.centroid_to_class(jnp.asarray(pred), MC_K)))
