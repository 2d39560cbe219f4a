"""The HDC classifier and the paper's bundled-query retrieval experiment
(counterpart of `repro/core/classifier.py`): Table I, Fig. 10's accuracy
against the BER and Fig. 11's similarity profile, plus the serve helpers.

A trial draws M classes from the shared codebook, bundles their
hypervectors by strict majority, flips the bundle through a BSC at the BER,
and searches the C prototypes:

* **baseline bundling**: the trial succeeds iff the top-M classes are the
  sent set;
* **permuted bundling**: encoder m sends rho^m(q_m); the receiver searches
  M permuted banks and the trial succeeds iff every bank's top-1 is the
  class its encoder sent.

On the physical ``symbol`` channel the majority and the BSC give way to
the link itself: each trial's M bits superpose in the constellation of RX
core ``t % N`` of a `phy.ChannelState`, which adds AWGN and decides by its
decision regions (`ota.awgn_decide`). `run_drift_sweep` runs these trials
at every step of a living channel (`phy.process`).

`_run_trials` runs all trials of one setting as three vectorized phases,
as the reference does: the draws (every trial's classes, then its channel
noise, from one `torch.Generator`), one batched search launch (the
``assoc_matmul``, ``hamming_search``, ``hamming_topk_banked`` or
``sparse_search`` kernel on the card), and a batched decision. Its draws
can be given from outside (the tests replay JAX's).

Ties: the baseline's top-M picks on the unique integer key
``dot*C + (C-1-col)``, so equal similarities go to the lower class, the
order of `jax.lax.top_k`; `torch.topk` promises no order among equal values.

The multi-centroid memory (`train_multicentroid`, `multicentroid_predict`)
turns each class prototype into k_c centroids by majority-based k-means in
packed space, and classifies with one fused top-1 launch over all centroid
rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import hypervector as hv, ota, sparse
from repro_torch.kernels.assoc_matmul import assoc_matmul
from repro_torch.kernels.common import popcount32
from repro_torch.kernels.hamming import hamming_search, hamming_topk_banked
from repro_torch.kernels.sparse import sparse_search
from repro_torch.phy import process as phy_process
from repro_torch.phy.channel import combo_index


@dataclasses.dataclass(frozen=True)
class HDCTaskConfig:
    n_classes: int = 100
    dim: int = 512
    n_trials: int = 2000


def make_codebook(generator: torch.Generator, cfg: HDCTaskConfig,
                  density: float | None = None,
                  device: str | torch.device | None = "cuda") -> torch.Tensor:
    """The shared item/prototype memory: [C, d] uint8 random hypervectors,
    each bit i.i.d. at ``density`` (default 1/2)."""
    if density is None:
        return hv.random_hv(generator, cfg.n_classes, cfg.dim, device)
    dev = _device.resolve(device)
    draw = torch.rand((cfg.n_classes, cfg.dim), generator=generator, device=dev)
    return (draw < density).to(torch.uint8)


def make_tenant_codebooks(generators, cfg: HDCTaskConfig,
                          device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Per-tenant prototype memories [T, C, d] uint8, one tenant per
    generator: tenant t's codebook is ``make_codebook(generators[t], cfg)``,
    the codebook a standalone single-tenant serve would build from that
    generator (the reference folds the tenant index into one key)."""
    return torch.stack([make_codebook(g, cfg, device=device) for g in generators])


def expanded_prototypes(protos: torch.Tensor, m: int) -> torch.Tensor:
    """Permuted prototype banks for TX signatures 0..M-1: [M, C, d]."""
    return torch.stack([hv.permute(protos, s) for s in range(m)], 0)


def expanded_prototypes_packed(protos_p: torch.Tensor, m: int) -> torch.Tensor:
    """Packed permuted banks: protos_p [C, W] int32 -> [M, C, W]."""
    return torch.stack([hv.permute_packed(protos_p, s) for s in range(m)], 0)


def _dots(qs: torch.Tensor, protos: torch.Tensor, d: int, packed: bool) -> torch.Tensor:
    """Bipolar dots d - 2*hamming [T, C], exact integers in f32: the Hamming
    search kernel on packed words, the bipolar matmul kernel on bits."""
    if packed:
        return (d - 2 * hamming_search(qs, protos)).to(torch.float32)
    return assoc_matmul(qs, protos)


def _similarity(qs: torch.Tensor, protos: torch.Tensor, d: int, packed: bool) -> torch.Tensor:
    """Batched similarity [T, C] in [0, 1], the same floats in both
    representations: (dot + d) / 2d from the exact integer dot."""
    return (_dots(qs, protos, d, packed) + d) / (2.0 * d)


def _topm_matches(dots: torch.Tensor, classes: torch.Tensor, m: int) -> torch.Tensor:
    """Baseline decision: is the top-m set of every row of ``dots`` [T, C]
    exactly the sent set ``classes`` [T, m]? The top-m is taken on the
    unique key dot*C + (C-1-col), so ties go to the lower class, as in
    `jax.lax.top_k`."""
    t, c = dots.shape
    col = torch.arange(c, device=dots.device)
    key = dots.to(torch.int64) * c + (c - 1 - col)
    topm = torch.topk(key, m, dim=-1).indices
    sent = torch.zeros((t, c), dtype=torch.bool, device=dots.device).scatter_(1, classes, True)
    got = torch.zeros((t, c), dtype=torch.bool, device=dots.device).scatter_(1, topm, True)
    return (sent == got).all(-1)


def _check_setting(bundling: str, representation: str, channel: str, k_max: int,
                   state=None) -> None:
    if channel not in ("bsc", "ideal", "symbol"):
        raise ValueError(f"unknown channel {channel!r}; the trials take 'bsc', 'ideal' "
                         "or 'symbol'")
    if channel == "symbol" and state is None:
        raise ValueError("channel='symbol' needs a phy.ChannelState "
                         "(scaleout.precharacterize_state)")
    if bundling not in ("baseline", "permuted"):
        raise ValueError(f"unknown bundling {bundling!r}")
    if representation not in ("unpacked", "packed", "sparse"):
        raise ValueError(f"unknown representation {representation!r}")
    if representation == "sparse":
        if k_max <= 0:
            raise ValueError("representation='sparse' needs k_max > 0 (the index-list "
                             f"capacity); got k_max={k_max}")
        if bundling != "baseline":
            raise ValueError("representation='sparse' supports baseline bundling only "
                             f"(permuted TX signatures would need per-bank sparse "
                             f"searches); got bundling={bundling!r}")
        if channel == "symbol":
            raise ValueError("representation='sparse' has no symbol tier (the "
                             "constellation decodes dense per-dimension fields); use "
                             "channel='bsc' or 'ideal'")


def _draw(generator: torch.Generator, c: int, m: int, t: int, ber, d: int,
          k_slots: int, representation: str, channel: str):
    """Phase 1's draws: every trial's classes [T, m] first, then its noise.
    The noise is None on the ideal channel, the AWGN's standard normals
    (real, imaginary) [T, d] each on the symbol channel, the flip mask
    [T, d] bool in the dense representations (packed packs the same mask)
    and the sparse BSC's (drop, pos, acc) [T, k_slots] otherwise."""
    dev = generator.device
    classes = torch.randint(0, c, (t, m), generator=generator, device=dev)
    if channel == "ideal":
        return classes, None
    if channel == "symbol":
        return classes, ota.awgn_draws(generator, (t, d), dev)
    if representation == "sparse":
        return classes, sparse._noise_draws(generator, (t, k_slots), ber, d, k_slots)
    return classes, torch.rand((t, d), generator=generator, device=dev) < ber


def _symbol_queries(q_tx: torch.Tensor, state, noise, d: int, packed: bool) -> torch.Tensor:
    """The symbol channel's received queries: q_tx [T, m, d|W] -> [T, d|W].
    Trial t superposes its m phase-encoded bits at RX core t % N, which adds
    the AWGN ``noise`` and decides by its own decision regions."""
    t = q_tx.shape[0]
    bits = hv.unpack(q_tx, d) if packed else q_tx
    combo = combo_index(bits, axis=1).to(torch.int64)         # [T, d]
    rx = torch.arange(t, device=q_tx.device) % state.n_rx
    sym = torch.gather(state.symbols[rx], 1, combo)           # [T, d]
    q = ota.awgn_decide(None, sym, state.c0[rx, None], state.c1[rx, None], state.n0,
                        noise=noise)
    return hv.pack(q) if packed else q


def _run_trials(protos: torch.Tensor, m: int, ber, bundling: str, representation: str,
                n_trials: int, *, channel: str = "bsc", k_max: int = 0,
                generator: torch.Generator | None = None, draws=None,
                state=None) -> torch.Tensor:
    """Per-trial success flags [T] bool for ``n_trials`` trials on the
    unpacked codebook ``protos`` [C, d] uint8.

    ``draws`` = (classes [T, m] int64, noise) replaces phase 1's draws (see
    `_draw`); without it they come from ``generator``. ``channel="ideal"`` is
    the noise-free link (the BSC at ber = 0). ``channel="symbol"`` replaces
    the majority and the BSC by the physical link of ``state`` (a
    `phy.ChannelState`): trial t superposes its m bits, adds AWGN and
    decodes at RX core t % N; ``ber`` is unused. ``representation="sparse"``
    (baseline bundling, bsc or ideal only) runs the trial on index lists of
    capacity ``k_max``: the same classes, the sparse bundle, the drop+insert
    BSC, and one ``sparse_search`` against the packed codebook; at ber = 0
    with no saturation its flags equal the packed ones."""
    _check_setting(bundling, representation, channel, k_max, state)
    if channel == "symbol" and state.m_tx != m:
        raise ValueError(f"channel='symbol': the state characterizes {state.m_tx} TXs, "
                         f"the trials bundle m={m}")
    c, d = protos.shape
    sparse_rep = representation == "sparse"
    packed = representation == "packed"
    protos_r = hv.pack(protos) if packed or sparse_rep else protos
    codes = sparse.sparsify(protos, k_max) if sparse_rep else None
    if draws is None:
        draws = _draw(generator, c, m, n_trials, ber, d,
                      codes.shape[-1] if sparse_rep else 0, representation, channel)
    classes, noise = draws

    # phase 1: the noisy bundled query of every trial
    if sparse_rep:
        qs = sparse.bundle(codes[classes])                    # [T, k_max]
        if noise is not None:
            qs = sparse.apply_noise(qs, *noise)
    else:
        q_tx = protos_r[classes]                              # [T, m, d|W]
        if bundling == "permuted":                # each TX applies its signature
            rho = hv.permute_packed if packed else hv.permute
            q_tx = torch.stack([rho(q_tx[:, s], s) for s in range(m)], 1)
        if channel == "symbol":
            qs = _symbol_queries(q_tx, state, noise, d, packed)
        else:
            q_tx = q_tx.transpose(0, 1)
            qs = hv.majority_packed(q_tx) if packed else hv.majority(q_tx)
            if noise is not None:
                flips = noise.to(torch.uint8)
                qs = qs ^ (hv.pack(flips) if packed else flips)

    # phases 2-3: one batched search, one batched decision
    if bundling == "baseline":
        if sparse_rep:
            dots = d - 2 * sparse_search(qs, protos_r)
        else:
            dots = _dots(qs, protos_r, d, packed)
        return _topm_matches(dots, classes, m)
    if packed:
        # every TX signature is a bank of one fused top-1 launch; argmin of
        # the distance is the first maximum of the similarity
        banks = expanded_prototypes_packed(protos_r, m)       # [m, C, W]
        q_rep = qs[None].expand((m,) + tuple(qs.shape)).contiguous()
        _, amin = hamming_topk_banked(q_rep, banks)
        return (amin.T == classes).all(-1)
    banks = expanded_prototypes(protos, m).reshape(m * c, d)
    dots = _dots(qs, banks, d, False).reshape(-1, m, c)
    return (torch.argmax(dots, -1) == classes).all(-1)       # first max per bank


def run_trials(seed: int, cfg: HDCTaskConfig, m: int, ber: float,
               bundling: str = "baseline", *, representation: str = "unpacked",
               channel: str = "bsc", density: float | None = None, k_max: int = 0,
               state=None, device: str | torch.device | None = "cuda") -> torch.Tensor:
    """Per-trial success flags [cfg.n_trials] bool of one Table I setting:
    one generator seeded with ``seed`` draws the codebook (each bit at
    ``density``, default 1/2), then every trial's classes, then its noise,
    so the unpacked and packed representations see the same draws and agree
    trial for trial. ``representation="sparse"`` needs ``k_max``;
    ``channel="symbol"`` needs ``state`` (`scaleout.precharacterize_state`)
    with at least one valid row, and cycles the trials over its RX cores."""
    _check_setting(bundling, representation, channel, k_max, state)
    if channel == "symbol" and not bool(state.valid.any()):
        raise ValueError("channel='symbol' needs characterized decision regions, but "
                         "state.valid is all-False (e.g. a state_from_ber synthesis with "
                         "zero physics) — build one with scaleout.precharacterize_state")
    dev = _device.resolve(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    protos = make_codebook(generator, cfg, density, dev)
    return _run_trials(protos, m, ber, bundling, representation, cfg.n_trials,
                       channel=channel, k_max=k_max, generator=generator, state=state)


def run_accuracy(seed: int, cfg: HDCTaskConfig, m: int, ber: float,
                 bundling: str = "baseline", *, representation: str = "unpacked",
                 channel: str = "bsc", density: float | None = None, k_max: int = 0,
                 state=None, device: str | torch.device | None = "cuda") -> float:
    """Trial-exact classification accuracy for M bundled hypervectors at a
    BER: the share of `run_trials`'s flags that are set (float32 mean)."""
    flags = run_trials(seed, cfg, m, ber, bundling, representation=representation,
                       channel=channel, density=density, k_max=k_max, state=state,
                       device=device)
    return float(flags.to(torch.float32).mean())


def accuracy_vs_ber(seed: int, cfg: HDCTaskConfig, m: int, bers, bundling: str = "baseline",
                    *, representation: str = "unpacked",
                    device: str | torch.device | None = "cuda") -> list[float]:
    """Fig. 10 sweep: accuracy at each BER, every point on the same seed."""
    return [run_accuracy(seed, cfg, m, float(b), bundling, representation=representation,
                         device=device) for b in bers]


def table1(seed: int, cfg: HDCTaskConfig, wireless_ber: float,
           ms: tuple[int, ...] = (1, 3, 5, 7, 9, 11), *,
           representation: str = "unpacked",
           device: str | torch.device | None = "cuda") -> dict:
    """Table I: accuracy for {baseline, permuted} x {ideal, wireless},
    keyed ``(bundling, "ideal"|"wireless")``, one value per M in ``ms``."""
    out = {}
    for bundling in ("baseline", "permuted"):
        for name, channel, ber in (("ideal", "ideal", 0.0), ("wireless", "bsc", wireless_ber)):
            out[(bundling, name)] = [
                run_accuracy(seed, cfg, m, ber, bundling, representation=representation,
                             channel=channel, device=device) for m in ms]
    return out


def _profile_sims(protos: torch.Tensor, classes: torch.Tensor, mask: torch.Tensor,
                  bundling: str) -> torch.Tensor:
    """One trial's similarities: classes [m], mask [d] bool -> [C] baseline,
    [m*C] permuted (bank-major)."""
    m, (c, d) = classes.shape[0], protos.shape
    q_tx = protos[classes]
    if bundling == "permuted":
        q_tx = hv.permute_batch(q_tx, torch.arange(m, device=protos.device))
        protos = expanded_prototypes(protos, m).reshape(m * c, d)
    q = hv.majority(q_tx) ^ mask.to(torch.uint8)
    return _similarity(q[None], protos, d, False)[0]


def similarity_profile(seed: int, cfg: HDCTaskConfig, m: int, ber: float,
                       bundling: str = "baseline",
                       device: str | torch.device | None = "cuda"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One trial's similarity-against-class profile (Fig. 11): (classes [m],
    sims [C] baseline or [m*C] permuted), the classes being the ones that
    trial sent."""
    dev = _device.resolve(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    protos = make_codebook(generator, cfg, None, dev)
    classes, mask = _draw(generator, cfg.n_classes, m, 1, ber, cfg.dim, 0, "unpacked", "bsc")
    return classes[0], _profile_sims(protos, classes[0], mask[0], bundling)


def run_drift_sweep(seed: int, cfg: HDCTaskConfig, m: int, state, process, n_steps: int,
                    *, bundling: str = "permuted", representation: str = "unpacked",
                    adaptive: bool = False, patience: int = 2,
                    band_kwargs: dict | None = None,
                    device: str | torch.device | None = "cuda") -> dict:
    """Accuracy per step over a living channel (the closed-loop sweep).

    Rolls ``state`` forward ``n_steps`` under ``process`` (`phy.rollout`,
    or `phy.adaptive_rollout` with the banded EM re-fit when ``adaptive``)
    and runs the symbol-tier trials at every step's channel. One generator
    seeded with ``seed`` draws the codebook and the trials' classes and
    noise once, and every step reuses them, so differences between steps are
    the channel's; the process draws from `phy.process_generators(seed)`.
    Returns per-step ``acc``, ``ber_avg``, ``ber_max`` and ``est_avg``
    (lists of floats, read from the device once at the end), the re-fit
    mask ``refits`` [T, N] bool and ``n_refits``."""
    dev = _device.resolve(device)
    _check_setting(bundling, representation, "symbol", 0, state)
    generator = torch.Generator(device=dev).manual_seed(seed)
    protos = make_codebook(generator, cfg, None, dev)
    draws = _draw(generator, cfg.n_classes, m, cfg.n_trials, 0.0, cfg.dim, 0,
                  representation, "symbol")
    gens = phy_process.process_generators(seed, dev)
    p0 = process.init(state)
    if adaptive:
        _, traj, trips = phy_process.adaptive_rollout(process, p0, gens, n_steps,
                                                      patience=patience,
                                                      band_kwargs=band_kwargs)
    else:
        _, traj = phy_process.rollout(process, p0, gens, n_steps)
        trips = torch.zeros((n_steps, state.n_rx), dtype=torch.bool, device=dev)
    rows = torch.stack([torch.stack([
        _run_trials(protos, m, 0.0, bundling, representation, cfg.n_trials,
                    channel="symbol", draws=draws, state=p.chan).to(torch.float32).mean(),
        p.chan.ber.mean(), p.chan.ber.max(), p.est.mean()]) for p in traj]).tolist()
    acc, ber_avg, ber_max, est_avg = (list(col) for col in zip(*rows)) if rows else ([],) * 4
    return {"acc": acc, "ber_avg": ber_avg, "ber_max": ber_max, "est_avg": est_avg,
            "refits": trips, "n_refits": int(trips.sum())}


def serve_accuracy(pred, classes) -> dict:
    """Accuracy of serve predictions against the sent classes: ``pred`` and
    ``classes`` share a shape ([B] baseline, [B, M] permuted). ``draw_acc``
    is the share of class draws answered, ``trial_acc`` the share of trials
    with every draw answered (Table I's criterion)."""
    p = np.asarray(pred.cpu() if isinstance(pred, torch.Tensor) else pred)
    c = np.asarray(classes.cpu() if isinstance(classes, torch.Tensor) else classes)
    if p.shape != c.shape:
        raise ValueError(f"pred {p.shape} and classes {c.shape} differ in shape")
    hit = p == c
    return {
        "draw_acc": float(hit.mean()),
        "trial_acc": float(hit.reshape(hit.shape[0], -1).all(axis=-1).mean()),
    }


# ---------------------------------------------------------------------------
# multi-centroid associative memory (MEMHD-style, arXiv 2502.07834)
# ---------------------------------------------------------------------------

def _multicentroid_draws(generator: torch.Generator, protos_p: torch.Tensor, k_c: int,
                        samples_per_class: int, ber) -> tuple[torch.Tensor, torch.Tensor]:
    """The k-means' draws: every class's BSC-noised samples [C, S, W] (one
    `hv.flip_bits_packed` over all classes) and its k_c distinct initial
    picks [C, k_c] (the first k_c of a random permutation of the S
    samples), in that order from ``generator``."""
    c, w = protos_p.shape
    rows = protos_p[:, None, :].expand(c, samples_per_class, w)
    samples = hv.flip_bits_packed(generator, rows, ber)
    draw = torch.rand((c, samples_per_class), generator=generator, device=protos_p.device)
    return samples, draw.argsort(-1)[:, :k_c]


def train_multicentroid(generator: torch.Generator | None, protos: torch.Tensor, k_c: int,
                        *, samples_per_class: int = 32, ber=0.08, n_iters: int = 4,
                        draws=None) -> torch.Tensor:
    """Majority-based k-means in packed space: each class's prototype
    becomes ``k_c`` centroids covering its noisy query distribution.

    protos [C, d] uint8 or [C, W] int32 -> [C, k_c, W] int32 centroids,
    class-major. Per class, ``samples_per_class`` copies of the class HV go
    through a BSC at ``ber``; k_c distinct samples seed the centroids; then
    ``n_iters`` rounds of nearest-centroid assignment (packed Hamming
    distance, ties to the first centroid) and the masked strict-majority
    update (`hv.majority_packed_masked`); an empty cluster keeps its
    centroid. ``draws`` = (samples [C, S, W], init [C, k_c]) replaces the
    draws of `_multicentroid_draws` (the tests replay JAX's); without it they
    come from ``generator``. Runs on the device of ``protos``."""
    protos_p = protos if protos.dtype == torch.int32 else hv.pack(protos)
    c, w = protos_p.shape
    if not 1 <= k_c <= samples_per_class:
        raise ValueError(f"k_c={k_c} outside [1, samples_per_class={samples_per_class}]")
    if draws is None:
        draws = _multicentroid_draws(generator, protos_p, k_c, samples_per_class, ber)
    samples, init = draws                                     # [C, S, W], [C, k_c]
    cent = torch.gather(samples, 1, init.to(torch.int64)[..., None].expand(c, k_c, w))
    members = samples.transpose(0, 1)[:, :, None, :]          # [S, C, 1, W]
    clusters = torch.arange(k_c, device=samples.device)
    for _ in range(n_iters):
        dist = popcount32(samples[:, :, None, :] ^ cent[:, None, :, :]).sum(-1)  # [C, S, k_c]
        assign = torch.argmin(dist, -1)                       # first minimum
        masks = assign[:, :, None] == clusters                # [C, S, k_c]
        new = hv.majority_packed_masked(members, masks.transpose(0, 1))  # [C, k_c, W]
        cent = torch.where(masks.any(1)[..., None], new, cent)
    return cent


def multicentroid_predict(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Top-1 class over a multi-centroid memory: queries [T, d] uint8 or
    [T, W] int32, centroids [C, k_c, W] int32 -> [T] int32 class ids. One
    fused top-1 launch over the [C*k_c] class-major centroid rows, so the
    class is the winning row // k_c and ties go to the lowest class."""
    c, k_c, w = centroids.shape
    qp = queries if queries.dtype == torch.int32 else hv.pack(queries)
    _, amin = hamming_topk_banked(qp[None].contiguous(),
                                  centroids.reshape(1, c * k_c, w).contiguous())
    return (amin[0] // k_c).to(torch.int32)
