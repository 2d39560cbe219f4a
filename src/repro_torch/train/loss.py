"""Chunked cross-entropy (counterpart of `repro/train/loss.py`): the full
[B, S, V] logits never materialize.

The sequence is cut into chunks, the largest divisor of S that is <= `chunk`,
and each chunk's logits are produced, consumed and freed under
``torch.utils.checkpoint``, which recomputes them in the backward pass (the
reference's ``jax.checkpoint`` around its scan body). A chunk's logits are
the product in the model's dtype, f32-accumulated: f32 for an f32 model, as
in the reference; for a bf16 model the product is rounded to bf16 once
before the f32 log-sum-exp, where the reference keeps the f32 accumulator
(its TPU product rounds the inputs to bf16 alike). An f32 product of
[d, V] = [2048, 32000] on every chunk would cost the card's f32 rate.

With the vocabulary cut over a model group (``group``; ``w`` holds columns
[vocab_start, vocab_start + V_l)) each chunk's max, sum of exponentials and
target logit are reduced over the group (`_VocabParallelNLL`), the
reference's note in `repro/train/loss.py`; with ``count_groups`` (the data
ranks) the token count is the global batch's, so each data rank's loss is
its share of the global mean and the shares sum to it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives


def _chunk_nll(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor):
    """h [B, C, d], w [d, V], targets [B, C] (int64), valid [B, C] f32 ->
    (sum nll, sum count)."""
    logits = torch.matmul(h, w).float()
    lse = torch.logsumexp(logits, dim=-1)
    # the target's logit as the reference picks it: a select and a sum, whose
    # backward is a select (gather's would scatter-add, which CUDA runs with
    # atomics, outside torch's deterministic algorithms)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    tgt = torch.where(iota == targets[..., None], logits, 0.0).sum(-1)
    nll = (lse - tgt) * valid
    return nll.sum(), valid.sum()


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL of f32 logits [B, C, V_l] whose vocabulary is cut over
    ``group``, this rank's columns starting at ``start``: the max, the sum
    of exponentials and the target's logit are each reduced over the group
    (max, sum, sum). The backward is the local softmax minus the one-hot
    target, scaled by the incoming gradient and ``valid``; the logits'
    gradient stays on this rank."""

    @staticmethod
    def forward(ctx, logits, targets, valid, start, group):
        m = collectives.all_reduce_max(logits.amax(-1), group)
        se = collectives.all_reduce(torch.exp(logits - m[..., None]).sum(-1), group)
        lse = m + torch.log(se)
        hit = _hits(logits, targets, start)
        tgt = collectives.all_reduce(torch.where(hit, logits, 0.0).sum(-1), group)
        ctx.save_for_backward(logits, lse, targets, valid)
        ctx.start = start
        return (lse - tgt) * valid

    @staticmethod
    def backward(ctx, g):
        logits, lse, targets, valid = ctx.saved_tensors
        p = torch.exp(logits - lse[..., None])
        d = (p - _hits(logits, targets, ctx.start).float()) * (g * valid)[..., None]
        return d, None, None, None, None


def _hits(logits: torch.Tensor, targets: torch.Tensor, start: int) -> torch.Tensor:
    """Where a row's target sits among this rank's vocabulary columns."""
    iota = torch.arange(logits.shape[-1], device=logits.device) + start
    return iota == targets[..., None]


def _chunk_nll_split(h, w, targets, valid, start: int, group):
    logits = torch.matmul(h, w).float()
    nll = _VocabParallelNLL.apply(logits, targets, valid, start, group)
    return nll.sum(), valid.sum()


def chunked_cross_entropy(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, *,
                          mask: torch.Tensor | None = None, chunk: int = 512,
                          ignore_id: int = -1, group=None, vocab_start: int = 0,
                          count_groups: tuple = ()) -> torch.Tensor:
    """Mean token NLL (f32). h [B, S, d]; w [d, V]; targets [B, S], positions
    holding ``ignore_id`` skipped; ``mask`` [B, S] weights the rest. With
    ``group`` w is this rank's [d, V_l] columns from ``vocab_start`` of a
    vocabulary cut over the group; with ``count_groups`` the count is
    summed over those groups (the mean's denominator is the global
    batch's)."""
    b, s, d = h.shape
    c = min(chunk, s)
    while s % c:  # largest divisor <= chunk
        c -= 1
    valid = (targets != ignore_id).float()
    if mask is not None:
        valid = valid * mask.float()
    tgt = torch.where(targets == ignore_id, 0, targets).long()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i0 in range(0, s, c):
        # the loss draws no random numbers: no RNG state to keep
        part = (tgt[:, i0:i0 + c], valid[:, i0:i0 + c])
        if group is None:
            nll, k = checkpoint(_chunk_nll, h[:, i0:i0 + c], w, *part,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            nll, k = checkpoint(_chunk_nll_split, h[:, i0:i0 + c], w, *part, vocab_start,
                                group, use_reentrant=False, preserve_rng_state=False)
        tot = tot + nll
        cnt = cnt + k
    cnt = collectives.all_reduce_groups(cnt, count_groups)
    return tot / torch.clamp(cnt, min=1.0)
