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
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


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


def chunked_cross_entropy(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, *,
                          mask: torch.Tensor | None = None, chunk: int = 512,
                          ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL (f32). h [B, S, d]; w [d, V]; targets [B, S], positions
    holding ``ignore_id`` skipped; ``mask`` [B, S] weights the rest."""
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
        nll, k = checkpoint(_chunk_nll, h[:, i0:i0 + c], w, tgt[:, i0:i0 + c],
                            valid[:, i0:i0 + c], use_reentrant=False, preserve_rng_state=False)
        tot = tot + nll
        cnt = cnt + k
    return tot / torch.clamp(cnt, min=1.0)
