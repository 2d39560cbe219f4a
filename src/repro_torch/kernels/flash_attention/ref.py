"""Plain PyTorch version of the flash attention forward kernel: a
transcription of the reference's blockwise scan `_flash_fwd_impl`
(src/repro/models/layers.py) with its block order, its ``NEG_INF`` rule and
its f32 statistics, plus ``q_offset``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (blocks tile the sequence)."""
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, KH, D] -> [B, S, KH*G, D] by repeating each kv head G times."""
    if groups == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, groups, d).reshape(b, s, kh * groups, d)


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = -1, q_offset: int = 0,
                  block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Skv, KH, D], H % KH == 0 -> [B, Sq, H, D].

    Query i sits at position ``q_offset + i``; keys at 0..Skv-1. The mask
    keeps ``k_pos <= q_pos`` when causal and ``q_pos - k_pos < window`` when
    window > 0. Block sizes are clipped to divisors of Sq and Skv, as the
    reference's ``flash_attention`` clips them. Scores, m, l and the
    accumulator are f32; P is cast to v's dtype for the P.V product, as in
    the reference."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    bq, bk = largest_divisor(sq, block_q), largest_divisor(max(skv, 1), block_k)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    outs = []
    for i0 in range(0, sq, bq):
        q_blk = q[:, i0:i0 + bq].float()
        q_pos = q_offset + i0 + torch.arange(bq, device=dev)
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, bq, d), dtype=torch.float32, device=dev)
        for j0 in range(0, skv, bk):
            k_full = expand_kv(k[:, j0:j0 + bk], g)
            v_full = expand_kv(v[:, j0:j0 + bk], g)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_full.float()) * scale
            k_pos = j0 + torch.arange(bk, device=dev)
            ok = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                ok &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                ok &= (q_pos[:, None] - k_pos[None, :]) < window
            s = s.masked_fill(~ok[None, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype).float(), v_full.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))             # [B, bq, H, D]
    if not outs:
        return torch.empty_like(q)
    return torch.cat(outs, dim=1)
