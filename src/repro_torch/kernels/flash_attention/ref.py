"""Plain PyTorch versions of the flash attention kernels: the forward, a
transcription of the reference's blockwise scan `_flash_fwd_impl`
(src/repro/models/layers.py) with its block order, its ``NEG_INF`` rule and
its f32 statistics, plus ``q_offset``; and the backward, a transcription of
its FlashAttention-2 custom VJP `_flash_vjp_bwd` in the same order."""
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


def _mask(causal: bool, window: int, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return ok


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = -1, q_offset: int = 0,
                  block_q: int = 512, block_k: int = 1024, return_lse: bool = False):
    """q [B, Sq, H, D]; k, v [B, Skv, KH, D], H % KH == 0 -> [B, Sq, H, D]
    (and, with ``return_lse``, the log-sum-exp [B, H, Sq] f32 of the scaled
    scores, ``m + log(max(l, 1e-30))`` as the reference's forward gives it).

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
    outs, lses = [], []
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
            ok = _mask(causal, window, q_pos, j0 + torch.arange(bk, device=dev))
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
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))    # [B, H, bq]
    if not outs:
        out = torch.empty_like(q)
        lse = torch.empty((b, h, 0), dtype=torch.float32, device=dev)
    else:
        out, lse = torch.cat(outs, dim=1), torch.cat(lses, dim=-1)
    return (out, lse) if return_lse else out


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                  window: int = -1, q_offset: int = 0, block_q: int = 512,
                  block_k: int = 1024):
    """The attention backward: (dq [B, Sq, H, D], dk, dv [B, Skv, KH, D]) in
    the inputs' dtypes, from the forward's ``out`` and ``lse`` [B, H, Sq].

    As `_flash_vjp_bwd`: delta = rowsum(dO * O) in f32; an outer loop over
    kv blocks, an inner one over q blocks; P = exp(s - lse) recomputed per
    block pair under the forward's mask (f32, the reference's
    ``FLASH_P_BF16 = False``), dS = P * (dP - delta) * scale in f32; dK and dV
    accumulated over the q blocks on the expanded heads, then the G query
    heads of each kv head summed onto it; dQ accumulated over kv blocks in
    f32. A row that sees no key has lse = -1e30 and so P = 1 on every key."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    bq, bk = largest_divisor(sq, block_q), largest_divisor(max(skv, 1), block_k)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)      # [B, H, Sq]
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j0 in range(0, skv, bk):
        k_full = expand_kv(k[:, j0:j0 + bk], g).float()
        v_full = expand_kv(v[:, j0:j0 + bk], g).float()
        k_pos = j0 + torch.arange(bk, device=dev)
        dk_acc = torch.zeros((b, bk, h, d), dtype=torch.float32, device=dev)
        dv_acc = torch.zeros_like(dk_acc)
        for i0 in range(0, sq, bq):
            q_blk = q[:, i0:i0 + bq].float()
            do_blk = dout[:, i0:i0 + bq].float()
            q_pos = q_offset + i0 + torch.arange(bq, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_full) * scale
            s = s.masked_fill(~_mask(causal, window, q_pos, k_pos)[None, None], NEG_INF)
            p = torch.exp(s - lse[:, :, i0:i0 + bq, None])               # [B, H, bq, bk]
            dv_acc = dv_acc + torch.einsum("bhqk,bqhd->bkhd", p, do_blk)
            dp = torch.einsum("bqhd,bkhd->bhqk", do_blk, v_full)
            ds = p * (dp - delta[:, :, i0:i0 + bq, None]) * scale
            dq[:, i0:i0 + bq] += torch.einsum("bhqk,bkhd->bqhd", ds, k_full)
            dk_acc = dk_acc + torch.einsum("bhqk,bqhd->bkhd", ds, q_blk)
        dks.append(dk_acc.reshape(b, bk, kh, g, d).sum(3))
        dvs.append(dv_acc.reshape(b, bk, kh, g, d).sum(3))
    if dks:
        dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
    else:
        dk, dv = torch.zeros_like(k, dtype=torch.float32), torch.zeros_like(v, dtype=torch.float32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
