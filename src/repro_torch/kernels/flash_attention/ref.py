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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), back in f32."""
    return x.to(torch.bfloat16).float()


def _bf16x2(x: torch.Tensor) -> torch.Tensor:
    """x as the sum of two bf16 terms, hi = bf16(x) and lo = bf16(x - hi)."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


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
                  block_k: int = 1024, p_bf16: int = 0):
    """The attention backward: (dq [B, Sq, H, D], dk, dv [B, Skv, KH, D]) in
    the inputs' dtypes, from the forward's ``out`` and ``lse`` [B, H, Sq].

    As `_flash_vjp_bwd`: delta = rowsum(dO * O) in f32; an outer loop over
    kv blocks, an inner one over q blocks; P = exp(s - lse) recomputed per
    block pair under the forward's mask (f32, the reference's
    ``FLASH_P_BF16 = False``), dS = P * (dP - delta) * scale in f32; dK and dV
    accumulated over the q blocks on the expanded heads, then the G query
    heads of each kv head summed onto it; dQ accumulated over kv blocks in
    f32. A row that sees no key has lse = -1e30 and so P = 1 on every key.

    ``p_bf16`` is the number of bf16 terms that carry P and dS into the
    three gradient products dV += P^T dO, dK += dS^T q and dQ = dS k, whose
    other operands dO, k and q are then rounded to bf16 too (exact for bf16
    inputs); every product still sums in f32. 0 keeps P and dS in f32. 1
    rounds each to bf16, the reference's ``FLASH_P_BF16 = True`` (dS formed
    from the rounded P). 2 carries each as bf16 hi + lo, hi = bf16(x) and
    lo = bf16(x - hi), 16 significant bits: the bf16 kernel's arithmetic
    (dS formed from the f32 P)."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    bq, bk = largest_divisor(sq, block_q), largest_divisor(max(skv, 1), block_k)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    if p_bf16 not in (0, 1, 2):
        raise ValueError(f"flash_bwd_ref: p_bf16 must be 0, 1 or 2, got {p_bf16}")
    same = lambda x: x                          # noqa: E731
    op = _bf16 if p_bf16 else same              # dO, k, q in a gradient product
    terms = {0: same, 1: _bf16, 2: _bf16x2}[p_bf16]     # P and dS in one
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
            if p_bf16 == 1:
                p = _bf16(p)
            dv_acc = dv_acc + torch.einsum("bhqk,bqhd->bkhd", terms(p), op(do_blk))
            dp = torch.einsum("bqhd,bkhd->bhqk", do_blk, v_full)
            ds = terms(p * (dp - delta[:, :, i0:i0 + bq, None]) * scale)
            dq[:, i0:i0 + bq] += torch.einsum("bhqk,bkhd->bqhd", ds, op(k_full))
            dk_acc = dk_acc + torch.einsum("bhqk,bqhd->bkhd", ds, op(q_blk))
        dks.append(dk_acc.reshape(b, bk, kh, g, d).sum(3))
        dvs.append(dv_acc.reshape(b, bk, kh, g, d).sum(3))
    if dks:
        dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
    else:
        dk, dv = torch.zeros_like(k, dtype=torch.float32), torch.zeros_like(v, dtype=torch.float32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_exact(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, *,
                    causal: bool = True, window: int = -1, q_offset: int = 0):
    """The attention backward in f64 (dq, dk, dv), batch row by batch row and
    kv head by kv head (its G query heads at once, so that a long sequence's
    f64 scores stay a few GB): the yardstick the bf16 backward is held to.
    The reference's formula (FlashAttention-2's, P = exp(s - lse)) on exact
    scores, with O the f64 softmax attention; a row that sees no key has
    lse = -1e30 here too (f64 rounds -1e30 + log Skv back to -1e30), so
    P = 1 on every key, as the reference and the kernel give it."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    ok = _mask(causal, window, q_offset + torch.arange(sq, device=q.device),
               torch.arange(skv, device=q.device))
    outs = []
    for i in range(b):
        dqs, dks, dvs = [], [], []
        for j in range(kh):
            qd, gd = (x[i, :, j * g:(j + 1) * g].double() for x in (q, dout))   # [Sq, G, D]
            kd, vd = k[i, :, j].double(), v[i, :, j].double()                   # [Skv, D]
            s = torch.einsum("qhd,kd->hqk", qd, kd) / math.sqrt(d)
            s = s.masked_fill(~ok, NEG_INF)
            m = s.amax(-1, keepdim=True)
            pu = torch.exp(s - m)
            lsum = pu.sum(-1, keepdim=True)
            o = torch.einsum("hqk,kd->qhd", pu / lsum, vd)
            p = torch.exp(s - (m + torch.log(lsum)))
            del pu, s
            dvs.append(torch.einsum("hqk,qhd->kd", p, gd))
            dp = torch.einsum("qhd,kd->hqk", gd, vd)
            delta = (gd * o).sum(-1).transpose(0, 1)[..., None]
            ds = p * (dp - delta) / math.sqrt(d)
            del p, dp
            dqs.append(torch.einsum("hqk,kd->qhd", ds, kd))
            dks.append(torch.einsum("hqk,qhd->kd", ds, qd))
            del ds
        outs.append((torch.cat(dqs, 1), torch.stack(dks, 1), torch.stack(dvs, 1)))
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))
