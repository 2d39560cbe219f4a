"""Building blocks of the LM families (counterpart of
`repro/models/layers.py`): norms, activations, projections, rotate-half RoPE
(with Qwen2-VL's M-RoPE sections), Whisper's sinusoid positions and
attention.

Norm, RoPE and softmax math runs in f32 whatever the activation dtype, and
products accumulate in f32, as the reference's do. The prefill attention is
the hand-written kernel behind `kernels.flash_attention.flash_attention_fwd`
(its plain twin on CPU tensors) and, when an input needs a gradient, the
autograd function `FlashAttention`, whose backward is the hand-written
backward kernel (its twin on the CPU); the decode attention over the (ring) KV
cache is plain tensor code, as in the reference, which has no kernel there.
The reference's A/B switches (custom VJP, early KV expansion, bf16 P, bf16
reductions) are not carried: the port behaves as their defaults do.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.kernels.flash_attention.ops import FlashAttention, flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import NEG_INF, expand_kv, largest_divisor

_expand_kv = expand_kv
_largest_divisor = largest_divisor


# ---------------------------------------------------------------------------
# norms / activations / projections
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + gain`` (gains start at zero)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gain.float())).to(x.dtype)


def layernorm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in f32 (biased variance), scaled by ``gain`` plus ``bias``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gain.float() + bias.float()).to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., d_in] @ [d_in, d_out] in x's dtype (f32 accumulation)."""
    return torch.matmul(x, w)


def gated_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
              act: str) -> torch.Tensor:
    h = act_fn(act)(dense(x, wg).float()).to(x.dtype) * dense(x, wu)
    return dense(h, wd)


# ---------------------------------------------------------------------------
# rotary position embeddings (rotate-half, and M-RoPE) and sinusoids
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions [...] -> angles [..., head_dim//2] (f32)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(float(theta), exps)      # f32, as the reference's f32 pow
    return positions[..., None].float() * freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """Rotate q/k: x [B, S, H, D], positions [B, S], or [B, S, K] under
    M-RoPE (Qwen2-VL). The first half of D pairs with the second half
    (rotate-half, not interleaved pairs). M-RoPE splits the D/2 frequency
    slots into ``sections`` (t, h, w): slot group i takes its angle from
    positions[..., i]; text tokens carry t = h = w, so for them M-RoPE is
    1-D RoPE."""
    d = x.shape[-1]
    if sections is None:
        ang = _rope_angles(positions, d, theta)                  # [B, S, D/2]
    else:
        if positions.shape[-1] != len(sections):
            raise ValueError(f"M-RoPE positions {tuple(positions.shape)} need one stream a "
                             f"section of {sections}")
        if sum(sections) != d // 2:
            raise ValueError(f"M-RoPE sections {sections} must cover the {d // 2} "
                             "frequency slots of D/2")
        ang_k = _rope_angles(positions, d, theta)                # [B, S, K, D/2]
        slot = torch.arange(d // 2, device=x.device)
        sec_id = torch.zeros_like(slot)                          # [D/2]: each slot's stream
        for edge in itertools.accumulate(sections[:-1]):
            sec_id += slot >= edge
        ang = ang_k.gather(-2, sec_id.expand(*ang_k.shape[:-2], 1, d // 2))[..., 0, :]
    cos = torch.cos(ang)[..., None, :]                            # [B, S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(seq: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings [seq, d_model] (f32): sines
    of the first half, cosines of the second, at geometric frequencies from
    1 to 1/10000."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=device) / (half - 1))
    ang = torch.arange(seq, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention — the flash kernel (prefill) and direct (decode)
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = -1, q_offset: int = 0,
                    block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """Attention forward with an online softmax. q [B, Sq, H, D]; k, v
    [B, Skv, KH, D] with H % KH == 0. `window` > 0 masks keys with
    q_pos - k_pos >= window; -1 (or any negative) means global. Query i sits
    at position ``q_offset + i``. ``block_q``/``block_k`` tile the plain twin
    (clipped to divisors of the sequence lengths, as in the reference). When
    grad mode is on and an input needs a gradient, the call goes through
    `FlashAttention` (the forward kernel with its log-sum-exp, then the
    backward kernel); otherwise it is the serve paths' forward alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, int(window), int(q_offset), block_q,
                                    block_k)
    return flash_attention_fwd(q, k, v, causal=causal, window=int(window),
                               q_offset=int(q_offset), block_q=block_q, block_k=block_k)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     slot_pos: torch.Tensor, cur_pos: int | torch.Tensor, *,
                     window: int = -1, group=None, slot_base: int = 0) -> torch.Tensor:
    """Single-token attention over a (ring) KV cache.

    q [B, 1, H, D]; caches [B, Sc, KH, D]; slot_pos [Sc] (one for the whole
    batch) or [B, Sc] (one a row) = absolute position held by each cache
    slot (-1 = empty); cur_pos = the current decode position, an int or an
    int32 tensor [B] (one a row, as the continuous engine's slots decode).
    Scores and softmax in f32; P cast to the cache's dtype for the P.V
    product, as in the reference. The query heads of one kv head are
    grouped instead of expanding the cache.

    With a ``group`` (the model ranks of a cache cut over its sequence),
    the caches hold this rank's slots [slot_base, slot_base + Sc) of
    the whole slot_pos (one position for the batch), every query head
    attends over them, and the ranks' partial softmaxes are merged over the
    group: M = max_r m_r, L = sum_r l_r e^(m_r - M), O = sum_r o_r e^(m_r -
    M) / L. Masked scores stay at the finite NEG_INF, so a rank with no
    visible slot adds nothing next to one that has some, and a row with
    none anywhere takes the mean over every slot, as on one rank."""
    b, _, h, d = q.shape
    sc, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kh, g, d).float()                               # [B, KH, G, D]
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale  # [B, KH, G, Sc]
    if group is not None:
        if isinstance(cur_pos, torch.Tensor) or slot_pos.dim() != 1:
            raise ValueError("a cache cut over its sequence decodes one position for the batch")
        slot_pos = slot_pos[slot_base:slot_base + sc]
    cur = cur_pos[:, None] if isinstance(cur_pos, torch.Tensor) else cur_pos
    ok = (slot_pos >= 0) & (slot_pos <= cur)                          # [Sc] or [B, Sc]
    if window > 0:
        ok &= (cur - slot_pos) < window
    if ok.dim() == 2:
        ok = ok[:, None, None, :]
    s = s.masked_fill(~ok, NEG_INF)
    if group is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
        return out.reshape(b, 1, h, d).to(q.dtype)
    m = s.amax(-1, keepdim=True)                                      # [B, KH, G, 1]
    p = torch.exp(s - m)
    l_ = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    top = collectives.all_reduce_max(m, group)
    w = torch.exp(m - top)
    den = collectives.all_reduce(l_ * w, group)
    out = collectives.all_reduce(o * w, group) / den
    return out.reshape(b, 1, h, d).to(q.dtype)
