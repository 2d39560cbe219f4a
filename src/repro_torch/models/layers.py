"""Building blocks of the dense decoder (counterpart of
`repro/models/layers.py`): norms, activations, projections, rotate-half RoPE
and attention.

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

import math

import torch
import torch.nn.functional as F

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
# rotary position embeddings (rotate-half)
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions [...] -> angles [..., head_dim//2] (f32)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(float(theta), exps)      # f32, as the reference's f32 pow
    return positions[..., None].float() * freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """Rotate q/k: x [B, S, H, D], positions [B, S]. The first half of D
    pairs with the second half (rotate-half, not interleaved pairs)."""
    if sections is not None:
        raise NotImplementedError("M-RoPE sections wait for the VLM slice "
                                  "(ROADMAP §1, LM stack)")
    ang = _rope_angles(positions, x.shape[-1], theta)            # [B, S, D/2]
    cos = torch.cos(ang)[..., None, :]                            # [B, S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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
                     window: int = -1) -> torch.Tensor:
    """Single-token attention over a (ring) KV cache.

    q [B, 1, H, D]; caches [B, Sc, KH, D]; slot_pos [Sc] (one for the whole
    batch) or [B, Sc] (one a row) = absolute position held by each cache
    slot (-1 = empty); cur_pos = the current decode position, an int or an
    int32 tensor [B] (one a row, as the continuous engine's slots decode).
    Scores and softmax in f32; P cast to the cache's dtype for the P.V
    product, as in the reference. The query heads of one kv head are
    grouped instead of expanding the cache."""
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kh, g, d).float()                               # [B, KH, G, D]
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale  # [B, KH, G, Sc]
    cur = cur_pos[:, None] if isinstance(cur_pos, torch.Tensor) else cur_pos
    ok = (slot_pos >= 0) & (slot_pos <= cur)                          # [Sc] or [B, Sc]
    if window > 0:
        ok &= (cur - slot_pos) < window
    if ok.dim() == 2:
        ok = ok[:, None, None, :]
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
