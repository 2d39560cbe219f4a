"""Dense decoder-only transformer stack (counterpart of
`repro/models/transformer.py`; llama/gemma family).

Layers are stacked along a leading L axis, in the reference's layouts
(``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``, ...), and run by a Python loop;
per-layer heterogeneity (sliding window, dual RoPE theta) comes from
`layer_meta`. The decode takes one position for the whole batch (the
static engine) or one a row on the device (the continuous engine's slots),
and the chunked prefill (`run_stack_chunk`) runs one chunk of a prompt on
the attention kernel's ``q_offset``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve
from repro_torch.models.base import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    decode_attention,
    flash_attention,
    gated_mlp,
    rmsnorm,
)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    l = cfg.n_layers if layers is None else layers
    hd, h, kh, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    lead = () if l == 0 else (l,)
    p = {
        "wq": ParamSpec(lead + (d, h, hd), "fan_in", dtype=cfg.dtype),
        "wk": ParamSpec(lead + (d, kh, hd), "fan_in", dtype=cfg.dtype),
        "wv": ParamSpec(lead + (d, kh, hd), "fan_in", dtype=cfg.dtype),
        "wo": ParamSpec(lead + (h, hd, d), "fan_in", dtype=cfg.dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec(lead + (hd,), "zeros", dtype=cfg.dtype)
        p["k_norm"] = ParamSpec(lead + (hd,), "zeros", dtype=cfg.dtype)
    return p


def mlp_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    l = cfg.n_layers if layers is None else layers
    d, f = cfg.d_model, cfg.d_ff
    lead = () if l == 0 else (l,)
    return {
        "wg": ParamSpec(lead + (d, f), "fan_in", dtype=cfg.dtype),
        "wu": ParamSpec(lead + (d, f), "fan_in", dtype=cfg.dtype),
        "wd": ParamSpec(lead + (f, d), "fan_in", dtype=cfg.dtype),
    }


def decoder_specs(cfg: ModelConfig) -> dict:
    l, d = cfg.n_layers, cfg.d_model
    blocks: dict[str, Any] = {
        "attn": attn_specs(cfg),
        "ln1": ParamSpec((l, d), "zeros", dtype=cfg.dtype),
        "ln2": ParamSpec((l, d), "zeros", dtype=cfg.dtype),
    }
    if cfg.sandwich_norm:
        blocks["ln1_post"] = ParamSpec((l, d), "zeros", dtype=cfg.dtype)
        blocks["ln2_post"] = ParamSpec((l, d), "zeros", dtype=cfg.dtype)
    blocks["mlp"] = mlp_specs(cfg)
    specs = {
        "embed": ParamSpec((cfg.vocab, d), "normal", 0.02, cfg.dtype),
        "blocks": blocks,
        "final_norm": ParamSpec((d,), "zeros", dtype=cfg.dtype),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab), "fan_in", dtype=cfg.dtype)
    return specs


# ---------------------------------------------------------------------------
# per-layer window / rope theta
# ---------------------------------------------------------------------------

def layer_meta(cfg: ModelConfig) -> tuple[list[int], list[float]]:
    """Each layer's window (-1 = global) and RoPE theta (the local theta on
    windowed layers when the config has one)."""
    windows = list(cfg.windows)
    if cfg.local_rope_theta is not None:
        thetas = [cfg.local_rope_theta if w > 0 else cfg.rope_theta for w in windows]
    else:
        thetas = [cfg.rope_theta] * cfg.n_layers
    return windows, thetas


def _layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked parameter tree (views, no copies)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_heads(blk: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                theta: float):
    b, s, d = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ blk["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    k = (x @ blk["wk"].reshape(d, kh * hd)).reshape(b, s, kh, hd)
    v = (x @ blk["wv"].reshape(d, kh * hd)).reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, blk["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, blk["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def _attn_out(blk: dict, cfg: ModelConfig, o: torch.Tensor) -> torch.Tensor:
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.n_heads * cfg.hd) @ blk["wo"].reshape(-1, cfg.d_model)


def _mlp_residual(blk: dict, cfg: ModelConfig, x: torch.Tensor, o: torch.Tensor):
    if cfg.sandwich_norm:
        o = rmsnorm(o, blk["ln1_post"], cfg.norm_eps)
    x = x + o
    h = rmsnorm(x, blk["ln2"], cfg.norm_eps)
    m = gated_mlp(h, blk["mlp"]["wg"], blk["mlp"]["wu"], blk["mlp"]["wd"], cfg.act)
    if cfg.sandwich_norm:
        m = rmsnorm(m, blk["ln2_post"], cfg.norm_eps)
    return x + m


def attn_block_prefill(blk: dict, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, window: int, theta: float):
    """The forward of the reference's ``attn_block_train(return_kv=True)``:
    returns (x, (k, v)) with k after qk-norm and RoPE."""
    h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = _attn_heads(blk["attn"], cfg, h, positions, theta)
    o = flash_attention(q, k, v, causal=True, window=window,
                        block_q=cfg.flash_block_q, block_k=cfg.flash_block_k)
    return _mlp_residual(blk, cfg, x, _attn_out(blk["attn"], cfg, o)), (k, v)


def attn_block_decode(blk: dict, cfg: ModelConfig, x: torch.Tensor, pos, window: int,
                      theta: float, kc: torch.Tensor, vc: torch.Tensor,
                      slot_pos: torch.Tensor, where: tuple) -> torch.Tensor:
    """x [B, 1, d]; kc/vc [B, Sc, KH, hd], written in place at ``where``
    (``(slice(None), slot)`` for one position, ``(rows, slots)`` for one a
    row); pos an int or an int32 tensor [B]."""
    if isinstance(pos, torch.Tensor):
        positions = pos[:, None]
    else:
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = _attn_heads(blk["attn"], cfg, h, positions, theta)
    kc[where] = k[:, 0]
    vc[where] = v[:, 0]
    o = decode_attention(q, kc, vc, slot_pos, pos, window=window)
    return _mlp_residual(blk, cfg, x, _attn_out(blk["attn"], cfg, o))


# ---------------------------------------------------------------------------
# stack runners
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.emb_scale:    # sqrt(d) rounded to the model's dtype first, as in the reference
        x = x * float(torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype))
    return x.to(cfg.dtype)


def logits_head(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocabulary projection; f32 logits, as the
    reference's f32-accumulated einsum gives them."""
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h.float(), w.float())


def run_stack_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor):
    """Full-sequence causal stack: (hidden [B, S, d], (k, v) stacks
    [L, B, S, KH, hd])."""
    windows, thetas = layer_meta(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = attn_block_prefill(_layer(params["blocks"], i), cfg, x, positions,
                                       windows[i], thetas[i])
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks), torch.stack(vs))


def cache_from_kv(cfg: ModelConfig, kv, seq: int, pad_to: int | None = None) -> dict:
    """Build a decode cache from prefill K/V stacks [L, B, S, KH, hd].

    For pure sliding-window models the cache is a ring of the largest window
    (slot = pos % window; further decodes wrap correctly). Otherwise the cache
    is full-length, optionally padded to `pad_to` capacity so decode can extend
    beyond the prompt without evicting position 0.
    """
    k, v = kv
    dev = k.device
    sc = seq if cfg.max_window < 0 else min(seq, cfg.max_window)
    if sc < seq:  # ring buffer holds the last sc positions at slot = pos % sc
        shift = seq % sc
        k = torch.roll(k[:, :, seq - sc:], shift, dims=2)
        v = torch.roll(v[:, :, seq - sc:], shift, dims=2)
        pos = torch.arange(seq - sc, seq, dtype=torch.int32, device=dev)
        return {"k": k, "v": v, "slot_pos": torch.roll(pos, shift)}
    slot_pos = torch.arange(seq, dtype=torch.int32, device=dev)
    return pad_kv_cache({"k": k, "v": v, "slot_pos": slot_pos}, pad_to)


def pad_kv_cache(cache: dict, pad_to: int | None) -> dict:
    """Grow a full-length cache's capacity (axis 2 of k/v) to `pad_to` slots."""
    seq = cache["k"].shape[2]
    if pad_to is None or pad_to <= seq:
        return cache
    extra = pad_to - seq
    out = dict(cache)
    for name in ("k", "v"):
        t = cache[name]
        shape = list(t.shape)
        shape[2] = extra
        out[name] = torch.cat([t, t.new_zeros(shape)], dim=2)
    out["slot_pos"] = torch.cat([cache["slot_pos"],
                                 cache["slot_pos"].new_full((extra,), -1)])
    return out


def run_stack_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, pos, cache: dict):
    """One decode step. ``pos`` is an int (every row at one position; the
    cache's ``slot_pos`` [Sc]) or an int32 tensor [B] on the device (one
    position a row; ``slot_pos`` [B, Sc]): each row writes its K/V at its
    own slot ``pos % Sc`` with one indexed write a layer, and nothing is
    read back to the host. Writes the step's K/V into the cache's k/v
    tensors in place (the reference returns new arrays; the port saves the
    copy) and returns (hidden, cache with the new slot_pos)."""
    windows, thetas = layer_meta(cfg)
    sc = cache["k"].shape[2]
    slot_pos = cache["slot_pos"].clone()
    if isinstance(pos, torch.Tensor) != (slot_pos.dim() == 2):
        raise ValueError("per-row positions need a per-row slot_pos [B, Sc], an int "
                         "position a shared slot_pos [Sc]")
    if isinstance(pos, torch.Tensor):
        where = (torch.arange(x.shape[0], device=x.device), (pos % sc).long())
        slot_pos[where] = pos
    else:
        where = (slice(None), pos % sc)
        slot_pos[pos % sc] = pos
    for i in range(cfg.n_layers):
        x = attn_block_decode(_layer(params["blocks"], i), cfg, x, pos, windows[i],
                              thetas[i], cache["k"][i], cache["v"][i], slot_pos, where)
    return x, dict(cache, slot_pos=slot_pos)


def run_stack_chunk(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, cache: dict, start: int):
    """One prefill chunk: x [B, cs, d] at positions [start, start + cs) of a
    prompt, attending over the K/V that earlier chunks wrote plus its own.

    Each layer writes the chunk's K/V at [start, stop) of the full-capacity
    cache, in place, and runs the attention kernel on the cache's prefix
    ``[:, :stop]`` with ``q_offset = start``: chunks fill the cache front to
    back, so the causal mask over keys [0, stop) is the full prefill's. The
    prefix of a B = 1 cache is contiguous, as the kernel needs. Returns
    (hidden, cache with slot_pos[start:stop] set). Dense decoder only, as
    in the reference; the cache must not be a ring (the engine checks)."""
    windows, thetas = layer_meta(cfg)
    stop = start + x.shape[1]
    if stop > cache["k"].shape[2]:
        raise ValueError(f"chunk [{start}, {stop}) past the cache's {cache['k'].shape[2]} slots")
    slot_pos = cache["slot_pos"].clone()
    slot_pos[start:stop] = torch.arange(start, stop, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = _attn_heads(blk["attn"], cfg, h, positions, thetas[i])
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, start:stop] = k
        vc[:, start:stop] = v
        o = flash_attention(q, kc[:, :stop], vc[:, :stop], causal=True, window=windows[i],
                            q_offset=start,
                            block_q=cfg.flash_block_q, block_k=cfg.flash_block_k)
        x = _mlp_residual(blk, cfg, x, _attn_out(blk["attn"], cfg, o))
    return x, dict(cache, slot_pos=slot_pos)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, layers: int | None = None,
               device="cuda") -> dict:
    """An empty KV cache on ``device`` (the card unless the caller asks for
    another; raises without CUDA, as every entry point does). For pure
    sliding-window models the cache is a ring buffer of the largest window;
    otherwise full length."""
    device = resolve(device)
    l = layers if layers is not None else cfg.n_layers
    sc = seq if cfg.max_window < 0 else min(seq, cfg.max_window)
    kv = (l, batch, sc, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "v": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "slot_pos": torch.full((sc,), -1, dtype=torch.int32, device=device),
    }
