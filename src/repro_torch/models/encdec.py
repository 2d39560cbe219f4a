"""Whisper-style encoder-decoder backbone (counterpart of
`repro/models/encdec.py`).

The conv/mel frontend is a stub, as in the reference: the batch holds
precomputed frame embeddings ``frames`` [B, T_enc, d]. The encoder is a
non-causal transformer over the frames with fixed sinusoid positions; the
decoder adds causal self-attention and cross-attention to the encoder's
output, with sinusoid positions in place of Whisper's learned table (so any
cache length is defined). Blocks are pre-RMSNorm, as the reference's are.
Attention projections carry no RoPE and no qk-norm, so this module has its
own projections rather than `transformer._attn_heads`, which rotates.

Every prefill attention (the encoder's, the decoder's self- and
cross-attention) is the hand-written forward kernel behind
`layers.flash_attention` (its plain twin on CPU tensors); the decode step
attends over its caches with the plain `layers.decode_attention`, as the
reference does. The decode writes its K/V into the cache's tensors in place
at each row's slot; the cross K/V (``ck``/``cv``) are read, never written.

Training across ranks (``tp``) runs every projection on the rank's heads
and MLP columns, as the dense decoder's tensor-parallel layers do: the
encoder's and the decoder's self-attention, the cross-attention (its K/V
from the encoder states, whole on every model rank) and the gelu MLP.
Inference across ranks runs the same shards; the decode attends over the
rank's piece of each cache, the self K/V and the cross K/V each placed as
the rules engine cuts them (`transformer.cache_attend`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.distributed import collectives
from repro_torch.models import transformer as tfm
from repro_torch.models.base import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import flash_attention, rmsnorm, sinusoid_positions
from repro_torch.models.transformer import _layers, attn_specs, mlp_specs


def encdec_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    le, ld = cfg.n_enc_layers, cfg.n_layers

    def blockset(l):
        return {
            "attn": attn_specs(cfg, layers=l),
            "mlp": mlp_specs(cfg, layers=l),
            "ln1": ParamSpec((l, d), (None, "embed"), "zeros", dtype=cfg.dtype),
            "ln2": ParamSpec((l, d), (None, "embed"), "zeros", dtype=cfg.dtype),
        }

    dec = blockset(ld)
    dec["xattn"] = attn_specs(cfg, layers=ld)
    dec["lnx"] = ParamSpec((ld, d), (None, "embed"), "zeros", dtype=cfg.dtype)
    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02, cfg.dtype),
        "enc_blocks": blockset(le),
        "dec_blocks": dec,
        "enc_norm": ParamSpec((d,), ("embed",), "zeros", dtype=cfg.dtype),
        "final_norm": ParamSpec((d,), ("embed",), "zeros", dtype=cfg.dtype),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, heads, hd] -> [B, S, heads, hd] in x's dtype."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).reshape(b, s, w.shape[-2], w.shape[-1])


def _proj_qkv(blk: dict, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig | None = None,
              tp=None):
    """q from ``xq``, k and v from ``xkv``: no RoPE, no qk-norm. With the
    heads cut over the model group (``tp``) the rank's heads, its inputs
    through `copy_to_group` and whole kv heads narrowed to the ones its q
    heads read, as `transformer._attn_heads` takes them."""
    wk, wv = blk["wk"], blk["wv"]
    h = blk["wq"].shape[-2]
    group = None if tp is None else collectives.cut_group(tp, h, cfg.n_heads)
    if group is not None:
        same = xkv is xq
        xq = collectives.copy_to_group(xq, group)
        xkv = xq if same else collectives.copy_to_group(xkv, group)
        if wk.shape[-2] == cfg.n_kv_heads:
            wk = tfm._kv_for_rank(collectives.copy_to_group(wk, group), tp, h, cfg)
            wv = tfm._kv_for_rank(collectives.copy_to_group(wv, group), tp, h, cfg)
    return _proj(xq, blk["wq"]), _proj(xkv, wk), _proj(xkv, wv)


def _out(blk: dict, o: torch.Tensor, dtype: torch.dtype, cfg: ModelConfig | None = None,
         tp=None) -> torch.Tensor:
    """The output projection of the rank's heads, summed over the model
    group when they are cut."""
    b, s, h, hd = o.shape
    out = (o.reshape(b, s, h * hd) @ blk["wo"].reshape(h * hd, -1)).to(dtype)
    return out if tp is None else collectives.reduce_from_group(
        out, collectives.cut_group(tp, h, cfg.n_heads))


def _mlp(blk: dict, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    h = rmsnorm(x, blk["ln2"], cfg.norm_eps)
    return x + tfm.mlp_out(blk["mlp"], cfg, h, tp)


def _attend(cfg: ModelConfig, q, k, v, causal: bool) -> torch.Tensor:
    return flash_attention(q, k, v, causal=causal, block_q=cfg.flash_block_q,
                           block_k=cfg.flash_block_k)


def _enc_block(blk: dict, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = _proj_qkv(blk["attn"], h, h, cfg, tp)
    x = x + _out(blk["attn"], _attend(cfg, q, k, v, causal=False), x.dtype, cfg, tp)
    return _mlp(blk, cfg, x, tp)


def run_encoder(params: dict, cfg: ModelConfig, frames: torch.Tensor, tp=None
                ) -> torch.Tensor:
    """frames [B, T, d] (the stub frontend's output) -> encoder states
    [B, T, d]. The sinusoid is added in f32 and the sum rounded once to the
    model's dtype, as in the reference. With ``cfg.remat`` each layer runs
    under ``torch.utils.checkpoint``; ``tp`` (training) on the rank's
    shards."""
    t = frames.shape[1]
    x = (frames + sinusoid_positions(t, cfg.d_model, frames.device)[None]).to(cfg.dtype)
    for blk in _layers(params["enc_blocks"], cfg.n_enc_layers):
        if cfg.remat:
            x = checkpoint(_enc_block, blk, cfg, x, tp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _enc_block(blk, cfg, x, tp)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(blk: dict, cfg: ModelConfig, x: torch.Tensor, enc: torch.Tensor, tp=None):
    """One decoder block: (x, (k, v, cross k, cross v))."""
    h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = _proj_qkv(blk["attn"], h, h, cfg, tp)
    x = x + _out(blk["attn"], _attend(cfg, q, k, v, causal=True), x.dtype, cfg, tp)
    h = rmsnorm(x, blk["lnx"], cfg.norm_eps)
    qx, kx, vx = _proj_qkv(blk["xattn"], h, enc, cfg, tp)
    x = x + _out(blk["xattn"], _attend(cfg, qx, kx, vx, causal=False), x.dtype, cfg, tp)
    return _mlp(blk, cfg, x, tp), (k, v, kx, vx)


def run_decoder_train(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      enc: torch.Tensor, return_kv: bool = False, tp=None):
    """tokens [B, S]; enc [B, T, d] -> (hidden [B, S, d], kv or None), kv the
    stacks (k, v [L, B, S, KH, hd], cross k, v [L, B, T, KH, hd]). The
    embedding and the sinusoid are each rounded to the model's dtype, then
    added, as in the reference. With ``cfg.remat`` and no K/V asked for,
    each layer runs under ``torch.utils.checkpoint``; ``tp`` (training) on
    the rank's shards, the embedding's vocabulary too where it is cut."""
    s = tokens.shape[1]
    x = (tfm.embed_tokens(params, cfg, tokens, tp)
         + sinusoid_positions(s, cfg.d_model, tokens.device)[None].to(cfg.dtype))
    kvs = []
    for blk in _layers(params["dec_blocks"], cfg.n_layers):
        if cfg.remat and not return_kv:
            x = checkpoint(lambda blk, x, enc: _dec_block(blk, cfg, x, enc, tp)[0], blk, x,
                           enc, use_reentrant=False, preserve_rng_state=False)
            continue
        x, kv = _dec_block(blk, cfg, x, enc, tp)
        if return_kv:
            kvs.append(kv)
    if not return_kv:
        return x, None
    return x, tuple(torch.stack(t) for t in zip(*kvs))


def _step_sinusoid(cfg: ModelConfig, pos, device) -> torch.Tensor:
    """The decode position's sinusoid [B or 1, 1, d] (f32), with the log
    taken in f32 as the reference's ``jnp.log`` takes it; one a row for
    per-row positions."""
    half = cfg.d_model // 2
    log = torch.full((), 10000.0, device=device).log()
    freqs = torch.exp(-log * torch.arange(half, device=device) / (half - 1))
    if isinstance(pos, torch.Tensor):
        ang = pos.float()[:, None] * freqs                            # [B, half]
    else:
        ang = float(pos) * freqs[None]                                # [1, half]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, None]


def run_decoder_step(params: dict, cfg: ModelConfig, token: torch.Tensor, pos, cache: dict,
                     tp=None):
    """One decode step. token [B]; cache k/v [L, B, Sc, KH, hd] with
    slot_pos [Sc] (``pos`` an int) or [B, Sc] (``pos`` an int32 tensor [B]
    on the device, one position a row, as `transformer.run_stack_decode`
    takes it), and the cross ck/cv [L, B, T, KH, hd]. Writes the step's K/V
    at each row's slot ``pos % Sc`` in place; the cross-attention reads all
    T frames (slot positions 0..T-1 at position T) whatever form ``pos``
    takes. Returns (hidden [B, 1, d], cache with the new slot_pos). ``tp``
    runs the rank's shards over its pieces of both caches, each as the
    rules engine places it (`transformer.cache_attend`), an int ``pos``
    only."""
    slot_pos, where = tfm.decode_slots(cache, pos, tp)
    x = (tfm.embed_tokens(params, cfg, token[:, None], tp)
         + _step_sinusoid(cfg, pos, token.device).to(cfg.dtype))
    # on ranks the cross K/V hold the config's enc_seq frames (the prefill
    # checks), of which a cut over their sequence leaves the rank a block
    t = cache["ck"].shape[2] if tp is None or tp.group is None else cfg.enc_seq
    frame_pos = torch.arange(t, dtype=torch.int32, device=token.device)
    with torch.no_grad():
        for i, blk in enumerate(_layers(params["dec_blocks"], cfg.n_layers)):
            h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
            kc, vc = cache["k"][i], cache["v"][i]
            q, k, v = _proj_qkv(blk["attn"], h, h, cfg, tfm.heads_tp(cfg, kc, slot_pos, tp))
            o = tfm.cache_attend(cfg, q, k, v, kc, vc, slot_pos, pos, -1, where, tp)
            x = x + _out(blk["attn"], o, x.dtype, cfg, tp)
            h = rmsnorm(x, blk["lnx"], cfg.norm_eps)
            qx = _proj(h, blk["xattn"]["wq"])
            ox = tfm.cache_attend(cfg, qx, None, None, cache["ck"][i], cache["cv"][i],
                                  frame_pos, t, -1, None, tp)
            x = _mlp(blk, cfg, x + _out(blk["xattn"], ox, x.dtype, cfg, tp), tp)
    return x, dict(cache, slot_pos=slot_pos)


def encdec_cache_specs(cfg: ModelConfig, batch: int, seq: int) -> tuple[dict, dict]:
    """Each cache leaf's (shape, dtype), and its logical axes (the batch axis
    is the continuous engine's slot axis): the self-attention's k/v over
    ``seq`` slots and the cross k/v over the config's ``enc_seq`` frames."""
    l = cfg.n_layers
    kv = (l, batch, seq, cfg.n_kv_heads, cfg.hd)
    xkv = (l, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
    kv_axes = (None, "batch", "kv_seq", "kv_heads", "head_dim")
    shapes = {
        "k": (kv, cfg.dtype),
        "v": (kv, cfg.dtype),
        "ck": (xkv, cfg.dtype),
        "cv": (xkv, cfg.dtype),
        "slot_pos": ((seq,), torch.int32),
    }
    axes = {"k": kv_axes, "v": kv_axes, "ck": kv_axes, "cv": kv_axes, "slot_pos": (None,)}
    return shapes, axes


def encdec_init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda") -> dict:
    """An empty cache on ``device`` (the card unless the caller asks for
    another; raises without CUDA): zeros, and slot_pos -1 (every slot empty)."""
    device = resolve(device)
    shapes, _ = encdec_cache_specs(cfg, batch, seq)
    cache = {k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in shapes.items()}
    cache["slot_pos"].fill_(-1)
    return cache
