"""Model facade (counterpart of `repro/models/zoo.py`).

`get_model(cfg)` returns a `Model` whose members are plain functions:

* loss_fn(params, batch, tp=None) -> (loss, metrics {"ce", "aux"}): the
  training loss ce + aux, differentiable through the attention kernels (aux
  the MoE blocks' load-balancing loss summed over the layers, 0 for the
  dense decoder); with ``tp`` (a `collectives.TensorParallel`)
  on the rank's tensor-parallel shards, the loss being this data rank's
  share of the global batch's mean
* prefill_fn(params, batch, pad_to=None, tp=None) -> (last logits [B, V]
  f32, cache)
* decode_fn(params, cache, token [B], pos, tp=None) -> (logits [B, V] f32,
  cache); pos an int, or an int32 tensor [B] on the device (one position a
  row, with a per-row ``slot_pos`` [B, Sc] in the cache)

  Both run without autograd. With ``tp`` (inference across ranks, the
  counterpart of the reference's GSPMD prefill and decode;
  `train.loop.build_infer_fns` builds it) they take this rank's rows and
  shards, the cache is this rank's piece as the rules engine cuts it from
  ``cache_axes`` (the K/V over their sequence where a config puts
  ``kv_seq`` on ``model``, `transformer.kv_cut`), and the logits stay cut
  over the vocabulary, as the reference leaves them: [B, V / model]. On
  ranks ``pos`` is an int: the engines stay off ranks
* init_cache_fn(batch, seq, device="cuda") -> an empty cache (raises without
  CUDA unless the caller asks for the CPU)
* cache_axes: each cache leaf's logical axes, the reference's
  ``cache_specs_fn`` axes; the "batch" axis is the continuous engine's slot
  axis
* prefill_chunk_fn(params, cache, tokens [B, cs], start: int) -> (logits
  [B, V] f32, cache): one prefill chunk against a full-capacity cache; None
  for the MoE decoders, as in the reference (routing over the token axis
  makes chunk boundaries change the experts' drops), and for the SSM and
  hybrid decoders

* inputs: the batch entries a prefill reads ("tokens"; "frames" for the
  enc-dec, "patch_embeds" and "positions" for the VLM); the engines refuse
  any other by name

The port carries every family of the reference: the text-only dense
decoder (smollm, gemma3, tinyllama, deepseek), the MoE decoder (mixtral,
kimi), the SSM decoder (falcon-mamba: Mamba-1 blocks, a cache of conv and
SSM states), the hybrid (zamba2: Mamba-2 blocks and one shared attention
block, both caches), the VLM (qwen2-vl: the dense decoder with a vision
prefix and M-RoPE positions from the batch) and the encoder-decoder
(whisper: a frame encoder, a decoder with cross-attention, a cache of
self K/V and the encoder's cross K/V). The SSM and hybrid decode steps
write the new states into the cache's tensors in place, as every family's
decode writes its K/V. Every family trains and infers across ranks
(``tp=``): the rank's shards of each family's layers, as the reference's
GSPMD step places them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.distributed import collectives
from repro_torch.models import encdec, hybrid, vlm
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.base import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.train.loss import chunked_cross_entropy


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    specs: Any
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    init_cache_fn: Callable
    cache_axes: dict
    # One prefill chunk against a full-capacity cache; dense decoders only
    # (None for the other families, as in the reference).
    prefill_chunk_fn: Callable | None = None
    inputs: tuple[str, ...] = ("tokens",)


def _final_loss(params: dict, cfg: ModelConfig, h: torch.Tensor, targets: torch.Tensor,
                aux: torch.Tensor, tp=None):
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    w = tfm.head_weight(params, cfg)
    if tp is None:
        ce = chunked_cross_entropy(h, w, targets, chunk=cfg.loss_chunk)
        return ce + aux, {"ce": ce, "aux": aux}
    group = collectives.cut_group(tp, w.shape[1], cfg.vocab)
    ce = chunked_cross_entropy(collectives.copy_to_group(h, group), w, targets,
                               chunk=cfg.loss_chunk, group=group,
                               vocab_start=tp.rank * w.shape[1] if group else 0,
                               count_groups=tp.data_groups)
    return ce + aux, {"ce": ce, "aux": aux}


def _positions(tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
    b, s = tokens.shape
    return (start + torch.arange(s, dtype=torch.int32, device=tokens.device))[None].expand(b, s)


def _last_logits(params: dict, cfg: ModelConfig, h_last: torch.Tensor) -> torch.Tensor:
    """h_last [B, 1, d] -> logits [B, V] (f32)."""
    return tfm.logits_head(params, cfg, h_last)[:, 0]


def _decoder_model(cfg: ModelConfig) -> Model:
    """The dense and MoE decoders, and the VLM: the same stack, which on the
    VLM takes a vision prefix (``patch_embeds``, optional) ahead of the
    tokens and its M-RoPE positions from the batch."""
    is_vlm = cfg.kind == "vlm"
    specs = vlm.vlm_specs(cfg) if is_vlm else tfm.decoder_specs(cfg)

    def vlm_positions(batch):
        if "positions" not in batch:
            raise ValueError(f"{cfg.name}: the VLM's M-RoPE positions come from the batch "
                             "('positions' [B, S_vis + S_text, 3]; see vlm.default_positions)")
        return batch["positions"]

    def loss_fn(params, batch, tp=None):
        if is_vlm:
            h, aux = vlm.run_vlm_train(params, cfg, batch["tokens"], batch.get("patch_embeds"),
                                       vlm_positions(batch), tp)
            return _final_loss(params, cfg, h, batch["targets"], aux, tp)
        x = tfm.embed_tokens(params, cfg, batch["tokens"], tp)
        h, aux = tfm.run_stack_train(params, cfg, x, _positions(batch["tokens"]), tp)
        return _final_loss(params, cfg, h, batch["targets"], aux, tp)

    @torch.no_grad()
    def prefill_fn(params, batch, pad_to=None, tp=None):
        tokens = batch["tokens"]
        if is_vlm:
            positions = vlm_positions(batch)
            h, kv = vlm.run_vlm_prefill(params, cfg, tokens, batch.get("patch_embeds"),
                                        positions, tp)
            seq = positions.shape[1]
        else:
            x = tfm.embed_tokens(params, cfg, tokens, tp)
            h, kv = tfm.run_stack_prefill(params, cfg, x, _positions(tokens), tp)
            seq = tokens.shape[1]
        cache = tfm.cache_from_kv(cfg, kv, seq, pad_to, tp)
        return _last_logits(params, cfg, h[:, -1:]), cache

    @torch.no_grad()
    def decode_fn(params, cache, token, pos, tp=None):
        x = tfm.embed_tokens(params, cfg, token[:, None], tp)
        h, cache = tfm.run_stack_decode(params, cfg, x, pos, cache, tp)
        return _last_logits(params, cfg, h), cache

    def init_cache_fn(batch, seq, device="cuda"):
        return tfm.init_cache(cfg, batch, seq, device=device)

    def prefill_chunk_fn(params, cache, tokens, start):
        x = tfm.embed_tokens(params, cfg, tokens)
        h, cache = tfm.run_stack_chunk(params, cfg, x, _positions(tokens, start), cache, start)
        return _last_logits(params, cfg, h[:, -1:]), cache

    kv_axes = tfm.KV_AXES
    return Model(cfg, specs, loss_fn, prefill_fn, decode_fn, init_cache_fn,
                 {"k": kv_axes, "v": kv_axes, "slot_pos": (None,)},
                 None if cfg.moe or is_vlm else prefill_chunk_fn,
                 ("tokens", "patch_embeds", "positions") if is_vlm else ("tokens",))


# ---------------------------------------------------------------------------
# SSM (falcon-mamba)
# ---------------------------------------------------------------------------

def _ssm_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"), "normal", 0.02,
                           cfg.dtype),
        "blocks": mamba_lib.mamba1_specs(cfg),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), "zeros", dtype=cfg.dtype),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"), "fan_in",
                             dtype=cfg.dtype),
    }


def _ssm_model(cfg: ModelConfig) -> Model:
    specs = _ssm_specs(cfg)
    s = cfg.ssm
    din = s.expand * cfg.d_model

    def run_train(params, x, return_state=False, tp=None):
        """(hidden, (conv [L, B, K-1, din], ssm [L, B, din, N]) or None); with
        ``cfg.remat`` and no states asked for, each layer runs under
        ``torch.utils.checkpoint``, as the reference checkpoints its body;
        ``tp`` (training) on the rank's d_inner channels."""
        convs, ssms = [], []
        for blk in tfm._layers(params["blocks"], cfg.n_layers):
            if cfg.remat and not return_state:
                x = checkpoint(lambda blk, x: mamba_lib.mamba1_block(blk, cfg, x, tp=tp)[0],
                               blk, x, use_reentrant=False, preserve_rng_state=False)
                continue
            x, (cst, sst) = mamba_lib.mamba1_block(blk, cfg, x, tp=tp)
            if return_state:
                convs.append(cst)
                ssms.append(sst)
        return x, ((torch.stack(convs), torch.stack(ssms)) if return_state else None)

    def loss_fn(params, batch, tp=None):
        x = tfm.embed_tokens(params, cfg, batch["tokens"], tp)
        h, _ = run_train(params, x, tp=tp)
        return _final_loss(params, cfg, h, batch["targets"],
                           torch.zeros((), dtype=torch.float32, device=h.device), tp)

    @torch.no_grad()
    def prefill_fn(params, batch, pad_to=None, tp=None):
        del pad_to  # SSM state is O(1); no cache capacity
        x = tfm.embed_tokens(params, cfg, batch["tokens"], tp)
        # on ranks the states are the rank's d_inner channels: the cache's cut
        h, (conv, ssm) = run_train(params, x, return_state=True, tp=tp)
        return _last_logits(params, cfg, h[:, -1:]), {"conv": conv, "ssm": ssm}

    @torch.no_grad()
    def decode_fn(params, cache, token, pos, tp=None):
        if tp is not None and isinstance(pos, torch.Tensor):
            raise ValueError("a decode on ranks takes one int position for the batch")
        x = tfm.embed_tokens(params, cfg, token[:, None], tp)
        for i in range(cfg.n_layers):
            x, cst, sst = mamba_lib.mamba1_decode(tfm._layer(params["blocks"], i), cfg, x,
                                                  cache["conv"][i], cache["ssm"][i], tp)
            cache["conv"][i].copy_(cst)
            cache["ssm"][i].copy_(sst)
        return _last_logits(params, cfg, x), dict(cache)

    def init_cache_fn(batch, seq, device="cuda"):
        device = resolve(device)
        l = cfg.n_layers
        return {
            "conv": torch.zeros((l, batch, s.d_conv - 1, din), dtype=cfg.dtype, device=device),
            "ssm": torch.zeros((l, batch, din, s.d_state), dtype=torch.float32, device=device),
        }

    axes = {"conv": (None, "batch", None, "inner"), "ssm": (None, "batch", "inner", "state")}
    return Model(cfg, specs, loss_fn, prefill_fn, decode_fn, init_cache_fn, axes)


# ---------------------------------------------------------------------------
# hybrid (zamba2)
# ---------------------------------------------------------------------------

def _hybrid_model(cfg: ModelConfig) -> Model:
    specs = hybrid.hybrid_specs(cfg)

    def loss_fn(params, batch, tp=None):
        tokens = batch["tokens"]
        x = tfm.embed_tokens(params, cfg, tokens, tp)
        h, _, _ = hybrid.run_hybrid_train(params, cfg, x, _positions(tokens), tp=tp)
        return _final_loss(params, cfg, h, batch["targets"],
                           torch.zeros((), dtype=torch.float32, device=h.device), tp)

    @torch.no_grad()
    def prefill_fn(params, batch, pad_to=None, tp=None):
        tokens = batch["tokens"]
        x = tfm.embed_tokens(params, cfg, tokens, tp)
        h, _, ((k, v), (conv, ssm)) = hybrid.run_hybrid_train(
            params, cfg, x, _positions(tokens), return_kv=True, tp=tp)
        slot_pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        cache = tfm.recut_kv(cfg, tfm.pad_kv_cache({"k": k, "v": v, "slot_pos": slot_pos},
                                                   pad_to), tp)
        conv, ssm = mamba_lib.mamba2_cache_states(cfg, conv, ssm, tp, hybrid.conv_cut(cfg, tp))
        cache.update(conv=conv, ssm=ssm)
        return _last_logits(params, cfg, h[:, -1:]), cache

    @torch.no_grad()
    def decode_fn(params, cache, token, pos, tp=None):
        x = tfm.embed_tokens(params, cfg, token[:, None], tp)
        h, cache = hybrid.run_hybrid_decode(params, cfg, x, pos, cache, tp)
        return _last_logits(params, cfg, h), cache

    def init_cache_fn(batch, seq, device="cuda"):
        return hybrid.hybrid_init_cache(cfg, batch, seq, device=device)

    _, axes = hybrid.hybrid_cache_specs(cfg, 1, 1)
    return Model(cfg, specs, loss_fn, prefill_fn, decode_fn, init_cache_fn, axes)


# ---------------------------------------------------------------------------
# enc-dec (whisper)
# ---------------------------------------------------------------------------

def _encdec_model(cfg: ModelConfig) -> Model:
    specs = encdec.encdec_specs(cfg)

    def loss_fn(params, batch, tp=None):
        enc = encdec.run_encoder(params, cfg, batch["frames"], tp)
        h, _ = encdec.run_decoder_train(params, cfg, batch["tokens"], enc, tp=tp)
        return _final_loss(params, cfg, h, batch["targets"],
                           torch.zeros((), dtype=torch.float32, device=h.device), tp)

    @torch.no_grad()
    def prefill_fn(params, batch, pad_to=None, tp=None):
        tokens, frames = batch["tokens"], batch["frames"]
        if tp is not None and tp.group is not None and frames.shape[1] != cfg.enc_seq:
            raise ValueError(f"{cfg.name}: on ranks the frames are the config's "
                             f"{cfg.enc_seq} a row, as the cross K/V's placement counts "
                             f"them (got {frames.shape[1]})")
        enc = encdec.run_encoder(params, cfg, frames, tp)
        h, (k, v, ck, cv) = encdec.run_decoder_train(params, cfg, tokens, enc, return_kv=True,
                                                     tp=tp)
        slot_pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        cache = tfm.recut_kv(cfg, tfm.pad_kv_cache({"k": k, "v": v, "slot_pos": slot_pos},
                                                   pad_to), tp)
        # the cross K/V over the frames: not padded, placed as the rules engine cuts them
        cache.update(tfm.recut_kv(cfg, {"ck": ck, "cv": cv}, tp, names=("ck", "cv")))
        return _last_logits(params, cfg, h[:, -1:]), cache

    @torch.no_grad()
    def decode_fn(params, cache, token, pos, tp=None):
        h, cache = encdec.run_decoder_step(params, cfg, token, pos, cache, tp)
        return _last_logits(params, cfg, h), cache

    def init_cache_fn(batch, seq, device="cuda"):
        return encdec.encdec_init_cache(cfg, batch, seq, device=device)

    _, axes = encdec.encdec_cache_specs(cfg, 1, 1)
    return Model(cfg, specs, loss_fn, prefill_fn, decode_fn, init_cache_fn, axes,
                 inputs=("tokens", "frames"))


def get_model(cfg: ModelConfig) -> Model:
    if not isinstance(cfg, ModelConfig):
        raise TypeError(f"get_model takes a ModelConfig, got {type(cfg).__name__}")
    if cfg.kind == "encdec":
        return _encdec_model(cfg)
    if cfg.shared_attn_every:
        return _hybrid_model(cfg)
    if cfg.ssm is not None:
        return _ssm_model(cfg)
    return _decoder_model(cfg)
