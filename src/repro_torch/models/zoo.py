"""Model facade (counterpart of `repro/models/zoo.py`).

`get_model(cfg)` returns a `Model` whose members are plain functions:

* loss_fn(params, batch) -> (loss, metrics {"ce", "aux"}): the training
  loss, differentiable through the attention kernels (aux is 0 for the
  dense decoder)
* prefill_fn(params, batch, pad_to=None) -> (last logits [B, V] f32, cache)
* decode_fn(params, cache, token [B], pos) -> (logits [B, V] f32, cache);
  pos an int, or an int32 tensor [B] on the device (one position a row,
  with a per-row ``slot_pos`` [B, Sc] in the cache)
* init_cache_fn(batch, seq, device="cuda") -> an empty cache (raises without
  CUDA unless the caller asks for the CPU)
* prefill_chunk_fn(params, cache, tokens [B, cs], start: int) -> (logits
  [B, V] f32, cache): one prefill chunk against a full-capacity cache

The port carries the text-only dense decoder (smollm, gemma3, tinyllama,
deepseek); the other families (MoE, VLM, SSM, hybrid, enc-dec) wait for
their slices (ROADMAP §1, LM stack).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import transformer as tfm
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
    # One prefill chunk against a full-capacity cache; dense decoders only
    # (None for the families that cannot chunk, as in the reference).
    prefill_chunk_fn: Callable | None = None


def _final_loss(params: dict, cfg: ModelConfig, h: torch.Tensor, targets: torch.Tensor,
                aux: torch.Tensor):
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    ce = chunked_cross_entropy(h, tfm.head_weight(params, cfg), targets, chunk=cfg.loss_chunk)
    return ce + aux, {"ce": ce, "aux": aux}


def _positions(tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
    b, s = tokens.shape
    return (start + torch.arange(s, dtype=torch.int32, device=tokens.device))[None].expand(b, s)


def _last_logits(params: dict, cfg: ModelConfig, h_last: torch.Tensor) -> torch.Tensor:
    """h_last [B, 1, d] -> logits [B, V] (f32)."""
    return tfm.logits_head(params, cfg, h_last)[:, 0]


def _decoder_model(cfg: ModelConfig) -> Model:
    specs = tfm.decoder_specs(cfg)

    def loss_fn(params, batch):
        x = tfm.embed_tokens(params, cfg, batch["tokens"])
        h, aux = tfm.run_stack_train(params, cfg, x, _positions(batch["tokens"]))
        return _final_loss(params, cfg, h, batch["targets"], aux)

    def prefill_fn(params, batch, pad_to=None):
        tokens = batch["tokens"]
        x = tfm.embed_tokens(params, cfg, tokens)
        h, kv = tfm.run_stack_prefill(params, cfg, x, _positions(tokens))
        cache = tfm.cache_from_kv(cfg, kv, tokens.shape[1], pad_to)
        return _last_logits(params, cfg, h[:, -1:]), cache

    def decode_fn(params, cache, token, pos):
        x = tfm.embed_tokens(params, cfg, token[:, None])
        h, cache = tfm.run_stack_decode(params, cfg, x, pos, cache)
        return _last_logits(params, cfg, h), cache

    def init_cache_fn(batch, seq, device="cuda"):
        return tfm.init_cache(cfg, batch, seq, device=device)

    def prefill_chunk_fn(params, cache, tokens, start):
        x = tfm.embed_tokens(params, cfg, tokens)
        h, cache = tfm.run_stack_chunk(params, cfg, x, _positions(tokens, start), cache, start)
        return _last_logits(params, cfg, h[:, -1:]), cache

    return Model(cfg, specs, loss_fn, prefill_fn, decode_fn, init_cache_fn, prefill_chunk_fn)


def get_model(cfg: ModelConfig) -> Model:
    if not isinstance(cfg, ModelConfig):
        raise NotImplementedError(
            f"{type(cfg).__name__}: the port carries the dense decoder only; the other "
            "model families wait for ROADMAP §1, LM stack")
    return _decoder_model(cfg)
