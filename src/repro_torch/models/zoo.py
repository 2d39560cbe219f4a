"""Model facade (counterpart of `repro/models/zoo.py`).

`get_model(cfg)` returns a `Model` whose members are plain functions:

* loss_fn(params, batch, tp=None) -> (loss, metrics {"ce", "aux"}): the
  training loss ce + aux, differentiable through the attention kernels (aux
  the MoE blocks' load-balancing loss summed over the layers, 0 for the
  dense decoder); with ``tp`` (a `collectives.TensorParallel`)
  on the rank's tensor-parallel shards, the loss being this data rank's
  share of the global batch's mean
* prefill_fn(params, batch, pad_to=None) -> (last logits [B, V] f32, cache)
* decode_fn(params, cache, token [B], pos) -> (logits [B, V] f32, cache);
  pos an int, or an int32 tensor [B] on the device (one position a row,
  with a per-row ``slot_pos`` [B, Sc] in the cache)
* init_cache_fn(batch, seq, device="cuda") -> an empty cache (raises without
  CUDA unless the caller asks for the CPU)
* prefill_chunk_fn(params, cache, tokens [B, cs], start: int) -> (logits
  [B, V] f32, cache): one prefill chunk against a full-capacity cache; None
  for the MoE decoders, as in the reference (routing over the token axis
  makes chunk boundaries change the experts' drops)

The port carries the text-only dense decoder (smollm, gemma3, tinyllama,
deepseek) and the MoE decoder (mixtral, kimi); the other families (VLM,
SSM, hybrid, enc-dec) wait for their slices (ROADMAP §1, LM stack).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed import collectives
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
    # (None for the MoE decoders, as in the reference).
    prefill_chunk_fn: Callable | None = None


def _final_loss(params: dict, cfg: ModelConfig, h: torch.Tensor, targets: torch.Tensor,
                aux: torch.Tensor, tp=None):
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    w = tfm.head_weight(params, cfg)
    if tp is None:
        ce = chunked_cross_entropy(h, w, targets, chunk=cfg.loss_chunk)
        return ce + aux, {"ce": ce, "aux": aux}
    group = tfm._split(tp, w.shape[1], cfg.vocab)
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
    specs = tfm.decoder_specs(cfg)

    def loss_fn(params, batch, tp=None):
        x = tfm.embed_tokens(params, cfg, batch["tokens"], tp)
        h, aux = tfm.run_stack_train(params, cfg, x, _positions(batch["tokens"]), tp)
        return _final_loss(params, cfg, h, batch["targets"], aux, tp)

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

    return Model(cfg, specs, loss_fn, prefill_fn, decode_fn, init_cache_fn,
                 None if cfg.moe else prefill_chunk_fn)


def get_model(cfg: ModelConfig) -> Model:
    if not isinstance(cfg, ModelConfig):
        raise NotImplementedError(
            f"{type(cfg).__name__}: the port carries the dense and MoE decoders only; "
            "the other model families wait for ROADMAP §1, LM stack")
    return _decoder_model(cfg)
