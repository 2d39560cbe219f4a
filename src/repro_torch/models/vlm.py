"""Qwen2-VL-style VLM backbone: the dense GQA decoder with M-RoPE and a
vision prefix (counterpart of `repro/models/vlm.py`).

The vision tower is a stub, as in the reference: the batch holds
precomputed patch embeddings ``patch_embeds`` [B, S_vis, d] (the
dynamic-resolution ViT's output after the merger) and the M-RoPE positions
``positions`` [B, S_vis + S_text, 3] (t, h, w), which depend on the image
grid. What is VLM-specific is (a) the vision prefix concatenated ahead of
the token embeddings and (b) the three position streams, which
`layers.apply_rope` takes by the config's ``mrope_sections``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def vlm_specs(cfg: ModelConfig) -> dict:
    return tfm.decoder_specs(cfg)


def assemble_sequence(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      patch_embeds: torch.Tensor | None, tp=None) -> torch.Tensor:
    """[B, S_vis, d] vision prefix + embedded tokens -> [B, S, d] (``tp``:
    the embedding's vocabulary cut over the model ranks)."""
    xt = tfm.embed_tokens(params, cfg, tokens, tp)
    if patch_embeds is None or patch_embeds.shape[1] == 0:
        return xt
    return torch.cat([patch_embeds.to(cfg.dtype), xt], dim=1)


def default_positions(batch: int, s_vis: int, s_text: int, grid_hw: tuple[int, int],
                      device="cuda") -> torch.Tensor:
    """M-RoPE (t, h, w) position ids [batch, s_vis + s_text, 3] int32: one
    image of ``grid_hw`` patches (t = 0, (h, w) from the grid), then text at
    t = h = w increasing from ``s_vis``, so a text token's rope position is
    its sequence index (the reference's choice, which keeps prefill and
    single-token decode in agreement). On the card unless the caller asks
    for another device."""
    device = resolve(device)
    gh, gw = grid_hw
    if gh * gw != s_vis:
        raise ValueError(f"grid {grid_hw} does not hold {s_vis} patches")
    hh = torch.arange(gh, device=device).repeat_interleave(gw)
    ww = torch.arange(gw, device=device).repeat(gh)
    vis = torch.stack([torch.zeros_like(hh), hh, ww], dim=-1)
    t = s_vis + torch.arange(s_text, device=device)
    pos = torch.cat([vis, torch.stack([t, t, t], dim=-1)]) if s_vis else torch.stack([t, t, t],
                                                                                      dim=-1)
    return pos[None].expand(batch, s_vis + s_text, 3).to(torch.int32)


def _prefix_len(patch_embeds: torch.Tensor | None) -> int:
    return 0 if patch_embeds is None else patch_embeds.shape[1]


def run_vlm_train(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  patch_embeds: torch.Tensor | None, positions: torch.Tensor, tp=None):
    """(hidden of the text positions [B, S_text, d], aux loss): the causal
    stack over prefix and text, remat and ranks (``tp``) as
    `transformer.run_stack_train` does them."""
    x = assemble_sequence(params, cfg, tokens, patch_embeds, tp)
    h, aux = tfm.run_stack_train(params, cfg, x, positions, tp)
    return h[:, _prefix_len(patch_embeds):], aux


def run_vlm_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    patch_embeds: torch.Tensor | None, positions: torch.Tensor, tp=None):
    """(hidden of the text positions [B, S_text, d], (k, v) stacks
    [L, B, S_vis + S_text, KH, hd]): the prefill, whose cache holds the
    prefix's K/V ahead of the text's; ``tp`` on the rank's shards, as
    `transformer.run_stack_prefill` runs them."""
    x = assemble_sequence(params, cfg, tokens, patch_embeds, tp)
    h, kv = tfm.run_stack_prefill(params, cfg, x, positions, tp)
    return h[:, _prefix_len(patch_embeds):], kv
