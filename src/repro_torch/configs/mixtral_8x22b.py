"""Mixtral 8x22B [arXiv:2401.04088] — MoE 8 experts top-2, sliding-window attn.

56L d_model=6144 48H (GQA kv=8, head_dim 128) expert d_ff=16384 vocab=32768,
window 4096 on every layer (per assignment). Sharding: 8 experts don't divide the
16-way model axis -> TP *inside* experts (d_expert 16384/16), experts replicated;
heads TP (48/16). Pure SWA -> ring KV cache -> long_500k runs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    rope_theta=1_000_000.0,
    window_pattern=(4096,) * 56,
    moe=MoESettings(n_experts=8, top_k=2, d_expert=16384, group_size=1024, capacity_factor=1.25),
    subquadratic=True,
    rules_override={"experts": None, "expert_mlp": "model", "kv_seq": "model"},
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        window_pattern=(64,) * 2,
        moe=MoESettings(n_experts=4, top_k=2, d_expert=256, group_size=64, capacity_factor=1.5),
        loss_chunk=64, remat=False,
    )
