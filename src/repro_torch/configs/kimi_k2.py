"""Kimi K2 1T-A32B [arXiv:2501 (Kimi K2 paper table)] — trillion-param MoE.

61L d_model=7168 64H (GQA kv=8, head_dim 112) vocab=163840; MoE: 384 routed
experts top-8 + 1 shared expert, expert d_ff=2048. Per the assignment all 61
layers are MoE (the released model makes layer 0 dense) and attention is GQA
(the released model uses MLA) — both noted in DESIGN.md §Arch-applicability.

Sharding: EP 384/16 = 24 experts per model shard; expert weights additionally
FSDP-sharded on the embed dim over "data" (1T params -> ~4 GB/chip on the
multi-pod mesh); ZeRO-1 optimizer state.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    rope_theta=50_000.0,
    moe=MoESettings(
        n_experts=384, top_k=8, d_expert=2048, n_shared=1,
        group_size=2048, capacity_factor=1.25,
    ),
    rules_override={"embed": "data", "kv_seq": "model"},
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=64, vocab=512,
        moe=MoESettings(n_experts=8, top_k=2, d_expert=64, n_shared=1,
                        group_size=64, capacity_factor=1.5),
        loss_chunk=64, remat=False,
    )
