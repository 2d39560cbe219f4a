"""Qwen2-VL 7B [arXiv:2409.12191] — VLM backbone with M-RoPE.

28L d_model=3584 28H (GQA kv=4, head_dim 128) d_ff=18944 vocab=152064.
M-RoPE sections (t, h, w) = (16, 24, 24) over the 64 half-dim slots; dynamic-
resolution vision tower is a stub (the batch supplies patch embeddings).
Sharding: 28 heads don't divide 16 -> FSDP + MLP TP.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    kind="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    rules_override={"embed": "data", "kv_seq": "model"},
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
        vocab=512, mrope_sections=(4, 6, 6), loss_chunk=64, remat=False,
    )
