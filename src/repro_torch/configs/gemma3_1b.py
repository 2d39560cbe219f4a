"""Gemma-3 1B [hf:google/gemma-3-1b-pt] — dense GQA, 5:1 local:global attention.

26L d_model=1152 4H (GQA kv=1, head_dim 256) d_ff=6912 vocab=262144.
Pattern: 5 sliding-window (512) layers per global layer; dual RoPE theta
(10k local / 1M global); qk-norm; sandwich (pre+post) norms; tied embeddings;
sqrt(d) embedding scale; gelu MLP.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

_PATTERN = tuple((512 if (i + 1) % 6 != 0 else -1) for i in range(26))

CONFIG = ModelConfig(
    name="gemma3-1b",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    rope_theta=1_000_000.0,
    local_rope_theta=10_000.0,
    window_pattern=_PATTERN,
    qk_norm=True,
    sandwich_norm=True,
    tie_embeddings=True,
    emb_scale=True,
    act="gelu",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=96, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab=512, window_pattern=tuple((64 if (i + 1) % 6 != 0 else -1) for i in range(6)),
        loss_chunk=64, remat=False,
    )
