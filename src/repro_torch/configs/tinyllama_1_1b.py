"""TinyLlama 1.1B [arXiv:2401.02385] — llama2-arch small dense GQA.

22L d_model=2048 32H (GQA kv=4, head_dim 64) d_ff=5632 vocab=32000.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    rope_theta=10_000.0,
    rules_override={"kv_seq": "model"},
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
        vocab=512, loss_chunk=64, remat=False,
    )
