"""DeepSeek-Coder 33B [arXiv:2401.14196] — llama-arch dense GQA.

62L d_model=7168 56H (GQA kv=8, head_dim 128) d_ff=19200 vocab=32256.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    rope_theta=100_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=7, n_kv_heads=1, d_ff=384,
        vocab=512, loss_chunk=64, remat=False,
    )
