"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] — llama-arch small dense GQA.

32L d_model=960 15H (GQA kv=5, head_dim 64) d_ff=2560 vocab=49152, tied embeddings.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
    rules_override={"embed": "data", "kv_seq": "model"},
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_ff=256,
        vocab=512, loss_chunk=64, remat=False,
    )
