"""Zamba2 2.7B [arXiv:2411.15242] — hybrid: Mamba-2 backbone + shared attn block.

54 Mamba-2 layers (d_inner 5120, state 64, head_dim 64 -> 80 ssd heads) with one
*shared* transformer block (32H MHA kv=32, head_dim 80, d_ff 10240) applied every
6 layers (9 invocations, one weight set), d_model=2560 vocab=32000.
long_500k runs: SSD state is O(1); the shared-attn KV cache (9 entries) is
sequence-sharded.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, SSMSettings

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMSettings(kind="mamba2", d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
    shared_attn_every=6,
    subquadratic=True,
    rules_override={"kv_seq": "model"},
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        ssm=SSMSettings(kind="mamba2", d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16),
        shared_attn_every=2, loss_chunk=32, remat=False,
    )
