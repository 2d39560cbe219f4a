"""Falcon-Mamba 7B [arXiv:2410.05355] — attention-free Mamba-1 SSM.

64L d_model=4096 (d_inner 8192, ssm_state=16, conv 4, dt_rank 256) vocab=65024.
Sharding: d_inner TP over "model" (the recurrence is elementwise across
channels); long_500k runs natively (O(1) state per token). The published
model's RMS norms of B, C and dt are not in the reference, so not here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, SSMSettings

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm=SSMSettings(kind="mamba1", d_state=16, d_conv=4, expand=2, dt_rank=256, chunk=128),
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=512,
        ssm=SSMSettings(kind="mamba1", d_state=8, d_conv=4, expand=2, dt_rank=8, chunk=16),
        loss_chunk=32, remat=False,
    )
