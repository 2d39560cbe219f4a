"""Whisper-tiny [arXiv:2212.04356] — encoder-decoder with stubbed conv frontend.

4 encoder + 4 decoder layers, d_model=384 6H (kv=6, head_dim 64) d_ff=1536
vocab=51865; 1500 encoder frames (stub mel/conv frontend -> precomputed frame
embeddings). Decode cells are structural: the real model caps targets at 448;
sinusoidal decoder positions make any cache length well-defined.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    kind="encdec",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    enc_seq=1500,
    tie_embeddings=True,  # whisper reuses the token embedding as the output head
    rules_override={"embed": "data", "kv_seq": "model"},
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=128, vocab=512, enc_seq=64, loss_chunk=32, remat=False,
    )
