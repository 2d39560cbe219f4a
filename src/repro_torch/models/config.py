"""Model configuration of the dense decoder (counterpart of
`repro/models/config.py`).

Only the fields the dense decoder reads are carried: the MoE, SSM, enc-dec and
VLM sections come back with the slices that read them; the sharding rules
and scanned layers have nothing to do on one GPU.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    rope_theta: float = 10_000.0
    local_rope_theta: float | None = None   # gemma3 dual-theta (local layers)
    window_pattern: tuple[int, ...] | None = None  # per-layer window, -1 = global
    qk_norm: bool = False
    sandwich_norm: bool = False  # gemma3 pre+post block norms
    tie_embeddings: bool = False
    emb_scale: bool = False      # gemma-style sqrt(d) embedding scaling
    act: str = "silu"            # silu | gelu
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True           # recompute each layer's forward in the backward
    flash_block_q: int = 512     # block sizes of the attention's plain twin
    flash_block_k: int = 1024
    loss_chunk: int = 512        # chunked cross-entropy sequence chunk

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def windows(self) -> tuple[int, ...]:
        if self.window_pattern is None:
            return (-1,) * self.n_layers
        if len(self.window_pattern) != self.n_layers:
            raise ValueError(f"{self.name}: window_pattern has {len(self.window_pattern)} "
                             f"entries for {self.n_layers} layers")
        return self.window_pattern

    @property
    def max_window(self) -> int:
        """Largest finite window; -1 if any layer is global."""
        ws = self.windows
        return -1 if any(w < 0 for w in ws) else max(ws)
