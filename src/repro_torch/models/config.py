"""Model configuration of every model family: the dense, MoE, SSM and
hybrid decoders, the encoder-decoder and the VLM (counterpart of
`repro/models/config.py`).

Only the fields the port reads are carried: ``vision_seq`` (read by no
function of the reference) and ``scan_layers`` (the scanned layers have
nothing to do in a Python loop) are not. ``kind`` picks the enc-dec and
VLM facades; ``n_enc_layers`` and ``enc_seq`` size Whisper's encoder and
its cross K/V, ``mrope_sections`` splits the rotary frequencies over
Qwen2-VL's (t, h, w) positions. ``rules_override`` is each config's
change to `distributed.sharding.DEFAULT_RULES`, the reference's letter for
letter; ``subquadratic`` is the reference's long-context marker, carried
as the reference sets it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0            # always-on shared experts (Kimi-style)
    group_size: int = 1024       # tokens per dispatch group (GShard-style)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMSettings:
    kind: str                    # "mamba1" | "mamba2"
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64           # mamba2 only
    n_groups: int = 1            # mamba2 only
    dt_rank: int | None = None   # mamba1; default d_model // 16
    chunk: int = 128             # selective-scan chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    kind: str = "decoder"        # decoder | encdec | vlm
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
    moe: MoESettings | None = None
    ssm: SSMSettings | None = None
    shared_attn_every: int = 0   # zamba2: one shared attn block every k ssm layers
    n_enc_layers: int = 0        # whisper encoder depth
    enc_seq: int = 1500          # whisper frame count (stub frontend output)
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE (t, h, w)
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True           # recompute each layer's forward in the backward
    flash_block_q: int = 512     # block sizes of the attention's plain twin
    flash_block_k: int = 1024
    loss_chunk: int = 512        # chunked cross-entropy sequence chunk
    rules_override: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    # long-context marker (the reference's dry run skips its 500k cell without it)
    subquadratic: bool = False

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
