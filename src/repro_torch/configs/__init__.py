"""Architecture registry (counterpart of `repro.configs`).

`get_config(name)` returns the full published config and `get_smoke(name)` a
reduced same-family config, forced to f32, for CPU tests. The port carries
every architecture of the reference: the four dense decoders, the two MoE
decoders, the SSM decoder (falcon-mamba), the hybrid (zamba2), the
encoder-decoder (whisper-tiny) and the VLM (qwen2-vl).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

ARCHS = (
    "smollm_360m",
    "gemma3_1b",
    "tinyllama_1_1b",
    "deepseek_coder_33b",
    "qwen2_vl_7b",
    "whisper_tiny",
    "falcon_mamba_7b",
    "zamba2_2_7b",
    "mixtral_8x22b",
    "kimi_k2",
)
DENSE = ("smollm_360m", "gemma3_1b", "tinyllama_1_1b", "deepseek_coder_33b")
MOE = ("mixtral_8x22b", "kimi_k2")
SSM = ("falcon_mamba_7b", "zamba2_2_7b")
ENCDEC = ("whisper_tiny",)
VLM = ("qwen2_vl_7b",)

ALIASES = {a.replace("_", "-"): a for a in ARCHS} | {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "zamba2-2.7b": "zamba2_2_7b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "kimi-k2": "kimi_k2",
}


def _mod(name: str):
    name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _mod(name).CONFIG


def get_smoke(name: str):
    """Reduced same-family config, forced to f32 as the reference's is."""
    return dataclasses.replace(_mod(name).smoke_config(), dtype=torch.float32)
