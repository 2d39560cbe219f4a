"""Public ops: the bipolar associative matmul, plain and banked.

A wrapper given CPU tensors runs the plain version in `ref.py`; given CUDA
tensors it launches the kernel of ``csrc/assoc_matmul.cu`` (and counts the
launch) or raises; given fake tensors it makes the kernel's output and
records `cost` (`kernels.common.fake_launch`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, check, check_contiguous, dispatch, record_launch
from repro_torch.kernels.assoc_matmul.ref import assoc_matmul_ref

MAX_K = 1 << 24          # int32 dots stay exact in f32 below this
MAX_GRID_YZ = 65535
BM = 64                  # queries per block (csrc/assoc_matmul.cu)


def cost(g: int, b: int, c: int, k: int) -> tuple[int, int, str]:
    """(bytes, operations, kind) of g banks of b queries against c classes
    of k bytes: every byte read once, the f32 dots written; a multiply-add
    an int8 tensor-core product's 2 operations."""
    return g * (b + c) * k + 4 * g * b * c, 2 * g * b * c * k, "int8"


def assoc_matmul_banked(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Bipolar dots of bank g's queries [G, B, K] against bank g's prototypes
    [G, C, K] (uint8 {0,1}) -> [G, B, C] f32 — the per-IMC-core search that
    the JAX serve writes as a vmap of `assoc_matmul`, in one launch. Other
    byte values v count as 2v - 1, as in the reference, exactly while
    4 * 255^2 * K fits int32 (K <= 8256)."""
    check("assoc_matmul q", q, torch.uint8, 3)
    check("assoc_matmul protos", protos, torch.uint8, 3)
    g, b, k = q.shape
    if protos.shape[0] != g or protos.shape[2] != k:
        raise ValueError(f"bank shapes differ: {tuple(q.shape)} vs {tuple(protos.shape)}")
    c = protos.shape[1]
    mode = dispatch("assoc_matmul", q, protos)
    if mode == "cpu":
        return assoc_matmul_ref(q, protos)
    check_contiguous("assoc_matmul", q, protos)
    if k >= MAX_K or g > MAX_GRID_YZ or cdiv(b, BM) > MAX_GRID_YZ:
        raise ValueError(f"assoc_matmul: K={k}, G={g} or B={b} beyond the kernel's limits")
    out = torch.empty((g, b, c), dtype=torch.float32, device=q.device)
    if g and b and c and mode == "fake":
        record_launch("assoc_matmul", cost(g, b, c, k))
    elif g and b and c:
        _build.launch("assoc_matmul_launch", q, protos, out, g, b, c, k)
        assoc_matmul_banked.launches += 1
    return out


assoc_matmul_banked.launches = 0


def assoc_matmul(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Bipolar dots between {0,1} queries [.., d] and prototypes [C, d] ->
    [.., C] f32 (one bank of `assoc_matmul_banked`)."""
    lead, d = q.shape[:-1], q.shape[-1]
    out = assoc_matmul_banked(q.reshape(1, -1, d).contiguous(),
                              protos.reshape(1, *protos.shape))
    return out.reshape(lead + (protos.shape[0],))
