"""Plain PyTorch version of the bipolar associative-matmul kernel."""
from __future__ import annotations

import torch


def assoc_matmul_ref(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Bipolar dots per bank: q [G, B, K] uint8 {0,1}, protos [G, C, K] ->
    [G, B, C] f32, dot = (2q-1).(2p-1) = K - 2*hamming.

    The float32 product of +-1 values is exact (|dot| <= K < 2^24); on the
    card the plain version runs with TF32 off, as PyTorch's default, so the
    comparison with the kernel is bit for bit either way."""
    qb = 2.0 * q.to(torch.float32) - 1.0
    pb = 2.0 * protos.to(torch.float32) - 1.0
    return torch.bmm(qb, pb.transpose(1, 2))
