"""Plain PyTorch version of the bipolar associative-matmul kernel."""
from __future__ import annotations

import torch


def assoc_matmul_ref(q: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Bipolar dots per bank: q [G, B, K] uint8, protos [G, C, K] ->
    [G, B, C] f32, dot = (2q-1).(2p-1) (= K - 2*hamming for {0,1} bytes).

    The product runs in float64, exact for any byte (|dot| <= 509^2 K <
    2^53), and is rounded to float32 once, as the kernel rounds its exact
    int32 dot; for {0,1} bytes every dot is an integer below 2^24, so the
    rounding is exact too."""
    qb = 2.0 * q.to(torch.float64) - 1.0
    pb = 2.0 * protos.to(torch.float64) - 1.0
    return torch.bmm(qb, pb.transpose(1, 2)).to(torch.float32)
