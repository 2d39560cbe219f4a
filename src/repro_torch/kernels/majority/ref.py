"""Plain PyTorch version of the majority-bundling kernel."""
from __future__ import annotations

import torch


def majority_bundle_ref(hvs: torch.Tensor) -> torch.Tensor:
    """Bitwise majority over axis 0: [M, N] uint8 {0,1} -> [N] uint8, with
    even-M ties resolving to 0 (``count*2 > M``)."""
    m = hvs.shape[0]
    counts = hvs.to(torch.int32).sum(0)
    return (counts * 2 > m).to(torch.uint8)
