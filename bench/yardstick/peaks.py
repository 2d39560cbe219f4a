"""Peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W), frozen here from the
port's `analysis/roofline.py`: the datasheet's dense rates, and for 1-bit
tensor-core products (NVIDIA publishes none) the highest rate a probe of
the 1-bit wgmma product measured on an H100 80GB HBM3 at 700 W, counted as
2 operations a bit product."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAKS = {"int8": 1979e12, "b1": 15684e12, "bf16": 989e12, "f32": 67e12}


def least_seconds(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time the card could
    take to move ``nbytes`` and do ``ops`` operations of ``kind``."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = ops / PEAKS[kind]
    return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")
