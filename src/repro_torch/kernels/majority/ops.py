"""Public op: majority bundling.

A wrapper given CPU tensors runs the plain version in `ref.py`; given CUDA
tensors it launches the kernel of ``csrc/majority.cu`` (and counts the
launch) or raises; given fake tensors it makes the kernel's output and
records `cost` (`kernels.common.fake_launch`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_contiguous, dispatch, record_launch
from repro_torch.kernels.majority.ref import majority_bundle_ref

# csrc/majority.cu counts in uint32: 255 * M stays below 2^32
MAX_ROWS = 2**24


def cost(m: int, n: int) -> tuple[int, int, str]:
    """(bytes, operations, kind) of the majority of m rows of n bytes: each
    byte read once, the n bytes written; m int32 adds a lane (no tensor-core
    peak: bound by its bytes)."""
    return m * n + n, m * n, "int32"


def majority_bundle(hvs: torch.Tensor) -> torch.Tensor:
    """Majority over axis 0 of [M, ..., d] uint8 {0,1} -> [..., d] uint8."""
    if hvs.dtype != torch.uint8 or hvs.dim() < 2:
        raise TypeError(f"majority_bundle: expected uint8 [M, ..., d], got "
                        f"{hvs.dtype} {tuple(hvs.shape)}")
    m, rest = hvs.shape[0], hvs.shape[1:]
    flat = hvs.reshape(m, -1)
    mode = dispatch("majority_bundle", flat)
    if mode == "cpu":
        return majority_bundle_ref(flat).reshape(rest)
    check_contiguous("majority_bundle", flat)
    n = flat.shape[1]
    if n >= 2**31:
        raise ValueError(f"majority_bundle: {n} lanes beyond the kernel's int index")
    if m > MAX_ROWS:
        raise ValueError(f"majority_bundle: M={m} beyond the kernel's 32-bit counts "
                         f"(MAX_ROWS={MAX_ROWS})")
    out = torch.empty((n,), dtype=torch.uint8, device=hvs.device)
    if n and m and mode == "fake":
        record_launch("majority_bundle", cost(m, n))
    elif n and m:
        _build.launch("majority_bundle_launch", flat, out, m, n)
        majority_bundle.launches += 1
    elif n:
        out.zero_()                      # majority of nothing: 0 > 0 is false
    return out.reshape(rest)


majority_bundle.launches = 0
