"""Shared helpers for the port's kernel wrappers and their plain versions.

Counterpart of `repro/kernels/common.py` (`pad_dim`, `cdiv`,
`hamming_blocks`), plus what the torch side needs on top: a SWAR popcount
(torch has no popcount op) and the device dispatch every wrapper follows —
CPU tensors run the plain ``ref.py`` twin, CUDA tensors launch the kernel,
fake tensors (`torch._subclasses.fake_tensor.FakeTensor`, of any device)
take the wrapper's fake branch, anything else raises.

The fake branch is the wrapper's fake implementation, the role
``register_fake`` plays for a ``torch.library`` op: the wrapper makes its
kernel's outputs, shaped and typed as the kernel's (and any scratch the
kernel's launch allocates), and records its family's ``cost()`` — (bytes
moved, operations, their kind) — with every active recorder
(`recording`; `analysis.op_cost` is one) in place of the launch. It is not
a fallback: it runs only on fake tensors, which hold no data, and a real
CUDA tensor still goes to the kernel or raises (`_build.launch` refuses a
fake tensor).
"""
from __future__ import annotations

import contextlib

import torch


def pad_dim(x: torch.Tensor, axis: int, multiple: int, fill=0) -> torch.Tensor:
    """Pad `axis` of `x` up to the next multiple of `multiple` with `fill`."""
    size = x.shape[axis]
    target = cdiv(size, multiple) * multiple
    if target == size:
        return x
    shape = list(x.shape)
    shape[axis] = target - size
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=axis)


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


# Class-chunk policy of the streamed plain versions, as in the reference:
# ``BC`` classes per chunk, 4x wider past ``TALL_C`` classes. (The CUDA
# kernels choose their own tiles; see the header of each source.)
BQ = 8
BC = 128
TALL_C = 4096


def hamming_blocks(
    b: int, c: int, bq: int | None = None, bc: int | None = None
) -> tuple[int, int]:
    """Resolve the (bq, bc) tile sizes for a Hamming search over ``b`` queries
    and ``c`` classes; explicit values win, ``None`` takes the policy default."""
    if bq is None:
        bq = BQ
    if bc is None:
        bc = 4 * BC if c >= TALL_C else BC
    return bq, bc


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words (the reference's uint32 bits).

    SWAR on the two 16-bit halves, so every intermediate stays in
    [0, 2^16) and no int32 arithmetic can overflow. Returns int32.
    """
    out = None
    for half in (x & 0xFFFF, (x >> 16) & 0xFFFF):   # >> is arithmetic: mask
        v = half - ((half >> 1) & 0x5555)
        v = (v & 0x3333) + ((v >> 2) & 0x3333)
        v = (v + (v >> 4)) & 0x0F0F
        v = (v + (v >> 8)) & 0x1F
        out = v if out is None else out + v
    return out


# H100 SXM streaming multiprocessors: the launch plans' SM count for fake
# tensors, which stand for the card and have no device to ask
FAKE_SMS = 132


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (no data; a shape, dtype and device)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def dispatch(name: str, *tensors: torch.Tensor) -> str:
    """"cpu" (run the plain version), "cuda" (launch the kernel) or "fake"
    (fake tensors of any device: make the outputs and record the cost) for
    the wrapper `name`; raises for mixed fake and real tensors and for mixed
    or other devices. Never a fallback: a CUDA tensor always goes to the
    kernel."""
    fake = [is_fake(t) for t in tensors]
    if any(fake):
        if not all(fake):
            raise ValueError(f"{name}: fake and real tensors mixed")
        return "fake"
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"{name}: tensors must all lie on the CPU or all on "
                         f"one CUDA device, got {sorted(kinds)}")
    if "cuda" in kinds and len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors lie on several CUDA devices")
    return kinds.pop()


def check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Type and rank checks every wrapper makes, on either device."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")


def check_contiguous(name: str, *tensors: torch.Tensor) -> None:
    """The kernels index dense row-major memory: raise on any other layout."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


# ---------------------------------------------------------------------------
# the fake branch's cost records
# ---------------------------------------------------------------------------

_recorders: list = []


@contextlib.contextmanager
def recording(recorder):
    """Within the block, every fake launch calls ``recorder.kernel(name,
    nbytes, ops, kind)`` when it starts and ``recorder.kernel_done()`` when
    its outputs are made (the aten ops in between make the kernel's outputs
    and are the kernel's, not work of their own)."""
    _recorders.append(recorder)
    try:
        yield recorder
    finally:
        _recorders.remove(recorder)


@contextlib.contextmanager
def fake_launch(name: str, cost: tuple):
    """The fake branch of wrapper ``name``: records ``cost`` = (bytes moved,
    operations, their kind) with every active recorder; the block makes the
    kernel's outputs."""
    for r in _recorders:
        r.kernel(name, *cost)
    try:
        yield
    finally:
        for r in _recorders:
            r.kernel_done()


def record_launch(name: str, cost: tuple) -> None:
    """A fake launch whose outputs are already made: records ``cost``."""
    with fake_launch(name, cost):
        pass
