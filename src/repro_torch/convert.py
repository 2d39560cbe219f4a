"""Carry hypervectors and channel state between numpy and the port.

numpy is the meeting point with the JAX package (convert a JAX array with
``np.asarray`` first); this module imports nothing of JAX. Packed words are
uint32 in numpy and int32 with the same bits in the port; sparse index lists
are int32 on both sides (``SENTINEL`` = 2^31 - 1 kept as is). Like the port's
entry points, the functions that make tensors put them on CUDA unless the
caller asks for another device, and raise when CUDA is absent.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.phy.channel import ChannelState


def hv_from_numpy(a: np.ndarray, device: str | torch.device | None = "cuda") -> torch.Tensor:
    """uint8 bits -> uint8 tensor; uint32 words -> int32 tensor (same bits);
    int32 sparse index lists -> int32 tensor (same values)."""
    dev = _device.resolve(device)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype not in (np.uint8, np.int32):
        raise TypeError(f"expected uint8 bits, uint32 words or int32 index lists, "
                        f"got {a.dtype}")
    return torch.from_numpy(a.copy()).to(dev)


def state_from_numpy(leaves: dict, device: str | torch.device | None = "cuda"
                     ) -> ChannelState:
    """A dict of the eight ChannelState leaves as numpy arrays (complex64
    kept) -> the port's ChannelState on `device`."""
    dev = _device.resolve(device)
    missing = set(ChannelState.FIELDS) - set(leaves)
    if missing:
        raise KeyError(f"missing ChannelState leaves: {sorted(missing)}")
    return ChannelState(*(
        torch.from_numpy(np.array(leaves[f], copy=True)).to(dev)
        for f in ChannelState.FIELDS
    ))


def to_numpy(x, words: bool = False):
    """Tensor -> numpy (``words=True`` views int32 words as uint32; index
    lists stay int32 with the default ``words=False``); a
    ChannelState -> the dict of its eight leaves."""
    if isinstance(x, ChannelState):
        return {f: to_numpy(getattr(x, f)) for f in ChannelState.FIELDS}
    a = x.detach().cpu().numpy()
    if words:
        if a.dtype != np.int32:
            raise TypeError(f"packed words are int32, got {a.dtype}")
        a = a.view(np.uint32)
    return a
