"""Carry hypervectors, channel state and model parameters between numpy
and the port.

numpy is the meeting point with the JAX package (convert a JAX array with
``np.asarray`` first); this module imports nothing of JAX. Packed words are
uint32 in numpy and int32 with the same bits in the port; sparse index lists
are int32 on both sides (``SENTINEL`` = 2^31 - 1 kept as is). bf16 arrays
(numpy dtype ``bfloat16`` from ml_dtypes, which ``torch.from_numpy``
refuses) cross as their 16-bit patterns, bit for bit. Like the port's entry
points, the functions that make tensors put them on CUDA unless the caller
asks for another device, and raise when CUDA is absent.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.faults.model import FaultState
from repro_torch.phy.channel import ChannelState
from repro_torch.phy.process import ProcessState


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


def pstate_from_numpy(leaves: dict, device: str | torch.device | None = "cuda"
                      ) -> ProcessState:
    """A dict of the ProcessState leaves as numpy arrays, ``chan`` itself a
    dict of the eight ChannelState leaves -> the port's ProcessState on
    `device` (``t`` a 0-dim int32 tensor)."""
    dev = _device.resolve(device)
    missing = set(ProcessState.FIELDS) - set(leaves)
    if missing:
        raise KeyError(f"missing ProcessState leaves: {sorted(missing)}")
    return ProcessState(chan=state_from_numpy(leaves["chan"], dev), **{
        f: torch.from_numpy(np.array(leaves[f], copy=True)).to(dev)
        for f in ProcessState.FIELDS if f != "chan"})


def fstate_from_numpy(leaves: dict, device: str | torch.device | None = "cuda"
                      ) -> FaultState:
    """A dict of the eight FaultState leaves as numpy arrays -> the port's
    FaultState on `device`: uint32 stuck masks become int32 words with the
    same bits, bool and int32 leaves keep their values (``t`` a 0-dim int32
    tensor)."""
    dev = _device.resolve(device)
    missing = set(FaultState.FIELDS) - set(leaves)
    if missing:
        raise KeyError(f"missing FaultState leaves: {sorted(missing)}")

    def leaf(a):
        a = np.array(a, order="C")                     # a copy; 0-dim stays 0-dim
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)

    return FaultState(*(leaf(leaves[f]) for f in FaultState.FIELDS))


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree, device: str | torch.device | None = "cuda"):
    """A nested dict of numpy arrays (a JAX parameter pytree through
    ``np.asarray``) -> the same nested dict of tensors on `device`, key paths,
    shapes, layouts and dtypes kept (bf16 bit for bit)."""
    dev = _device.resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor_from_numpy(np.asarray(tree)).to(dev)


def opt_state_from_numpy(state: dict, device: str | torch.device | None = "cuda") -> dict:
    """A JAX optimizer state through ``np.asarray`` -- AdamW's {"m", "v",
    "step"} or signum's {"mom", "step"} -> the port's: the moment trees as
    `params_from_numpy` carries parameters, ``step`` a 0-dim int32 tensor."""
    dev = _device.resolve(device)
    if set(state) not in ({"m", "v", "step"}, {"mom", "step"}):
        raise KeyError(f"expected AdamW's m, v, step or signum's mom, step; got {sorted(state)}")
    out = {k: params_from_numpy(v, dev) for k, v in state.items() if k != "step"}
    out["step"] = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=dev)
    return out


def to_numpy(x, words: bool = False):
    """Tensor -> numpy (``words=True`` views int32 words as uint32; index
    lists stay int32 with the default ``words=False``; bf16 -> ml_dtypes'
    bfloat16, bit for bit); a ChannelState -> the dict of its eight leaves; a
    nested dict of tensors (model parameters, a KV cache) -> the same dict of
    arrays; a ProcessState -> the dict of its leaves, ``chan`` a dict as
    above; a FaultState -> the dict of its leaves, stuck masks as uint32."""
    if isinstance(x, (ChannelState, ProcessState)):
        return {f: to_numpy(getattr(x, f)) for f in type(x).FIELDS}
    if isinstance(x, FaultState):
        return {f: to_numpy(getattr(x, f), words=f in ("stuck0", "stuck1"))
                for f in FaultState.FIELDS}
    if isinstance(x, dict):
        return {k: to_numpy(v, words) for k, v in x.items()}
    if x.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16 type; needed only to convert bf16 back

        return x.detach().cpu().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    a = x.detach().cpu().numpy()
    if words:
        if a.dtype != np.int32:
            raise TypeError(f"packed words are int32, got {a.dtype}")
        a = a.view(np.uint32)
    return a
