"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asks
    for another. Raises when CUDA is asked for (the default) and absent — the
    port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def check_on(dev: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``dev`` (type and index)."""
    for name, t in tensors.items():
        if t.device.type != dev.type or (
            dev.index is not None and t.device.index != dev.index
        ):
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
