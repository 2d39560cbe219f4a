"""HDC classifier helpers of the serve path (counterpart of parts of
`repro/core/classifier.py`: `HDCTaskConfig`, `make_codebook`,
`serve_accuracy`). The Table I trial loop (`run_accuracy`, `table1`) is not
ported yet."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import hypervector as hv


@dataclasses.dataclass(frozen=True)
class HDCTaskConfig:
    n_classes: int = 100
    dim: int = 512
    n_trials: int = 2000


def make_codebook(generator: torch.Generator, cfg: HDCTaskConfig,
                  density: float | None = None,
                  device: str | torch.device | None = "cuda") -> torch.Tensor:
    """The shared item/prototype memory: [C, d] uint8 random hypervectors,
    each bit i.i.d. at ``density`` (default 1/2)."""
    if density is None:
        return hv.random_hv(generator, cfg.n_classes, cfg.dim, device)
    dev = _device.resolve(device)
    draw = torch.rand((cfg.n_classes, cfg.dim), generator=generator, device=dev)
    return (draw < density).to(torch.uint8)


def serve_accuracy(pred, classes) -> dict:
    """Accuracy of serve predictions against the sent classes: ``pred`` and
    ``classes`` share a shape ([B] baseline, [B, M] permuted). ``draw_acc``
    is the share of class draws answered, ``trial_acc`` the share of trials
    with every draw answered (Table I's criterion)."""
    p = np.asarray(pred.cpu() if isinstance(pred, torch.Tensor) else pred)
    c = np.asarray(classes.cpu() if isinstance(classes, torch.Tensor) else classes)
    if p.shape != c.shape:
        raise ValueError(f"pred {p.shape} and classes {c.shape} differ in shape")
    hit = p == c
    return {
        "draw_acc": float(hit.mean()),
        "trial_acc": float(hit.reshape(hit.shape[0], -1).all(axis=-1).mean()),
    }
