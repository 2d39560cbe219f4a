"""The multi-centroid bank of HDC-as-a-service (counterpart of two helpers
of `repro/serving/hdc.py`).

The serve is class-count-agnostic: a multi-centroid memory is a codebook of
C*k_c class-major rows, served by a `ScaleOutConfig` with
``n_classes = C * k_c``, and a serve prediction ``p`` maps back to class
``p // k_c``. The tenant registry, the slot-ring engine and the scheduler of
the reference module are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import classifier, hypervector as hv
from repro_torch.core.scaleout import ScaleOutConfig


def multicentroid_bank(generator: torch.Generator | None, protos: torch.Tensor, k_c: int,
                       cfg: ScaleOutConfig, **train_kwargs) -> torch.Tensor:
    """Expand a [C, d] uint8 or [C, W] int32 codebook into a class-major
    [C*k_c, d|W] centroid bank (`classifier.train_multicentroid`), in the
    representation ``cfg`` serves: packed int32 words, or unpacked bits.
    Among equidistant centroids a serve picks the lowest flat row, which is
    the lowest (class, centroid) pair, so the tie rule carries over."""
    cents = classifier.train_multicentroid(generator, protos, k_c, **train_kwargs)
    c, _, w = cents.shape
    bank = cents.reshape(c * k_c, w)
    return bank if cfg.packed else hv.unpack(bank, cfg.dim)


def centroid_to_class(pred: torch.Tensor, k_c: int) -> torch.Tensor:
    """Class-major centroid predictions (of a `multicentroid_bank` serve) ->
    class labels, elementwise on any shape."""
    return pred // k_c
