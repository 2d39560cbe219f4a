"""What this PyTorch runtime offers the port (counterpart of
`repro/compat/version.py`).

Detection probes the live runtime at call time, not version strings, so a
test can monkeypatch a capability in or out and see both answers on one
install: ``torch.cuda`` for the card and its compute capability, ``PATH``
for ``nvcc`` (the kernels' build), ``importlib`` for ``triton``, the fake
process-group backend that the dry run's production meshes stand on
(`launch.mesh.fake_world`), and whether FakeTensorMode can make a tensor on
the card (the dry run's tensors stand for the card's there).
"""
from __future__ import annotations

import importlib.util

import torch

# feature -> what it gates
FEATURE_DOC = {
    "torch": "the PyTorch version",
    "cuda": "a CUDA device is visible (every entry point's default device)",
    "device": "the card's name (torch.cuda.get_device_name(0))",
    "sm": "the card's compute capability (the kernels are built for sm_90a)",
    "nvcc": "nvcc on PATH or under CUDA_HOME (kernels/_build.py compiles csrc/)",
    "triton": "the triton package imports",
    "fake_pg": "the fake process-group backend (launch.mesh.fake_world, the dry run)",
    "fake_cuda": "FakeTensorMode makes tensors on the card (the dry run's default device)",
}


def _cuda() -> bool:
    return torch.cuda.is_available()


def _nvcc() -> bool:
    from repro_torch.kernels import _build

    try:
        _build._nvcc()
    except RuntimeError:
        return False
    return True


def _importable(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def _fake_pg() -> bool:
    return _importable("torch.testing._internal.distributed.fake_pg")


def _fake_cuda() -> bool:
    """Whether a fake tensor on the card can be made and multiplied: only
    with a CUDA build of torch and a visible card (a CPU build aborts the
    process on a fake CUDA tensor's autograd, so it is not tried there)."""
    if not _cuda():
        return False
    from torch._subclasses.fake_tensor import FakeTensorMode

    try:
        with FakeTensorMode():
            x = torch.empty((2, 2), device="cuda")
            return (x @ x).device.type == "cuda"
    except Exception:        # a probe: any refusal means "no"
        return False


def detect_features() -> dict:
    """A snapshot of every capability in `FEATURE_DOC` against the live
    runtime: booleans, and the version, device name and capability as
    strings (None without a card)."""
    cuda = _cuda()
    sm = None
    if cuda:
        major, minor = torch.cuda.get_device_capability(0)
        sm = f"sm_{major}{minor}"
    return {
        "torch": torch.__version__,
        "cuda": cuda,
        "device": torch.cuda.get_device_name(0) if cuda else None,
        "sm": sm,
        "nvcc": _nvcc(),
        "triton": _importable("triton"),
        "fake_pg": _fake_pg(),
        "fake_cuda": _fake_cuda(),
    }


def describe() -> str:
    """One line of `detect_features`: ``torch <v>`` and each feature as
    ``+name``/``-name`` (or ``name=value``)."""
    feats = detect_features()
    parts = [f"torch {feats.pop('torch')}"]
    for k, v in feats.items():
        if isinstance(v, bool):
            parts.append(("+" if v else "-") + k)
        else:
            parts.append(f"{k}={v}")
    return "compat: " + " ".join(parts)
