"""repro_torch.compat: the capability probe, every branch forced by
monkeypatching the live runtime, as tests/test_compat.py forces the
reference's shims (the probe reads the runtime at call time)."""
import pytest
import torch

from repro_torch import compat
from repro_torch.compat import version
from repro_torch.kernels import _build


def test_feature_keys_and_types():
    feats = compat.detect_features()
    assert set(feats) == set(compat.FEATURE_DOC)
    assert feats["torch"] == torch.__version__
    for k in ("cuda", "nvcc", "triton", "fake_pg", "fake_cuda"):
        assert isinstance(feats[k], bool), k
    line = compat.describe()
    assert "\n" not in line and line.startswith("compat: torch ")
    # the fake process group the dry run stands on is in this torch
    assert feats["fake_pg"]


def test_no_card_branch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats = compat.detect_features()
    assert feats["cuda"] is False and feats["device"] is None and feats["sm"] is None
    assert feats["fake_cuda"] is False
    assert "-cuda" in compat.describe() and "device=None" in compat.describe()


def test_card_branch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (9, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(version, "_fake_cuda", lambda: True)
    feats = compat.detect_features()
    assert feats["cuda"] and feats["sm"] == "sm_90" and feats["fake_cuda"]
    assert feats["device"] == "NVIDIA H100 80GB HBM3"
    line = compat.describe()
    assert "+cuda" in line and "sm=sm_90" in line and "+fake_cuda" in line


@pytest.mark.parametrize("present", [True, False])
def test_nvcc_branch(monkeypatch, present):
    def nvcc():
        if not present:
            raise RuntimeError("nvcc not found")
        return "/usr/local/cuda/bin/nvcc"

    monkeypatch.setattr(_build, "_nvcc", nvcc)
    assert compat.detect_features()["nvcc"] is present


@pytest.mark.parametrize("present", [True, False])
def test_importable_branches(monkeypatch, present):
    real = version.importlib.util.find_spec

    def find_spec(name, *a, **kw):
        if name in ("triton", "torch.testing._internal.distributed.fake_pg"):
            return object() if present else None
        return real(name, *a, **kw)

    monkeypatch.setattr(version.importlib.util, "find_spec", find_spec)
    feats = compat.detect_features()
    assert feats["triton"] is present and feats["fake_pg"] is present


def test_fake_cuda_probe_refuses_without_a_card(monkeypatch):
    """The probe never makes a fake CUDA tensor where torch has no CUDA (a
    CPU build aborts the process on one's autograd)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert version._fake_cuda() is False
