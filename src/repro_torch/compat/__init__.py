"""Capability probe of the PyTorch runtime (counterpart of `repro/compat`).

The reference's compat package shims JAX versions. The port has no such
surface to shim: the rest of the reference's compat has its counterparts
elsewhere (``mesh``/``sharding`` in `distributed.mesh` and
`distributed.sharding`, ``tree`` in `repro_torch.tree`, ``pallas`` in the
hand-written kernels, ``xla``'s cost analysis in `analysis.op_cost`). What
is left is a probe of what this runtime offers the port: `detect_features`
and `describe`.
"""
from repro_torch.compat.version import FEATURE_DOC, describe, detect_features

__all__ = ["FEATURE_DOC", "describe", "detect_features"]
