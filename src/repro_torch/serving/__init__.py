"""Serving (counterpart of `repro.serving`): the static-batch LM engine and
the multi-centroid bank of `hdc.py`; the slot ring, the scheduler and the
continuous engines wait for ROADMAP module item 12."""
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: F401
