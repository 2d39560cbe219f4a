"""Serving helpers (counterpart of `repro.serving`); only the
multi-centroid bank of `hdc.py` is ported so far."""
