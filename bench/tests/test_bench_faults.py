"""A whole run on the CPU, past the harness's look for a card, with the timed
path broken underneath: ``correct`` comes out false for each fault a cell of
one chip can have (the exchange between chips has no place on one chip)."""
from __future__ import annotations

from unittest import mock

import pytest

import bench_tiny
from bench_tiny import WORKLOADS


def _stale_step():
    """A step that returns its state unchanged: every step answers as the
    first did."""
    from repro_torch.serving.hdc import HDCEngine

    first = {}
    inner = HDCEngine._serve_slots

    def stale(self, params, state):
        if self not in first:
            first[self] = inner(self, params, state)
        return first[self]

    return mock.patch.object(HDCEngine, "_serve_slots", stale)


def _half_batch():
    """Half of every slot's trials left out, their answers copied from the
    served half."""
    import torch

    from repro_torch.core import scaleout

    inner = scaleout._serve_slots

    def half(cfg, chan, sh, store, queries, *args, **kwargs):
        b = queries.shape[1]
        pred, sim = inner(cfg, chan, sh, store, queries[:, : b // 2], *args, **kwargs)
        return torch.cat([pred, pred], 1), torch.cat([sim, sim], 1)

    return mock.patch.object(scaleout, "_serve_slots", half)


def _altered_answer():
    """One answer altered where it is produced: the global top-1 gives the
    next class for the first trial of every slot."""
    from repro_torch.core import scaleout

    inner = scaleout._gather_top1

    def altered(cfg, sh, val, idx):
        pred, sim = inner(cfg, sh, val, idx)
        pred = pred.clone()
        pred[:, 0] = (pred[:, 0] + 1) % cfg.n_classes
        return pred, sim

    return mock.patch.object(scaleout, "_gather_top1", altered)


FAULTS = {"stale_step": _stale_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_serve_is_not_correct(workload, fault):
    with FAULTS[fault]():
        result, _ = bench_tiny.run(workload)
    assert result["correct"] is False
    assert (result["checks"]["pred_mismatch"]["value"]
            + result["checks"]["maxsim_mismatch"]["value"]) > 0
