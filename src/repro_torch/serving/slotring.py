"""The slot ring of continuous-batching serving (counterpart of
`repro/serving/slotring.py`).

A slot ring is a fixed number of resident request *slots*, advanced
together by one multi-slot step. A backend implements:

* ``init_state()``: a dict whose entries carry a ``num_slots`` axis,
  tensors stacked slot-major (the LM cache's k/v slot-second, after the
  layers), or lists with one entry a slot (per-slot `torch.Generator`s);
* ``_step_impl(params, state) -> (state, emitted)``: one step of EVERY slot
  (empty slots compute harmlessly, and their results are never read);
* ``_admit_impl(state, slots, *payload)``: overwrite the rows of K slots
  (`slot_update`, one scatter per state entry), between steps, with no
  change of shape.

The reference compiles the step and the admission once each; PyTorch runs
eagerly, so `step` and `admit` call the methods directly. The state's
tensors are written in place and keep their addresses, so a later capture of
the step in a CUDA graph can replay it over the same buffers. The queue and
admission policy on top is `repro_torch.serving.scheduler.SlotScheduler`.
"""
from __future__ import annotations

import torch


def slot_update(state: dict, new: dict, slots: list[int], axes: dict | None = None) -> dict:
    """Write the values of ``new`` into rows ``slots`` of the slot-stacked
    ``state``, in place, and return ``state``. A tensor entry's value is
    stacked along a K = len(slots) axis, the leading one unless ``axes``
    names another for that entry (the LM cache's k/v carry their slot axis
    second, after the layers), and lands in one ``index_copy_`` (cast to the
    live dtype; anything `torch.as_tensor` takes), a copy, never an alias,
    so a caller may reuse its buffer for the next request; a list entry's
    value is K objects, one a slot."""
    idx = torch.as_tensor(slots, dtype=torch.int64)
    axes = axes or {}
    for name, x in new.items():
        live = state[name]
        if isinstance(live, torch.Tensor):
            x = torch.as_tensor(x).to(device=live.device, dtype=live.dtype)
            live.index_copy_(axes.get(name, 0), idx.to(live.device), x)
        else:
            for slot, obj in zip(slots, x):
                live[slot] = obj
    return state


class SlotRingEngine:
    """Slot-ring base: owns the slot count, the step and admission entry
    points, the cache of step variants and the scheduler's hooks.

    Subclasses define the state (``init_state``), the per-step compute
    (``_step_impl``) and the admission payload (``_admit_impl``).
    """

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self._variants: dict = {}

    # -- backend contract ----------------------------------------------------

    def init_state(self) -> dict:
        """Slot-stacked state (a num_slots axis on every entry)."""
        raise NotImplementedError

    def _step_impl(self, params, state):
        """(params, state) -> (state, emitted): one step for every slot."""
        raise NotImplementedError

    def _admit_impl(self, state, slots, *payload):
        """Swap K requests' payloads into ``slots`` (K values an entry)."""
        raise NotImplementedError

    # -- drive ---------------------------------------------------------------

    def step(self, params, state):
        """One step for every slot. Returns (state, per-slot emissions)."""
        return self._step_impl(params, state)

    def admit(self, state, slots, *payload):
        """Admit K requests' payloads into ``slots`` (see `_admit_impl`)."""
        return self._admit_impl(state, slots, *payload)

    def step_variant(self, key, build):
        """Build-once-per-VARIANT step functions.

        A backend whose step runs in a few modes (the HDC link controller
        switching bundling width or collective) builds each mode's function
        through here: ``build()`` runs only on the first request for ``key``,
        and switching between variants afterwards is a dict lookup. The slot
        state has one shape across variants, so a switch needs no admission
        and no rebuild of the state."""
        fn = self._variants.get(key)
        if fn is None:
            fn = self._variants[key] = build()
        return fn

    def on_barrier(self):
        """Hook run by the scheduler at each step barrier (the host sync of
        ``_collect``): the one safe place for host-side control decisions
        that retarget the NEXT step (the HDC `LinkController` re-fits and
        quarantines here). Default: nothing."""

    def on_evict(self, slot: int):
        """Hook run by the scheduler when it forcibly evicts ``slot`` (a
        deadline-expired request). The slot's stale rows stay in place: they
        compute harmlessly until the next admission overwrites them, so the
        default does nothing; backends with per-slot host bookkeeping clean
        it up here."""
