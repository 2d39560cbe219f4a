"""Continuous-batching request scheduler: a submit/poll queue and age-fair
admission over a slot-ring engine (counterpart of the backend-agnostic half
of `repro/serving/scheduler.py`).

``SlotScheduler`` owns the slot free-list, the FIFO buckets, the completion
table and the step loop: fill free slots, one multi-slot engine step,
collect finished slots. Backends specialize the admission and collection
hooks; the HDC scheduler (`repro_torch.serving.hdc.HDCScheduler`) admits
query batches into tenant slots and finishes every running slot each step.
The LM ``Scheduler``, its ``Request``/``Completion`` and its multi-step
(chunked-prefill) admissions wait for the continuous LM engine (ROADMAP §1,
serving).

Admission is age-fair: each free slot takes the globally oldest pending
request, re-picked per slot, so a stream into one bucket cannot starve a
request that arrived in another in between.

Eviction is step-granular: a finished slot is freed at once and refilled on
the next admission pass while the other slots keep going.

Slot-leak guard: ``max_slot_steps`` bounds the steps one admission may
consume. An expired slot is force-evicted (freed, ``engine.on_evict``), and
its request is requeued at the head of its bucket up to ``max_requeues``
times, then failed with an ``"evicted"`` completion, so the queue always
drains.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable

import torch


class SlotScheduler:
    """Backend-agnostic queue and slot bookkeeping over a `SlotRingEngine`.

    Subclasses implement:

    * ``_admit(batch)``: serve each (request, slot) pair of ``batch``, the
      requests the age-fair pass matched to free slots, registering each in
      ``running`` (HDC: one scatter into the engine's state);
    * ``_collect(emitted) -> list``: consume one engine step's per-slot
      emissions, finishing and freeing slots as the backend dictates;
    * ``_step_params()``: what ``engine.step`` takes as params (default: the
      ``params`` given at construction);
    * ``_fail_eviction(slot, record)``: the completion of a request failed
      by the slot-leak guard.

    Requests carry ``rid`` and ``t_submit``.
    """

    def __init__(self, engine, params, clock: Callable[[], float] = time.monotonic,
                 *, max_slot_steps: int | None = None, max_requeues: int = 1):
        if max_slot_steps is not None and max_slot_steps < 1:
            raise ValueError("max_slot_steps must be >= 1")
        self.engine = engine
        self.params = params
        self.clock = clock
        self.state = engine.init_state()
        self.free: list[int] = list(range(engine.num_slots))
        # slot -> backend-defined running record (HDC: (request, t_admit))
        self.running: dict[int, Any] = {}
        self.buckets: dict[Any, collections.deque] = collections.defaultdict(
            collections.deque)
        self.results: dict[int, Any] = {}
        self.steps = 0
        self._next_rid = 0
        self.max_slot_steps = max_slot_steps
        self.max_requeues = max_requeues
        self._slot_steps: dict[int, int] = {}   # slot -> steps consumed in flight
        self._requeues: dict[int, int] = {}     # rid -> deadline evictions so far

    # -- queue ---------------------------------------------------------------

    def poll(self, rid: int):
        return self.results.get(rid)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.buckets.values())

    @property
    def active(self) -> int:
        return len(self.running)

    # -- admission / eviction ------------------------------------------------

    def _pop_oldest(self):
        """Pop the globally oldest pending request across all buckets."""
        live = [(q[0].t_submit, q[0].rid, s) for s, q in self.buckets.items() if q]
        if not live:
            return None
        return self.buckets[min(live)[2]].popleft()

    def _admit_free_slots(self) -> None:
        """Match every free slot with the globally oldest pending request,
        re-picked per slot (age-fair), and admit the matches in one backend
        call."""
        batch = []
        while self.free:
            req = self._pop_oldest()
            if req is None:
                break
            batch.append((req, self.free.pop(0)))
        if batch:
            self._admit(batch)

    # -- backend hooks --------------------------------------------------------

    def _admit(self, batch: list) -> None:
        raise NotImplementedError

    def _collect(self, emitted) -> list:
        raise NotImplementedError

    def _step_params(self):
        return self.params

    def _bucket_key(self, req) -> Any:
        """The bucket a submitted or requeued request lands in (one bucket
        unless a backend buckets by shape)."""
        return 0

    def _fail_eviction(self, slot: int, record):
        """The failure completion of a deadline-evicted slot record."""
        raise NotImplementedError

    # -- slot-leak guard ------------------------------------------------------

    def _evict_slot(self, slot: int) -> list:
        """Force-evict a deadline-expired slot: free it, notify the engine,
        requeue the request at the HEAD of its bucket (it is the oldest, so
        the age-fair pop must see it first) or fail it after
        ``max_requeues``."""
        record = self.running.pop(slot)
        req = record[0]
        self.free.append(slot)
        self._slot_steps.pop(slot, None)
        self.engine.on_evict(slot)
        n = self._requeues.get(req.rid, 0)
        if n < self.max_requeues:
            self._requeues[req.rid] = n + 1
            self.buckets[self._bucket_key(req)].appendleft(req)
            return []
        done = self._fail_eviction(slot, record)
        self.results[req.rid] = done
        return [done]

    def _enforce_deadlines(self, stepped: list[int]) -> list:
        """Charge one step to every slot that ran and evict the expired ones."""
        finished = []
        for slot in stepped:
            if slot not in self.running:      # finished normally this step
                self._slot_steps.pop(slot, None)
                continue
            n = self._slot_steps.get(slot, 0) + 1
            self._slot_steps[slot] = n
            if n >= self.max_slot_steps:
                finished.extend(self._evict_slot(slot))
        return finished

    # -- drive ---------------------------------------------------------------

    def step(self) -> list:
        """Fill free slots, run one multi-slot engine step, collect finished
        slots. Returns the requests completed during this call."""
        self._admit_free_slots()
        if not self.running:
            return []
        stepped = list(self.running)
        self.state, emitted = self.engine.step(self._step_params(), self.state)
        self.steps += 1
        finished = self._collect(emitted)
        if self.max_slot_steps is not None:
            finished.extend(self._enforce_deadlines(stepped))
        return finished

    def run(self, timeout: float | None = None) -> dict:
        """Step until the queue and all slots drain. Returns {rid: completion}."""
        t0 = self.clock()
        while self.pending or self.running:
            self.step()
            if timeout is not None and self.clock() - t0 > timeout:
                raise TimeoutError(
                    f"scheduler did not drain within {timeout}s "
                    f"(pending={self.pending}, active={self.active})")
        return self.results
