"""Continuous-batching request scheduler: a submit/poll queue and age-fair
admission over a slot-ring engine (counterpart of
`repro/serving/scheduler.py`).

``SlotScheduler`` is the backend-agnostic half: the slot free-list, the
per-prompt-shape FIFO buckets, the completion table and the step loop
(advance in-flight admissions, fill free slots, one multi-slot engine step,
collect finished slots). Backends specialize the admission and collection
hooks: the LM ``Scheduler`` admits by a whole or chunked prefill and
finishes a slot on EOS or ``max_new``; the HDC scheduler
(`repro_torch.serving.hdc.HDCScheduler`) admits query batches into tenant
slots in one call and finishes every running slot each step.

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

Over ranks (an engine with a ``mesh`` of more than one rank, the HDC
engines) every rank runs the same scheduler, and its one per-rank input,
the clock, becomes rank 0's reading broadcast at every read
(`collectives.SharedClock`): every rank then admits, requeues, evicts and
stamps alike, and so calls the same collectives in the same order (the
SPMD counterpart of the reference's single controller).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Callable

import torch

from repro_torch import spans
from repro_torch.distributed import collectives
from repro_torch.serving.engine import ContinuousEngine, _prompt_sig

# step ids, from 1, unique over every scheduler of the process, so that the
# spans of one step (and the completions it served) share an id no other has
_STEP_IDS = itertools.count(1)


@dataclasses.dataclass
class Request:
    rid: int
    batch: dict                  # B = 1 model inputs: {'tokens': [1, S], extras...}
    prompt_len: int
    max_new: int
    generator: torch.Generator | None   # the request's sampling stream
    t_submit: float
    # the generator's state at submit: every admission starts from it, so a
    # requeued request draws its tokens again (a JAX key is a value; a
    # torch generator is consumed by drawing)
    generator_state: torch.Tensor | None = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list[int]            # generated tokens (incl. the final EOS, if any)
    finish_reason: str           # "length" | "eos" | "evicted"
    prompt_len: int
    t_submit: float
    t_admit: float
    t_finish: float

    @property
    def latency(self) -> float:
        """Submit-to-finish wall time (queueing included)."""
        return self.t_finish - self.t_submit


class SlotScheduler:
    """Backend-agnostic queue and slot bookkeeping over a `SlotRingEngine`.

    Subclasses implement:

    * ``_start_admission(req, slot) -> list``: begin serving ``req`` on
      ``slot``: admit it fully (register it in ``running``, possibly
      finishing at once) or park a multi-step admission in
      ``self.admitting[slot]``;
    * ``_admit_batch(pairs) -> list``: admit one pass's matched
      ``(request, slot)`` pairs (default: ``_start_admission`` for each;
      a backend whose admissions are cheap scatters, HDC, admits them all
      in one engine call);
    * ``_advance_admissions() -> list``: one unit of progress on every
      in-flight admission (default: none exist);
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
        mesh = getattr(engine, "mesh", None)
        self.clock = clock if mesh is None or mesh.size == 1 else collectives.SharedClock(clock)
        self.state = engine.init_state()
        self.free: list[int] = list(range(engine.num_slots))
        # slot -> backend-defined running record (LM: (request, tokens, t_admit))
        self.running: dict[int, Any] = {}
        # slot -> backend-defined in-flight admission (LM: (request, ChunkedPrefill))
        self.admitting: dict[int, Any] = {}
        self.buckets: dict[Any, collections.deque] = collections.defaultdict(
            collections.deque)
        self.results: dict[int, Any] = {}
        self.steps = 0
        self.step_id = 0                        # the latest `step` call's (`_STEP_IDS`)
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
        return len(self.running) + len(self.admitting)

    # -- admission / eviction ------------------------------------------------

    def _pop_oldest(self):
        """Pop the globally oldest pending request across all buckets."""
        live = [(q[0].t_submit, q[0].rid, s) for s, q in self.buckets.items() if q]
        if not live:
            return None
        return self.buckets[min(live)[2]].popleft()

    def _admit_free_slots(self) -> list:
        """Match every free slot with the globally oldest pending request,
        re-picked per slot (age-fair), and admit the matches; a slot freed
        at admission (an instant finish) is refilled in the same call."""
        finished = []
        while self.free:
            pairs = []
            while self.free:
                req = self._pop_oldest()
                if req is None:
                    break
                pairs.append((req, self.free.pop(0)))
            if not pairs:
                break
            finished.extend(self._admit_batch(pairs))
        return finished

    # -- backend hooks --------------------------------------------------------

    def _start_admission(self, req, slot: int) -> list:
        raise NotImplementedError

    def _admit_batch(self, pairs: list) -> list:
        return [done for req, slot in pairs for done in self._start_admission(req, slot)]

    def _advance_admissions(self) -> list:
        return []

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
        """Advance in-flight admissions one unit, fill free slots, run one
        multi-slot engine step, collect finished slots. Returns the requests
        completed during this call (at admission too). The call is the
        ``sched.step`` span of step ``step_id``."""
        self.step_id = next(_STEP_IDS)
        with spans.span("sched.step", step=self.step_id):
            finished = self._advance_admissions()
            with spans.span("sched.admit"):
                finished.extend(self._admit_free_slots())
            if not self.running:
                return finished
            stepped = list(self.running)
            self.state, emitted = self.engine.step(self._step_params(), self.state)
            self.steps += 1
            finished.extend(self._collect(emitted))
            if self.max_slot_steps is not None:
                finished.extend(self._enforce_deadlines(stepped))
            return finished

    def run(self, timeout: float | None = None) -> dict:
        """Step until the queue and all slots drain. Returns {rid: completion}."""
        t0 = self.clock()
        while self.pending or self.running or self.admitting:
            self.step()
            if timeout is not None and self.clock() - t0 > timeout:
                raise TimeoutError(
                    f"scheduler did not drain within {timeout}s "
                    f"(pending={self.pending}, active={self.active})")
        return self.results


class Scheduler(SlotScheduler):
    """LM request scheduler over a `ContinuousEngine`.

    Short prompts admit with one whole-prompt prefill; prompts longer than
    the engine's ``prefill_chunk`` (when chunking is on) reserve their slot
    and run one prefill chunk a scheduler step, the first at reservation,
    interleaved with the other slots' decode steps."""

    def __init__(self, engine: ContinuousEngine, params,
                 clock: Callable[[], float] = time.monotonic,
                 *, max_slot_steps: int | None = None, max_requeues: int = 1):
        super().__init__(engine, params, clock, max_slot_steps=max_slot_steps,
                         max_requeues=max_requeues)

    def submit(self, tokens, *, extras: dict | None = None, max_new: int | None = None,
               generator: torch.Generator | None = None) -> int:
        """Queue one request: ``tokens`` [S] or [1, S] (anything
        `torch.as_tensor` takes; moved to the engine's device); ``extras``
        the other B = 1 inputs of the model's family (the enc-dec's
        ``frames``, the VLM's ``patch_embeds`` and ``positions``), tensors
        on the engine's device, which the engine checks at admission. The
        request keeps them with its tokens, so a requeued request replays
        them. Temperature sampling draws from ``generator`` (default: one on
        the engine's device seeded with the request id). Returns the
        request id."""
        tokens = torch.as_tensor(tokens, dtype=torch.int32, device=self.engine.device)
        if tokens.dim() == 1:
            tokens = tokens[None]
        batch = {"tokens": tokens, **(extras or {})}
        max_new = self.engine.cfg.max_new if max_new is None else max_new
        if not 1 <= max_new <= self.engine.cfg.max_new:
            raise ValueError(f"max_new must be in [1, {self.engine.cfg.max_new}]")
        rid = self._next_rid
        self._next_rid += 1
        if generator is None and self.engine.cfg.temperature > 0.0:
            generator = torch.Generator(device=self.engine.device).manual_seed(rid)
        req = Request(rid, batch, tokens.shape[1], max_new, generator, self.clock(),
                      None if generator is None else generator.get_state())
        self.buckets[self._bucket_key(req)].append(req)
        return rid

    def _bucket_key(self, req: Request):
        return _prompt_sig(req.batch)

    def _fail_eviction(self, slot: int, record) -> Completion:
        req, toks, t_admit = record
        return Completion(req.rid, toks, "evicted", req.prompt_len, req.t_submit, t_admit,
                          self.clock())

    def _evict_slot(self, slot: int) -> list:
        self.state["generator"][slot] = None      # the request's stream is drawn no more
        return super()._evict_slot(slot)

    def _finish(self, slot: int, reason: str) -> Completion:
        req, toks, t_admit = self.running.pop(slot)
        done = Completion(req.rid, toks, reason, req.prompt_len, req.t_submit, t_admit,
                          self.clock())
        self.results[req.rid] = done
        self.free.append(slot)
        self.state["generator"][slot] = None
        return done

    def _register(self, req: Request, slot: int, tok0: int) -> list:
        """Record a freshly admitted request; finish at once on an instant
        EOS or max_new == 1."""
        self.running[slot] = (req, [tok0], self.clock())
        eos = self.engine.cfg.eos_id
        if eos is not None and tok0 == eos:
            return [self._finish(slot, "eos")]
        if req.max_new <= 1:
            return [self._finish(slot, "length")]
        return []

    def _start_admission(self, req: Request, slot: int) -> list:
        if req.generator is not None:
            req.generator.set_state(req.generator_state)
        if self.engine.supports_chunked_prefill(req.batch):
            job = self.engine.begin_chunked_prefill(self.params, req.batch, req.generator)
            # run the first chunk now, so a reserved slot always has progress
            self.admitting[slot] = (req, self.engine.advance_chunked_prefill(self.params, job))
            return []
        self.state, tok0 = self.engine.prefill_into_slot(self.params, self.state, req.batch,
                                                         slot, req.generator)
        return self._register(req, slot, tok0)

    def _advance_admissions(self) -> list:
        finished = []
        for slot in sorted(self.admitting):
            req, job = self.admitting[slot]
            if not job.done:
                job = self.engine.advance_chunked_prefill(self.params, job)
                self.admitting[slot] = (req, job)
            if job.done:
                del self.admitting[slot]
                self.state, tok0 = self.engine.admit_chunked(self.state, job, slot)
                finished.extend(self._register(req, slot, tok0))
        return finished

    def _collect(self, emitted) -> list:
        em = emitted.cpu().tolist()      # the step barrier: one copy to the host
        eos = self.engine.cfg.eos_id
        finished = []
        for slot in sorted(self.running):
            req, toks, _ = self.running[slot]
            toks.append(em[slot])
            if eos is not None and em[slot] == eos:
                finished.append(self._finish(slot, "eos"))
            elif len(toks) >= req.max_new:
                finished.append(self._finish(slot, "length"))
        return finished
