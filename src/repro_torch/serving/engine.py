"""LM serving engines (counterpart of `repro/serving/engine.py`): the
static-batch generate and the slot-ring decode backend.

* ``Engine`` (static batch): a batch of same-length prompts is prefilled in
  one pass, with the KV cache padded to prefix + prompt + max_new + 1 (the
  prefix: a VLM's patch embeddings, which sit ahead of the text), then
  ``max_new`` decode steps run in a Python loop, exactly the reference's
  schedule: the emitted tokens are the carry ``[tok0, ..., tok_{max_new-1}]``,
  so the last decode's output is not used.

* ``ContinuousEngine``: the LM backend of the slot ring
  (`repro_torch.serving.slotring`). N decode slots share one multi-slot
  step, which is the static decode at B = N with one position a row: every
  cache leaf's batch axis (the model's ``cache_axes``) is the slot axis
  (k/v [L, N, Sc, KH, hd]; the SSM's conv/ssm [L, N, ...]; the hybrid's
  k/v [G, N, ...] and conv/ssm [G, per, N, ...]; the enc-dec's cross
  ck/cv [L, N, T, KH, hd]), ``slot_pos`` is [N, Sc]
  where the family has a KV cache, and ``pos`` [N] lives on the device, so
  the step reads nothing back to the host. A request is admitted by a
  B = 1 prefill whose cache is copied into its slot's row
  (`slotring.slot_update`), with its next token, position, done flag and
  generator; a request carries the inputs its model's family reads (the
  enc-dec's ``frames``, the VLM's ``patch_embeds`` and ``positions``), and
  nothing else; finished rows are evicted at step granularity while the
  others keep decoding. `repro_torch.serving.scheduler`
  is the queue and admission policy on top.

Chunked prefill (``prefill_chunk=N``): a prompt longer than N admits chunk
by chunk, one chunk a scheduler step, while its slot is reserved, so one
long admission does not stall every decoding slot for a whole prefill. Each
chunk writes its K/V into the request's own full-capacity B = 1 cache and
attends over the prefix plus itself on the attention kernel's ``q_offset``;
the last chunk's logits are sampled with the request's generator, so the
tokens match the one-shot prefill's.

PyTorch runs eagerly: the reference's compiled programs have no
counterpart, and the signature sets ``_prefill_sigs`` and ``_chunk_sigs``
only record the distinct prompt shapes and (start, length) chunks seen.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from repro_torch.distributed.mesh import one_rank
from repro_torch.serving import slotring


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new: int = 32
    temperature: float = 0.0     # 0 -> greedy
    eos_id: int | None = None


def _sample(cfg: ServeConfig, logits: torch.Tensor,
            generator: torch.Generator | None) -> torch.Tensor:
    """Greedy: the first maximum (``torch.argmax`` promises it). Otherwise a
    categorical draw at the temperature from `generator`."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, -1).to(torch.int32)
    probs = torch.softmax(logits.float() / cfg.temperature, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _vision_prefix(batch: dict) -> int:
    """Decoder positions in front of the prompt (the VLM's patch embeddings)."""
    return batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0


def _check_inputs(model, batch: dict) -> None:
    """Refuse, by name, a batch entry that the model's family does not read
    (the reference's engine would count a dense decoder's ``patch_embeds``
    as a prefix and shift its positions; the port refuses it)."""
    extra = sorted(set(batch) - set(model.inputs))
    if extra:
        raise ValueError(f"{model.cfg.name} reads no {extra}: its batch holds "
                         f"{list(model.inputs)}")
    if "tokens" not in batch:
        raise ValueError(f"{model.cfg.name}: a batch needs 'tokens'")


class Engine:
    """Static-batch engine over a model's ``prefill_fn`` / ``decode_fn``."""

    def __init__(self, model, cfg: ServeConfig):
        one_rank("Engine")
        self.model = model
        self.cfg = cfg

    def generate(self, params: dict, batch: dict,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """batch: {'tokens': [B, S_prompt]} and the inputs the model's family
        reads (``frames``; ``patch_embeds``, ``positions``). Returns int32
        [B, max_new]. The first decode sits at the prompt's length plus the
        vision prefix. Temperature sampling draws from `generator` (required
        then)."""
        model, cfg = self.model, self.cfg
        if cfg.temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        _check_inputs(model, batch)
        pos0 = batch["tokens"].shape[1] + _vision_prefix(batch)
        logits, cache = model.prefill_fn(params, batch, pad_to=pos0 + cfg.max_new + 1)
        tok = _sample(cfg, logits, generator)
        done = torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
        out = []
        for i in range(cfg.max_new):
            logits, cache = model.decode_fn(params, cache, tok, pos0 + i)
            nxt = _sample(cfg, logits, generator)
            if cfg.eos_id is not None:
                done = done | (tok == cfg.eos_id)
                nxt = torch.where(done, torch.full_like(nxt, cfg.eos_id), nxt)
            out.append(tok)
            tok = nxt
        if not out:
            return torch.empty((tok.shape[0], 0), dtype=torch.int32, device=tok.device)
        return torch.stack(out, 1)


def _prompt_sig(batch: dict) -> tuple:
    """Shape signature of a prompt batch: the shape and dtype of every input."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))


@dataclasses.dataclass
class ChunkedPrefill:
    """One in-flight chunked admission: the reserved slot's prefill progress.

    ``cache`` is the request's own full-capacity B = 1 cache with K/V
    written for positions [0, start); ``logits`` holds the last chunk's
    last-position logits (what the first token is sampled from once
    ``done``)."""

    batch: dict
    generator: torch.Generator | None
    cache: dict
    start: int
    logits: torch.Tensor | None = None

    @property
    def prompt_len(self) -> int:
        return self.batch["tokens"].shape[1]

    @property
    def done(self) -> bool:
        return self.start >= self.prompt_len


class ContinuousEngine(slotring.SlotRingEngine):
    """Slot-ring LM decode backend: step-granular admission and eviction
    over one multi-slot decode.

    State: ``cache`` (the model's cache at B = N, any tree of leaves with a
    batch axis, e.g. k/v [L, N, Sc, KH, hd], and slot_pos [N, Sc] where the
    family has a KV cache), ``tok``, ``pos`` [N] int32, ``done`` [N] bool
    and ``generator`` (a list of N `torch.Generator` or None). Every slot's
    cache has the capacity ``max_prompt_len + max_prefix + max_new + 1``
    whatever its prompt's length (``max_prefix``: the longest vision
    prefix a VLM request brings), so one step serves any mix of requests.
    Empty and finished slots decode garbage rows (``done`` set, the row
    masked or stale) until an admission overwrites the whole row.

    ``prefill_chunk=N`` admits text prompts longer than N chunk by chunk on
    the families with a ``prefill_chunk_fn`` (the dense decoders); a
    request with a vision prefix prefills whole."""

    def __init__(self, model, cfg: ServeConfig, num_slots: int, max_prompt_len: int,
                 max_prefix: int = 0, prefill_chunk: int | None = None, *,
                 device: str | torch.device | None = "cuda"):
        one_rank("ContinuousEngine")     # the reference's engines take no mesh either
        if cfg.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if max_prefix < 0:
            raise ValueError("max_prefix must be >= 0")
        self.device = _device.resolve(device)
        self.model = model
        self.cfg = cfg
        self.max_prompt_len = max_prompt_len
        self.capacity = max_prompt_len + max_prefix + cfg.max_new + 1
        mw = model.cfg.max_window
        if 0 <= mw < max_prompt_len + max_prefix:
            raise ValueError(
                f"pure sliding-window model (window {mw} < max prompt "
                f"{max_prompt_len + max_prefix}): prefill would produce ring caches whose "
                "capacity depends on prompt length, breaking slot uniformity")
        self.prefill_chunk = None
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            if model.prefill_chunk_fn is None:
                raise ValueError("this model family has no chunked prefill "
                                 "(prefill_chunk_fn is None): dense decoders only")
            if 0 <= mw < self.capacity:
                raise ValueError(f"chunked prefill needs a full-capacity cache; window {mw} "
                                 f"< capacity {self.capacity} would make it a ring")
            self.prefill_chunk = int(prefill_chunk)
        self._prefill_sigs: set[tuple] = set()
        self._chunk_sigs: set[tuple] = set()
        super().__init__(num_slots)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> dict:
        n = self.num_slots
        cache = self.model.init_cache_fn(n, self.capacity, device=self.device)
        if "slot_pos" in cache:      # one row of slot positions a slot
            cache["slot_pos"] = torch.full((n, cache["slot_pos"].shape[0]), -1,
                                           dtype=torch.int32, device=self.device)
        return {
            "cache": cache,
            "tok": torch.zeros((n,), dtype=torch.int32, device=self.device),
            "pos": torch.zeros((n,), dtype=torch.int32, device=self.device),
            "done": torch.ones((n,), dtype=torch.bool, device=self.device),  # empty: frozen
            "generator": [None] * n,
        }

    # -- admission -----------------------------------------------------------

    def _admit_impl(self, state, slots, cache, tok0, pos0, generators):
        """Copy a B = K cache into rows ``slots`` of the slot-stacked cache
        (each leaf's batch axis, from the model's ``cache_axes``; slot_pos
        [Sc] becomes K rows), with each row's first token, position, done
        flag and generator: the whole row, so no stale key or state of the
        slot's last request stays visible."""
        k = len(slots)
        new = {name: t.reshape(k, -1) if name == "slot_pos" else t for name, t in cache.items()}
        axes = {name: self.model.cache_axes[name].index("batch")
                for name in new if name != "slot_pos"}
        slotring.slot_update(state["cache"], new, slots, axes=axes)
        return slotring.slot_update(state, {"tok": tok0, "pos": pos0, "done": [False] * k,
                                            "generator": generators}, slots)

    def _check_request(self, batch: dict) -> int:
        """The first decode position (prompt length plus vision prefix) of a
        B = 1 batch that holds only what the model's family reads, on the
        engine's device, and fits the capacity: the continuous
        counterpart of the reference's ``_check_capacity``."""
        _check_inputs(self.model, batch)
        if any(t.shape[0] != 1 for t in batch.values()):
            raise ValueError("continuous admission is per request (B = 1), got "
                             f"{ {k: tuple(t.shape) for k, t in batch.items()} }")
        _device.check_on(self.device, **batch)
        cfg = self.model.cfg
        if "frames" in batch and tuple(batch["frames"].shape[1:]) != (cfg.enc_seq,
                                                                      cfg.d_model):
            raise ValueError(f"frames {tuple(batch['frames'].shape)}: a slot's cross K/V "
                             f"holds [1, {cfg.enc_seq}, {cfg.d_model}] frames")
        prompt_len, prefix = batch["tokens"].shape[1], _vision_prefix(batch)
        if "positions" in batch and batch["positions"].shape[1] != prefix + prompt_len:
            raise ValueError(f"positions {tuple(batch['positions'].shape)} do not cover the "
                             f"prefix {prefix} and the prompt {prompt_len}")
        if prompt_len + prefix + self.cfg.max_new + 1 > self.capacity:
            raise ValueError(f"prompt_len {prompt_len} (+prefix {prefix}) exceeds engine "
                             f"capacity {self.capacity} - max_new {self.cfg.max_new} - 1")
        return prompt_len + prefix

    def prefill_into_slot(self, params, state, batch: dict, slot: int,
                          generator: torch.Generator | None = None) -> tuple[dict, int]:
        """Prefill one request (B = 1) and copy it into ``slot``. Returns
        (state, first generated token). Temperature sampling draws from
        ``generator``."""
        pos0 = self._check_request(batch)
        self._prefill_sigs.add(_prompt_sig(batch))
        logits, cache = self.model.prefill_fn(params, batch, pad_to=self.capacity)
        tok0 = _sample(self.cfg, logits, generator)
        state = self.admit(state, [slot], cache, tok0, [pos0], [generator])
        return state, int(tok0[0])

    # -- chunked admission ---------------------------------------------------

    def supports_chunked_prefill(self, batch: dict) -> bool:
        """True when this request admits chunk by chunk: chunking is on, the
        request has no vision prefix (which changes the position map) and
        the prompt is longer than one chunk (a shorter prompt IS one chunk,
        and takes the whole-prefill path)."""
        return (self.prefill_chunk is not None and "patch_embeds" not in batch
                and batch["tokens"].shape[1] > self.prefill_chunk)

    def begin_chunked_prefill(self, params, batch: dict,
                              generator: torch.Generator | None = None) -> ChunkedPrefill:
        """Start a chunked admission: a fresh full-capacity B = 1 cache of
        the request's own, on the engine's device, with no chunk run yet.
        ``params`` rides along for parity with `prefill_into_slot`."""
        del params
        self._check_request(batch)
        cache = self.model.init_cache_fn(1, self.capacity, device=self.device)
        return ChunkedPrefill(batch=batch, generator=generator, cache=cache, start=0)

    def advance_chunked_prefill(self, params, job: ChunkedPrefill) -> ChunkedPrefill:
        """Run ONE prefill chunk of ``job``."""
        cs = min(self.prefill_chunk, job.prompt_len - job.start)
        tokens = job.batch["tokens"][:, job.start:job.start + cs]
        self._chunk_sigs.add((job.start, cs))
        logits, cache = self.model.prefill_chunk_fn(params, job.cache, tokens, job.start)
        return dataclasses.replace(job, cache=cache, start=job.start + cs, logits=logits)

    def admit_chunked(self, state, job: ChunkedPrefill, slot: int) -> tuple[dict, int]:
        """Copy a completed chunked prefill into ``slot``; the first token is
        sampled from the last chunk's logits with the request's generator,
        as the one-shot prefill samples it."""
        if not job.done:
            raise ValueError("admit_chunked before the last chunk ran")
        tok0 = _sample(self.cfg, job.logits, job.generator)
        state = self.admit(state, [slot], job.cache, tok0, [job.prompt_len], [job.generator])
        return state, int(tok0[0])

    # -- decode --------------------------------------------------------------

    def _sample_slots(self, logits: torch.Tensor, generators: list) -> torch.Tensor:
        """Greedy over all rows at once; at a temperature each row draws from
        its own slot's generator, as a B = 1 static generate draws (a slot
        with none, empty or finished, takes the greedy token)."""
        if self.cfg.temperature <= 0.0:
            return _sample(self.cfg, logits, None)
        greedy = dataclasses.replace(self.cfg, temperature=0.0)
        return torch.cat([_sample(self.cfg if g is not None else greedy, logits[i:i + 1], g)
                          for i, g in enumerate(generators)])

    def _step_impl(self, params, state):
        """One decode step of every slot, each at its own position, written
        into the state in place (its tensors keep their addresses). Emits
        the next token of every slot [N] int32."""
        cfg = self.cfg
        logits, cache = self.model.decode_fn(params, state["cache"], state["tok"],
                                             state["pos"])
        for name, live in state["cache"].items():    # what the decode did not write in place
            if cache[name] is not live:
                live.copy_(cache[name])
        nxt = self._sample_slots(logits, state["generator"])
        if cfg.eos_id is not None:
            state["done"] |= state["tok"] == cfg.eos_id
            nxt = torch.where(state["done"], torch.full_like(nxt, cfg.eos_id), nxt)
        state["tok"].copy_(nxt)
        state["pos"] += 1
        return state, nxt
