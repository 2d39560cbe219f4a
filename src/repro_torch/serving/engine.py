"""Static-batch LM serving (counterpart of `Engine` in
`repro/serving/engine.py`).

A batch of same-length prompts is prefilled in one pass, with the KV cache
padded to prompt + max_new + 1, then ``max_new`` decode steps run in a
Python loop, exactly the reference's schedule: the emitted tokens are the
carry ``[tok0, ..., tok_{max_new-1}]``, so the last decode's output is not
used. The reference's compiled-program cache has no counterpart: PyTorch
runs eagerly. The continuous engine waits for ROADMAP §1, serving.
"""
from __future__ import annotations

import dataclasses

import torch


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


class Engine:
    """Static-batch engine over a model's ``prefill_fn`` / ``decode_fn``."""

    def __init__(self, model, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg

    def generate(self, params: dict, batch: dict,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """batch: {'tokens': [B, S_prompt]}. Returns int32 [B, max_new].
        Temperature sampling draws from `generator` (required then)."""
        model, cfg = self.model, self.cfg
        if cfg.temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        pos0 = batch["tokens"].shape[1]
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
