"""Deterministic sharded synthetic LM stream with O(1) skip-ahead resume
(counterpart of `repro/data/pipeline.py`).

Every batch is a pure function of (seed, step, host index): `batch(step)`
seeds a `torch.Generator` from them, so resuming from a checkpoint at step k
needs no replay; the pipeline's state is the step counter (the Trainer
stores it in the checkpoint as ``data_step``). Per-host sharding gives each host its own slice of the global
batch. The stream is the reference's: Zipf(a) tokens, a per-row motif of
`motif_len` tokens tiled along the row and used at each position with
probability `motif_prob`, tokens and targets shifted by one. The torch and
JAX generators draw different numbers from one seed, so the two streams
agree in distribution, not token for token.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.7


class SyntheticLM:
    """Deterministic LM stream; `batch(step)` -> {'tokens', 'targets'}
    int32 [B_local, S] on ``device`` (the card unless the caller asks for
    another; raises without CUDA)."""

    def __init__(self, cfg: DataConfig, host_index: int = 0, host_count: int = 1,
                 device="cuda"):
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{host_count} hosts")
        if not 0 <= host_index < host_count:
            raise ValueError(f"host index {host_index} outside [0, {host_count})")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.device = resolve(device)
        self._local = cfg.global_batch // host_count
        ranks = torch.arange(1, cfg.vocab + 1, dtype=torch.float64)
        p = ranks ** (-cfg.zipf_a)
        # the inverse CDF of Zipf(a) over the vocabulary, in f64
        self._cdf = torch.cumsum(p / p.sum(), 0).to(self.device)

    def _generator(self, step: int) -> torch.Generator:
        seed = (self.cfg.seed * 1_000_003 + step) * 1_000_003 + self.host_index
        return torch.Generator(device=self.device).manual_seed(seed % (2**63))

    def _zipf(self, gen: torch.Generator, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=gen, dtype=torch.float64, device=self.device)
        return torch.searchsorted(self._cdf, u, right=True).clamp_(max=self.cfg.vocab - 1)

    def draw(self, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(tokens [B_local, S + 1] int32, the motif mask [B_local, S + 1])."""
        cfg = self.cfg
        gen = self._generator(step)
        b, s = self._local, cfg.seq + 1
        fresh = self._zipf(gen, (b, s))
        motif = self._zipf(gen, (b, cfg.motif_len))
        tiled = motif.repeat(1, s // cfg.motif_len + 1)[:, :s]
        use_motif = torch.rand((b, s), generator=gen, device=self.device) < cfg.motif_prob
        return torch.where(use_motif, tiled, fresh).to(torch.int32), use_motif

    def batch(self, step: int) -> dict:
        toks, _ = self.draw(step)
        return {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
