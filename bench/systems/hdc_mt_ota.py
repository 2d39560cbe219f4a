"""The multi-tenant OTA serve of `repro_torch` as the system under test:
`serving.hdc.HDCScheduler` over an `HDCEngine`, whose step is one
`core.scaleout.make_mt_ota_serve` call.

Set-up, in order: load the kernel library (built into ``build/kernels/`` of
the checkout by its first run), precharacterize the channel
(`scaleout.precharacterize_state`), make the tenants' packed codebooks and a
pool of query batches a tenant from the seed (the benchmark's inputs, made
here on the device in three calls), onboard every tenant. Each request
carries its own noise generator, seeded from (seed, request index).

The configuration file gives the serve's `ScaleOutConfig` fields, the slots
and the tenants; the reference it names (``bench/reference/<name>.py``)
checks the answers.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from bench.seeds import derive

# the ScaleOutConfig fields a configuration file states
SERVE_FIELDS = ("n_classes", "dim", "m_tx", "n_rx_cores", "snr_db", "batch", "channel",
                "noise", "noise_planes", "representation", "permuted", "collective")


@dataclasses.dataclass
class Done:
    """One finished request, on the scheduler's clock (seconds)."""

    rid: int
    index: int          # the benchmark's request index (its noise seed's)
    tenant: int
    entry: int          # its query batch in the tenant's pool
    t_submit: float
    t_admit: float
    t_finish: float
    ok: bool
    units: int          # trials
    pred: object        # [B] int32 (numpy)
    maxsim: object      # [B] float32 (numpy)


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, spans: dict | None):
        from repro_torch.core import scaleout
        from repro_torch.serving import HDCEngine, HDCScheduler

        self.cfg, self.seed = cfg, seed
        self.dev = torch.device(device)
        self.marks = [("imports", time.perf_counter())]     # set-up's stages, as they end
        if self.dev.type == "cuda":
            from repro_torch.kernels import _build
            _build.library()
        self.marks.append(("kernel library", time.perf_counter()))
        self.scfg = scaleout.ScaleOutConfig(**{k: cfg[k] for k in SERVE_FIELDS})
        state = scaleout.precharacterize_state(self.scfg, device=self.dev)
        self.marks.append(("precharacterization", time.perf_counter()))
        t, c, b, m = cfg["tenants"], cfg["n_classes"], cfg["batch"], cfg["m_tx"]
        w = cfg["dim"] // 32
        self.pool_size = traffic["pool"]
        g = torch.Generator(device=self.dev).manual_seed(derive(seed, "codebooks"))
        self.books = torch.randint(-2 ** 31, 2 ** 31, (t, c, w), generator=g, device=self.dev,
                                   dtype=torch.int32)
        g = torch.Generator(device=self.dev).manual_seed(derive(seed, "classes"))
        self.classes = torch.randint(0, c, (t, self.pool_size, b, m), generator=g,
                                     device=self.dev)
        tix = torch.arange(t, device=self.dev)[:, None, None, None]
        pool = self.books[tix, self.classes]                       # [T, K, B, M, W]
        # each request's [B, 1, M, W] view, sliced once here and not per request
        self.pool = [[pool[i, k][:, None] for k in range(self.pool_size)] for i in range(t)]
        self.marks.append(("inputs", time.perf_counter()))
        self.engine = HDCEngine(self.scfg, state, num_slots=cfg["slots"], max_tenants=t,
                                device=self.dev)
        for tenant in range(t):
            self.engine.registry.onboard(tenant, self.books[tenant])
        self.sched = HDCScheduler(self.engine, clock=time.perf_counter)
        self.marks.append(("engine and onboarding", time.perf_counter()))
        self.meta: dict[int, tuple[int, int, int]] = {}
        if spans is not None:
            _timed(self.engine, "admit_many", "bench.admit", spans.setdefault("admit", []))
            _timed(self.engine, "step", "bench.serve", None)

    # -- what the loops drive ----------------------------------------------

    def submit(self, client: int, index: int) -> int:
        """Queue request ``index`` of ``client``: the tenant ``client mod T``,
        query batch ``index mod K`` of its pool, its own noise generator."""
        tenant = client % self.cfg["tenants"]
        entry = index % self.pool_size
        gen = torch.Generator(device=self.dev).manual_seed(derive(self.seed, "noise", index))
        rid = self.sched.submit(tenant, self.pool[tenant][entry], generator=gen)
        self.meta[rid] = (index, tenant, entry)
        return rid

    def step(self) -> list[Done]:
        out = []
        for c in self.sched.step():
            self.sched.results.pop(c.rid, None)
            index, tenant, entry = self.meta.pop(c.rid)
            out.append(Done(c.rid, index, tenant, entry, c.t_submit, c.t_admit, c.t_finish,
                            c.status == "ok", self.cfg["batch"], c.pred, c.maxsim))
        return out

    @property
    def in_flight(self) -> int:
        return self.sched.pending + self.sched.active

    def shapes(self) -> dict:
        """The top-1 search a step: G = slots x cores banks of B queries over
        C / cores classes of W words, the banks rows of a [T x cores, C /
        cores, W] table (`yardstick.cost.topk_cost`)."""
        cfg = self.cfg
        n = cfg["n_rx_cores"]
        return {"top1": dict(g=cfg["slots"] * n, b=cfg["batch"], c_real=cfg["n_classes"] // n,
                             w=cfg["dim"] // 32, table_rows=cfg["tenants"] * n)}

    def release(self) -> None:
        """Free the program's state (the inputs stay for the reference)."""
        self.engine = self.sched = self.pool = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------

    def mismatches(self, dones: list[Done], control: bool = False) -> dict:
        """Trials of ``dones`` whose class, and whose similarity, differ from
        the reference's. ``control``: the reference one precision below the
        stated noise takes the program's place."""
        from bench.harness import load

        Reference = load("reference", self.cfg["reference"]).Reference
        ref = Reference(self.cfg, self.books)
        low = Reference(self.cfg, self.books, lower=True) if control else None
        pred_off = sim_off = 0
        for d in dones:
            args = (d.tenant, self.classes[d.tenant, d.entry],
                    derive(self.seed, "noise", d.index))
            pred, sim = (x.cpu().numpy() for x in ref.answer(*args))
            got = (d.pred, d.maxsim) if low is None else (
                x.cpu().numpy() for x in low.answer(*args))
            got_pred, got_sim = got
            pred_off += int((got_pred != pred).sum())
            sim_off += int((got_sim != sim).sum())
        return {"pred_mismatch": pred_off, "maxsim_mismatch": sim_off}


def _timed(obj, method: str, label: str, durations: list | None) -> None:
    """Wrap ``obj.method`` in a profiler range and, with ``durations``, a
    host-clock span appended there."""
    from torch.profiler import record_function

    inner = getattr(obj, method)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        with record_function(label):
            out = inner(*args, **kwargs)
        if durations is not None:
            durations.append(time.perf_counter() - t0)
        return out

    setattr(obj, method, wrapped)


def build(cfg: dict, traffic: dict, seed: int, device: str, spans: dict | None) -> System:
    return System(cfg, traffic, seed, device, spans)
