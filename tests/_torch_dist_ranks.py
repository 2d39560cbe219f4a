"""What one rank of a multi-rank test world runs (imported by the spawned
rank processes, so it imports torch and the port only, never JAX).

`run(mesh, inputs, cases)` serves every case on this rank's shard of the
global inputs and returns {case name: outputs}. With ``mesh=None`` the same
code serves the whole inputs on one rank, which is what the multi-rank
answers are held to.

``inputs`` holds numpy arrays: ``protos_u`` [C, d] uint8 (the codebook),
``protos2_u`` (a second tenant), ``ber`` [n_rx] (the BSC state), ``masks``
[n_rx, B, d] uint8 (flip masks replayed by core, the ``bsc_replay`` tier),
``nr``/``ni``/``flips`` [n_rx, B, d] (the symbol tier's draws replayed by
core, ``symbol_replay``), ``state_*`` (a real ChannelState's fields),
``examples``/``labels`` (a training batch), and optionally queries in any
model-column layout [B, S', e', d|W|k] under the name a case gives.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import phy
from repro_torch.core import hypervector as hv, scaleout, sparse
from repro_torch.distributed import collectives
from repro_torch.launch import mesh as tmesh

CPU = "cpu"


class ReplayChannel(phy.Channel):
    """BSC tier that flips with masks drawn beforehand, core i on
    ``masks[i]`` [B, d] uint8."""

    name = "bsc_replay"
    wire = "votes"

    def __init__(self, masks: torch.Tensor):
        self.masks = masks

    def rx_copies(self, generator, reduced, state, rx_base, n_cores,
                  *, packed, dim, noise, planes, n_all=None):
        m = self.masks[rx_base:rx_base + n_cores]
        return reduced[None] ^ (hv.pack(m) if packed else m)


class SymbolReplay(phy.SymbolChannel):
    """The symbol tier on draws made beforehand, core i on row i."""

    name = "symbol_replay"

    def __init__(self, nr, ni, flips):
        self.nr, self.ni, self.flips = nr, ni, flips

    def draws(self, generator, state, rx_base, n_cores, shape, n_all=None):
        rows = slice(rx_base, rx_base + n_cores)
        return self.nr[rows], self.ni[rows], self.flips[rows]


def relayout(q: torch.Tensor, m_tx: int, model_size: int, fill) -> torch.Tensor:
    """Queries [..., B, S', e', L] -> [..., B, S, ceil(M/S), L] (S =
    ``model_size``): the same encoders in global order, empty slots ``fill``."""
    lead, last = tuple(q.shape[:-3]), q.shape[-1]
    flat = q.reshape(lead + (-1, last))[..., :m_tx, :]
    e_per = -(-m_tx // model_size)
    pad = model_size * e_per - m_tx
    flat = torch.nn.functional.pad(flat, (0, 0, 0, pad), value=fill)
    return flat.reshape(lead + (model_size, e_per, last))


def _state(inputs, cfg):
    if "state_ber" in inputs:
        return phy.ChannelState(**{f: torch.from_numpy(np.array(inputs[f"state_{f}"]))
                                   for f in phy.ChannelState.FIELDS})
    return phy.state_from_ber(torch.from_numpy(np.array(inputs["ber"])), cfg.m_tx)


def _queries(inputs, case, cfg, protos_u, model_size, seed):
    if "queries" in case:
        q = torch.from_numpy(np.array(inputs[case["queries"]]))
        fill = sparse.SENTINEL if cfg.sparse else 0
        return relayout(q, cfg.m_tx, model_size, fill)
    return scaleout.make_queries(torch.Generator().manual_seed(seed), cfg, protos_u,
                                 model_size=model_size)[1]


def _serve_case(mesh, inputs, case, model_size):
    cfg = scaleout.ScaleOutConfig(**case["cfg"])
    protos_u = torch.from_numpy(np.array(inputs[case.get("book", "protos_u")]))
    words = cfg.packed or cfg.sparse
    state = _state(inputs, cfg)
    if case.get("state") == "hot":
        # a BER ramp of 0.25-0.5 over the cores: the real state flips ~1e-5 of
        # the bits, and a core at BER 0 would win every sparse top-1
        state = phy.state_from_ber(torch.linspace(0.25, 0.5, cfg.n_rx_cores), cfg.m_tx)
    kind = case.get("kind", "ota")
    if kind == "train":
        fn = scaleout.make_hdc_train(cfg, device=CPU, mesh=mesh)
        ex = torch.from_numpy(np.array(inputs["examples"]))
        ex = hv.pack(ex) if cfg.packed else ex
        labels = torch.from_numpy(np.array(inputs["labels"]))
        out = fn(scaleout.shard_batch(mesh, ex), scaleout.shard_batch(mesh, labels))
        return dict(protos=out.numpy())
    if kind == "mt":
        books = [protos_u, torch.from_numpy(np.array(inputs["protos2_u"]))]
        store = torch.stack([hv.pack(b) if words else b for b in books])
        rows = torch.tensor(case["rows"], dtype=torch.int32)
        q = torch.stack([scaleout.make_queries(torch.Generator().manual_seed(10 + s), cfg,
                                               books[r], model_size=model_size)[1]
                         for s, r in enumerate(case["rows"])])
        store, q, st = scaleout.shard_inputs(cfg, mesh, store, q, state, slots=True)
        gens = [torch.Generator().manual_seed(20 + s) for s in range(len(case["rows"]))]
        collectives.reset_wire_bytes()
        pred, sim = scaleout.make_mt_ota_serve(cfg, device=CPU, mesh=mesh)(store, q, rows, st,
                                                                           gens)
        return dict(pred=pred.numpy(), sim=sim.numpy(), bytes=collectives.wire_bytes())
    q = _queries(inputs, case, cfg, protos_u, model_size, case.get("seed", 1))
    if "batch_rows" in case:          # one data row's rows of the batch, on one rank
        lo, hi = case["batch_rows"]
        q = q[lo:hi]
        cfg = dataclasses.replace(cfg, batch=hi - lo)
    protos = hv.pack(protos_u) if words else protos_u
    protos, q, st = scaleout.shard_inputs(cfg, mesh, protos, q, state)
    build = scaleout.make_wired_serve if kind == "wired" else scaleout.make_ota_serve
    fn = build(cfg, device=CPU, mesh=mesh)
    collectives.reset_wire_bytes()
    pred, sim = fn(protos, q, st, torch.Generator().manual_seed(2))
    return dict(pred=pred.numpy(), sim=sim.numpy(), bytes=collectives.wire_bytes())


def refusals(mesh) -> dict:
    """What a rank of a multi-rank world refuses: the LM `Engine` and the
    `ContinuousEngine` each raise NotImplementedError naming ROADMAP.md §1
    (the reference's engines take no mesh); the `Trainer` takes the ranks
    ("ran": sharded training, tests/test_torch_distributed_train.py)."""
    from repro_torch.serving.engine import ContinuousEngine, Engine
    from repro_torch.train.loop import Trainer, TrainerConfig

    tries = {
        "engine": lambda: Engine(None, None),
        "continuous": lambda: ContinuousEngine(None, None, 1, 8, device=CPU),
        "trainer": lambda: Trainer(None, None, TrainerConfig()),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = "ROADMAP.md §1" in str(e)
    return out


def run(mesh, inputs: dict, cases: list) -> dict:
    """Serve every case on this rank (``mesh=None``: on one rank, the whole
    inputs) and return {name: outputs}, plus this rank's coordinates."""
    dpos, _ = scaleout._dpos(mesh)
    tx, model_size = (0, 1) if mesh is None else (mesh.index("model"), mesh.axis_size("model"))
    rows = scaleout.shard_batch(mesh, torch.arange(inputs["masks"].shape[1]))
    rows = slice(int(rows[0]), int(rows[-1]) + 1)
    phy.register_channel(ReplayChannel(torch.from_numpy(np.array(inputs["masks"]))[:, rows]),
                         override=True)
    if "nr" in inputs:
        phy.register_channel(SymbolReplay(*(torch.from_numpy(np.array(inputs[k]))[:, rows]
                                            for k in ("nr", "ni", "flips"))), override=True)
    out = {"coords": (dpos, tx)}
    for case in cases:
        out[case["name"]] = _serve_case(mesh, inputs, case, model_size)
    if mesh is not None and mesh.size > 1:
        out["refusals"] = refusals(mesh)
    return out


def assemble(results: list, name: str, key: str) -> np.ndarray:
    """One case's global answer from every rank's: the data ranks' rows in
    order (every model rank of a data row must agree), or for a training
    case the model ranks' classes in order (every data rank must agree)."""
    by = {r["coords"]: r[name][key] for r in results}
    n_data = 1 + max(d for d, _ in by)
    n_model = 1 + max(t for _, t in by)
    if key == "protos":
        for t in range(n_model):
            for d in range(n_data):
                np.testing.assert_array_equal(by[(d, t)], by[(0, t)])
        return np.concatenate([by[(0, t)] for t in range(n_model)])
    for d in range(n_data):
        for t in range(n_model):
            np.testing.assert_array_equal(by[(d, t)], by[(d, 0)])
    axis = 1 if name.startswith("mt") else 0
    return np.concatenate([by[(d, 0)] for d in range(n_data)], axis=axis)


# ---------------------------------------------------------------------------
# the collectives on one model axis
# ---------------------------------------------------------------------------

BLIND = [(1, 512), (2, 512), (1, 100), (3, 257), (5, 96), (1, 64)]      # (e_per, d)
AWARE = [(1, 3, 512), (2, 5, 512), (2, 7, 100), (1, 3, 96), (2, 3, 64)]  # (e_per, m_act, d)


def collective_case_names(s: int) -> list[str]:
    """The names `collective_cases` returns on a model axis of ``s`` ranks."""
    names = []
    for e_per, d in BLIND:
        for tag in ("random", "max", "min"):
            names += [f"{op}-blind-e{e_per}-d{d}-{tag}" for op in ("allreduce", "scatter")
                      if op == "allreduce" or d % s == 0]
    for e_per, m_act, d in AWARE:
        for tag in ("random", "ones", "zeros"):
            names += [f"{op}-aware-e{e_per}-m{m_act}-d{d}-{tag}"
                      for op in ("allreduce", "scatter") if op == "allreduce" or d % s == 0]
        names += [f"{op}-erased-e{e_per}-m{m_act}-d{d}"
                  for op in ("allreduce", "scatter") if op == "allreduce" or d % s == 0]
    return names + ["bit31-lanes", "bit31-tally", "index_allgather", "majority",
                    "majority-ber", "sign", "sign-ber", "wire-bytes", "host-mesh"]


def collective_cases(mesh) -> dict:
    """Every collective of `distributed.collectives` over the model axis:
    {name: (got, want[, bytes])} on this rank, ``want`` being the plain
    int32 reduction (or the expected layout) of the same inputs."""
    g, s, tx = mesh.group("model"), mesh.axis_size("model"), mesh.index("model")
    out = {}

    def reduce_pair(name, votes, **kw):
        want = collectives.all_reduce(votes.to(torch.int32), g)
        collectives.reset_wire_bytes()
        got = collectives.packed_vote_allreduce(votes, g, **kw)
        out[f"allreduce-{name}"] = (got.numpy(), want.numpy(), collectives.wire_bytes())
        if votes.shape[-1] % s:
            return
        want = collectives.reduce_scatter_last(votes.to(torch.int32), g)
        collectives.reset_wire_bytes()
        got = collectives.packed_vote_psum_scatter(votes, g, **kw)
        out[f"scatter-{name}"] = (got.numpy(), want.numpy(), collectives.wire_bytes())

    for e_per, d in BLIND:
        gen = torch.Generator().manual_seed(1000 * e_per + d)
        rand = torch.randint(-e_per, e_per + 1, (s, 4, d), generator=gen)[tx]
        for tag, v in (("random", rand), ("max", torch.full((4, d), e_per)),
                       ("min", torch.full((4, d), -e_per))):
            reduce_pair(f"blind-e{e_per}-d{d}-{tag}", v.to(torch.int8), e_per=e_per)
    for e_per, m_act, d in AWARE:
        gen = torch.Generator().manual_seed(100 * e_per + 10 * m_act + d)
        bits = torch.randint(0, 2, (s, e_per, 4, d), generator=gen)[tx]
        gids = tx * e_per + torch.arange(e_per)
        local = min(max(m_act - tx * e_per, 0), e_per)
        for tag, b in (("random", bits), ("ones", torch.ones_like(bits)),
                       ("zeros", torch.zeros_like(bits))):
            votes = torch.where((gids < m_act)[:, None, None], 2 * b - 1, 0).sum(0)
            reduce_pair(f"aware-e{e_per}-m{m_act}-d{d}-{tag}", votes.to(torch.int8),
                        e_per=e_per, n_active=m_act, local_active=local)
        # erasures: slot 1 is dead; the fields stay sized for m_act voters
        live = (gids < m_act) & (gids != 1)
        votes = torch.where(live[:, None, None], 2 * bits - 1, 0).sum(0).to(torch.int8)
        total = sum(1 for j in range(s * e_per) if j < m_act and j != 1)
        reduce_pair(f"erased-e{e_per}-m{m_act}-d{d}", votes, e_per=e_per, n_active=m_act,
                    local_active=torch.tensor(int(live.sum())), total_active=total)
    # the lane's top field at its maximum: 4-bit fields, k = 8, bit 31 set
    votes = torch.ones((2, 64), dtype=torch.int8)
    lanes = collectives.all_reduce(collectives._pack_vote_fields(votes, 1, 4, 8), g)
    out["bit31-lanes"] = ((lanes < 0).numpy(), np.ones((2, 8), bool))
    out["bit31-tally"] = (collectives.packed_vote_allreduce(votes, g).numpy(),
                          np.full((2, 64), s, np.int32))
    # the index lists, shard-major
    idx = (tx * 100 + torch.arange(2)[:, None] * 10 + torch.arange(3)).to(torch.int32)
    want = (torch.arange(s)[:, None, None] * 100 + torch.arange(2)[:, None] * 10
            + torch.arange(3)).reshape(1, s * 2, 3)
    out["index_allgather"] = (collectives.sparse_index_allgather(idx[None], g).numpy(),
                              want.to(torch.int32).numpy())
    # the majority and the sign vote
    allbits = torch.randint(0, 2, (s, 16, 96), generator=torch.Generator().manual_seed(5),
                            dtype=torch.uint8)
    out["majority"] = (collectives.majority_allreduce(allbits[tx], g).numpy(),
                       hv.majority(allbits).numpy())
    noisy = collectives.majority_allreduce(allbits[tx], g,
                                           generator=torch.Generator().manual_seed(6), ber=0.2)
    want = collectives.ota_noise(torch.Generator().manual_seed(6), hv.majority(allbits), 0.2)
    out["majority-ber"] = (noisy.numpy(), want.numpy())
    x = torch.randn((s, 5, 33), generator=torch.Generator().manual_seed(7))
    x[:, 0, :3] = 0.0                                          # zero votes: sign 0
    want = torch.sign(torch.sign(x).sum(0))
    out["sign"] = (collectives.sign_allreduce(x[tx].bfloat16(), g).float().numpy(),
                   want.numpy())
    flips = collectives.sign_allreduce(x[tx], g, generator=torch.Generator().manual_seed(8),
                                       ber=0.3)
    again = collectives.sign_allreduce(torch.sign(x).sum(0), None,
                                       generator=torch.Generator().manual_seed(8), ber=0.3)
    out["sign-ber"] = (flips.numpy(), again.numpy())
    # the byte counter: operand + result bytes
    counts = []
    for fn in (lambda: collectives.all_reduce(torch.ones((7, 9), dtype=torch.int8), g),
               lambda: collectives.all_gather_last(torch.ones((5, 6), dtype=torch.int32), g),
               lambda: collectives.reduce_scatter_last(torch.ones((3, 8), dtype=torch.int32), g),
               lambda: collectives.all_reduce(torch.ones(4), None)):
        collectives.reset_wire_bytes()
        fn()
        counts.append(collectives.wire_bytes())
    out["wire-bytes"] = (np.array(counts), np.array([2 * 63, 120 + s * 120, 96 + 96 // s, 0]))
    # the world of S ranks as ("data", "model"): the closest factors, model the larger
    host = tmesh.make_host_mesh()
    out["host-mesh"] = (np.array(host.shape + (host.size,)),
                        np.array({2: (1, 2, 2), 4: (2, 2, 4), 8: (2, 4, 8)}[s]))
    return out
