"""What one rank of the sharded-inference worlds runs (imported by the
spawned rank processes, so it imports torch and the port only, never JAX).

`run(mesh, inputs)` prefills every smoke config of ``inputs["runs"]`` (f32,
the parameters and batches ``inputs`` holds as numpy) on this rank through
`train.loop.build_infer_fns`, then decodes the run's next tokens one step
at a time, and reports the logits gathered whole (every row, every
vocabulary entry) and its pieces of the cache after the prefill and after
the last step, with the slices of the global cache they are; and, where
``inputs["cases"]`` asks, the merged decode attention over slots cut across
the model ranks, an MoE decode group straddling the data ranks, and the
refusal of per-row positions. With ``mesh=None`` the same code runs on one
rank, which is what the ranks are held to.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import collectives
from repro_torch.models import abstract_params, get_model, layers, moe
from repro_torch.train.loop import build_infer_fns
from repro_torch.tree import tree_flatten, tree_map

CPU = "cpu"


def _whole_rows(t: torch.Tensor, mesh, b: int) -> torch.Tensor:
    """A rank's rows of a global batch of b rows, gathered over the data
    ranks they are cut over."""
    if mesh is None or t.shape[0] == b:
        return t
    return collectives.all_gather_dim(t, 0, mesh.group("data"))


def infer(mesh, run: dict, params: dict) -> dict:
    """Prefill ``run["batch"]`` at ``run["pad_to"]`` capacity, then decode
    ``run["next"]`` [B, steps] from position ``run["start"]``: every step's
    logits [B, V] (numpy) and the cache pieces after the prefill and after
    the last step."""
    model = get_model(configs.get_smoke(run["arch"]))
    fns = build_infer_fns(model, mesh=mesh, device=CPU)
    p = fns.shard_params(params_from_numpy(params, CPU))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in run["batch"].items()}
    b = batch["tokens"].shape[0]
    lg, cache = fns.prefill(p, batch, run["pad_to"])
    plc = fns.cache_placements(b, run["pad_to"])
    slices = {"/".join(path): [(s.start, s.stop) for s in pl.slices(fns.mesh)]
              if fns.mesh is not None else None for path, pl in tree_flatten(plc)}

    def pieces():
        return {"/".join(path): x.numpy().copy() for path, x in tree_flatten(cache)}

    out = dict(logits=[_whole_rows(fns.gather_logits(lg), mesh, b).numpy()],
               prefill_cache=pieces(), slices=slices)
    nxt = torch.from_numpy(np.array(run["next"]))
    for i in range(nxt.shape[1]):
        lg, cache = fns.decode(p, cache, nxt[:, i], run["start"] + i)
        out["logits"].append(_whole_rows(fns.gather_logits(lg), mesh, b).numpy())
    out["cache"] = pieces()
    return out


def merged_attention(mesh) -> dict:
    """`layers.decode_attention` over a 32-slot cache cut in two halves over
    the model ranks, against the whole cache on this rank: (a) every slot
    of rank 0 empty, (b) no slot visible anywhere (the position before
    every slot's), (c) a window that leaves rank 1's slots out."""
    g = torch.Generator().manual_seed(5)
    b, sc, h, kh, d = 3, 32, 4, 2, 16
    q = torch.randn(b, 1, h, d, generator=g)
    k = torch.randn(b, sc, kh, d, generator=g)
    v = torch.randn(b, sc, kh, d, generator=g)
    m, r = mesh.axis_size("model"), mesh.index("model")
    n = sc // m
    cases = {"rank 0 empty": (torch.cat([torch.full((n,), -1), torch.arange(n, sc)]), sc, -1),
             "none visible": (torch.arange(10, 10 + sc), 5, -1),
             "window": (torch.arange(sc), 10, 8)}
    out = {}
    for name, (slot_pos, cur, window) in cases.items():
        slot_pos = slot_pos.to(torch.int32)
        whole = layers.decode_attention(q, k, v, slot_pos, cur, window=window)
        cut = layers.decode_attention(q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n],
                                      slot_pos, cur, window=window,
                                      group=mesh.group("model"), slot_base=r * n)
        out[name] = (cut.numpy(), whole.numpy())
    return out


def straddling_moe(seed: int = 3):
    """The mixtral smoke config's MoE block (f32, capacity_factor 0.5, one
    group of 16 decode tokens) and 16 tokens [16, 1, d] leaning to expert 0,
    so its 4-slot capacity drops assignments."""
    cfg = configs.get_smoke("mixtral_8x22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, group_size=16,
                                                           capacity_factor=0.5))
    g = torch.Generator().manual_seed(seed)
    p = {k: torch.randn(s.shape, generator=g) / s.shape[-2] ** 0.5
         for k, s in moe.moe_specs(cfg, layers=0).items()}
    x = torch.randn(16, 1, cfg.d_model, generator=g)
    x += 2.0 * (p["router"].T / p["router"].norm(dim=0)[:, None])[0]
    return cfg, p, x


def moe_straddle(mesh) -> dict:
    """`straddling_moe`'s block on this data rank's 8 of the 16 tokens, one
    dispatch group spanning both data ranks, at inference."""
    cfg, p, x = straddling_moe()
    i, n = mesh.index("data"), mesh.axis_size("data")
    rows = x.shape[0] // n
    tp = collectives.TensorParallel(None, 0, (mesh.group("data"),), i, True)
    out, _ = moe.apply(p, cfg, x[i * rows:(i + 1) * rows], tp)
    return dict(out=out.numpy(), rows=(i * rows, (i + 1) * rows))


def per_row_refusal(mesh) -> str:
    """A decode on ranks at per-row positions: the refusal's message."""
    cfg = configs.get_smoke("tinyllama_1_1b")
    model = get_model(cfg)
    fns = build_infer_fns(model, mesh=mesh, device=CPU)
    p = fns.shard_params(tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                                  abstract_params(model.specs)))
    cache = fns.init_cache(2, 8)
    try:
        fns.decode(p, cache, torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    except ValueError as e:
        return str(e)
    return ""


def run(mesh, inputs: dict) -> dict:
    """Every run of ``inputs["runs"]`` and every case of ``inputs["cases"]``
    on this rank."""
    coords = (0, 0) if mesh is None else (mesh.index("data"), mesh.index("model"))
    out = {"coords": coords}
    for name, run_ in inputs["runs"].items():
        out[name] = infer(mesh, run_, inputs["params"][run_["arch"]])
    for case in inputs.get("cases", ()):
        out[case] = {"attention": merged_attention, "moe": moe_straddle,
                     "per_row": per_row_refusal}[case](mesh)
    return out
