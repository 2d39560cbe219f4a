"""What one rank of the non-dense sharded-training worlds runs (imported by
the spawned rank processes, so it imports torch and the port only, never
JAX).

`run(mesh, inputs)` trains every non-dense smoke config (f32) for three
AdamW steps on this rank from the initial parameters and on the batches
``inputs`` holds (numpy: JAX's initial parameters, JAX's token batches
with numpy frames or patch embeddings and M-RoPE positions), and, where
``inputs["cases"]`` asks, checks the MoE block's aux over the data ranks
and its refusal of dispatch groups that straddle two data ranks. With
``mesh=None`` the same code trains on one rank, which is what the ranks
are held to.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import collectives
from repro_torch.models import get_model, moe
from repro_torch.train.loop import build_train_fns
from repro_torch.train.optimizer import OptConfig

CPU = "cpu"
NONDENSE = ("mixtral_8x22b", "kimi_k2", "falcon_mamba_7b", "zamba2_2_7b", "whisper_tiny",
            "qwen2_vl_7b")
ADAMW = dict(lr=1e-3, warmup=2, total_steps=10)
STEPS = 3


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def train(mesh, arch: str, params: dict, batches: list) -> dict:
    """Three AdamW steps from ``params`` on ``batches``: each step's loss,
    gradient norm and aux as every rank reports them."""
    model = get_model(configs.get_smoke(arch))
    fns = build_train_fns(model, OptConfig(**ADAMW), mesh=mesh, device=CPU)
    p, st = fns.shard_params(params_from_numpy(params, CPU))
    out = dict(losses=[], gnorms=[], aux=[])
    for b in batches[:STEPS]:
        p, st, m = fns.step(p, st, _batch(b), None)
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["gnorm"]))
        out["aux"].append(float(m["aux"]))
    return out


def unbalanced_moe(seed: int = 0):
    """The kimi smoke config's MoE block (f32) and an input [4, 32, d] whose
    halves route apart: rows 0-1 lean to expert 0, rows 2-3 to expert 1
    (128 tokens in groups of 64, one data rank's two rows a group)."""
    cfg = configs.get_smoke("kimi_k2")
    g = torch.Generator().manual_seed(seed)
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
    p = {"router": torch.randn(d, e, generator=g) / d**0.5,
         "wg": torch.randn(e, d, f, generator=g) / d**0.5,
         "wu": torch.randn(e, d, f, generator=g) / d**0.5,
         "wd": torch.randn(e, f, d, generator=g) / f**0.5,
         "shared": {"wg": torch.randn(d, f, generator=g) / d**0.5,
                    "wu": torch.randn(d, f, generator=g) / d**0.5,
                    "wd": torch.randn(f, d, generator=g) / f**0.5}}
    x = torch.randn(4, 32, d, generator=g)
    lean = p["router"].T / p["router"].norm(dim=0)[:, None]            # [E, d]
    x[:2] += 4.0 * lean[0]
    x[2:] += 4.0 * lean[1]
    return cfg, p, x


def aux_and_grads(p: dict, cfg, x: torch.Tensor, tp=None):
    """(out, aux, d aux / d router, d out.sum() / d x) of the MoE block on
    x; on ranks the router gradient is this data rank's share."""
    router = p["router"].clone().requires_grad_()
    xr = x.clone().requires_grad_()
    out, aux = moe.apply(dict(p, router=router), cfg, xr, tp)
    (g_router,) = torch.autograd.grad(aux, router, retain_graph=True)
    (g_x,) = torch.autograd.grad(out.sum(), xr)
    return out.detach(), aux.detach(), g_router, g_x


def aux_on_ranks(mesh) -> dict:
    """The MoE block on this data rank's half of `unbalanced_moe`'s input:
    its output rows, the aux summed over the data ranks, the router's
    gradient summed over them, and the mean of each rank's aux taken over
    its own tokens alone (what a per-rank aux would give)."""
    cfg, p, x = unbalanced_moe()
    group = mesh.group("data")
    i, n = mesh.index("data"), mesh.axis_size("data")
    rows = x.shape[0] // n
    tp = collectives.TensorParallel(None, 0, (group,))
    out, aux, g_router, _ = aux_and_grads(p, cfg, x[i * rows:(i + 1) * rows], tp)
    _, own, _, _ = aux_and_grads(p, cfg, x[i * rows:(i + 1) * rows])
    return dict(out=out.numpy(), aux=float(collectives.all_reduce(aux, group)),
                g_router=collectives.all_reduce(g_router, group).numpy(),
                per_rank=float(collectives.all_reduce(own, group)) / n)


def straddle(mesh) -> str:
    """B 2 x S 60 over two data ranks at group_size 40: the global 120
    tokens route in groups of 40, which a rank's 60 tokens cannot hold;
    the refusal's message."""
    cfg = configs.get_smoke("mixtral_8x22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, group_size=40))
    p = {k: torch.zeros(s.shape) for k, s in moe.moe_specs(cfg, layers=0).items()}
    tp = collectives.TensorParallel(None, 0, (mesh.group("data"),))
    try:
        moe.apply(p, cfg, torch.zeros(1, 60, cfg.d_model), tp)
    except ValueError as e:
        return str(e)
    return ""


def run(mesh, inputs: dict) -> dict:
    """Every case of ``inputs["cases"]`` on this rank."""
    coords = (0, 0) if mesh is None else (mesh.index("data"), mesh.index("model"))
    out = {"coords": coords}
    for case in inputs["cases"]:
        if case == "train":
            out[case] = {a: train(mesh, a, inputs["params"][a], inputs["batches"][a])
                         for a in NONDENSE}
        elif case == "aux":
            out[case] = aux_on_ranks(mesh)
        elif case == "straddle":
            out[case] = straddle(mesh)
        else:
            raise ValueError(case)
    return out
