"""What one rank of the pod-mesh training test runs (imported by the
spawned rank processes, so it imports torch and the port only, never JAX).

`adamw_step(mesh, arch)` takes one AdamW step of the smoke config ``arch``
from the parameters drawn from seed 0, on a batch drawn from seed 1, and
returns the loss, the gradient norm, the global parameters and moments
after the step (gathered; numpy by path) and the wire bytes by axis; with
``mesh=None`` the same step on one rank. `adamw_steps` runs it for each
of several configs (one world of ranks for all)."""
from __future__ import annotations

import torch

from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import collectives, sharding
from repro_torch.models import get_model, init_params
from repro_torch.train.loop import build_train_fns
from repro_torch.train.optimizer import OptConfig
from repro_torch.tree import tree_flatten


def adamw_step(mesh, arch: str) -> dict:
    torch.set_num_threads(1)
    cfg = configs.get_smoke(arch)
    model = get_model(cfg)
    fns = build_train_fns(model, OptConfig(lr=1e-3, warmup=1, total_steps=10), mesh=mesh,
                          device="cpu")
    params, state = fns.shard_params(init_params(model.specs, torch.Generator().manual_seed(0),
                                                 "cpu"))
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=32, global_batch=8),
                        device="cpu").batch(1)
    collectives.reset_wire_bytes()
    params, state, m = fns.step(params, state, batch)
    wire = collectives.wire_bytes_by_axis()
    whole = sharding.gather_tree((params, state), fns.placements, fns.mesh)
    return dict(loss=float(m["loss"]), gnorm=float(m["gnorm"]), wire=wire,
                leaves={"/".join(str(k) for k in p): v.detach().float().numpy().copy()
                        for p, v in tree_flatten(whole)})


def adamw_steps(mesh, archs: tuple) -> dict:
    return {arch: adamw_step(mesh, arch) for arch in archs}
