"""What one rank of a sharded-training test world runs (imported by the
spawned rank processes, so it imports torch and the port only, never JAX).

`run(mesh, inputs, tmp)` trains every case on this rank and returns
{case: outputs}; with ``mesh=None`` the same code trains on one rank, which
is what the multi-rank answers are held to. ``inputs`` holds numpy arrays
and plain values: JAX's initial parameters and batches for the cases that
start from them (``jax_params/...``, ``jax_batches``), a signum batch
(``sign_batch``), and which cases this grid runs (``cases``).
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.convert import params_from_numpy
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import sharding
from repro_torch.models import get_model
from repro_torch.train.loop import Trainer, TrainerConfig, build_train_fns
from repro_torch.train.optimizer import OptConfig
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

CPU = "cpu"
DENSE = ("tinyllama_1_1b", "smollm_360m", "gemma3_1b", "deepseek_coder_33b")
ADAMW = dict(lr=1e-3, warmup=2, total_steps=10)
SIGN = dict(kind="sign_majority", lr=3e-4, warmup=5, total_steps=40)


def _np(x: torch.Tensor) -> np.ndarray:
    """A copy (the steps update the tensors in place)."""
    return x.detach().float().numpy().copy()


def _paths(tree) -> dict:
    return {"/".join(str(k) for k in p): v for p, v in tree_flatten(tree)}


def _fns(arch: str, mesh, opt: dict, **kw):
    model = get_model(configs.get_smoke(arch))
    return model, build_train_fns(model, OptConfig(**opt), mesh=mesh, device=CPU, **kw)


def _pipe(arch: str, seq: int, batch: int) -> SyntheticLM:
    return SyntheticLM(DataConfig(vocab=configs.get_smoke(arch).vocab, seq=seq,
                                  global_batch=batch), device=CPU)


def _whole(fns, params, opt_state):
    """The global (params, opt_state) as numpy by path."""
    tree = sharding.gather_tree((params, opt_state), fns.placements, fns.mesh)
    return {k: _np(v) for k, v in _paths(tree).items()}


def shard_shapes(mesh) -> dict:
    """Every leaf's local shape on this rank, per smoke config and mode."""
    out = {}
    for arch in DENSE:
        for kind, opt in (("adamw", ADAMW), ("sign_majority", SIGN)):
            _, fns = _fns(arch, mesh, opt)
            params, state = fns.init(0)
            out[(arch, kind)] = {
                "params": {k: tuple(v.shape) for k, v in _paths(params).items()},
                "opt": {k: tuple(v.shape) for k, v in _paths(state).items()}}
            out[(arch, kind)]["bytes"] = (
                sum(v.numel() * v.element_size() for v in tree_leaves((params, state))),
                sharding.local_bytes(fns.placements, (params, state), fns.mesh))
    return out


def _moments(whole: dict) -> dict:
    return {k: v for k, v in whole.items() if k.startswith("1/m/")}


def _params(whole: dict) -> dict:
    return {k: v for k, v in whole.items() if k.startswith("0/")}


def _pieces(fns, params) -> dict:
    """This rank's piece of every parameter leaf, keyed by (path, the
    piece's slices): ranks holding the same piece hold copies of it."""
    return {(k, str(z.slices(fns.mesh))): _np(x) for (k, x), z in
            zip(_paths(params).items(), tree_leaves(fns.placements[0]))}


def _tree(like, whole: dict):
    """The tree ``like`` holding ``whole``'s arrays (path -> numpy, as
    `_whole` gives them) at ``like``'s dtypes."""
    return tree_unflatten(like, [torch.tensor(whole[k], dtype=x.dtype)
                                 for k, x in _paths(like).items()])


def train_losses(mesh, arch: str, steps: int, opt=ADAMW, seq=64, batch=8, states=False,
                 one=None, **kw) -> dict:
    """``steps`` steps from seed 0 on the port's stream: each step's loss
    and gradient norm and, with ``states``, the global first moment after
    each step (``m``, rank 0 only: after step 1 it is 0.1 x the clipped
    gradient, leaf by leaf), the global parameters after the last step
    (rank 0 only) and, on one rank, the whole global state after each step
    but the last (``states``); on a mesh, this rank's piece of every
    parameter leaf after each step (``pieces``). ``one``, one rank's
    ``states``, adds ``same`` and ``carried`` (`_steps_from_one_rank`)."""
    _, fns = _fns(arch, mesh, opt, **kw)
    pipe = _pipe(arch, seq, batch)
    params, state = fns.init(0)
    out = dict(losses=[], gnorms=[], m=[], pieces=[], states=[])
    keep = states and (mesh is None or torch.distributed.get_rank() == 0)
    for s in range(steps):
        params, state, m = fns.step(params, state, pipe.batch(s), None)
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["gnorm"]))
        if states:
            whole = _whole(fns, params, state)
            if keep:
                out["m"].append(_moments(whole))
            if mesh is None and s < steps - 1:
                out["states"].append(whole)
            if mesh is not None:
                out["pieces"].append(_pieces(fns, params))
    if states and keep:
        out["params"] = _params(whole)
    if one is not None:
        out.update(_steps_from_one_rank(fns, arch, opt, one, pipe, keep, **kw))
    return out


def _steps_from_one_rank(fns, arch: str, opt, wholes: list, pipe, keep: bool, **kw) -> dict:
    """On ``fns``'s mesh, from ``wholes``, one rank's global state after
    each step s = 1 .. n - 1 (resharded with `sharding.shard_tree`):
    ``same``, step s + 1 from each, its loss, gradient norm and (rank 0
    only) first moment and parameters after it; ``carried`` (rank 0 only),
    the parameters after steps 2 .. n all taken on the mesh from one
    rank's state after step 1, the mesh carrying its own optimizer state
    from step to step."""
    like = _fns(arch, None, opt, **kw)[1].init(0)

    def sharded(whole):
        return sharding.shard_tree(_tree(like, whole), fns.placements, fns.mesh)

    same = []
    for s, whole in enumerate(wholes, start=1):
        p, st, m = fns.step(*sharded(whole), pipe.batch(s), None)
        after = _whole(fns, p, st)
        same.append(dict(loss=float(m["loss"]), gnorm=float(m["gnorm"]),
                         m=_moments(after) if keep else None,
                         params=_params(after) if keep else None))
    p, st = sharded(wholes[0])
    for s in range(1, len(wholes) + 1):
        p, st, _ = fns.step(p, st, pipe.batch(s), None)
    carried = _params(_whole(fns, p, st))
    return dict(same=same, carried=carried if keep else None)


def from_jax(mesh, inputs: dict, arch: str, steps: int) -> dict:
    """AdamW from JAX's initial parameters on JAX's batches."""
    _, fns = _fns(arch, mesh, ADAMW)
    params, state = fns.shard_params(params_from_numpy(inputs["jax_params"], CPU))
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(np.array(v)) for k, v in inputs["jax_batches"][s].items()}
        params, state, m = fns.step(params, state, batch, None)
        losses.append(float(m["loss"]))
    return dict(losses=losses)


def sign_from_jax(mesh, inputs: dict) -> dict:
    """One signum step at BER 0 from JAX's tinyllama parameters on JAX's
    batch: the global parameters after it."""
    _, fns = _fns("tinyllama_1_1b", mesh, SIGN)
    params = params_from_numpy(inputs["sign_params"], CPU)
    params, state = fns.shard_params(params)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in inputs["sign_batch"].items()}
    params, state, m = fns.step(params, state, batch, None)
    tree = sharding.gather_tree(params, fns.placements[0], fns.mesh)
    return dict(loss=float(m["loss"]), params={k: _np(v) for k, v in _paths(tree).items()})


def sign_converges(mesh) -> dict:
    """The reference's pin: signum at BER 0.01 on tinyllama smoke, seq 128,
    global batch 8, 20 steps."""
    _, fns = _fns("tinyllama_1_1b", mesh, SIGN, ota_ber=0.01)
    pipe = _pipe("tinyllama_1_1b", 128, 8)
    params, state = fns.init(0)
    from repro_torch.train.loop import step_generator
    losses = []
    for s in range(20):
        params, state, m = fns.step(params, state, pipe.batch(s),
                                    step_generator(0, s, CPU, fns.data_index))
        losses.append(float(m["loss"]))
    return dict(losses=losses)


def _tcfg(d: str, steps: int, every: int = 2) -> TrainerConfig:
    return TrainerConfig(steps=steps, ckpt_every=every, ckpt_dir=d, keep=3, log_every=100)


def checkpoint_write(mesh, tmp: str) -> dict:
    """Two AdamW steps on smollm smoke (its embed is cut over the data
    ranks) saved to ``tmp``/ckpt2x2: the global state the ranks held."""
    _, fns = _fns("smollm_360m", mesh, ADAMW)
    d = os.path.join(tmp, "ckpt2x2")
    params, state, _ = Trainer(fns, _pipe("smollm_360m", 64, 8), _tcfg(d, 2)).run(
        0, quiet=True)
    return dict(state=_whole(fns, params, state))


def checkpoint_resume(mesh, tmp: str, tag: str) -> dict:
    """Resume the 2x2 checkpoint on this layout for two more steps through
    the Trainer, and continue the same restored state in memory without
    it: both final states, which must agree bit for bit."""
    _, fns = _fns("smollm_360m", mesh, ADAMW)
    src, d = os.path.join(tmp, "ckpt2x2"), os.path.join(tmp, f"ckpt-{tag}")
    if mesh is None or torch.distributed.get_rank() == 0:
        shutil.copytree(src, d, dirs_exist_ok=True)
    if mesh is not None:
        torch.distributed.barrier()
    pipe = _pipe("smollm_360m", 64, 8)
    (params, state), extra = restore_checkpoint(src, 2, fns.abstract(), device=CPU,
                                                placements=fns.placements, mesh=fns.mesh)
    restored = _whole(fns, params, state)
    for s in range(int(extra["data_step"]), 4):
        params, state, _ = fns.step(params, state, pipe.batch(s), None)
    memory = _whole(fns, params, state)
    params, state, losses = Trainer(fns, pipe, _tcfg(d, 4)).run(0, quiet=True)
    return dict(restored=restored, memory=memory, trainer=_whole(fns, params, state),
                losses=losses)


def crash_resume(mesh, tmp: str, tag: str) -> dict:
    """A Trainer run killed at step 3 and resumed, against an uninterrupted
    one (AdamW on smollm smoke, checkpoints every 2 steps)."""
    _, fns = _fns("smollm_360m", mesh, ADAMW)
    pipe = _pipe("smollm_360m", 64, 8)
    d1, d2 = os.path.join(tmp, f"crash-{tag}"), os.path.join(tmp, f"whole-{tag}")
    try:
        Trainer(fns, pipe, _tcfg(d1, 5)).run(0, fail_at=3, quiet=True)
        crashed = False
    except RuntimeError as e:
        crashed = "injected failure at step 3" in str(e)
    p1, s1, resumed = Trainer(fns, pipe, _tcfg(d1, 5)).run(0, quiet=True)
    p2, s2, whole = Trainer(fns, pipe, _tcfg(d2, 5)).run(0, quiet=True)
    return dict(crashed=crashed, resumed=resumed, whole=whole,
                same=all(torch.equal(a, b) for a, b in zip(tree_leaves((p1, s1)),
                                                          tree_leaves((p2, s2)))))


def run(mesh, inputs: dict, tmp: str) -> dict:
    """Every case of ``inputs["cases"]`` on this rank."""
    from repro_torch.train.loop import _data_place
    coords = (0, 0) if mesh is None else (mesh.index("data"), mesh.index("model"))
    out = {"coords": coords, "data_index": _data_place(mesh)[0]}
    for case in inputs["cases"]:
        if case == "shapes":
            out[case] = shard_shapes(mesh)
        elif case == "losses":
            one = inputs.get("one_states", {})
            out[case] = {a: train_losses(mesh, a, 3, states=True, one=one.get(a))
                         for a in DENSE}
        elif case == "pin-adamw":
            out[case] = train_losses(mesh, "smollm_360m", 5)
        elif case == "pin-adamw-jax":
            out[case] = from_jax(mesh, inputs, "smollm_360m", 5)
        elif case == "pin-sign":
            out[case] = sign_converges(mesh)
        elif case == "sign-jax":
            out[case] = sign_from_jax(mesh, inputs)
        elif case == "ckpt-write":
            out[case] = checkpoint_write(mesh, tmp)
        elif case == "ckpt-resume":
            out[case] = checkpoint_resume(mesh, tmp, "x".join(map(str, mesh.shape))
                                          if mesh is not None else "1")
        elif case == "crash":
            out[case] = crash_resume(mesh, tmp, "x".join(map(str, mesh.shape))
                                     if mesh is not None else "1")
        else:
            raise ValueError(case)
    return out
