"""Starting the ranks of a mesh (counterpart of `repro/launch/mesh.py`).

`spawn` starts the ranks of a mesh as processes, each initialized through a
``file://`` store, builds each rank's `distributed.mesh.RankMesh`, runs a
function on every rank and returns what each rank returned.
`make_host_mesh` lays the initialized world out as ("data", "model").

The production meshes (`make_production_mesh`): (16, 16) over ("data",
"model") and (2, 16, 16) over ("pod", "data", "model"), the reference's
layouts (`repro/launch/mesh.py`). No host holds 256 or 512 cards: the dry
run (`launch.dryrun`) builds them from one rank's view over a fake world
(`fake_world`), a default process group of the "fake" backend, in which
every collective returns at once and sends nothing, so that one process
traces a rank's step with its real groups and its real wire counts.
"""
from __future__ import annotations

import contextlib
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import RankMesh, make_mesh

AXES = ("pod", "data", "model")          # a mesh's axes, outermost first


def host_mesh_shape(n: int) -> tuple[int, int]:
    """(data, model) for ``n`` ranks: the model axis takes the larger of the
    two closest factors of ``n``."""
    d = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    return d, n // d


def make_host_mesh() -> RankMesh:
    """The world as ("data", "model") of `host_mesh_shape` (1 rank without a
    process group)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(host_mesh_shape(n), ("data", "model"))


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A default process group of ``world`` ranks of the "fake" backend
    (``torch.testing``'s fake process group), this process being ``rank``:
    every collective on it returns at once and moves nothing. Destroyed on
    leaving the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(multi_pod: bool = False) -> RankMesh:
    """This rank's production mesh: (16, 16) ("data", "model"), or with
    ``multi_pod`` (2, 16, 16) ("pod", "data", "model"); over the initialized
    world of 256 or 512 ranks (a `fake_world` on one host)."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes)


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, shape, backend, init, threads, results, args):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=init, world_size=math.prod(shape),
                                rank=rank)
        out = fn(make_mesh(shape, AXES[-len(shape):]), *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, shape: Sequence[int], args: tuple = (), *, backend: str = "gloo",
          timeout: float = 300.0, store_dir: str | os.PathLike | None = None,
          threads: int | None = 1) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a mesh of ``shape`` (the
    last of ``AXES`` its axes: ("data", "model") for a grid) and return the
    ranks' results in rank order.

    Each rank is a process started with `torch.multiprocessing` ("spawn"),
    joined to a process group of ``backend`` through a ``file://`` store in
    ``store_dir`` (a temporary directory by default, removed afterwards), with its
    `RankMesh` built by `make_mesh`. ``fn`` and ``args`` must pickle and
    ``fn``'s results must too. ``threads`` sets each rank's CPU threads
    (None leaves torch's default). Ranks that launch kernels load the
    library the caller built (`kernels._build.build`) before the call;
    otherwise each rank would run the compiler.

    Raises RuntimeError with the rank's traceback as soon as a rank fails,
    and TimeoutError when the ranks have not all returned within
    ``timeout`` seconds; either way every rank still running is
    terminated. No rank outlives the call."""
    import torch.multiprocessing as mp

    shape = tuple(shape)
    if not 1 <= len(shape) <= len(AXES):
        raise ValueError(f"mesh shape {shape} has no axes of {AXES}")
    world = math.prod(shape)
    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="ranks-") if own else str(store_dir)
    store = os.path.join(store_dir, f"store-{os.getpid()}-{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, shape, backend, f"file://{store}", threads, results,
                               tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got: dict[int, object] = {}
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} of mesh "
                                   f"{shape} did not return within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of mesh {shape} died with exit code "
                                       f"{procs[dead[0]].exitcode}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of mesh {shape} failed:\n{out}")
            got[rank] = out
        for r, p in enumerate(procs):
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                raise TimeoutError(f"rank {r} of mesh {shape} returned but did not exit")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [got[r] for r in range(world)]
