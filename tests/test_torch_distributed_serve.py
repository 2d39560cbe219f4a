"""The port's multi-rank serve (gloo ranks on the CPU) against its one-rank
serve: 256 classes over 8 cores, d = 256, M = 3, B = 16 on (data, model)
grids of 1x2, 1x4 and 2x2 ranks.

Each grid's ranks start once for the module (`launch.mesh.spawn`, a
``file://`` store under pytest's temporary directory, a join timeout) and
serve every case on their shards; the one-rank answers come from the same
code with no mesh. Predictions, maxsim and learned prototypes must be equal
bit for bit: the four modes (unpacked or packed x baseline or permuted)
with psum, psum_packed and rs_ag, on the ideal channel and on flip masks
replayed by core (the port's ranks draw their noise from their own
generators, so a replayed draw is what makes the noisy serves comparable);
the symbol tier on replayed draws, the sparse serve (index_ag and the dense
psum_packed wire), the coarse packed screen, the multi-tenant serve, the
wired serve and the one-shot training. With real noise (bsc dense and
sparse, the bitplane masks, the symbol tier) on one generator seed the
serve is mesh-layout invariant: every model rank draws over the global
cores and keeps its own, so 1x2 and 1x4 equal one rank bit for bit, and
each data row of 2x2 equals a one-rank serve of its rows."""
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro_torch.core import scaleout as tscale, sparse as tsparse
from repro_torch.launch import mesh as tmesh

SMALL = dict(n_classes=256, dim=256, m_tx=3, n_rx_cores=8, batch=16)
MODES = [(False, "unpacked"), (False, "packed"), (True, "unpacked"), (True, "packed")]
GRIDS = [(1, 2), (1, 4), (2, 2)]


def _case(name, **kw):
    kind = kw.pop("kind", "ota")
    extra = {k: kw.pop(k) for k in ("rows", "book", "state") if k in kw}
    return dict(name=name, kind=kind, cfg={**SMALL, **kw}, **extra)


CASES = (
    [_case(f"ota-{rep}-{'perm' if perm else 'base'}-{coll}-{ch}", permuted=perm,
           representation=rep, collective=coll, channel=ch)
     for perm, rep in MODES for coll in ("psum", "psum_packed", "rs_ag")
     for ch in ("ideal", "bsc_replay")]
    + [_case("symbol-unpacked-base", channel="symbol_replay"),
       _case("symbol-packed-perm", channel="symbol_replay", representation="packed",
             permuted=True),
       _case("sparse-index_ag", representation="sparse", k_max=24, collective="index_ag",
             channel="ideal", book="protos_s"),
       _case("sparse-psum_packed", representation="sparse", k_max=24,
             collective="psum_packed", channel="ideal", book="protos_s"),
       _case("coarse-packed", representation="packed", collective="psum_packed",
             channel="bsc_replay", coarse_group=4, coarse_keep=2),
       _case("mt-packed-base-psum_packed", kind="mt", representation="packed",
             collective="psum_packed", channel="bsc_replay", rows=[1, 0, 1]),
       _case("mt-unpacked-perm-rs_ag", kind="mt", permuted=True, collective="rs_ag",
             channel="bsc_replay", rows=[0, 1]),
       _case("wired-unpacked", kind="wired", channel="ideal"),
       _case("wired-packed", kind="wired", representation="packed", channel="ideal"),
       _case("train-unpacked", kind="train"),
       _case("train-packed", kind="train", representation="packed")])

# Real noise on one generator seed: every model rank draws over the global
# cores and keeps its own, so on 1xS these equal the one-rank serve bit for
# bit, and on 2x2 each data row equals a one-rank serve of its rows.
REAL = [_case("real-bsc-unpacked-base", channel="bsc", state="hot"),
        _case("real-bsc-packed-perm", channel="bsc", representation="packed", permuted=True,
              state="hot"),
        _case("real-bsc-packed-bitplane", channel="bsc", representation="packed",
              collective="psum_packed", noise="bitplane", state="hot"),
        _case("real-symbol-unpacked-base", channel="symbol"),
        _case("real-symbol-packed-perm", channel="symbol", representation="packed",
              permuted=True),
        _case("real-sparse-bsc", representation="sparse", k_max=24, collective="index_ag",
              channel="bsc", book="protos_s", state="hot")]
CASES = CASES + REAL


@pytest.fixture(scope="module")
def inputs():
    """Every rank's global inputs, made from a seed with numpy."""
    rng = np.random.default_rng(0)
    n, b, d = SMALL["n_rx_cores"], SMALL["batch"], SMALL["dim"]
    ber = np.array([0.0, 0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.45], np.float32)
    state = tscale.precharacterize_state(tscale.ScaleOutConfig(**SMALL), device="cpu")
    sparse_book = tsparse.densify(tsparse.random_sparse(
        torch.Generator().manual_seed(3), SMALL["n_classes"], d, 24, 8.0 / d, device="cpu"), d)
    out = dict(
        protos_u=rng.integers(0, 2, (SMALL["n_classes"], d), dtype=np.uint8),
        protos2_u=rng.integers(0, 2, (SMALL["n_classes"], d), dtype=np.uint8),
        protos_s=sparse_book.numpy(), ber=ber,
        masks=(rng.random((n, b, d)) < ber[:, None, None]).astype(np.uint8),
        nr=rng.standard_normal((n, b, d), dtype=np.float32),
        ni=rng.standard_normal((n, b, d), dtype=np.float32),
        flips=rng.random((n, b, d)) < 0.05,
        examples=rng.integers(0, 2, (32, d), dtype=np.uint8),
        labels=rng.integers(0, SMALL["n_classes"], 32))
    out.update({f"state_{f}": getattr(state, f).numpy() for f in state.FIELDS})
    return out


@pytest.fixture(scope="module")
def reference(inputs):
    return ranks.run(None, inputs, CASES)


@pytest.fixture(scope="module")
def row_reference(inputs):
    """The real-noise cases served on one rank for each half of the batch
    (the 2x2 grid's data rows), on the generator every rank uses."""
    half = SMALL["batch"] // 2
    return [ranks.run(None, inputs, [dict(c, batch_rows=(i * half, (i + 1) * half))
                                     for c in REAL]) for i in range(2)]


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """grid -> every rank's results, each grid's ranks started once."""
    cache = {}

    def get(grid):
        if grid not in cache:
            try:
                cache[grid] = tmesh.spawn(ranks.run, grid, (inputs, CASES), timeout=120,
                                          store_dir=tmp_path_factory.mktemp("ranks"))
            except (RuntimeError, TimeoutError) as e:
                cache[grid] = e
        if isinstance(cache[grid], Exception):
            raise cache[grid]
        return cache[grid]

    return get


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_multi_rank_serve_equals_one_rank(worlds, reference, row_reference, grid, name):
    results = worlds(grid)
    if name.startswith("real") and grid[0] > 1:
        # each data row draws its rows' noise: a one-rank serve of those rows
        for key in ("pred", "sim"):
            got = ranks.assemble(results, name, key)
            want = np.concatenate([r[name][key] for r in row_reference])
            np.testing.assert_array_equal(got, want, err_msg=f"{grid} {name} {key}")
        return
    keys = ("protos",) if name.startswith("train") else ("pred", "sim")
    for key in keys:
        np.testing.assert_array_equal(ranks.assemble(results, name, key),
                                      reference[name][key], err_msg=f"{grid} {name} {key}")
    if not name.startswith("train"):
        assert all(r[name]["bytes"] > 0 for r in results) and reference[name]["bytes"] == 0


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_process_faults_engines_and_trainer_refuse_ranks(worlds, grid):
    """On a mesh of more than one rank the LM engines raise
    NotImplementedError naming ROADMAP.md §1 (process=, faults= and the HDC
    engines run on ranks: tests/test_torch_distributed_living.py); the
    trainer no longer refuses (sharded training:
    tests/test_torch_distributed_train.py)."""
    for r in worlds(grid):
        assert r["refusals"] == dict(engine=True, continuous=True, trainer="ran")
