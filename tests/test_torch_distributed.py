"""The port's collectives over `torch.distributed` (gloo ranks on the CPU)
and its 2x4 serve against the JAX reference's 8-device serve.

* The guard-bit field layout (`vote_field_spec`, the packing and unpacking
  of the vote fields) against JAX's on the same votes.
* On a model axis of 4 ranks: the packed all-reduce and reduce-scatter
  against the plain int32 reductions of the same votes, bit for bit
  (slot-blind and slot-aware fields, erased voters, the plain-scatter
  branch, a lane whose bit 31 is set), the index-list all-gather's order,
  the majority all-reduce against `hv.majority`, the sign vote, and the
  byte counter.
* On a (data, model) grid of 2x4 ranks, the serve of 256 classes over 8
  cores, d = 256, M = 3, B = 16 equals the reference's `make_ota_serve` on
  its 8-device mesh (run in a subprocess, as tests/test_distributed.py
  does) bit for bit: the four modes x psum, psum_packed and rs_ag, on the
  ideal channel and on JAX's own flip masks replayed by core, and the
  sparse, wired and training paths on ideal.
* The bytes each rank sends on EXPERIMENTS.md's 2x4 cell (C = 4096,
  d = 1024, M = 3, 8 cores, B = 128): 133,632 (psum), 55,296 (psum_packed)
  and 53,760 (rs_ag, packed).

Every world of ranks starts once for the module (`launch.mesh.spawn`, a
``file://`` store under pytest's temporary directory, a join timeout)."""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro.distributed import collectives as jcoll
from repro_torch.distributed import collectives as tcoll
from repro_torch.launch import mesh as tmesh

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
SMALL = dict(n_classes=256, dim=256, m_tx=3, n_rx_cores=8, batch=16)
MODES = [(False, "unpacked"), (False, "packed"), (True, "unpacked"), (True, "packed")]
CELL = dict(n_classes=4096, dim=1024, m_tx=3, n_rx_cores=8, batch=128, channel="ideal")
CELL_BYTES = {"psum-unpacked": 133_632, "psum-packed": 133_632,
              "psum_packed-packed": 55_296, "rs_ag-packed": 53_760}


# ---------------------------------------------------------------------------
# the field layout against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(4, 1, False, None), (16, 1, False, None),
                                  (16, 1, True, None), (1, 1, False, None),
                                  (8, 3, False, None), (16, 1, False, 3), (16, 1, True, 3),
                                  (4, 1, False, 3), (4, 2, False, 3), (16, 1, False, 16),
                                  (2, 5, True, None), (8, 2, True, 5), (4, 1, True, 3)])
def test_vote_field_spec_matches_jax(args):
    s, e_per, pow2, n_active = args
    assert tcoll.vote_field_spec(s, e_per, pow2, n_active) == \
        jcoll.vote_field_spec(s, e_per, pow2, n_active)


@pytest.mark.parametrize("s,e_per,d,n_active", [(4, 1, 512, None), (4, 1, 100, 3),
                                                (8, 3, 257, None), (16, 1, 96, 3),
                                                (2, 5, 64, None), (1, 2, 33, None)])
def test_vote_fields_pack_and_unpack_as_jax(s, e_per, d, n_active):
    """Every rank's lanes equal JAX's uint32 lanes bit for bit, and the
    unpacked sum of the ranks' lanes equals JAX's unpack of it. Slot-aware
    fields: the first ``n_active`` ranks hold one live voter each (bias 1),
    the others abstain (bias 0)."""
    fbits, k = tcoll.vote_field_spec(s, e_per, n_active=n_active)
    rng = np.random.default_rng(s * 100 + d)
    if n_active is None:
        bias, total = [e_per] * s, s * e_per
    else:
        bias, total = [int(r < n_active) for r in range(s)], n_active
    votes = np.stack([rng.integers(-b, b + 1, (3, d)) for b in bias]).astype(np.int8)
    lanes_j = np.stack([np.asarray(jcoll._pack_vote_fields(jnp.asarray(v), b, fbits, k))
                        for v, b in zip(votes, bias)])
    lanes_t = np.stack([tcoll._pack_vote_fields(torch.from_numpy(v), b, fbits, k).numpy()
                        for v, b in zip(votes, bias)])
    np.testing.assert_array_equal(lanes_t.view(np.uint32), lanes_j)
    summed = lanes_j.sum(0, dtype=np.uint32)
    want = np.asarray(jcoll._unpack_vote_fields(jnp.asarray(summed), d, total, fbits, k))
    got = tcoll._unpack_vote_fields(torch.from_numpy(summed.view(np.int32)), d, total, fbits, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, votes.astype(np.int32).sum(0))


# ---------------------------------------------------------------------------
# the collectives on a model axis of 4 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def axis4(tmp_path_factory):
    return tmesh.spawn(ranks.collective_cases, (1, 4), timeout=120,
                       store_dir=tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("name", ranks.collective_case_names(4))
def test_collective_equals_the_plain_reduction(axis4, name):
    for r, res in enumerate(axis4):
        got, want = res[name][:2]
        assert got.dtype == want.dtype or name.startswith(("bit31-lanes", "wire"))
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r} {name}")


def test_packed_wires_send_fewer_bytes_and_the_plain_scatter_int8(axis4):
    """At S = 4, e_per = 1 the slot-blind lanes (4-bit fields, k = 8) send a
    quarter of the int32 votes' bytes; d = 100 does not tile 8-field lanes
    over 4 ranks, so the scatter sends the int8 votes as they are."""
    res = axis4[0]
    assert res["allreduce-blind-e1-d512-random"][2] == 2 * 4 * 64 * 4
    assert res["scatter-blind-e1-d512-random"][2] == 4 * 64 * 4 + 4 * 16 * 4
    assert res["scatter-blind-e1-d100-random"][2] == 4 * 100 + 4 * 25
    assert res["allreduce-aware-e1-m3-d512-random"][2] == 2 * 4 * 52 * 4   # 3-bit, k = 10


# ---------------------------------------------------------------------------
# the 2x4 serve against the reference's 8-device serve
# ---------------------------------------------------------------------------

def _jax_cases():
    cases = [(f"ota-{rep}-{'perm' if perm else 'base'}-{coll}-{ch}",
              dict(permuted=perm, representation=rep, collective=coll, channel=ch))
             for perm, rep in MODES for coll in ("psum", "psum_packed", "rs_ag")
             for ch in ("ideal", "bsc")]
    return cases + [("sparse-index_ag", dict(representation="sparse", k_max=24,
                                             collective="index_ag", channel="ideal")),
                    ("wired-unpacked", dict(channel="ideal")),
                    ("wired-packed", dict(representation="packed", channel="ideal")),
                    ("train-unpacked", {}), ("train-packed", dict(representation="packed"))]


JAX_CASES = _jax_cases()

JAX_SCRIPT = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import phy
from repro.compat import make_mesh
from repro.core import hypervector as hv, scaleout, sparse
SMALL, CASES, out_path = {small!r}, {cases!r}, sys.argv[1]
mesh = make_mesh((2, 4), ("data", "model"))
protos = hv.random_hv(jax.random.PRNGKey(0), SMALL["n_classes"], SMALL["dim"])
protos_s = sparse.densify(sparse.random_sparse(jax.random.PRNGKey(3), SMALL["n_classes"],
                          SMALL["dim"], 24, 8.0 / SMALL["dim"]), SMALL["dim"])
ber = jnp.array([0.0, 0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.45], jnp.float32)
state = phy.state_from_ber(ber, 3)
key = jax.random.PRNGKey(2)
b_l = SMALL["batch"] // 2
masks = np.zeros((8, SMALL["batch"], SMALL["dim"]), np.uint8)
for r in range(2):                      # data row r: fold_in(key, r), core g: fold_in(., g)
    for g in range(8):
        k = jax.random.fold_in(jax.random.fold_in(key, r), g)
        masks[g, r * b_l:(r + 1) * b_l] = np.asarray(
            jax.random.bernoulli(k, ber[g], (b_l, SMALL["dim"])), np.uint8)
examples = jax.random.bernoulli(jax.random.PRNGKey(4), 0.5, (32, SMALL["dim"])).astype(jnp.uint8)
labels = jax.random.randint(jax.random.PRNGKey(5), (32,), 0, SMALL["n_classes"])
out = dict(protos_u=np.asarray(protos), protos_s=np.asarray(protos_s), masks=masks,
           ber=np.asarray(ber), examples=np.asarray(examples), labels=np.asarray(labels))
for name, kw in CASES:
    cfg = scaleout.ScaleOutConfig(**SMALL, **kw, use_kernels=False)
    book = protos_s if cfg.sparse else protos
    words = cfg.packed or cfg.sparse
    p = hv.pack(book) if words else book
    if name.startswith("train"):
        ex = hv.pack(examples) if cfg.packed else examples
        out[name + "/protos"] = np.asarray(scaleout.make_hdc_train(mesh, cfg)(ex, labels))
        continue
    _, q = scaleout.make_queries(jax.random.PRNGKey(1), cfg, book, 4)
    out[name + "/queries"] = np.asarray(q)
    build = scaleout.make_wired_serve if name.startswith("wired") else scaleout.make_ota_serve
    pred, sim = build(mesh, cfg)(p, q, state, key)
    out[name + "/pred"], out[name + "/sim"] = np.asarray(pred), np.asarray(sim)
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    """The reference's answers on its 8-device (2, 4) mesh, its inputs and
    its replayed flip masks, from a subprocess with 8 host devices."""
    path = tmp_path_factory.mktemp("jax8") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT).format(
        small=SMALL, cases=JAX_CASES), str(path)], capture_output=True, text=True,
        timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as z:
        return {k: (z[k].view(np.int32) if z[k].dtype == np.uint32 else z[k]) for k in z.files}


def _port_cases():
    cases = []
    for name, kw in JAX_CASES:
        kw = {**SMALL, **kw}
        if kw.get("channel") == "bsc":
            kw["channel"] = "bsc_replay"
        kind = name.split("-")[0] if name.startswith(("wired", "train")) else "ota"
        case = dict(name=name, kind=kind, cfg=kw)
        if kind != "train":
            case["queries"] = name + "/queries"
        if kw.get("representation") == "sparse":
            case["book"] = "protos_s"
        cases.append(case)
    cell = [dict(name=f"cell-{coll}-{rep}", book="protos_big",
                 cfg={**CELL, "collective": coll, "representation": rep})
            for coll, rep in (k.split("-") for k in CELL_BYTES)]
    return cases + cell


@pytest.fixture(scope="module")
def grid24(jax8, tmp_path_factory):
    inputs = dict(jax8, protos_big=np.random.default_rng(0).integers(
        0, 2, (CELL["n_classes"], CELL["dim"]), dtype=np.uint8))
    return tmesh.spawn(ranks.run, (2, 4), (inputs, _port_cases()), timeout=180,
                       store_dir=tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("name", [n for n, _ in JAX_CASES])
def test_2x4_serve_equals_the_reference_8_device_serve(jax8, grid24, name):
    keys = ("protos",) if name.startswith("train") else ("pred", "sim")
    for key in keys:
        np.testing.assert_array_equal(ranks.assemble(grid24, name, key), jax8[f"{name}/{key}"],
                                      err_msg=f"{name} {key}")


@pytest.mark.parametrize("cell", list(CELL_BYTES))
def test_wire_bytes_per_rank_on_the_2x4_cell(grid24, cell):
    """Operand + result bytes of every collective of one serve call, on
    every rank: the vote leg plus the 2,560-byte top-1 gather."""
    assert [r[f"cell-{cell}"]["bytes"] for r in grid24] == [CELL_BYTES[cell]] * 8
