"""The plain reference against the port on the CPU: the same channel, the same
answers bit for bit, a perturbed answer caught, and the control (the noise
one precision lower) failing the comparison."""
from __future__ import annotations

import time

import pytest
import torch

import bench_tiny
from bench_tiny import SEED, SMALL, WORKLOADS, harness
from bench.reference import hdc_ota


@pytest.mark.parametrize("cores", [8, 64])
def test_core_ber_is_the_ports(cores):
    from repro_torch.core import scaleout

    cfg = scaleout.ScaleOutConfig(n_classes=cores * 10, n_rx_cores=cores)
    ours = hdc_ota.core_ber(3, cores, 7.0, "cpu")
    assert torch.equal(ours, scaleout.precharacterize_state(cfg, device="cpu").ber)


def test_unpack_and_bundle():
    words = torch.tensor([[1, -2 ** 31]], dtype=torch.int32)
    bits = hdc_ota.unpack(words, 64)[0]
    assert bits[0] == 1 and bits[63] == 1 and bits.sum() == 2
    q = torch.tensor([[[1, 0, 1, 0], [1, 1, 0, 0], [0, 1, 1, 0]]], dtype=torch.uint8)
    assert hdc_ota.bundle(q).tolist() == [[1, 1, 1, 0]]


def test_top1_ties_go_to_the_lowest_class():
    book = torch.zeros((4, 8), dtype=torch.uint8)          # 4 classes, 2 cores, all equal
    copies = torch.zeros((2, 3, 8), dtype=torch.uint8)
    pred, sim = hdc_ota.top1(lambda lo, hi: copies[lo:hi], book, 2, 3, block=1)
    assert pred.tolist() == [0, 0, 0] and sim.tolist() == [8, 8, 8]
    book[2:] = 1                                           # core 1 holds classes 2 and 3
    copies[1] = 1                                          # core 1 sees all ones
    pred, sim = hdc_ota.top1(lambda lo, hi: copies[lo:hi], book, 2, 3, block=2)
    assert pred.tolist() == [0, 0, 0] and sim.tolist() == [8, 8, 8]   # 0 and 2 tie
    copies[0] = 1
    pred, sim = hdc_ota.top1(lambda lo, hi: copies[lo:hi], book, 2, 3, block=1)
    assert pred.tolist() == [2, 2, 2] and sim.tolist() == [8, 8, 8]


def _loop(workload: str, sizes: dict):
    p = bench_tiny.plan(workload, sizes, check_requests=8)
    system = harness.load("systems", p["config"]["system"]).build(
        p["config"], p["traffic"], SEED, "cpu", None)
    loop = harness.load("loops", p["traffic"]["loop"]).run(system, p["traffic"], 0.3, {})
    system.release()
    return p, system, loop


@pytest.mark.parametrize("workload", WORKLOADS)
def test_answers_equal_and_a_perturbed_one_is_caught(workload):
    p, system, loop = _loop(workload, bench_tiny.TINY)
    limits = p["config"]["limits"]
    sound = harness.judge(system, loop, SEED, 8, limits)
    assert all(c["value"] == 0 for c in sound.values())
    for d in loop.done + loop.later:
        d.pred = d.pred.copy()
        d.pred[0] = (d.pred[0] + 1) % p["config"]["n_classes"]
    bad = harness.judge(system, loop, SEED, 8, limits)
    assert bad["pred_mismatch"]["value"] == 8 and bad["maxsim_mismatch"]["value"] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails(workload):
    p, system, loop = _loop(workload, SMALL)
    t0 = time.perf_counter()
    numbers = harness.judge(system, loop, SEED, 8, p["config"]["limits"], control=True)
    assert numbers["maxsim_mismatch"]["value"] > numbers["maxsim_mismatch"]["limit"]
    assert time.perf_counter() - t0 < 30


def test_bitplane_lower_keeps_the_top_planes():
    g = torch.Generator().manual_seed(3)
    words = torch.randint(-2 ** 31, 2 ** 31, (4, 2, 3, 1), generator=g, dtype=torch.int32)
    ber = torch.tensor([0.3, 0.6])
    full = hdc_ota.flips_bitplane(words, ber, 4, lower=False)
    low = hdc_ota.flips_bitplane(words, ber, 4, lower=True)
    bits = hdc_ota.unpack(words, 32).to(torch.int32)                  # [4, 2, 3, 32]
    u = sum(bits[i] << i for i in range(4))
    assert torch.equal(full, u < torch.round(ber * 16).to(torch.int32)[:, None, None])
    assert torch.equal(low, (u >> 2) < torch.round(ber * 4).to(torch.int32)[:, None, None])
    assert not torch.equal(full, low)
