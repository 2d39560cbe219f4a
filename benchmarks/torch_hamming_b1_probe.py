#!/usr/bin/env python3
"""Rates of the 1-bit tensor-core products on one H100, and the two
tensor-core routes of the packed Hamming search at the recall oracle.

    python3 benchmarks/torch_hamming_b1_probe.py [--json out.json]

Builds ``benchmarks/torch_hamming_b1_probe.cu`` with nvcc into
``build/b1_probe/`` and prints ``mma.sync m16n8k256 .b1 .and.popc``'s rate
on registers alone and ``wgmma m64n128k256 .b1 .and.popc``'s on tiles in
shared memory (TOP/s, 2 * M * N * K a product: the int8 peak's count).
NVIDIA publishes no 1-bit peak; ``chip_smoke.py`` bounds the Hamming
kernels by the higher rate (``B1_OPS_PER_S``). Then, at the recall oracle's shape
(G 8, B 512, C 12,800, W 64), times with CUDA events, in turns: the port's
``hamming_search_banked`` (the 1-bit route), the int8 wgmma route's product
as the port runs it (``assoc_matmul_banked`` on the {0,1} byte expansions:
the same G*B*C*32W products with the bits already expanded, so a floor for
that route), and one bf16 ``torch.bmm`` on the +-1 expansions. Needs a CUDA
device; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SRC = Path(__file__).with_suffix(".cu")
OUT = ROOT / "build" / "b1_probe"


def build() -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
                                       / "bin" / "nvcc")
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libb1probe.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                    "-Xcompiler", "-fPIC", "-shared", str(SRC), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.b1_peak_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dll.b1_wgmma_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return dll


def events_ms(torch, fn, reps: int = 20, samples: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(samples):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b1 probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels as tk
    from repro_torch.core import hypervector as hv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dll = build()

    # the rate on registers: 4 blocks of 8 warps an SM, 8 products a loop
    blocks, threads, iters = torch.cuda.get_device_properties(0).multi_processor_count * 4, 256, 4096
    sink = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")

    def peak_launch():
        err = dll.b1_peak_launch(sink.data_ptr(), blocks, threads, iters,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")

    peak_ms = events_ms(torch, peak_launch, reps=3)
    peak = blocks * threads // 32 * iters * 8 * 2 * 16 * 8 * 256 / (peak_ms * 1e-3)
    print(f"b1 m16n8k256 rate on registers: {peak / 1e12:.1f} TOP/s ({peak_ms:.4f} ms)",
          flush=True)

    # the warpgroup rate from shared memory: 8 one-warpgroup blocks an SM
    wblocks, witers = torch.cuda.get_device_properties(0).multi_processor_count * 8, 2000
    wsink = torch.empty(wblocks * 128, dtype=torch.int32, device="cuda")

    def wgmma_launch():
        err = dll.b1_wgmma_launch(wsink.data_ptr(), wblocks, witers,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")

    wgmma_ms = events_ms(torch, wgmma_launch, reps=3)
    wgmma = wblocks * witers * 4 * 2 * 64 * 128 * 256 / (wgmma_ms * 1e-3)
    print(f"b1 wgmma m64n128k256 rate from shared memory: {wgmma / 1e12:.1f} TOP/s "
          f"({wgmma_ms:.4f} ms)", flush=True)

    g, b, c, w = 8, 512, 12800, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, p = (torch.randint(-2**31, 2**31 - 1, (g, n, w), generator=gen, device="cuda",
                          dtype=torch.int32) for n in (b, c))
    q01, p01 = hv.unpack(q, 32 * w), hv.unpack(p, 32 * w)
    qb = (1 - 2 * q01.to(torch.bfloat16)).contiguous()
    pbt = (1 - 2 * p01.to(torch.bfloat16)).transpose(1, 2).contiguous()
    fns = {"b1 (port)": lambda: tk.hamming_search_banked(q, p),
           "u8 wgmma": lambda: tk.assoc_matmul_banked(q01, p01),
           "bf16 bmm": lambda: torch.bmm(qb, pbt)}          # d - 2H, bf16 out
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(events_ms(torch, fns[k]))
    oracle = {k: statistics.median(v) for k, v in times.items()}
    print(f"recall oracle G={g} B={b} C={c} W={w}: "
          + ", ".join(f"{k} {v:.5f} ms" for k, v in oracle.items()), flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(card=card, b1_peak_tops=peak / 1e12,
                                             b1_wgmma_tops=wgmma / 1e12, oracle_ms=oracle),
                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
