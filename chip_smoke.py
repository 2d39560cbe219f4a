#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failing phase exits non-zero; there is no CPU
fallback, and a missing GPU is a failure):

1. card: the GPU's name and power limit (nvidia-smi); build the CUDA kernels
   from src/repro_torch/csrc with nvcc and print the build seconds; count
   instructions in the built library's SASS (cuobjdump): HGMMA/HMMA in the
   bf16 attention kernel, IGMMA/IMMA and no IDP4A in assoc_matmul, LDGSTS
   (16-byte cp.async) in the sparse kernels, BMMA (1-bit tensor-core
   products) in the Hamming search and top-k kernels, and the SIMT
   attention kernel built for f32 only;
2. kernels: each of the nine kernels against its plain PyTorch version on
   the card, at the main path's shapes and at one tall shape (102,400 classes
   over 64 cores, d = 2048, batch 4096); assoc_matmul also at a ragged shape
   (K = 500, a partial class tile) and on bytes 0-255; the fused top-k and
   the per-bank search also at ragged, tie (across the kernel's 128-row
   tiles and across the top-k's class splits) and limit shapes, k = 1
   against the top-1 kernel, c_real inside the last split, k past a split's
   classes (W = 64 and 5), B and C off the search's tiles and W = 76;
   `hamming_search` also at the Table I trials' shape; the two sparse
   kernels at ragged, tie and empty-query shapes, full lists at the serve
   shape, indices on segment and row edges, one class past a 128-class
   tile, and d = 2^21 -- bit-exact; the attention forward at
   the LM prefill's shape (B = 8, S = 1024, 32 heads over 4, D = 64, causal,
   bf16), gemma3-1b's layer shape (4 heads over 1, D = 256, window 512 and
   global), non-causal, ragged, a prefill chunk (q_offset 512), f32,
   deepseek-coder-33b's layer shape (56 heads over 8, D = 128), D = 16 and
   32, and rows that see no key (q_offset -64) -- within atol = rtol = 2e-2
   in bf16 and 1e-5 in f32; each with the kernel's median
   device time (CUDA-graph replay) and eager call time, the plain version's
   time, one PyTorch library call's where one computes the same function
   (for the Hamming searches also one bf16 `torch.bmm` on the +-1
   expansions), and the bound (least time the card could take; the Hamming
   kernels' products counted as 2*G*B*c*32W operations at the 1-bit
   tensor-core rate, B1_OPS_PER_S);
3. precharacterization: the EM channel + exhaustive OTA phase search at
   3 TX / 64 RX / 7 dB, avg BER 0.0100 +- 1e-4;
4. OTA serve at the paper's configuration (6400 classes, d = 512, M = 3,
   64 cores, batch 256): 8 calls in each of the four bsc modes
   (baseline/permuted x unpacked/packed) and ideal baseline unpacked/packed;
   packed == unpacked on the same seeds, ideal == the noise-free reference
   (predictions and maxsim), and the launch counters show which kernels
   each serve ran;
5. wired serve, unpacked and packed, with the same checks;
6. the bsc tier alone at the serve shape: every core's flip rate lies within
   5 sigma of its BER, and the packed draw equals the unpacked one;
7. Table I at the paper's task (C = 100, d = 512, 2000 trials): M in
   (1, 3, 5, 7, 9, 11) x baseline/permuted x ideal/wireless (the average
   BER of phase 3) x unpacked/packed, 48 calls of `classifier.run_trials`
   (`run_accuracy` is its mean); packed == unpacked trial for trial, M = 1
   cells 1.0, the ideal baseline M = 3 cell within 5 sigma of 0.9702;
8. sparse trials at d = 2^20, density 0.001, k_max = 2048 (M in (1, 3),
   ideal and bsc), every run's search held against a dense oracle on every
   25th trial, and at d = 8192 (density 0.008, k_max 131, ideal) the sparse,
   packed and unpacked searches equal, distance for distance;
9. the sparse serve at d = 2^20, k_max = 2048 over the paper's 6400 classes,
   64 cores, M = 3, batch 256: ideal and bsc calls, the ideal answers held
   against a dense oracle, the psum wire and representation="auto" against
   index_ag, the d = 8192 sparse serve against the packed one, and the bsc
   drop and insertion rates per core within 5 sigma;
10. coarse-to-fine and multi-centroid: the flat and coarse serves at the C
   sweep's gate row (102,400 classes, d = 2048, 8 cores, batch 512, bsc at
   BER 0.02, groups of 8, 8 kept), 8 calls each, packed and unpacked:
   0 predictions differ coarse vs flat, packed == unpacked; the screen's
   recall against full distances (`hamming_search_banked`); keep == n_grp
   at C = 1024 == flat in pred and maxsim; `train_multicentroid` on the
   6400-class d = 512 codebook (k_c = 4), `multicentroid_predict` right on
   every noisy prototype at BER 0.0 and 0.1, and the 25,600-row bank served
   flat and coarse over 64 cores, centroid rows and classes equal;
11. the LM serve: TinyLlama-1.1B at its published width and depth (22
   layers, d = 2048, bf16, 1.1 B parameters drawn from the seed), batch 8 x
   prompt 1024 x 32 new tokens, greedy, through `Engine.generate`: 22
   attention launches a generate and no other kernel, time to first token,
   decode ms per token, tokens/s; each layer's attention on its own inputs
   against f64 (kernel no further off than its plain twin); and, with the
   attention projections at fan-in over their contraction, f32 greedy
   tokens of kernel and twin identical (last logits within 1e-3),
   decode(prefill(x), t) against prefill(x ‖ t) within 5e-3, bf16 last
   logits within LM_BF16_LOGIT_BOUND (see `phase_lm`); bf16 `torch.matmul` at
   the projection shapes identical with the reduced-precision reduction
   flag on and off.

Each phase prints its seconds. Then the card line again, a JSON line
{"kernels": [...]} (launches counted on the main-path runs of phases 4-5 and
7-11, each run between a reset and a read of the counters: the serves, the
48 Table I calls, the sparse trials and serves at d = 2^20, phase 10's
serves, recall oracle and multi-centroid calls, and phase 11's generates;
the d = 8192 comparisons, the keep == n_grp identity at C = 1024 and phase
11's checks are not counted), and as the last line {"ok": true, ...}.

    python3 chip_smoke.py --profile --json out/chip_smoke.json

adds a profile of every serve mode, of the sparse serve, of the flat
and coarse packed serves at 102,400 classes, and of the LM prefill (with
the attention kernel's share of its device time) and decode step under
torch.profiler (device busy time, idle share, top device ops per call), and
writes every number of the run, unrounded, to the JSON file.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 peak outside the tensor cores
# the 1-bit tensor-core product (mma.sync m16n8k256 .b1 .and.popc), counted
# as 2 operations a bit product like the int8 peak: NVIDIA publishes no 1-bit
# peak, so this is the highest rate benchmarks/torch_hamming_b1_probe.py
# measured on an H100 80GB HBM3 at 700 W (about 5x the int8 peak)
B1_OPS_PER_S = 10283e12
PEAKS = {"int8": INT8_OPS_PER_S, "b1": B1_OPS_PER_S, "bf16": BF16_FLOPS_PER_S,
         "f32": F32_FLOPS_PER_S}
CALLS = 8                        # serve calls per mode
SEED = 0
SPARSE_DIM, SPARSE_DENSITY, SPARSE_K = 2**20, 0.001, 2048   # benchmarks/sparse.py:46-47
NARROW_DIM, NARROW_DENSITY, NARROW_K = 8192, 0.008, 131     # packed kernels fit (W = 256)
# the gate row of the coarse-to-fine C sweep: benchmarks/topk.py:52-53
# (C = 102,400, gs = 8, keep = 8), :89-101 (d = 2048, M = 3, 8 cores, batch
# 512, exact noise) and :102 (bsc at BER 0.02)
COARSE = dict(n_classes=102400, dim=2048, m_tx=3, n_rx_cores=8, batch=512)
COARSE_BER, COARSE_GS, COARSE_KEEP = 0.02, 8, 8
# the serve codebook of the multi-centroid memory, with train_multicentroid's
# defaults (src/repro/core/classifier.py:450-461): k_c = 4 -> 25,600 rows
MC_CLASSES, MC_DIM, MC_KC, MC_CORES = 6400, 512, 4, 64
PAPER_TABLE1 = {  # benchmarks/table1.py:11-16, M = 1, 3, ..., 11
    ("baseline", "ideal"): [1, 0.966, 0.902, 0.803, 0.704, 0.543],
    ("baseline", "wireless"): [1, 0.966, 0.9, 0.801, 0.699, 0.537],
    ("permuted", "ideal"): [1, 1, 1, 1, 0.995, 0.978],
    ("permuted", "wireless"): [1, 1, 1, 1, 0.994, 0.963],
}
TABLE1_MS = (1, 3, 5, 7, 9, 11)
# phase 11: TinyLlama-1.1B at its published width (src/repro/configs/tinyllama_1_1b.py:
# 22 layers, d 2048, 32 heads over 4 kv heads, head_dim 64, d_ff 5632, vocab
# 32000, bf16), weights drawn from the seed; batch 8 x prompt 1024 x 32 new, greedy
LM = dict(arch="tinyllama-1.1b", batch=8, prompt_len=1024, max_new=32)
LM_GENERATES = 2                 # counted generate calls (the first one cold)
# bf16 prefill last logits, kernel vs its plain twin, with the attention
# projections at fan-in over their contraction: max |diff| allowed, about 3x
# what this tree shows on the H100 and 5% of its largest logit (PERF.md)
LM_BF16_LOGIT_BOUND = 0.25
# serve modes: (serve, PHY tier, permuted bundling, representation)
MODES = ([("ota", ch, perm, rep) for ch, perm in (("bsc", False), ("bsc", True), ("ideal", False))
          for rep in ("unpacked", "packed")]
         + [("wired", "bsc", False, rep) for rep in ("unpacked", "packed")])
SERVE_KERNELS = {  # (serve, representation) -> the kernels its calls must launch
    ("ota", "unpacked"): ("assoc_matmul",), ("ota", "packed"): ("hamming_topk_banked",),
    ("wired", "unpacked"): ("majority_bundle", "assoc_matmul"),
    ("wired", "packed"): ("hamming_search",),
}
KERNELS = {  # name -> (route, source, the TPU kernel it replaces)
    "hamming_topk_banked": ("cuda", "src/repro_torch/csrc/hamming.cu",
                            "src/repro/kernels/hamming/kernel.py:109"),
    "hamming_search": ("cuda", "src/repro_torch/csrc/hamming.cu",
                       "src/repro/kernels/hamming/kernel.py:260"),
    "hamming_topk_k_banked": ("cuda", "src/repro_torch/csrc/hamming.cu",
                              "src/repro/kernels/hamming/kernel.py:214"),
    "hamming_search_banked": ("cuda", "src/repro_torch/csrc/hamming.cu",
                              "src/repro/kernels/hamming/kernel.py:41"),
    "assoc_matmul": ("cuda", "src/repro_torch/csrc/assoc_matmul.cu",
                     "src/repro/kernels/assoc_matmul/kernel.py:42"),
    "majority_bundle": ("cuda", "src/repro_torch/csrc/majority.cu",
                        "src/repro/kernels/majority/kernel.py:27"),
    "sparse_search": ("cuda", "src/repro_torch/csrc/sparse.cu",
                      "src/repro/kernels/sparse/kernel.py:62"),
    "sparse_topk_banked": ("cuda", "src/repro_torch/csrc/sparse.cu",
                           "src/repro/kernels/sparse/kernel.py:119"),
    "flash_attention_fwd": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:82"),
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# instructions in the SASS of the redesigned kernels: kernel symbol -> the
# opcodes that must appear (tensor-core products; the sparse kernels'
# asynchronous 16-byte copies) and those that must not
SASS_RULES = {
    "flash_fwd_mma_kernel": (("HGMMA", "HMMA"), ()),
    "assoc_matmul_kernel": (("IGMMA", "IMMA"), ("IDP4A",)),
    "sparse_kernel": (("LDGSTS",), ()),
    # the packed Hamming search and top-k: 1-bit tensor-core products
    "hamming_search_kernel": (("BMMA", "IMMA"), ()),
    "hamming_topk_k_kernel": (("BMMA", "IMMA"), ()),
}


def sass_counts(lib: Path) -> dict:
    """{kernel symbol: {opcode: count}} over every instance of the kernels in
    SASS_RULES, from ``cuobjdump -sass`` of the built library; also
    the names of the SIMT attention kernel's instances (f32 only)."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    ops = {op for want, bad in SASS_RULES.values() for op in want + bad}
    pat = re.compile(r"\b(" + "|".join(sorted(ops)) + r")\b")
    counts = {name: dict.fromkeys(sorted(ops), 0) for name in SASS_RULES}
    simt, current = [], None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            current = next((n for n in SASS_RULES if n in fn), None)
            if "flash_fwd_simt_kernel" in fn:
                simt.append(fn)
        elif current is not None:
            for op in pat.findall(line):
                counts[current][op] += 1
    return dict(counts=counts, simt_attention=simt)


def ptxas_report(lib: Path) -> dict:
    """{instance: (registers, spill store bytes, spill load bytes)} of the
    kernels in SASS_RULES, from the ptxas report (-Xptxas -v) that the
    build keeps in build.log beside the library."""
    out, current = {}, None
    for line in (lib.parent / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            name = next((n for n in SASS_RULES if n in fn), None)
            current = None if name is None else fn[fn.index(name):].split("EE")[0] + "E"
            if current is not None:
                out[current] = [None, None, None]
        elif current is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[current][1:] = [int(st), int(ld)]
        elif current is not None and "Used" in line and "registers" in line:
            out[current][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return {k: tuple(v) for k, v in out.items()}


def _events(torch):
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def call_ms(torch, fn, samples: int = 7) -> float:
    """Median time of one eager call of `fn` issued back to back from Python:
    the device time or, when the host issues slower than the device runs,
    the host's cost per call (what an eager caller pays)."""
    fn()
    torch.cuda.synchronize()
    start, end = _events(torch)
    per_call = []
    for _ in range(samples):
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / 20)
    return statistics.median(per_call)


def time_ms(torch, fn, samples: int = 7) -> float:
    """Median device time of one call of `fn`: a batch of calls (sized from
    one eager call to take ~2 ms) captured in one CUDA graph, so the host's
    launch cost drops out, and the graph replayed `samples` times between
    CUDA events. Caches stay warm, as for the serve, which reuses its
    prototypes from call to call."""
    fn()
    torch.cuda.synchronize()
    start, end = _events(torch)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(1, min(100, int(2.0 / max(start.elapsed_time(end), 1e-3))))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up on a side stream before capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(per_call)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def bmm_yardstick(torch, hv, q, p) -> dict:
    """The Hamming searches' second library time: one bf16 `torch.bmm` of
    the +-1 expansions of q [G, B, W] and p [G, C, W], d - 2H in one call
    (the product a tensor-core route computes; its bf16 output rounds)."""
    d = 32 * q.shape[-1]
    qb = (1 - 2 * hv.unpack(q, d).to(torch.bfloat16)).contiguous()
    pbt = (1 - 2 * hv.unpack(p, d).to(torch.bfloat16)).transpose(1, 2).contiguous()
    return dict(bmm=lambda: torch.bmm(qb, pbt))


def kernel_cases(torch, gen):
    """(kernel name, shape label, kernel call, plain call, library call or
    None, bytes moved, operations, operation kind) at the main path's shapes
    and the tall shape."""
    from repro_torch import kernels as tk
    from repro_torch.core import hypervector as hv
    from repro_torch.kernels.assoc_matmul.ref import assoc_matmul_ref
    from repro_torch.kernels.hamming.ref import hamming_search_ref, hamming_topk_banked_ref
    from repro_torch.kernels.majority.ref import majority_bundle_ref

    dev = "cuda"

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.uint8)

    cases = []
    for label, (g, b, c, w) in [("serve baseline G=64", (64, 256, 100, 16)),
                                ("serve permuted G=192", (192, 256, 100, 16)),
                                ("tall", (64, 4096, 1600, 64)),
                                # static + dynamic shared memory just past 48 KB
                                ("wide", (4, 64, 300, 76))]:
        q, p = words(g, b, w), words(g, c, w)
        cases.append(("hamming_topk_banked", f"{label} B={b} C={c} W={w}",
                      lambda q=q, p=p: tk.hamming_topk_banked(q, p),
                      lambda q=q, p=p: hamming_topk_banked_ref(q, p), None,
                      4 * g * (b + c) * w + 8 * g * b, 2 * g * b * c * 32 * w, "b1"))
    for label, (b, c, w) in [("serve wired", (256, 6400, 16)), ("tall", (4096, 102400, 64)),
                             ("Table I trials", (2000, 100, 16))]:
        q, p = words(b, w), words(c, w)
        # cdist with p=0 counts the coordinates that differ: the Hamming
        # distance, on the unpacked bits as f32
        qf, pf = hv.unpack(q, 32 * w).float(), hv.unpack(p, 32 * w).float()
        cases.append(("hamming_search", f"{label} B={b} C={c} W={w}",
                      lambda q=q, p=p: tk.hamming_search(q, p),
                      lambda q=q, p=p: hamming_search_ref(q, p),
                      lambda qf=qf, pf=pf: torch.cdist(qf, pf, p=0),
                      4 * (b + c) * w + 4 * b * c, 2 * b * c * 32 * w, "b1",
                      bmm_yardstick(torch, hv, q[None], p[None])))
    for label, (g, b, c, k) in [("serve per core G=64", (64, 256, 100, 512)),
                                ("serve permuted G=192", (192, 256, 100, 512)),
                                ("serve wired G=1", (1, 256, 6400, 512)),
                                ("tall", (64, 4096, 1600, 2048)),
                                # padding past K, a partial class tile, unaligned rows
                                ("ragged", (3, 200, 100, 500)),
                                # every byte value, not only 0 and 1: 2v - 1 each
                                ("bytes 0-255", (3, 200, 100, 500))]:
        q, p = bits(g, b, k), bits(g, c, k)
        if label.startswith("bytes"):
            q, p = (torch.randint(0, 256, x.shape, generator=gen, device=dev,
                                  dtype=torch.uint8) for x in (q, p))
        qb = (2 * q.to(torch.bfloat16) - 1).contiguous()
        pbt = (2 * p.to(torch.bfloat16) - 1).transpose(1, 2).contiguous()
        cases.append(("assoc_matmul", f"{label} B={b} C={c} K={k}",
                      lambda q=q, p=p: tk.assoc_matmul_banked(q, p),
                      lambda q=q, p=p: assoc_matmul_ref(q, p),
                      lambda qb=qb, pbt=pbt: torch.bmm(qb, pbt),
                      g * (b + c) * k + 4 * g * b * c, 2 * g * b * c * k, "int8"))
    for label, (m, b, d) in [("serve wired", (3, 256, 512)), ("tall", (3, 4096, 2048))]:
        x = bits(m, b, d)
        cases.append(("majority_bundle", f"{label} M={m} B={b} d={d}",
                      lambda x=x: tk.majority_bundle(x),
                      lambda x=x, m=m: majority_bundle_ref(x.reshape(m, -1)).reshape(x.shape[1:]),
                      lambda x=x: torch.mode(x, 0).values,   # odd M: the mode is the majority
                      m * b * d + b * d, m * b * d, "int32"))
    return cases


def sparse_kernel_cases(torch, gen):
    """The two sparse kernels' cases, as `kernel_cases` gives them plus a
    dict of extras: ``lib_eager`` (time the library call eagerly: a
    cuSPARSE product is not captured in a CUDA graph here) and ``expect``
    (a check of the result beyond equality with the plain version). Queries
    are random index lists at density >= 0.001, lists with every slot live,
    and lists on the edges of the kernels' segments (`plan`) and of the row;
    every list is checked sorted and SENTINEL-padded, the kernels'
    precondition. The prototypes are random words (about half their bits
    set)."""
    from repro_torch import kernels as tk
    from repro_torch.core import hypervector as hv, sparse
    from repro_torch.kernels.sparse.ops import plan
    from repro_torch.kernels.sparse.ref import sparse_search_ref, sparse_topk_banked_ref

    dev, S = "cuda", sparse.SENTINEL

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def sorted_lists(q):
        """The kernels' precondition, held on every list they are fed: each
        row strictly increasing up to its SENTINEL padding."""
        require(bool((q[..., 1:] > q[..., :-1]).logical_or(q[..., 1:] == S).all()),
                "sparse kernel cases: index lists not sorted or not SENTINEL-padded")
        return q

    def lists(n, d, k, density, empty=()):
        q = sparse.random_sparse(gen, n, d, k, density, dev)
        q[list(empty)] = S                  # all-SENTINEL rows, as padded batch rows are
        return sorted_lists(q)

    def live(q):
        return int((q != S).sum())

    def full(n, d, k):
        """Lists with all k slots live (as the bsc serve's are), one index in
        each of k equal strides of the row."""
        stride = d // k
        return sorted_lists((torch.arange(k, device=dev, dtype=torch.int32) * stride
                             + torch.randint(0, stride, (n, k), generator=gen, device=dev,
                                             dtype=torch.int32)).contiguous())

    def edges(n, d, k, wseg, density):
        """Random lists but the first four: the first and last bits of the row
        and of the kernels' first segment boundary; every segment's first and
        last bit; live slots all inside one (middle) segment; empty."""
        seg, nseg = 32 * wseg, -(-d // (32 * wseg))
        q = sparse.random_sparse(gen, n, d, k, density, dev)
        mid = nseg // 2 * seg
        one = torch.randperm(min(seg, d - mid), generator=gen, device=dev)[:min(k, 300)] + mid
        special = [sorted({b for b in (0, seg - 1, seg, d - 1) if b < d}),
                   sorted({b for i in range(nseg) for b in (i * seg, min(d, (i + 1) * seg) - 1)}),
                   sorted(one.tolist()), []]
        for r, idx in enumerate(special):
            idx = idx[:k]
            q[r] = S
            q[r, :len(idx)] = torch.tensor(idx, dtype=torch.int32, device=dev)
        return sorted_lists(q)

    cases = []
    for label, (b, c, w, k, dens, empty, lib) in [
            ("trials", (2000, 100, 32768, 2048, SPARSE_DENSITY, (), True)),
            ("serve-wide", (256, 6400, 32768, 2048, SPARSE_DENSITY, (), False)),
            ("ragged", (77, 333, 1000, 2097, 0.04, (3, 4, 5), False)),
            ("a class tile and one", (40, 129, 1000, 2097, 0.04, (), False)),
            ("segment edges", (40, 100, 32768, 2048, SPARSE_DENSITY, (), False)),
            ("d = 2^21", (20, 150, 65536, 4096, SPARSE_DENSITY, (), False))]:
        q, p = lists(b, 32 * w, k, dens, empty), words(c, w)
        if label == "segment edges":
            q = edges(b, 32 * w, k, plan(b, c, w, search=True).wseg, dens)
        libfn, extra = None, {}
        if lib:
            # the overlap |q AND p| by cuSPARSE: the queries as a CSR f32
            # matrix [B, d] times the unpacked prototypes [d, C] f32, all of
            # the kernel's work but two adds
            valid = q != S
            crow = torch.zeros(b + 1, dtype=torch.int64, device=dev)
            crow[1:] = valid.sum(1).cumsum(0)
            col = q[valid].to(torch.int64)
            with warnings.catch_warnings():     # "CSR support is in beta"
                warnings.simplefilter("ignore", UserWarning)
                csr = torch.sparse_csr_tensor(crow, col, torch.ones(col.numel(), device=dev),
                                              size=(b, 32 * w), check_invariants=True)
            dense = hv.unpack(p, 32 * w).T.float().contiguous()
            libfn, extra = (lambda csr=csr, dense=dense: torch.sparse.mm(csr, dense)), dict(
                lib_eager=True, lib_what=f"CSR f32 [B, d] x f32 [d, C] ({dense.numel() * 4} B)")
        cases.append(("sparse_search", f"{label} B={b} C={c} k={k} W={w}",
                      lambda q=q, p=p: tk.sparse_search(q, p),
                      lambda q=q, p=p: sparse_search_ref(q, p), libfn,
                      4 * (b * k + c * w + b * c), live(q) * c, "gather", extra))
    for label, (g, b, c, c_real, w, k, dens, empty) in [
            ("serve G=64", (64, 256, 100, 100, 32768, 2048, SPARSE_DENSITY, ())),
            ("ragged", (3, 77, 333, 300, 1000, 2097, 0.04, (2, 80, 150))),
            ("full lists, serve G=64", (64, 256, 100, 100, 32768, 2048, None, ())),
            ("a class tile and one", (2, 40, 129, 129, 1000, 2097, 0.04, ())),
            ("segment edges", (2, 40, 100, 100, 32768, 2048, SPARSE_DENSITY, ())),
            ("d = 2^21", (2, 20, 150, 150, 65536, 4096, SPARSE_DENSITY, ()))]:
        if dens is None:
            q = full(g * b, 32 * w, k).reshape(g, b, k)
        elif label == "segment edges":
            wseg = plan(b, c_real, w, banks=g).wseg
            q = edges(g * b, 32 * w, k, wseg, dens).reshape(g, b, k)
        else:
            q = lists(g * b, 32 * w, k, dens, empty).reshape(g, b, k)
        p = words(g, c, w)
        cases.append(("sparse_topk_banked", f"{label} B={b} C={c} c_real={c_real} k={k} W={w}",
                      lambda q=q, p=p, cr=c_real: tk.sparse_topk_banked(q, p, c_real=cr),
                      lambda q=q, p=p, cr=c_real: sparse_topk_banked_ref(q, p, cr), None,
                      4 * g * (b * k + c * w) + 8 * g * b, live(q) * c_real, "gather", {}))
    # duplicates of query 0's bank row across tile boundaries (32 rows a tile
    # at W = 1000, one at W = 32768): the first copy must win at distance 0
    for w, k, dens, dups in [(1000, 2097, 0.04, (31, 32, 64)), (32768, 2048, SPARSE_DENSITY,
                                                              (5, 6, 99))]:
        g, b, c = 2, 40, 100
        q = lists(g * b, 32 * w, k, dens).reshape(g, b, k)
        p = words(g, c, w)
        p[:, list(dups)] = hv.pack(sparse.densify(q[:, 0], 32 * w))[:, None, :]

        def expect(got, first=dups[0]):
            dist, idx = got
            return bool((idx[:, 0] == first).all() and (dist[:, 0] == 0).all())

        cases.append(("sparse_topk_banked", f"ties at {dups} B={b} C={c} k={k} W={w}",
                      lambda q=q, p=p: tk.sparse_topk_banked(q, p),
                      lambda q=q, p=p: sparse_topk_banked_ref(q, p), None,
                      4 * g * (b * k + c * w) + 8 * g * b, live(q) * c, "gather",
                      dict(expect=expect)))
    return cases


def hamming_k_cases(torch, gen):
    """The fused top-k's and the per-bank search's cases, as
    `sparse_kernel_cases` gives them: the coarse screen's shape (G = 8 cores,
    B = 512, 1600 group summaries of W = 64 words, k = 8) and the recall
    oracle's (12,800 rows per core) first, then ragged shapes, ties across
    the kernel's 128-row tiles, k = 1 against the top-1 kernel, and k at the
    kernel's limit."""
    from repro_torch import kernels as tk
    from repro_torch.core import hypervector as hv
    from repro_torch.kernels.hamming.ops import CLASS_TILE, MAX_K, plan
    from repro_torch.kernels.hamming.ref import (hamming_search_banked_ref,
                                                 hamming_topk_k_banked_ref)

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    def topk_case(label, g, b, c, w, k, c_real=None, p=None, q=None, expect=None):
        q = words(g, b, w) if q is None else q
        p = words(g, c, w) if p is None else p
        cr = c if c_real is None else c_real
        return ("hamming_topk_k_banked", f"{label} G={g} B={b} C={c} c_real={cr} W={w} k={k}",
                lambda: tk.hamming_topk_banked(q, p, k=k, c_real=cr),
                lambda: hamming_topk_k_banked_ref(q, p, k, cr), None,
                4 * g * (b + cr) * w + 8 * g * b * k, 2 * g * b * cr * 32 * w, "b1",
                {} if expect is None else dict(expect=expect))

    cases = [topk_case("screen", 8, 512, 1600, 64, 8),
             topk_case("bank screen", 64, 256, 50, 16, 8),   # under one tile
             topk_case("ragged", 3, 77, 333, 16, 5, c_real=300),
             # the last split ends at c_real, inside its last tile
             topk_case("c_real inside the last split", 8, 512, 1600, 64, 8, c_real=1550),
             # k past one split's classes (6 splits of one 128-class tile)
             topk_case("k past a split's classes", 2, 100, 700, 64, 150, c_real=650),
             topk_case("k past a split's classes, W=5", 1, 64, 1600, 5, 200)]
    # eight equal copies of query 0's row straddle the boundary of splits 1
    # and 2 of the screen's plan: ranks 0-7 are those columns, lowest first
    splits = plan(8, 512, 1600, torch.cuda.get_device_properties(0).multi_processor_count)
    edge = CLASS_TILE * (2 * 13 // splits)       # split 2's first tile of 13
    q, p = words(8, 512, 64), words(8, 1600, 64)
    p[:, edge - 4:edge + 4] = q[:, :1]
    want_i = torch.arange(edge - 4, edge + 4, device="cuda", dtype=torch.int32)
    cases.append(topk_case(f"equal rows across the split edge at {edge}", 8, 512, 1600, 64, 8,
                           p=p, q=q, expect=lambda got, want=want_i: bool(
                               (got[1][:, 0] == want).all() and (got[0][:, 0] == 0).all())))
    # every row identical: rank r is column r, across five tiles
    same = words(2, 1, 64).expand(2, 600, 64).contiguous()
    cases.append(topk_case("all rows equal", 2, 40, 600, 64, 12, p=same, expect=lambda got: bool(
        (got[1] == torch.arange(12, device="cuda", dtype=torch.int32)).all()
        and (got[0] == got[0][..., :1]).all())))
    # query 0's rows at 0..11 bits, at 122..133 and again at 250..261 (both
    # copies straddle a tile edge): ranks (0,122), (0,250), (1,123), ...
    q = words(2, 8, 64)
    p = words(2, 384, 64)
    for at in (122, 250):
        for j in range(12):
            p[:, at + j] = q[:, 0]
            p[:, at + j, 0] ^= (1 << j) - 1
    want_i = torch.tensor([122, 250, 123, 251, 124, 252], device="cuda", dtype=torch.int32)
    want_d = torch.tensor([0, 0, 1, 1, 2, 2], device="cuda", dtype=torch.int32)
    cases.append(topk_case("duplicates across tiles", 2, 8, 384, 64, 6, p=p, q=q,
                           expect=lambda got: bool((got[0][:, 0] == want_d).all()
                                                   and (got[1][:, 0] == want_i).all())))
    q, p = words(8, 512, 64), words(8, 1600, 64)

    def as_top1(got, q=q, p=p):
        d1, i1 = tk.hamming_topk_banked(q, p)
        return torch.equal(got[0][..., 0], d1) and torch.equal(got[1][..., 0], i1)

    cases.append(topk_case("k=1 == top-1 kernel", 8, 512, 1600, 64, 1, p=p, q=q,
                           expect=as_top1))
    q, p = words(8, 64, 64), words(8, 1600, 64)

    def over_the_limit_raises(got, q=q, p=p):
        try:
            tk.hamming_topk_banked(q, p, k=MAX_K + 1)
        except ValueError as e:
            return "MAX_K" in str(e)
        return False

    cases.append(topk_case("k at the limit (k + 1 raises)", 8, 64, 1600, 64, MAX_K, p=p, q=q,
                           expect=over_the_limit_raises))
    for label, (g, b, c, w) in [("recall oracle", (8, 512, 12800, 64)),
                                ("ragged", (3, 77, 333, 5)),
                                # 128-query tiles, B past a tile, C % 4 != 0
                                ("B and C off the tiles", (4, 200, 9001, 64)),
                                ("W=76", (2, 130, 700, 76))]:
        q, p = words(g, b, w), words(g, c, w)
        qf, pf = hv.unpack(q, 32 * w).float(), hv.unpack(p, 32 * w).float()
        cases.append(("hamming_search_banked", f"{label} G={g} B={b} C={c} W={w}",
                      lambda q=q, p=p: tk.hamming_search_banked(q, p),
                      lambda q=q, p=p: hamming_search_banked_ref(q, p),
                      lambda qf=qf, pf=pf: torch.cdist(qf, pf, p=0),   # batched, on bits
                      4 * g * (b + c) * w + 4 * g * b * c, 2 * g * b * c * 32 * w, "b1",
                      bmm_yardstick(torch, hv, q, p)))
    return cases


def attention_pairs(sq: int, skv: int, causal: bool, window: int, q_offset: int) -> int:
    """The (query, key) pairs of one head that the mask keeps: the work these
    inputs need (query i at position q_offset + i; a row that sees no key
    takes the mean of V over all Skv keys, as the reference gives it)."""
    n = 0
    for i in range(sq):
        qp = q_offset + i
        hi = min(skv, qp + 1) if causal else skv
        lo = max(0, qp - window + 1) if window > 0 else 0
        n += hi - lo if hi > lo else skv
    return n


def flash_cases(torch, gen):
    """The attention kernel's cases, as `sparse_kernel_cases` gives them: the
    prefill's shape first (TinyLlama-1.1B, B = 8, S = 1024), then gemma3-1b's
    layer shape at its full width (windowed and global), non-causal, a ragged
    length, a prefill chunk (q_offset = 512 over a 768-key prefix), f32 at
    the prefill's shape, deepseek-coder-33b's layer shape (B = 2), the two
    smallest head dims, and a causal q_offset of -64 (queries 0-63 see no
    key and take the mean of V over all keys). Tolerances: f32 atol = rtol =
    1e-5 (only the order of the sums differs); bf16 atol = rtol = 2e-2, compared in f32 (both
    sides round to bf16 once at the output). The library call is
    F.scaled_dot_product_attention on the same tensors (is_causal where that
    is the mask, else an explicit boolean mask), timed eagerly."""
    import torch.nn.functional as F

    from repro_torch import kernels as tk
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

    cases = []
    for label, (b, sq, skv, h, kh, d, causal, win, off, dt) in [
            ("prefill", (8, 1024, 1024, 32, 4, 64, True, -1, 0, torch.bfloat16)),
            ("gemma3-1b local", (8, 1024, 1024, 4, 1, 256, True, 512, 0, torch.bfloat16)),
            ("gemma3-1b global", (8, 1024, 1024, 4, 1, 256, True, -1, 0, torch.bfloat16)),
            ("non-causal", (8, 512, 512, 32, 4, 64, False, -1, 0, torch.bfloat16)),
            ("ragged", (8, 1000, 1000, 32, 4, 64, True, -1, 0, torch.bfloat16)),
            ("chunk", (8, 256, 768, 32, 4, 64, True, -1, 512, torch.bfloat16)),
            ("f32 prefill", (8, 1024, 1024, 32, 4, 64, True, -1, 0, torch.float32)),
            ("deepseek-coder-33b", (2, 1024, 1024, 56, 8, 128, True, -1, 0, torch.bfloat16)),
            ("D=16", (2, 300, 300, 4, 2, 16, True, -1, 0, torch.bfloat16)),
            ("D=32", (2, 300, 300, 4, 2, 32, True, -1, 0, torch.bfloat16)),
            # queries 0-63 see no key: the mean of V over all 128 keys
            ("fully masked rows", (2, 128, 128, 4, 2, 64, True, -1, -64, torch.bfloat16))]:
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, skv, kh, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        kw = dict(causal=causal, window=win, q_offset=off)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if win <= 0 and off == 0 and sq == skv:
            def lib(qt=qt, kt=kt, vt=vt, c=causal):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=c, enable_gqa=True)
        else:
            qp = off + torch.arange(sq, device="cuda")[:, None]
            kp = torch.arange(skv, device="cuda")[None, :]
            mask = (kp <= qp) if causal else torch.ones_like(qp - kp, dtype=torch.bool)
            if win > 0:
                mask &= (qp - kp) < win

            def lib(qt=qt, kt=kt, vt=vt, mask=mask):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
        tol = 1e-5 if dt == torch.float32 else 2e-2
        cases.append((
            "flash_attention_fwd",
            f"{label} B={b} Sq={sq} Skv={skv} H={h} KH={kh} D={d} causal={causal} "
            f"window={win} q_offset={off} {str(dt).split('.')[-1]}",
            lambda q=q, k=k, v=v, kw=kw: tk.flash_attention_fwd(q, k, v, **kw),
            lambda q=q, k=k, v=v, kw=kw: flash_fwd_ref(q, k, v, **kw), lib,
            q.element_size() * 2 * b * d * (sq * h + skv * kh),
            4 * b * h * d * attention_pairs(sq, skv, causal, win, off),
            "bf16" if dt == torch.bfloat16 else "f32",
            dict(tol=(tol, tol), lib_eager=True,
                 lib_what="F.scaled_dot_product_attention (eager)")))
    return cases


def phase_kernels(torch, gen) -> dict:
    results = {}
    for case in kernel_cases(torch, gen) + hamming_k_cases(torch, gen) + sparse_kernel_cases(
            torch, gen) + flash_cases(torch, gen):
        name, label, kern, plain, lib, nbytes, ops, kind = case[:8]
        extra = case[8] if len(case) > 8 else {}
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got_t = got if isinstance(got, tuple) else (got,)
        want_t = want if isinstance(want, tuple) else (want,)
        err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                  for a, b in zip(got_t, want_t))
        if "tol" in extra:      # float kernels: within the stated tolerance, in f32
            atol, rtol = extra["tol"]
            near = all(torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol)
                       for a, b in zip(got_t, want_t))
            require(near, f"{name} [{label}] beyond atol {atol} rtol {rtol} of its plain "
                          f"version (max |err| {err})")
            verdict = f"within atol {atol} rtol {rtol} (max |err| {err:.3g})"
        else:
            exact = all(torch.equal(a, b) for a, b in zip(got_t, want_t))
            require(exact, f"{name} [{label}] differs from its plain version (max |err| {err})")
            verdict = "bit-exact"
        if "expect" in extra:
            require(extra["expect"](got), f"{name} [{label}]: fails its expected-result check")
        ms, eager_ms = time_ms(torch, kern), call_ms(torch, kern)
        plain_ms = time_ms(torch, plain, samples=3)
        lib_timer = call_ms if extra.get("lib_eager") else time_ms
        lib_ms = lib_timer(torch, lib, samples=3) if lib is not None else None
        bmm_ms = time_ms(torch, extra["bmm"], samples=3) if "bmm" in extra else None
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if kind in PEAKS:       # products with a peak for their type (b1: measured)
            ops_ms = ops / PEAKS[kind] * 1e3
            bound_ms, bound_by = max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                                          else "operations")
        else:                   # gathers: no published peak, bytes bound
            bound_ms, bound_by = bytes_ms, "bytes"
        row = dict(shape=label, max_abs_err=err, ms=ms, call_ms=eager_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bmm_ms=bmm_ms,
                   bound_by=bound_by, library_ms=lib_ms, bytes=nbytes, ops=ops, op_kind=kind,
                   library_what=extra.get("lib_what"), tol=extra.get("tol"))
        results.setdefault(name, []).append(row)
        print(f"kernel {name} [{label}]: {verdict}, {ms:.4f} ms (eager call {eager_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, "
              f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms"
              f"{'' if bmm_ms is None else f', bf16 bmm {bmm_ms:.5f} ms'}, bound "
              f"{bound_ms:.5f} ms ({bound_by}; {nbytes} B, {ops} {kind} ops)", flush=True)
    return results


# ---------------------------------------------------------------------------
# phases 4-5: the serves
# ---------------------------------------------------------------------------

def serve_setup(torch, base, mode, protos_u, device):
    """One serve mode: (label, cfg, serve fn, its prototypes, CALLS batches of
    (classes, queries), noise generator). The query and noise generators are
    seeded alike in every mode, so every mode sees the same draws."""
    import dataclasses

    from repro_torch.core import hypervector as hv
    from repro_torch.core import scaleout

    kind, ch, perm, rep = mode
    cfg = dataclasses.replace(base, channel=ch, permuted=perm, representation=rep)
    make = scaleout.make_ota_serve if kind == "ota" else scaleout.make_wired_serve
    label = (f"ota {ch} {'permuted' if perm else 'baseline'} {rep}" if kind == "ota"
             else f"wired {rep}")
    gq = torch.Generator(device=device).manual_seed(1)
    batches = [scaleout.make_queries(gq, cfg, protos_u) for _ in range(CALLS)]
    return (label, cfg, make(cfg, device=device), hv.pack(protos_u) if cfg.packed else protos_u,
            batches, torch.Generator(device=device).manual_seed(2))


def run_serve(torch, base, mode, protos_u, state, device):
    """CALLS serve calls of one mode with the launch counters set to 0 just
    before and read just after; returns predictions, maxsims, classes, the
    noise-free reference's predictions and maxsims, per-call ms and kernel
    launches."""
    from repro_torch import kernels as tk
    from repro_torch.core import scaleout

    label, cfg, serve, protos, batches, gn = serve_setup(torch, base, mode, protos_u, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    preds, sims, ms = [], [], []
    tk.reset_launch_counts()
    for _, q in batches:
        t0 = time.perf_counter()
        pred, sim = serve(protos, q, state, gn)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        preds.append(pred)
        sims.append(sim)
    counts = tk.launch_counts()
    refs = [scaleout.serve_reference(cfg, protos, q) for _, q in batches]
    return dict(label=label, pred=torch.cat(preds), sim=torch.cat(sims),
                classes=torch.cat([c for c, _ in batches]), ms=ms, counts=counts,
                ref_pred=torch.cat([r[0] for r in refs]),
                ref_sim=torch.cat([r[1] for r in refs]))


def hit_rate(torch, run, permuted: bool) -> dict:
    from repro_torch.core import classifier

    if permuted:
        return classifier.serve_accuracy(run["pred"], run["classes"])
    sent = (run["pred"][:, None] == run["classes"]).any(1)
    return {"hit": float(sent.float().mean())}


def phase_serves(torch, state, protos_u, base, device="cuda") -> dict:
    """Phases 4-5 at configuration `base` (the paper's on the card)."""
    launches = dict.fromkeys(KERNELS, 0)
    runs = {}
    for mode in MODES:
        run = runs[mode] = run_serve(torch, base, mode, protos_u, state, device)
        want = SERVE_KERNELS[(mode[0], mode[3])]
        require(all(run["counts"][k] > 0 for k in want),
                f"{run['label']}: {want} not all launched {run['counts']}")
        require(all(v == 0 for k, v in run["counts"].items() if k not in want),
                f"{run['label']}: unexpected launches {run['counts']}")
        for name, n in run["counts"].items():
            launches[name] += n
        run["acc"] = hit_rate(torch, run, mode[2])
        print(f"serve {run['label']}: {CALLS} calls x batch {base.batch}, "
              f"{statistics.median(run['ms']):.3f} ms/call median "
              f"(first {run['ms'][0]:.3f}), {json.dumps(run['acc'])}, launches {run['counts']}",
              flush=True)
    for kind, ch, perm, rep in MODES:
        run = runs[(kind, ch, perm, rep)]
        if rep == "packed":
            u = runs[(kind, ch, perm, "unpacked")]
            require(torch.equal(u["pred"], run["pred"]) and torch.equal(u["sim"], run["sim"]),
                    f"{run['label']}: differs from the unpacked serve")
        if kind == "wired" or ch == "ideal":
            require(torch.equal(run["pred"], run["ref_pred"])
                    and torch.equal(run["sim"], run["ref_sim"]),
                    f"{run['label']}: differs from serve_reference")
    require(runs[("ota", "bsc", False, "unpacked")]["acc"]["hit"] > 0.9,
            "bsc baseline: fewer than 90% of trials answered from the sent set")
    print("serve checks: packed == unpacked in every mode, ideal and wired == "
          "serve_reference (predictions and maxsim)", flush=True)
    return {"launches": launches, "runs": {
        r["label"]: dict(ms=r["ms"], acc=r["acc"], counts=r["counts"]) for r in runs.values()}}


def phase_flip_rate(torch, state, cfg) -> dict:
    """The bsc tier alone at the serve shape: CALLS draws of every core's
    copy of an all-zero bundle. Each core's flip rate must lie within 5 sigma
    of ``state.ber`` (binomial sigma over the bits drawn), and the packed
    tier's draw on the same seed must unpack to the unpacked one."""
    from repro_torch import phy
    from repro_torch.core import hypervector as hv

    chan, n = phy.get_channel("bsc"), cfg.n_rx_cores
    zeros = torch.zeros((cfg.batch, cfg.dim), dtype=torch.uint8, device="cuda")
    flips = torch.zeros(n, dtype=torch.float64, device="cuda")
    for seed in range(CALLS):
        draws = [chan.rx_copies(torch.Generator(device="cuda").manual_seed(100 + seed),
                                hv.pack(zeros) if packed else zeros, state, 0, n,
                                packed=packed, dim=cfg.dim, noise=cfg.noise)
                 for packed in (False, True)]
        require(torch.equal(hv.unpack(draws[1], cfg.dim), draws[0]),
                "bsc: the packed draw differs from the unpacked one")
        flips += draws[0].sum((1, 2), dtype=torch.float64)
    bits = CALLS * cfg.batch * cfg.dim
    ber = state.ber.double()
    rate = flips / bits
    sigma = (ber * (1 - ber) / bits).sqrt()
    z = float(((rate - ber).abs() / sigma.clamp_min(1e-300)).max())
    require(bool(((rate - ber).abs() <= 5 * sigma + 1e-12).all()),
            f"bsc: a core's flip rate is more than 5 sigma from its BER (max {z:.2f} sigma)")
    print(f"bsc flip rate: {n} cores x {bits} bits, within 5 sigma of each core's BER "
          f"(max {z:.3f} sigma), packed draw == unpacked", flush=True)
    return dict(bits_per_core=bits, max_sigma=z)


# ---------------------------------------------------------------------------
# phases 7-9: Table I, the sparse trials, the sparse serve
# ---------------------------------------------------------------------------

def counted(torch, fn):
    """(result, seconds, launch counts) of one main-path call, the counters
    set to 0 just before and read just after."""
    from repro_torch import kernels as tk

    torch.cuda.synchronize()
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, tk.launch_counts()


def require_only(counts: dict, want: tuple, what: str) -> None:
    require(all(counts[k] > 0 for k in want) and
            all(v == 0 for k, v in counts.items() if k not in want),
            f"{what}: launches {counts}, expected {want} and nothing else")


def add_launches(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


@contextlib.contextmanager
def recorded(module, name: str):
    """Within the block, every call of ``module.name`` runs unchanged and
    appends its (positional arguments, result) to the list this yields."""
    orig, log = getattr(module, name), []

    def wrapper(*args, **kwargs):
        log.append((args, orig(*args, **kwargs)))
        return log[-1][1]

    setattr(module, name, wrapper)
    try:
        yield log
    finally:
        setattr(module, name, orig)


def phase_table1(torch, wireless_ber: float, launches: dict) -> dict:
    """Table I at the paper's task: 48 calls of `classifier.run_trials`."""
    from repro_torch.core import classifier

    cfg = classifier.HDCTaskConfig()
    flags, rows, call_s = {}, {}, []
    for rep in ("unpacked", "packed"):
        for bundling in ("baseline", "permuted"):
            want = (("assoc_matmul",) if rep == "unpacked" else
                    ("hamming_search",) if bundling == "baseline" else ("hamming_topk_banked",))
            for name, channel, ber in (("ideal", "ideal", 0.0),
                                       ("wireless", "bsc", wireless_ber)):
                accs = []
                for m in TABLE1_MS:
                    f, sec, counts = counted(torch, lambda: classifier.run_trials(
                        SEED, cfg, m, ber, bundling, representation=rep, channel=channel))
                    require_only(counts, want, f"table1 {rep} {bundling} {name} M={m}")
                    add_launches(launches, counts)
                    call_s.append(sec)
                    flags[(rep, bundling, name, m)] = f
                    accs.append(float(f.float().mean()))
                rows[(rep, bundling, name)] = accs
    for (rep, bundling, name, m), f in flags.items():
        if rep == "packed":
            require(torch.equal(f, flags[("unpacked", bundling, name, m)]),
                    f"table1 {bundling} {name} M={m}: packed differs from unpacked")
    require(all(accs[0] == 1.0 for accs in rows.values()), "table1: an M = 1 cell is not 1.0")
    p = 0.99 * 0.98                        # prod(1 - i/C), i < M = 3, C = 100
    acc3 = rows[("unpacked", "baseline", "ideal")][1]
    sigma = (p * (1 - p) / cfg.n_trials) ** 0.5
    require(abs(acc3 - p) <= 5 * sigma,
            f"table1 ideal baseline M=3: {acc3} is more than 5 sigma from {p:.4f}")
    for bundling in ("baseline", "permuted"):
        for name in ("ideal", "wireless"):
            print(f"table1 {bundling:8s} {name:8s} M={TABLE1_MS}: "
                  f"{rows[('unpacked', bundling, name)]} (paper {PAPER_TABLE1[(bundling, name)]})",
                  flush=True)
    print(f"table1 checks: packed == unpacked trial for trial in all 24 cells, M = 1 cells "
          f"1.0, ideal baseline M=3 {acc3} within 5 sigma of {p:.4f}; "
          f"{statistics.median(call_s) * 1e3:.3f} ms per call median "
          f"(max {max(call_s) * 1e3:.3f})", flush=True)
    return dict(rows={" ".join(k): v for k, v in rows.items()}, wireless_ber=wireless_ber,
                call_ms=[x * 1e3 for x in call_s])


def phase_sparse_trials(torch, ber: float, launches: dict) -> dict:
    """Sparse trials at d = 2^20, each run's search held against a dense
    oracle; at d = 8192 the three representations' searches held equal."""
    from repro_torch.core import classifier, hypervector as hv, sparse
    from repro_torch.kernels.hamming.ref import hamming_search_ref

    cfg = classifier.HDCTaskConfig(dim=SPARSE_DIM)
    out = {}
    for channel, b in (("ideal", 0.0), ("bsc", ber)):
        for m in (1, 3):
            with recorded(classifier, "sparse_search") as log:
                f, sec, counts = counted(torch, lambda: classifier.run_trials(
                    SEED, cfg, m, b, representation="sparse", channel=channel,
                    density=SPARSE_DENSITY, k_max=SPARSE_K))
            require_only(counts, ("sparse_search",), f"sparse trials {channel} M={m}")
            add_launches(launches, counts)
            require(len(log) == 1, f"sparse trials {channel} M={m}: {len(log)} searches")
            (qs, protos), dist = log[0]
            # every 25th trial's distances from the densified, packed query
            oracle = hamming_search_ref(hv.pack(sparse.densify(qs[::25], SPARSE_DIM)), protos)
            require(torch.equal(dist[::25], oracle),
                    f"sparse trials {channel} M={m}: distances differ from the dense oracle")
            out[f"{channel} M={m}"] = dict(acc=float(f.float().mean()), s=sec,
                                           live=float(sparse.count(qs).float().mean()))
            print(f"sparse trials d=2^20 k_max={SPARSE_K} {channel} M={m}: accuracy "
                  f"{out[f'{channel} M={m}']['acc']}, {sec:.3f} s, "
                  f"{out[f'{channel} M={m}']['live']:.1f} live indices per query", flush=True)
    require(out["ideal M=1"]["acc"] == 1.0, "sparse trials: ideal M=1 accuracy is not 1.0")
    # at d = 8192 (not counted: a check, not the main path) the three
    # representations search the same trials: equal distances, equal dots
    narrow = classifier.HDCTaskConfig(dim=NARROW_DIM)
    searches = {"sparse": "sparse_search", "packed": "hamming_search",
                "unpacked": "assoc_matmul"}
    for m in (1, 3):
        flags, found = {}, {}
        for rep, fn in searches.items():
            with recorded(classifier, fn) as log:
                flags[rep], _, counts = counted(torch, lambda: classifier.run_trials(
                    SEED, narrow, m, 0.0, representation=rep, channel="ideal",
                    density=NARROW_DENSITY, k_max=NARROW_K))
            require(len(log) == 1, f"sparse trials d=8192 M={m} {rep}: {len(log)} searches")
            found[rep] = log[0][1]
            if rep == "sparse":
                require_only(counts, ("sparse_search",), f"sparse trials d=8192 M={m}")
        require(torch.equal(found["sparse"], found["packed"]) and
                torch.equal((NARROW_DIM - 2 * found["sparse"]).float(), found["unpacked"]),
                f"sparse trials d=8192 M={m}: the sparse, packed and unpacked searches differ")
        require(torch.equal(flags["sparse"], flags["packed"]) and
                torch.equal(flags["packed"], flags["unpacked"]),
                f"sparse trials d=8192 M={m}: sparse, packed and unpacked differ")
        out[f"d=8192 M={m}"] = float(flags["sparse"].float().mean())
    print(f"sparse trials checks: ideal M=1 accuracy 1.0 at d=2^20; every 25th trial's "
          f"distances == the dense oracle in all four runs; at d=8192 sparse == packed == "
          f"unpacked distances ({narrow.n_trials} x {narrow.n_classes}) and flags (accuracy "
          f"M=1 {out['d=8192 M=1']}, M=3 {out['d=8192 M=3']})", flush=True)
    return out


def rate_sigmas(counts, n: int, p):
    """Per-core distance of observed Bernoulli counts from n*p, in binomial
    sigmas. A float32 uniform draw compared with p cannot resolve p below its
    2^-24 step, so p is floored there, and one count of slack covers the
    discreteness where n*p is small (some cores' BER is ~1e-12)."""
    p = p.clamp(min=2.0**-24)
    sigma = (n * p * (1 - p)).sqrt()
    return ((counts - n * p).abs() - 1).clamp(min=0) / sigma.clamp(min=1e-300)


def sparse_codebook(torch, gen, n: int, d: int, k_max: int, density: float):
    """Index lists [n, k_max] and packed words [n, d/32] of a random sparse
    codebook, packed 64 rows at a time (a dense [6400, 2^20] codebook is
    6.7 GB of bytes)."""
    from repro_torch.core import hypervector as hv, sparse

    codes = sparse.random_sparse(gen, n, d, k_max, density, "cuda")
    words = torch.cat([hv.pack(sparse.densify(codes[i:i + 64], d))
                       for i in range(0, n, 64)])
    return codes, words


def phase_sparse_serve(torch, state, launches: dict, profile: bool = False) -> dict:
    """The sparse serve at d = 2^20 over the paper's geometry (``profile``:
    also its ideal and bsc calls under torch.profiler)."""
    import dataclasses

    from repro_torch.core import hypervector as hv, scaleout, sparse
    from repro_torch.kernels.hamming.ref import hamming_search_ref

    base = scaleout.ScaleOutConfig(representation="sparse", collective="index_ag",
                                   dim=SPARSE_DIM, k_max=SPARSE_K)
    d, n_core = base.dim, base.n_rx_cores
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    codes, protos = sparse_codebook(torch, gen, base.n_classes, d, base.k_max, SPARSE_DENSITY)
    gq = torch.Generator(device="cuda").manual_seed(1)
    batches = [scaleout.make_queries(gq, base, codes) for _ in range(CALLS)]
    out, answers = {}, {}
    drops = torch.zeros(n_core, dtype=torch.float64, device="cuda")
    accepted = torch.zeros(n_core, dtype=torch.float64, device="cuda")
    live_total, slots_total = 0, 0
    for channel in ("ideal", "bsc"):
        cfg = dataclasses.replace(base, channel=channel)
        serve = scaleout.make_ota_serve(cfg)
        gn = torch.Generator(device="cuda").manual_seed(2)
        preds, sims, ms = [], [], []
        for classes, q in batches:
            with recorded(sparse, "_noise_draws") as drawn:     # the bsc draws it makes
                (pred, sim), sec, counts = counted(torch, lambda: serve(protos, q, state, gn))
            require_only(counts, ("sparse_topk_banked",), f"sparse serve {channel}")
            add_launches(launches, counts)
            ms.append(sec * 1e3)
            preds.append(pred)
            sims.append(sim)
            if channel == "ideal":              # a dense oracle on the first 16 trials
                bundled = hv.majority(sparse.densify(q[:16, 0], d).transpose(0, 1))
                dist = hamming_search_ref(hv.pack(bundled), protos)
                require(torch.equal(pred[:16], torch.argmin(dist, -1).to(torch.int32)) and
                        torch.equal(sim[:16], (d - 2 * dist.min(-1).values) / (2.0 * d) + 0.5),
                        "sparse serve ideal: differs from the dense oracle")
            else:
                require(len(drawn) == 1, "sparse serve bsc: not one draw per call")
                drop, _, acc = drawn[0][1]
                live = sparse.valid(sparse.bundle(q[:, 0]))[None]       # [1, B, k]
                drops += (drop & live).sum((1, 2), dtype=torch.float64)
                accepted += acc.sum((1, 2), dtype=torch.float64)
                live_total += int(live.sum())
                slots_total += live.numel()
        pred, classes = torch.cat(preds), torch.cat([c for c, _ in batches])
        hit = float((pred[:, None] == classes).any(1).float().mean())
        answers[channel] = (preds, sims)
        out[channel] = dict(ms=ms, hit=hit)
        print(f"sparse serve {channel}: {CALLS} calls x batch {base.batch}, "
              f"{statistics.median(ms):.3f} ms/call median (first {ms[0]:.3f}), hit rate "
              f"{hit} (reported, not gated)", flush=True)
    # the drop rate of live indices, and the insertion acceptance, per core
    ber = state.ber.double()[:n_core]
    z_drop = rate_sigmas(drops, live_total, ber)
    z_ins = rate_sigmas(accepted, slots_total, torch.clamp(ber * (d / base.k_max), max=1.0))
    require(float(z_drop.max()) <= 5, f"sparse bsc: a core's drop rate is more than 5 sigma "
                                      f"from its BER (max {float(z_drop.max()):.2f} sigma)")
    require(float(z_ins.max()) <= 5, f"sparse bsc: a core's insertion rate is more than 5 sigma "
                                     f"from min(1, ber*d/k_max) (max {float(z_ins.max()):.2f} sigma)")
    # the psum wire and representation="auto" answer as index_ag does
    for channel in ("ideal", "bsc"):
        for variant in (dict(collective="psum"), dict(representation="auto", collective="psum")):
            cfg = dataclasses.replace(base, channel=channel, **variant)
            if variant.get("representation") == "auto":
                require(scaleout.resolve_representation(cfg).representation == "sparse",
                        "representation='auto' does not resolve to sparse at d = 2^20")
                if channel == "bsc":
                    continue
            gn = torch.Generator(device="cuda").manual_seed(2)
            (pred, sim), _, counts = counted(
                torch, lambda: scaleout.make_ota_serve(cfg)(protos, batches[0][1], state, gn))
            require_only(counts, ("sparse_topk_banked",), f"sparse serve {channel} {variant}")
            add_launches(launches, counts)
            want_p, want_s = answers[channel][0][0], answers[channel][1][0]
            require(torch.equal(pred, want_p) and torch.equal(sim, want_s),
                    f"sparse serve {channel} {variant}: differs from index_ag")
    # at d = 8192 (not counted: a check, not the main path) the ideal sparse
    # serve answers as the packed serve
    narrow = dataclasses.replace(base, dim=NARROW_DIM, k_max=NARROW_K, channel="ideal")
    codes8, protos8 = sparse_codebook(torch, gen, base.n_classes, NARROW_DIM, NARROW_K,
                                      NARROW_DENSITY)
    packed = dataclasses.replace(narrow, representation="packed", collective="psum", k_max=0)
    g8 = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(2):
        _, q8 = scaleout.make_queries(g8, narrow, codes8)
        (sp, ss), _, counts = counted(
            torch, lambda: scaleout.make_ota_serve(narrow)(protos8, q8, state, None))
        require_only(counts, ("sparse_topk_banked",), "sparse serve d=8192")
        q8p = hv.pack(sparse.densify(q8, NARROW_DIM))
        pp, ps = scaleout.make_ota_serve(packed)(protos8, q8p, state, None)
        require(torch.equal(sp, pp) and torch.equal(ss, ps),
                "sparse serve d=8192: differs from the packed serve")
    print(f"sparse serve checks: ideal == dense oracle (16 trials x {CALLS} calls), psum == "
          f"index_ag and auto -> sparse, d=8192 sparse == packed; bsc drop rate within 5 sigma "
          f"of each core's BER (max {float(z_drop.max()):.3f} sigma over {live_total} live "
          f"indices), insertion rate within 5 sigma of min(1, ber*d/k_max) (max "
          f"{float(z_ins.max()):.3f} sigma)", flush=True)
    out["bsc_rates"] = dict(live=live_total, slots=slots_total,
                            max_sigma_drop=float(z_drop.max()), max_sigma_ins=float(z_ins.max()))
    if profile:
        for channel in ("ideal", "bsc"):
            serve = scaleout.make_ota_serve(dataclasses.replace(base, channel=channel))
            gn = torch.Generator(device="cuda").manual_seed(2)
            out[f"profile {channel}"] = profile_calls(torch, f"sparse serve {channel}", [
                lambda q=q: serve(protos, q, state, gn) for _, q in batches])
    return out


# ---------------------------------------------------------------------------
# phase 10: coarse-to-fine search and the multi-centroid memory
# ---------------------------------------------------------------------------

def coarse_serves(torch, base, protos_u, protos_p, state, launches, log=None):
    """CALLS calls of each of the flat and coarse serves, packed and
    unpacked, on the same query and noise seeds; each call's launches are
    checked and added to ``launches``. ``log``
    (a list) receives the recorded (args, result) of every packed coarse
    call's screen and `_coarse_fine_packed`."""
    import dataclasses

    from repro_torch.core import hypervector as hv, scaleout

    kernels = {("packed", False): ("hamming_topk_banked",),
               ("packed", True): ("hamming_topk_k_banked",),
               ("unpacked", False): ("assoc_matmul",), ("unpacked", True): ("assoc_matmul",)}
    gq = torch.Generator(device="cuda").manual_seed(1)
    batches = [scaleout.make_queries(gq, base, protos_u) for _ in range(CALLS)]
    runs = {}
    for rep in ("packed", "unpacked"):
        for coarse in (False, True):
            cfg = dataclasses.replace(base, representation=rep,
                                      coarse_group=COARSE_GS if coarse else 0)
            serve = scaleout.make_ota_serve(cfg)
            protos = protos_p if cfg.packed else protos_u
            gn = torch.Generator(device="cuda").manual_seed(2)
            preds, sims, ms = [], [], []
            for _, q in batches:
                q = hv.pack(q) if cfg.packed else q
                with contextlib.ExitStack() as stack:
                    if log is not None and coarse and cfg.packed:
                        fine = stack.enter_context(recorded(scaleout, "_coarse_fine_packed"))
                        screen = stack.enter_context(recorded(scaleout, "hamming_topk_banked"))
                    (pred, sim), sec, counts = counted(torch, lambda: serve(protos, q, state, gn))
                    if log is not None and coarse and cfg.packed:
                        log.append((fine[0], screen[0]))
                require_only(counts, kernels[(rep, coarse)],
                             f"coarse phase {rep} {'coarse' if coarse else 'flat'} C={base.n_classes}")
                add_launches(launches, counts)
                preds.append(pred)
                sims.append(sim)
                ms.append(sec * 1e3)
            runs[(rep, coarse)] = dict(pred=torch.cat(preds), sim=torch.cat(sims), ms=ms)
    classes = torch.cat([c for c, _ in batches])
    return runs, classes


def phase_coarse(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 10 at the full width of the C sweep's gate row (COARSE), the
    identity at keep == n_grp, the screen's recall, and the multi-centroid
    memory at the serve codebook (train, predict, bank served flat and
    coarse)."""
    import dataclasses

    from repro_torch import kernels as tk, phy
    from repro_torch.core import classifier, hypervector as hv, scaleout
    from repro_torch.serving import hdc

    out = {}
    base = scaleout.ScaleOutConfig(**COARSE, noise="exact", channel="bsc",
                                   coarse_keep=COARSE_KEEP)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    protos_u = hv.random_hv(gen, base.n_classes, base.dim, "cuda")
    protos_p = torch.cat([hv.pack(protos_u[i:i + 8192]) for i in range(0, base.n_classes, 8192)])
    state = phy.state_from_ber(torch.full((base.n_rx_cores,), COARSE_BER, device="cuda"),
                               base.m_tx)
    c_core = base.n_classes // base.n_rx_cores
    cut = c_core / (c_core / COARSE_GS + COARSE_KEEP * COARSE_GS)
    log = []
    runs, classes = coarse_serves(torch, base, protos_u, protos_p, state, launches, log)
    mism = {}
    for rep in ("packed", "unpacked"):
        flat, coarse = runs[(rep, False)], runs[(rep, True)]
        mism[rep] = int((flat["pred"] != coarse["pred"]).sum())
        hit = float((coarse["pred"][:, None] == classes).any(1).float().mean())
        out[f"{rep} C={base.n_classes}"] = dict(
            flat_ms=flat["ms"], coarse_ms=coarse["ms"], mismatches=mism[rep], hit=hit,
            speedup=statistics.median(flat["ms"]) / statistics.median(coarse["ms"]))
        print(f"coarse {rep} C={base.n_classes} d={base.dim} {base.n_rx_cores} cores batch "
              f"{base.batch} BER {COARSE_BER} gs={COARSE_GS} keep={COARSE_KEEP}: flat "
              f"{statistics.median(flat['ms']):.3f} ms/call, coarse "
              f"{statistics.median(coarse['ms']):.3f} ms/call median ({CALLS} calls; "
              f"{out[f'{rep} C={base.n_classes}']['speedup']:.3f}x, row-visit cut {cut:.2f}x), "
              f"{mism[rep]} of {flat['pred'].numel()} predictions differ, hit rate {hit}",
              flush=True)
        require(mism[rep] == 0, f"coarse {rep}: {mism[rep]} predictions differ from the flat serve")
    for coarse in (False, True):
        a, b = runs[("packed", coarse)], runs[("unpacked", coarse)]
        require(torch.equal(a["pred"], b["pred"]) and torch.equal(a["sim"], b["sim"]),
                f"coarse phase: packed differs from unpacked (coarse={coarse})")

    # the screen's recall: of every (core, query), does the flat per-core
    # winner (first minimum of the full distances) lie in a surviving group?
    # (and on the core that holds the flat serve's answer)
    kept, kept_win, pairs = 0, 0, 0
    flat_pred = runs[("packed", False)]["pred"].reshape(CALLS, base.batch)
    for i, (((_, banks, q), _), (_, (_, gidx))) in enumerate(log):
        dist, _, counts = counted(torch, lambda: tk.hamming_search_banked(q.contiguous(), banks))
        require_only(counts, ("hamming_search_banked",), "recall oracle")
        add_launches(launches, counts)
        winner = torch.argmin(dist, -1)                       # [cores, B]
        d1, i1 = tk.hamming_topk_banked(q.contiguous(), banks)
        require(torch.equal(i1.long(), winner) and torch.equal(d1, dist.min(-1).values),
                "recall oracle: the full distances disagree with the fused top-1")
        survived = (gidx == (winner // COARSE_GS)[..., None].to(gidx.dtype)).any(-1)
        kept += int(survived.sum())
        pairs += winner.numel()
        core = (flat_pred[i] // c_core).long()
        kept_win += int(survived.gather(0, core[None])[0].sum())
    require(len(log) == CALLS, f"recall: {len(log)} coarse packed calls recorded")
    out["recall"] = dict(kept=kept, pairs=pairs, share=kept / pairs, winning_core=kept_win,
                         queries=CALLS * base.batch)
    print(f"coarse recall: the flat per-core winner survives the screen in {kept} of {pairs} "
          f"(core, query) pairs ({kept / pairs:.6f}), on the core of the flat serve's answer in "
          f"{kept_win} of {CALLS * base.batch} (full distances by hamming_search_banked)",
          flush=True)

    # keep == n_grp: the coarse serve is the flat serve, pred and maxsim
    small = dataclasses.replace(base, n_classes=1024, coarse_keep=1024 // base.n_rx_cores // COARSE_GS)
    ident, _ = coarse_serves(torch, small, protos_u[:1024].contiguous(),
                             protos_p[:1024].contiguous(), state, {})   # a check: not counted
    for rep in ("packed", "unpacked"):
        f, c = ident[(rep, False)], ident[(rep, True)]
        require(torch.equal(f["pred"], c["pred"]) and torch.equal(f["sim"], c["sim"]),
                f"coarse identity {rep}: keep == n_grp differs from the flat serve")
    print(f"coarse checks: 0 mismatches coarse vs flat in {CALLS} x {base.batch} trials, packed "
          f"and unpacked; packed == unpacked (flat and coarse, pred and maxsim); keep == n_grp "
          f"({small.coarse_keep}) at C={small.n_classes} == flat in pred and maxsim", flush=True)

    # the multi-centroid memory at the serve codebook
    book = classifier.make_codebook(torch.Generator(device="cuda").manual_seed(SEED),
                                    classifier.HDCTaskConfig(n_classes=MC_CLASSES, dim=MC_DIM),
                                    device="cuda")
    cents, train_s, counts = counted(torch, lambda: classifier.train_multicentroid(
        torch.Generator(device="cuda").manual_seed(3), book, MC_KC))
    require_only(counts, (), "train_multicentroid")
    pred_s = {}
    for ber in (0.0, 0.1):
        qs = hv.flip_bits_packed(torch.Generator(device="cuda").manual_seed(4), hv.pack(book), ber)
        pred, pred_s[ber], counts = counted(
            torch, lambda: classifier.multicentroid_predict(qs, cents))
        require_only(counts, ("hamming_topk_banked",), "multicentroid_predict")
        add_launches(launches, counts)
        require(torch.equal(pred.long(), torch.arange(MC_CLASSES, device="cuda")),
                f"multicentroid_predict at BER {ber}: {int((pred.long() != torch.arange(MC_CLASSES, device='cuda')).sum())} "
                "of the noisy prototypes misclassified")
    mc_cfg = scaleout.ScaleOutConfig(n_classes=MC_CLASSES * MC_KC, dim=MC_DIM, m_tx=3,
                                     n_rx_cores=MC_CORES, batch=256, representation="packed",
                                     channel="ideal", coarse_keep=COARSE_KEEP)
    bank = hdc.multicentroid_bank(torch.Generator(device="cuda").manual_seed(3), book, MC_KC,
                                  mc_cfg)
    require(torch.equal(bank, cents.reshape(MC_CLASSES * MC_KC, -1)),
            "multicentroid_bank: not the class-major rows of train_multicentroid")
    gq = torch.Generator(device="cuda").manual_seed(5)
    batches = [scaleout.make_queries(gq, dataclasses.replace(mc_cfg, n_classes=MC_CLASSES), book)
               for _ in range(CALLS)]
    mc_state = phy.state_from_ber(torch.zeros(MC_CORES, device="cuda"), 3)
    mc = {}
    for coarse, want in ((False, "hamming_topk_banked"), (True, "hamming_topk_k_banked")):
        serve = scaleout.make_ota_serve(dataclasses.replace(
            mc_cfg, coarse_group=COARSE_GS if coarse else 0))
        preds, ms = [], []
        for _, q in batches:                              # packed queries
            (pred, _), sec, counts = counted(torch, lambda: serve(bank, q, mc_state, None))
            require_only(counts, (want,), f"multicentroid serve coarse={coarse}")
            add_launches(launches, counts)
            preds.append(pred)
            ms.append(sec * 1e3)
        mc[coarse] = dict(pred=torch.cat(preds), ms=ms)
    sent = torch.cat([c for c, _ in batches])
    flat_cls = hdc.centroid_to_class(mc[False]["pred"], MC_KC)
    coarse_cls = hdc.centroid_to_class(mc[True]["pred"], MC_KC)
    require(torch.equal(flat_cls, coarse_cls), "multicentroid serve: coarse classes differ from flat")
    require(torch.equal(mc[False]["pred"], mc[True]["pred"]),
            "multicentroid serve: coarse centroid rows differ from flat")
    hit = float((flat_cls[:, None] == sent).any(1).float().mean())
    out["multicentroid"] = dict(
        train_s=train_s, predict_s=pred_s, rows=int(bank.shape[0]), hit=hit,
        flat_ms=mc[False]["ms"], coarse_ms=mc[True]["ms"])
    print(f"multicentroid checks: train {MC_CLASSES} classes x k_c={MC_KC} (d={MC_DIM}) in "
          f"{train_s:.3f} s; predict classifies all {MC_CLASSES} noisy prototypes at BER 0.0 "
          f"and 0.1 ({pred_s[0.0] * 1e3:.3f} / {pred_s[0.1] * 1e3:.3f} ms); bank "
          f"{bank.shape[0]} rows == the trained centroids; ideal serve over {MC_CORES} cores "
          f"flat {statistics.median(mc[False]['ms']):.3f} ms/call, coarse "
          f"{statistics.median(mc[True]['ms']):.3f} ms/call, centroid rows and classes flat == "
          f"coarse, hit rate {hit}", flush=True)
    if profile:
        for coarse in (False, True):
            cfg = dataclasses.replace(base, representation="packed",
                                      coarse_group=COARSE_GS if coarse else 0)
            serve = scaleout.make_ota_serve(cfg)
            gq = torch.Generator(device="cuda").manual_seed(1)
            qs = [scaleout.make_queries(gq, cfg, protos_u)[1] for _ in range(CALLS)]  # packed
            gn = torch.Generator(device="cuda").manual_seed(2)
            label = f"{'coarse' if coarse else 'flat'} packed C={base.n_classes}"
            # the coarse screen's split lists go through topk_merge_kernel
            out[f"profile {label}"] = profile_calls(torch, label, [
                lambda q=q: serve(protos_p, q, state, gn) for q in qs],
                share_of="topk_merge_kernel" if coarse else None)
    return out


def profile_calls(torch, label: str, calls: list, share_of: str | None = None) -> dict:
    """Where a call's time goes: the calls (zero-argument callables) under
    torch.profiler after one warm call; the device's busy time is the union
    of its kernel and copy intervals, its idle share the rest of the host's
    wall time of those calls, and the top device ops by summed time. With
    `share_of`, also the share of the summed device time in the ops whose
    name holds that string, and their device ms per call."""
    from torch.profiler import ProfilerActivity, profile

    calls[0]()                                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if cur_e is None or a > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += 0 if cur_e is None else cur_e - cur_s
    n = len(calls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    row = dict(wall_ms_per_call=wall_us / n / 1e3,
               device_busy_ms_per_call=busy / n / 1e3,
               idle_share=(1 - busy / wall_us) if dev else None,
               device_ops_per_call=len(dev) / n,
               top=[(name[:60], t / n / 1e3) for name, t in top])
    if share_of is not None:
        total = sum(by_name.values())
        mine = sum(t for name, t in by_name.items() if share_of in name)
        row["share"] = mine / total if total else None
        row["share_ms_per_call"] = mine / n / 1e3
        print(f"profile {label}: share of device time in {share_of}: {row['share']} "
              f"({row['share_ms_per_call']:.4f} ms/call)", flush=True)
    idle = "n/a" if row["idle_share"] is None else f"{row['idle_share']:.3f}"
    print(f"profile {label}: {row['wall_ms_per_call']:.3f} ms/call wall, device busy "
          f"{row['device_busy_ms_per_call']:.3f} ms/call "
          f"({row['device_ops_per_call']:.0f} device ops), idle share {idle}; top: "
          + ", ".join(f"{name} {t:.4f}" for name, t in row["top"][:4]), flush=True)
    return row


def fan_in_over_contraction(params: dict, cfg) -> dict:
    """Scale a drawn tree's attention projections, in place, to fan-in over
    the axes they contract: d_model for wq, wk, wv and H * hd for wo (the MLP
    and the head already are). The reference's init takes fan-in over axis -2
    (`src/repro/models/base.py:41-44`), which for wq [d, H, hd] and wk
    [d, KH, hd] is the head axis: at TinyLlama's width q and k then have
    std ~8 and ~23 and the scores ~180, a near-hard attention under which
    any change of summation order, the plain twin's own re-blocking
    included, changes the greedy tokens at 22 layers (phase 11 reports
    how far)."""
    a, d, h = params["blocks"]["attn"], cfg.d_model, cfg.n_heads
    a["wq"].mul_(math.sqrt(h / d))
    a["wk"].mul_(math.sqrt(cfg.n_kv_heads / d))
    a["wv"].mul_(math.sqrt(cfg.n_kv_heads / d))
    a["wo"].mul_(1 / math.sqrt(h))
    return params


def exact_attention(torch, q, k, v, causal=True, window=-1, q_offset=0, **_):
    """Softmax attention in f64: the yardstick of the per-layer check."""
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    kd, vd = (x.double().repeat_interleave(g, 2) for x in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) / math.sqrt(d)
    qp = q_offset + torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    ok = (kp <= qp) if causal else torch.ones_like(qp - kp, dtype=torch.bool)
    if window > 0:
        ok &= (qp - kp) < window
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc.masked_fill(~ok, -1e30), -1), vd)


# TinyLlama-1.1B's projection shapes in the prefill (M = batch 8 x prompt
# 1024 rows; K x N of wq/wo, wk/wv, wg/wu and wd)
BF16_MATMUL_SHAPES = [(8192, 2048, 2048), (8192, 2048, 256), (8192, 2048, 5632),
                      (8192, 5632, 2048)]


def bf16_reduction_check(torch, gen) -> list:
    """bf16 ``torch.matmul`` with PyTorch's
    ``allow_bf16_reduced_precision_reduction`` on and off, each against the
    f32 product rounded to bf16 once, at the LM's projection shapes: whether
    the flag changes what cuBLAS returns on this card (the reference
    accumulates in f32, src/repro/models/layers.py `dense`)."""
    flags = torch.backends.cuda.matmul
    keep = flags.allow_bf16_reduced_precision_reduction
    rows = []
    try:
        for m, k, n in BF16_MATMUL_SHAPES:
            x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            w = (torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)).bfloat16()
            ref = torch.matmul(x.float(), w.float()).bfloat16().float()
            got = {}
            for on in (True, False):
                flags.allow_bf16_reduced_precision_reduction = on
                got[on] = torch.matmul(x, w).float()
            torch.cuda.synchronize()
            row = dict(shape=(m, k, n), on_vs_off_equal=bool(torch.equal(got[True], got[False])),
                       on_err=float((got[True] - ref).abs().max()),
                       off_err=float((got[False] - ref).abs().max()),
                       on_differ=int((got[True] != ref).sum()),
                       off_differ=int((got[False] != ref).sum()))
            rows.append(row)
            print(f"bf16 matmul M={m} K={k} N={n}: reduced-precision reduction on vs off "
                  f"{'identical' if row['on_vs_off_equal'] else 'DIFFER'}; vs the f32 product "
                  f"rounded once: on max |err| {row['on_err']:.4g} ({row['on_differ']} of {m * n} "
                  f"differ), off {row['off_err']:.4g} ({row['off_differ']} differ)", flush=True)
    finally:
        flags.allow_bf16_reduced_precision_reduction = keep
    return rows


def phase_lm(torch, launches: dict, profile: bool = False) -> dict:
    """Phase 11: the dense-decoder LM serve at TinyLlama-1.1B's published
    width and depth (`LM`), weights drawn from the seed.

    With the reference's own init, as its launcher draws it: the main path,
    counted (bf16 `Engine.generate` x LM_GENERATES, 22 attention launches each
    and no other kernel), time to first token and decode ms per token; every
    layer's attention on its own inputs (the prefill's, first two rows),
    kernel and plain twin against f64, the kernel no further off than 1.5x
    the twin (bf16 and f32); and, reported only, how far kernel vs twin and
    twin vs the twin re-blocked drift apart end to end in f32.

    With the attention projections at fan-in over their contraction
    (`fan_in_over_contraction`): in f32 the greedy tokens of kernel and twin
    identical, the prefill's last logits within 1e-3 and decode(prefill(x), t)
    against prefill(x ‖ t) within 5e-3; in bf16 the last logits within
    LM_BF16_LOGIT_BOUND, token agreement reported. Last, bf16 `torch.matmul`
    at the projection shapes is the same with PyTorch's reduced-precision
    reduction flag on and off (`bf16_reduction_check`)."""
    import dataclasses
    from unittest import mock

    from repro_torch import configs
    from repro_torch import kernels as tk
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.models import count_params, get_model, init_params, layers
    from repro_torch.serving import Engine, ServeConfig

    dev = "cuda"
    b, s, new = LM["batch"], LM["prompt_len"], LM["max_new"]
    cfg = configs.get_config(LM["arch"])
    toks = torch.randint(0, cfg.vocab, (b, s + 1), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    prompt = {"tokens": toks[:, :s].contiguous()}
    pad_to = s + new + 1
    models = {dt: get_model(dataclasses.replace(cfg, dtype=dt))
              for dt in (torch.bfloat16, torch.float32)}
    engines = {dt: Engine(m, ServeConfig(max_new=new)) for dt, m in models.items()}

    def draw(conditioned: bool) -> dict:
        """{dtype: params}: one f32 draw from the seed, cast to bf16."""
        p32 = init_params(models[torch.float32].specs,
                          torch.Generator(device=dev).manual_seed(SEED), dev)
        if conditioned:
            fan_in_over_contraction(p32, cfg)

        def cast(t):
            return {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.bfloat16()
        return {torch.float32: p32, torch.bfloat16: cast(p32)}

    def using(fn):
        """The attention entry of the model swapped for `fn`."""
        return mock.patch.object(layers, "flash_attention_fwd", fn)

    def reblocked(q, k, v, **kw):
        return flash_fwd_ref(q, k, v, **dict(kw, block_q=128, block_k=256))

    def end_to_end(dt, params, fn):
        """(prefill last logits, greedy tokens) with the attention `fn`."""
        with using(fn):
            lg, _ = models[dt].prefill_fn(params, prompt)
            return lg, engines[dt].generate(params, prompt)

    # --- the reference's init: the main path, counted
    ref = draw(False)
    model, params, eng = models[torch.bfloat16], ref[torch.bfloat16], engines[torch.bfloat16]
    n_params = count_params(model.specs)
    gen_s = []
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    for _ in range(LM_GENERATES):
        t0 = time.perf_counter()
        toks_k = eng.generate(params, prompt)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    counts = tk.launch_counts()
    require_only(counts, ("flash_attention_fwd",), "lm generate")
    require(counts["flash_attention_fwd"] == cfg.n_layers * LM_GENERATES,
            f"lm generate: {counts['flash_attention_fwd']} attention launches in "
            f"{LM_GENERATES} calls, expected {cfg.n_layers} a call")
    add_launches(launches, counts)
    require(tuple(toks_k.shape) == (b, new) and
            bool(((toks_k >= 0) & (toks_k < cfg.vocab)).all()),
            f"lm generate: tokens {tuple(toks_k.shape)} out of shape or range")

    ttft_ms, dec_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, prompt, pad_to=pad_to)
        tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(new):
            step, cache = model.decode_fn(params, cache, tok, s + i)
            tok = torch.argmax(step, -1).to(torch.int32)
        torch.cuda.synchronize()
        ttft_ms.append((t1 - t0) * 1e3)
        dec_ms.append((time.perf_counter() - t1) / new * 1e3)
    require(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step).all()),
            "lm bf16: logits not finite")
    tok_s = b * new / statistics.median(gen_s[1:])
    out = dict(arch=cfg.name, params=n_params, batch=b, prompt_len=s, max_new=new,
               generate_s=gen_s, ttft_ms=ttft_ms, decode_ms_per_token=dec_ms,
               tokens_per_s=tok_s, launches=counts["flash_attention_fwd"])
    print(f"lm serve: {cfg.name} ({n_params} parameters, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, bf16), batch {b} x prompt {s} x {new} new, greedy: prefill "
          f"(time to first token) {statistics.median(ttft_ms):.3f} ms, decode "
          f"{statistics.median(dec_ms):.3f} ms/token, generate {gen_s[0]:.3f} s cold / "
          f"{statistics.median(gen_s[1:]):.3f} s warm ({tok_s:.1f} generated tokens/s)",
          flush=True)
    if profile:
        out["profile prefill"] = profile_calls(torch, "lm prefill bf16", [
            lambda: model.prefill_fn(params, prompt, pad_to=pad_to)], share_of="flash_fwd")
        _, cache = model.prefill_fn(params, prompt, pad_to=pad_to)
        state = dict(cache=cache, tok=toks_k[:, 0], pos=s)

        def decode_step():
            step, state["cache"] = model.decode_fn(params, state["cache"], state["tok"],
                                                   state["pos"])
            state["tok"] = torch.argmax(step, -1).to(torch.int32)
            state["pos"] += 1

        out["profile decode"] = profile_calls(torch, "lm decode step bf16",
                                              [decode_step] * 16)
        del state
    del cache

    layer_err = {}
    for dt in (torch.bfloat16, torch.float32):     # every layer on its own inputs
        seen = []

        def record(q, k, v, **kw):
            seen.append((q[:2], k[:2], v[:2], kw))
            return tk.flash_attention_fwd(q, k, v, **kw)

        with using(record):
            models[dt].prefill_fn(ref[dt], prompt)
        rows = []
        for q, k, v, kw in seen:
            want = exact_attention(torch, q, k, v, **kw)
            rows.append(tuple(float((got.double() - want).abs().max()) for got in (
                tk.flash_attention_fwd(q, k, v, **kw), flash_fwd_ref(q, k, v, **kw))))
        del seen
        name = str(dt).split(".")[-1]
        require(len(rows) == cfg.n_layers and all(a <= 1.5 * t for a, t in rows),
                f"lm {name}: a layer's attention off f64 by more than 1.5x the twin's: {rows}")
        layer_err[name] = rows
    lg_k, tk_k = end_to_end(torch.float32, ref[torch.float32], tk.flash_attention_fwd)
    lg_t, tk_t = end_to_end(torch.float32, ref[torch.float32], flash_fwd_ref)
    lg_r, tk_r = end_to_end(torch.float32, ref[torch.float32], reblocked)
    drift = dict(kernel_vs_twin_logits=float((lg_k - lg_t).abs().max()),
                 kernel_vs_twin_tokens=float((tk_k == tk_t).float().mean()),
                 twin_vs_reblocked_logits=float((lg_t - lg_r).abs().max()),
                 twin_vs_reblocked_tokens=float((tk_t == tk_r).float().mean()))
    out.update(layer_err_vs_f64=layer_err, reference_init_f32_drift=drift)
    worst = {k: (max(a for a, _ in v), max(t for _, t in v)) for k, v in layer_err.items()}
    print(f"lm checks, the reference's init: {counts['flash_attention_fwd']} attention launches "
          f"in {LM_GENERATES} generates ({cfg.n_layers} each), nothing else launched; bf16 "
          f"logits finite; every layer's attention vs f64, worst max |err| kernel / twin: "
          + ", ".join(f"{k} {a:.4g} / {t:.4g}" for k, (a, t) in worst.items())
          + f"; f32 end to end (not gated): kernel vs twin logits "
          f"{drift['kernel_vs_twin_logits']:.4g}, tokens agree "
          f"{drift['kernel_vs_twin_tokens']:.4f}; twin vs twin re-blocked "
          f"{drift['twin_vs_reblocked_logits']:.4g}, {drift['twin_vs_reblocked_tokens']:.4f}",
          flush=True)
    del ref, lg_k, lg_t, lg_r

    # --- attention projections at fan-in over their contraction: the gates end to end
    con = draw(True)
    lg32, tk32 = end_to_end(torch.float32, con[torch.float32], tk.flash_attention_fwd)
    lg32_t, tk32_t = end_to_end(torch.float32, con[torch.float32], flash_fwd_ref)
    f32_err = float((lg32 - lg32_t).abs().max())
    require(torch.equal(tk32, tk32_t),
            f"lm f32: greedy tokens differ kernel vs twin in "
            f"{int((tk32 != tk32_t).sum())} of {tk32.numel()}")
    require(f32_err <= 1e-3, f"lm f32: prefill logits kernel vs twin differ by {f32_err}")
    m32, p32 = models[torch.float32], con[torch.float32]
    _, cache = m32.prefill_fn(p32, prompt, pad_to=s + 1)
    lg_step, _ = m32.decode_fn(p32, cache, toks[:, s], s)
    lg_full, _ = m32.prefill_fn(p32, {"tokens": toks})
    dec_err = float((lg_step - lg_full).abs().max())
    require(dec_err < 5e-3, f"lm f32: decode(prefill(x), t) vs prefill(x + t) differ by "
                            f"{dec_err}")
    del cache
    lgb, tkb = end_to_end(torch.bfloat16, con[torch.bfloat16], tk.flash_attention_fwd)
    lgb_t, tkb_t = end_to_end(torch.bfloat16, con[torch.bfloat16], flash_fwd_ref)
    bf16_err = float((lgb - lgb_t).abs().max())
    agree = float((tkb == tkb_t).float().mean())
    require(bool(torch.isfinite(lgb).all()) and bool(torch.isfinite(lgb_t).all()),
            "lm bf16: logits not finite")
    require(bf16_err <= LM_BF16_LOGIT_BOUND,
            f"lm bf16: prefill logits kernel vs twin differ by {bf16_err} > "
            f"{LM_BF16_LOGIT_BOUND}")
    out.update(f32_logit_err=f32_err, decode_consistency_err=dec_err,
               bf16_logit_err=bf16_err, bf16_token_agreement=agree,
               logit_std=float(lgb.std()), logit_max=float(lgb.abs().max()))
    # the port's bf16 products leave the reduction to cuBLAS: hold that the
    # reduced-precision flag (True by default) changes nothing at these shapes
    out["bf16_matmul"] = bf16_reduction_check(torch, torch.Generator(device=dev).manual_seed(SEED))
    require(all(r["on_vs_off_equal"] for r in out["bf16_matmul"]),
            "lm bf16: allow_bf16_reduced_precision_reduction changes torch.matmul's result")
    print(f"lm checks, projections at fan-in over their contraction: f32 greedy tokens "
          f"kernel == twin ({tk32.numel()}), last logits max |diff| {f32_err:.3g}; "
          f"decode(prefill(x), t) vs prefill(x + t) {dec_err:.3g}; bf16 logits finite, last "
          f"logits kernel vs twin max |diff| {bf16_err:.4g} (bound {LM_BF16_LOGIT_BOUND}; "
          f"max |logit| {out['logit_max']:.3g}), tokens agree {agree:.4f}", flush=True)
    return out


def phase_profile(torch, state, protos_u, base) -> dict:
    """``--profile``: each serve mode's CALLS calls under torch.profiler."""
    out = {}
    for mode in MODES:
        label, _, serve, protos, batches, gn = serve_setup(torch, base, mode, protos_u, "cuda")
        out[label] = profile_calls(torch, label, [
            lambda q=q: serve(protos, q, state, gn) for _, q in batches])
    return out


def main(argv: list[str]) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile every serve mode under torch.profiler")
    ap.add_argument("--json", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs only on the GPU here",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)
    from repro_torch.core import classifier, scaleout
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}
    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"card: {card} ({kind}, {count} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)
    _build.library()
    print(f"build: {_build.build_seconds:.2f} s (nvcc, sm_90a, "
          f"{len(_build.SOURCES)} sources in parallel)", flush=True)
    sass = sass_counts(_build.build())
    sass["ptxas"] = ptxas_report(_build.build())
    print("ptxas (registers, spill store / load bytes): " + ", ".join(
        f"{k} {v[0]} regs {v[1]}/{v[2]} B" for k, v in sass["ptxas"].items()), flush=True)
    for name, (want, bad) in SASS_RULES.items():
        got = sass["counts"][name]
        print(f"sass {name}: " + ", ".join(f"{op} {got[op]}" for op in want + bad), flush=True)
        require(sum(got[op] for op in want) > 0, f"sass {name}: no {'/'.join(want)} instruction")
        require(all(got[op] == 0 for op in bad), f"sass {name}: {bad} present: {got}")
    # the SIMT attention kernel is built for f32 only (no bf16 instance)
    require(sass["simt_attention"] and all("bfloat16" not in fn
                                           for fn in sass["simt_attention"]),
            f"sass: the SIMT attention kernel has other than f32 instances: "
            f"{sass['simt_attention']}")
    seconds["1 build"] = time.perf_counter() - t_start

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return out

    kernels = phase("2 kernels", lambda: phase_kernels(
        torch, torch.Generator(device="cuda").manual_seed(0)))

    cfg = scaleout.ScaleOutConfig()
    pre_ms = []

    def precharacterize():
        for _ in range(2):                   # cold (first use of its ops), then warm
            t0 = time.perf_counter()
            st = scaleout.precharacterize_state(cfg, device="cuda")
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
        return st

    state = phase("3 precharacterization", precharacterize)
    avg, mx = float(state.ber.mean()), float(state.ber.max())
    print(f"precharacterization: {cfg.m_tx} TX / {cfg.n_rx_cores} RX / {cfg.snr_db} dB, "
          f"avg BER {avg:.6f}, max {mx:.6f}, {pre_ms[0]:.1f} ms cold, {pre_ms[1]:.1f} ms warm",
          flush=True)
    require(abs(avg - 0.0100) <= 1e-4, f"avg BER {avg} is not 0.0100 +- 1e-4")

    protos_u = classifier.make_codebook(
        torch.Generator(device="cuda").manual_seed(0),
        classifier.HDCTaskConfig(n_classes=cfg.n_classes, dim=cfg.dim), device="cuda")
    serves = phase("4-5 serves", lambda: phase_serves(torch, state, protos_u, cfg))
    launches = dict(serves["launches"])
    flip = phase("6 bsc flip rate", lambda: phase_flip_rate(torch, state, cfg))
    table = phase("7 table1", lambda: phase_table1(torch, avg, launches))
    sparse_trials = phase("8 sparse trials", lambda: phase_sparse_trials(torch, avg, launches))
    sparse_serve = phase("9 sparse serve", lambda: phase_sparse_serve(
        torch, state, launches, profile=args.profile))
    coarse = phase("10 coarse-to-fine and multi-centroid", lambda: phase_coarse(
        torch, launches, profile=args.profile))
    lm = phase("11 LM serve", lambda: phase_lm(torch, launches, profile=args.profile))
    profiles = (phase("profile", lambda: phase_profile(torch, state, protos_u, cfg))
                if args.profile else None)

    line = []
    for name, (route, source, replaces) in KERNELS.items():
        main_row = kernels[name][0]          # the first case is the main path's shape
        line.append(dict(name=name, route=route, source=source, replaces=replaces,
                         launches=launches.get(name, 0),
                         max_abs_err=max(r["max_abs_err"] for r in kernels[name]),
                         ms=main_row["ms"], call_ms=main_row["call_ms"],
                         plain_ms=main_row["plain_ms"],
                         bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                         library_ms=main_row["library_ms"], shape=main_row["shape"]))
    require(all(k["launches"] > 0 for k in line), "a kernel of the path never launched")
    seconds["total"] = time.perf_counter() - t_start
    print("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
          flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(
            card=card, kind=kind, torch=torch.__version__, build_s=_build.build_seconds,
            sass=sass,
            ber=dict(avg=avg, max=mx, ms=pre_ms), kernels=kernels, serves=serves["runs"],
            flip_rate=flip, table1=table, sparse_trials=sparse_trials,
            sparse_serve=sparse_serve, coarse=coarse, lm=lm, launches=launches,
            profiles=profiles, seconds=seconds), indent=1))
    print(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
