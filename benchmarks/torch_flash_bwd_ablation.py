#!/usr/bin/env python3
"""Where the bf16 attention backward's time goes, on one H100.

    python3 benchmarks/torch_flash_bwd_ablation.py

Builds copies of `src/repro_torch/csrc/flash_attention_bwd.cu`, each with
one part of the tensor-core passes taken out (a text edit of the source),
into build/flash_bwd_ablation/ (one nvcc each, in parallel), and times each
at the training shape (B 8, S 1024, 32 heads over 4, D 64, causal, bf16):
the whole call by CUDA events (median of 5 runs of 20 calls) and each of
its kernels by torch.profiler (5 calls). The copies compute wrong
gradients on purpose; only "kernel" is the port's. Their time against the
kernel's is the cost of what they leave out:

  kernel      the source as it is
  no lo       the lo terms of P and dS: the three gradient products once
  plain ew    P = S and dS = dP: no exponent, no mask, no dS arithmetic
  no grads    no dV, dK or dQ product (the compiler then drops P and dS)
  no S/dP     no S^T and dP^T (S and dP) product (their tiles zero)
  no loads    the streamed tiles loaded once (every later tile reuses it)

Also prints ptxas' registers of each copy's D = 64 kernels and any note
that it serialized their wgmma. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "flash_bwd_ablation"

ABLATIONS = {
    "kernel": [],
    "no lo": [("      wgmma_rs<DH>(&acc_v[0][0], al[ks], db);\n", ""),
              ("      wgmma_rs<DH>(&acc_k[0][0], dl[ks], db);\n", ""),
              ("      wgmma_rs<D>(&acc[0][0], al[ks], db);\n", "")],
    "plain ew": [
        ("        float p = exp2f(fmaf(st[j][e], scale_log2, -l));", "        float p = st[j][e];"),
        ("      for (int e = 0; e < 4; ++e) dpt[j][e] = st[j][e] * (dpt[j][e] - ((e & 1) ? d1 : d0)) "
         "* scale;", "      for (int e = 0; e < 4; ++e) dpt[j][e] += d0 * d1;"),
        ("        float p = exp2f(fmaf(s[j][e], scale_log2, -l));", "        float p = s[j][e];"),
        ("        dp[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1)) * scale;", "        dp[j][e] += p;")],
    "no grads": [(f"      wgmma_rs<{n}>(&{acc}[0][0], {a}[ks], db);\n", "")
                 for n, acc, a in (("DH", "acc_v", "ah"), ("DH", "acc_v", "al"),
                                   ("DH", "acc_k", "dh"), ("DH", "acc_k", "dl"),
                                   ("D", "acc", "ah"), ("D", "acc", "al"))],
    "no S/dP": [(f"      wgmma_ss<{n}>(&{x}[0][0], kmajor_desc<D>({a}, WG, 0, kk),\n"
                 f"                   kmajor_desc<D>({b}, {n}, 0, kk), kk == 0);", "")
                for n, x, a, b in (("BQ", "st", "sk_addr", "sq_addr"),
                                   ("BQ", "dpt", "sv_addr", "sdo_addr"),
                                   ("BK", "s", "sq_addr", "sk_addr"),
                                   ("BK", "dp", "sdo_addr", "sv_addr"))]
               + [("    float st[NT][4], dpt[NT][4];", "    float st[NT][4] = {}, dpt[NT][4] = {};"),
                  ("    float s[NT][4], dp[NT][4];", "    float s[NT][4] = {}, dp[NT][4] = {};")],
    "no loads": [("    if (nx < total) load_q(nx, (n + 1) & 1);",
                  "    if (nx < total && n < 1) load_q(nx, (n + 1) & 1);"),
                 ("    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);",
                  "    if (t + 1 < ntiles && t < 1) load_kv(t + 1, (t + 1) & 1);")],
}


def build() -> dict:
    from repro_torch.kernels._build import ARCH, FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    base = (CSRC / "flash_attention_bwd.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(ABLATIONS.items()):
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"ablation {name!r}: {old[:60]!r} is not in the source once")
            src = src.replace(old, new)
        cu, so = OUT / f"a{i}.cu", OUT / f"a{i}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen([_nvcc(), *ARCH, *FLAGS, "-shared", "-I", str(CSRC),
                                             str(cu), "-o", str(so)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"ablation {name!r} does not build:\n{log[-3000:]}")
        regs = re.findall(r"Compiling entry function '\w*?(flash_bwd_\w+?mma_kernel)ILi64E"
                          r".*?Used (\d+) registers", log, re.S)
        notes = sorted({m for m in re.findall(r"serialized due to ([^']*?) in the function "
                                              r"'\w*?flash_bwd_\w+?mma_kernelILi64E", log)})
        print(f"{name}: registers (D = 64) {dict(regs)}"
              + (f"; wgmma serialized: {notes}" if notes else ""), flush=True)
        fn = ctypes.CDLL(str(so)).flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_flash_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    libs = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, kh, d = 8, 1024, 32, 4, 64
    q, do = (torch.randn(b, s, h, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(b, s, kh, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    delta = torch.empty(b, h, s, device="cuda")
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    ptrs = [x.data_ptr() for x in (q, k, v, out, do, lse, delta, *grads)]
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name, fn in libs.items():
        def call(fn=fn):
            err = fn(*ptrs, b, s, s, h, kh, d, 1, -1, 0, 1,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        call()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            e0.record()
            for _ in range(20):
                call()
            e1.record()
            e1.synchronize()
            runs.append(e0.elapsed_time(e1) / 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        parts = {re.search(r"flash_bwd_\w+", e.key).group(0):
                 (getattr(e, "device_time_total", 0) or e.cuda_time_total) / 5e3
                 for e in prof.key_averages() if "flash_bwd" in e.key}
        print(f"{name}: {statistics.median(runs):.4f} ms a call; "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
