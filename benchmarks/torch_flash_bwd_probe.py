#!/usr/bin/env python3
"""Build-and-check probe of the attention backward kernel on one H100.

    python3 benchmarks/torch_flash_bwd_probe.py

Builds the port's kernels (`repro_torch.kernels._build`) and prints ptxas'
registers and spills of the forward and backward attention kernels; then,
at ten shapes (f32 and bf16, D 16-256, GQA, windows, non-causal, q_offset,
rows that see no key), runs the forward kernel with its log-sum-exp and the
backward kernel against their plain twins: the lse's largest difference,
kernel vs twin for dq, dk, dv, and for bf16 kernel and twin each against
an f64 computation (ok when the kernel is no further off than 1.5x the
twin), and for bf16 the kernel against the twin in its own arithmetic
(``p_bf16=2``) as the worst share of chip_smoke's allowance; f32 ok within
atol = rtol = 1e-5. Last, at the training shape (B 8, S 1024, 32 heads over
4, D 64, causal, bf16) whether two backward launches give the same bits,
the device time of each of the backward's kernels (torch.profiler over 5
calls), and the mean time of 10 calls by CUDA events of the backward
kernel, the forward with and without the lse, and the backward of autograd
through F.scaled_dot_product_attention.
Needs a CUDA device.
"""
from __future__ import annotations

import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import (flash_bwd_exact, flash_bwd_ref,
                                                       flash_fwd_ref)

    t0 = time.time()
    lib = _build.build()
    print("build", time.time() - t0, flush=True)
    cur = None
    for line in (lib.parent / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1) if "flash_bwd" in m.group(1) or "flash_fwd" in m.group(1) else None
        elif "wgmma" in line or "arning" in line:       # ptxas' wgmma serialization notes
            print(line.strip()[:300])
        elif cur and ("Used" in line or "spill" in line):
            print(re.sub(r"^_ZN\w*?_GLOBAL__N_\w*?\d+(?=flash_)", "", cur)[:48], line.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(2, 256, 256, 4, 2, 64, True, -1, 0, torch.float32),
             (2, 300, 300, 4, 2, 16, True, -1, 0, torch.bfloat16),
             (2, 300, 300, 4, 2, 32, True, -1, 0, torch.bfloat16),
             (2, 512, 512, 32, 4, 64, True, -1, 0, torch.bfloat16),
             (1, 1024, 1024, 4, 1, 256, True, 512, 0, torch.bfloat16),
             (1, 256, 256, 56, 8, 128, True, -1, 0, torch.bfloat16),
             (2, 200, 200, 4, 2, 64, False, -1, 0, torch.bfloat16),
             (2, 128, 128, 4, 2, 64, True, -1, -64, torch.bfloat16),
             (2, 100, 100, 4, 2, 32, True, 24, 0, torch.float32),
             (2, 128, 128, 4, 2, 64, True, -1, -64, torch.float32)]
    for (b, sq, skv, h, kh, d, causal, win, off, dt) in cases:
        q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, skv, kh, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, skv, kh, d, generator=g, device="cuda").to(dt)
        do = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dt)
        kw = dict(causal=causal, window=win, q_offset=off)
        out, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
        _, lse_t = flash_fwd_ref(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        lerr = float((lse - lse_t).abs().max())
        got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = flash_bwd_ref(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        errs = [float((a.double() - b.double()).abs().max()) for a, b in zip(got, want)]
        line = (f"{(b, sq, skv, h, kh, d, causal, win, off, str(dt))}: lse err {lerr:.3g} "
                f"kernel-vs-twin {['%.3g' % e for e in errs]}")
        if dt == torch.bfloat16:
            ex = flash_bwd_exact(q, k, v, do, causal=causal, window=win, q_offset=off)
            ek = [float((a.double() - e).abs().max()) for a, e in zip(got, ex)]
            et = [float((a.double() - e).abs().max()) for a, e in zip(want, ex)]
            split = flash_bwd_ref(q, k, v, out, lse, do, p_bf16=2, **kw)
            share = [float(((a.double() - b.double()).abs() / (
                2.0 ** -7 * b.double().abs() + 2.0 ** -12 * float(b.double().abs().max()))).max())
                for a, b in zip(got, split)]
            line += (f" vs f64 kernel {['%.3g' % e for e in ek]} twin {['%.3g' % e for e in et]}"
                     f" vs split twin {['%.3g' % e for e in share]}"
                     f" ok={all(a <= 1.5 * t for a, t in zip(ek, et)) and max(share) <= 1}")
        else:
            line += (" ok=" + str(all(torch.allclose(a, b, atol=1e-5, rtol=1e-5)
                                      for a, b in zip(got, want))))
        print(line, flush=True)

    b, s, h, kh, d = 8, 1024, 32, 4, 64
    q = torch.randn(b, s, h, d, generator=g, device="cuda").bfloat16()
    k = torch.randn(b, s, kh, d, generator=g, device="cuda").bfloat16()
    v = torch.randn(b, s, kh, d, generator=g, device="cuda").bfloat16()
    do = torch.randn(b, s, h, d, generator=g, device="cuda").bfloat16()
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)

    def tm(fn, n=10):
        fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / n

    one, two = (flash_attention_bwd(q, k, v, out, lse, do) for _ in range(2))
    print("two launches bit-identical:", all(torch.equal(a, b) for a, b in zip(one, two)))
    print("bwd kernel ms", tm(lambda: flash_attention_bwd(q, k, v, out, lse, do)))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if "flash_bwd" in e.key and dev:
            print(f"profile {e.key[:60]}: {dev / 5 / 1e3:.4f} ms a backward call "
                  f"({e.count // 5} launches)")
    print("fwd+lse kernel ms", tm(lambda: flash_attention_fwd(q, k, v, return_lse=True)),
          "fwd ms", tm(lambda: flash_attention_fwd(q, k, v)))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    print("sdpa bwd ms", tm(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
