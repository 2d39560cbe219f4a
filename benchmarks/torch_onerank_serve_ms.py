"""Host ms a call and device ops a call of the one-rank HDC serves on the GPU.

Times the serve modes of `chip_smoke.py` phases 4-5 (the OTA serve on bsc,
baseline and permuted, and on ideal, unpacked and packed; the wired serve)
at the paper's configuration (`ScaleOutConfig`'s defaults: C = 6400, d =
512, M = 3, 64 RX cores, B = 256) for whichever `repro_torch` comes first
on ``sys.path``, so two trees are compared by running this script once with
each on ``PYTHONPATH``, back to back on one machine:

    PYTHONPATH=src python benchmarks/torch_onerank_serve_ms.py --label change

Each mode: WARM calls, then CALLS calls on the host clock, each ending in a
synchronize (the median is printed), then PROFILED calls under
`torch.profiler`, whose CUDA kernel and memcpy/memset events give the
device ops a call. Prints one JSON line {"label", "card", "modes": {mode:
{"ms": [...], "median_ms", "device_ops"}}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

WARM, CALLS, PROFILED = 20, 200, 5
MODES = ([("ota", ch, perm, rep) for ch, perm in (("bsc", False), ("bsc", True), ("ideal", False))
          for rep in ("unpacked", "packed")]
         + [("wired", "bsc", False, rep) for rep in ("unpacked", "packed")])


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def device_ops(torch, call, n: int) -> float | None:
    """Device events (kernels, copies, sets) a call over ``n`` profiled
    calls; None when the profiler records no device event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(events) / n if events else None


def main() -> int:
    import torch

    from repro_torch.core import classifier, hypervector as hv, scaleout

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True, help="the tree's name in the output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_onerank_serve_ms: no CUDA device")
    base = scaleout.ScaleOutConfig()
    state = scaleout.precharacterize_state(base, device="cuda")
    protos_u = classifier.make_codebook(
        torch.Generator(device="cuda").manual_seed(0),
        classifier.HDCTaskConfig(n_classes=base.n_classes, dim=base.dim), device="cuda")
    out = {}
    for kind, ch, perm, rep in MODES:
        cfg = dataclasses.replace(base, channel=ch, permuted=perm, representation=rep)
        make = scaleout.make_ota_serve if kind == "ota" else scaleout.make_wired_serve
        serve = make(cfg, device="cuda")
        protos = hv.pack(protos_u) if cfg.packed else protos_u
        _, q = scaleout.make_queries(torch.Generator(device="cuda").manual_seed(1), cfg, protos_u)
        gen = torch.Generator(device="cuda").manual_seed(2)
        call = lambda: serve(protos, q, state, gen)        # noqa: E731
        for _ in range(WARM):
            call()
        torch.cuda.synchronize()
        ms = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        label = (f"ota {ch} {'permuted' if perm else 'baseline'} {rep}" if kind == "ota"
                 else f"wired {rep}")
        out[label] = dict(ms=ms, median_ms=statistics.median(ms),
                          device_ops=device_ops(torch, call, PROFILED))
    print(json.dumps(dict(label=args.label, card=card_line(), modes=out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
