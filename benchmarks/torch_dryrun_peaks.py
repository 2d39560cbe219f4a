#!/usr/bin/env python3
"""What sets the non-dense training peaks: phase 23's runs of chip_smoke.py
(NT_RUNS: Mixtral-8x22B and Kimi-K2 at 1 layer, Zamba2-2.7B whole,
Falcon-Mamba-7B at 16 layers, Whisper-tiny whole, Qwen2-VL-7B at 14
layers; B x 1024 as phase 23 feeds them, AdamW with f32 moments) and phase
16's TinyLlama-1.1B step, each traced once on fake tensors by the dry run
(`repro_torch.launch.dryrun.count_train`, one rank): the predicted peak and
the bytes of each category at it (parameters, moments, batch, and the
temporaries made in the forward, the backward and the update), and the
aten ops that moved the most bytes.

    PYTHONPATH=src python benchmarks/torch_dryrun_peaks.py [--device cpu|cuda] [--json out.json]

Allocates nothing and needs no card: with ``--device cpu`` (the default on
a torch without CUDA) the fake tensors lie on the CPU and stand for the
card (the training path widens the MoE and SSM products to f32 on both
devices)."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def batch_spec(torch, cfg, run: dict, seq: int) -> dict:
    """{name: (global shape, dtype)} of phase 23's batch for ``run``."""
    b, n = run["batch"], run.get("seq", seq)
    out = {"tokens": ((b, n), torch.int32), "targets": ((b, n), torch.int32)}
    if cfg.kind == "encdec":
        out["frames"] = ((b, cfg.enc_seq, cfg.d_model), cfg.dtype)
    elif cfg.kind == "vlm":
        sv = run["grid"][0] * run["grid"][1]
        out["patch_embeds"] = ((b, sv, cfg.d_model), cfg.dtype)
        out["positions"] = ((b, sv + n, 3), torch.int32)
    return out


def main(argv=None) -> int:
    import torch

    import chip_smoke
    from repro_torch import configs
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=dryrun.default_device())
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    notes = dryrun.trace_notes(args.device)
    runs = [(dict(arch=chip_smoke.TRAIN["arch"], batch=chip_smoke.TRAIN["batch"]),
             configs.get_config(chip_smoke.TRAIN["arch"]))]
    runs += [(run, chip_smoke.nt_cfg(run)) for run in chip_smoke.NT_RUNS]
    out = []
    for run, cfg in runs:
        rec = dryrun.count_train(cfg, batch_spec(torch, cfg, run, chip_smoke.NT_SEQ), None,
                                  args.device)
        oc = rec.pop("_oc")
        m = rec["memory_per_rank"]
        gib = {k: v / 2**30 for k, v in m["categories_at_peak"].items()}
        print(f"{run['arch']} ({cfg.n_layers} layers, B {run['batch']}): peak "
              f"{m['peak_bytes'] / 2**30:.2f} GiB; at the peak " + ", ".join(
                  f"{k} {v:.2f}" for k, v in gib.items()) + "; top ops by bytes " + ", ".join(
                  f"{n} {b / 1e9:.3g} GB" for n, _, b in oc.top_ops(4))
              + f"; {rec['t_count_s']:.1f} s to count", flush=True)
        out.append(dict(run=run, layers=cfg.n_layers, peak=m["peak_bytes"],
                        categories=m["categories_at_peak"], top_ops=oc.top_ops(8)))
    if notes:
        print("; ".join(notes))
    if args.json is not None:
        args.json.write_text(json.dumps(dict(traced_on=args.device, runs=out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
