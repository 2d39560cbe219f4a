"""Fault-tolerant checkpointing: atomic, checksummed, keep-k (counterpart of
`repro/checkpoint/ckpt.py`, in its layout).

Layout: <dir>/step_<k>/ -- one .npy per leaf of the tree (path-flattened
names, "/" joined and written as "__") plus a manifest.json holding each
leaf's path, file, shape, dtype and CRC32 and the caller's ``extra`` (the
data pipeline's step). Writes go to <dir>/.tmp_step_<k> and are
os.replace'd into place, so a killed writer never leaves a half-checkpoint
that restore would pick up; ``keep`` prunes old steps after a commit.

Restore is defensive: a missing or corrupt manifest, a leaf file that is
absent, truncated or bit-flipped (checksum mismatch), or a shape or dtype
drift against the manifest all raise `CheckpointError` naming the step and
leaf, and `all_steps` lists only directories with a committed manifest.

bf16 leaves are written as the reference writes them: their raw 16-bit words
under the numpy header descr '<V2' (what ``np.save`` writes for ml_dtypes'
bfloat16) and manifest dtype "bfloat16", so the files are the reference's
byte for byte; they restore bit for bit, here and from the reference (numpy
without ml_dtypes reads them as 2-byte voids). The reference's own restore
compares that void dtype with "bfloat16" and refuses its bf16 leaves
(ROADMAP §3, Reference, not port).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.tree import tree_flatten, tree_unflatten

BF16_DESCR = "<V2"


class CheckpointError(RuntimeError):
    """A checkpoint is unreadable: missing, truncated, corrupt or mismatched.

    Carries a message naming the step and leaf; callers that keep several
    steps catch this and fall back to an earlier one.
    """


def _paths(tree: Any) -> list[tuple[str, Any]]:
    return [("/".join(str(k) for k in path), leaf) for path, leaf in tree_flatten(tree)]


def _write_leaf(fpath: str, t: torch.Tensor) -> tuple[list, str]:
    """Write one tensor as .npy; returns (shape, manifest dtype)."""
    t = t.detach().cpu().contiguous()
    with open(fpath, "wb") as f:
        if t.dtype == torch.bfloat16:
            np.lib.format.write_array_header_1_0(
                f, {"descr": BF16_DESCR, "fortran_order": False, "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
            return list(t.shape), "bfloat16"
        arr = t.numpy()
        np.save(f, arr)
        return list(arr.shape), str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any, extra: dict | None = None,
                    keep: int = 3) -> str:
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):  # leftover from a killed writer -- never committed
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for path, leaf in _paths(tree):
        fname = path.replace("/", "__") + ".npy"
        fpath = os.path.join(tmp, fname)
        shape, dtype = _write_leaf(fpath, leaf)
        with open(fpath, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["leaves"].append({"path": path, "file": fname, "shape": shape,
                                   "dtype": dtype, "crc32": crc})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return max(steps) if steps else None


def _load_manifest(path: str, step: int) -> dict:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.isdir(path) or not os.path.exists(mpath):
        raise CheckpointError(f"no committed checkpoint at step {step}: {path}")
    try:
        with open(mpath) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(
            f"checkpoint step {step}: manifest.json unreadable ({e})") from e


def _load_leaf(path: str, step: int, entry: dict) -> torch.Tensor:
    """One leaf as a CPU tensor, verified against its manifest record before
    it is trusted."""
    fpath = os.path.join(path, entry["file"])
    if not os.path.exists(fpath):
        raise CheckpointError(f"checkpoint step {step}: leaf {entry['path']!r} file missing "
                              f"({entry['file']})")
    with open(fpath, "rb") as f:
        data = f.read()
    crc = entry.get("crc32")  # pre-checksum checkpoints: skip the CRC gate
    if crc is not None and zlib.crc32(data) != crc:
        raise CheckpointError(
            f"checkpoint step {step}: leaf {entry['path']!r} is corrupt "
            f"(CRC mismatch -- truncated or bit-flipped {entry['file']})")
    try:
        arr = np.load(fpath)
    except (ValueError, OSError, EOFError) as e:    # np.load's parse failures
        raise CheckpointError(f"checkpoint step {step}: leaf {entry['path']!r} failed to "
                              f"parse ({e})") from e
    bf16 = entry["dtype"] == "bfloat16" and arr.dtype.kind == "V" and arr.dtype.itemsize == 2
    dtype = "bfloat16" if bf16 else str(arr.dtype)
    if list(arr.shape) != entry["shape"] or dtype != entry["dtype"]:
        raise CheckpointError(
            f"checkpoint step {step}: leaf {entry['path']!r} is {arr.shape} {arr.dtype}, "
            f"manifest says {tuple(entry['shape'])} {entry['dtype']}")
    arr = arr.copy(order="C")       # a 0-dim leaf stays 0-dim
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, step: int, like: Any, device="cuda"):
    """Restore into the structure of ``like`` (a tree whose leaves may be
    tensors of any device, meta included: only the structure is read), each
    leaf on ``device`` (the card unless the caller asks for another; raises
    without CUDA). Returns (tree, extra). Raises `CheckpointError` when the
    checkpoint is missing, truncated, corrupt, or does not cover ``like``'s
    leaves."""
    dev = resolve(device)
    path = os.path.join(directory, f"step_{step}")
    manifest = _load_manifest(path, step)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    paths = [p for p, _ in _paths(like)]
    missing = [p for p in paths if p not in by_path]
    if missing:
        raise CheckpointError(f"checkpoint step {step} does not cover the requested "
                              f"structure; missing leaves: {missing}")
    loaded = [_load_leaf(path, step, by_path[p]).to(dev) for p in paths]
    return tree_unflatten(like, loaded), manifest["extra"]
