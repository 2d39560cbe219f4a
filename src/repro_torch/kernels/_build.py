"""Build and load the port's CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` source is compiled by its own ``nvcc``
process, all started together, for ``sm_90a`` and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use into ``build/kernels/<hash>/`` at the repository root (git-ignored),
keyed by a hash of the sources and flags, so an unchanged tree reuses it.
Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("hamming.cu", "assoc_matmul.cu", "majority.cu", "sparse.cu",
           "flash_attention.cu", "flash_attention_bwd.cu")
HEADERS = ("flash_mma.cuh",)        # included by sources; part of the build's hash
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argtypes; every entry returns cudaGetLastError() as int
SIGNATURES = {
    # q, protos, dist, idx, split scratch dist and idx, G, B, C, W, c_real,
    # query tile, splits, stream
    "hamming_topk_banked_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, protos, dist, idx, split scratch dist and idx, G, B, C, W, c_real, k,
    # splits, stream
    "hamming_topk_k_banked_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, protos, out, G, B, C, W, stream (G = 1: the unbanked search)
    "hamming_search_banked_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    # q, protos, out, G, B, C, K, stream
    "assoc_matmul_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    # hvs, out, M, N, stream
    "majority_bundle_launch": [_P, _P, _I, _I, _P],
    # q, protos, out, B, C, W, K, then the plan: qpw, wseg, stride, splits; stream
    "sparse_search_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, protos, dist, idx, G, B, C, W, K, c_real, then the plan: qpw, wseg, stride; stream
    "sparse_topk_banked_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, lse (or null), B, Sq, Skv, H, KH, D, causal, window, q_offset,
    # bf16, stream
    "flash_attention_fwd_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _P],
    # q, k, v, out, dout, lse, delta scratch, dq, dk, dv, B, Sq, Skv, H, KH, D,
    # causal, window, q_offset, bf16, stream
    "flash_attention_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the build in this process


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME, "
                           "/usr/local/cuda); the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (one nvcc each, in parallel) and link the shared
    library; returns its path. Reuses an earlier build of the same sources.
    The compiler's output, ptxas register and shared-memory report included,
    is kept in ``build.log`` beside the library."""
    global build_seconds
    out = BUILD_ROOT / _digest()
    lib = out / "librepro_torch_kernels.so"
    if lib.exists():
        if build_seconds is None:        # built by an earlier process
            build_seconds = 0.0
        return lib
    t0 = time.perf_counter()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = out / (Path(name).stem + f".{os.getpid()}.o")
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs, failed = [], [], []
    for name, obj, p in procs:
        text, _ = p.communicate()
        log.append(f"== {name} (rc {p.returncode})\n{text}")
        objs.append(str(obj))
        if p.returncode != 0:
            failed.append(name)
    if not failed:
        tmp = out / f"lib.{os.getpid()}.so"
        p = subprocess.run([nvcc, *ARCH, "-shared", *objs, "-o", str(tmp)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        log.append(f"== link (rc {p.returncode})\n{p.stdout}")
        if p.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append("link")
    (out / "build.log").write_text("\n".join(log))
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(entry: str, *args) -> None:
    """Call C entry `entry` on PyTorch's current stream; raise if the launch
    was refused (the entry returns ``cudaGetLastError()``)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
