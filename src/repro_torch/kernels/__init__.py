"""Hand-written CUDA kernels (``csrc/*.cu``, ``sm_90a``) for the serves and
the classifier trials, and the attention of the LM prefill.

Each family has ops.py (the wrapper: checks, dispatch on the tensor's device,
launch counter) and ref.py (the plain PyTorch twin):

* hamming/      packed XOR+popcount search (flat and per bank) and the fused
                per-bank top-1 and top-k
* assoc_matmul/ bipolar {0,1} -> +-1 dot products, plain and banked
* majority/     bitwise strict majority bundling
* sparse/       sparse index-list queries against packed prototypes: full
                distances and the fused per-bank top-1
* flash_attention/ the attention forward of the LM prefill: causal and
                sliding-window GQA with an online softmax

`launch_counts` / `reset_launch_counts` read and clear the wrappers' counters,
which count kernel launches only (never a CPU call of the plain version).
"""
from repro_torch.kernels.assoc_matmul import assoc_matmul, assoc_matmul_banked
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.hamming import (hamming_search, hamming_search_banked,
                                        hamming_topk_banked, hamming_topk_k_banked)
from repro_torch.kernels.majority import majority_bundle
from repro_torch.kernels.sparse import sparse_search, sparse_topk_banked

# kernel name -> the wrapper that launches it and holds its count
WRAPPERS = {
    "hamming_topk_banked": hamming_topk_banked,
    "hamming_search": hamming_search,
    "hamming_topk_k_banked": hamming_topk_k_banked,
    "hamming_search_banked": hamming_search_banked,
    "assoc_matmul": assoc_matmul_banked,
    "majority_bundle": majority_bundle,
    "sparse_search": sparse_search,
    "sparse_topk_banked": sparse_topk_banked,
    "flash_attention_fwd": flash_attention_fwd,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "assoc_matmul", "assoc_matmul_banked", "flash_attention_fwd",
           "hamming_search", "hamming_search_banked", "hamming_topk_banked",
           "hamming_topk_k_banked", "launch_counts", "majority_bundle",
           "reset_launch_counts", "sparse_search", "sparse_topk_banked"]
