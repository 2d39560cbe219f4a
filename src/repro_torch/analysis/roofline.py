"""Roofline terms at the H100's peaks, and the model-FLOPs yardstick
(counterpart of `repro/analysis/roofline.py`).

Three terms per (arch x cell x mesh), per rank:

    compute    = ops of each kind   / that kind's peak   (summed over kinds)
    memory     = device-memory bytes / HBM_BYTES_PER_S
    collective = wire bytes          / LINK_BYTES_PER_S

The reference reads its FLOPs and bytes from XLA's compiled HLO and its
collective bytes from the HLO text (``collective_bytes``). The port has no
HLO: `analysis.op_cost` counts a call traced on fake tensors, and the wire
bytes come from the collectives' own counter
(`distributed.collectives.wire_bytes_by_op` / ``_by_axis``).

The peaks are the card's (H100 SXM, the datasheet's dense rates). The
kernels' bounds in `chip_smoke.py` and the dry run's roofline read the same
constants, and each kernel family's ``cost()`` gives the (bytes, ops,
kind) both count.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 peak outside the tensor cores
# the 1-bit tensor-core products (mma.sync m16n8k256 and wgmma m64n128k256,
# .b1 .and.popc), counted as 2 operations a bit product like the int8 peak:
# NVIDIA publishes no 1-bit peak, so this is the highest rate
# benchmarks/torch_hamming_b1_probe.py measured on an H100 80GB HBM3 at
# 700 W (the wgmma product from shared memory; about 7.9x the int8 peak)
B1_OPS_PER_S = 15684e12
PEAKS = {"int8": INT8_OPS_PER_S, "b1": B1_OPS_PER_S, "bf16": BF16_FLOPS_PER_S,
         "f32": F32_FLOPS_PER_S}
# The link: NVLink 4 on an H100 SXM, 450 GB/s a direction. One NVLink Switch
# system joins 256 H100s, the (16, 16) mesh, so this one rate stands where
# the reference's single ICI rate does. The (2, 16, 16) mesh's "pod" axis
# crosses between two such systems, as the reference's crosses its DCI
# (src/repro/launch/mesh.py:9-11): its bytes are reported apart in the dry
# run's records (``collective_by_axis``), and the collective term here
# counts them at the same rate, as the reference's counts its DCI bytes.
LINK_BYTES_PER_S = 450e9
HW = {"flops": BF16_FLOPS_PER_S, "hbm": HBM_BYTES_PER_S, "link": LINK_BYTES_PER_S}


def kernel_bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time the card could take
    to move ``nbytes`` and do ``ops`` operations of ``kind``; a kind with no
    peak (gathers, int32 counts) is bound by its bytes."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    if kind not in PEAKS:
        return bytes_s, "bytes"
    ops_s = ops / PEAKS[kind]
    return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s else "operations")


def compute_seconds(ops_by_kind: dict) -> float:
    """Seconds of the compute term: each kind's operations at its peak
    (kinds with no peak count nothing here; their bytes are the memory
    term's)."""
    return sum(n / PEAKS[k] for k, n in ops_by_kind.items() if k in PEAKS)


@dataclasses.dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float, chips: int,
                   ops_by_kind: dict | None = None) -> Roofline:
    """The three terms over ``chips`` cards: ``flops`` at the bf16 peak, or
    ``ops_by_kind`` each at its own peak (`compute_seconds`) when given."""
    compute = (flops / HW["flops"] if ops_by_kind is None
               else compute_seconds(ops_by_kind))
    return Roofline(
        compute_s=compute / chips,
        memory_s=bytes_accessed / (chips * HW["hbm"]),
        collective_s=coll_bytes / (chips * HW["link"]),
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the "useful FLOPs" yardstick)
# ---------------------------------------------------------------------------

def active_params(cfg, total_params: int) -> int:
    """Parameters touched per token (MoE: routed top-k + shared only)."""
    if cfg.moe is None:
        return total_params
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_expert
    inactive = cfg.n_layers * (m.n_experts - m.top_k) * per_expert
    return total_params - inactive


def model_flops(cfg, cell, total_params: int) -> float:
    """6·N·D (train), 2·N_active·D (prefill), 2·N_active·B (decode)."""
    n_act = active_params(cfg, total_params)
    if cell.kind == "train":
        return 6.0 * n_act * cell.batch * cell.seq  # N_active == N for dense
    if cell.kind == "prefill":
        return 2.0 * n_act * cell.batch * cell.seq
    return 2.0 * n_act * cell.batch  # decode: one token per sequence
