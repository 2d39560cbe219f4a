"""Operations and bytes of the port's kernels, from their shapes (frozen
copies of each kernel family's ``cost()``)."""
from __future__ import annotations


def topk_cost(g: int, b: int, c_real: int, w: int, k: int = 1,
              table_rows: int | None = None) -> tuple[int, int, str]:
    """(bytes, operations, kind) of the fused per-bank top-1 (k = 1) or
    top-k Hamming search of g banks of b queries over c_real classes of w
    words (`repro_torch.kernels.hamming.ops.topk_cost`): the queries and the
    classes read once, k (distance, index) pairs a query written; with
    ``table_rows`` (T) the banks are rows of a [T, C, W] table, whose T *
    c_real classes and the g row ids are read instead. 2 operations a bit
    product (AND + popcount on the 1-bit tensor cores)."""
    classes = g * c_real if table_rows is None else table_rows * c_real
    extra = 0 if table_rows is None else 4 * g
    return (4 * (g * b + classes) * w + extra + 8 * g * b * k, 2 * g * b * c_real * 32 * w,
            "b1")
