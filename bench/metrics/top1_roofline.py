"""top1_roofline: the top-1 kernels' least time over their measured time
(%), a step. The least time is max(bytes / HBM rate, 1-bit operations /
peak) of the step's search shape (`yardstick.cost.topk_cost`,
`yardstick.peaks`); the measured time the top-1 kernels' device seconds of
the profiled steps, by name (kernels layer)."""
from bench.yardstick.cost import topk_cost
from bench.yardstick.peaks import least_seconds

KERNELS = ("hamming_top1_kernel", "top1_merge_kernel")


def read(ctx):
    t, shape = ctx.trace, ctx.shapes.get("top1")
    if t is None or shape is None:
        return None
    measured = t.op_seconds(*KERNELS) / t.steps if t.steps else 0.0
    if measured <= 0:
        return None
    least, _ = least_seconds(*topk_cost(**shape))
    return 100.0 * least / measured
