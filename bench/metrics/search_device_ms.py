"""search_device_ms: device ms a step in the port's top-1 kernels, found by
name, over the profiled steps (multi-tenant serve layer)."""

KERNELS = ("hamming_top1_kernel", "top1_merge_kernel")


def read(ctx):
    t = ctx.trace
    s = 0.0 if t is None else t.op_seconds(*KERNELS)
    return s / t.steps * 1e3 if s > 0 else None
