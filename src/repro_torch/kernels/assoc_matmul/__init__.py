from repro_torch.kernels.assoc_matmul.ops import assoc_matmul, assoc_matmul_banked  # noqa: F401
