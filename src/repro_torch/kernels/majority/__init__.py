from repro_torch.kernels.majority.ops import majority_bundle  # noqa: F401
