from repro_torch.kernels.flash_attention.ops import flash_attention_fwd  # noqa: F401
