from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    FlashAttention, flash_attention_bwd, flash_attention_fwd)
