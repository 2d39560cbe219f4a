from repro_torch.kernels.hamming.ops import (  # noqa: F401
    hamming_search, hamming_search_banked, hamming_topk_banked, hamming_topk_k_banked)
