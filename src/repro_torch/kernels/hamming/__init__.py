from repro_torch.kernels.hamming.ops import hamming_search, hamming_topk_banked  # noqa: F401
