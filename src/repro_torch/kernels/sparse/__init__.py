from repro_torch.kernels.sparse.ops import sparse_search, sparse_topk_banked  # noqa: F401
