from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: F401
