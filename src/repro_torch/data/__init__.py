from repro_torch.data.pipeline import DataConfig, SyntheticLMData  # noqa: F401
