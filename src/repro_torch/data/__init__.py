from repro_torch.data.pipeline import DataConfig, SyntheticPackedDataset  # noqa
