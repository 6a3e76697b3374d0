from repro_torch.data.pipeline import DataConfig, PrefetchIterator, make_batch  # noqa: F401
