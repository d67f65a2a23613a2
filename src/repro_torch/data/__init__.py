from repro_torch.data.pipeline import (
    DataConfig, Prefetcher, SyntheticLMDataset, batch_to, make_batch_iterator,
)

__all__ = ["DataConfig", "SyntheticLMDataset", "Prefetcher", "batch_to", "make_batch_iterator"]
