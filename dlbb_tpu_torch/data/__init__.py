"""Seeded synthetic inputs (counterpart of ``dlbb_tpu/data``)."""

from dlbb_tpu_torch.data.synthetic import (
    SyntheticEmbeddingDataset,
    batch_slice,
    create_dataset_from_config,
)

__all__ = ["SyntheticEmbeddingDataset", "batch_slice", "create_dataset_from_config"]
