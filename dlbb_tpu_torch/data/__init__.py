"""Seeded synthetic inputs (counterpart of ``dlbb_tpu/data``)."""

from dlbb_tpu_torch.data.synthetic import (
    SyntheticEmbeddingDataset,
    create_dataset_from_config,
)

__all__ = ["SyntheticEmbeddingDataset", "create_dataset_from_config"]
