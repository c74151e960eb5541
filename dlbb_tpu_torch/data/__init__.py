"""Seeded synthetic inputs (counterpart of ``dlbb_tpu/data``)."""

from dlbb_tpu_torch.data.synthetic import (
    SyntheticEmbeddingDataset,
    batch_slice,
    create_dataset_from_config,
    prompt_token_ids,
    request_embeddings,
    token_embedding_table,
)

__all__ = ["SyntheticEmbeddingDataset", "batch_slice", "create_dataset_from_config",
           "prompt_token_ids", "request_embeddings", "token_embedding_table"]
