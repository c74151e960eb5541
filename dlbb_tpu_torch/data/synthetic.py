"""Synthetic embedding batches (counterpart of ``dlbb_tpu/data/synthetic.py``).

One fixed, seeded ``[batch, seq_len, hidden]`` batch returned on every
``get_batch()``.  The draw is the JAX package's own
(``np.random.default_rng(seed).standard_normal(..., float32)``), rounded to
the model dtype the same way, so both packages see bit-identical inputs.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


class SyntheticEmbeddingDataset:
    def __init__(self, batch_size: int, seq_length: int, hidden_size: int,
                 seed: int = 42, dtype: torch.dtype = torch.bfloat16,
                 device="cpu") -> None:
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.hidden_size = hidden_size
        self.seed = seed
        host = np.random.default_rng(seed).standard_normal(
            (batch_size, seq_length, hidden_size), dtype=np.float32)
        self._batch = torch.from_numpy(host).to(device=device, dtype=dtype)

    def get_batch(self) -> torch.Tensor:
        return self._batch


def create_dataset_from_config(config: dict[str, Any], dtype=torch.bfloat16,
                               device="cpu", hidden_size: Optional[int] = None,
                               seed_offset: int = 0) -> SyntheticEmbeddingDataset:
    """Build from the YAML ``input:`` + ``model:`` sections;
    ``seed_offset`` derives another batch from the same config (the
    training targets are seed + 1)."""
    if hidden_size is None:
        hidden_size = config["model"]["hidden_size"]
    return SyntheticEmbeddingDataset(
        batch_size=config["input"]["batch_size"],
        seq_length=config["input"]["sequence_length"],
        hidden_size=hidden_size,
        seed=config["input"].get("seed", 42) + seed_offset,
        dtype=dtype,
        device=device,
    )
