"""Synthetic embedding batches (counterpart of ``dlbb_tpu/data/synthetic.py``).

One fixed, seeded ``[batch, seq_len, hidden]`` batch returned on every
``get_batch()``.  The draw is the JAX package's own
(``np.random.default_rng(seed).standard_normal(..., float32)``), rounded to
the model dtype the same way, so both packages see bit-identical inputs.
Under data parallelism the global batch is drawn the same way and rank
``dp_rank`` of ``dp`` keeps rows ``[dp_rank B/dp, (dp_rank + 1) B/dp)``, the
slice JAX's ``device_put`` gives it under ``batch_spec``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


class SyntheticEmbeddingDataset:
    def __init__(self, batch_size: int, seq_length: int, hidden_size: int,
                 seed: int = 42, dtype: torch.dtype = torch.bfloat16,
                 device="cpu", dp_rank: int = 0, dp: int = 1) -> None:
        if batch_size % dp != 0:
            raise ValueError(f"input.batch_size={batch_size} not divisible by "
                             f"data_parallel={dp}")
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.hidden_size = hidden_size
        self.seed = seed
        host = np.random.default_rng(seed).standard_normal(
            (batch_size, seq_length, hidden_size), dtype=np.float32)
        rows = batch_size // dp
        host = host[dp_rank * rows:(dp_rank + 1) * rows]
        self._batch = torch.from_numpy(host).to(device=device, dtype=dtype)

    def get_batch(self) -> torch.Tensor:
        return self._batch


def create_dataset_from_config(config: dict[str, Any], dtype=torch.bfloat16,
                               device="cpu", hidden_size: Optional[int] = None,
                               seed_offset: int = 0, dp_rank: int = 0,
                               dp: int = 1) -> SyntheticEmbeddingDataset:
    """Build from the YAML ``input:`` + ``model:`` sections;
    ``seed_offset`` derives another batch from the same config (the
    training targets are seed + 1); ``dp_rank``/``dp`` select a dp slice."""
    if hidden_size is None:
        hidden_size = config["model"]["hidden_size"]
    return SyntheticEmbeddingDataset(
        batch_size=config["input"]["batch_size"],
        seq_length=config["input"]["sequence_length"],
        hidden_size=hidden_size,
        seed=config["input"].get("seed", 42) + seed_offset,
        dtype=dtype,
        device=device,
        dp_rank=dp_rank,
        dp=dp,
    )
