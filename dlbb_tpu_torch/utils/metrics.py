"""Metric summaries and a wall timer (counterpart of
``dlbb_tpu/utils/metrics.py``).

``summarize`` is numpy only; its keys and math are those of the JAX
package's numpy path, which its native stats core is held equal to.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

# every caller can rely on these keys, an empty series included
SUMMARY_KEYS = ("mean", "std", "min", "max", "median", "p95", "p99",
                "p999", "count")


def summarize(values: list[float]) -> dict[str, float]:
    """Summary statistics over a timing series (seconds).  An empty series
    gives NaN values with ``count == 0``."""
    arr = np.asarray(values, dtype=np.float64)
    if arr.size == 0:
        out = {k: float("nan") for k in SUMMARY_KEYS}
        out["count"] = 0
        return out
    return {
        "mean": float(arr.mean()),
        "std": float(arr.std()),
        "min": float(arr.min()),
        "max": float(arr.max()),
        "median": float(np.median(arr)),
        "p95": float(np.percentile(arr, 95)),
        "p99": float(np.percentile(arr, 99)),
        "p999": float(np.percentile(arr, 99.9)),
        "count": int(arr.size),
    }


class Timer:
    """Context-manager wall timer.  With ``sync`` set to a CUDA device it
    waits for that device before stopping the clock (PyTorch returns
    before the device finishes)."""

    def __init__(self, sync: Optional[torch.device] = None) -> None:
        self._sync = torch.device(sync) if sync is not None else None
        self.elapsed: float = float("nan")

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._sync is not None and self._sync.type == "cuda":
            torch.cuda.synchronize(self._sync)
        self.elapsed = time.perf_counter() - self._start
