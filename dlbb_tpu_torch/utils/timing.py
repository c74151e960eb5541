"""Per-iteration timing (counterpart of the ``per_iter`` regime of
``dlbb_tpu/utils/timing.py``).

On a CUDA device each iteration is bracketed by a pair of
``torch.cuda.Event``s recorded on the current stream, and the device is
synchronised once after the loop: the samples are device times, and the
host runs ahead without waiting between iterations.  On the CPU each
iteration is bracketed by ``time.perf_counter``.  The JAX package's chained
regime exists for a remotely attached TPU and has no counterpart here.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def time_fn_per_iter(fn: Callable, *args, iterations: int,
                     device) -> list[float]:
    """Run ``fn(*args)`` ``iterations`` times, each timed; returns the
    samples in seconds.  The caller warms up first."""
    device = torch.device(device)
    if device.type != "cuda":
        out = []
        for _ in range(iterations):
            t0 = time.perf_counter()
            fn(*args)
            out.append(time.perf_counter() - t0)
        return out
    with torch.cuda.device(device):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(iterations)]
        torch.cuda.synchronize()
        for start, end in pairs:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize()
    return [start.elapsed_time(end) / 1e3 for start, end in pairs]
