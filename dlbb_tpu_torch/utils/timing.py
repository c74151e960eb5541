"""Per-iteration timing (counterpart of the ``per_iter`` regime of
``dlbb_tpu/utils/timing.py``).

On a CUDA device each iteration is bracketed by a pair of
``torch.cuda.Event``s recorded on the current stream, and the device is
synchronised once after the loop: the samples are device times, and the
host runs ahead without waiting between iterations.  On the CPU each
iteration is bracketed by ``time.perf_counter``.  The JAX package's chained
regime exists for a remotely attached TPU and has no counterpart here.
``time_collective`` times one rank's share of a collective, and
``time_fn_per_iter_spmd`` one step of a program that every rank of a
process group runs together.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist


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


# the forced-completion cross-check (the JAX package's per_iter_plausible):
# above this host time per call, a median under this share of it means the
# timed interval missed the op
_PLAUSIBLE_FLOOR_S, _PLAUSIBLE_RATIO = 0.02, 0.2


def time_fn_per_iter_spmd(fn: Callable, *args, iterations: int, device,
                          group) -> tuple[list[float], list[float]]:
    """Time ``fn(*args)``, which every rank of ``group`` runs together,
    ``iterations`` times.  Each iteration is a one-element allreduce over
    ``group`` (the reference's ``comm.Barrier()``, ``run_mpi.py:177``), then
    ``fn`` bracketed by CUDA events on ``cuda`` or ``time.perf_counter`` on
    ``cpu``, then a synchronize.  Returns ``(the slowest rank's time per
    iteration, this rank's)`` in seconds: one step of an SPMD program lasts
    as long as its slowest rank.  The caller warms up first."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    token = torch.zeros(1, device=device)
    local = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    for _ in range(iterations):
        dist.all_reduce(token, group=group)
        if cuda:
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize(device)
            local.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            local.append(time.perf_counter() - t0)
    slowest = torch.tensor(local, dtype=torch.float64, device=device)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=group)
    return slowest.tolist(), local


def time_collective(fn, x, group, warmup: int = 10,
                    iterations: int = 100, device="cpu",
                    max_seconds: Optional[float] = None
                    ) -> tuple[list[float], dict[str, Any]]:
    """Per-iteration timing of a collective ``fn`` (a ``comm.ops.Collective``)
    on payload ``x`` on this rank (counterpart of
    ``dlbb_tpu/utils/timing.py::time_collective`` in its ``per_iter`` mode).

    Each timed iteration is ``fn.prepare(x)``, which refreshes the output
    buffer from the payload (a copy for the in-place ops), a synchronize,
    and then the reference's ``Barrier(); t0; op; t1`` (``collectives/1d/openmpi.py:60-66``):
    a one-element allreduce over ``group``, then ``fn.call`` bracketed by CUDA
    events on ``cuda`` (the op's device time from the moment the barrier
    completes) or by ``time.perf_counter`` on ``cpu``, then a synchronize.
    The warmup and forced-completion calls prepare a fresh buffer too, so
    every call sees the same input.  Every rank of ``group`` calls this with
    the same arguments: each call here is a collective, and the counts must
    agree.

    ``max_seconds`` caps the measurement: after the first warmup call, one
    call's wall time (the slowest rank's) scales the warmup and iteration
    counts down to fit, and the actual counts land in the metadata.  Then,
    as in JAX, three more calls timed on the host to completion give
    ``forced_completion_s``, which the timed median must not undercut
    (``per_iter_plausible``).  Returns ``(seconds per iteration, metadata)``.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    token = torch.zeros(1, device=device)

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(device)

    def wall() -> float:
        buf = fn.prepare(x)
        sync()
        t0 = time.perf_counter()
        fn.call(x, buf)
        sync()
        return time.perf_counter() - t0

    def slowest(seconds: float) -> float:
        t = torch.tensor([seconds], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return float(t.item())

    wall()  # first call: a new communicator is set up here
    warmup_run, clamped = 1, False
    if max_seconds is not None:
        probe = slowest(wall())
        warmup_run += 1
        floor = 1 if 3 * probe > max_seconds else 3
        affordable = max(floor, int(max_seconds / max(probe, 1e-9)))
        if affordable < warmup + iterations:
            clamped = True
            warmup = min(warmup, max(0, affordable // 10))
            iterations = min(iterations, max(floor, affordable - warmup))
    for _ in range(max(0, warmup - warmup_run)):
        wall()
        warmup_run += 1

    samples = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    for _ in range(iterations):
        # the copy ends before the barrier: were the device still copying
        # when the host enqueued the op, the events would hide the op's host
        # cost at large payloads and show it at small ones
        buf = fn.prepare(x)
        sync()
        dist.all_reduce(token, group=group)
        if cuda:
            start.record()
            fn.call(x, buf)
            end.record()
            sync()
            samples.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn.call(x, buf)
            samples.append(time.perf_counter() - t0)

    forced = min(wall() for _ in range(3))
    meta: dict[str, Any] = {
        "timing_mode": "per_iter",
        "timing_method": (
            "output buffer refreshed from the payload and synchronized outside "
            "the events, then barrier, then torch.cuda.Event pair around the "
            "op, synchronize"
            if cuda else
            "output buffer refreshed from the payload outside the timer, then "
            "barrier, then time.perf_counter() around the op"),
        "timing_granularity": "per_iteration",
        "forced_completion_s": forced,
    }
    median = sorted(samples)[len(samples) // 2] if samples else forced
    implausible = forced >= _PLAUSIBLE_FLOOR_S and median < _PLAUSIBLE_RATIO * forced
    if slowest(float(implausible)):  # every rank raises, or none does
        raise RuntimeError(
            f"timed median {median * 1e3:.3f} ms is under {_PLAUSIBLE_RATIO:.0%} "
            f"of one call's completion time {forced * 1e3:.3f} ms on some rank "
            "(this one's shown): the timed interval missed the op")
    if clamped:
        meta.update(measurement_iterations=len(samples),
                    warmup_iterations=warmup_run, time_budget_s=max_seconds,
                    time_budget_clamped=True)
    return samples, meta
