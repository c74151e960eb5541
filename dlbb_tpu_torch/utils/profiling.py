"""Tracing and profiling (counterpart of ``dlbb_tpu/utils/profiling.py``),
over ``torch.profiler``.

- ``maybe_trace(trace_dir)`` — traces the block into
  ``trace_dir/perfetto_trace.json.gz`` (Kineto's chrome trace, gzipped,
  under JAX's name, so ``obs devtrace`` reads it as it reads a capture); a
  no-op when ``trace_dir`` is None/empty and ``DLBB_TRACE_DIR`` is unset.
  Its activities come from the device: CPU on a CPU run, CPU and CUDA on
  the card; on a rank of a process group of several, ``rank_trace_dir``
  gives each rank its own ``rank<r>/``.  JAX's xplane output has no
  counterpart.
- ``annotate(name)`` — a named host region (``record_function``), visible
  on the host and, on the card, on the GPU timeline.
- ``step_annotation(name, step)`` — a per-step region (``name#step``).

This module and ``obs/capture.py`` are the port's only profiler homes;
``utils/timing.py`` imports neither, so no profiler call sits inside a
timed region (``tests/test_torch_imports.py`` pins it).
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Iterator, Optional

import torch

__all__ = ["maybe_trace", "annotate", "step_annotation", "default_trace_dir",
           "rank_trace_dir", "TRACE_FILE", "profiler_active", "profile_session"]

# the trace file of a trace directory: JAX's perfetto file name
TRACE_FILE = "perfetto_trace.json.gz"
# the trace-level key naming the device a trace ran on (obs/devtrace.py
# reads it: a CUDA run's CPU ops are never device events)
DEVICE_KEY = "dlbb_device"
# the launches a session on the card makes of its own before and after its
# work, each batch inside a ``warmup`` annotation, which obs/devtrace.py
# excludes: on the H100 (torch 2.11.0+cu128), once a process has run the 3D
# sweeps at 1 GiB per rank, a session loses the records of its first one to
# five launches, now and then of its last two
# (scripts/torch_trace_probe.py), so these are the ones it loses
GUARD_LAUNCHES = 10
GUARD_ANNOTATION = "warmup"


def default_trace_dir() -> Optional[str]:
    """The env-switched default (``DLBB_TRACE_DIR``), or None."""
    return os.environ.get("DLBB_TRACE_DIR") or None


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` session is already running in this
    process (a second one inside it is JAX's "broken profiler" case)."""
    return bool(torch._C._autograd._profiler_enabled())


@contextlib.contextmanager
def profile_session(device: torch.device, path: "str | Path") -> Iterator[None]:
    """One ``torch.profiler`` session over the block, written to ``path``
    (gzipped Kineto chrome trace, marked with the device); on the card it
    makes launches of its own before and after the block
    (``GUARD_LAUNCHES``).  Raises
    ``RuntimeError`` when a session is already running."""
    from torch.profiler import ProfilerActivity, profile

    if profiler_active():
        raise RuntimeError("a torch.profiler session is already active in this process "
                           "(an outer --trace session holds the profiler)")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, record_shapes=False, with_stack=False) as prof:
        prof.add_metadata(DEVICE_KEY, device.type)
        _guard_launches(device)
        yield
        _guard_launches(device)
    prof.export_chrome_trace(str(path))


def _guard_launches(device: torch.device) -> None:
    """On the card: ``GUARD_LAUNCHES`` one-element fills back to back inside
    a ``GUARD_ANNOTATION`` window, between two synchronisations."""
    if device.type != "cuda":
        return
    torch.cuda.synchronize(device)
    with annotate(GUARD_ANNOTATION):
        guard = torch.empty(1, device=device)
        for _ in range(GUARD_LAUNCHES):
            guard.fill_(0)
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str] = None,
                device=None) -> Iterator[Optional[str]]:
    """Trace everything inside the block to ``trace_dir``.

    ``trace_dir=None`` falls back to ``DLBB_TRACE_DIR``; with neither, the
    block runs untraced at no cost.  ``device`` is ``cuda`` unless the
    caller names ``cpu``.  Yields the resolved trace directory (or None)."""
    trace_dir = trace_dir or default_trace_dir()
    if not trace_dir:
        yield None
        return
    from dlbb_tpu_torch.utils.sysinfo import resolve_device

    os.makedirs(trace_dir, exist_ok=True)
    with profile_session(resolve_device(device), Path(trace_dir) / TRACE_FILE):
        yield trace_dir


def rank_trace_dir(trace_dir: Optional[str] = None) -> Optional[str]:
    """This process's trace directory for ``maybe_trace``: ``trace_dir``
    (else ``DLBB_TRACE_DIR``) itself, or its ``rank<r>/`` on a rank of a
    process group of several, so that every rank writes its own trace."""
    import torch.distributed as dist

    trace_dir = trace_dir or default_trace_dir()
    if trace_dir and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return os.path.join(trace_dir, f"rank{dist.get_rank()}")
    return trace_dir


def annotate(name: str):
    """A named host region, visible in the trace timeline."""
    return torch.profiler.record_function(name)


def step_annotation(name: str, step: int):
    """A per-step region (JAX's ``StepTraceAnnotation``)."""
    return torch.profiler.record_function(f"{name}#{step}")
