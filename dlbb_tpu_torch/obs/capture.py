"""Gated per-config device-trace capture (counterpart of
``dlbb_tpu/obs/capture.py``), over ``torch.profiler``.

JAX's contract:

- captures run on DEDICATED profile reps, separate calls of the unit's
  program, never appended to the timing series the stats summarise (a
  traced sweep's artifacts equal an untraced run's in every stats field);
- captures run strictly after the timed region and outside the
  measurement gate, on a fresh payload;
- a capture failure is contained: an ``error`` field in the metadata,
  never a failed config (the sweep counts it in
  ``obs_device_capture_failures_total``).  A profiler session already
  running in the process (an outer ``--trace``) is such a failure, and so
  is a trace that holds no device event (``obs/devtrace.py``'s rule: on
  the card, CUPTI gave no kernel), which fails closed here already.  The
  port's metadata adds ``device_records``, the trace's census of device
  records (``obs/devtrace.py::parse_capture_census``: found, placed
  outside the reps' window, launches of the work that left none), so that a
  capture without device events says whether its records were absent or
  excluded, and ``attempts``: on the card a session whose work left a
  launch unrecorded is taken again after a pause, up to
  ``CAPTURE_ATTEMPTS`` sessions.

Each rank of the mesh runs the reps (their collectives would deadlock
otherwise) and writes its own Kineto chrome trace, gzipped, under JAX's
file name: ``<trace_root>/<label>/rank<r>/perfetto_trace.json.gz``.  Every
verdict the ranks must share (whether to run the reps, whether the capture
failed) is taken over the mesh before any rep's collective, so no rank is
left inside one; rank 0's metadata lists every rank's file
(``rank_traces``).  JAX also keeps the raw ``.xplane.pb`` files
(``xplane_files``); the port has no counterpart of them.
"""

from __future__ import annotations

import os
import re
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from dlbb_tpu_torch.obs.devtrace import CaptureError, parse_capture_census
from dlbb_tpu_torch.utils.profiling import TRACE_FILE, annotate, profile_session, \
    profiler_active

CAPTURE_META_SCHEMA = "dlbb_device_capture_v1"

ENV_VAR = "DLBB_DEVICE_TRACE"

# the sessions a capture may take on the card while its work leaves a
# launch unrecorded, each retake after a pause of this many seconds times
# the sessions taken: on the H100 a session now and then loses every
# record, and sessions taken at once after it can lose theirs too
# (scripts/torch_trace_probe.py)
CAPTURE_ATTEMPTS = 3
CAPTURE_RETRY_PAUSE_S = 0.5


def default_capture_dir() -> Optional[str]:
    """Env-switched default (``DLBB_DEVICE_TRACE=dir``), or None."""
    return os.environ.get(ENV_VAR) or None


def _slug(label: str) -> str:
    return re.sub(r"[^\w.+-]+", "_", label).strip("_") or "capture"


def _dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _any_rank(failed: bool, group, device: torch.device) -> bool:
    """Whether any rank of ``group`` failed (every rank learns it)."""
    if group is None or dist.get_world_size(group) == 1:
        return failed
    dev = device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    t = torch.tensor([int(failed)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def capture_device_trace(
    fn: Callable,
    payload_builder: Callable[[], Any],
    trace_root: "str | Path",
    label: str,
    profile_reps: int = 1,
    *,
    group=None,
    device=None,
) -> dict[str, Any]:
    """Run ``profile_reps`` dedicated calls of ``fn`` on a freshly built
    payload under a ``profile_rep:<label>`` annotation inside one
    ``torch.profiler`` session, written to ``trace_root/<label>/rank<r>/``.
    ``group`` is the mesh's process group (None: this process alone) and
    ``device`` the device ``fn`` runs on (``cuda`` unless ``cpu`` is named).
    Returns the capture metadata (JAX's keys); the reps' timings are never
    returned."""
    dev = torch.device(device if device is not None else "cuda")
    rank = dist.get_rank() if group is not None and dist.is_initialized() else 0
    trace_dir = Path(trace_root) / _slug(label)
    path = trace_dir / f"rank{rank}" / TRACE_FILE
    meta: dict[str, Any] = {
        "schema": CAPTURE_META_SCHEMA,
        "label": label,
        "trace_dir": str(trace_dir),
        "profile_reps": int(profile_reps),
        # the marker consumers key on: these reps are outside the
        # measurement series by construction
        "excluded_from_stats": True,
    }
    t0 = time.perf_counter()
    error: Optional[BaseException] = None
    x = None
    try:
        # a fresh payload: the measured one may be cached for later configs
        x = payload_builder()
        if dev.type == "cuda":
            # comm-lint: disable=host-sync-in-timed-region  the span is the capture's own cost; the sync keeps the payload's work out of the reps
            torch.cuda.synchronize(dev)  # no payload work inside the reps' window
        path.parent.mkdir(parents=True, exist_ok=True)
        if profiler_active():
            raise RuntimeError("a torch.profiler session is already active in this "
                               "process (an outer --trace session holds the profiler)")
    except Exception as e:  # noqa: BLE001 — capture must not fail a config
        error = e
    if _any_rank(error is not None, group, dev):
        error = error or RuntimeError("the capture could not start on another rank")
    else:
        for attempt in range(1, CAPTURE_ATTEMPTS + 1):
            if attempt > 1:
                time.sleep(CAPTURE_RETRY_PAUSE_S * (attempt - 1))
            meta["attempts"] = attempt
            meta.pop("device_records", None)
            error = _session(fn, x, dev, path, label, profile_reps, meta)
            # on the card, a session whose work left a launch unrecorded is
            # taken again (every rank together: the reps hold collectives)
            lost = dev.type == "cuda" and bool(
                (meta.get("device_records") or {}).get("launches_without_record"))
            if not _any_rank(lost, group, dev):
                break
        if _any_rank(error is not None, group, dev) and error is None:
            error = RuntimeError("the capture failed on another rank")
    if error is not None:
        meta["error"] = f"{type(error).__name__}: {error}"
        meta["error_kind"] = type(error).__name__
    meta["wall_seconds"] = time.perf_counter() - t0
    if trace_dir.is_dir():
        meta["trace_bytes"] = _dir_bytes(trace_dir)
        traces = perfetto_trace_files(trace_dir)
        if traces:
            ranked = sorted(traces, key=lambda p: _rank_of(p))
            meta["perfetto_trace"] = str(ranked[0])
            meta["rank_traces"] = [str(p) for p in ranked]
        elif "error" not in meta:
            meta["error"] = f"capture produced no perfetto trace-event JSON under {trace_dir}"
            meta["error_kind"] = "NoPerfettoTrace"
    return meta


def _session(fn: Callable, x: Any, dev: torch.device, path: Path, label: str,
             profile_reps: int, meta: dict[str, Any]) -> Optional[BaseException]:
    """One profiled session of the reps into ``path``; sets
    ``meta["device_records"]`` from the trace and returns the error, if
    any.  A trace with no device event fails closed here, as devtrace
    would (on the card: CUPTI gave no kernel)."""
    try:
        with profile_session(dev, path), annotate(f"profile_rep:{label}"):
            for _ in range(max(1, int(profile_reps))):
                fn(x)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        meta["device_records"] = parse_capture_census(path)[1]
    except CaptureError as e:
        if e.census is not None:
            meta["device_records"] = e.census
        return e
    except Exception as e:  # noqa: BLE001 — capture must not fail a config
        return e
    return None


def _rank_of(path: Path) -> int:
    m = re.match(r"rank(\d+)$", path.parent.name)
    return int(m.group(1)) if m else 0


def perfetto_trace_files(trace_root: "str | Path") -> list[Path]:
    """The parseable trace-event JSON file(s) under a capture directory,
    what ``obs devtrace`` parses: ``perfetto_trace.json.gz``, else a
    ``*.trace.json.gz`` trace taken by other tooling (JAX's rule)."""
    root = Path(trace_root)
    primary = sorted(root.rglob(TRACE_FILE))
    if primary:
        return primary
    return sorted(root.rglob("*.trace.json.gz"))
