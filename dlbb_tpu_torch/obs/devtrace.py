"""Device-trace analysis (counterpart of ``dlbb_tpu/obs/devtrace.py``,
``cli obs devtrace``).

Each capture that ``obs/capture.py`` recorded (one rank's
``perfetto_trace.json.gz``, a Kineto chrome trace, per rank of the mesh) is
parsed into a per-op device timeline.  Three products per run directory,
JAX's:

- **per-op device durations**, bucketed by op kind (collective / permute /
  dot / fusion / other) and keyed by event name;
- **measured overlap**: the share of each collective event's time covered
  by compute events running at once on the same device;
- **op-level fit samples** (kind, ranks, analytic wire bytes, device µs,
  ``dispatches: 0``) from ``obs/corpus.py::ingest_result``.

What a device event is, is the port's own rule (:func:`classify_event`):

- an event carrying ``args.hlo_op`` is classified as JAX's ``bucket_of``
  does, its containers dropped, so JAX's captures parse as in JAX;
- on the card, Kineto's ``kernel`` events (``gpu_memcpy`` and
  ``gpu_memset`` go to ``other``), one device per GPU, a lane per stream;
- on the CPU (a trace the port's capture marked ``dlbb_device: cpu``), the
  top-level ``cpu_op`` events of each of a rank's threads and gloo's own
  work spans (``gloo:*``), each thread a lane and a device, as JAX's
  cpu-sim runs each device on a host thread.  A CUDA run's CPU ops are
  never device events.

A record of the card is placed in the annotation windows (``profile_rep:``,
``measure``, ``warmup``, ``all-to-all``) by its launch call on the host,
found by ``args.correlation`` (:func:`_placement`), and the windows are the
host's annotations alone: the card's timestamps, converted to the host's
clock, were seen up to 3 ms off on the H100, which put records outside the
window of the rep that launched them and Kineto's GPU copies of the
annotations over other reps' launches.

The buckets (:func:`kernel_bucket`): NCCL's AllReduce, AllGather,
ReduceScatter, Broadcast, Reduce and all-to-all go to ``collective``, and a
P2P ``SendRecv`` to ``permute``, unless it ran inside the port's
``all-to-all`` annotation (NCCL names both SendRecv; the sweep's capture
annotates each rep with the HLO op JAX lowers the op to); cuBLAS and
CUTLASS GEMMs go to ``dot``; the port's own ``flash_*_kernel``s go where
JAX's Pallas custom call goes (``other``); per-op rows keep kernel names.

The static column is JAX's join against the schedule auditor's committed
baselines, the port's own under ``stats/torch/analysis/baselines/``
(``analysis/schedule_audit.py``; JAX's describe XLA's programs): each sweep
config's (op, variant) names its audit target (:func:`audit_target_name`)
and its row carries that baseline's overlap efficiency, critical path,
collective count, tier and cost model (:func:`_static_join`), or
``static: null`` where no baseline exists.  :func:`_gate_overlap` holds a
ring-decomposed row's measured timeline against the static overlap.

Fail-closed contract (JAX's): a run directory with no captures, a capture
whose trace is missing, truncated or empty, or a capture with zero device
events each produce an explicit error finding, never a silent empty report.
Exit codes follow ``analysis.findings.EXIT_*`` (0 clean / 1 findings / 2
crash).  Pure file processing: nothing here touches a device.
"""

from __future__ import annotations

import gzip
import json
import math
import re
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.analysis.findings import SEVERITY_ERROR, SEVERITY_WARNING, Finding

DEVTRACE_SCHEMA = "dlbb_devtrace_v1"
DEFAULT_DEVTRACE_DIR = Path("stats/torch/analysis/devtrace")

BUCKETS = ("collective", "permute", "dot", "fusion", "other")

# the trace-level key the port's captures write (obs/capture.py): the
# device the traced program ran on
DEVICE_KEY = "dlbb_device"

# --- JAX's HLO-op branch (dlbb_tpu/obs/devtrace.py:62-110) -----------------

_COLLECTIVE_PREFIXES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-broadcast", "reduce_scatter", "partial-reduce",
)
_DOT_PREFIXES = ("dot", "convolution")
_CONTAINER_PREFIXES = ("call", "while", "conditional", "async-start",
                       "async-done", "async-update")


def bucket_of(name: str) -> str:
    """JAX's bucket of an HLO instruction name (``fusion`` matched as a
    substring: XLA names fused computations ``<ops>_fusion[.N]``)."""
    base = name.split(".")[0]
    for suffix in ("-start", "-done", "-update"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    if base == "collective-permute":
        return "permute"
    if base.startswith(_COLLECTIVE_PREFIXES):
        return "collective"
    if base.startswith(_DOT_PREFIXES):
        return "dot"
    if "fusion" in base:
        return "fusion"
    return "other"


def _is_container(name: str) -> bool:
    return name.split(".")[0] in _CONTAINER_PREFIXES


def _is_async_completion(name: str) -> bool:
    """The ``-done``/``-update`` half of an async HLO collective pair."""
    return name.split(".")[0].endswith(("-done", "-update"))


# --- the port's kernels and CPU ops ----------------------------------------

# normalised (lower case, no "_", ":" or spaces) name fragments; only the
# communication libraries' kernels and ops (NCCL's kernels carry the
# collective's name, gloo's and c10d's ops theirs) are communication
_COMM_LIBS = ("nccl", "c10d", "gloo")
_P2P_WORDS = ("sendrecv", "send", "recv")
_GEMM_KERNEL_WORDS = ("gemm", "nvjet", "xmma")
_CPU_DOT_OPS = {"mm", "matmul", "bmm", "addmm", "baddbmm", "linear", "einsum", "dot", "mv",
                "addmv", "conv1d", "conv2d", "conv3d", "convolution"}
_A2A_ANNOTATION = "all-to-all"
# Kineto's copy of an annotation on the GPU timeline (the card's clock)
_GPU_ANNOTATION = "gpu_user_annotation"


def _norm(name: str) -> str:
    return re.sub(r"[_:\s]", "", name.lower())


def kernel_bucket(name: str, in_all_to_all: bool = False) -> str:
    """The bucket of a CUDA kernel or a CPU op by its name (module
    docstring); ``in_all_to_all``: the event ran inside the ``all-to-all``
    annotation."""
    n = _norm(name.split("(")[0])
    if any(lib in n for lib in _COMM_LIBS):
        if "alltoall" in n or in_all_to_all:
            return "collective"
        return "permute" if any(w in n for w in _P2P_WORDS) else "collective"
    if any(w in n for w in _GEMM_KERNEL_WORDS) or \
            name.split("::")[-1].strip().lower().rstrip("_") in _CPU_DOT_OPS:
        return "dot"
    return "other"


class CaptureError(ValueError):
    """A capture that cannot be parsed into a device timeline (missing,
    truncated, or empty): the caller turns it into an explicit finding.
    One raised for want of device events carries ``census``
    (:func:`parse_capture_census`)."""

    census: Optional[dict[str, int]] = None


# ---------------------------------------------------------------------------
# capture parsing
# ---------------------------------------------------------------------------


def _load_trace(path: "str | Path") -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """(the trace's top-level keys but its events, its events); raises
    :class:`CaptureError` on anything unreadable."""
    path = Path(path)
    if not path.exists():
        raise CaptureError(f"no trace file at {path}")
    try:
        raw = path.read_bytes()
        if path.name.endswith(".gz"):
            raw = gzip.decompress(raw)
        data = json.loads(raw)
    except (OSError, EOFError, gzip.BadGzipFile, json.JSONDecodeError) as e:
        raise CaptureError(f"{path}: truncated or unparseable trace ({e})") from e
    events = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(events, list) or not events:
        raise CaptureError(f"{path}: trace holds no events")
    head = {k: v for k, v in data.items() if k != "traceEvents"} if isinstance(data, dict) \
        else {}
    return head, [e for e in events if isinstance(e, dict)]


def load_trace_events(path: "str | Path") -> list[dict[str, Any]]:
    """The trace-event list of one capture (gz or plain JSON); raises
    :class:`CaptureError` on anything unreadable."""
    return _load_trace(path)[1]


def _annotation_windows(events: list[dict[str, Any]]) -> dict[str, list[tuple[float, float]]]:
    """JAX's harness windows: ``profile_rep:<label>`` (the dedicated capture
    reps), ``measure`` and ``warmup``; a name truncated at the colon rides
    ``args.long_name``.  On the card an annotation appears twice, on the
    host and on the GPU timeline; only the host's counts, since the card's
    records are placed by their launches on the host's clock."""
    windows: dict[str, list[tuple[float, float]]] = {
        "profile_rep": [], "measure": [], "warmup": [],
    }
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev or ev.get("cat") == _GPU_ANNOTATION:
            continue
        args = ev.get("args") or {}
        name = str(args.get("long_name") or ev.get("name") or "")
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if name.startswith("profile_rep:"):
            windows["profile_rep"].append(span)
        elif name == "measure":
            windows["measure"].append(span)
        elif name == "warmup":
            windows["warmup"].append(span)
    return windows


def _in_any(mid: float, spans: list[tuple[float, float]]) -> bool:
    return any(lo <= mid <= hi for lo, hi in spans)


# the card's own records in a Kineto trace
_CARD_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host calls that put work on the card; each of its device records
# carries the call's ``args.correlation``
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_LAUNCH_RE = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy|Memset)")


def _launches(events: list[dict[str, Any]]) -> dict[Any, dict[str, Any]]:
    """``{correlation: launch call}`` of a CUDA trace's host launch calls
    (empty for any other trace)."""
    out: dict[Any, dict[str, Any]] = {}
    for ev in events:
        if ev.get("cat") in _LAUNCH_CATS and ev.get("ph") == "X" and "dur" in ev \
                and _LAUNCH_RE.match(str(ev.get("name", ""))):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                out[corr] = ev
    return out


def _placement(ev: dict[str, Any], launches: dict[Any, dict[str, Any]]) -> float:
    """The time that places an event in the annotation windows: for a
    record of the card, the midpoint of its launch call on the host (the
    annotations' own clock; Kineto's conversion of the card's timestamps
    to the host's was seen 1.2 to 1.8 ms early on the H100, which put a
    short rep's only record outside its window), else its own midpoint."""
    launch = None
    if ev.get("cat") in _CARD_CATS:
        launch = launches.get((ev.get("args") or {}).get("correlation"))
    src = launch or ev
    return float(src["ts"]) + float(src["dur"]) / 2.0


def classify_event(ev: dict[str, Any], device: Optional[str],
                   a2a: list[tuple[float, float]],
                   launches: Optional[dict[Any, dict[str, Any]]] = None,
                   ) -> Optional[tuple[str, str]]:
    """``(name, bucket)`` of a device event, None for any other event (the
    module docstring's rule).  ``device`` is the trace's ``dlbb_device``;
    ``a2a`` the ``all-to-all`` annotation windows; ``launches`` the trace's
    launch calls (:func:`_launches`).  CPU ops are weighed for nesting by
    the caller."""
    if ev.get("ph") != "X" or "dur" not in ev:
        return None
    args = ev.get("args")
    if isinstance(args, dict) and "hlo_op" in args:
        name = str(ev.get("name", args["hlo_op"]))
        return None if _is_container(name) else (name, bucket_of(name))
    name = str(ev.get("name", ""))
    cat = ev.get("cat")
    if cat == "kernel":
        return name, kernel_bucket(name, _in_any(_placement(ev, launches or {}), a2a))
    if cat in ("gpu_memcpy", "gpu_memset"):
        return name, "other"
    if device == "cpu" and (cat == "cpu_op" or (cat == "user_annotation"
                                                and name.startswith("gloo:"))):
        return name, kernel_bucket(name, _in_any(_placement(ev, {}), a2a))
    return None


def _top_level(events: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """The events of one lane that no earlier event of the lane contains."""
    out: list[dict[str, Any]] = []
    end = -math.inf
    for ev in sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        ts = float(ev["ts"])
        if ts >= end:
            out.append(ev)
            end = ts + float(ev["dur"])
    return out


def parse_capture(path: "str | Path") -> dict[str, Any]:
    """One capture's trace-event JSON -> the device timeline (JAX's):
    ``{lanes, devices, device_events, excluded_warmup, windows}``, each
    event ``{name, bucket, ts, dur, lane}``.  Warmup reps are excluded (an
    event placed in a ``warmup`` window), and where ``profile_rep:``/
    ``measure`` windows exist only events placed inside one are kept (a
    record of the card is placed by its launch, :func:`_placement`).
    Raises :class:`CaptureError` when no device events survive."""
    return parse_capture_census(path)[0]


def parse_capture_census(path: "str | Path") -> tuple[dict[str, Any], dict[str, int]]:
    """:func:`parse_capture`, and the census of the trace's device records:
    ``{total, excluded, launches_without_record}``, the records found, those
    placed outside the windows, and the launch calls placed inside them
    (the work's) whose record the trace lacks.  A :class:`CaptureError` for want of device events carries
    the census as its ``census``."""
    head, events = _load_trace(path)
    device = head.get(DEVICE_KEY)
    windows = _annotation_windows(events)
    keep_windows = windows["profile_rep"] + windows["measure"]
    a2a = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("ph") == "X" and "dur" in e and e.get("name") == _A2A_ANNOTATION
           and e.get("cat") != _GPU_ANNOTATION]
    launches = _launches(events)
    candidates: dict[str, list[tuple[dict[str, Any], str, str]]] = {}
    host: dict[str, list[dict[str, Any]]] = {}
    recorded: set[Any] = set()
    for ev in events:
        if ev.get("cat") in _CARD_CATS:
            recorded.add((ev.get("args") or {}).get("correlation"))
        got = classify_event(ev, device, a2a, launches)
        if got is None:
            continue
        lane = f"{ev.get('pid', 0)}/{ev.get('tid', 0)}"
        if ev.get("cat") in ("cpu_op", "user_annotation"):
            host.setdefault(lane, []).append(ev)
        else:
            candidates.setdefault(lane, []).append((ev, *got))
    for lane, evs in host.items():
        for ev in _top_level(evs):
            candidates.setdefault(lane, []).append(
                (ev, *classify_event(ev, device, a2a, launches)))
    lanes: dict[str, list[dict[str, Any]]] = {}
    kernel_pids: set[str] = set()
    excluded = total = 0
    for lane, evs in candidates.items():
        for ev, name, bucket in evs:
            total += 1
            ts, dur = float(ev["ts"]), float(ev["dur"])
            at = _placement(ev, launches)
            if _in_any(at, windows["warmup"]) or (keep_windows
                                                  and not _in_any(at, keep_windows)):
                excluded += 1
                continue
            if ev.get("cat") in _CARD_CATS:
                kernel_pids.add(lane.split("/")[0])
            lanes.setdefault(lane, []).append(
                {"name": name, "bucket": bucket, "ts": ts, "dur": dur, "lane": lane})
    # the work's launches (placed as their records would be) that left none
    unrecorded = sum(1 for corr, launch in launches.items() if corr not in recorded
                     and not _in_any(_placement(launch, {}), windows["warmup"])
                     and (not keep_windows or _in_any(_placement(launch, {}), keep_windows)))
    census = {"total": total, "excluded": excluded, "launches_without_record": unrecorded}
    if not any(lanes.values()):
        error = CaptureError(
            f"{path}: no device events"
            + (f" ({excluded} excluded as warmup/out-of-window, of {total} total)"
               if total else
               " — the capture carries no hlo_op-stamped thunks, no CUDA kernels"
               + ("" if device == "cpu" else
                  f" ({census['launches_without_record']} launches on the host left no "
                  "record; is CUPTI available?)")))
        error.census = census
        raise error
    # device grouping: JAX's multi-device traces export one process per
    # device ("/device:TPU:0"), Kineto one per GPU: lanes group by pid
    # there; a CPU run's threads are each their own device
    proc_names: dict[Any, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            proc_names[ev.get("pid")] = str((ev.get("args") or {}).get("name", ""))
    devices: dict[str, list[dict[str, Any]]] = {}
    for lane, evs in lanes.items():
        pid = lane.split("/")[0]
        pname = proc_names.get(int(pid) if pid.lstrip("-").isdigit() else pid, "")
        group = pid if ("/device:" in pname or pid in kernel_pids) else lane
        devices.setdefault(group, []).extend(evs)
    return {
        "lanes": lanes,
        "devices": devices,
        "excluded_warmup": excluded,
        "device_events": sum(len(v) for v in lanes.values()),
        "windows": {k: len(v) for k, v in windows.items()},
    }, census


def merge_timelines(timelines: list[dict[str, Any]]) -> dict[str, Any]:
    """One timeline of a mesh's ranks' captures (one per rank, in rank
    order): lanes and devices keep their rank as a prefix."""
    if len(timelines) == 1:
        return timelines[0]
    merged: dict[str, Any] = {"lanes": {}, "devices": {}, "excluded_warmup": 0,
                              "device_events": 0, "windows": {}}
    for r, t in enumerate(timelines):
        for key in ("lanes", "devices"):
            for name, evs in t[key].items():
                merged[key][f"r{r}:{name}"] = [dict(e, lane=f"r{r}:{e['lane']}") for e in evs]
        merged["excluded_warmup"] += t["excluded_warmup"]
        merged["device_events"] += t["device_events"]
        for k, v in t["windows"].items():
            merged["windows"][k] = merged["windows"].get(k, 0) + v
    return merged


# ---------------------------------------------------------------------------
# per-capture analysis
# ---------------------------------------------------------------------------


def _union_cover(span: tuple[float, float], others: list[tuple[float, float]]) -> float:
    """Length of ``span`` covered by the union of ``others``."""
    lo, hi = span
    xs = sorted((max(a, lo), min(b, hi)) for a, b in others if b > lo and a < hi)
    covered = 0.0
    cur_lo = cur_hi = None
    for a, b in xs:
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    return covered


def analyze_capture(timeline: dict[str, Any]) -> dict[str, Any]:
    """JAX's bucket totals, per-op duration rows (keyed by event name) and
    measured-overlap numbers of one parsed capture."""
    per_op: dict[str, dict[str, Any]] = {}
    buckets = {b: 0.0 for b in BUCKETS}
    comm_total = hidden = 0.0
    comm_count = 0
    serialized: list[str] = []
    straddled = 0
    concurrent = False
    for group in sorted(timeline["devices"]):
        evs = timeline["devices"][group]
        compute = [(e["ts"], e["ts"] + e["dur"]) for e in evs
                   if e["bucket"] in ("dot", "fusion")]
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs)
        for i in range(1, len(spans)):
            if spans[i][0] < spans[i - 1][1] - 1e-3:
                concurrent = True
                break
        for e in evs:
            row = per_op.setdefault(e["name"], {
                "name": e["name"], "bucket": e["bucket"], "count": 0,
                "total_us": 0.0, "durations": [],
            })
            row["count"] += 1
            row["total_us"] += e["dur"]
            row["durations"].append(e["dur"])
            buckets[e["bucket"]] += e["dur"]
            if e["bucket"] in ("collective", "permute"):
                comm_total += e["dur"]
                cover = _union_cover((e["ts"], e["ts"] + e["dur"]), compute)
                hidden += min(cover, e["dur"])
                if _is_async_completion(e["name"]) or e["dur"] <= 0.0:
                    continue
                comm_count += 1
                if cover <= 0.0:
                    serialized.append(e["name"])
                else:
                    straddled += 1
    rows = []
    for name in sorted(per_op):
        row = per_op[name]
        ds = sorted(row.pop("durations"))
        row["median_us"] = round(ds[len(ds) // 2], 3)
        row["total_us"] = round(row["total_us"], 3)
        rows.append(row)
    return {
        "per_op": rows,
        "buckets_us": {b: round(v, 3) for b, v in buckets.items()},
        "comm_events": comm_count,
        "comm_total_us": round(comm_total, 3),
        "hidden_us": round(hidden, 3),
        "measured_overlap_efficiency": (round(hidden / comm_total, 6)
                                        if comm_total > 0 else None),
        "comm_serialized_events": len(serialized),
        "comm_straddled_events": straddled,
        # whether two events ever ran at once on one device in this capture
        "runtime_concurrent": concurrent,
    }


def device_comm_samples(timeline: dict[str, Any], profile_reps: int = 1,
                        buckets: "Optional[tuple[str, ...]]" = ("collective", "permute"),
                        ) -> dict[str, Any]:
    """JAX's per-device totals for the fit sample: the median across
    devices of each device's summed time over ``buckets`` (None: every
    bucket) per profile rep, and the per-device instruction count."""
    totals: list[float] = []
    counts: list[int] = []
    for group in sorted(timeline["devices"]):
        evs = [e for e in timeline["devices"][group]
               if buckets is None or e["bucket"] in buckets]
        if not evs:
            continue
        totals.append(sum(e["dur"] for e in evs))
        counts.append(sum(1 for e in evs if not _is_async_completion(e["name"])))
    if not totals:
        return {}
    totals.sort()
    counts.sort()
    reps = max(1, int(profile_reps))
    return {
        "measured_device_us": totals[len(totals) // 2] / reps,
        "comm_instructions": counts[len(counts) // 2] / reps,
        "devices": len(totals),
    }


# ---------------------------------------------------------------------------
# run-directory walk
# ---------------------------------------------------------------------------

_RANK_DIR = re.compile(r"^rank(\d+)$")


def _capture_files(root: Path) -> list[Path]:
    """A capture directory's trace files: every rank's, in rank order,
    where the port wrote ``rank<r>/`` files, else JAX's newest one."""
    from dlbb_tpu_torch.obs.capture import perfetto_trace_files  # (it imports this module)

    files = perfetto_trace_files(root)
    ranked = [(int(m.group(1)), f) for f in files
              if (m := _RANK_DIR.match(f.parent.name))]
    if ranked:
        return [f for _, f in sorted(ranked)]
    return files[-1:]


def _resolve_capture_paths(meta: dict[str, Any], input_dir: Path) -> list[Path]:
    """The parseable trace files of one capture meta (every rank's),
    tolerating relative ``trace_dir`` records from runs launched in another
    cwd (JAX's resolution); empty when none exists."""
    listed = [Path(p) for p in meta.get("rank_traces") or ()]
    if listed and all(p.exists() for p in listed):
        return listed
    explicit = meta.get("perfetto_trace")
    if explicit and Path(explicit).exists() and not listed:
        return [Path(explicit)]
    trace_dir = str(meta.get("trace_dir") or "")
    if not trace_dir:
        # Path("") is the cwd: a dir-less meta must fail closed
        return []
    rel = Path(trace_dir)
    for root in (rel, input_dir / rel.parent.name / rel.name, input_dir / rel.name):
        if root.is_dir():
            files = _capture_files(root)
            if files:
                return files
    return []


def _sweep_captures(input_dir: Path) -> list[dict[str, Any]]:
    """Captured sweep configs: result JSONs carrying ``device_trace``."""
    out: list[dict[str, Any]] = []
    for path in sorted(input_dir.glob("*.json")):
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(data, dict):
            continue
        meta = data.get("device_trace")
        if isinstance(meta, dict):
            out.append({"kind": "config", "file": path, "data": data, "meta": meta})
    return out


def _serving_captures(input_dir: Path) -> list[dict[str, Any]]:
    """Captured serving phases: the report's ``observability.
    device_captures`` metas (one prefill and one decode scan per run)."""
    out: list[dict[str, Any]] = []
    for path in sorted(input_dir.glob("serving_*.json")):
        if path.name == "serving_resume.json":
            continue
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(data, dict):
            continue
        metas = (data.get("observability") or {}).get("device_captures")
        if isinstance(metas, list):
            for meta in metas:
                if isinstance(meta, dict):
                    out.append({"kind": "serving", "file": path, "data": data,
                                "meta": meta})
            break
    return out


# ---------------------------------------------------------------------------
# the static join (the port's committed schedule baselines)
# ---------------------------------------------------------------------------


def audit_target_name(op: str, variant: str) -> str:
    """The collective audit's default target a sweep config's (op, variant)
    was audited as: the key into the schedule baselines (JAX's naming,
    ``analysis/hlo_audit.py``'s registry)."""
    if op in ("ag_matmul", "matmul_rs"):
        schedule = {"overlap_ring": "ring", "overlap_bidir": "bidir"}.get(variant, "fused")
        return f"comm/ops.py::{op}[{schedule}]"
    if op.endswith("_q"):
        return f"comm/ops.py::{op}[{'fp8' if 'fp8' in variant else 'int8'}]"
    return f"comm/ops.py::{op}"


def _static_join(baselines: dict[str, dict], op: str, variant: str) -> Optional[dict[str, Any]]:
    base = baselines.get(audit_target_name(op, variant))
    if base is None:
        return None
    return {
        "target": base.get("target"),
        "overlap_efficiency": base.get("overlap_efficiency"),
        "critical_path_us": base.get("critical_path_us"),
        "num_collectives": base.get("num_collectives"),
        "tier": base.get("tier"),
        "cost_model_version": base.get("cost_model_version"),
    }


def analyze_run(input_dir: "str | Path", baselines_dir: "Optional[str | Path]" = None
                ) -> tuple[dict[str, Any], list[Finding]]:
    """Parse every capture a run directory recorded into the devtrace
    report and findings, each sweep config joined with its target's
    schedule baseline under ``baselines_dir`` (default: the committed
    ``stats/torch/analysis/baselines``).  Fail-closed: no captures at all,
    or a capture missing or unparseable, is an explicit error finding."""
    from dlbb_tpu_torch.analysis.schedule_audit import DEFAULT_BASELINE_DIR, load_baselines

    input_dir = Path(input_dir)
    baselines_dir = Path(baselines_dir or DEFAULT_BASELINE_DIR)
    baselines = load_baselines(baselines_dir) if baselines_dir.is_dir() else {}
    findings: list[Finding] = []
    captures = _sweep_captures(input_dir) + _serving_captures(input_dir)
    report: dict[str, Any] = {
        "schema": DEVTRACE_SCHEMA,
        "input_dir": str(input_dir),
        "baselines_dir": str(baselines_dir),
        "captures": [],
        "op_samples": [],
    }
    if not captures:
        findings.append(Finding(
            pass_name="devtrace", rule="no-captures", severity=SEVERITY_ERROR,
            target=str(input_dir),
            message=("no device captures recorded under this directory — run the "
                     "sweep/serving benchmark with --device-trace DIR (or "
                     "DLBB_DEVICE_TRACE) so there is a timeline to analyze; refusing "
                     "to emit an empty report")))
        return report, findings

    parsed_any = False
    for cap in captures:
        meta = cap["meta"]
        label = str(meta.get("label", cap["file"].name))
        row: dict[str, Any] = {
            "label": label,
            "source": cap["file"].name,
            "kind": cap["kind"],
            "capture": {k: meta.get(k) for k in (
                "trace_dir", "perfetto_trace", "profile_reps", "wall_seconds",
                "trace_bytes", "phase") if k in meta},
        }
        if "error" in meta:
            findings.append(Finding(
                pass_name="devtrace", rule="capture-failed", severity=SEVERITY_WARNING,
                target=label,
                message=(f"capture failed at run time and was contained "
                         f"({meta['error']}) — no timeline to analyze")))
            row["error"] = meta["error"]
            report["captures"].append(row)
            continue
        paths = _resolve_capture_paths(meta, input_dir)
        if not paths:
            findings.append(Finding(
                pass_name="devtrace", rule="capture-missing", severity=SEVERITY_ERROR,
                target=label,
                message=(f"result records a device capture under {meta.get('trace_dir')} "
                         "but no parseable perfetto trace-event JSON exists there — the "
                         "capture artifact was moved or deleted")))
            row["error"] = "trace file missing"
            report["captures"].append(row)
            continue
        try:
            timeline = merge_timelines([parse_capture(p) for p in paths])
        except CaptureError as e:
            findings.append(Finding(
                pass_name="devtrace", rule="capture-unparseable", severity=SEVERITY_ERROR,
                target=label, message=str(e)))
            row["error"] = str(e)
            report["captures"].append(row)
            continue
        parsed_any = True
        row.update(analyze_capture(timeline))
        row["device_events"] = timeline["device_events"]
        row["excluded_warmup"] = timeline["excluded_warmup"]
        row["devices"] = len(timeline["devices"])
        if cap["kind"] == "config":
            data = cap["data"]
            row["op"] = str(data.get("operation", ""))
            row["variant"] = str(data.get("variant", "default"))
            row["ranks"] = int(data.get("num_ranks", 0))
            row["static"] = _static_join(baselines, row["op"], row["variant"])
            _gate_overlap(row, findings)
            sample = _op_sample(cap, timeline)
            if sample is not None:
                report["op_samples"].append(sample)
        else:
            row["phase"] = meta.get("phase")
        report["captures"].append(row)

    if not parsed_any:
        findings.append(Finding(
            pass_name="devtrace", rule="no-captures", severity=SEVERITY_ERROR,
            target=str(input_dir),
            message=(f"none of the {len(captures)} recorded capture(s) yielded a "
                     "parseable device timeline — see the per-capture findings above; "
                     "refusing to emit an empty report")))
    return report, findings


def _gate_overlap(row: dict[str, Any], findings: list[Finding]) -> None:
    """JAX's static-vs-measured overlap gate, for a row measuring a
    ring-decomposed schedule (``overlap_*`` variants) that carries a static
    ``overlap_efficiency``; quantised rings (``*_q``) are exempt.  A
    runtime with no concurrency anywhere in the capture downgrades the
    finding to a warning."""
    variant = row.get("variant", "")
    op = row.get("op", "")
    if not variant.startswith("overlap_") or op.endswith("_q"):
        return
    static = row.get("static") or {}
    static_overlap = static.get("overlap_efficiency")
    if not static_overlap or static_overlap <= 0:
        return
    hops = row.get("comm_events", 0)
    serialized = row.get("comm_serialized_events", 0)
    if not hops or not serialized:
        return
    severity = SEVERITY_ERROR if row.get("runtime_concurrent") else SEVERITY_WARNING
    measured = row.get("measured_overlap_efficiency")
    findings.append(Finding(
        pass_name="devtrace", rule="runtime-serialized-collective", severity=severity,
        target=row["label"],
        message=(
            f"static proof claims overlap_efficiency={static_overlap:.2f} for "
            f"{static.get('target')}, but the measured timeline shows {serialized}/{hops} "
            f"ring hop event(s) with zero straddling compute occupancy (measured overlap "
            f"{measured if measured is not None else 0:.2f})"
            + ("" if severity == SEVERITY_ERROR else
               " — single-stream runtime: no thunk concurrency observed anywhere in "
               "this capture, so hiding is unobservable on this backend, not disproved")),
        details={
            "static_overlap_efficiency": static_overlap,
            "measured_overlap_efficiency": measured,
            "serialized_events": serialized,
            "comm_events": hops,
            "runtime_concurrent": bool(row.get("runtime_concurrent")),
        }))


def _op_sample(cap: dict[str, Any], timeline: dict[str, Any]) -> Optional[dict[str, Any]]:
    """JAX's fit sample of one captured sweep config: the op's analytic
    features and its measured device communication time (``dispatches``
    0, ``flops`` 0)."""
    from dlbb_tpu_torch.obs.corpus import ingest_result

    sample, _reason = ingest_result(cap["file"], cap["data"])
    if sample is None:
        return None
    comm = device_comm_samples(timeline, int(cap["meta"].get("profile_reps", 1)))
    if not comm or comm["measured_device_us"] <= 0:
        return None
    return {
        "file": f"{cap['file']}::devtrace",
        "source": "devtrace",
        "op": sample["op"],
        "variant": sample["variant"],
        "kind": sample["kind"],
        "ranks": sample["ranks"],
        "dtype": sample["dtype"],
        "num_elements": sample["num_elements"],
        "wire_bytes": sample["wire_bytes"],
        "flops": 0,
        "collectives": float(comm["comm_instructions"]),
        "dispatches": 0.0,
        "measured_median_us": float(comm["measured_device_us"]),
        "measured_p90_us": float(comm["measured_device_us"]),
        "measured_p99_us": None,
        "iterations": int(cap["meta"].get("profile_reps", 1)),
        "tier": sample["tier"],
        "host": sample["host"],
        "timestamp": sample.get("timestamp"),
        "devices": comm["devices"],
    }


# ---------------------------------------------------------------------------
# report writers (JSON + MD + CSV)
# ---------------------------------------------------------------------------


def _fmt_us(us: Optional[float]) -> str:
    if us is None or not math.isfinite(us):
        return "-"
    if us >= 1e6:
        return f"{us / 1e6:.2f} s"
    if us >= 1e3:
        return f"{us / 1e3:.1f} ms"
    return f"{us:.0f} us"


def _fmt_eff(v: Optional[float]) -> str:
    return f"{v:.2f}" if isinstance(v, (int, float)) else "-"


def write_devtrace(report: dict[str, Any], findings: list[Finding], out_dir: "str | Path",
                   name: str) -> tuple[Path, Path, Path]:
    """JAX's report set: ``<name>.json`` (the report and its findings),
    ``<name>.md`` (measured overlap beside the static value per capture,
    the bucket totals, the fit samples, the findings) and ``<name>.csv``
    (flat per-op rows) under ``out_dir``."""
    import csv
    import io

    from dlbb_tpu_torch.utils.config import atomic_write_text

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    payload = dict(report)
    payload["findings"] = [f.to_dict() for f in findings]
    json_path = atomic_write_text(json.dumps(payload, indent=1, sort_keys=True),
                                  out_dir / f"{name}.json")

    caps = report.get("captures", [])
    parsed = [c for c in caps if "error" not in c]
    lines = [
        f"# Device-trace analysis — {name}",
        "",
        f"- schema: `{DEVTRACE_SCHEMA}`",
        f"- input: `{report.get('input_dir')}`",
        f"- captures: {len(parsed)} parsed / {len(caps)} recorded",
        f"- static join: `{report.get('baselines_dir')}`",
        "",
        "## Measured vs static overlap, per capture",
        "",
        "Measured overlap is the wall-occupancy of collective/permute device events "
        "covered by concurrently-executing compute events on the same device; the "
        "static value is the schedule auditor's ASAP upper bound from the committed "
        "baseline (`analysis/schedule_audit.py`).",
        "",
        "| capture | target | dev events | comm | measured overlap | static overlap "
        "| concurrency |",
        "|---|---|---:|---:|---:|---:|---|",
    ]
    for c in parsed:
        static = c.get("static") or {}
        lines.append(
            f"| {c['label']} | {static.get('target') or c.get('phase') or '-'} "
            f"| {c.get('device_events', 0)} "
            f"| {_fmt_us(c.get('comm_total_us'))} "
            f"| {_fmt_eff(c.get('measured_overlap_efficiency'))} "
            f"| {_fmt_eff(static.get('overlap_efficiency'))} "
            f"| {'yes' if c.get('runtime_concurrent') else 'no'} |")
    lines += ["", "## Bucket totals (device µs)", "",
              "| capture | " + " | ".join(BUCKETS) + " |",
              "|---|" + "---:|" * len(BUCKETS)]
    for c in parsed:
        b = c.get("buckets_us", {})
        lines.append("| " + c["label"] + " | "
                     + " | ".join(_fmt_us(b.get(k, 0.0)) for k in BUCKETS) + " |")
    if report.get("op_samples"):
        lines += [
            "",
            f"## Fit samples ({len(report['op_samples'])} op-level rows, source "
            "`devtrace`)",
            "",
            "| op | variant | ranks | wire bytes | measured device µs | collectives |",
            "|---|---|---:|---:|---:|---:|",
        ]
        for s in report["op_samples"]:
            lines.append(f"| {s['op']} | {s['variant']} | {s['ranks']} "
                         f"| {s['wire_bytes']} | {s['measured_median_us']:.1f} "
                         f"| {s['collectives']:.0f} |")
    if findings:
        lines += ["", "## Findings", ""]
        lines += [f"- `{f.rule}` ({f.severity}) @ {f.target}: {f.message}" for f in findings]
    lines.append("")
    md_path = atomic_write_text("\n".join(lines), out_dir / f"{name}.md")

    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=[
        "capture", "target", "phase", "name", "bucket", "count", "total_us", "median_us",
    ])
    writer.writeheader()
    for c in parsed:
        static = c.get("static") or {}
        for op_row in c.get("per_op", ()):
            writer.writerow({"capture": c["label"], "target": static.get("target", ""),
                             "phase": c.get("phase", ""), **op_row})
    csv_path = atomic_write_text(buf.getvalue(), out_dir / f"{name}.csv", newline="")
    return json_path, md_path, csv_path


def run_devtrace(input_dir: "str | Path", out_dir: "Optional[str | Path]" = None,
                 baselines_dir: "Optional[str | Path]" = None,
                 name: Optional[str] = None, verbose: bool = True,
                 ) -> tuple[dict[str, Any], list[Finding]]:
    """``cli obs devtrace``: parse, join and write the report set; the
    caller maps the findings to the exit codes."""
    input_dir = Path(input_dir)
    name = name or input_dir.resolve().name
    report, findings = analyze_run(input_dir, baselines_dir)
    _json, md_path, _csv = write_devtrace(report, findings,
                                          Path(out_dir or DEFAULT_DEVTRACE_DIR), name)
    if verbose:
        parsed = [c for c in report["captures"] if "error" not in c]
        n_overlap = sum(1 for c in parsed if (c.get("static") or {}).get("overlap_efficiency"))
        print(f"[obs] devtrace: {len(parsed)}/{len(report['captures'])} capture(s) parsed, "
              f"{n_overlap} overlap-proof target(s), {len(report['op_samples'])} fit "
              f"sample(s) -> {md_path}")
    return report, findings
