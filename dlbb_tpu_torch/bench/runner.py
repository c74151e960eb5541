"""The 1D and 3D collective sweeps (counterpart of ``dlbb_tpu/bench/runner.py``).

Every rank of a process group (``bench/launch.py``, or one the caller
initialised with ``comm.initialize_distributed``) calls ``run_sweep`` with
the same sweep.  For each rank count P it walks the grid serially, one
config at a time, on the mesh of the first P ranks (``comm.get_mesh``):
this rank's payload slab, the op built by ``comm.ops``, per-iteration
timing (``utils.timing.time_collective``), the ranks' timings gathered as
``[rank][iteration]`` (the reference's shape, ``collectives/1d/openmpi.py:270``),
and one result JSON per config, written atomically by the mesh's rank 0 in
the JAX package's schema and under its file name, with the implementation
``torch_nccl`` (``cuda``) or ``torch_gloo`` (``cpu``).

The ranks past a rank count's mesh sit it out, and every rank of the
world meets at the end of each rank count before any goes on (a barrier on
a gloo group of its own, whose timeout is ``HOLD_TIMEOUT``):
a rank that went on alone would wait in the larger mesh's first
collective, under the collective timeout, while the smaller mesh is still
measuring.  The JAX package has no such skew, since one SPMD process runs
every mesh in turn.  Payloads are built once per rank count and kept in a
byte-budgeted LRU (``PayloadCache``, the JAX runner's).

A config that fails is contained as in JAX: a transient failure
(``resilience.errors.is_transient``) retries with exponential backoff, any
other is quarantined with its exception chain in ``sweep_manifest.json``
and journaled ``failed`` (``SweepJournal``, ``sweep_journal.jsonl`` beside
the results), never silently skipped.  ``unit_deadline_seconds`` runs each
measurement on a watchdog thread and abandons an overrun (its late write
suppressed); SIGTERM stops the sweep at a config boundary (``resilience.
preempt.PreemptionGuard``) and ``resume`` re-validates each artifact and
completes the grid; ``fault_plan`` (else ``DLBB_FAULT_PLAN``) injects JAX's
faults at JAX's sites; ``span_trace`` (else ``DLBB_SPANS``) writes the
sweep's span trace; ``metrics.prom`` comes from ``obs/export.py::
sweep_metrics``.  Rank 0 journals, traces and writes the manifest.

A verdict the ranks of a mesh must share is rank 0's: whether a fault site
fires (``_fire``), whether the watchdog abandons a unit (``_watched``) and
whether to stop for a preemption (an all-reduce over the mesh, then over
the world at the end of each rank count); a retry follows from an error
every rank of the mesh sees (an injected transient, timings gathered with a
NaN in them).  A failure on one rank only, or a hang inside a collective,
cannot be contained: its peers wait in the op's collective until the
process group's timeout.

Not ported yet (ROADMAP Queue 1, Slice F, item 13, part 13b): the
compile-ahead engine and its compile cache (``pipeline``,
``compile_cache``) and device traces (``device_trace_dir``).  Those knobs
keep their "off" values, and ``run_sweep`` raises on any other value; the
manifest's compile fields read 0.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import traceback
from collections import OrderedDict
from dataclasses import dataclass, field, fields
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dlbb_tpu_torch.comm.mesh import BACKENDS, Mesh, get_mesh
from dlbb_tpu_torch.comm.ops import (
    COMPRESSED_OPS,
    DTYPES,
    MATMUL_OPS,
    build_allreduce_hierarchical,
    get_op,
    make_payload,
)
from dlbb_tpu_torch.comm.variants import Variant, get_variant
from dlbb_tpu_torch.obs import spans
from dlbb_tpu_torch.obs.export import MetricsRegistry, sweep_metrics
from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.resilience.errors import (
    CorruptStats,
    DeadlineExceeded,
    exception_chain,
    is_transient,
)
from dlbb_tpu_torch.resilience.journal import SweepJournal
from dlbb_tpu_torch.resilience.preempt import PreemptionGuard
from dlbb_tpu_torch.utils.config import save_json
from dlbb_tpu_torch.utils.sysinfo import (collect_system_info, resolve_device,
                                          topology_record)
from dlbb_tpu_torch.utils.timing import time_collective

# Reference 1D sweep constants (``collectives/1d/openmpi.py:14-49``).  The
# labels are 2x the bf16 payload ("16MB" = 4,194,304 elements x 2 B = 8 MiB),
# kept verbatim for curve comparability, with honest byte counts in the JSON.
DATA_SIZES_1D: dict[str, int] = {
    "1KB": 256,
    "64KB": 16384,
    "1MB": 262144,
    "16MB": 4194304,
}

# extension to the north-star 1 KB - 1 GB curve
EXTENDED_DATA_SIZES_1D: dict[str, int] = {
    **DATA_SIZES_1D,
    "64MB": 16777216,
    "256MB": 67108864,
    "1GB": 268435456,
}

OPERATIONS_1D: tuple[str, ...] = (
    "allreduce",
    "allgather",
    "broadcast",
    "gather",
    "scatter",
    "reduce",
    "alltoall",
    "sendrecv",
)

# Reference 3D sweep grid (``collectives/3d/openmpi.py:19-31``).
OPERATIONS_3D: tuple[str, ...] = (
    "allreduce",
    "allgather",
    "broadcast",
    "gather",
    "reduce",
)
GRID_3D: dict[str, Sequence[int]] = {
    "batch_sizes": (1, 8, 16, 32),
    "seq_lengths": (1, 2048, 4096, 8192),
    "hidden_dims": (2048, 4096),
}

# knob -> what brings it; each sweep field below keeps its "off" value
_NOT_PORTED_KNOBS = {
    "pipeline": "the compile-ahead engine (bench/schedule.py)",
    "compile_cache": "the compile-ahead engine's compilation cache",
    "device_trace_dir": "device traces (obs/capture.py)",
}
MANIFEST_NAME = "sweep_manifest.json"
MANIFEST_SCHEMA = "dlbb_sweep_manifest_v1"


@dataclass(frozen=True)
class Sweep1D:
    """1D collective microbenchmark sweep (flat element-count payloads)."""

    # None: torch_nccl on cuda, torch_gloo on cpu
    implementation: Optional[str] = None
    variant: str = "default"
    operations: tuple[str, ...] = OPERATIONS_1D
    data_sizes: tuple[tuple[str, int], ...] = tuple(DATA_SIZES_1D.items())
    rank_counts: tuple[int, ...] = (2, 4, 8)
    dtype: str = "bfloat16"
    warmup_iterations: int = 10
    measurement_iterations: int = 100
    output_dir: str = "results/torch/1d"
    root: int = 0
    # the port times per iteration only (the JAX "chained" regime exists
    # for a remotely attached TPU)
    timing_mode: str = "per_iter"
    # wall-time cap per config; iteration counts scale down to fit
    max_config_seconds: Optional[float] = None
    # skip configs whose estimated global input+output bytes exceed this
    max_global_bytes: Optional[int] = None
    # skip configs whose result JSON already exists and validates
    resume: bool = False
    # not ported (item 13, part 13b): run_sweep raises on any other value
    pipeline: bool = False
    compile_cache: Optional[str] = None
    device_trace_dir: Optional[str] = None
    # fault-injection plan (resilience/inject.py); None: DLBB_FAULT_PLAN
    fault_plan: Optional[str] = None
    # wall-clock watchdog per config; None: DLBB_UNIT_DEADLINE, else off
    unit_deadline_seconds: Optional[float] = None
    # bounded retries of transient failures, with exponential backoff
    max_retries: int = 2
    retry_backoff_seconds: float = 0.05
    # sweep_journal.jsonl beside the results
    journal: bool = True
    # the span trace's file; None: DLBB_SPANS, else off
    span_trace: Optional[str] = None

    kind: str = "1d"


@dataclass(frozen=True)
class Sweep3D:
    """3D LLM-shaped tensor collective sweep over (batch, seq, hidden)."""

    implementation: Optional[str] = None
    variant: str = "default"
    operations: tuple[str, ...] = OPERATIONS_3D
    batch_sizes: tuple[int, ...] = tuple(GRID_3D["batch_sizes"])
    seq_lengths: tuple[int, ...] = tuple(GRID_3D["seq_lengths"])
    hidden_dims: tuple[int, ...] = tuple(GRID_3D["hidden_dims"])
    rank_counts: tuple[int, ...] = (4, 8)
    dtype: str = "bfloat16"
    warmup_iterations: int = 10
    measurement_iterations: int = 100
    output_dir: str = "results/torch/3d"
    root: int = 0
    timing_mode: str = "per_iter"
    max_config_seconds: Optional[float] = None
    max_global_bytes: Optional[int] = None
    resume: bool = False
    pipeline: bool = False
    compile_cache: Optional[str] = None
    device_trace_dir: Optional[str] = None
    fault_plan: Optional[str] = None
    unit_deadline_seconds: Optional[float] = None
    max_retries: int = 2
    retry_backoff_seconds: float = 0.05
    journal: bool = True
    span_trace: Optional[str] = None

    kind: str = "3d"


@dataclass
class SweepResult:
    """What one rank's ``run_sweep`` did: the result files it wrote (or, on
    resume, found valid), the configs that failed (file name and error),
    and the configs skipped for the rank count, the variant or the
    memory cap."""

    written: list[Path] = field(default_factory=list)
    failed: list[dict[str, str]] = field(default_factory=list)
    skipped: int = 0


_PAYLOAD_CACHE_BYTES_ENV = "DLBB_PAYLOAD_CACHE_BYTES"
DEFAULT_PAYLOAD_CACHE_BYTES = 1 << 30  # 1 GiB of payloads per rank

# How long a rank waits at the end of a rank count for the ranks still
# measuring it.  A rank count of a large grid runs for hours over gloo, so
# this is not the collective timeout; a rank that dies closes its gloo
# connections, which fails the others' wait at once.
HOLD_TIMEOUT = timedelta(days=1)


class PayloadCache:
    """Byte-budgeted LRU of this rank's payloads (the JAX runner's
    ``bench/schedule.py::PayloadCache``): ops that share a key reuse one
    tensor instead of drawing it again.  The budget is ``max_bytes``, else
    ``DLBB_PAYLOAD_CACHE_BYTES``, else 1 GiB; a payload larger than the
    budget passes through uncached, and the least recently used entries
    go when a new one would exceed it.  A payload counts the bytes of
    its whole mesh, this rank's tensor times its ``ranks``, as JAX counts
    its global array, so one budget holds the same payloads on both."""

    def __init__(self, max_bytes: Optional[int] = None) -> None:
        if max_bytes is None:
            max_bytes = int(os.environ.get(_PAYLOAD_CACHE_BYTES_ENV,
                                           DEFAULT_PAYLOAD_CACHE_BYTES))
        self.max_bytes = max_bytes
        # key -> (tensor, its mesh's bytes)
        self._entries: OrderedDict[tuple, tuple[torch.Tensor, int]] = OrderedDict()
        self.nbytes = 0
        self.hits = self.misses = self.evictions = 0

    def get(self, key: tuple, build: Callable[[], torch.Tensor],
            ranks: int = 1) -> torch.Tensor:
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry[0]
        self.misses += 1
        t = build()
        nbytes = t.nbytes * ranks
        if nbytes > self.max_bytes:
            return t
        self._entries[key] = (t, nbytes)
        self.nbytes += nbytes
        while self.nbytes > self.max_bytes:
            _, (_, old) = self._entries.popitem(last=False)
            self.nbytes -= old
            self.evictions += 1
        return t

    def invalidate(self, key: tuple) -> None:
        """Drop ``key`` (a failed config's payload is drawn again)."""
        entry = self._entries.pop(key, None)
        if entry is not None:
            self.nbytes -= entry[1]

    def stats(self) -> dict[str, int]:
        """JAX's ``PayloadCache.stats`` keys, for the manifest."""
        return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                "resident_bytes": self.nbytes, "budget_bytes": self.max_bytes}

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries


def _check_sweep(sweep) -> None:
    defaults = {f.name: f.default for f in fields(sweep)}
    for knob, what in _NOT_PORTED_KNOBS.items():
        if getattr(sweep, knob) != defaults[knob]:
            raise NotImplementedError(
                f"{type(sweep).__name__}.{knob}={getattr(sweep, knob)!r}: "
                f"{what} is not ported (ROADMAP Queue 1, Slice F, item 13, part 13b)")
    if sweep.timing_mode != "per_iter":
        raise NotImplementedError(
            f"timing_mode={sweep.timing_mode!r}: the port times per "
            "iteration only (the chained regime is not ported)")
    if sweep.dtype not in DTYPES:
        raise ValueError(f"dtype {sweep.dtype!r}; known: {sorted(DTYPES)}")


def _impl_name(sweep, backend: str) -> str:
    impl = sweep.implementation or f"torch_{backend}"
    if sweep.variant and sweep.variant != "default":
        return f"{impl}_{sweep.variant}"
    return impl


def _build_fn(op_name: str, variant: Variant, mesh: Mesh, root: int):
    if op_name == "allreduce" and variant.hierarchical:
        return build_allreduce_hierarchical(mesh, root)
    if op_name in MATMUL_OPS and variant.overlap_schedule is not None:
        return get_op(op_name).build(mesh, root, schedule=variant.overlap_schedule)
    if op_name in COMPRESSED_OPS:
        compression, accum = variant.compressed_wire()
        return get_op(op_name).build(mesh, root, compression=compression,
                                     accum_dtype=accum)
    return get_op(op_name).build(mesh, root)


def _payload_geometry(sweep, config) -> tuple[int, Optional[tuple[int, ...]]]:
    """(num_elements, per-rank payload shape) of one config."""
    if sweep.kind == "1d":
        return config["num_elements"], None
    shape = (config["batch"], config["seq_len"], config["hidden_dim"])
    return int(np.prod(shape)), shape


def _estimate_global_bytes(sweep, config, num_ranks: int) -> int:
    """Global input+output bytes of one config, from the op's declared
    buffer kinds (``per_peer`` is P^2 x payload, ``per_rank`` P x), plus the
    fused schedule's transient where the op declares one.  An overlap
    variant's ring never holds that transient (one travelling chunk rides
    inside the input and output), so it is charged none: charging it would
    skip the very configs whose memory the variant exists to show."""
    op = get_op(config["operation"])
    n = _payload_geometry(sweep, config)[0]
    itemsize = torch.empty((), dtype=DTYPES[sweep.dtype]).element_size()

    def mult(kind):
        return num_ranks * num_ranks if kind == "per_peer" else num_ranks

    transient = mult(op.transient_kind) if op.transient_kind else 0
    if op.name in MATMUL_OPS and get_variant(sweep.variant).overlap_schedule is not None:
        transient = 0
    return (mult(op.input_kind) + mult(op.output_kind) + transient) * n * itemsize


def _iter_configs(sweep):
    if sweep.kind == "1d":
        for op in sweep.operations:
            for label, n in sweep.data_sizes:
                yield {"operation": op, "size_label": label, "num_elements": n}
    else:
        for op in sweep.operations:
            for b in sweep.batch_sizes:
                for s in sweep.seq_lengths:
                    for h in sweep.hidden_dims:
                        yield {"operation": op, "batch": b, "seq_len": s,
                               "hidden_dim": h}


# file-name tags of the non-bf16 dtypes (the JAX package's names)
_DTYPE_FILE_TAG = {"float32": "fp32", "float16": "fp16"}


def _result_filename(sweep, impl: str, num_ranks: int, config) -> str:
    op_name = config["operation"]
    tag = _DTYPE_FILE_TAG.get(sweep.dtype)
    suffix = f"_{tag}" if tag else ""
    if sweep.kind == "1d":
        return (f"{impl}_{op_name}_ranks{num_ranks}_"
                f"{config['size_label']}{suffix}.json")
    b, s, h = config["batch"], config["seq_len"], config["hidden_dim"]
    return f"{impl}_{op_name}_ranks{num_ranks}_b{b}_s{s}_h{h}{suffix}.json"


def _validate_result(path: Path) -> tuple[bool, str]:
    """Whether a result JSON is whole: it parses, carries the fields the
    stats read, and its timings are finite (the JAX package's
    ``resilience.validate.validate_result_json``)."""
    if not path.exists():
        return False, "missing"
    try:
        data = json.loads(path.read_text())
    except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
        return False, f"unparseable ({type(e).__name__}: {e})"
    if not isinstance(data, dict):
        return False, "not a JSON object"
    missing = [k for k in ("implementation", "operation", "num_ranks",
                           "num_elements", "timings") if k not in data]
    if missing:
        return False, f"missing fields {missing}"
    try:
        arr = np.asarray(data["timings"], dtype=np.float64)
    except (TypeError, ValueError) as e:
        return False, f"non-numeric timings ({e})"
    if arr.size == 0 or not np.isfinite(arr).all():
        return False, "empty or non-finite timings"
    return True, "ok"


def _resume_ok(path: Path, mesh: Mesh) -> tuple[bool, str]:
    """The mesh's rank 0 (the one that writes) decides whether resume may
    skip this config, and every rank of the mesh follows it."""
    verdict = [_validate_result(path) if mesh.rank == 0 else None]
    dist.broadcast_object_list(verdict, src=0, group=mesh.group)
    return verdict[0]


def _gather_timings(local: list[float], mesh: Mesh) -> list[list[float]]:
    """Every rank's timings, ``[rank][iteration]``."""
    rows: list[Any] = [None] * mesh.spec.num_ranks
    dist.all_gather_object(rows, local, group=mesh.group)
    return rows


def _payload_key(sweep, mesh: Mesh, config) -> tuple:
    """A payload's identity: its mesh, its op's input kind and its shape."""
    num_elements, shape = _payload_geometry(sweep, config)
    return mesh.spec.num_ranks, get_op(config["operation"]).input_kind, num_elements, shape


@dataclass
class _Run:
    """One rank's sweep-wide state: its journal, counters, quarantine and
    watchdog records (the manifest's ``resilience`` section)."""

    journal: SweepJournal
    counts: Any
    guard: PreemptionGuard
    deadline: Optional[float]
    # the sweep's payloads, a fresh cache after a hang, as JAX's
    payloads: PayloadCache = field(default_factory=PayloadCache)
    quarantined: list = field(default_factory=list)
    retries_total: int = 0
    abandoned: int = 0
    preempted: bool = False


def _resolve_deadline(sweep) -> Optional[float]:
    """The per-config wall-clock deadline: the sweep's, else
    ``DLBB_UNIT_DEADLINE``, else none."""
    if sweep.unit_deadline_seconds is not None:
        return float(sweep.unit_deadline_seconds)
    env = os.environ.get("DLBB_UNIT_DEADLINE", "").strip()
    return float(env) if env else None


def _rank0_flag(flag: bool, mesh: Mesh, dev: torch.device) -> bool:
    """Rank 0's ``flag``, broadcast over the mesh."""
    if mesh.spec.num_ranks == 1:
        return flag
    t = torch.tensor([int(flag)], device=dev)
    dist.broadcast(t, src=mesh.global_rank(0), group=mesh.group)
    return bool(t.item())


def _fire(site: str, mesh: Mesh, dev: torch.device) -> bool:
    """``inject.fire(site)`` on the mesh's rank 0, and its verdict on every
    rank (each rank's plan counts its own hits, and ranks past a smaller
    mesh skip its configs); no collective without an active plan, which
    every rank shares (the sweep's or the environment's)."""
    if inject.active() is None:
        return False
    return _rank0_flag(inject.fire(site) if mesh.rank == 0 else False, mesh, dev)


def _any_rank(flag: bool, group, dev: torch.device) -> bool:
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def _watched(fn, deadline: Optional[float], label: str, mesh: Mesh, dev: torch.device):
    """``fn(cancel)`` under the watchdog (JAX's ``_call_with_deadline``):
    with no deadline a direct call; with one, on a daemon thread joined for
    ``deadline`` seconds.  Rank 0's verdict decides on every rank of the
    mesh: an overrun sets ``cancel`` (the abandoned thread checks it after
    an injected hang, before any collective, and before its write) and
    raises ``DeadlineExceeded``; where rank 0 finished, so does the rest of
    the mesh's collective, and a rank still running is waited for."""
    if deadline is None:
        return fn(None)
    box: dict[str, Any] = {}
    cancel = threading.Event()

    def target() -> None:
        try:
            box["value"] = fn(cancel)
        except BaseException as e:  # noqa: BLE001 — marshalled to the caller
            box["error"] = e

    t = threading.Thread(target=target, daemon=True, name=f"dlbb-measure-{label}")
    t.start()
    t.join(deadline)
    if _rank0_flag(t.is_alive(), mesh, dev):
        cancel.set()
        raise DeadlineExceeded(label, deadline, phase="measure")
    t.join()
    if "error" in box:
        raise box["error"]
    return box["value"]


def run_sweep(sweep: Sweep1D | Sweep3D, device=None,
              verbose: bool = True) -> SweepResult:
    """Run ``sweep`` on this rank; see the module docstring.  ``device`` is
    ``cuda`` unless the caller names ``cpu``; it raises without CUDA, and
    when the process group's backend is not the device's (NCCL on cuda,
    gloo on cpu)."""
    _check_sweep(sweep)
    variant = get_variant(sweep.variant)
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("run_sweep runs in a process group: start it "
                           "through bench.launch.launch or "
                           "comm.initialize_distributed")
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise RuntimeError(f"a {dev.type} sweep needs the {BACKENDS[dev.type]} "
                           f"backend, the process group has {backend}")
    impl = _impl_name(sweep, backend)
    # an explicit plan wins; else a plan already active (an embedding
    # harness) is left alone; else the environment's
    fault_spec = sweep.fault_plan
    if fault_spec is None and inject.active() is None:
        fault_spec = os.environ.get(inject.ENV_VAR, "").strip() or None
    span_path = (sweep.span_trace or spans.default_span_path()
                 if dist.get_rank() == 0 else None)
    with spans.tracing(span_path, meta={"kind": sweep.kind, "implementation": impl,
                                        "variant": variant.name}), \
            inject.plan_scope(fault_spec), PreemptionGuard() as guard:
        return _run_sweep_configured(sweep, variant, impl, dev, backend, guard, verbose)


def _run_sweep_configured(sweep, variant: Variant, impl: str, dev: torch.device,
                          backend: str, guard: PreemptionGuard,
                          verbose: bool) -> SweepResult:
    t0 = time.perf_counter()
    out_dir = Path(sweep.output_dir)
    world = dist.get_world_size()
    rank0 = dist.get_rank() == 0
    sysinfo = collect_system_info(dev)
    configs = list(_iter_configs(sweep))
    result = SweepResult()
    journal = SweepJournal(
        out_dir, meta={"kind": sweep.kind, "implementation": impl,
                       "variant": variant.name, "resume": sweep.resume,
                       "fault_plan": getattr(inject.active(), "spec", None)},
        enabled=sweep.journal and rank0, sink=spans.journal_sink)
    topology = topology_record(dev)
    journal.event("topology", **topology)
    metrics = MetricsRegistry()
    metrics.inc("sweep_degraded", 0,
                help="sweeps measured on a degraded (fallback) backend")
    counts = metrics.labeled_counter(
        "sweep_configs", "outcome",
        initial=("resumed", "resume_invalid", "skipped_mem", "skipped_ranks",
                 "measured", "failed"),
        help="sweep configs by lifecycle outcome")
    run = _Run(journal, counts, guard, _resolve_deadline(sweep))
    # gloo on every backend: its barrier waits on the host, and a peer's
    # death breaks it at once
    hold_group = (dist.new_group(backend="gloo", timeout=HOLD_TIMEOUT)
                  if world > 1 else None)
    planned = 0

    for num_ranks in sweep.rank_counts:
        reason = f"{num_ranks} ranks > {world} in the process group"
        spec = None
        if num_ranks <= world:
            try:
                spec = variant.mesh_spec(num_ranks)
            except ValueError as e:
                reason = str(e)
        if spec is None:
            result.skipped += len(configs)
            counts["skipped_ranks"] += len(configs)
            journal.event("rank-skip", num_ranks=num_ranks, reason=reason)
            if verbose and rank0:
                print(f"[skip] ranks={num_ranks}: {reason}")
            continue
        mesh = get_mesh(spec)
        if mesh is not None:  # the ranks past the mesh sit this count out
            planned += _run_rank_count(sweep, variant, impl, mesh, configs, dev,
                                       out_dir, sysinfo, verbose, result, run)
        if hold_group is not None:
            # every rank waits for the whole count, and all stop where any
            # was preempted
            run.preempted = _any_rank(run.preempted or guard.requested, hold_group,
                                      torch.device("cpu"))
        if run.preempted:
            break

    if rank0 and (planned or counts["resumed"]):
        tracer = spans.active()
        manifest = {
            "kind": sweep.kind, "implementation": impl, "variant": variant.name,
            "topology": topology,
            # the port has no cost model (JAX's analysis/costmodel.py)
            "cost_model_version": None,
            "timing_mode": sweep.timing_mode,
            # eager torch.distributed calls: nothing is compiled, cached or
            # compiled ahead (the compile-ahead engine is item 13, part 13b)
            "pipeline": False, "prefetch": 0,
            "wall_seconds": time.perf_counter() - t0,
            "compile_seconds_total": 0.0,
            "compile_cache": {"dir": None, "enabled": False, "persistent_hits": 0,
                              "persistent_misses": 0},
            "work_units": {"planned_configs": planned, "unique": 0, "compile_failed": 0},
            "configs": dict(counts),
            "payload_cache": run.payloads.stats(),
            "observability": {"span_trace": str(tracer.path) if tracer else None,
                              "device_trace_dir": None, "device_captures": 0},
            "resilience": {
                "fault_plan": getattr(inject.active(), "spec", None),
                "unit_deadline_seconds": run.deadline,
                "max_retries": sweep.max_retries,
                "retries_total": run.retries_total,
                "quarantined": run.quarantined,
                "preempted": run.preempted,
                "watchdog": {"abandoned_measurements": run.abandoned,
                             "abandoned_compiles": 0, "scheduler_wedged": False,
                             "gate_degraded": False},
            },
            "timestamp": time.time(),
        }
        save_json({"schema": MANIFEST_SCHEMA, **manifest}, out_dir / MANIFEST_NAME)
        sweep_metrics(manifest, metrics).write_textfile(out_dir / "metrics.prom")
        if tracer is not None:
            tracer.finish()
    journal.event("sweep-end", preempted=run.preempted, measured=counts["measured"],
                  failed=counts["failed"])
    journal.close()
    return result


def _plan(sweep, mesh: Mesh, configs, impl: str, out_dir: Path, verbose: bool,
          result: SweepResult, run: _Run) -> list:
    """This rank count's configs to measure, past the memory cap and
    ``resume``'s valid artifacts, each journaled."""
    num_ranks, journal, counts = mesh.spec.num_ranks, run.journal, run.counts
    say = verbose and mesh.rank == 0
    todo = []
    for config in configs:
        fname = _result_filename(sweep, impl, num_ranks, config)
        try:
            if sweep.max_global_bytes is not None:
                est = _estimate_global_bytes(sweep, config, num_ranks)
                if est > sweep.max_global_bytes:
                    result.skipped += 1
                    counts["skipped_mem"] += 1
                    journal.event("skipped", config=fname, reason="memory-cap",
                                  estimated_bytes=est)
                    if say:
                        print(f"[skip-mem] {fname}: ~{est / 2**30:.1f} GiB "
                              f"> cap {sweep.max_global_bytes / 2**30:.1f} GiB")
                    continue
            if sweep.resume:
                ok, why = _resume_ok(out_dir / fname, mesh)
                if ok:
                    counts["resumed"] += 1
                    journal.event("resume-valid", config=fname)
                    result.written.append(out_dir / fname)
                    if say:
                        print(f"  [resume-skip] {fname}")
                    continue
                if why != "missing":
                    counts["resume_invalid"] += 1
                    journal.event("resume-invalid", config=fname, reason=why)
                    if say:
                        print(f"  [resume-INVALID] {fname}: {why} — re-measuring")
            todo.append((config, fname))
            journal.event("planned", config=fname)
        except Exception as e:  # noqa: BLE001 — a config fails alone
            _quarantine(run, result, fname, "planning", 0, e, verbose)
    return todo


def _quarantine(run: _Run, result: SweepResult, fname: str, phase: str, retries: int,
                e: BaseException, verbose: bool) -> None:
    run.counts["failed"] += 1
    run.quarantined.append({"config": fname, "phase": phase, "retries": retries,
                            **exception_chain(e)})
    run.journal.event("failed", config=fname, phase=phase, retries=retries, error=str(e))
    result.failed.append({"config": fname, "error": f"{type(e).__name__}: {e}"})
    if verbose:
        print(f"[error] rank {dist.get_rank()} {fname}: {e}")
        traceback.print_exception(type(e), e, e.__traceback__)


def _run_rank_count(sweep, variant: Variant, impl: str, mesh: Mesh, configs,
                    dev: torch.device, out_dir: Path, sysinfo, verbose: bool,
                    result: SweepResult, run: _Run) -> int:
    """Measure this rank count's configs; returns how many were planned."""
    with spans.span("plan", cat="sweep", num_ranks=mesh.spec.num_ranks):
        todo = _plan(sweep, mesh, configs, impl, out_dir, verbose, result, run)
    attempts = max(0, int(sweep.max_retries)) + 1
    journal = run.journal
    for config, fname in todo:
        if _fire("preempt", mesh, dev):
            # a real SIGTERM, which the PreemptionGuard turns into its flag
            os.kill(os.getpid(), signal.SIGTERM)
        requested = run.guard.requested
        if (_any_rank(requested, mesh.group, dev) if mesh.spec.num_ranks > 1
                else requested):
            run.preempted = True
            journal.event("preempted", config=fname, signal=run.guard.signal_received)
            if verbose and mesh.rank == 0:
                print(f"[preempt] SIGTERM received — stopping before {fname}; "
                      "journal flushed, resume completes the grid")
            break
        journal.event("started", config=fname)
        last_exc: Optional[BaseException] = None
        attempt = 0
        for attempt in range(attempts):
            try:
                with spans.span(fname, cat="config", attempt=attempt):
                    path = _watched(
                        lambda cancel: _run_one(sweep, variant, impl, mesh, config,
                                                run.payloads, dev, out_dir / fname,
                                                sysinfo, verbose, attempt, cancel),
                        run.deadline, fname, mesh, dev)
                if path is not None:
                    result.written.append(path)
                run.counts["measured"] += 1
                run.retries_total += attempt
                journal.event("completed", config=fname, retries=attempt)
                last_exc = None
                break
            except DeadlineExceeded as e:
                # a hang is not transient: the abandoned thread may still
                # hold the payloads, so later configs get a fresh cache
                run.abandoned += 1
                run.payloads = PayloadCache()
                last_exc = e
                break
            except Exception as e:  # noqa: BLE001 — a config fails alone
                run.payloads.invalidate(_payload_key(sweep, mesh, config))
                last_exc = e
                if is_transient(e) and attempt < attempts - 1:
                    delay = sweep.retry_backoff_seconds * (2 ** attempt)
                    journal.event("retry", config=fname, attempt=attempt + 1,
                                  error=str(e), backoff_seconds=delay)
                    if verbose and mesh.rank == 0:
                        print(f"[retry] {impl} {fname}: transient {type(e).__name__}: "
                              f"{e} — backing off {delay:.3f}s (attempt "
                              f"{attempt + 1}/{attempts - 1})")
                    time.sleep(delay)
                    continue
                break
        if last_exc is not None:
            _quarantine(run, result, fname, "measure", attempt, last_exc, verbose)
    return len(todo)


def _run_one(sweep, variant: Variant, impl: str, mesh: Mesh, config,
             payloads: PayloadCache, dev: torch.device, path: Path, sysinfo,
             verbose: bool, retries: int = 0,
             cancel: Optional[threading.Event] = None) -> Optional[Path]:
    """Measure one config; the mesh's rank 0 writes its JSON and returns
    the path, the other ranks return None.  ``cancel`` is the watchdog's
    (``_watched``): once set, this abandoned call runs no collective and
    writes nothing."""
    num_ranks = mesh.spec.num_ranks
    op_name = config["operation"]
    op = get_op(op_name)
    dtype = DTYPES[sweep.dtype]
    num_elements, shape = _payload_geometry(sweep, config)
    # every op leaves its input untouched, so configs share payloads
    with spans.span("payload", cat="payload", label=path.name):
        x = payloads.get(_payload_key(sweep, mesh, config), lambda: make_payload(
            op, mesh.rank, num_ranks, num_elements, dtype=dtype, shape=shape,
            device=dev), ranks=num_ranks)
    fn = _build_fn(op_name, variant, mesh, sweep.root)
    # JAX's fault sites, before the timed region
    if _fire("exec-transient", mesh, dev):
        raise inject.TransientFault(f"injected transient runtime failure for {path.name}")
    if _fire("exec-hang", mesh, dev):
        time.sleep(inject.param("hang_seconds"))
    if cancel is not None and cancel.is_set():
        raise DeadlineExceeded(path.name, 0.0, phase="measure (abandoned before its "
                               "collectives)")
    with spans.span("measure", cat="measure", label=path.name, mode="per_iter"):
        local, timing_meta = time_collective(
            fn, x, mesh.group, warmup=sweep.warmup_iterations,
            iterations=sweep.measurement_iterations, device=dev,
            max_seconds=sweep.max_config_seconds)
    if _fire("stats-nan", mesh, dev) and mesh.rank == 0:
        # poison the timings after the timed region: the check below must
        # refuse to publish them
        local = list(local)
        local[0] = float("nan")
        if len(local) > 1:
            local[-1] = float("inf")
    timings = _gather_timings(local, mesh)
    if not np.isfinite(np.asarray(timings, dtype=np.float64)).all():
        # every rank sees the gathered timings, so every rank retries
        raise CorruptStats(f"{path.name}: non-finite timings — refusing to write "
                           "the artifact")
    if mesh.rank != 0:
        return None
    result: dict[str, Any] = {
        "implementation": impl,
        "mpi_implementation": impl,  # the key the 1D stats reader prefers
        "operation": op_name,
        "num_ranks": num_ranks,
        "num_elements": num_elements,
        "dtype": sweep.dtype,
        "warmup_iterations": sweep.warmup_iterations,
        "measurement_iterations": sweep.measurement_iterations,
        # eager torch.distributed calls: nothing is compiled or cached
        "compile_seconds": 0.0,
        "compile_cache_hit": None,
        "retries": retries,
        **timing_meta,
        "timings": timings,
        "variant": variant.name,
        # the wire of the quantised micro-ops, which the stats price
        **({"compression": variant.compressed_wire()[0]}
           if op_name in COMPRESSED_OPS else {}),
        "mesh_shape": list(mesh.spec.shape),
        "mesh_axis_names": list(mesh.axis_names),
        "payload_bytes_per_rank": num_elements * torch.empty(
            (), dtype=dtype).element_size(),
        "timestamp": time.time(),
        "system_info": sysinfo,
    }
    if sweep.kind == "1d":
        result["data_size_name"] = config["size_label"]
    else:
        b, s, h = config["batch"], config["seq_len"], config["hidden_dim"]
        tensor_size_bytes = num_elements * 2  # as bf16, like the reference
        result["tensor_shape"] = {"batch": b, "seq_len": s, "hidden_dim": h}
        result["tensor_size_bytes"] = tensor_size_bytes
        result["tensor_size_mb"] = tensor_size_bytes / 2**20
    if cancel is not None and cancel.is_set():
        # the watchdog abandoned this call and quarantined the config: a
        # late write must not bring it back
        raise DeadlineExceeded(path.name, 0.0, phase="measure (zombie write "
                               "suppressed after abandonment)")
    with spans.span("write", cat="io", file=path.name):
        save_json(result, path)
    if verbose:
        median_ms = float(np.median(np.asarray(timings))) * 1e3
        print(f"  [{impl}] {path.name}: median {median_ms:.3f} ms (per_iter)")
    return path
