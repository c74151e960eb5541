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

A config that fails is printed with its traceback, recorded and skipped,
as in JAX; ``run_sweep`` returns the failures beside the files written.
A failure on one rank only cannot be contained: its peers wait in the
op's collective until the process group's timeout.

Not ported in this slice (ROADMAP Queue 1, Slice F): the compile-ahead
engine and its compile cache, fault injection, the deadline watchdog,
retries, the journal, span traces and device traces.  The sweeps keep their
knobs with the values that mean "off", and ``run_sweep`` raises on any
other value.
"""

from __future__ import annotations

import json
import os
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
    DTYPES,
    MATMUL_OPS,
    build_allreduce_hierarchical,
    get_op,
    make_payload,
)
from dlbb_tpu_torch.comm.variants import Variant, get_variant
from dlbb_tpu_torch.utils.config import save_json
from dlbb_tpu_torch.utils.sysinfo import collect_system_info, resolve_device
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
    "fault_plan": "fault injection (resilience/inject.py)",
    "unit_deadline_seconds": "the deadline watchdog",
    "max_retries": "retries of transient failures",
    "journal": "the sweep journal (resilience/journal.py)",
    "span_trace": "span traces (obs/spans.py)",
    "device_trace_dir": "device traces (obs/capture.py)",
}


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
    output_dir: str = "results/1d"
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
    # not ported (Slice F): run_sweep raises on any other value
    pipeline: bool = False
    compile_cache: Optional[str] = None
    fault_plan: Optional[str] = None
    unit_deadline_seconds: Optional[float] = None
    max_retries: int = 0
    journal: bool = False
    span_trace: Optional[str] = None
    device_trace_dir: Optional[str] = None

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
    output_dir: str = "results/3d"
    root: int = 0
    timing_mode: str = "per_iter"
    max_config_seconds: Optional[float] = None
    max_global_bytes: Optional[int] = None
    resume: bool = False
    pipeline: bool = False
    compile_cache: Optional[str] = None
    fault_plan: Optional[str] = None
    unit_deadline_seconds: Optional[float] = None
    max_retries: int = 0
    journal: bool = False
    span_trace: Optional[str] = None
    device_trace_dir: Optional[str] = None

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
    go when a new one would exceed it."""

    def __init__(self, max_bytes: Optional[int] = None) -> None:
        if max_bytes is None:
            max_bytes = int(os.environ.get(_PAYLOAD_CACHE_BYTES_ENV,
                                           DEFAULT_PAYLOAD_CACHE_BYTES))
        self.max_bytes = max_bytes
        self._entries: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self.nbytes = 0

    def get(self, key: tuple, build: Callable[[], torch.Tensor]) -> torch.Tensor:
        t = self._entries.get(key)
        if t is not None:
            self._entries.move_to_end(key)
            return t
        t = build()
        if t.nbytes > self.max_bytes:
            return t
        self._entries[key] = t
        self.nbytes += t.nbytes
        while self.nbytes > self.max_bytes:
            _, old = self._entries.popitem(last=False)
            self.nbytes -= old.nbytes
        return t

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries


def _check_sweep(sweep) -> None:
    defaults = {f.name: f.default for f in fields(sweep)}
    for knob, what in _NOT_PORTED_KNOBS.items():
        if getattr(sweep, knob) != defaults[knob]:
            raise NotImplementedError(
                f"{type(sweep).__name__}.{knob}={getattr(sweep, knob)!r}: "
                f"{what} is not ported (ROADMAP Queue 1, Slice F, item 14)")
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
    out_dir = Path(sweep.output_dir)
    world = dist.get_world_size()
    sysinfo = collect_system_info(dev)
    configs = list(_iter_configs(sweep))
    result = SweepResult()
    # gloo on every backend: its barrier waits on the host, and a peer's
    # death breaks it at once
    hold_group = (dist.new_group(backend="gloo", timeout=HOLD_TIMEOUT)
                  if world > 1 else None)

    for num_ranks in sweep.rank_counts:
        if num_ranks > world:
            result.skipped += len(configs)
            if verbose and dist.get_rank() == 0:
                print(f"[skip] {num_ranks} ranks > {world} in the process group")
            continue
        try:
            spec = variant.mesh_spec(num_ranks)
        except ValueError as e:
            result.skipped += len(configs)
            if verbose and dist.get_rank() == 0:
                print(f"[skip] ranks={num_ranks}: {e}")
            continue
        mesh = get_mesh(spec)
        if mesh is not None:  # the ranks past the mesh sit this count out
            _run_rank_count(sweep, variant, impl, mesh, configs, dev,
                            out_dir, sysinfo, verbose, result)
        if hold_group is not None:  # every rank waits for the whole count
            dist.barrier(group=hold_group)
    return result


def _run_rank_count(sweep, variant: Variant, impl: str, mesh: Mesh, configs,
                    dev: torch.device, out_dir: Path, sysinfo, verbose: bool,
                    result: SweepResult) -> None:
    num_ranks = mesh.spec.num_ranks
    payloads = PayloadCache()
    for config in configs:
        fname = _result_filename(sweep, impl, num_ranks, config)
        try:
            if sweep.max_global_bytes is not None:
                est = _estimate_global_bytes(sweep, config, num_ranks)
                if est > sweep.max_global_bytes:
                    result.skipped += 1
                    if verbose and mesh.rank == 0:
                        print(f"[skip-mem] {fname}: ~{est / 2**30:.1f} GiB "
                              f"> cap {sweep.max_global_bytes / 2**30:.1f} GiB")
                    continue
            if sweep.resume:
                ok, why = _resume_ok(out_dir / fname, mesh)
                if ok:
                    result.written.append(out_dir / fname)
                    if verbose and mesh.rank == 0:
                        print(f"  [resume-skip] {fname}")
                    continue
                if why != "missing" and verbose and mesh.rank == 0:
                    print(f"  [resume-INVALID] {fname}: {why} — re-measuring")
            path = _run_one(sweep, variant, impl, mesh, config, payloads,
                            dev, out_dir / fname, sysinfo, verbose)
            if path is not None:
                result.written.append(path)
        except Exception as e:  # noqa: BLE001 — a config fails alone
            result.failed.append({"config": fname,
                                  "error": f"{type(e).__name__}: {e}"})
            print(f"[error] rank {mesh.rank} {impl} {fname}: {e}")
            traceback.print_exc()


def _run_one(sweep, variant: Variant, impl: str, mesh: Mesh, config,
             payloads: PayloadCache, dev: torch.device, path: Path, sysinfo,
             verbose: bool) -> Optional[Path]:
    """Measure one config; the mesh's rank 0 writes its JSON and returns
    the path, the other ranks return None."""
    num_ranks = mesh.spec.num_ranks
    op_name = config["operation"]
    op = get_op(op_name)
    dtype = DTYPES[sweep.dtype]
    num_elements, shape = _payload_geometry(sweep, config)
    # every op leaves its input untouched, so configs share payloads
    x = payloads.get((op.input_kind, num_elements, shape), lambda: make_payload(
        op, mesh.rank, num_ranks, num_elements, dtype=dtype, shape=shape,
        device=dev))
    fn = _build_fn(op_name, variant, mesh, sweep.root)
    local, timing_meta = time_collective(
        fn, x, mesh.group, warmup=sweep.warmup_iterations,
        iterations=sweep.measurement_iterations, device=dev,
        max_seconds=sweep.max_config_seconds)
    timings = _gather_timings(local, mesh)
    if not np.isfinite(np.asarray(timings, dtype=np.float64)).all():
        raise RuntimeError(f"{path.name}: non-finite timings, not written")
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
        "retries": 0,
        **timing_meta,
        "timings": timings,
        "variant": variant.name,
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
    save_json(result, path)
    if verbose:
        median_ms = float(np.median(np.asarray(timings))) * 1e3
        print(f"  [{impl}] {path.name}: median {median_ms:.3f} ms (per_iter)")
    return path
