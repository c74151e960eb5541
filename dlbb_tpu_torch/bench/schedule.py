"""The sweep's compile-ahead engine (counterpart of
``dlbb_tpu/bench/schedule.py``).

The JAX engine overlaps XLA compilation with measurement.  Eager torch
compiles no program, so a work unit's "compile" here is the host work done
before a config's first measured call: resolve the op and its variant,
check the payload's shape and build the callable (``comm.ops.Collective``).
The mechanisms carry over unchanged:

- **Work units** — the grid is walked once up front and deduplicated by
  :func:`work_unit_key` ``(op, variant, mesh, axes, root, payload shape and
  dtype, timing fingerprint)``; configs that share a key share one built
  callable, configs that differ in any component never do.
- **Compile-ahead** — :class:`CompileAheadScheduler` builds units N+1..N+k
  on a background thread while unit N's configs are measured; ``k`` is the
  sweep's ``prefetch``, and ``pipeline=False`` builds inline through the
  same code path.  A build never issues a collective, creates a process
  group or communicator, or allocates on the device: the meshes and their
  groups are made on the main thread, in the same order on every rank,
  before the engine starts (``bench/runner.py``).
- **The measurement gate** (:class:`MeasureGate`) keeps builds out of
  timed regions.

The persistent compilation cache has no counterpart: the port's only
compiled artifacts are ``ops/_build.py``'s nvcc objects, built once per
source hash.  ``compile_cache`` accepts JAX's default ``"auto"`` and its
"off" values and records the cache as disabled with :data:`NO_CACHE_REASON`
(:func:`compile_cache_record`); a directory is refused with that reason.

``PayloadCache`` and ``write_sweep_manifest`` are JAX's, as the runner uses
them.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterable, Optional, Sequence

import torch

from dlbb_tpu_torch.obs import spans
from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.resilience.errors import DeadlineExceeded, InjectedFault

# ---------------------------------------------------------------------------
# the compilation cache: none to configure
# ---------------------------------------------------------------------------

_CACHE_OFF_VALUES = {"", "off", "none", "0", "disabled"}
NO_CACHE_REASON = ("eager torch compiles no program: a work unit builds a "
                   "callable on the host, and the port's only compiled artifacts "
                   "are ops/_build.py's nvcc objects, built once per source hash")


def compile_cache_record(setting: Optional[str] = "auto") -> dict[str, Any]:
    """JAX's ``compile_cache`` manifest block for ``setting`` (the sweep's
    ``compile_cache``; ``DLBB_XLA_CACHE`` overrides it, as in JAX), without
    its hit and miss counts: ``"auto"`` and the "off" values give the
    disabled cache; a directory raises ``ValueError`` with the reason."""
    env = os.environ.get("DLBB_XLA_CACHE")
    if env is not None:
        setting = env
    if setting is not None and str(setting).lower() not in _CACHE_OFF_VALUES | {"auto"}:
        raise ValueError(f"compile_cache={setting!r}: there is no compilation cache "
                         f"to place there; {NO_CACHE_REASON}")
    return {"dir": None, "enabled": False, "reason": NO_CACHE_REASON}


def default_pipeline() -> bool:
    """Whether the compile-ahead thread runs on this host (JAX's policy):
    ``DLBB_SWEEP_PIPELINE=1/0`` forces either way, ``DLBB_COMPILE_OVERLAP=1``
    (the gate lifted) implies cores to spare, else only with >= 4 cores."""
    env = os.environ.get("DLBB_SWEEP_PIPELINE")
    if env is not None:
        return env.lower() not in ("0", "off", "false", "no")
    if os.environ.get("DLBB_COMPILE_OVERLAP") == "1":
        return True
    return (os.cpu_count() or 1) >= 4


# ---------------------------------------------------------------------------
# work units
# ---------------------------------------------------------------------------


def work_unit_key(op_name: str, variant_name: str, mesh, axes: Sequence[str], root: int,
                  shape: Sequence[int], dtype: torch.dtype, backend: str,
                  mode: str = "per_iter") -> tuple:
    """Dedup identity of one built callable: the op, the variant's name (two
    variants can share a mesh yet build different callables), the mesh's
    shape, axis names and global ranks and the process group's backend, the
    axes the op runs over, the root, this rank's payload shape and dtype,
    and the timing fingerprint (the port times per iteration only)."""
    if mode != "per_iter":
        raise ValueError(f"timing mode {mode!r}: the port times per iteration only")
    ranks = tuple(mesh.global_rank(i) for i in range(mesh.spec.num_ranks))
    return (op_name, variant_name, tuple(mesh.spec.shape), tuple(mesh.axis_names), ranks,
            backend, tuple(axes), root, tuple(shape), str(dtype), ("per_iter",))


@dataclass
class WorkUnit:
    """One deduplicated build job and its product."""

    key: tuple
    build: Callable[[], Callable]  # -> the callable the configs measure
    label: str = ""
    fn: Optional[Callable] = None
    compile_seconds: float = 0.0
    error: Optional[Exception] = None
    consumers: int = 0  # configs measured against this unit (main thread)
    # set once a consumer has recorded the build's cost in an artifact:
    # the first config that writes one reports it, later sharers report 0
    compile_reported: bool = False
    ready: threading.Event = field(default_factory=threading.Event)


def _compile_unit(unit: WorkUnit, fire_sites: bool = True) -> None:
    """Build one unit; idempotent; never raises (a failure is contained in
    ``unit.error``, so one poisoned unit skips its configs while the
    pipeline drains).  ``fire_sites`` evaluates JAX's ``compile-fail`` and
    ``compile-hang`` sites here; the runner passes it on the mesh's rank 0
    only, whose verdict every rank then shares."""
    if unit.ready.is_set():
        return
    try:
        if fire_sites and inject.fire("compile-fail"):
            raise InjectedFault(f"injected compile failure for {unit.label}")
        if fire_sites and inject.fire("compile-hang"):
            # a wedged build: the watchdog (deadline-aware get()) must
            # abandon and quarantine it without blocking the drain
            time.sleep(inject.param("hang_seconds"))
        # the span's clock reads sit outside the compile_seconds bracket
        with spans.span("compile", cat="compile", label=unit.label, chained=False):
            t0 = time.perf_counter()
            unit.fn = unit.build()
            unit.compile_seconds = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 — containment is the contract
        unit.error = e
    finally:
        unit.ready.set()


# ---------------------------------------------------------------------------
# measurement gate
# ---------------------------------------------------------------------------


class MeasureGate:
    """The mutex between timed regions and background builds (JAX's): a
    lock the worker polls with a timeout, so a measurement abandoned by the
    watchdog while holding it never wedges the drain, and that degrades
    once the watchdog has abandoned a unit (acquisition then falls through
    after a bounded wait; recorded as ``watchdog.gate_degraded``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.degraded = False
        self._held_here = threading.local()

    def degrade(self) -> None:
        self.degraded = True

    def acquire(self, timeout: float = 0.25) -> bool:
        return self._lock.acquire(timeout=timeout)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "MeasureGate":
        while True:
            if self._lock.acquire(timeout=0.25):
                self._held_here.held = True
                return self
            if self.degraded:
                self._held_here.held = False
                return self

    def __exit__(self, *exc) -> None:
        if getattr(self._held_here, "held", False):
            self._held_here.held = False
            self._lock.release()


# ---------------------------------------------------------------------------
# compile-ahead scheduler
# ---------------------------------------------------------------------------


class CompileAheadScheduler:
    """Bounded producer/consumer builder (JAX's).

    The worker thread builds units in first-use order, at most ``prefetch``
    ahead of consumption; :meth:`get` blocks until the unit is ready and
    frees a prefetch slot the first time each unit is consumed.  With
    ``pipeline=False`` no thread starts and :meth:`get` builds inline.
    ``fire_sites`` is :func:`_compile_unit`'s."""

    def __init__(self, units: Iterable[WorkUnit], prefetch: int = 2, pipeline: bool = True,
                 measure_gate: "Optional[MeasureGate | threading.Lock]" = None,
                 fire_sites: bool = True) -> None:
        self._units = list(units)
        self._pipeline = bool(pipeline) and bool(self._units)
        # prefetch slots: the unit being measured + k built ahead
        self._slots = threading.Semaphore(max(1, int(prefetch)) + 1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the worker never builds while the consumer holds this (a config
        # is being timed)
        self._measure_gate = measure_gate
        self._fire_sites = fire_sites
        # watchdog state: a deadline overrun abandoned a build, and the
        # worker may be stuck inside it for good
        self.wedged = False
        self.abandoned = 0
        # keys whose build already blew a deadline: never re-run inline
        self._abandoned_keys: set[tuple] = set()

    @property
    def pipelined(self) -> bool:
        return self._pipeline

    def start(self) -> None:
        if not self._pipeline or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._worker, name="dlbb-compile-ahead",
                                        daemon=True)
        self._thread.start()

    def _acquire_gate(self) -> bool:
        """Poll the gate, checking for a stop and for degradation; whether
        the gate is held."""
        gate = self._measure_gate
        if gate is None:
            return False
        while not self._stop.is_set():
            if gate.acquire(timeout=0.25):
                return True
            if getattr(gate, "degraded", False):
                return False
        return False

    def _worker(self) -> None:
        try:
            for unit in self._units:
                if self._stop.is_set():
                    break
                self._slots.acquire()
                if self._stop.is_set():
                    break
                held = self._acquire_gate()
                try:
                    if not self._stop.is_set():
                        _compile_unit(unit, self._fire_sites)
                finally:
                    if held:
                        self._measure_gate.release()
        finally:
            # a unit left un-ready would hang get() forever: fail closed
            for unit in self._units:
                if not unit.ready.is_set():
                    unit.error = RuntimeError("compile-ahead worker exited before "
                                              f"building unit {unit.label or unit.key}")
                    unit.ready.set()

    def get(self, unit: WorkUnit, deadline: Optional[float] = None) -> WorkUnit:
        """Block until ``unit`` is built (or failed); build inline in
        serial mode.  Call once per consuming config.

        ``deadline`` (pipelined mode) is the watchdog: a build not ready
        after that many seconds raises ``DeadlineExceeded``, marks the
        scheduler wedged and degrades the measurement gate; the hung build
        is abandoned on its daemon thread.  After a wedge, later units
        build inline on the calling thread, except a unit whose build
        already blew the deadline, which raises at once."""
        if not self._pipeline:
            _compile_unit(unit, self._fire_sites)
        elif self.wedged and not unit.ready.is_set():
            if unit.key in self._abandoned_keys:
                raise DeadlineExceeded(unit.label or str(unit.key), float(deadline or 0.0),
                                       phase="compile (unit previously abandoned)")
            clone = WorkUnit(key=unit.key, build=unit.build,
                             label=f"{unit.label}/inline-after-wedge")
            _compile_unit(clone, self._fire_sites)
            clone.consumers += 1
            return clone
        else:
            if not unit.ready.wait(deadline):
                self.wedged = True
                self.abandoned += 1
                self._abandoned_keys.add(unit.key)
                gate = self._measure_gate
                if gate is not None and hasattr(gate, "degrade"):
                    gate.degrade()
                raise DeadlineExceeded(unit.label or str(unit.key), float(deadline or 0.0),
                                       phase="compile")
            if unit.consumers == 0:
                self._slots.release()
        unit.consumers += 1
        return unit

    def close(self) -> None:
        self._stop.set()
        self._slots.release()  # unblock a worker waiting for a slot
        if self._thread is not None:
            # a wedged worker may never return: a bounded join, then the
            # daemon thread is left behind (recorded as scheduler_wedged)
            self._thread.join(timeout=5.0 if self.wedged else None)
            self._thread = None


# ---------------------------------------------------------------------------
# payload cache
# ---------------------------------------------------------------------------

_PAYLOAD_CACHE_BYTES_ENV = "DLBB_PAYLOAD_CACHE_BYTES"
DEFAULT_PAYLOAD_CACHE_BYTES = 1 << 30  # 1 GiB of payloads per rank


class PayloadCache:
    """Byte-budgeted LRU of this rank's payloads (JAX's): ops that share a
    key reuse one tensor instead of drawing it again.  The budget is
    ``max_bytes``, else ``DLBB_PAYLOAD_CACHE_BYTES``, else 1 GiB; a payload
    larger than the budget passes through uncached, and the least recently
    used entries go when a new one would exceed it.  A payload counts the
    bytes of its whole mesh, this rank's tensor times its ``ranks``, as JAX
    counts its global array, so one budget holds the same payloads on both."""

    def __init__(self, max_bytes: Optional[int] = None) -> None:
        if max_bytes is None:
            max_bytes = int(os.environ.get(_PAYLOAD_CACHE_BYTES_ENV,
                                           DEFAULT_PAYLOAD_CACHE_BYTES))
        self.max_bytes = max_bytes
        # key -> (tensor, its mesh's bytes)
        self._entries: OrderedDict[tuple, tuple[Any, int]] = OrderedDict()
        self.nbytes = 0
        self.hits = self.misses = self.evictions = 0

    def get(self, key: tuple, build: Callable[[], Any], ranks: int = 1) -> Any:
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry[0]
        self.misses += 1
        t = build()
        nbytes = int(t.nbytes) * ranks
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


# ---------------------------------------------------------------------------
# sweep manifest
# ---------------------------------------------------------------------------

MANIFEST_NAME = "sweep_manifest.json"
MANIFEST_SCHEMA = "dlbb_sweep_manifest_v1"


def write_sweep_manifest(out_dir, payload: dict[str, Any]) -> Path:
    """The sweep's manifest (wall and build totals, dedup and cache
    accounting, resilience) beside its results, replacing the previous
    sweep's in the same directory."""
    from dlbb_tpu_torch.utils.config import save_json

    return save_json({"schema": MANIFEST_SCHEMA, **payload}, Path(out_dir) / MANIFEST_NAME)
