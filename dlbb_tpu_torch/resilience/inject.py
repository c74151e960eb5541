"""Deterministic, seedable fault-injection registry (a host-only copy of
``dlbb_tpu/resilience/inject.py``: its whole plan grammar, its sites and
its parameters; the port imports nothing of the JAX package).

Production fleets treat preemption, flaky runtimes, torn writes and
corrupt artifacts as routine (Varuna, EuroSys'21; CheckFreq, FAST'21); the
harness must fail closed, retry transients, and resume exactly.  This
module is the *injection* half: named fault sites threaded through the
execution layers (never through timed regions), activated by a compact plan
string.  The port threads these of the sites so far: ``preempt`` between
the train steps of ``train/loop.py::run_train``, ``ckpt-corrupt`` in
``train/checkpoint.py::Checkpointer.maybe_save``, ``serve-trace-corrupt``
in ``serve/traffic.py::TrafficTrace.load``, and the engine's serving sites
(the second table) in ``serve/engine.py``, and the fleet's (the third) in
``serve/fleet.py``, where the JAX package hosts them; a fleet counts its
replica sites' hits across its processes (``FaultPlan.fire_nth``).  The
sweep's fire in ``bench/runner.py`` (``exec-transient``, ``exec-hang``,
``stats-nan``, ``preempt``: the mesh's rank 0 decides and broadcasts), in
``bench/schedule.py::_compile_unit`` at the unit build (``compile-fail``,
``compile-hang``: on rank 0's build, whose failure or overrun the mesh then
shares) and in ``utils/config.py::save_json`` (``torn-write``,
``kill-mid-write``).  The tables below list where the JAX package hosts
each.

Plan grammar (``DLBB_FAULT_PLAN`` env / ``--fault-plan`` CLI)::

    plan    := entry ("," entry)*
    entry   := SITE [":" trigger] | NAME "=" VALUE
    trigger := INT        fire on the first N hits of the site
             | "@" INT    fire only on the Nth hit (1-based)
             | "p" FLOAT  fire each hit with probability FLOAT (seeded)
             | "*"        fire on every hit

    examples:  "exec-transient"            first hit only
               "exec-transient:2"          first two hits
               "stats-nan:@2"              second hit only
               "exec-transient:p0.5,seed=7"  seeded coin per hit
               "exec-hang:@1,hang_seconds=5" site parameter

``NAME=VALUE`` entries are plan-level parameters: ``seed`` (default 0)
drives the probabilistic triggers through a per-site ``random.Random``
seeded by ``crc32(site) ^ seed`` — stable across processes and hash
randomisation — and sites read behaviour knobs (``hang_seconds``,
``torn_fraction``) via :func:`param`.

Zero-overhead contract: fault sites live strictly OUTSIDE timed regions —
around compiles, before/after (never inside) ``time_collective``, in
artifact writers and checkpoint save paths.  ``utils/timing.py`` (the only
module that brackets device work with clocks) never imports this module,
so an inactive plan adds zero instructions to any timed region; with no
plan active :func:`fire` is one module-global load and an ``is None``
test.  ``tests/test_resilience.py`` pins both properties for the JAX
package.

Known sites (each raises/acts at its caller, listed with the layer that
hosts it):

==================  =====================================================
``compile-fail``    ``bench/schedule._compile_unit`` — build raises
``compile-hang``    ``bench/schedule._compile_unit`` — sleeps
                    ``hang_seconds`` (default 30) before building
``exec-transient``  ``bench/runner._run_one`` pre-measurement — raises
                    :class:`~dlbb_tpu_torch.resilience.errors.TransientFault`
``exec-hang``       ``bench/runner._run_one`` pre-measurement — sleeps
                    ``hang_seconds``
``stats-nan``       ``bench/runner._run_one`` post-measurement — poisons
                    the timing vector with NaN/Inf
``torn-write``      ``utils/config.save_json`` — leaves a truncated JSON
                    at the final path (first ``torn_fraction``, default
                    0.3, of the payload) and raises
                    :class:`~dlbb_tpu_torch.resilience.errors.TornWrite`
``kill-mid-write``  ``utils/config.save_json`` — SIGKILLs the process
                    between the tmp write and ``os.replace`` (died
                    mid-write with the atomic writer: tmp file only)
``ckpt-corrupt``    ``train/checkpoint.Checkpointer.maybe_save`` —
                    flips bytes in a just-saved checkpoint file (after
                    its integrity manifest was written, so verification
                    must catch it)
``preempt``         ``bench/runner`` between configs / ``train/loop``
                    between steps — SIGTERMs own process (the graceful
                    preemption path; the installed handler must turn it
                    into a journaled stop + final save)
==================  =====================================================

Serving sites (``serve/engine.py``; all fire strictly on the HOST side
of a dispatch boundary — the prefill/decode programs are the same with or
without a plan, pinned statically by ``tests/test_serve_resilience.py``
and, for the port, ``tests/test_torch_serve_resilience.py``):

=====================  ==================================================
``serve-prefill-fail`` prefill dispatch boundary — raises
                       :class:`TransientFault` BEFORE the jit is
                       invoked (retry re-dispatches; the donated cache
                       was never consumed)
``serve-decode-fail``  decode-unit dispatch boundary — same contract
``serve-decode-hang``  decode-unit dispatch — sleeps ``hang_seconds``
                       (the in-flight-window watchdog must abandon it)
``serve-cache-torn``   host ledger/slot bookkeeping after a decode
                       unit — raises mid-loop, leaving the accounting
                       torn (rollback to the pre-dispatch snapshot must
                       recover; the device result is unaffected)
``serve-trace-corrupt`` ``serve/traffic.TrafficTrace.load`` — truncates
                       the trace text before parsing (load must fail
                       closed with a clear chained error)
``serve-preempt``      serving scheduler loop boundary — SIGTERMs own
                       process (graceful drain + checkpoint +
                       ``cli serve --resume``)
=====================  ==================================================

Fleet sites (``serve/fleet.py`` + the replica control plane checked at
the engine's scheduler-loop boundary; all strictly host-side — the
static zero-injection pin extends to ``fleet.py`` via
``tests/test_fleet.py``):

========================  ===============================================
``serve-replica-kill``    replica loop boundary — raises
                          :class:`~dlbb_tpu.serve.fleet.ReplicaKilled`
                          out of the engine (simulated replica SIGKILL:
                          no report, no cleanup; the supervisor fences
                          the replica and fails its residents over)
``serve-replica-hang``    replica loop boundary — sleeps
                          ``hang_seconds`` (the per-replica heartbeat
                          watchdog must fence the silent replica)
``serve-failover-torn``   supervisor routing-table update mid-failover —
                          raises :class:`TornWrite` after the mutation,
                          before any feed push (the snapshot/restore
                          discipline must roll back and retry without
                          double-routing a request)
========================  ===============================================
"""

from __future__ import annotations

import os
import random
import threading
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

from dlbb_tpu_torch.resilience.errors import InjectedFault, TornWrite, TransientFault

__all__ = [
    "SITES",
    "FaultPlan",
    "activate",
    "active",
    "deactivate",
    "fire",
    "from_env",
    "param",
    "plan_scope",
    "InjectedFault",
    "TransientFault",
    "TornWrite",
]

ENV_VAR = "DLBB_FAULT_PLAN"

SITES: tuple[str, ...] = (
    "compile-fail",
    "compile-hang",
    "exec-transient",
    "exec-hang",
    "stats-nan",
    "torn-write",
    "kill-mid-write",
    "ckpt-corrupt",
    "preempt",
    "serve-prefill-fail",
    "serve-decode-fail",
    "serve-decode-hang",
    "serve-cache-torn",
    "serve-trace-corrupt",
    "serve-preempt",
    "serve-replica-kill",
    "serve-replica-hang",
    "serve-failover-torn",
)

_DEFAULT_PARAMS = {
    "seed": 0.0,
    "hang_seconds": 30.0,
    "torn_fraction": 0.3,
}


@dataclass(frozen=True)
class _SiteSpec:
    """Trigger rule for one site (exactly one field set; all None =
    first-hit-only default)."""

    count: Optional[int] = None   # fire on hits 1..count
    nth: Optional[int] = None     # fire only on hit == nth
    prob: Optional[float] = None  # seeded coin per hit
    always: bool = False


def _parse_trigger(site: str, trig: str) -> _SiteSpec:
    if trig == "*":
        return _SiteSpec(always=True)
    if trig.startswith("@"):
        return _SiteSpec(nth=int(trig[1:]))
    if trig.startswith("p"):
        p = float(trig[1:])
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"site {site!r}: probability {p} not in [0,1]")
        return _SiteSpec(prob=p)
    return _SiteSpec(count=int(trig))


@dataclass
class FaultPlan:
    """Parsed fault plan: per-site triggers, plan parameters, and the
    deterministic hit/fire bookkeeping chaos assertions read back."""

    sites: dict[str, _SiteSpec] = field(default_factory=dict)
    params: dict[str, float] = field(default_factory=dict)
    spec: str = ""
    hits: dict[str, int] = field(default_factory=dict)
    fired: list[tuple[str, int]] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    _rngs: dict[str, random.Random] = field(default_factory=dict,
                                            repr=False)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        plan = cls(spec=spec)
        for raw in spec.split(","):
            entry = raw.strip()
            if not entry:
                continue
            if "=" in entry:
                name, _, value = entry.partition("=")
                name = name.strip()
                if name not in _DEFAULT_PARAMS:
                    raise ValueError(
                        f"unknown fault-plan parameter {name!r} "
                        f"(known: {sorted(_DEFAULT_PARAMS)})"
                    )
                plan.params[name] = float(value)
                continue
            site, _, trig = entry.partition(":")
            site = site.strip()
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} (known: {list(SITES)})"
                )
            plan.sites[site] = (_parse_trigger(site, trig.strip())
                                if trig else _SiteSpec(count=1))
        return plan

    def param(self, name: str) -> float:
        return self.params.get(name, _DEFAULT_PARAMS[name])

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            # crc32, not hash(): stable under PYTHONHASHSEED randomisation
            seed = zlib.crc32(site.encode()) ^ int(self.param("seed"))
            rng = self._rngs[site] = random.Random(seed)
        return rng

    def fire(self, site: str) -> bool:
        spec = self.sites.get(site)
        if spec is None:
            return False
        with self._lock:
            n = self.hits[site] = self.hits.get(site, 0) + 1
            return self._hit(site, spec, n)

    def fire_nth(self, site: str, n: int) -> bool:
        """Should ``site`` fault at its ``n``-th hit, counted elsewhere
        (a serving fleet counts the replica sites across its processes)?"""
        spec = self.sites.get(site)
        if spec is None:
            return False
        with self._lock:
            self.hits[site] = max(self.hits.get(site, 0), n)
            return self._hit(site, spec, n)

    def _hit(self, site: str, spec: _SiteSpec, n: int) -> bool:
        if spec.always:
            hit = True
        elif spec.prob is not None:
            hit = self._rng(site).random() < spec.prob
        elif spec.nth is not None:
            hit = n == spec.nth
        else:
            hit = n <= (spec.count or 1)
        if hit:
            self.fired.append((site, n))
        return hit


# The one module-global the (inactive) fast path touches.
_ACTIVE: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def activate(plan: "FaultPlan | str") -> FaultPlan:
    """Install ``plan`` (a :class:`FaultPlan` or spec string) process-wide;
    returns the installed plan.  Callers own the scope — pair with
    :func:`deactivate` (or use :func:`plan_scope`)."""
    global _ACTIVE
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    _ACTIVE = plan
    return plan


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextmanager
def plan_scope(plan: "FaultPlan | str | None"):
    """Scoped activation; ``None`` is a no-op scope (so callers can write
    ``with plan_scope(sweep.fault_plan):`` unconditionally)."""
    global _ACTIVE
    if plan is None:
        yield None
        return
    prev = _ACTIVE
    installed = activate(plan)
    try:
        yield installed
    finally:
        _ACTIVE = prev


def from_env() -> Optional[FaultPlan]:
    """Parse ``DLBB_FAULT_PLAN`` (None when unset/empty)."""
    spec = os.environ.get(ENV_VAR, "").strip()
    return FaultPlan.parse(spec) if spec else None


def fire(site: str) -> bool:
    """Should ``site`` fault now?  One global load + ``is None`` test when
    no plan is active — and every call site lives outside timed regions."""
    plan = _ACTIVE
    if plan is None:
        return False
    return plan.fire(site)


def param(name: str) -> float:
    """Active plan's parameter (module default when inactive — callers
    only consult parameters after :func:`fire` returned True)."""
    plan = _ACTIVE
    if plan is None:
        return _DEFAULT_PARAMS[name]
    return plan.param(name)
