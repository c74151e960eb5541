"""Replica-level fault tolerance: the serving fleet supervisor (a port of
``dlbb_tpu/serve/fleet.py``: its names, schema ``dlbb_fleet_report_v1``,
journal events, counters and report keys).

Part 11d made ONE engine survive its own faults (transient dispatches,
torn bookkeeping, graceful preemption).  This module makes the engine
itself a replaceable unit: the ranks of the world are partitioned into N
independent replicas (``comm/mesh.partition_devices``: contiguous,
disjoint *failure domains*), each running its own
:class:`~dlbb_tpu_torch.serve.engine.ServingEngine` (its own
``BlockLedger``, KV planes and journal track), under a host-side supervisor
that:

- **routes** admissions least-loaded with prefix affinity: a request
  carrying a ``prefix_seed`` goes back to the replica whose ``PrefixTrie``
  already holds that prefix (the re-prefill there is a cheap attach),
  falling back to the replica with the fewest resident blocks;
- **health-checks** replicas through a per-replica heartbeat.  A replica
  that dies (``serve-replica-kill``), hangs past its heartbeat deadline
  (``serve-replica-hang``), or crashes is **fenced**: no new admissions,
  its kill flag set (a hung replica that later wakes raises
  :class:`ReplicaKilled` at its next loop boundary, so it can never
  double-serve), and every resident request **failed over**: re-enqueued
  at the head of a survivor's feed and re-prefilled there, its original
  ``arrival_s`` (and so its ``deadline_s`` accounting) kept;
- **hedges** stragglers when ``serving.hedge_factor`` is set: a request
  resident past p99 x factor is duplicated onto a second replica, first
  completion wins, the loser is cancelled and its blocks freed (greedy
  decode depends only on (params, request), and every replica initialises
  from the same seed, so the tokens are the same either way);
- **degrades** explicitly under overload or shrinking capacity through a
  monotonic ladder (:data:`DEGRADE_LEVELS`): full service -> no
  speculation -> a decode horizon of 1 -> shed best-effort (no
  ``deadline_s``) arrivals.  Every transition is journaled and counted
  (``serve_degrade_transitions_total``).

Failover is transactional: the routing mutation runs against a snapshot,
the ``serve-failover-torn`` site fires after the mutation and BEFORE any
feed push, and a torn attempt restores the snapshot and retries, so a
request is never routed twice and a shared prefix block never freed twice.

**Replicas, processes and failure domains in the port.**  JAX runs one
controller: its replicas are threads on disjoint sub-meshes of one
process.  The port's engine runs one scheduler per rank, one process per
rank, so a fleet of R replicas of W = dp x tp ranks each is R x W ranks,
launched once (:func:`run_fleet`).  Replica ``i`` is ranks ``[i W, (i+1)
W)``, its engine SPMD on a mesh over those ranks alone, every collective
on its own group (``get_mesh(..., ranks=)``), never on the world's, so
a fenced replica whose ranks stop calling collectives blocks no survivor.
:class:`FleetSupervisor` runs on global rank 0, beside replica 0's engine
(on a thread there, as JAX's replicas are), and owns all routing state.
On one card a replica is a process (W processes) with its own CUDA
context, cache and allocator on the shared GPU: an injected kill or hang,
a Python exception or a crash of that process stays inside its domain; a
device reset, an Xid or running out of the card's memory takes every
replica (``validate_fleet`` prices every replica's weights and cache
against the card before anything starts).  JAX abandons a hung replica's
thread; the launch here waits for every replica's process, so an injected
hang (``serve-replica-hang``) ends at the replica's fence, when the
supervisor's kill reaches its mailbox, and the replica then raises
:class:`ReplicaKilled` at its next boundary, as JAX's wakes to.

**The control plane crosses processes.**  Feeds, cancels, the kill flag,
``spec_enabled``, ``horizon_cap``, heartbeats, lifecycle events, journal
lines and each replica's final report travel through a mailbox: a
``torch.distributed.FileStore`` with one sequence-numbered channel per
direction and replica, one writer each, that no engine ever blocks on.  A
replica's rank 0 (its leader) reads its channel at the engine's loop
boundary and broadcasts what it read over its replica's group only, so
every rank of a replica admits, cancels and dies at the same iteration.
The supervisor applies what arrives and posts what it decided once per
tick.  The clock origin is one ``time.perf_counter()`` reading, which on
Linux is the host's monotonic clock, the same in every process.  The
replica sites ``serve-replica-kill`` and ``serve-replica-hang`` count their
hits fleet-wide in the mailbox, as JAX's replica threads count them in one
plan; every other site counts per process, so per replica.

Everything here is host-side: processes, threads, deques and dicts.  No
function in this module launches device work of its own or builds a device
program (``tests/test_torch_fleet.py`` pins that statically), so the
serving programs are the same with or without a fleet or a fault plan.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
import time
from collections import deque
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch.distributed as dist

from dlbb_tpu_torch.comm.mesh import (available_devices, build_parallelism_mesh,
                                      fault_domain_record, partition_devices)
from dlbb_tpu_torch.models.configs import ModelConfig, kv_cache_bytes_per_device
from dlbb_tpu_torch.obs.export import MetricsRegistry
from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.resilience.errors import (DeadlineExceeded, InjectedFault, TornWrite,
                                              exception_chain)
from dlbb_tpu_torch.serve.engine import ServingConfig, ServingEngine
from dlbb_tpu_torch.serve.traffic import Request, TrafficTrace

FLEET_REPORT_SCHEMA = "dlbb_fleet_report_v1"

# The degradation ladder, in escalation order.  Transitions are monotonic
# within a run: the supervisor only ever climbs (recovering capacity
# mid-trace would un-shed nobody and make the journal ambiguous about which
# requests saw which service level).
DEGRADE_LEVELS = ("full", "no-speculation", "short-horizon",
                  "shed-best-effort")

# Feed-empty sentinel arrival.  Deliberately NOT float("inf"): the engine's
# admission planner computes ``int(gap / step_ema)`` on the next arrival
# gap, and int(inf) raises.  1e12 seconds is ~31k years: far enough.
_FAR_FUTURE_S = 1.0e12

_FENCE_REASONS = ("replica-killed", "replica-hung", "replica-crashed")

# a replica's leader posts its heartbeat at most this often (the fence
# deadline is at least ``heartbeat_min_s``, 1.5 s by default)
_BEAT_POST_S = 0.05


class ReplicaKilled(InjectedFault):
    """A replica was killed (the ``serve-replica-kill`` site, or the
    supervisor's kill flag after fencing).  Simulated SIGKILL: it
    propagates straight out of the engine (no cleanup, no report) and the
    supervisor fails the residents over."""


class _FeedHorizon:
    """What an open-but-empty feed shows at index 0: a pseudo-arrival in
    the far future, so the engine's arrival-gap planner keeps decoding at
    full horizon instead of seeing IndexError or int(inf)."""

    __slots__ = ()
    arrival_s = _FAR_FUTURE_S
    rid = -1


_HORIZON = _FeedHorizon()


class RequestFeed:
    """The arrival feed one replica's engine drains (``run_trace(...,
    feed=)``), filled by its :class:`ReplicaControl` from what the
    supervisor posted.  Only the replica's engine thread touches it: the
    control applies the posted pushes at the loop boundary, the engine pops.

    Mimics the deque the engine otherwise builds from the static trace:
    truthiness means "more work may come" (items present OR still open),
    ``[0]`` peeks the next arrival (a far-future sentinel while
    empty-but-open, so the engine idles instead of exiting), and
    ``popleft``/``discard`` drain it.  The supervisor closes the feed once
    every request is fleet-terminal: only then does the engine's main loop
    condition go false."""

    def __init__(self) -> None:
        self._items: deque[Request] = deque()
        self._closed = False

    def push(self, req: Request) -> None:
        if self._closed:
            raise RuntimeError("push into a closed feed")
        self._items.append(req)

    def push_front(self, req: Request) -> None:
        """Failover re-admission: the moved request jumps the line (it
        already waited its queue time on the dead replica)."""
        if self._closed:
            raise RuntimeError("push into a closed feed")
        self._items.appendleft(req)

    def popleft(self) -> Request:
        return self._items.popleft()

    def discard(self, rid: int) -> bool:
        """Drop a not-yet-admitted request (hedge-loser cancel)."""
        for i, req in enumerate(self._items):
            if req.rid == rid:
                del self._items[i]
                return True
        return False

    def close(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def __bool__(self) -> bool:
        return bool(self._items) or not self._closed

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(list(self._items))

    def __getitem__(self, idx: int) -> Any:
        if idx != 0:
            raise IndexError("feeds only expose the head")
        if self._items:
            return self._items[0]
        if not self._closed:
            return _HORIZON
        raise IndexError("feed drained and closed")


# ---------------------------------------------------------------------------
# the control plane: a mailbox between the supervisor and each replica's
# leader (the port's own: JAX's replicas share one process)
# ---------------------------------------------------------------------------


class _Mailbox:
    """Sequence-numbered message channels over a ``torch.distributed``
    store, one writer per channel: a message is set under
    ``<channel>/<seq>`` before the channel's count ``<channel>/n`` moves
    past it, so a reader never waits on a message it was told of.  Neither
    side ever blocks on the other: :meth:`take` returns what has arrived."""

    def __init__(self, store: Any) -> None:
        self._store = store
        self._sent: dict[str, int] = {}
        self._read: dict[str, int] = {}

    @classmethod
    def at(cls, path: str) -> "_Mailbox":
        """A mailbox on the ``FileStore`` at ``path`` (every user opens its
        own handle on it)."""
        return cls(dist.FileStore(path, -1))

    def post(self, channel: str, msg: Any) -> None:
        seq = self._sent.get(channel, 0)
        self._store.set(f"{channel}/{seq}", pickle.dumps(msg))
        self._sent[channel] = seq + 1
        self._store.add(f"{channel}/n", 1)

    def take(self, channel: str) -> list:
        n = self._store.add(f"{channel}/n", 0)
        start = self._read.get(channel, 0)
        self._read[channel] = n
        return [pickle.loads(self._store.get(f"{channel}/{i}")) for i in range(start, n)]

    def count(self, key: str) -> int:
        """One more hit of a fleet-wide counter; returns its new value."""
        return self._store.add(key, 1)

    def set_float(self, key: str, value: float) -> None:
        self._store.set(key, repr(float(value)))

    def wait_float(self, key: str, timeout_s: float) -> Optional[float]:
        try:
            self._store.wait([key], timedelta(seconds=timeout_s))
        except RuntimeError:
            return None
        return float(self._store.get(key).decode())


def _inbox(replica: int) -> str:
    return f"fleet/in/{replica}"


def _outbox(replica: int) -> str:
    return f"fleet/out/{replica}"


_T0_KEY = "fleet/t0"
# how often a hung replica's leader looks for the fence's kill
_HANG_POLL_S = 0.05


def _fire_fleet(box: _Mailbox, site: str) -> bool:
    """``inject.fire`` for a replica site, with the hit counted across the
    fleet (JAX's replica threads share one plan's count)."""
    plan = inject.active()
    if plan is None or site not in plan.sites:
        return False
    return plan.fire_nth(site, box.count(f"fleet/hits/{site}"))


class ReplicaControl:
    """A replica's control plane, on each of its ranks (``run_trace(...,
    control=)``), with the feed its engine drains (``feed``).  The engine
    consults it strictly at its scheduler-loop boundary: heartbeat out,
    kill/cancel/degradation in.  At each boundary (:meth:`beat`) the
    replica's leader (its rank 0) fires the replica sites (counted
    fleet-wide), posts its heartbeat and reads its mailbox; the batch it
    read and its kill verdict are broadcast over the replica's group, and
    every rank applies them, so every rank admits, cancels and dies at the
    same boundary.  A fenced replica, even one waking from a hang after
    its residents were failed over, raises :class:`ReplicaKilled` at its
    next :meth:`check` and never dispatches again.  Everything here is
    host-side; the fault sites fire in :meth:`beat`, never inside a device
    program.  ``boundaries`` counts the boundaries this rank passed."""

    def __init__(self, replica: int, box: _Mailbox, mesh: Any = None,
                 start_timeout_s: float = 120.0) -> None:
        self.replica = replica
        self._box = box
        self._mesh = mesh
        self._start_timeout_s = start_timeout_s
        self.leader = mesh is None or mesh.rank == 0
        self.feed = RequestFeed()
        self._cancels: list[tuple[int, str]] = []
        self._kill_reason: Optional[str] = None
        # degradation knobs the engine reads per loop iteration
        self.spec_enabled = True
        self.horizon_cap: Optional[int] = None
        # lifecycle sink (engine._event feeds it; the leader posts it)
        self.on_event: Optional[Callable[[int, str, dict], None]] = None
        # heartbeat state (the leader's, posted to the supervisor)
        self.started = False
        self.last_beat = time.monotonic()
        self.beat_ema: Optional[float] = None
        self.beats = 0
        self.boundaries = 0
        self._posted = -1.0e9

    def sync_start(self) -> float:
        """The fleet's shared clock origin: the supervisor sets it once
        every replica has compiled and arrived, so arrival offsets and
        ``deadline_s`` accounting agree across the fleet, un-skewed by
        per-replica compile time."""
        if self.leader:
            self._box.post(_outbox(self.replica), ("arrive",))
        t0 = self._box.wait_float(_T0_KEY, self._start_timeout_s)
        # the gate timed out (supervisor gone?): a local origin, never a hang
        return time.perf_counter() if t0 is None else t0

    def beat(self) -> None:
        self.boundaries += 1
        payload: list = [[], None]
        if self.leader:
            now = time.monotonic()
            if self.started:
                dt = now - self.last_beat
                self.beat_ema = dt if self.beat_ema is None else 0.9 * self.beat_ema + 0.1 * dt
            self.last_beat = now
            self.started = True
            self.beats += 1
            # the hang site goes silent (the heartbeat watchdog must fence
            # us meanwhile); the kill site sets the flag check() raises on
            held = (self._hang(inject.param("hang_seconds"))
                    if _fire_fleet(self._box, "serve-replica-hang") else [])
            if self._kill_reason is None and _fire_fleet(self._box, "serve-replica-kill"):
                self._kill_reason = "serve-replica-kill"
            if now - self._posted >= _BEAT_POST_S:
                self._posted = now
                self.post(("beat", self.last_beat, self.beat_ema, self.beats))
            payload = [held + self._box.take(_inbox(self.replica)), self._kill_reason]
        if self._mesh is not None and self._mesh.spec.num_ranks > 1:
            dist.broadcast_object_list(payload, src=self._mesh.global_rank(0),
                                       group=self._mesh.group)
        msgs, kill = payload
        for msg in msgs:
            self._apply(msg)
        if kill is not None and self._kill_reason is None:
            self._kill_reason = kill

    def _hang(self, seconds: float) -> list:
        """The injected hang: silent for ``seconds``, or until the
        supervisor's fence posts the kill.  JAX abandons a hung replica's
        thread; a replica here is a process that the launch waits for, so
        the fence ends its silence, as a fleet kills a hung replica.
        Returns the messages read meanwhile, applied after it in order."""
        held: list = []
        end = time.monotonic() + seconds
        while (left := end - time.monotonic()) > 0:
            time.sleep(min(_HANG_POLL_S, left))
            held += self._box.take(_inbox(self.replica))
            if any(msg[0] == "kill" for msg in held):
                break
        return held

    def _apply(self, msg: tuple) -> None:
        kind = msg[0]
        if kind == "push":
            self.feed.push(msg[1])
        elif kind == "push_front":
            self.feed.push_front(msg[1])
        elif kind == "close":
            self.feed.close()
        elif kind == "cancel":
            self._cancels.append((msg[1], msg[2]))
        elif kind == "kill":
            if self._kill_reason is None:
                self._kill_reason = msg[1]
        elif kind == "knobs":
            self.spec_enabled, self.horizon_cap = msg[1], msg[2]

    def check(self) -> None:
        if self._kill_reason is not None:
            raise ReplicaKilled(f"replica {self.replica} killed ({self._kill_reason})")

    def take_cancels(self) -> list[tuple[int, str]]:
        out, self._cancels = self._cancels, []
        return out

    @property
    def kill_reason(self) -> Optional[str]:
        return self._kill_reason

    def post(self, msg: tuple) -> None:
        """A message to the supervisor (the leader's only)."""
        self._box.post(_outbox(self.replica), msg)

    def post_event(self, rid: int, event: str, extra: dict) -> None:
        self.post(("event", rid, event, extra))


class _ReplicaJournal:
    """A replica's view of the ONE shared fleet journal: each line goes to
    the supervisor, which writes it with ``replica=N`` (the per-replica
    track key of ``obs/spans.journal_to_trace``)."""

    def __init__(self, control: ReplicaControl) -> None:
        self._control = control

    def event(self, event: str, config: Optional[str] = None, **extra: Any) -> None:
        self._control.post(("journal", event, config, extra))


class _SupervisorFeed:
    """The supervisor's end of a replica's feed: each push and the close
    is posted to the replica's mailbox at once."""

    def __init__(self, box: _Mailbox, replica: int) -> None:
        self._box = box
        self._channel = _inbox(replica)
        self.closed = False

    def _send(self, msg: tuple) -> None:
        if self.closed:
            raise RuntimeError("push into a closed feed")
        self._box.post(self._channel, msg)

    def push(self, req: Request) -> None:
        self._send(("push", req))

    def push_front(self, req: Request) -> None:
        self._send(("push_front", req))

    def close(self) -> None:
        self._send(("close",))
        self.closed = True


class _SupervisorControl:
    """The supervisor's end of a replica's control: the replica's heartbeat
    as its leader last posted it, and the kill flag, the cancels and the
    degradation knobs, each posted to the replica's mailbox at once."""

    def __init__(self, box: _Mailbox, replica: int) -> None:
        self._box = box
        self._channel = _inbox(replica)
        self.replica = replica
        self.kill_reason: Optional[str] = None
        self.spec_enabled = True
        self.horizon_cap: Optional[int] = None
        self.started = False
        self.last_beat = time.monotonic()
        self.beat_ema: Optional[float] = None
        self.beats = 0

    def request_kill(self, reason: str) -> None:
        if self.kill_reason is None:
            self.kill_reason = reason
            self._box.post(self._channel, ("kill", reason))

    def cancel(self, rid: int, reason: str) -> None:
        self._box.post(self._channel, ("cancel", rid, reason))

    def set_knobs(self, **knobs: Any) -> None:
        """Set ``spec_enabled`` and/or ``horizon_cap`` and post both."""
        for name, value in knobs.items():
            setattr(self, name, value)
        self._box.post(self._channel, ("knobs", self.spec_enabled, self.horizon_cap))


class FleetConfig:
    """Fleet-level knobs (the ``fleet:`` config section).

    replicas             independent failure domains to partition the
                         ranks into
    heartbeat_factor     fence a replica silent for factor x its own
                         loop-period EMA ...
    heartbeat_min_s      ... but never sooner than this floor (compile
                         stalls and idle sleeps are legal silences)
    start_timeout_s      cap on waiting for every replica to compile
                         and reach the shared clock gate
    stall_timeout_s      fleet-level fail-closed: no routing/terminal
                         progress for this long ends the run with every
                         outstanding request failed, never a hang
    degrade              enable the automatic overload ladder
    degrade_high_water   escalate one level when resident requests
                         exceed this multiple of live slot capacity
    degrade_interval_s   minimum spacing between automatic escalations
    hedge_min_completions completions needed before the p99 estimate is
                         trusted enough to hedge on
    tick_s               supervisor loop period
    """

    _FIELDS = ("replicas", "heartbeat_factor", "heartbeat_min_s",
               "start_timeout_s", "stall_timeout_s", "degrade",
               "degrade_high_water", "degrade_interval_s",
               "hedge_min_completions", "tick_s")

    def __init__(self, replicas: int = 2, heartbeat_factor: float = 32.0,
                 heartbeat_min_s: float = 1.5,
                 start_timeout_s: float = 120.0,
                 stall_timeout_s: float = 120.0, degrade: bool = True,
                 degrade_high_water: float = 2.0,
                 degrade_interval_s: float = 0.25,
                 hedge_min_completions: int = 8,
                 tick_s: float = 0.005) -> None:
        self.replicas = int(replicas)
        self.heartbeat_factor = float(heartbeat_factor)
        self.heartbeat_min_s = float(heartbeat_min_s)
        self.start_timeout_s = float(start_timeout_s)
        self.stall_timeout_s = float(stall_timeout_s)
        self.degrade = bool(degrade)
        self.degrade_high_water = float(degrade_high_water)
        self.degrade_interval_s = float(degrade_interval_s)
        self.hedge_min_completions = int(hedge_min_completions)
        self.tick_s = float(tick_s)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FleetConfig":
        unknown = set(d) - set(cls._FIELDS)
        if unknown:
            raise ValueError(
                f"unknown fleet config key(s) {sorted(unknown)} "
                f"(known: {list(cls._FIELDS)})"
            )
        return cls(**{k: d[k] for k in cls._FIELDS if k in d})

    def to_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in self._FIELDS}

    def validate(self) -> None:
        if self.replicas < 1:
            raise ValueError(f"fleet.replicas={self.replicas} must be >= 1")
        if self.heartbeat_factor < 1.0:
            raise ValueError(
                f"fleet.heartbeat_factor={self.heartbeat_factor} must be "
                ">= 1 (a sub-EMA deadline fences healthy replicas)"
            )
        for knob in ("heartbeat_min_s", "start_timeout_s",
                     "stall_timeout_s", "degrade_high_water",
                     "degrade_interval_s", "tick_s"):
            if getattr(self, knob) <= 0:
                raise ValueError(f"fleet.{knob} must be > 0")
        if self.hedge_min_completions < 1:
            raise ValueError("fleet.hedge_min_completions must be >= 1")


def rank_bytes(model_cfg: ModelConfig, serving_cfg: ServingConfig, dp: int,
               tp: int) -> dict[str, int]:
    """What one rank of a replica holds on its card: its cache shard, its
    weight shards (the draft model's too), and the decode step's transient
    fp32 copies of one layer's K and V."""
    from dlbb_tpu_torch.models.transformer import DTYPES, num_parameters

    itemsize = DTYPES[model_cfg.dtype].itemsize
    cache = kv_cache_bytes_per_device(
        model_cfg, serving_cfg.max_batch, serving_cfg.max_seq, dp=dp, tp=tp,
        kv_quantization=serving_cfg.kv_quantization, block_size=serving_cfg.block_size)
    weights = num_parameters(model_cfg) * itemsize // tp
    if serving_cfg.speculation == "draft-model":
        weights += num_parameters(serving_cfg.draft_model_config(model_cfg)) * itemsize // tp
    dense = kv_cache_bytes_per_device(model_cfg, serving_cfg.max_batch, serving_cfg.max_seq,
                                      dp=dp, tp=tp, block_size=serving_cfg.block_size)
    transient = 2 * (dense // max(1, model_cfg.num_layers)) * 4 // itemsize
    return {"kv_cache": cache, "weights": weights, "transient": transient}


def validate_fleet(config: dict[str, Any], model_cfg: ModelConfig,
                   serving_cfg: ServingConfig, fleet_cfg: FleetConfig,
                   n_devices: int, card_bytes: Optional[int] = None,
                   cards: int = 1) -> tuple[int, int]:
    """The fleet admission ladder: every rung rejects BEFORE any replica
    builds, with the reason, never as a mid-run OOM or a lopsided fleet:

    1. the fleet knobs themselves are sane;
    2. the device count (ranks, in the port) partitions into ``replicas``
       equal failure domains;
    3. the per-replica (dp, tp) plan fits inside one domain, and (the
       port's) fills it: a rank outside its replica's mesh would run an
       engine of its own on the replica's mailbox, a second leader that
       serves every request again;
    4. the per-replica serving envelope (incl. the HBM budget: each
       replica carries its OWN full KV planes) passes the engine's own
       ``ServingConfig.validate``;
    5. (the port's, where the ranks share ``cards`` GPUs of ``card_bytes``
       each, contiguous ranks to a card) every rank on a card, its weights,
       cache and transient copies (:func:`rank_bytes`), fits the card, and
       no replica's ``hbm_budget_gb`` claims more than its share of it.

    Returns the per-replica ``(dp, tp)``."""
    fleet_cfg.validate()
    par = dict(config.get("parallelism", {}))
    tp = int(par.get("world_size", 1))
    dp = int(par.get("data_parallel", 1))
    for axis in ("sequence_parallel", "pipeline_parallel",
                 "expert_parallel"):
        if int(par.get(axis, 1)) > 1:
            raise ValueError(
                f"serving fleets support (dp, tp) replicas only "
                f"(got {axis}={par[axis]})"
            )
    if n_devices % fleet_cfg.replicas != 0:
        raise ValueError(
            f"{n_devices} device(s) do not partition into "
            f"{fleet_cfg.replicas} equal failure domains"
        )
    per_domain = n_devices // fleet_cfg.replicas
    if dp * tp > per_domain:
        raise ValueError(
            f"per-replica plan dp={dp} x tp={tp} needs {dp * tp} "
            f"devices but each of the {fleet_cfg.replicas} failure "
            f"domains has only {per_domain} "
            f"({n_devices} devices total)"
        )
    if dp * tp < per_domain:
        raise ValueError(
            f"per-replica plan dp={dp} x tp={tp} uses {dp * tp} of the {per_domain} ranks "
            f"of each of the {fleet_cfg.replicas} failure domains: every rank must be in "
            f"its replica's mesh, so launch replicas x dp x tp = "
            f"{fleet_cfg.replicas * dp * tp} ranks, not {n_devices}"
        )
    serving_cfg.validate(model_cfg, dp=dp, tp=tp)
    if card_bytes is not None:
        per_card = -(-n_devices // max(1, cards))
        need = rank_bytes(model_cfg, serving_cfg, dp, tp)
        total = per_card * sum(need.values())
        gib = 2 ** 30
        if total > card_bytes:
            raise ValueError(
                f"{per_card} rank(s) on one card need {total / gib:.2f} GiB "
                f"(each {need['weights'] / gib:.2f} GiB of weights, "
                f"{need['kv_cache'] / gib:.2f} GiB of cache, "
                f"{need['transient'] / gib:.2f} GiB of transient copies) of its "
                f"{card_bytes / gib:.2f} GiB")
        if serving_cfg.hbm_budget_gb is not None \
                and per_card * serving_cfg.hbm_budget_gb * gib > card_bytes:
            raise ValueError(
                f"serving.hbm_budget_gb={serving_cfg.hbm_budget_gb} is each replica "
                f"rank's budget, and {per_card} of them share one card of "
                f"{card_bytes / gib:.2f} GiB: give each its share")
    return dp, tp


# engine terminal lifecycle events -> fleet outcome kind
_TERMINAL_EVENTS = {
    "request-completed": "completed",
    "request-failed": "failed",
    "request-rejected": "rejected",
    "request-infeasible": "rejected",
    "request-canceled": "canceled",
}


class FleetSupervisor:
    """Host-side control plane over N replica engines (module docstring).
    One instance serves one trace; all shared state is owned by the
    supervisor's thread.  It reaches each replica only through
    ``mailbox`` (:class:`_SupervisorFeed`, :class:`_SupervisorControl`),
    whose other end is each replica's :class:`ReplicaControl`; ``meshes``
    are only counted here."""

    def __init__(self, model_cfg: ModelConfig, serving_cfg: ServingConfig,
                 fleet_cfg: FleetConfig, meshes: Sequence,
                 fault_domains: Optional[dict[str, list[int]]] = None,
                 seed: int = 0, journal: Any = None,
                 registry: Optional[MetricsRegistry] = None,
                 verbose: bool = False,
                 capture_tokens: bool = True, *, mailbox: _Mailbox) -> None:
        if not meshes:
            raise ValueError("a fleet needs at least one replica mesh")
        self.model = model_cfg
        self.serving = serving_cfg
        self.fleet = fleet_cfg
        self.meshes = list(meshes)
        self.fault_domains = dict(fault_domains or {})
        self.seed = seed
        self.journal = journal
        self.verbose = verbose
        self.capture_tokens = capture_tokens
        self.registry = registry if registry is not None else MetricsRegistry()
        self._failover_counter = self.registry.labeled_counter(
            "serve_failovers", "reason", initial=_FENCE_REASONS,
            help="requests failed over off a fenced replica, by fence "
                 "reason")
        self._hedge_counter = self.registry.labeled_counter(
            "serve_hedges", "outcome", initial=("issued", "won", "lost"),
            help="hedged requests: issued duplicates, and whether the "
                 "hedge (won) or the primary (lost) completed first")
        self._degrade_counter = self.registry.labeled_counter(
            "serve_degrade_transitions", "level",
            initial=DEGRADE_LEVELS[1:],
            help="degradation-ladder escalations, by level entered")

        R = len(self.meshes)
        self._mailbox = mailbox
        self.controls = [_SupervisorControl(mailbox, i) for i in range(R)]
        self.feeds = [_SupervisorFeed(mailbox, i) for i in range(R)]
        self._arrived: set[int] = set()   # replicas parked at the clock gate
        self.reports: list[Optional[dict]] = [None] * R
        self.death: list[Optional[dict]] = [None] * R
        self._done = [False] * R
        self._fenced = [False] * R
        self._fence_reason: list[Optional[str]] = [None] * R

        # routing state (supervisor thread only)
        self._events: deque[tuple[int, int, str, dict]] = deque()
        self._req_by_rid: dict[int, Request] = {}
        self._assign: dict[int, int] = {}      # rid -> primary replica
        self._hedged: dict[int, int] = {}      # rid -> hedge replica
        self._hedge_resolved: set[int] = set()
        self._terminal: dict[int, str] = {}    # rid -> fleet outcome
        self._routed_at: dict[int, float] = {}
        self._copy_blocks: dict[tuple[int, int], int] = {}
        self._blocks = [0] * R                 # resident-block estimate
        self._routed_count = [0] * R
        self._affinity: dict[tuple, int] = {}
        self._affinity_hits = 0
        self._affinity_misses = 0
        self._shed = 0
        self._e2e: list[float] = []
        self._ttft: dict[int, float] = {}
        self._tokens: dict[int, list[int]] = {}
        self._completed_by: dict[int, int] = {}
        self._failover_rids: set[int] = set()
        self._failover_log: list[dict[str, Any]] = []
        self._level = 0
        self._degrade_log: list[dict[str, Any]] = []
        self._last_degrade = -1.0e9
        self._t0: Optional[float] = None

    # -- journal -----------------------------------------------------------

    def _jevent(self, event: str, config: Optional[str] = None,
                **extra: Any) -> None:
        if self.journal is None:
            return
        self.journal.event(event, config=config, **extra)

    # -- the replicas' mailbox ---------------------------------------------

    def _pump(self) -> None:
        """Apply what every replica posted: gate arrivals, heartbeats,
        lifecycle events (into the event deque JAX's sink fills), journal
        lines, and the end of a replica (its report or its death)."""
        for idx in range(len(self.meshes)):
            for msg in self._mailbox.take(_outbox(idx)):
                kind = msg[0]
                if kind == "arrive":
                    self._arrived.add(idx)
                elif kind == "up":
                    self._jevent("replica-up", replica=idx,
                                 devices=self.fault_domains.get(str(idx)))
                elif kind == "beat":
                    ctl = self.controls[idx]
                    ctl.last_beat, ctl.beat_ema, ctl.beats = msg[1], msg[2], msg[3]
                    ctl.started = True
                elif kind == "event":
                    self._events.append((idx, msg[1], msg[2], msg[3]))
                elif kind == "journal":
                    self._jevent(msg[1], config=msg[2], **{"replica": idx, **msg[3]})
                elif kind == "done":
                    self.reports[idx] = msg[1]
                    self._done[idx] = True
                elif kind == "died":
                    self.death[idx] = {"reason": msg[1], **msg[2]}
                    self._jevent("replica-failed", replica=idx, reason=msg[1], **msg[2])
                    self._done[idx] = True

    # -- clock -------------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - (self._t0 or time.perf_counter())

    # -- routing -----------------------------------------------------------

    def _blocks_for(self, req: Request) -> int:
        total = req.prompt_len + req.output_len
        return -(-total // self.serving.block_size)

    def _admittable(self) -> list[int]:
        return [i for i in range(len(self.meshes))
                if not self._fenced[i] and not self._done[i]]

    def _pick(self, req: Request,
              exclude: frozenset = frozenset()) -> Optional[int]:
        alive = [i for i in self._admittable() if i not in exclude]
        if not alive:
            return None
        key = None
        if req.prefix_seed is not None:
            key = (req.prefix_seed, req.prefix_len)
            aff = self._affinity.get(key)
            if aff is not None and aff in alive:
                self._affinity_hits += 1
                return aff
        tgt = min(alive, key=lambda i: (self._blocks[i], i))
        if key is not None:
            self._affinity[key] = tgt
            self._affinity_misses += 1
        return tgt

    def _push(self, rid: int, req: Request, tgt: int,
              front: bool = False) -> None:
        self._assign[rid] = tgt
        nb = self._blocks_for(req)
        self._copy_blocks[(rid, tgt)] = nb
        self._blocks[tgt] += nb
        (self.feeds[tgt].push_front if front
         else self.feeds[tgt].push)(req)
        self._routed_count[tgt] += 1

    def _route(self, req: Request) -> None:
        rid = req.rid
        self._req_by_rid.setdefault(rid, req)
        if self._level >= 3 and req.deadline_s is None:
            # shed-best-effort: requests without an SLO class are rejected
            # at the door while the fleet is at ladder level 3
            self._terminal[rid] = "rejected[degraded-shed]"
            self._shed += 1
            self._jevent("request-rejected", config=f"request-{rid}",
                         reason="degraded-shed", level=self._level)
            return
        tgt = self._pick(req)
        if tgt is None:
            self._terminal[rid] = "failed[no-replica]"
            self._jevent("request-failed", config=f"request-{rid}",
                         reason="no-replica")
            return
        self._routed_at[rid] = self._now()
        self._push(rid, req, tgt)

    # -- lifecycle events --------------------------------------------------

    def _drain_events(self) -> int:
        batch = list(self._events)
        self._events.clear()
        for replica, rid, event, extra in batch:
            self._handle_event(replica, rid, event, extra)
        return len(batch)

    def _handle_event(self, rep: int, rid: int, event: str,
                      extra: dict) -> None:
        if event == "request-prefill":
            ttft = extra.get("ttft_s")
            if ttft is not None:
                # last write wins: a failed-over request's re-prefill
                # overwrites the dead replica's number: THAT is the TTFT
                # the client observed
                self._ttft[rid] = float(ttft)
            return
        kind = _TERMINAL_EVENTS.get(event)
        if kind is None:
            return
        nb = self._copy_blocks.pop((rid, rep), None)
        if nb:
            self._blocks[rep] = max(0, self._blocks[rep] - nb)
        reason = extra.get("reason")
        out = ("completed" if kind == "completed"
               else f"{kind}[{reason}]" if reason else kind)
        prev = self._terminal.get(rid)
        # precedence: a completion anywhere beats any other copy's fate
        # (hedge loser cancels, fence-time failures); first-terminal wins
        # otherwise
        if prev is None or (kind == "completed"
                            and not prev.startswith("completed")):
            self._terminal[rid] = out
        if kind == "completed":
            lat = extra.get("latency_s")
            if prev is None or not prev.startswith("completed"):
                if lat is not None:
                    self._e2e.append(float(lat))
                self._completed_by[rid] = rep
                toks = extra.get("tokens")
                if toks is not None:
                    self._tokens[rid] = [int(t) for t in toks]
            hedge = self._hedged.get(rid)
            if hedge is not None and rid not in self._hedge_resolved:
                self._hedge_resolved.add(rid)
                won = rep == hedge
                self._hedge_counter["won" if won else "lost"] += 1
                loser = self._assign.get(rid) if won else hedge
                if (loser is not None and loser != rep
                        and not self._fenced[loser]
                        and not self._done[loser]):
                    self.controls[loser].cancel(rid, "hedge-lost")

    # -- fencing & failover ------------------------------------------------

    def _routing_snapshot(self) -> dict[str, Any]:
        return {
            "assign": dict(self._assign),
            "blocks": list(self._blocks),
            "copy_blocks": dict(self._copy_blocks),
            "affinity": dict(self._affinity),
            "hedged": dict(self._hedged),
            "routed_count": list(self._routed_count),
        }

    def _restore_routing(self, snap: dict[str, Any]) -> None:
        self._assign = dict(snap["assign"])
        self._blocks = list(snap["blocks"])
        self._copy_blocks = dict(snap["copy_blocks"])
        self._affinity = dict(snap["affinity"])
        self._hedged = dict(snap["hedged"])
        self._routed_count = list(snap["routed_count"])

    def _fence(self, idx: int, reason: str,
               chain: Optional[dict] = None) -> None:
        """Fence ``idx`` (kill flag + closed feed + purged affinity) and
        fail its residents over.  The routing mutation is transactional:
        built against a snapshot, ``serve-failover-torn`` fires after the
        mutation and before any feed push, and a torn attempt rolls back
        and retries: never a double-routed request or a leaked block
        estimate."""
        if self._fenced[idx]:
            return
        self._fenced[idx] = True
        self._fence_reason[idx] = reason
        self.controls[idx].request_kill(reason)
        self.feeds[idx].close()
        self._jevent("replica-fenced", replica=idx, reason=reason,
                     **(chain or {}))
        if self.verbose:
            print(f"[fleet] replica {idx} FENCED ({reason})")
        # the dead replica's block estimates and prefix homes are moot
        self._blocks[idx] = 0
        for key in [k for k in self._copy_blocks if k[1] == idx]:
            del self._copy_blocks[key]
        self._affinity = {k: v for k, v in self._affinity.items()
                          if v != idx}
        # hedge copies touching the dead replica resolve to the survivor
        for rid, hedge in list(self._hedged.items()):
            if hedge == idx:
                del self._hedged[rid]
            elif self._assign.get(rid) == idx:
                self._assign[rid] = hedge
                del self._hedged[rid]
        residents = [rid for rid, rep in self._assign.items()
                     if rep == idx and rid not in self._terminal]
        pushes: list[tuple[int, Request, int]] = []
        orphans: list[int] = []
        for attempt in (1, 2):
            snap = self._routing_snapshot()
            pushes, orphans = [], []
            try:
                for rid in residents:
                    req = self._req_by_rid[rid]
                    tgt = self._pick(req, exclude=frozenset({idx}))
                    if tgt is None:
                        orphans.append(rid)
                        continue
                    self._assign[rid] = tgt
                    nb = self._blocks_for(req)
                    self._copy_blocks[(rid, tgt)] = nb
                    self._blocks[tgt] += nb
                    self._routed_count[tgt] += 1
                    pushes.append((rid, req, tgt))
                if pushes and inject.fire("serve-failover-torn"):
                    raise TornWrite(
                        "fleet routing table torn mid-failover")
                break
            except TornWrite as e:
                self._restore_routing(snap)
                self._jevent("failover-torn", replica=idx,
                             attempt=attempt, **exception_chain(e))
                if attempt == 2:
                    raise
        # COMMIT: only a committed routing table touches the feeds, so a
        # torn attempt above never half-delivered a request
        for rid, req, tgt in pushes:
            self.feeds[tgt].push_front(req)
            self._failover_counter[reason] += 1
            self._failover_rids.add(rid)
            rec = {"rid": rid, "from": idx, "to": tgt, "reason": reason}
            self._failover_log.append(rec)
            self._jevent("request-failover", config=f"request-{rid}",
                         from_replica=idx, to_replica=tgt, reason=reason,
                         **(chain or {}))
        for rid in orphans:
            self._terminal[rid] = "failed[replica-lost]"
            self._jevent("request-failed", config=f"request-{rid}",
                         reason="replica-lost", replica=idx,
                         **(chain or {}))

    def _health(self) -> None:
        for idx in range(len(self.meshes)):
            if self._fenced[idx]:
                continue
            if self._done[idx]:
                if self.death[idx] is not None:
                    self._fence(idx, self.death[idx]["reason"],
                                chain={k: v
                                       for k, v in self.death[idx].items()
                                       if k != "reason"})
                continue
            ctl = self.controls[idx]
            if not ctl.started:
                continue  # still compiling: the start gate owns this
            ema = ctl.beat_ema if ctl.beat_ema else 0.05
            deadline = max(self.fleet.heartbeat_min_s,
                           self.fleet.heartbeat_factor * ema)
            if time.monotonic() - ctl.last_beat > deadline:
                exc = DeadlineExceeded(f"replica-{idx} heartbeat",
                                       deadline, phase="heartbeat")
                self._fence(idx, "replica-hung",
                            chain=exception_chain(exc))

    # -- hedging -----------------------------------------------------------

    def _maybe_hedge(self, now: float) -> None:
        factor = self.serving.hedge_factor
        if factor is None:
            return
        if len(self._e2e) < self.fleet.hedge_min_completions:
            return
        threshold = factor * float(np.quantile(self._e2e, 0.99))
        for rid, routed_at in list(self._routed_at.items()):
            if (rid in self._terminal or rid in self._hedged
                    or now - routed_at <= threshold):
                continue
            primary = self._assign.get(rid)
            if primary is None:
                continue
            req = self._req_by_rid[rid]
            alt = self._pick(req, exclude=frozenset({primary}))
            if alt is None:
                continue
            self._hedged[rid] = alt
            nb = self._blocks_for(req)
            self._copy_blocks[(rid, alt)] = nb
            self._blocks[alt] += nb
            self._routed_count[alt] += 1
            self.feeds[alt].push_front(req)
            self._hedge_counter["issued"] += 1
            self._jevent("request-hedged", config=f"request-{rid}",
                         primary=primary, hedge=alt,
                         threshold_s=round(threshold, 6))

    # -- degradation ladder ------------------------------------------------

    def degrade_to(self, level: int, reason: str) -> None:
        """Climb the ladder to ``level`` (monotonic: requests to a level at
        or below the current one are no-ops; the fleet never silently
        recovers service classes mid-run).  Each level entered is applied
        to every live replica, journaled, and counted."""
        level = int(level)
        if level <= self._level:
            return
        if level >= len(DEGRADE_LEVELS):
            raise ValueError(
                f"degrade level {level} out of range "
                f"(max {len(DEGRADE_LEVELS) - 1})"
            )
        while self._level < level:
            self._level += 1
            name = DEGRADE_LEVELS[self._level]
            if self._level == 1:
                for ctl in self.controls:
                    ctl.set_knobs(spec_enabled=False)
            elif self._level == 2:
                for ctl in self.controls:
                    ctl.set_knobs(horizon_cap=1)
            # level 3 (shed-best-effort) acts at routing time
            self._degrade_counter[name] += 1
            rec = {"level": self._level, "name": name, "reason": reason,
                   "t_s": round(self._now(), 6)}
            self._degrade_log.append(rec)
            self._jevent("degrade-transition", level=self._level,
                         name=name, reason=reason)
            if self.verbose:
                print(f"[fleet] DEGRADE -> {name} ({reason})")

    def _maybe_degrade(self, now: float) -> None:
        if (not self.fleet.degrade or self._level >= 3
                or now - self._last_degrade
                < self.fleet.degrade_interval_s):
            return
        alive = self._admittable()
        if not alive:
            return
        capacity = len(alive) * self.serving.max_batch
        resident = sum(1 for rid in self._assign
                       if rid not in self._terminal)
        pressure = resident / max(1, capacity)
        if pressure > self.fleet.degrade_high_water:
            self._last_degrade = now
            self.degrade_to(
                self._level + 1,
                f"overload: {resident} resident requests over "
                f"{capacity} live slots (pressure {pressure:.2f})")

    # -- gauges ------------------------------------------------------------

    def _export_gauges(self) -> None:
        resident: dict[int, int] = {i: 0 for i in range(len(self.meshes))}
        for rid, rep in self._assign.items():
            if rid not in self._terminal:
                resident[rep] += 1
        for rid, rep in self._hedged.items():
            if rid not in self._terminal:
                resident[rep] += 1
        for i, n in resident.items():
            self.registry.set_gauge(
                "serve_replica_resident_requests", n, replica=str(i),
                help="requests resident (routed, not terminal) per "
                     "replica")
        self.registry.set_gauge(
            "serve_fleet_degrade_level", self._level,
            help="current degradation-ladder level (0 = full service)")
        self.registry.set_gauge(
            "serve_fleet_live_replicas", len(self._admittable()),
            help="replicas admitting new requests")

    # -- the run -----------------------------------------------------------

    def _wait_replicas(self, timeout_s: float, which: Callable[[int], bool]) -> None:
        """Pump the mailbox until every replica ``which`` picks has ended,
        or ``timeout_s`` passed."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self._pump()
            if all(self._done[i] for i in range(len(self.meshes)) if which(i)):
                return
            time.sleep(self.fleet.tick_s)

    def serve(self, trace: TrafficTrace) -> dict[str, Any]:
        """Serve ``trace`` across the fleet; returns the aggregated fleet
        report (schema :data:`FLEET_REPORT_SCHEMA`).  The replicas are the
        engines :func:`run_fleet` launched, serving the same trace, each
        reached through the mailbox."""
        R = len(self.meshes)
        reqs = sorted(trace, key=lambda r: (r.arrival_s, r.rid))
        if not reqs:
            raise ValueError("cannot serve an empty trace")
        self._req_by_rid = {r.rid: r for r in reqs}
        # hold the gate until every replica that is still alive has
        # compiled and parked: the shared t0 keeps arrival offsets and
        # deadline_s accounting identical across the fleet
        gate_deadline = time.monotonic() + self.fleet.start_timeout_s
        while time.monotonic() < gate_deadline:
            self._pump()
            if all(self._done[i] or i in self._arrived for i in range(R)):
                break
            time.sleep(0.01)
        self._t0 = time.perf_counter()
        self._mailbox.set_float(_T0_KEY, self._t0)
        wall_start = time.perf_counter()

        i = 0
        last_progress = time.monotonic()
        while True:
            self._pump()
            now = self._now()
            progressed = 0
            while i < len(reqs) and reqs[i].arrival_s <= now:
                self._route(reqs[i])
                i += 1
                progressed += 1
            progressed += self._drain_events()
            self._health()
            self._maybe_hedge(now)
            self._maybe_degrade(now)
            self._export_gauges()
            outstanding = [rid for rid in self._assign
                           if rid not in self._terminal]
            if progressed:
                last_progress = time.monotonic()
            if i >= len(reqs) and not outstanding:
                break
            if not self._admittable():
                # the whole fleet is gone: fail closed, loudly; every
                # unserved request gets a terminal outcome and the run ends
                # instead of hanging
                for j in range(i, len(reqs)):
                    rid = reqs[j].rid
                    self._terminal[rid] = "failed[no-replica]"
                    self._jevent("request-failed",
                                 config=f"request-{rid}",
                                 reason="no-replica")
                i = len(reqs)
                for rid in outstanding:
                    if rid not in self._terminal:
                        self._terminal[rid] = "failed[replica-lost]"
                        self._jevent("request-failed",
                                     config=f"request-{rid}",
                                     reason="replica-lost")
                break
            if (time.monotonic() - last_progress
                    > self.fleet.stall_timeout_s):
                self._jevent("fleet-stall",
                             outstanding=sorted(outstanding),
                             timeout_s=self.fleet.stall_timeout_s)
                for rid in outstanding:
                    self._terminal[rid] = "failed[fleet-stall]"
                    self._jevent("request-failed",
                                 config=f"request-{rid}",
                                 reason="fleet-stall")
                for idx in self._admittable():
                    self._fence(idx, "replica-hung",
                                chain={"error": "fleet stall timeout"})
                break
            time.sleep(self.fleet.tick_s)

        for feed in self.feeds:
            if not feed.closed:
                feed.close()
        # a fenced replica may still be inside an injected hang; it sees its
        # kill flag when it wakes: don't let the end wait on it
        self._wait_replicas(60.0, lambda r: not self._fenced[r])
        self._wait_replicas(2.0, lambda r: self._fenced[r])
        self._drain_events()
        self._export_gauges()
        wall = time.perf_counter() - wall_start
        return self._build_report(trace, wall)

    # -- the report --------------------------------------------------------

    def _build_report(self, trace: TrafficTrace,
                      wall: float) -> dict[str, Any]:
        from dlbb_tpu_torch.utils.metrics import summarize

        R = len(self.meshes)
        outcomes = {rid: self._terminal.get(rid, "failed[unresolved]")
                    for rid in self._req_by_rid}
        counts = {"completed": 0, "failed": 0, "rejected": 0,
                  "canceled": 0, "preempted": 0}
        for out in outcomes.values():
            for k in counts:
                if out.startswith(k):
                    counts[k] += 1
                    break
        replicas = []
        for i in range(R):
            rep = self.reports[i]
            if rep is not None:
                # the fleet artifact carries the aggregate; strip the
                # per-replica bulk (fleet-level tokens/series are the
                # authoritative copies)
                rep = {k: v for k, v in rep.items()
                       if k not in ("timeseries", "completed_tokens")}
            status = ("fenced" if self._fenced[i]
                      else "failed" if self.death[i] is not None
                      else "ok")
            replicas.append({
                "replica": i,
                "devices": self.fault_domains.get(str(i)),
                "status": status,
                "fence_reason": self._fence_reason[i],
                "routed": self._routed_count[i],
                "death": self.death[i],
                "report": rep,
            })
        clean_ttft = [v for rid, v in self._ttft.items()
                      if rid not in self._failover_rids]
        fo_ttft = [v for rid, v in self._ttft.items()
                   if rid in self._failover_rids]
        penalty = (float(np.mean(fo_ttft) - np.mean(clean_ttft))
                   if fo_ttft and clean_ttft else None)
        completed_tokens = sum(
            self._req_by_rid[rid].output_len
            for rid, out in outcomes.items() if out == "completed")
        report: dict[str, Any] = {
            "schema": FLEET_REPORT_SCHEMA,
            "model": {
                "hidden_size": self.model.hidden_size,
                "num_layers": self.model.num_layers,
                "num_heads": self.model.num_heads,
                "kv_heads": self.model.kv_heads,
                "attention": self.model.attention,
                "dtype": self.model.dtype,
            },
            "serving": self.serving.to_dict(),
            "fleet": {**self.fleet.to_dict(),
                      "fault_domains": self.fault_domains},
            "trace": {"kind": trace.kind, "seed": trace.seed,
                      "num_requests": len(trace)},
            "requests": {
                "arrived": len(trace),
                "shed": self._shed,
                "outcomes": {str(r): o
                             for r, o in sorted(outcomes.items())},
                **counts,
            },
            "routing": {
                "per_replica": {str(i): self._routed_count[i]
                                for i in range(R)},
                "prefix_affinity_hits": self._affinity_hits,
                "prefix_affinity_misses": self._affinity_misses,
            },
            "replicas": replicas,
            "failovers": {
                "total": len(self._failover_log),
                "by_reason": {r: int(self._failover_counter[r])
                              for r in _FENCE_REASONS},
                "requests": self._failover_log,
            },
            "hedges": {k: int(self._hedge_counter[k])
                       for k in ("issued", "won", "lost")},
            "degrade": {"level": self._level,
                        "name": DEGRADE_LEVELS[self._level],
                        "transitions": self._degrade_log},
            "ttft": summarize(sorted(self._ttft.values())),
            "ttft_failover": summarize(sorted(fo_ttft)),
            "failover_ttft_penalty_s": penalty,
            "e2e_latency": summarize(sorted(self._e2e)),
            "goodput_tokens_per_s": (completed_tokens / wall
                                     if wall > 0 else 0.0),
            "wall_seconds": wall,
        }
        if self.capture_tokens:
            report["completed_tokens"] = {
                str(rid): toks
                for rid, toks in sorted(self._tokens.items())
            }
        return report


# ---------------------------------------------------------------------------
# the launch: one process per rank, the supervisor on rank 0
# ---------------------------------------------------------------------------


def _serve_replica(idx: int, mesh: Any, box: _Mailbox, model_cfg: ModelConfig,
                   serving_cfg: ServingConfig, fleet_cfg: FleetConfig, trace: TrafficTrace,
                   seed: int, journal: bool, capture_tokens: bool, device,
                   weights: Optional[dict]) -> dict[str, Any]:
    """One rank of replica ``idx``: its engine over the replica's mesh,
    fed and controlled through the mailbox (JAX's ``_worker``).  The
    leader posts the replica's lifecycle, its journal lines, and at the end
    its report or its death.  Returns this rank's record: its outcome and
    the boundary it ended at."""
    from dlbb_tpu_torch.models import params_from_jax
    from dlbb_tpu_torch.models.sharding import shard_params
    from dlbb_tpu_torch.resilience.preempt import PreemptionGuard

    ctl = ReplicaControl(idx, box, mesh, fleet_cfg.start_timeout_s)
    rank = dist.get_rank()
    try:
        params = None
        if weights is not None:
            tp = 1 if mesh is None else mesh.shape["tp"]
            params = shard_params(params_from_jax(weights, model_cfg, device=device), model_cfg,
                                  0 if mesh is None else mesh.coords["tp"], tp)
        engine = ServingEngine(
            model_cfg, serving_cfg, mesh, params=params,
            journal=_ReplicaJournal(ctl) if ctl.leader and journal else None,
            seed=seed, verbose=False, capture_tokens=capture_tokens, device=device)
        if ctl.leader:
            ctl.on_event = ctl.post_event
            ctl.post(("up",))
        # an uninstalled guard: a replica drains on no signal (JAX's
        # replicas are threads, whose guards are inert)
        report = engine.run_trace(trace, guard=PreemptionGuard(), feed=ctl.feed,
                                  control=ctl)
        outcome: tuple = ("done", report)
        record = {"outcome": "completed"}
    except ReplicaKilled as e:
        outcome = ("died", "replica-killed", exception_chain(e))
        record = {"outcome": "replica-killed"}
    except BaseException as e:  # noqa: BLE001 — fail closed, never hang
        outcome = ("died", "replica-crashed", exception_chain(e))
        record = {"outcome": "replica-crashed", "error": repr(e)}
    if ctl.leader:
        ctl.post(outcome)
    return {"replica": idx, "rank": rank, "boundary": ctl.boundaries, **record}


def fleet_rank(config: dict[str, Any], trace: TrafficTrace, output_dir: Optional[str],
               journal: bool, verbose: bool, fault_spec: Optional[str],
               capture_tokens: bool, device, box_path: str,
               weights: Optional[dict] = None) -> dict[str, Any]:
    """One rank of :func:`run_fleet` (launched by name).  Every rank builds
    every replica's mesh, in the same order, then serves its replica; global
    rank 0 also runs the supervisor, and writes the artifacts.  Returns
    ``{"replica": this rank's record, "report": the fleet report on rank 0,
    else None}``."""
    from dlbb_tpu_torch.obs import spans
    from dlbb_tpu_torch.obs.export import fleet_metrics
    from dlbb_tpu_torch.parallel.plan import ParallelismPlan
    from dlbb_tpu_torch.resilience.journal import SweepJournal
    from dlbb_tpu_torch.serve.bench import (DEFAULT_SERVE_MODEL, SERVING_MANIFEST_SCHEMA,
                                            _hbm_record)
    from dlbb_tpu_torch.utils.config import save_json
    from dlbb_tpu_torch.utils.sysinfo import (collect_system_info, gpu_cards, resolve_device,
                                              topology_record)

    rank = dist.get_rank()
    dev = resolve_device(device)
    model_cfg = ModelConfig.from_dict(config.get("model", DEFAULT_SERVE_MODEL))
    serving_cfg = ServingConfig.from_dict(config.get("serving", {}))
    fleet_cfg = FleetConfig.from_dict(config.get("fleet", {}))
    ranks = available_devices()
    dp, tp = validate_fleet(config, model_cfg, serving_cfg, fleet_cfg, len(ranks))
    groups = partition_devices(ranks, fleet_cfg.replicas)
    # a collective call on every rank, in the same order; a one-rank
    # replica needs no group (its engine runs no collective)
    meshes = [build_parallelism_mesh(dp, tensor_parallel=tp, ranks=g) if dp * tp > 1 else None
              for g in groups]
    idx = next(i for i, g in enumerate(groups) if rank in g)
    seed = config.get("input", {}).get("seed", 0)
    run = (idx, meshes[idx], _Mailbox.at(box_path), model_cfg, serving_cfg, fleet_cfg,
           trace, seed, journal and output_dir is not None, capture_tokens, dev, weights)
    with inject.plan_scope(fault_spec):
        if rank != 0:
            return {"replica": _serve_replica(*run), "report": None}
        # rank 0: replica 0's engine on a thread, the supervisor here
        mine: dict[str, Any] = {}
        worker = threading.Thread(target=lambda: mine.update(_serve_replica(*run)),
                                  name="fleet-replica-0", daemon=True)
        worker.start()
        plan = ParallelismPlan(dp, 1, 1, 1, tp, None, meshes[0])
        domains = fault_domain_record(groups)
        name = config.get("experiment", {}).get("name") or (
            f"fleet{fleet_cfg.replicas}_{trace.kind}_{len(trace)}req_"
            f"seed{trace.seed}")
        out = Path(output_dir) if output_dir is not None else None
        jrn = None
        if out is not None and journal:
            jrn = SweepJournal(
                out,
                meta={"mode": "fleet", "name": name,
                      "replicas": fleet_cfg.replicas,
                      "trace_kind": trace.kind, "num_requests": len(trace),
                      "fault_plan": fault_spec},
                sink=spans.journal_sink,
            )
        topology = {**topology_record(dev), "fault_domains": domains}
        try:
            sup = FleetSupervisor(
                model_cfg, serving_cfg, fleet_cfg, groups,
                fault_domains=domains, journal=jrn, seed=seed,
                verbose=verbose, capture_tokens=capture_tokens,
                mailbox=_Mailbox.at(box_path))
            if jrn is not None:
                jrn.event("topology", **topology)
            sup.registry.inc(
                "serve_degraded", 1 if topology["degraded"] else 0,
                help="runs on a degraded (fallback) backend",
            )
            report = sup.serve(trace)
        finally:
            if jrn is not None:
                jrn.close()
        worker.join(timeout=2.0 if sup._fenced[0] else 60.0)

    report["experiment"] = config.get("experiment", {})
    report["backend"] = f"torch_{dev.type}"
    report["mesh"] = plan.mesh_dict()  # ONE replica's mesh
    report["topology"] = topology
    # the engine's record, and what every rank of the fleet holds on its
    # card, priced as validate_fleet priced it
    cards, card = gpu_cards() if dev.type == "cuda" else (1, None)
    report["hbm"] = {**_hbm_record(model_cfg, serving_cfg, plan),
                     "rank_bytes": rank_bytes(model_cfg, serving_cfg, dp, tp),
                     "ranks_per_card": -(-len(ranks) // max(1, cards)),
                     "card_bytes": card}
    report["system_info"] = collect_system_info(dev)
    report["timestamp"] = time.time()

    if out is not None:
        trace_path = trace.save(out / f"trace_{name}.json")
        result_path = save_json(report, out / f"fleet_{name}.json")
        registry = fleet_metrics(report, registry=sup.registry)
        prom_path = registry.write_textfile(out / "metrics.prom")
        manifest = {
            "schema": SERVING_MANIFEST_SCHEMA,
            "name": name,
            "kind": "fleet",
            "result": result_path.name,
            "trace_file": trace_path.name,
            "metrics": prom_path.name,
            "requests": report["requests"],
            "goodput_tokens_per_s": report["goodput_tokens_per_s"],
            "wall_seconds": report["wall_seconds"],
            "mesh": plan.mesh_dict(),
            "hbm": report["hbm"],
            "topology": topology,
            "fault_domains": domains,
            "failovers": report["failovers"]["total"],
            "hedges": report["hedges"],
            "degrade_level": report["degrade"]["level"],
            "journal": (None if jrn is None else jrn.path.name),
        }
        save_json(manifest, out / "serving_manifest.json")
        if verbose:
            print(f"[fleet] report written to {result_path}")
    return {"replica": mine or {"replica": 0, "rank": 0, "outcome": "unresolved"},
            "report": report}


def launch_fleet(rank_fn: Callable, config: dict[str, Any], trace: TrafficTrace,
                 output_dir: Optional[str] = None, journal: bool = True,
                 verbose: bool = True, fault_plan: Optional[str] = None,
                 capture_tokens: bool = True, device=None,
                 timeout: Optional[float] = None, weights: Optional[dict] = None) -> list:
    """:func:`run_fleet`'s launch with the rank function ``rank_fn`` (called
    as :func:`fleet_rank` is); returns every rank's result, by rank."""
    from dlbb_tpu_torch.bench.launch import launch
    from dlbb_tpu_torch.serve.bench import DEFAULT_SERVE_MODEL
    from dlbb_tpu_torch.utils.sysinfo import gpu_cards, resolve_device

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        raise ValueError("run_fleet launches its own ranks: run it outside torchrun")
    dev = resolve_device(device)
    model_cfg = ModelConfig.from_dict(config.get("model", DEFAULT_SERVE_MODEL))
    serving_cfg = ServingConfig.from_dict(config.get("serving", {}))
    fleet_cfg = FleetConfig.from_dict(config.get("fleet", {}))
    par = config.get("parallelism", {}) or {}
    n = fleet_cfg.replicas * int(par.get("data_parallel", 1)) * int(par.get("world_size", 1))
    cards, card = gpu_cards() if dev.type == "cuda" else (1, None)
    validate_fleet(config, model_cfg, serving_cfg, fleet_cfg, n, card_bytes=card,
                   cards=cards)
    fault_spec = fault_plan
    if fault_spec is None and inject.active() is None:
        fault_spec = os.environ.get(inject.ENV_VAR, "").strip() or None
    elif fault_spec is None:
        fault_spec = inject.active().spec or None
    with tempfile.TemporaryDirectory(prefix="dlbb_fleet_") as tmp:
        return launch(rank_fn, n, dev, shared=True, timeout=timeout,
                      args=(config, trace, output_dir, journal, verbose, fault_spec,
                            capture_tokens, device, os.path.join(tmp, "mailbox"), weights))


def run_fleet(
    config: dict[str, Any],
    trace: TrafficTrace,
    output_dir: Optional[str] = None,
    journal: bool = True,
    verbose: bool = True,
    fault_plan: Optional[str] = None,
    capture_tokens: bool = True,
    device=None,
    weights: Optional[dict] = None,
) -> dict[str, Any]:
    """Run one trace across a replica fleet (the ``cli serve --replicas N``
    entry point); returns the fleet report.

    ``config`` follows the experiment-YAML schema with ``fleet:`` next to
    ``serving:``/``model:``/``parallelism:`` (the parallelism plan is PER
    REPLICA).  Replicas x dp x tp ranks are launched once, one process
    each, and partitioned into the replicas (module docstring), every rank
    in its replica's mesh; they share the GPUs over gloo, contiguous ranks to a card
    (``bench/launch.py``'s ``shared``), since NCCL puts no two ranks of a
    communicator on one GPU.  At dp x tp = 1 a replica runs no collective
    at all, and the ranks talk only through the mailbox.  Before anything
    starts, ``validate_fleet`` prices every rank's weights, cache and
    transient copies against the card.  ``device`` is ``cuda`` unless the
    caller names ``cpu``.  Global rank 0 writes the serving artifact family
    under ``output_dir``: ``fleet_<name>.json`` (schema
    ``dlbb_fleet_report_v1``), the shared journal with per-replica tracks,
    ``metrics.prom``, and ``serving_manifest.json`` whose ``fault_domains``
    field (replica id -> its ranks) marks the run as a fleet so report
    overlays never aggregate it with single-replica numbers.

    ``fault_plan`` activates the chaos harness on every rank (an explicit
    plan wins; else an active plan's spec; else ``DLBB_FAULT_PLAN``).
    ``weights`` (a parameter tree of numpy arrays in the JAX package's
    layout, which ``models/weights.params_from_jax`` reads) gives every
    replica those weights, each rank its tp shards; None draws them from
    ``input.seed``, as the engine does."""
    results = launch_fleet(fleet_rank, config, trace, output_dir=output_dir,
                           journal=journal, verbose=verbose, fault_plan=fault_plan,
                           capture_tokens=capture_tokens, device=device, weights=weights)
    return results[0]["report"]
