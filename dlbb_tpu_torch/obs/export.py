"""Metrics registry: labelled counters and gauges, and their Prometheus
textfile export (a copy of ``dlbb_tpu/obs/export.py``'s registry).

Dependency-free: counters and gauges with string labels, a deterministic
output order (metrics in insertion order, label sets sorted within one),
atomic writes through ``utils/config.atomic_write_text``.  The same
updates give the JAX package's ``metrics.prom`` byte for byte.

``serving_metrics`` folds a serving report (``serve/bench.py``),
``fleet_metrics`` a fleet report (``serve/fleet.py``) and ``sweep_metrics``
a sweep manifest (``bench/runner.py``) into ``metrics.prom``, as JAX's do.
``analysis_metrics`` (the analysis report) waits for ROADMAP Queue 1,
Slice F, item 15.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Iterator, Mapping, Optional

PROM_PREFIX = "dlbb_"

_KINDS = ("counter", "gauge")


def _label_key(labels: dict[str, Any]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    __slots__ = ("name", "kind", "help", "values")

    def __init__(self, name: str, kind: str, help: str = "") -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.values: dict[tuple[tuple[str, str], ...], float] = {}


class MetricsRegistry:
    """Thread-safe registry of named counters/gauges with labels."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _metric(self, name: str, kind: str, help: str = "") -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _Metric(name, kind, help)
                self._metrics[name] = m
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {kind}"
                )
            return m

    def inc(self, name: str, value: float = 1.0, help: str = "",
            **labels: Any) -> float:
        """Increment a counter; negative increments are rejected (that is
        what gauges are for)."""
        if value < 0:
            raise ValueError(f"counter {name!r} cannot decrease ({value})")
        m = self._metric(name, "counter", help)
        key = _label_key(labels)
        with self._lock:
            m.values[key] = m.values.get(key, 0.0) + value
            return m.values[key]

    def set_gauge(self, name: str, value: float, help: str = "",
                  **labels: Any) -> None:
        m = self._metric(name, "gauge", help)
        with self._lock:
            m.values[_label_key(labels)] = float(value)

    def get(self, name: str, **labels: Any) -> float:
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        return m.values.get(_label_key(labels), 0.0)

    def labeled_counter(self, name: str, label: str,
                        initial: tuple[str, ...] = (),
                        help: str = "") -> "LabeledCounter":
        """A dict-like view over one counter's ``label`` axis — the sweep
        engine's config-outcome counters use this so the SAME registry
        entries feed the manifest dict and the textfile export."""
        counter = LabeledCounter(self, name, label, help=help)
        for key in initial:
            counter.ensure(key)
        return counter

    # -- rendering ---------------------------------------------------------

    def as_dict(self) -> dict[str, dict[str, Any]]:
        out: dict[str, dict[str, Any]] = {}
        with self._lock:
            for name, m in self._metrics.items():
                out[name] = {
                    "kind": m.kind,
                    "values": [
                        {"labels": dict(k), "value": v}
                        for k, v in sorted(m.values.items())
                    ],
                }
        return out

    def to_prometheus(self) -> str:
        """Prometheus textfile exposition format.  Counter names get the
        conventional ``_total`` suffix appended when missing."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            name = PROM_PREFIX + m.name
            if m.kind == "counter" and not name.endswith("_total"):
                name += "_total"
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, value in sorted(m.values.items()):
                if key:
                    rendered = ",".join(
                        f'{k}="{_escape(v)}"' for k, v in key
                    )
                    lines.append(f"{name}{{{rendered}}} {_num(value)}")
                else:
                    lines.append(f"{name} {_num(value)}")
        return "\n".join(lines) + "\n"

    def write_textfile(self, path: "str | Path") -> Path:
        from dlbb_tpu_torch.utils.config import atomic_write_text

        return atomic_write_text(self.to_prometheus(), Path(path))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class LabeledCounter(Mapping):
    """Mapping view of one counter metric keyed by a single label.

    Supports the sweep's counting idiom (``counts["measured"] +=
    1``, ``dict(counts)`` for the manifest) while every mutation lands in
    the backing :class:`MetricsRegistry` — the "metrics back the manifest
    aggregates" contract."""

    def __init__(self, registry: MetricsRegistry, name: str, label: str,
                 help: str = "") -> None:
        self._registry = registry
        self._name = name
        self._label = label
        self._keys: list[str] = []
        self._help = help

    def ensure(self, key: str) -> None:
        if key not in self._keys:
            self._keys.append(key)
            self._registry.inc(self._name, 0, help=self._help,
                               **{self._label: key})

    def __getitem__(self, key: str) -> int:
        return int(self._registry.get(self._name, **{self._label: key}))

    def __setitem__(self, key: str, value: int) -> None:
        self.ensure(key)
        current = self[key]
        delta = int(value) - current
        if delta < 0:
            raise ValueError(
                f"counter {self._name}[{key}] cannot decrease "
                f"({current} -> {value})"
            )
        if delta:
            self._registry.inc(self._name, delta, **{self._label: key})

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def serving_metrics(report: dict[str, Any],
                    registry: Optional[MetricsRegistry] = None
                    ) -> MetricsRegistry:
    """Fold a serving report (``serve/engine.py``) into gauges on top of
    the live counters/gauges the engine already registered — the serving
    analogue of :func:`sweep_metrics`, written as ``metrics.prom`` next
    to every serving run's manifest.

    The request-outcome counters (arrived/admitted/rejected/completed)
    are registry-backed during the run (``serve_requests``), so the
    report and the export share one source; this adds the derived
    summary numbers (goodput, tail latencies, cache peaks)."""
    registry = registry or MetricsRegistry()
    registry.set_gauge("serve_goodput_tokens_per_second",
                       report.get("goodput_tokens_per_s", 0.0),
                       help="completed-request output tokens per second")
    registry.set_gauge("serve_throughput_tokens_per_second",
                       report.get("throughput_tokens_per_s", 0.0),
                       help="all generated tokens per second")
    registry.set_gauge("serve_wall_seconds",
                       report.get("wall_seconds", 0.0),
                       help="trace wall-clock time")
    # serve_decode_steps is a live engine COUNTER (each fused-scan trip
    # counts once); when folding a bare report into a fresh registry,
    # seed it from the report so the export is self-contained either way
    if registry.get("serve_decode_steps") == 0:
        registry.inc("serve_decode_steps", report.get("decode_steps", 0),
                     help="decode steps executed (each fused-scan trip "
                          "counts once)")
    registry.set_gauge("serve_decode_units",
                       report.get("decode_units",
                                  report.get("decode_steps", 0)),
                       help="decode host dispatches (a fused scan is one)")
    fast = report.get("fast_path", {})
    for key, hlp in (
        ("fused_scans", "fused decode scans dispatched"),
        ("fused_steps", "decode steps executed inside fused scans"),
        ("prefill_chunks", "prefill chunks processed"),
        ("compacted_scans", "fused scans run on a compacted batch"),
    ):
        if key in fast:
            registry.set_gauge(f"serve_fastpath_{key}", fast[key])
    shed = report.get("requests", {}).get("shed_rate")
    if shed is not None:
        registry.set_gauge("serve_shed_rate", shed,
                           help="rejected / arrived requests this run")
    req = report.get("requests", {})
    for key, metric, hlp in (
        ("deadline_shed", "serve_deadline_shed",
         "queued requests shed because their SLO deadline passed"),
        ("completed_past_deadline", "serve_completed_past_deadline",
         "requests served to completion but past their SLO deadline"),
        ("failed", "serve_failed_requests",
         "requests failed closed (dispatch failure / hung dispatch)"),
        ("preempted", "serve_preempted_requests",
         "in-flight requests preempted by a graceful drain"),
    ):
        if key in req:
            registry.set_gauge(metric, req[key], help=hlp)
    # resilience counters live in the engine registry during the run
    # (serve_request_retries / serve_hung_dispatches /
    # serve_deadline_exceeded); when folding a bare report into a
    # fresh registry, seed the totals so the export is self-contained
    res = report.get("resilience", {})
    if res and all(registry.get("serve_request_retries", phase=p) == 0
                   for p in ("decode", "prefill", "bookkeeping")):
        registry.inc("serve_request_retries", res.get("retries", 0),
                     phase="decode",
                     help="transient dispatch/bookkeeping retries, "
                          "by phase")
    if res and registry.get("serve_hung_dispatches") == 0:
        registry.inc("serve_hung_dispatches",
                     res.get("hung_dispatches", 0),
                     help="decode units abandoned by the dispatch "
                          "watchdog")
    # speculative decoding: the per-drafter proposed/accepted counters
    # (serve_spec_proposed_total / serve_spec_accepted_total) and the
    # acceptance-EMA gauge are live ENGINE metrics; when folding a bare
    # report into a fresh registry, seed the totals from the report's
    # speculation sub-dict so the export is self-contained either way
    spec = report.get("speculation", {})
    if spec and spec.get("mode") not in (None, "off"):
        drafter = spec["mode"]
        if registry.get("serve_spec_proposed_total", drafter=drafter) == 0:
            registry.inc("serve_spec_proposed_total",
                         spec.get("proposed_tokens", 0), drafter=drafter,
                         help="draft tokens proposed to the verify step, "
                              "by drafter")
            registry.inc("serve_spec_accepted_total",
                         spec.get("accepted_tokens", 0), drafter=drafter,
                         help="draft tokens the target verify accepted, "
                              "by drafter")
        if spec.get("acceptance_rate") is not None:
            registry.set_gauge("serve_spec_acceptance_ema",
                               spec["acceptance_rate"],
                               help="run-level draft acceptance EMA")
        if spec.get("mean_accepted_len") is not None:
            registry.set_gauge("serve_spec_mean_accepted_len",
                               spec["mean_accepted_len"],
                               help="mean tokens committed per verify "
                                    "unit slot (accepted + bonus)")
    for metric, key in (("serve_ttft_seconds", "ttft"),
                        ("serve_per_token_seconds", "per_token_latency")):
        summary = report.get(key, {})
        for q in ("median", "p95", "p99", "p999"):
            if q in summary:
                registry.set_gauge(metric, summary[q], quantile=q)
    cache = report.get("cache", {})
    for k in ("blocks_in_use", "peak_blocks_in_use",
              "peak_blocks_reserved", "total_blocks", "shared_blocks",
              "peak_shared_blocks", "cow_blocks", "prefix_refs"):
        if k in cache:
            registry.set_gauge("serve_cache_blocks", cache[k], stat=k)
    # prefix cache: the hit/reuse counters (serve_prefix_hits_total /
    # serve_prefix_tokens_reused_total) are live ENGINE metrics; when
    # folding a bare report into a fresh registry, seed the totals from
    # the report's prefix sub-dict so the export is self-contained
    pre = report.get("prefix", {})
    if pre.get("enabled"):
        if registry.get("serve_prefix_hits") == 0:
            registry.inc("serve_prefix_hits", pre.get("hits", 0),
                         help="admissions that attached to a trie-matched "
                              "shared prefix")
            registry.inc("serve_prefix_tokens_reused",
                         pre.get("tokens_reused", 0),
                         help="prompt tokens served from shared blocks "
                              "instead of prefill compute")
        if pre.get("hit_rate") is not None:
            registry.set_gauge("serve_prefix_hit_rate", pre["hit_rate"],
                               help="prefix-attached fraction of "
                                    "prefills this run")
    return registry


def fleet_metrics(report: dict[str, Any],
                  registry: Optional[MetricsRegistry] = None
                  ) -> MetricsRegistry:
    """Fold a fleet report (``serve/fleet.py``) into the supervisor's
    live registry: the fleet analogue of :func:`serving_metrics`,
    written as ``metrics.prom`` next to the fleet manifest.

    The failover/hedge/degrade counters and the per-replica resident
    gauges are registry-backed DURING the run (``serve_failovers`` /
    ``serve_hedges`` / ``serve_degrade_transitions`` /
    ``serve_replica_resident_requests``), so report and export share
    one source; folding a bare report into a fresh registry seeds the
    totals so the export is self-contained either way — and never
    clobbers live counters that already carry the run's increments."""
    registry = registry or MetricsRegistry()
    registry.set_gauge("serve_goodput_tokens_per_second",
                       report.get("goodput_tokens_per_s", 0.0),
                       help="completed-request output tokens per second")
    registry.set_gauge("serve_wall_seconds",
                       report.get("wall_seconds", 0.0),
                       help="trace wall-clock time")
    fleet = report.get("fleet", {})
    registry.set_gauge("serve_fleet_replicas",
                       fleet.get("replicas", 0),
                       help="configured replica count (failure domains)")
    fo = report.get("failovers", {})
    if fo and all(registry.get("serve_failovers", reason=r) == 0
                  for r in fo.get("by_reason", {})):
        for reason, n in sorted(fo.get("by_reason", {}).items()):
            registry.inc("serve_failovers", n, reason=reason,
                         help="requests failed over off a fenced "
                              "replica, by fence reason")
    hedges = report.get("hedges", {})
    if hedges and all(registry.get("serve_hedges", outcome=o) == 0
                      for o in hedges):
        for outcome, n in sorted(hedges.items()):
            registry.inc("serve_hedges", n, outcome=outcome,
                         help="hedged requests by outcome")
    degrade = report.get("degrade", {})
    registry.set_gauge("serve_fleet_degrade_level",
                       degrade.get("level", 0),
                       help="final degradation-ladder level "
                            "(0 = full service)")
    if degrade.get("transitions") and registry.get(
            "serve_degrade_transitions",
            level=degrade["transitions"][0]["name"]) == 0:
        for rec in degrade["transitions"]:
            registry.inc("serve_degrade_transitions", 1,
                         level=rec["name"],
                         help="degradation-ladder escalations, by "
                              "level entered")
    routing = report.get("routing", {})
    for key, metric, hlp in (
        ("prefix_affinity_hits", "serve_fleet_affinity_hits",
         "admissions routed by prefix affinity"),
        ("prefix_affinity_misses", "serve_fleet_affinity_misses",
         "prefix-bearing admissions routed least-loaded instead"),
    ):
        if key in routing:
            registry.set_gauge(metric, routing[key], help=hlp)
    req = report.get("requests", {})
    for key in ("completed", "failed", "rejected", "canceled", "shed"):
        if key in req:
            registry.set_gauge("serve_fleet_requests", req[key],
                               outcome=key,
                               help="fleet-terminal request outcomes")
    ttft = report.get("ttft", {})
    for q in ("median", "p95", "p99", "p999"):
        if q in ttft:
            registry.set_gauge("serve_ttft_seconds", ttft[q], quantile=q)
    penalty = report.get("failover_ttft_penalty_s")
    if penalty is not None:
        registry.set_gauge("serve_failover_ttft_penalty_seconds", penalty,
                           help="mean TTFT of failed-over requests minus "
                                "mean TTFT of cleanly-routed ones")
    return registry


def sweep_metrics(manifest: dict[str, Any],
                  registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """JAX's: a sweep manifest's aggregate sections as gauges (wall and
    compile seconds, compile-cache hits and misses, payload-cache stats,
    retries and quarantine) on top of the counters the sweep registered.
    The port compiles nothing, so its compile gauges read 0."""
    registry = registry or MetricsRegistry()
    registry.set_gauge("sweep_wall_seconds", manifest.get("wall_seconds", 0.0),
                       help="sweep wall-clock time")
    registry.set_gauge("sweep_compile_seconds",
                       manifest.get("compile_seconds_total", 0.0),
                       help="summed compile time across work units")
    cache = manifest.get("compile_cache", {})
    for k in ("persistent_hits", "persistent_misses"):
        registry.set_gauge("sweep_compile_cache", cache.get(k, 0),
                           outcome=k.replace("persistent_", ""))
    payload = manifest.get("payload_cache", {})
    for k, v in sorted(payload.items()):
        registry.set_gauge("sweep_payload_cache", v, stat=k)
    res = manifest.get("resilience", {})
    registry.set_gauge("sweep_retries", res.get("retries_total", 0),
                       help="transient-failure retries burned")
    registry.set_gauge("sweep_quarantined", len(res.get("quarantined", ())),
                       help="configs quarantined with exception chains")
    return registry
