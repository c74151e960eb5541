"""Metrics registry: labelled counters and gauges, and their Prometheus
textfile export (a copy of ``dlbb_tpu/obs/export.py``'s registry).

Dependency-free: counters and gauges with string labels, a deterministic
output order (metrics in insertion order, label sets sorted within one),
atomic writes through ``utils/config.atomic_write_text``.  The same
updates give the JAX package's ``metrics.prom`` byte for byte.

The JAX module's report folds wait with the layers whose reports they
read: ``serving_metrics`` and ``fleet_metrics`` (the serving and fleet
reports, ROADMAP Queue 1, Slice E, item 12), ``sweep_metrics`` (the sweep
manifest, Slice F, item 13) and ``analysis_metrics`` (the analysis
report, Slice F, item 15).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Iterator, Mapping

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
