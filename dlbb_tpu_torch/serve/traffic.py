"""Synthetic serving traffic: seeded, replayable request traces (a copy of
``dlbb_tpu/serve/traffic.py``, numpy only: the same draws in the same
order, so one seed gives both packages the same trace, byte for byte in
its JSON).

The serving benchmark (``serve/bench.py``) is trace-driven: a
:class:`TrafficTrace` fixes every request's arrival time, prompt length,
output length, and embedding seed up front, so a run is exactly
reproducible (same trace + same engine config => same admission order,
same rejections, same token counts) and two engine configurations can be
compared on *identical* load.  Three arrival processes model the
"millions of users" regimes the ROADMAP north-star cares about:

- ``poisson``  — homogeneous Poisson arrivals (exponential inter-arrival
  times at ``rate`` req/s): the steady-state baseline.
- ``bursty``   — a 2-state Markov-modulated Poisson process (MMPP):
  exponentially-distributed dwells in a ``calm`` state at ``rate`` and a
  ``burst`` state at ``rate * burst_factor``.  Bursts are what stress
  admission control and the bounded queue.
- ``diurnal``  — a nonhomogeneous Poisson process with a sinusoidal rate
  profile ``rate * (1 + depth * sin(2*pi*t/period))``, sampled by
  Lewis-Shedler thinning: the compressed day/night cycle.

Prompt/output lengths are sampled from clipped lognormals (long-tailed,
like real chat traffic) inside caller-given bounds; each request carries
its own embedding seed for :func:`dlbb_tpu_torch.data.synthetic.
request_embeddings`.  Traces serialise to JSON (schema
``dlbb_serving_trace_v1``, documented in ``docs/serving.md``) through the
repo's atomic writer.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np

TRACE_SCHEMA = "dlbb_serving_trace_v1"

TRACE_KINDS = ("poisson", "bursty", "diurnal")


@dataclass(frozen=True)
class Request:
    """One serving request, fully determined at trace-generation time.

    arrival_s is relative to the start of the run (the engine's
    monotonic clock); ``seed`` derives the request's synthetic prompt
    embeddings, so replaying a trace replays the exact inputs.
    ``deadline_s`` is an optional per-request SLO, in seconds from
    *arrival*: the scheduler sheds a queued request whose wait has
    already blown it (``request-rejected[reason=deadline]``), and a
    request that completes past it is counted
    ``completed_past_deadline`` (docs/serving.md).  Absent (None) means
    no deadline — the pre-deadline trace schema is unchanged.
    ``prompt_period`` tiles the request's prompt embeddings from a
    seeded motif of that many positions (``data/synthetic.py``) — the
    repeating-structure variant that gives the n-gram drafter real
    lookup structure; None (the default) keeps the original fully
    random prompts and the original serialisation.
    ``prefix_len``/``prefix_seed`` mark the request a member of a
    shared-prefix group (``generate_trace(prefix_groups=…)``): its
    first ``prefix_len`` prompt positions are drawn from the GROUP seed
    ``prefix_seed``, bit-identical across the group, which is what the
    engine's prefix trie content-addresses.  Absent (None) keeps the
    original prompts and serialisation."""

    rid: int
    arrival_s: float
    prompt_len: int
    output_len: int
    seed: int
    deadline_s: Optional[float] = None
    prompt_period: Optional[int] = None
    prefix_len: Optional[int] = None
    prefix_seed: Optional[int] = None

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.output_len


@dataclass(frozen=True)
class TrafficTrace:
    """A replayable request trace (sorted by arrival time)."""

    kind: str
    seed: int
    params: dict[str, Any]
    requests: tuple[Request, ...] = field(default_factory=tuple)

    def __iter__(self) -> Iterator[Request]:
        return iter(self.requests)

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def horizon_s(self) -> float:
        """Arrival time of the last request (0 for an empty trace)."""
        return self.requests[-1].arrival_s if self.requests else 0.0

    @property
    def max_total_tokens(self) -> int:
        return max((r.total_tokens for r in self.requests), default=0)

    @property
    def max_prompt_len(self) -> int:
        return max((r.prompt_len for r in self.requests), default=0)

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema": TRACE_SCHEMA,
            "kind": self.kind,
            "seed": self.seed,
            "params": dict(self.params),
            # optional fields serialise only when set, so committed
            # pre-feature traces stay byte-stable
            "requests": [
                {k: v for k, v in asdict(r).items()
                 if k not in ("deadline_s", "prompt_period",
                              "prefix_len", "prefix_seed")
                 or v is not None}
                for r in self.requests
            ],
        }

    def save(self, path: "str | Path") -> Path:
        from dlbb_tpu_torch.utils.config import atomic_write_text

        return atomic_write_text(json.dumps(self.to_dict(), indent=2),
                                 Path(path))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrafficTrace":
        if d.get("schema") != TRACE_SCHEMA:
            raise ValueError(
                f"not a serving trace (schema={d.get('schema')!r}, "
                f"expected {TRACE_SCHEMA!r})"
            )
        reqs = tuple(Request(**r) for r in d["requests"])
        return cls(kind=d["kind"], seed=int(d["seed"]),
                   params=dict(d.get("params", {})), requests=reqs)

    @classmethod
    def load(cls, path: "str | Path") -> "TrafficTrace":
        from dlbb_tpu_torch.resilience import inject

        text = Path(path).read_text()
        if inject.fire("serve-trace-corrupt"):
            # chaos harness: model a torn/corrupt trace file on disk —
            # the load below must fail CLOSED with a chained error, and
            # the caller must publish nothing
            text = text[:int(len(text) * inject.param("torn_fraction"))]
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"serving trace {path} is corrupt or truncated "
                "(refusing to serve a partial trace)"
            ) from e
        return cls.from_dict(d)


def _lognormal_lengths(rng: np.random.Generator, n: int,
                       lo: int, hi: int) -> np.ndarray:
    """Clipped-lognormal integer lengths in ``[lo, hi]`` — median near the
    geometric middle of the range, with the long right tail clipped."""
    if lo < 1 or lo > hi:
        raise ValueError(
            f"length bounds must satisfy 1 <= lo <= hi, got [{lo}, {hi}]"
        )
    if lo == hi:
        return np.full(n, lo, dtype=np.int64)
    mu = 0.5 * (math.log(lo) + math.log(hi))
    sigma = (math.log(hi) - math.log(lo)) / 4.0
    raw = rng.lognormal(mean=mu, sigma=sigma, size=n)
    return np.clip(np.round(raw).astype(np.int64), lo, hi)


def _poisson_arrivals(rng: np.random.Generator, n: int,
                      rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def _bursty_arrivals(rng: np.random.Generator, n: int, rate: float,
                     burst_factor: float, dwell_s: float) -> np.ndarray:
    """2-state MMPP: exponential dwells (mean ``dwell_s``) alternating
    between ``rate`` and ``rate * burst_factor``."""
    arrivals = np.empty(n)
    t = 0.0
    burst = False
    state_end = float(rng.exponential(dwell_s))
    for i in range(n):
        while True:
            r = rate * burst_factor if burst else rate
            gap = float(rng.exponential(1.0 / r))
            if t + gap <= state_end:
                t += gap
                arrivals[i] = t
                break
            # the gap straddles a state switch: advance to the boundary
            # and resample in the new state (memorylessness makes the
            # truncated draw exact)
            t = state_end
            burst = not burst
            state_end = t + float(rng.exponential(dwell_s))
    return arrivals


def _diurnal_arrivals(rng: np.random.Generator, n: int, rate: float,
                      period_s: float, depth: float) -> np.ndarray:
    """Lewis-Shedler thinning of a ``rate * (1 + depth*sin)`` profile."""
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"diurnal depth must be in [0, 1), got {depth}")
    rate_max = rate * (1.0 + depth)
    arrivals = np.empty(n)
    t = 0.0
    i = 0
    while i < n:
        t += float(rng.exponential(1.0 / rate_max))
        lam = rate * (1.0 + depth * math.sin(2.0 * math.pi * t / period_s))
        if rng.uniform() * rate_max <= lam:
            arrivals[i] = t
            i += 1
    return arrivals


def generate_trace(
    kind: str,
    num_requests: int,
    seed: int = 42,
    rate: float = 32.0,
    prompt_range: tuple[int, int] = (8, 96),
    output_range: tuple[int, int] = (4, 48),
    burst_factor: float = 6.0,
    dwell_s: float = 0.5,
    period_s: float = 4.0,
    depth: float = 0.8,
    deadline_s: Optional[float] = None,
    prompt_period: Optional[int] = None,
    prefix_groups: Optional[int] = None,
    prefix_len: Optional[int] = None,
) -> TrafficTrace:
    """Generate a seeded, replayable trace.

    ``rate`` is the mean arrival rate in req/s (the calm-state rate for
    ``bursty``, the mean of the sinusoid for ``diurnal``); length bounds
    are inclusive.  ``deadline_s`` stamps every request with that SLO
    (seconds from arrival; None = no deadlines, the original schema).
    ``prompt_period`` stamps every request with a repeating-structure
    prompt (motif of that many positions tiled to the prompt length —
    the speculative-decoding bench's trace variant; None = fully random
    prompts, the original schema).  ``prefix_groups`` splits the trace
    into that many seeded shared-prefix populations: each request joins
    a group and shares its first ``prefix_len`` prompt positions
    (clamped to ``prompt_len - 1``; default the midpoint of
    ``prompt_range``) with every other member — the system-prompt /
    few-shot-header traffic shape the prefix cache exploits.  The group
    draws happen AFTER all original draws, so prefix-free traces stay
    byte-identical to the pre-feature schema.  The same ``(kind,
    num_requests, seed, params)`` always yields the identical trace.
    """
    if kind not in TRACE_KINDS:
        raise ValueError(
            f"unknown trace kind {kind!r} (expected one of {TRACE_KINDS})"
        )
    if num_requests <= 0:
        raise ValueError(f"num_requests must be > 0, got {num_requests}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0 req/s, got {rate}")
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        arrivals = _poisson_arrivals(rng, num_requests, rate)
        params: dict[str, Any] = {"rate": rate}
    elif kind == "bursty":
        arrivals = _bursty_arrivals(rng, num_requests, rate,
                                    burst_factor, dwell_s)
        params = {"rate": rate, "burst_factor": burst_factor,
                  "dwell_s": dwell_s}
    else:
        arrivals = _diurnal_arrivals(rng, num_requests, rate,
                                     period_s, depth)
        params = {"rate": rate, "period_s": period_s, "depth": depth}
    prompts = _lognormal_lengths(rng, num_requests, *prompt_range)
    outputs = _lognormal_lengths(rng, num_requests, *output_range)
    seeds = rng.integers(0, 2**31 - 1, size=num_requests)
    params.update({"prompt_range": list(prompt_range),
                   "output_range": list(output_range)})
    if deadline_s is not None:
        if deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0 seconds, got {deadline_s}"
            )
        params["deadline_s"] = deadline_s
    if prompt_period is not None:
        if prompt_period < 1:
            raise ValueError(
                f"prompt_period must be >= 1, got {prompt_period}"
            )
        params["prompt_period"] = prompt_period
    prefix_lens = prefix_seeds = None
    if prefix_groups is not None:
        if prefix_groups < 1:
            raise ValueError(
                f"prefix_groups must be >= 1, got {prefix_groups}"
            )
        if prefix_len is None:
            prefix_len = (prompt_range[0] + prompt_range[1]) // 2
        if prefix_len < 1:
            raise ValueError(f"prefix_len must be >= 1, got {prefix_len}")
        if prompt_range[0] < 2:
            raise ValueError(
                "prefix_groups needs prompt_range lo >= 2 (every request "
                "must keep at least one per-request position after its "
                "shared prefix)"
            )
        # drawn after every original draw: prefix-free traces are
        # byte-identical to the pre-feature schema
        group_seeds = rng.integers(0, 2**31 - 1, size=prefix_groups)
        membership = rng.integers(0, prefix_groups, size=num_requests)
        prefix_seeds = [int(group_seeds[g]) for g in membership]
        prefix_lens = [min(prefix_len, int(prompts[i]) - 1)
                       for i in range(num_requests)]
        params.update({"prefix_groups": prefix_groups,
                       "prefix_len": prefix_len})
    elif prefix_len is not None:
        raise ValueError("prefix_len requires prefix_groups")
    requests = tuple(
        Request(rid=i, arrival_s=float(arrivals[i]),
                prompt_len=int(prompts[i]), output_len=int(outputs[i]),
                seed=int(seeds[i]), deadline_s=deadline_s,
                prompt_period=prompt_period,
                prefix_len=None if prefix_lens is None else prefix_lens[i],
                prefix_seed=(None if prefix_seeds is None
                             else prefix_seeds[i]))
        for i in range(num_requests)
    )
    return TrafficTrace(kind=kind, seed=seed, params=params,
                        requests=requests)
