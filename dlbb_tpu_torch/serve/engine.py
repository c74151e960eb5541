"""Continuous-batching inference engine over the paged KV-cache
(counterpart of ``dlbb_tpu/serve/engine.py``): ROADMAP Queue 1, Slice E,
item 11, parts 11a (the core), 11b (the fast path and the capacity levers),
11c (speculative and sampled decoding) and 11d (serving resilience).

The device programs, fixed shapes for the whole run:

- **prefill** (per sequence-length *bucket*): runs the full transformer
  stack over one request's ``[1, bucket, H]`` prompt with ordinary causal
  attention (``models/attention.py::dense_attention``, as JAX's prefill),
  writes its K/V into the first ``bucket / block_size`` blocks of the
  request's cache slot, sets the slot length, and returns the last real
  token's output: the request's FIRST generated token (TTFT stops here).
- **prefill chunk** (``prefill_chunk``; per chunk offset): one chunk of a
  chunked prefill, attending over an explicit prefix carry ``[L, start,
  kvh, d]`` plus the chunk (``_chunk_attention``: fp32, offset-causal), its
  blocks written at block offset ``start / block_size``.
- **decode_step** (``[max_batch, 1, H]``): appends each active slot's
  pending token to the cache at its own length, attends over the slot's
  valid prefix (length-masked fp32 softmax, GQA-grouped at ``kv_heads``
  width, never repeated), and produces every slot's next token.  In the
  "off" mode the output hidden state IS the next step's input embedding
  (the model is its own next-token function); in the "greedy" token mode
  the output is quantised through ``data.synthetic.token_embedding_table``
  (``tok = argmax(y)``, next input ``table[tok]``).
- **decode_fused** (``decode_horizon``; k = 2, 4, ... steps): k calls of
  the one decode-step math in a device-side loop, step ``i`` over ``active
  & (i < remaining)``, with no host read between trips; ``ys`` stacked.
- **compaction** (``compact_threshold``, dp = 1): the active slots gathered
  into a half-size batch, a fused scan over it, and the rows scattered
  back.
- **prefix attach** (``prefix_caching``, dp = 1): a donor slot's first
  matched blocks copied into the admitted slot, and returned as the
  chunked prefill's prefix carry, so only the suffix chunks run.
- **verify** (``speculation`` "ngram" or "draft-model"; per γ of the
  ladder): each slot's pending token and its γ drafts through every
  block, each position in the decode step's own shapes, K/V rows appended
  at ``lengths + i`` and position ``i`` attending to the keys up to it
  (``_verify_math``); the greedy verify commits
  the accepted prefix and one more token on the device, the sampled one
  (``temperature > 0``) returns the logits, the host samples, and a small
  commit program advances the carry.  The draft model runs γ greedy token
  steps on its own cache (``build_draft_scan``); the n-gram drafter is host
  code.

With ``kv_quantization="int8"`` the cache is a ``QuantKVCache`` and the
programs read its layout from the cache they are given: a prefill
quantises its blocks as it writes them (attention runs over the exact
values), and a decode step attends over the dequantised old codes plus the
exact new row, then requantises only each writing slot's touched block.

The programs are plain callables on the port's stacked ``[L, ...]``
parameters, run eagerly: there is no ``jit``, no compile and no CUDA
graph.  JAX donates the cache and rebuilds it with ``jnp.where``; here the
cache tensors are updated in place, which is what XLA does with a donated
buffer: a decode step writes one ``[kv_heads, head_dim]`` row per active
slot at that slot's length (an inactive slot's row is written back with
its own bits), a prefill writes only the granted slot's blocks, and
``lengths`` advances only for active slots.  A whole-cache select would
copy the 12 GiB cache of a one-card 1B server on every step.

Tensor and data parallelism run as one process per rank of a ``(dp, tp)``
mesh (``comm.mesh.build_parallelism_mesh``), where JAX runs one program on
a device mesh.  Each rank holds its tp shard of the layer weights
(``models/sharding.py``'s Megatron layout; the row-parallel ``out`` and
``ffn_down`` products are summed over the tp group) and its
``serve/kvcache.py::shard_cache`` shard of the cache: its ``max_batch /
dp`` slots, its ``kv_heads / tp`` heads, ``lengths`` whole on every rank.
A decode step runs on every rank over the rank's own slots; ``active`` is
whole on every rank, as JAX replicates it.  A prefill (or chunk) runs only
in the dp group that owns the slot, which alone writes it; its ``y_last``
is then broadcast over each tp column's dp group from the owner (one
``[H]`` vector per admission), so every rank injects and counts the same
first token and times the same prefill.  With ``capture_tokens``, or
under the n-gram drafter (whose histories they extend), each decode
unit's token ids are all-gathered over the dp group.

Around them, a host-side continuous-batching scheduler (Orca-style
iteration-level scheduling): arrivals from a ``TrafficTrace`` pass
admission control (bounded queue: overflow is a *rejected* request),
waiting requests are granted slots and worst-case block reservations at
step boundaries, completed requests free both immediately, and the next
decode unit runs with whatever mix of old and new requests is resident: a
single step, or a fused scan up to the next scheduling event, kept in an
in-flight window of ``inflight_window`` units before the host waits on
it.  JAX has one host controller; the port has one scheduler per rank, and
admission and the scan horizon read the wall clock, so rank 0's clock (and
its estimate of the steps to the next arrival) is broadcast: every rank
takes the same decisions.  Per-phase spans, request-lifecycle events into
the resilience journal and the registry's counters are JAX's, name for
name.

Under speculation every rank must take the same decisions: a verify unit
gathers its token ids and commits over the dp group (they move the
n-gram histories and the ledger), whether the drafter is cold is read
from the histories of every resident slot, and the sampled path gathers
the verify logits, so every rank draws from one numpy generator over the
global slots in JAX's order and commits the same tokens.  The draft
model's proposals stay on each rank's own slots.

Resilience (part 11d), JAX's paths under JAX's names, counters and
journal events: the serving fault sites of ``resilience/inject.py`` fire
on the host side of a dispatch boundary; a transient fault
(``TransientFault``, ``CorruptStats``) rolls the host bookkeeping back to
the pre-dispatch snapshot and re-issues the unit with exponential backoff,
and a torn bookkeeping pass replays from the device result in hand; an
exhausted retry fails only the affected requests closed, with their
exception chains; any other exception from a dispatch fails the resident
batch closed and continues on a fresh carry, since a program that raised
part-way may already have appended rows in place.  ``dispatch_deadline_factor``
arms the watchdog (``_with_deadline``): an overrunning unit is abandoned
on its thread, its window fails closed as ``hung-dispatch`` and the engine
continues on a fresh carry.  Requests may carry SLO deadlines (blown queue
heads are shed, late completions counted), and a SIGTERM under the run's
``PreemptionGuard`` drains the window and returns a preempted report that
``serve/bench.py::resume_serving`` replays.  On a mesh every such verdict
is rank 0's, broadcast like its clock: the watchdog's, the drain flag and
the late check.  A sticky CUDA error poisons the context and no fresh
carry recovers from it; neither does a real overrun stuck inside a tp
collective on a multi-rank mesh, whose abandoned thread may still be
waiting on the group: both fail the run.

The fleet's replica hooks (``run_trace``'s ``feed`` and ``control``,
``serve/fleet.py``) are consulted only at the scheduler loop's boundary.
``capture_device_traces`` captures one prefill and one decode scan on
fresh state after a run (``obs/capture.py``, JAX's serving capture).
``hedge_factor`` is the fleet's: one engine accepts and ignores it, as
JAX's does.
"""

from __future__ import annotations

import math
import os
import queue
import signal
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field, replace as dc_replace
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dlbb_tpu_torch.data.synthetic import (
    prompt_token_ids,
    request_embeddings,
    token_embedding_table,
)
from dlbb_tpu_torch.models.attention import dense_attention
from dlbb_tpu_torch.models.configs import ModelConfig, validate_serving
from dlbb_tpu_torch.models.sharding import all_gather_along, local_config
from dlbb_tpu_torch.models.transformer import (
    DTYPES,
    _layernorm,
    _projections,
    init_params,
    layer_list,
)
from dlbb_tpu_torch.obs import spans
from dlbb_tpu_torch.obs.export import MetricsRegistry
from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.resilience.errors import (
    CorruptStats,
    DeadlineExceeded,
    InjectedFault,
    TransientFault,
    exception_chain,
)
from dlbb_tpu_torch.resilience.preempt import PreemptionGuard
from dlbb_tpu_torch.serve.kvcache import (
    BlockLedger,
    KVCache,
    QuantKVCache,
    create_kv_cache,
    create_quant_kv_cache,
    dequantize_kv_blocks,
    gather_cache_slots,
    quantize_kv_blocks,
    scatter_cache_slots,
)
from dlbb_tpu_torch.serve.traffic import Request, TrafficTrace
from dlbb_tpu_torch.utils.metrics import Timer, summarize
from dlbb_tpu_torch.utils.sysinfo import resolve_device

SERVING_REPORT_SCHEMA = "dlbb_serving_report_v1"

# decode feedback / drafting modes (ServingConfig.speculation):
# "off" = legacy continuous hidden-state feedback; "greedy" = token
# feedback without drafting (the speculative modes' pinned oracle);
# "ngram" / "draft-model" = draft-and-verify speculative decoding
SPECULATION_MODES = ("off", "greedy", "ngram", "draft-model")


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def _default_buckets(block_size: int, max_seq: int) -> tuple[int, ...]:
    """Doubling bucket ladder: block_size, 2x, 4x, ... up to max_seq."""
    buckets = []
    b = block_size
    while b < max_seq:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq)
    return tuple(buckets)


@dataclass(frozen=True)
class ServingConfig:
    """The serving envelope (YAML ``serving:`` section), a copy of JAX's:
    every field, its validation and its messages; JAX's docstring
    (``dlbb_tpu/serve/engine.py:171-300``) documents each.

    max_batch:       decode slots (the fixed decode batch dim).
    block_size:      tokens per cache block.
    max_seq:         per-slot capacity (prompt + output ceiling); must be
                     a block multiple — ``num_blocks = max_seq/block_size``.
    prefill_buckets: sequence-length buckets prefill runs at
                     (block-multiples; default: doubling ladder up to
                     max_seq).  A prompt pads to the smallest bucket >= it.
    queue_capacity:  admission-control bound; an arrival finding the
                     queue full is REJECTED (counted, journaled).
    blocks_budget:   global cache-block budget the ledger enforces
                     (default: the physical pool, max_batch x num_blocks;
                     set lower to model cache pressure).
    hbm_budget_gb:   per-device HBM budget the build-time footprint gate
                     (``models.configs.validate_serving``) checks the
                     KV-cache against; None disables the gate.
    reject_infeasible: reject-and-journal requests the envelope cannot
                     serve (reason="infeasible") instead of failing the
                     whole trace up front (the strict default).
    decode_horizon:  the most decode steps fused into one unit (1: the
                     per-step engine; fused scans run k = 2, 4, ... up to it).
    inflight_window: decode units dispatched before the host waits on the
                     oldest (fused units only).
    prefill_chunk:   chunked prefill's chunk length (None: monolithic).
    compact_threshold: fused scans run on a gathered half-size batch while
                     at most this share of the slots is resident (dp = 1).
    prefix_caching:  shared prompt blocks are copied from a resident donor
                     slot instead of prefilled (needs ``prefill_chunk``).
    kv_quantization: "none" or "int8" (int8 blocks, per block and kv-head
                     fp32 scales).
    speculation:     "off" (continuous hidden-state feedback), "greedy"
                     (token feedback through the greedy token table), or
                     the drafting modes "ngram" and "draft-model".
    spec_gamma:      drafts per verify unit (the largest of the γ ladder).
    spec_adaptive:   each request backs its γ off through the ladder by
                     its acceptance EMA.
    spec_draft_layers, spec_draft_kv_heads: the draft model's depth and
                     kv heads ("draft-model").
    temperature:     > 0 samples every token on the host (residual
                     sampling over the verify logits) from a numpy
                     generator seeded with ``sample_seed``.
    """

    max_batch: int = 8
    block_size: int = 16
    max_seq: int = 256
    prefill_buckets: tuple[int, ...] = ()
    queue_capacity: int = 64
    blocks_budget: Optional[int] = None
    hbm_budget_gb: Optional[float] = 12.0
    decode_horizon: int = 1
    inflight_window: int = 1
    prefill_chunk: Optional[int] = None
    compact_threshold: Optional[float] = None
    reject_infeasible: bool = False
    max_dispatch_retries: int = 2
    retry_backoff_s: float = 0.05
    dispatch_deadline_factor: Optional[float] = None
    dispatch_deadline_min_s: float = 0.25
    speculation: str = "off"
    spec_gamma: int = 0
    spec_adaptive: bool = False
    spec_draft_layers: int = 1
    spec_draft_kv_heads: Optional[int] = None
    prefix_caching: bool = False
    kv_quantization: str = "none"
    temperature: float = 0.0
    sample_seed: int = 0
    hedge_factor: Optional[float] = None

    def __post_init__(self) -> None:
        if not self.prefill_buckets:
            object.__setattr__(
                self, "prefill_buckets",
                _default_buckets(self.block_size, self.max_seq),
            )
        else:
            # normalise: bucket_for's first-match walk and every
            # "buckets[-1] is the largest" consumer assume ascending
            # unique buckets
            object.__setattr__(
                self, "prefill_buckets",
                tuple(sorted(set(self.prefill_buckets))),
            )

    @property
    def num_blocks(self) -> int:
        return self.max_seq // self.block_size

    @property
    def total_blocks(self) -> int:
        return (self.blocks_budget if self.blocks_budget is not None
                else self.max_batch * self.num_blocks)

    def validate(self, config: ModelConfig, dp: int = 1,
                 tp: int = 1) -> None:
        budget = (None if self.hbm_budget_gb is None
                  else int(self.hbm_budget_gb * 2**30))
        if self.speculation not in SPECULATION_MODES:
            raise ValueError(
                f"serving.speculation={self.speculation!r} must be one "
                f"of {SPECULATION_MODES}"
            )
        # speculation with tp_overlap != off or non-dense attention is
        # rejected inside validate_serving (those envelopes cannot serve
        # at all); the draft plane re-runs the same gate on its own
        # config below, so a draft kv plane breaking kv_heads % tp
        # fails here at build time too
        draft = (self.draft_model_config(config)
                 if self.speculation == "draft-model" else None)
        validate_serving(config, self.max_batch, self.max_seq,
                         self.block_size, dp=dp, tp=tp,
                         hbm_budget_bytes=budget, draft_config=draft,
                         kv_quantization=self.kv_quantization)
        for b in self.prefill_buckets:
            if b % self.block_size != 0 or not 0 < b <= self.max_seq:
                raise ValueError(
                    f"prefill bucket {b} must be a block_size="
                    f"{self.block_size} multiple in (0, {self.max_seq}]"
                )
        if self.queue_capacity < 1:
            raise ValueError(
                f"serving.queue_capacity must be >= 1, got "
                f"{self.queue_capacity}"
            )
        if self.hedge_factor is not None and self.hedge_factor <= 1.0:
            raise ValueError(
                f"serving.hedge_factor must be > 1.0 (it scales the "
                f"observed p99 latency), got {self.hedge_factor}"
            )
        if self.total_blocks < 1:
            raise ValueError(
                f"serving.blocks_budget must be >= 1, got "
                f"{self.total_blocks}"
            )
        if self.decode_horizon < 1:
            raise ValueError(
                f"serving.decode_horizon must be >= 1, got "
                f"{self.decode_horizon}"
            )
        if self.inflight_window < 1:
            raise ValueError(
                f"serving.inflight_window must be >= 1, got "
                f"{self.inflight_window}"
            )
        if self.inflight_window > 1 and self.decode_horizon < 2:
            raise ValueError(
                "serving.inflight_window > 1 requires decode_horizon "
                ">= 2: per-step (k=1) units never stay in flight (their "
                "y may alias the donated carry), so the window would be "
                "a silent no-op on the per-step engine"
            )
        if self.prefill_chunk is not None:
            if (self.prefill_chunk % self.block_size != 0
                    or not 0 < self.prefill_chunk <= self.max_seq):
                raise ValueError(
                    f"serving.prefill_chunk={self.prefill_chunk} must be "
                    f"a block_size={self.block_size} multiple in "
                    f"(0, {self.max_seq}]"
                )
            if self.max_seq % self.prefill_chunk != 0:
                # a prompt near max_seq pads to ceil(prompt/chunk)*chunk;
                # unless the chunk divides max_seq that rounding can
                # overrun the slot's block ring for a perfectly feasible
                # request — reject the geometry up front
                raise ValueError(
                    f"serving.prefill_chunk={self.prefill_chunk} must "
                    f"divide serving.max_seq={self.max_seq} (chunk "
                    "rounding of a near-max_seq prompt would overrun "
                    "the slot's block ring)"
                )
        if self.compact_threshold is not None:
            if not 0.0 < self.compact_threshold <= 0.5:
                raise ValueError(
                    f"serving.compact_threshold must be in (0, 0.5] — "
                    f"compaction repacks into the half-size batch bucket "
                    f"(got {self.compact_threshold})"
                )
            if self.decode_horizon < 2:
                raise ValueError(
                    "serving.compact_threshold requires decode_horizon "
                    ">= 2: compaction only engages on fused scans, so "
                    "with the per-step engine it would be a silent no-op "
                    "that still pays the gather/scatter compiles"
                )
            if self.max_batch < 2:
                raise ValueError(
                    "serving.compact_threshold needs max_batch >= 2 "
                    "(nothing to compact into)"
                )
            if dp > 1:
                raise ValueError(
                    "serving.compact_threshold requires dp=1: the slot "
                    "gather/scatter must stay shard-local, and the slot "
                    f"dim is sharded over dp={dp}"
                )
        if self.max_dispatch_retries < 0:
            raise ValueError(
                f"serving.max_dispatch_retries must be >= 0, got "
                f"{self.max_dispatch_retries}"
            )
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"serving.retry_backoff_s must be >= 0, got "
                f"{self.retry_backoff_s}"
            )
        if (self.dispatch_deadline_factor is not None
                and self.dispatch_deadline_factor <= 0):
            raise ValueError(
                f"serving.dispatch_deadline_factor must be > 0, got "
                f"{self.dispatch_deadline_factor}"
            )
        if self.dispatch_deadline_min_s <= 0:
            raise ValueError(
                f"serving.dispatch_deadline_min_s must be > 0 seconds, "
                f"got {self.dispatch_deadline_min_s}"
            )
        # -- speculation ladder (same no-op-trap contract as
        #    compact_threshold/inflight_window: a knob that would
        #    silently do nothing is a config error) --
        if self.spec_drafting:
            if self.spec_gamma < 1:
                raise ValueError(
                    f"serving.speculation={self.speculation!r} requires "
                    f"spec_gamma >= 1 (got {self.spec_gamma}): a drafter "
                    "with zero proposals per verify is a silent no-op "
                    "that still pays the verify compiles"
                )
            if self.spec_gamma + 1 > self.max_seq:
                raise ValueError(
                    f"serving.spec_gamma={self.spec_gamma} cannot exceed "
                    f"max_seq-1={self.max_seq - 1}: a verify step "
                    "appends gamma+1 positions to one slot"
                )
        else:
            if self.spec_gamma:
                raise ValueError(
                    f"serving.spec_gamma={self.spec_gamma} requires a "
                    "drafting speculation mode ('ngram' or "
                    "'draft-model'); with speculation="
                    f"{self.speculation!r} no verify step ever runs, so "
                    "the knob would be a silent no-op"
                )
            if self.spec_adaptive:
                raise ValueError(
                    "serving.spec_adaptive requires a drafting "
                    "speculation mode ('ngram' or 'draft-model'): "
                    "there is no acceptance EMA to adapt to with "
                    f"speculation={self.speculation!r}"
                )
        if self.speculation != "off" and self.compact_threshold is not None:
            raise ValueError(
                "serving.compact_threshold cannot combine with "
                f"speculation={self.speculation!r}: token-feedback and "
                "verify units run on the full decode batch (no "
                "compacted token/verify program exists), so compaction "
                "would be a silent no-op that still pays the gather/"
                "scatter compiles"
            )
        if self.speculation == "draft-model":
            if self.spec_draft_layers < 1:
                raise ValueError(
                    f"serving.spec_draft_layers must be >= 1, got "
                    f"{self.spec_draft_layers}"
                )
            if self.prefill_chunk is not None:
                raise ValueError(
                    "serving.prefill_chunk cannot combine with "
                    "speculation='draft-model': the draft KV plane is "
                    "prefilled monolithically at admission, and a "
                    "chunked target prefill would leave it silently "
                    "unfilled"
                )
        # -- shared-prefix cache + quantized KV planes (same no-op-trap
        #    contract: a knob that cannot engage is a config error) --
        if self.prefix_caching:
            if self.prefill_chunk is None:
                raise ValueError(
                    "serving.prefix_caching requires prefill_chunk: the "
                    "suffix-only prefill of a prefix hit IS the chunked-"
                    "prefill machinery (attach replaces the matched "
                    "chunks), so without it every admission would pay "
                    "the full prefill and the trie would be a silent "
                    "no-op"
                )
            if dp > 1:
                raise ValueError(
                    "serving.prefix_caching requires dp=1: the prefix "
                    "attach copies donor-slot blocks into the admitted "
                    "slot, and that copy must stay shard-local — the "
                    f"slot dim is sharded over dp={dp} (same constraint "
                    "as compact_threshold)"
                )
            if self.speculation != "off":
                raise ValueError(
                    "serving.prefix_caching cannot combine with "
                    f"speculation={self.speculation!r}: prefix attach "
                    "rides the chunked prefill, which the speculative "
                    "modes exclude (and generated tokens are never "
                    "indexed in the trie, so drafting gains nothing)"
                )
        if self.kv_quantization == "int8":
            if self.speculation != "off":
                raise ValueError(
                    "serving.kv_quantization='int8' cannot combine with "
                    f"speculation={self.speculation!r}: the token/"
                    "verify programs read and write the fp cache layout "
                    "only"
                )
            if self.compact_threshold is not None:
                raise ValueError(
                    "serving.kv_quantization='int8' cannot combine with "
                    "compact_threshold: the slot gather/scatter programs "
                    "repack the fp cache layout only, so compaction "
                    "would silently run on stale scale planes"
                )
        # -- sampled decode (same no-op-trap contract) --
        if self.temperature < 0:
            raise ValueError(
                f"serving.temperature must be >= 0, got "
                f"{self.temperature}"
            )
        if self.temperature > 0:
            if not self.spec_drafting:
                raise ValueError(
                    f"serving.temperature={self.temperature} requires a "
                    "drafting speculation mode ('ngram' or "
                    "'draft-model'): the sampled path runs inside the "
                    "verify unit (residual sampling over the verify "
                    "logits), and with speculation="
                    f"{self.speculation!r} every decode program is the "
                    "greedy argmax law — the knob would silently emit "
                    "greedy tokens"
                )
            if self.decode_horizon != 1:
                raise ValueError(
                    f"serving.temperature={self.temperature} requires "
                    f"decode_horizon=1 (got {self.decode_horizon}): the "
                    "fused token scans are greedy-argmax programs, so a "
                    "fused unit mid-sampled-run would silently emit "
                    "greedy tokens (the verify window is the sampled "
                    "path's multi-token mechanism)"
                )
            if self.prefill_chunk is not None:
                raise ValueError(
                    f"serving.temperature={self.temperature} cannot "
                    "combine with prefill_chunk: the chunk interleave's "
                    "per-step decode units are greedy token programs, "
                    "so a long admission would silently emit greedy "
                    "tokens mid-sampled-run"
                )
        elif self.sample_seed:
            raise ValueError(
                f"serving.sample_seed={self.sample_seed} requires "
                "temperature > 0: the greedy path never consumes the "
                "host RNG, so the knob would be a silent no-op"
            )

    @property
    def spec_drafting(self) -> bool:
        """True when a drafter runs (verify steps exist)."""
        return self.speculation in ("ngram", "draft-model")

    @property
    def spec_gammas(self) -> tuple[int, ...]:
        """The verify-step γ ladder: powers of two 1, 2, 4, ... below
        ``spec_gamma``, plus ``spec_gamma`` itself (adaptive γ backs
        off through these buckets; empty when not drafting)."""
        if not self.spec_drafting:
            return ()
        gs = []
        g = 1
        while g < self.spec_gamma:
            gs.append(g)
            g *= 2
        gs.append(self.spec_gamma)
        return tuple(sorted(set(gs)))

    def draft_model_config(self, config: ModelConfig) -> ModelConfig:
        """The draft transformer's config: the target at
        ``spec_draft_layers`` depth (and an optional kv_heads
        override), everything else — hidden size, heads, dtype,
        attention — identical, so the draft shares the target's
        ParallelismPlan and its outputs live in the same hidden/token
        space the verify step argmaxes over."""
        kwargs: dict[str, Any] = {"num_layers": self.spec_draft_layers}
        if self.spec_draft_kv_heads is not None:
            kwargs["num_kv_heads"] = self.spec_draft_kv_heads
        return dc_replace(config, **kwargs)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt_len={prompt_len} exceeds the largest prefill bucket "
            f"{self.prefill_buckets[-1]} (serving.max_seq={self.max_seq})"
        )

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServingConfig":
        fields = {}
        for k in ("max_batch", "block_size", "max_seq", "queue_capacity",
                  "blocks_budget", "hbm_budget_gb", "decode_horizon",
                  "inflight_window", "prefill_chunk", "compact_threshold",
                  "reject_infeasible", "max_dispatch_retries",
                  "retry_backoff_s", "dispatch_deadline_factor",
                  "dispatch_deadline_min_s", "speculation", "spec_gamma",
                  "spec_adaptive", "spec_draft_layers",
                  "spec_draft_kv_heads", "prefix_caching",
                  "kv_quantization", "temperature", "sample_seed",
                  "hedge_factor"):
            if k in d:
                fields[k] = d[k]
        if "prefill_buckets" in d:
            fields["prefill_buckets"] = tuple(d["prefill_buckets"])
        return cls(**fields)

    def to_dict(self) -> dict[str, Any]:
        return {
            "max_batch": self.max_batch,
            "block_size": self.block_size,
            "max_seq": self.max_seq,
            "num_blocks": self.num_blocks,
            "prefill_buckets": list(self.prefill_buckets),
            "queue_capacity": self.queue_capacity,
            "blocks_budget": self.total_blocks,
            "hbm_budget_gb": self.hbm_budget_gb,
            "decode_horizon": self.decode_horizon,
            "inflight_window": self.inflight_window,
            "prefill_chunk": self.prefill_chunk,
            "compact_threshold": self.compact_threshold,
            "reject_infeasible": self.reject_infeasible,
            "max_dispatch_retries": self.max_dispatch_retries,
            "retry_backoff_s": self.retry_backoff_s,
            "dispatch_deadline_factor": self.dispatch_deadline_factor,
            "dispatch_deadline_min_s": self.dispatch_deadline_min_s,
            "speculation": self.speculation,
            "spec_gamma": self.spec_gamma,
            "spec_adaptive": self.spec_adaptive,
            "spec_draft_layers": self.spec_draft_layers,
            "spec_draft_kv_heads": self.spec_draft_kv_heads,
            "prefix_caching": self.prefix_caching,
            "kv_quantization": self.kv_quantization,
            "temperature": self.temperature,
            "sample_seed": self.sample_seed,
            "hedge_factor": self.hedge_factor,
        }

    @property
    def fused_horizons(self) -> tuple[int, ...]:
        """The power-of-two fused-scan bucket ladder: 2, 4, ... up to
        ``decode_horizon`` (empty when the fast path is off)."""
        ks = []
        k = 2
        while k <= self.decode_horizon:
            ks.append(k)
            k *= 2
        return tuple(ks)


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------


def _tp_mesh(mesh):
    """The mesh whose tp group the programs' products sum over, None
    where tp is 1 (no collective at all)."""
    return mesh if mesh is not None and mesh.shape["tp"] > 1 else None


def _slot_range(cache: KVCache, mesh) -> tuple[int, int]:
    """``(first, count)``: the global slots this rank's cache shard holds
    (its dp rank's contiguous ``max_batch / dp``, as ``shard_cache``
    cuts them)."""
    count = cache.max_batch
    dp_rank = 0 if mesh is None else mesh.coords["dp"]
    return dp_rank * count, count


def _split_qkv(qkv: torch.Tensor, config: ModelConfig):
    """[..., qkv_width] -> q [..., H], k/v [..., kv_heads * head_dim]."""
    h, kvd = config.hidden_size, config.kv_heads * config.head_dim
    return qkv[..., :h], qkv[..., h:h + kvd], qkv[..., h + kvd:]


def _block_head(h, layer, config: ModelConfig, col):
    """A block's ln1 and qkv product: ``(q, k, v)``."""
    y = _layernorm(h, layer["ln1"]["scale"], layer["ln1"]["bias"])
    return _split_qkv(col(y, layer["qkv"]), config)


def _block_tail(h, attn, layer, col, row):
    """A block's out product and residual, then ln2, the ffn and its
    residual."""
    h = row(attn, layer["out"]) + h
    residual = h
    y2 = _layernorm(h, layer["ln2"]["scale"], layer["ln2"]["bias"])
    y2 = col(y2, layer["ffn_up"])
    # jax.nn.gelu defaults to approximate=True: the tanh form
    y2 = F.gelu(y2, approximate="tanh")
    return row(y2, layer["ffn_down"]) + residual


def _serve_block(h, layer, config: ModelConfig, attention_step,
                 cache_state, mesh=None):
    """One transformer block with a pluggable attention step — the ONE
    copy of the ln1/qkv/out/ln2/ffn structure every serving program
    shares (the serving twin of ``transformer._block``; the verify runs
    its two halves, :func:`_block_head` and :func:`_block_tail`, one
    position at a time).
    ``attention_step(q, k, v, cache_state) -> (attn [B, S, n*d],
    cache_state)`` owns everything that differs between prefill (dense
    causal + block write) and decode (cached append + length-masked
    read); ``cache_state`` is the layer's cache planes.  ``config`` is
    this rank's (``sharding.local_config``); on a mesh with tp above 1
    the two row-parallel products are summed over its tp group, then
    their bias is added, once."""
    col, row = _projections(config, mesh)
    q, k, v = _block_head(h, layer, config, col)
    attn, cache_state = attention_step(q, k, v, cache_state)
    return _block_tail(h, attn, layer, col, row), cache_state


def _heads(t: torch.Tensor, nh: int, d: int) -> torch.Tensor:
    """[B, S, nh*d] -> [B, nh, S, d]."""
    b, s, _ = t.shape
    return t.reshape(b, s, nh, d).transpose(1, 2)


def _kv32(k_flat: torch.Tensor, v_flat: torch.Tensor) -> tuple:
    """A layer's flattened cache planes ``[B, S_max, kvh, d]`` as fp32
    copies in ``[B, kvh, S_max, d]`` order, as JAX upcasts them."""
    return tuple(t.permute(0, 2, 1, 3).to(torch.float32, memory_format=torch.contiguous_format)
                 for t in (k_flat, v_flat))


def _attend(q: torch.Tensor, k32: torch.Tensor, v32: torch.Tensor,
            valid: torch.Tensor, dtype) -> torch.Tensor:
    """One query position per slot against a layer's fp32 K/V
    (:func:`_kv32`): q ``[B, n, 1, d]``, valid ``[B, S_max]``; returns
    ``[B, n, 1, d]`` in ``dtype``.  fp32 logits over 1/sqrt(d), fp32
    softmax, the query heads grouped ``[B, kvh, n/kvh, d]`` against each kv
    head (never repeated), and -inf past each slot's length, so those
    positions contribute exactly zero, whatever rows lie there.  Position
    0 of a slot is always valid, so no row is empty."""
    b, n, _, d = q.shape
    kvh = k32.shape[1]
    q32 = q.float().contiguous().reshape(b, kvh, n // kvh, d)
    logits = torch.matmul(q32, k32.transpose(-1, -2)) / math.sqrt(d)
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v32).reshape(b, n, 1, d).to(dtype)


def _cached_attention(q: torch.Tensor, k_flat: torch.Tensor, v_flat: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Length-masked decode attention over the flattened cache (JAX's
    math): q ``[B, n, 1, d]``; k_flat/v_flat ``[B, S_max, kvh, d]``, read
    once per layer into fp32 copies (:func:`_kv32`); valid ``[B, S_max]``
    bool (:func:`_attend`)."""
    k32, v32 = _kv32(k_flat, v_flat)
    return _attend(q, k32, v32, valid, k_flat.dtype)


def _layer_planes(cache, i: int) -> tuple:
    """Layer ``i``'s cache planes: ``(k, v)``, or ``(k, v, k_scale,
    v_scale)`` in the int8 layout."""
    if isinstance(cache, QuantKVCache):
        return (cache.k[i], cache.v[i], cache.k_scale[i], cache.v_scale[i])
    return (cache.k[i], cache.v[i])


def _write_prompt_blocks(cache_layer: torch.Tensor, update: torch.Tensor,
                         slot: int, start_blk: int = 0) -> None:
    """Write a prefill bucket (or chunk) into one slot's blocks from block
    ``start_blk`` on, in place: cache_layer ``[B, nb, bs, kvh, d]`` (this
    rank's slots, ``slot`` local to them) and update ``[wb, bs, kvh, d]``,
    or the int8 layout's scales ``[B, nb, kvh]`` and ``[wb, kvh]`` (JAX's
    ``_write_scale_blocks``).  JAX's one-hot masked select over the whole
    layer touches these blocks and no other."""
    cache_layer[slot, start_blk:start_blk + update.shape[0]] = update


def _write_kv_blocks(planes: tuple, k_blocks: torch.Tensor, v_blocks: torch.Tensor,
                     slot: int, start_blk: int = 0) -> None:
    """Write ``[wb, bs, kvh, d]`` K/V blocks into a layer's planes, each
    block quantised per kv head first in the int8 layout (``planes`` of
    four)."""
    if len(planes) == 4:
        k_l, v_l, ks_l, vs_l = planes
        kq, ks = quantize_kv_blocks(k_blocks)
        vq, vs = quantize_kv_blocks(v_blocks)
        _write_prompt_blocks(k_l, kq, slot, start_blk)
        _write_prompt_blocks(v_l, vq, slot, start_blk)
        _write_prompt_blocks(ks_l, ks, slot, start_blk)
        _write_prompt_blocks(vs_l, vs, slot, start_blk)
    else:
        k_l, v_l = planes
        _write_prompt_blocks(k_l, k_blocks, slot, start_blk)
        _write_prompt_blocks(v_l, v_blocks, slot, start_blk)


def build_prefill(config: ModelConfig, mesh=None):
    """``prefill(cache, params, x, slot, length) -> (cache, y_last)``: one
    request's prompt ``x [1, bucket, H]`` (zeros past ``length``) through
    every layer with dense causal attention, its K/V written into the
    first ``bucket / block_size`` blocks of slot ``slot`` (global) in
    place, ``lengths[slot] = length``, and ``y_last`` the final LN's
    output at position ``length - 1``.  A ``QuantKVCache`` takes the
    blocks quantised; attention runs over the exact values either way.

    On a mesh, ``cache`` is this rank's shard and ``params`` its tp
    shards.  A rank whose dp group does not own ``slot`` records the
    length only (``lengths`` is whole on every rank) and returns
    ``y_last`` None: the owner's dp group runs the prefill alone (the
    engine broadcasts its ``y_last``)."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    local = local_config(config, tp)
    tp_mesh = _tp_mesh(mesh)
    n, d, kvh = local.num_heads, local.head_dim, local.kv_heads

    @torch.no_grad()
    def prefill(cache, params, x, slot, length):
        slot, length = int(slot), int(length)
        cache.lengths[slot] = length
        first, count = _slot_range(cache, mesh)
        if not first <= slot < first + count:
            return cache, None
        local_slot = slot - first
        bs = cache.block_size
        s_bucket = x.shape[1]
        wb = s_bucket // bs

        def attention_step(q, k, v, cache_state):
            qh, kh, vh = _heads(q, n, d), _heads(k, kvh, d), _heads(v, kvh, d)
            attn = dense_attention(qh, kh, vh, causal=config.causal)
            # this layer's K/V blocks into the slot ([S, kvh, d] token-major,
            # re-tiled to whole blocks)
            _write_kv_blocks(cache_state, kh.transpose(1, 2)[0].reshape(wb, bs, kvh, d),
                             vh.transpose(1, 2)[0].reshape(wb, bs, kvh, d), local_slot)
            return attn.transpose(1, 2).reshape(1, s_bucket, n * d), cache_state

        h = x
        layers, _ = layer_list(params["layers"])
        for i, layer in enumerate(layers):
            h, _ = _serve_block(h, layer, local, attention_step, _layer_planes(cache, i),
                                tp_mesh)
        y = _layernorm(h, params["ln_f"]["scale"], params["ln_f"]["bias"])
        return cache, y[0, length - 1]

    return prefill


def create_prefix(config: ModelConfig, mesh=None, device=None):
    """The empty (start = 0) prefix carry of a chunked prefill: a pair of
    ``[L, 0, kv_heads / tp, head_dim]`` tensors in the model dtype (this
    rank's kv-head shard, JAX's ``prefix_spec``)."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    local = local_config(config, tp)
    shape = (config.num_layers, 0, local.kv_heads, local.head_dim)
    device = resolve_device(device)
    return (torch.zeros(shape, dtype=DTYPES[config.dtype], device=device),
            torch.zeros(shape, dtype=DTYPES[config.dtype], device=device))


def _chunk_attention(qh: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                     start: int) -> torch.Tensor:
    """Offset-causal fp32 attention for one prefill chunk.

    qh: ``[1, n, C, d]`` (the chunk's queries, global positions ``start ..
    start + C``); k_all/v_all: ``[start + C, kvh, d]`` (prefix and chunk
    keys).  ``_cached_attention``'s math (fp32 logits over 1/sqrt(d), fp32
    softmax, the query heads grouped against each kv head, never
    repeated) under the static mask ``j <= start + qi``: a real query
    reaches only real keys, so a final partial chunk's pad rows never
    reach a real output."""
    b, n, c, d = qh.shape
    kvh, s_tot = k_all.shape[1], k_all.shape[0]
    q32 = qh.float().reshape(b, kvh, n // kvh, c, d)
    k32 = k_all.permute(1, 0, 2).float()[None, :, None]      # [1, kvh, 1, S, d]
    v32 = v_all.permute(1, 0, 2).float()[None, :, None]
    logits = torch.matmul(q32, k32.transpose(-1, -2)) / math.sqrt(d)
    pos = torch.arange(s_tot, device=qh.device)
    mask = pos[None, :] <= (start + torch.arange(c, device=qh.device))[:, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs, v32).reshape(b, n, c, d)
    return out.to(k_all.dtype)


def build_prefill_chunk(config: ModelConfig, mesh=None, *, chunk_len: int, start: int):
    """``prefill_chunk(cache, prefix, params, x, slot, length) -> (cache,
    prefix, y_last)``: one chunk ``x [1, chunk_len, H]`` of a chunked
    prefill at global offset ``start`` (a block multiple; JAX builds one
    program per chunk index).

    The chunk's K/V blocks are written into the slot in place at block
    offset ``start / block_size`` (quantised in the int8 layout); attention
    runs over the carried prefix ``[L, start, kvh, d]`` concatenated with
    the chunk, so the cache is never read back.  ``length`` is the true
    prompt length: ``lengths[slot] = min(length, start + chunk_len)`` and
    ``y_last`` is the output at the last real position clipped into this
    chunk (the engine uses the final chunk's).  The returned prefix is the
    carry grown by the chunk, in the model dtype whatever the cache
    layout.  A rank whose dp group does not own ``slot`` records the length
    and returns its prefix unchanged and ``y_last`` None."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    local = local_config(config, tp)
    tp_mesh = _tp_mesh(mesh)
    n, d, kvh = local.num_heads, local.head_dim, local.kv_heads

    @torch.no_grad()
    def prefill_chunk(cache, prefix, params, x, slot, length):
        slot, length = int(slot), int(length)
        cache.lengths[slot] = min(length, start + chunk_len)
        first, count = _slot_range(cache, mesh)
        if not first <= slot < first + count:
            return cache, prefix, None
        local_slot = slot - first
        bs = cache.block_size
        wb, start_blk = chunk_len // bs, start // bs
        pk, pv = prefix
        k_alls, v_alls = [], []

        def attention_step(q, k, v, cache_state):
            i = len(k_alls)
            k_chunk = k[0].reshape(chunk_len, kvh, d)
            v_chunk = v[0].reshape(chunk_len, kvh, d)
            k_all = torch.cat([pk[i], k_chunk])
            v_all = torch.cat([pv[i], v_chunk])
            attn = _chunk_attention(_heads(q, n, d), k_all, v_all, start)
            _write_kv_blocks(cache_state, k_chunk.reshape(wb, bs, kvh, d),
                             v_chunk.reshape(wb, bs, kvh, d), local_slot, start_blk)
            k_alls.append(k_all)
            v_alls.append(v_all)
            return attn.transpose(1, 2).reshape(1, chunk_len, n * d), cache_state

        h = x
        layers, _ = layer_list(params["layers"])
        for i, layer in enumerate(layers):
            h, _ = _serve_block(h, layer, local, attention_step, _layer_planes(cache, i),
                                tp_mesh)
        y = _layernorm(h, params["ln_f"]["scale"], params["ln_f"]["bias"])
        at = min(max(length - 1 - start, 0), chunk_len - 1)
        return cache, (torch.stack(k_alls), torch.stack(v_alls)), y[0, at]

    return prefill_chunk


def build_prefix_attach(config: ModelConfig, mesh=None, *, matched_len: int,
                        block_size: int):
    """``attach(cache, src, dst) -> (cache, prefix)``: the copy-on-attach
    step of the shared-prefix cache (JAX builds one program per matched
    chunk count).  Copies the donor slot ``src``'s first ``matched_len /
    block_size`` blocks of every plane (the scales too, in the int8
    layout) into slot ``dst``, in place; ``src == dst`` is the identity.
    Returns the matched prefix as the chunked prefill's carry ``[L,
    matched_len, kvh, d]``: the cache blocks themselves (what the skipped
    chunks would have carried, bit for bit), dequantised to the model
    dtype in the int8 layout.  ``ServingConfig.validate`` pins prefix
    caching to dp = 1, so both slots are this rank's."""
    nb_m = matched_len // block_size
    tp = 1 if mesh is None else mesh.shape["tp"]
    local = local_config(config, tp)
    kvh, d = local.kv_heads, local.head_dim
    dtype = DTYPES[config.dtype]

    @torch.no_grad()
    def attach(cache, src, dst):
        src, dst = int(src), int(dst)
        nl = cache.k.shape[0]
        donor = {}
        for name in cache._fields[:-1]:
            plane = getattr(cache, name)
            donor[name] = plane[:, src, :nb_m].clone()
            plane[:, dst, :nb_m] = donor[name]
        pk, pv = donor["k"], donor["v"]
        if isinstance(cache, QuantKVCache):
            pk = dequantize_kv_blocks(pk, donor["k_scale"], dtype)
            pv = dequantize_kv_blocks(pv, donor["v_scale"], dtype)
        return cache, (pk.reshape(nl, matched_len, kvh, d), pv.reshape(nl, matched_len, kvh, d))

    return attach


def build_compact_gather():
    """``gather(carry, idx) -> small_carry``: the slots named by ``idx``
    (``[b']`` int64, distinct) repacked into a new, smaller decode carry
    (slot compaction, dp = 1).  The big carry is left as it is: the
    compacted scan's results are scattered back into it."""

    @torch.no_grad()
    def gather(carry, idx):
        cache, x = carry
        return gather_cache_slots(cache, idx), x.index_select(0, idx)

    return gather


def build_compact_scatter():
    """``scatter(carry, small_carry, idx) -> carry``: the compacted rows
    written back into their big-batch slots, the cache in place; ``x`` is
    copied first, as :func:`_inject_token` copies it."""

    @torch.no_grad()
    def scatter(carry, small_carry, idx):
        cache, x = carry
        s_cache, s_x = small_carry
        return scatter_cache_slots(cache, s_cache, idx), x.index_copy(0, idx, s_x)

    return scatter


def _append_rows(plane: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
                 blk: torch.Tensor, off: torch.Tensor, write: torch.Tensor) -> None:
    """``plane[b, blk[b], off[b]] = new[b]`` where ``write[b]``, in place;
    an unwritten row is written back with its own value, bit for bit, so
    the step needs no host read of which slots write."""
    cur = plane[rows, blk, off]
    plane[rows, blk, off] = torch.where(write[:, None, None], new.to(plane.dtype), cur)


def _append_rows_int8(codes: torch.Tensor, scales: torch.Tensor, new: torch.Tensor,
                      rows: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
                      write: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The int8 layout's append: returns what attention reads, the layer
    dequantised to ``dtype`` (the old codes) with each writing slot's exact
    new row in place, as JAX's step reads ``k_flat.astype(x.dtype)``; then
    requantises each writing slot's touched block (its old rows dequantised
    in fp32 and the new row) into ``codes``/``scales`` in place.

    JAX requantises every block of every active slot; a block it did not
    touch comes back with its own codes and scales (each stored value is
    ``q * s`` with ``max |q| = 127``, so its recomputed amax is ``127 s``
    rounded and its scale ``s``), so requantising only the touched block
    gives JAX's planes (held bit for bit in the tests).  Dequantising
    straight to ``dtype`` gives the bits of JAX's fp32 detour and skips an
    fp32 copy of the layer."""
    read = dequantize_kv_blocks(codes, scales, dtype)
    _append_rows(read, new, rows, blk, off, write)
    block = dequantize_kv_blocks(codes[rows, blk], scales[rows, blk], torch.float32)
    block[rows, off] = torch.where(write[:, None, None], new.float(), block[rows, off])
    bq, bscale = quantize_kv_blocks(block)                      # [B, bs, kvh, d], [B, kvh]
    codes[rows, blk] = torch.where(write[:, None, None, None], bq, codes[rows, blk])
    scales[rows, blk] = torch.where(write[:, None], bscale, scales[rows, blk])
    return read


def _decode_step_math(carry, params, active, config: ModelConfig, mesh=None):
    """The decode-step computation (JAX's ``_decode_step_math``, the one
    copy of the math every decode program shares: the per-step programs
    and every trip of the fused ones).  ``carry = (cache, x)``: this rank's
    cache shard (``KVCache`` or ``QuantKVCache``) and its slots' inputs
    ``[B/dp, 1, H]``; ``active`` is the whole ``[max_batch]`` bool mask.
    Returns ``((cache, y), y)`` with ``y [B/dp, 1, H]``; the cache is
    updated in place (module docstring) and ``lengths`` advances by
    ``active`` on every rank."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    local = local_config(config, tp)
    tp_mesh = _tp_mesh(mesh)
    n, d, kvh = local.num_heads, local.head_dim, local.kv_heads
    cache, x = carry
    quantized = isinstance(cache, QuantKVCache)
    first, b_dim = _slot_range(cache, mesh)
    s_max, bs = cache.max_seq, cache.block_size
    lengths = cache.lengths[first:first + b_dim]
    act = active[first:first + b_dim]
    pos = torch.arange(s_max, device=lengths.device)[None, :]
    valid = pos <= lengths[:, None]
    # append at each active slot's own length (JAX's where(pos == length
    # & active), so a slot already at max_seq is not written)
    write = act & (lengths < s_max)
    at = torch.where(write, lengths, torch.zeros_like(lengths)).long()
    rows = torch.arange(b_dim, device=lengths.device)
    blk, off = at // bs, at % bs

    def attention_step(q, k, v, cache_state):
        qh = _heads(q, n, d)                        # [B, n, 1, d]
        k_new = k[:, 0].reshape(b_dim, kvh, d)
        v_new = v[:, 0].reshape(b_dim, kvh, d)
        if quantized:
            k_l, v_l, ks_l, vs_l = cache_state
            k_l = _append_rows_int8(k_l, ks_l, k_new, rows, blk, off, write, x.dtype)
            v_l = _append_rows_int8(v_l, vs_l, v_new, rows, blk, off, write, x.dtype)
        else:
            k_l, v_l = cache_state
            _append_rows(k_l, k_new, rows, blk, off, write)
            _append_rows(v_l, v_new, rows, blk, off, write)
        attn = _cached_attention(qh, k_l.reshape(b_dim, s_max, kvh, d),
                                 v_l.reshape(b_dim, s_max, kvh, d), valid)
        return attn.transpose(1, 2).reshape(b_dim, 1, n * d), cache_state

    h = x
    layers, _ = layer_list(params["layers"])
    for i, layer in enumerate(layers):
        h, _ = _serve_block(h, layer, local, attention_step, _layer_planes(cache, i),
                            tp_mesh)
    y = _layernorm(h, params["ln_f"]["scale"], params["ln_f"]["bias"])
    cache.lengths.add_(active.to(torch.int32))
    return (cache, y), y


def build_decode_step(config: ModelConfig, mesh=None):
    """``decode_step(carry, params, active) -> (carry, y)`` with ``carry =
    (cache, x)``: one step of the continuous-feedback ("off") mode; the
    returned carry's ``x`` is this step's output ``y``, which the engine
    feeds straight back in."""

    @torch.no_grad()
    def decode_step(carry, params, active):
        return _decode_step_math(carry, params, active, config, mesh)

    return decode_step


def build_decode_fused(config: ModelConfig, mesh=None, *, k: int):
    """``decode_fused(carry, params, active, remaining) -> (carry, ys)``:
    ``k`` decode steps in one device-side loop.  ``remaining [max_batch]``
    is each slot's step budget in the unit (``min(k, tokens left)``, 0 for
    an inactive slot): trip ``i`` runs over ``active & (i < remaining)``,
    so a slot that completes mid-scan is inactive for the rest of it and
    its cache stops advancing, as the per-step engine would leave it;
    ``lengths`` ends at ``lengths0 + active * min(k, remaining)``, JAX's
    formula.  The host reads nothing between trips.  ``ys [k, B/dp, 1,
    H]`` stacks every trip's output."""

    @torch.no_grad()
    def decode_fused(carry, params, active, remaining):
        ys = []
        for i in range(k):
            carry, y = _decode_step_math(carry, params, active & (remaining > i), config, mesh)
            ys.append(y)
        return carry, torch.stack(ys)

    return decode_fused


def _inject_token(carry, slot, vec, mesh=None):
    """Place a freshly-prefilled request's first token into the decode
    input buffer, ``x[slot, 0] = vec``, on the rank that holds the slot
    (the carry unchanged elsewhere).  ``x`` is copied first (``[B/dp, 1,
    H]``, one row per slot): the "off" decode step returns its output as
    the next carry's ``x``, and a caller holding that output must not see
    it change."""
    cache, x = carry
    first, count = _slot_range(cache, mesh)
    slot = int(slot)
    if first <= slot < first + count:
        x = x.clone()
        x[slot - first, 0] = vec.to(x.dtype)
    return cache, x


def _inject_token_greedy(carry, slot, vec, table, mesh=None):
    """Token-mode admission inject: quantise the prefill's last output
    through the greedy token table, ``tok = argmax(vec)``, ``x[slot, 0] =
    table[tok]`` on the rank that holds the slot; returns ``(carry,
    tok)``, ``tok`` an int32 scalar tensor (``torch.argmax`` takes the
    first maximum, as ``jnp.argmax``)."""
    tok = torch.argmax(vec).to(torch.int32)
    return _inject_token(carry, slot, table.index_select(0, tok.reshape(1))[0], mesh), tok


def build_decode_token_step(config: ModelConfig, mesh=None):
    """Token-feedback decode step: the per-step decode math followed by
    the greedy token quantisation, ``tok = argmax(y)``, next input
    ``table[tok]``.  Returns ``(carry, tok [B/dp] int32)``: the committed
    token ids of this rank's slots."""

    @torch.no_grad()
    def decode_token_step(carry, params, table, active):
        (cache, y), _ = _decode_step_math(carry, params, active, config, mesh)
        tok = torch.argmax(y[:, 0, :], dim=-1).to(torch.int32)
        x2 = table.index_select(0, tok)[:, None, :].to(y.dtype)
        return (cache, x2), tok

    return decode_token_step


def build_decode_fused_token(config: ModelConfig, mesh=None, *, k: int):
    """The fused ``k``-step loop in the token-feedback mode:
    :func:`build_decode_fused`'s trips with the greedy token quantisation
    between them.  Returns ``(carry, toks [k, B/dp] int32)``."""
    step = build_decode_token_step(config, mesh)

    @torch.no_grad()
    def decode_fused_token(carry, params, table, active, remaining):
        toks = []
        for i in range(k):
            carry, tok = step(carry, params, table, active & (remaining > i))
            toks.append(tok)
        return carry, torch.stack(toks)

    return decode_fused_token


# ---------------------------------------------------------------------------
# speculative and sampled decoding (part 11c)
# ---------------------------------------------------------------------------


def _gather_dp(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This rank's per-slot values (``B/dp`` along ``dim``) as the whole
    batch's, gathered over its dp group (the ranks of its tp column)."""
    if mesh is None or mesh.shape["dp"] == 1:
        return t
    return all_gather_along(t, dim, mesh.axis_groups["dp"])


def _inject_token_sampled(carry, slot, tok, table, mesh=None):
    """Sampled-mode admission inject: the host drew the first token from
    the prefill's softmax, so the device only embeds the committed id,
    ``x[slot, 0] = table[tok]``, on the rank that holds the slot."""
    return _inject_token(carry, slot, table[int(tok)], mesh)


def _verify_math(carry, params, table, draft_ids, active, config: ModelConfig, mesh=None):
    """The verify unit's target forward, shared by the greedy verify and
    the sampled verify: each slot's pending input and its γ drafts
    (``draft_ids [B/dp, γ]``, embedded through the token table) through
    every block.  Per layer, position ``i`` appends its K/V row at
    ``lengths + i`` for active slots, in place (JAX's one-hot ``pos ==
    lengths + i`` write: a row at or past ``max_seq`` is not written), and
    attends to the keys ``pos <= lengths + i``.  The rows appended past
    what the host later commits stay in the cache past each length, dead
    because attention is masked by length.  Returns ``y [B/dp, γ+1, H]``;
    ``lengths`` is not changed.

    Every position runs the decode step's own calls, one position at a
    time: its ln1, qkv, out, ln2 and ffn products on a contiguous ``[B/dp,
    1, H]`` input, its attention in the step's ``[B, kvh, grp, d]`` shape
    (:func:`_attend`).  So where the drafts are the step's tokens, row
    ``i`` of ``y`` is step ``i``'s output bit for bit: a batched ``[B, γ+1,
    H]`` pass adds the attention's products in another order on a GPU, and
    a greedy argmax at a near-tie then moves.  The fp32 copies of a
    layer's K and V are made once, after its γ+1 appends, and shared by the
    positions (the upcast is exact, and each position's mask drops the
    rows after it)."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    local = local_config(config, tp)
    col, row = _projections(local, _tp_mesh(mesh))
    n, d, kvh = local.num_heads, local.head_dim, local.kv_heads
    cache, x = carry
    first, b_dim = _slot_range(cache, mesh)
    s_max, bs = cache.max_seq, cache.block_size
    g1 = draft_ids.shape[1] + 1
    lengths = cache.lengths[first:first + b_dim]
    act = active[first:first + b_dim]
    dev = lengths.device
    hs = [x] + [table.index_select(0, draft_ids[:, j].long())[:, None, :].to(x.dtype)
                for j in range(g1 - 1)]                          # γ+1 x [B, 1, H]
    pos = torch.arange(s_max, device=dev)[None, :]
    rows = torch.arange(b_dim, device=dev)
    steps = []
    for i in range(g1):
        off_i = lengths + i
        write = act & (off_i < s_max)
        at = torch.where(write, off_i, torch.zeros_like(lengths)).long()
        steps.append((pos <= off_i[:, None], at // bs, at % bs, write))

    layers, _ = layer_list(params["layers"])
    for i, layer in enumerate(layers):
        k_l, v_l = _layer_planes(cache, i)
        heads = [_block_head(h, layer, local, col) for h in hs]
        for (q, k, v), (_valid, blk, off, write) in zip(heads, steps):
            _append_rows(k_l, k[:, 0].reshape(b_dim, kvh, d), rows, blk, off, write)
            _append_rows(v_l, v[:, 0].reshape(b_dim, kvh, d), rows, blk, off, write)
        k32, v32 = _kv32(k_l.reshape(b_dim, s_max, kvh, d), v_l.reshape(b_dim, s_max, kvh, d))
        hs = [_block_tail(h, _attend(_heads(q, n, d), k32, v32, valid, x.dtype)
                          .transpose(1, 2).reshape(b_dim, 1, n * d), layer, col, row)
              for h, (q, _k, _v), (valid, *_w) in zip(hs, heads, steps)]
    return torch.cat([_layernorm(h, params["ln_f"]["scale"], params["ln_f"]["bias"])
                      for h in hs], dim=1)


def build_verify_step(config: ModelConfig, mesh=None, *, gamma: int):
    """``verify_step(carry, params, table, draft_ids, active, remaining) ->
    (carry, tok, commits)``: the greedy draft-and-verify unit, one batched
    target forward (:func:`_verify_math`) for the γ drafts of every slot.

    ``tok = argmax(y)`` is the target's token at every position; the
    accepted length is the run of leading draft/target matches and
    ``commits = min(accepted + 1, remaining)`` for an active slot, 0
    otherwise (the +1 is the verify's own token at the first mismatch).
    ``lengths`` advances by ``commits`` and ``x'`` is the last committed
    token's embedding, so the carry protocol is the decode step's.  ``tok
    [B, γ+1]`` and ``commits [B]`` come back whole on every rank, gathered
    over the dp group: each rank's scheduler reads them, and ``lengths`` is
    whole."""

    @torch.no_grad()
    def verify_step(carry, params, table, draft_ids, active, remaining):
        cache, x = carry
        first, b_dim = _slot_range(cache, mesh)
        y = _verify_math(carry, params, table, draft_ids, active, config, mesh)
        act = active[first:first + b_dim]
        tok = torch.argmax(y, dim=-1).to(torch.int32)              # [B/dp, γ+1]
        match = (tok[:, :gamma] == draft_ids).to(torch.int32)
        accepted = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        rem = remaining[first:first + b_dim].to(torch.int32)
        commits = torch.where(act, torch.minimum(accepted + 1, rem),
                              torch.zeros_like(accepted)).to(torch.int32)
        last = tok.gather(1, (commits - 1).clamp(min=0).long()[:, None])[:, 0]
        x_new = table.index_select(0, last)[:, None, :].to(x.dtype)
        x_f = torch.where(act[:, None, None], x_new, x)
        tok, commits = _gather_dp(tok, mesh), _gather_dp(commits, mesh)
        cache.lengths.add_(commits)
        return (cache, x_f), tok, commits

    return verify_step


def build_verify_probs(config: ModelConfig, mesh=None, *, gamma: int):
    """``verify_probs(carry, params, table, draft_ids, active) -> (carry,
    y)``: the sampled verify's device half, :func:`build_verify_step`'s
    forward returning the raw logits ``y [B/dp, γ+1, H]`` and committing
    nothing: ``lengths`` and ``x`` come back unchanged, so a second call on
    the returned carry writes the same rows and gives the same ``y``.
    ``gamma`` 0 is a plain decode step that commits nothing, the sampled
    path's unit while the drafter is cold."""

    @torch.no_grad()
    def verify_probs(carry, params, table, draft_ids, active):
        if draft_ids.shape[1] != gamma:
            raise ValueError(f"draft_ids carry {draft_ids.shape[1]} drafts, not {gamma}")
        return carry, _verify_math(carry, params, table, draft_ids, active, config, mesh)

    return verify_probs


def build_spec_commit(config: ModelConfig, mesh=None):
    """``spec_commit(carry, table, next_ids, commits, active) -> carry``: the
    sampled verify's commit half.  The host decided each slot's ``commits``
    and its last committed token ``next_ids`` (both whole ``[max_batch]``):
    ``lengths`` advances by the commits and an active slot's ``x`` becomes
    ``table[next_ids]``, the carry protocol the greedy verify applies on the
    device."""

    @torch.no_grad()
    def spec_commit(carry, table, next_ids, commits, active):
        cache, x = carry
        first, b_dim = _slot_range(cache, mesh)
        cache.lengths.add_(commits.to(torch.int32))
        emb = table.index_select(0, next_ids[first:first + b_dim].long())[:, None, :]
        return cache, torch.where(active[first:first + b_dim, None, None], emb.to(x.dtype), x)

    return spec_commit


def build_draft_scan(config: ModelConfig, mesh=None, *, gamma: int):
    """``draft_scan(cache, params, table, x, lengths, active) -> (cache,
    draft_ids [B/dp, γ])``: γ greedy token-feedback decode steps of the
    shallow draft model over its own cache.  ``x`` is the target's carry
    input (the draft shares its hidden size and token table); ``lengths``
    (whole) are the host's committed lengths and overwrite the cache's own,
    which is the draft plane's rollback after a rejection: rows past them
    are dead by the length mask."""

    @torch.no_grad()
    def draft_scan(cache, params, table, x, lengths, active):
        cache.lengths.copy_(lengths)
        toks = []
        for _ in range(gamma):
            (cache, y), _ = _decode_step_math((cache, x), params, active, config, mesh)
            tok = torch.argmax(y[:, 0, :], dim=-1).to(torch.int32)
            x = table.index_select(0, tok)[:, None, :].to(y.dtype)
            toks.append(tok)
        return cache, torch.stack(toks, dim=1)

    return draft_scan


def _ngram_propose(hist: list, gamma: int, max_ngram: int = 3) -> Optional[list]:
    """Prompt-lookup / n-gram drafting (Saxena 2023), JAX's host helper: the
    most recent earlier occurrence of the history's trailing n-gram (n from
    ``max_ngram`` down to 1) proposes the γ ids that followed it; a match
    ``d < γ`` positions back extends cyclically through that period.  A pure
    function of ``hist`` (the prompt's token ids and every committed
    token); None when even the last token never occurred before (cold)."""
    ln = len(hist)
    for n in range(min(max_ngram, ln - 1), 0, -1):
        key = hist[ln - n:]
        for start in range(ln - n - 1, -1, -1):
            if hist[start:start + n] == key:
                cont = list(hist[start + n:start + n + gamma])
                if len(cont) < gamma:
                    d = len(cont)  # == distance back to the match
                    cont += [cont[i % d] for i in range(d, gamma)]
                return cont
    return None


def softmax_np(logits: np.ndarray, temperature: float) -> np.ndarray:
    """Host-side temperature softmax (float64, max-subtracted): the sampled
    path's target law ``p``.  The device never softmaxes: every probability
    the sampler draws from is computed here, from the raw logits."""
    z = np.asarray(logits, np.float64) / float(temperature)
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def residual_distribution(p_target: np.ndarray, q_draft: np.ndarray) -> np.ndarray:
    """Speculative sampling's rejection distribution (Leviathan et al.
    2023), ``norm(max(p - q, 0))``; ``p`` itself when ``q`` dominates it
    everywhere (rejection then has probability zero)."""
    resid = np.maximum(np.asarray(p_target, np.float64) - np.asarray(q_draft, np.float64), 0.0)
    z = resid.sum()
    if z <= 0.0:
        return np.asarray(p_target, np.float64)
    return resid / z


def speculative_sample(p_target: np.ndarray, q_draft: np.ndarray, draft_id: int,
                       rng: np.random.Generator) -> tuple[int, bool]:
    """One position of the residual-sampling correction: accept the draft
    with probability ``min(1, p/q)``, else draw from
    :func:`residual_distribution`.  The composite law is exactly ``p``, so
    sampled speculative decode is distribution-identical to the sequential
    sampler.  The engine calls it with ``q`` the deterministic drafter's
    one-hot, so acceptance is ``p[draft]`` and the residual is ``p`` with
    the draft's mass removed."""
    p = float(p_target[draft_id])
    q = float(q_draft[draft_id])
    accept_p = 1.0 if q <= 0.0 and p > 0.0 else (min(1.0, p / q) if q > 0.0 else 0.0)
    if rng.uniform() < accept_p:
        return int(draft_id), True
    resid = residual_distribution(p_target, q_draft)
    return int(rng.choice(len(resid), p=resid)), False


class _WatchdogThread:
    """The thread the watchdog runs its calls on, one call at a time, kept
    from unit to unit: a fresh thread per unit (JAX's ``_with_deadline``
    starts one per call) sets up torch's per-thread state anew each time,
    which cost the 1B's decode step 4.0 ms on an H100.  An abandoned thread
    ends after the call it is stuck in; the next call starts another."""

    def __init__(self) -> None:
        self._jobs: Optional[queue.SimpleQueue] = None

    def submit(self, fn, cancel: threading.Event) -> tuple[dict, threading.Event]:
        if self._jobs is None:
            self._jobs = queue.SimpleQueue()
            threading.Thread(target=_watchdog_loop, args=(self._jobs,), daemon=True,
                             name="dlbb-serve-watchdog").start()
        box: dict[str, Any] = {}
        done = threading.Event()
        self._jobs.put((fn, cancel, box, done))
        return box, done

    def close(self) -> None:
        """Let the thread end once its current call (if any) returns."""
        if self._jobs is not None:
            self._jobs.put(None)
            self._jobs = None


def _watchdog_loop(jobs: queue.SimpleQueue) -> None:
    while (job := jobs.get()) is not None:
        fn, cancel, box, done = job
        try:
            box["value"] = fn(cancel)
        except BaseException as e:  # noqa: BLE001 — marshalled to the caller
            box["error"] = e
        finally:
            done.set()


def _with_deadline(fn, deadline: Optional[float], label: str, phase: str,
                   thread: _WatchdogThread, agree=None) -> Any:
    """Run ``fn(cancel)`` under the serving dispatch watchdog (JAX's
    ``_with_deadline``, ``dlbb_tpu/serve/engine.py:1783``).

    With no deadline this is a direct call, ``fn(None)``: no thread, no
    event, no sync.  With one, ``fn`` runs on ``thread`` and is waited for
    ``deadline`` seconds.  ``agree(overran) -> bool`` turns this rank's
    verdict into the mesh's (rank 0's, broadcast); a rank whose own call is
    still running waits for it when the verdict is "in time".  On an
    overrun the thread is abandoned (it cannot be killed) and
    :class:`DeadlineExceeded` raised; ``cancel``, a ``threading.Event``,
    is set first.  ``fn`` checks it before it launches anything, so a
    thread that wakes after its deadline (an injected hang) launches no
    kernel and issues no collective: the engine's cache is updated in
    place and its process group is in use again by then.  A thread that
    overran inside its program runs to its end on the arguments it holds."""
    if deadline is None:
        return fn(None)
    cancel = threading.Event()
    box, done = thread.submit(fn, cancel)
    overran = not done.wait(deadline)
    if agree is not None:
        overran = agree(overran)
    if overran:
        cancel.set()
        thread.close()
        raise DeadlineExceeded(label, deadline, phase=phase)
    done.wait()
    if "error" in box:
        raise box["error"]
    return box["value"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclass
class _SlotState:
    req: Request
    tokens_done: int = 0
    # adaptive speculation: this request's verify γ (a ladder bucket) and
    # its acceptance-rate EMA (-1: no verify observed yet)
    gamma_eff: int = 0
    accept_ema: float = -1.0


@dataclass
class _RunStats:
    ttft_s: list[float] = field(default_factory=list)
    per_token_s: list[float] = field(default_factory=list)
    prefill_s: list[float] = field(default_factory=list)
    decode_step_s: list[float] = field(default_factory=list)
    e2e_latency_s: list[float] = field(default_factory=list)
    completed_output_tokens: int = 0
    generated_tokens: int = 0
    decode_steps: int = 0           # every fused trip counts once
    decode_units: int = 0           # host dispatches (single steps + scans)
    single_steps: int = 0
    fused_scans: int = 0
    fused_steps: int = 0
    compacted_scans: int = 0
    prefill_chunks: int = 0
    prefix_hits: int = 0            # admissions that attached to the trie
    prefix_tokens_reused: int = 0   # prompt tokens served from shared blocks
    prefix_cow_blocks: int = 0      # blocks recomputed privately (CoW)
    spec_verify_units: int = 0      # draft-and-verify dispatches
    spec_fallback_units: int = 0    # cold-drafter fallbacks
    spec_proposed_tokens: int = 0   # γ per resident slot per verify
    spec_accepted_tokens: int = 0   # drafts the target verify accepted
    spec_commit_tokens: int = 0     # committed, the bonus token included
    spec_slot_verifies: int = 0     # slot-level verifies (for the mean length)
    spec_draft_s: float = 0.0       # host drafting and draft-scan wall
    # resilience (part 11d)
    retries: int = 0
    hung_dispatches: int = 0
    failed_requests: int = 0
    preempted_requests: int = 0
    deadline_shed: int = 0
    completed_past_deadline: int = 0


class ServingEngine:
    """Trace-driven continuous-batching engine (see module docstring).

    One engine serves many traces: each :meth:`run_trace` starts from a
    fresh cache.  The journal (``resilience.journal.SweepJournal``) and
    metrics registry are optional.

    ``mesh`` is a ``(dp, tp)`` mesh of ``comm.mesh.build_parallelism_mesh``
    (None: one device, no process group); every rank of it builds the
    engine and calls :meth:`run_trace` with the same trace.  ``params``
    are this rank's tp shards (``models/sharding.py``), or None for
    ``init_params`` from ``seed``; ``draft_params`` likewise the draft
    model's under ``speculation="draft-model"`` (None: ``init_params`` of
    ``serving.draft_model_config`` from ``seed + 1``, as JAX derives its
    draft from ``seed + 1``).  ``device`` is ``cuda`` unless the caller
    names ``cpu``.  After a run, ``draft_cache_stats`` holds the draft
    model's ledger's ``stats()`` (None without a draft model): JAX's report
    does not carry that ledger."""

    def __init__(
        self,
        config: ModelConfig,
        serving: ServingConfig,
        mesh: Any = None,
        params: Any = None,
        journal: Any = None,
        registry: Optional[MetricsRegistry] = None,
        seed: int = 0,
        verbose: bool = True,
        capture_tokens: bool = False,
        device=None,
        draft_params: Any = None,
    ) -> None:
        if mesh is not None and set(mesh.axis_names) != {"dp", "tp"}:
            raise ValueError(f"the serving engine runs on a (dp, tp) mesh, not axes "
                             f"{mesh.axis_names}")
        self.dp = 1 if mesh is None else mesh.shape["dp"]
        self.tp = 1 if mesh is None else mesh.shape["tp"]
        serving.validate(config, dp=self.dp, tp=self.tp)
        self.config = config
        self.serving = serving
        self.mesh = mesh
        self.device = resolve_device(device)
        if serving.spec_drafting and self.device.type == "cuda":
            warnings.warn(
                f"speculation={serving.speculation!r} is slower than greedy decoding on the "
                "card: the verify runs each of its gamma+1 positions in the decode step's own "
                "calls (its rows are the step's bits), and each position reads the layer's "
                "fp32 K/V copy again, until a decode-attention kernel reads the cache once "
                "for all of them (ROADMAP.md, Queue 2's measured gaps)", RuntimeWarning,
                stacklevel=2)
        self.verbose = verbose
        # the equivalence gate: argmax "token ids" of every generated
        # output recorded per request (syncs each unit — leave off for
        # perf runs)
        self.capture_tokens = capture_tokens
        # public and reassignable: tests swap it between run_trace calls
        self.journal = journal
        self.registry = registry if registry is not None else MetricsRegistry()
        self._requests = self.registry.labeled_counter(
            "serve_requests", "outcome",
            initial=("arrived", "admitted", "rejected", "completed",
                     "failed", "preempted", "canceled"),
            help="request lifecycle outcomes",
        )
        self._rejections = self.registry.labeled_counter(
            "serve_rejections", "reason",
            initial=("queue-full", "infeasible", "deadline"),
            help="requests shed, by rejection reason",
        )
        self._retry_counter = self.registry.labeled_counter(
            "serve_request_retries", "phase",
            initial=("prefill", "decode", "bookkeeping"),
            help="transient dispatch/bookkeeping retries, by phase",
        )
        self._deadline_counter = self.registry.labeled_counter(
            "serve_deadline_exceeded", "reason",
            initial=("shed-queued", "completed-late"),
            help="per-request SLO deadline misses, by how they surfaced",
        )
        for name, hlp in (
            ("serve_decode_steps",
             "decode steps executed (each fused-scan trip counts once)"),
            ("serve_fused_scan_steps",
             "decode steps executed inside fused lax.scan dispatches"),
            ("serve_prefill_chunks", "prefill chunks processed"),
            ("serve_hung_dispatches",
             "decode units abandoned by the dispatch watchdog"),
        ):
            self.registry.inc(name, 0, help=hlp)
        self._quantized = serving.kv_quantization == "int8"
        if serving.prefix_caching:
            for name, hlp in (
                ("serve_prefix_hits",
                 "admissions that attached to shared prefix blocks"),
                ("serve_prefix_tokens_reused",
                 "prompt tokens served from shared blocks (prefill "
                 "skipped)"),
            ):
                self.registry.inc(name, 0, help=hlp)
        self._dtype = DTYPES[config.dtype]
        tp_rank = 0 if mesh is None else mesh.coords["tp"]
        if params is None:
            params = init_params(config, seed, self.device, tp_rank=tp_rank, tp=self.tp)
        self.params = params
        self._prefill = build_prefill(config, mesh)
        self._decode = build_decode_step(config, mesh)
        self._fused_ks = serving.fused_horizons
        self._decode_fused = {k: build_decode_fused(config, mesh, k=k) for k in self._fused_ks}
        # built on first use, one per chunk index and per matched chunk count
        self._chunk_programs: dict[int, Any] = {}
        self._attach_programs: dict[int, Any] = {}
        self._compact_gather = self._compact_scatter = None
        if serving.compact_threshold is not None:
            self._compact_gather = build_compact_gather()
            self._compact_scatter = build_compact_scatter()
        self._fast = (serving.decode_horizon > 1
                      or serving.inflight_window > 1
                      or serving.prefill_chunk is not None
                      or serving.compact_threshold is not None)
        # token-feedback ("greedy") quantises decode through the greedy
        # token table, whole on every rank
        self._token_mode = serving.speculation != "off"
        # non-adaptive runs verify at spec_gamma alone; adaptive ones back
        # off through the whole ladder
        self._spec_gammas: tuple[int, ...] = (
            serving.spec_gammas if serving.spec_adaptive
            else ((serving.spec_gamma,) if serving.spec_drafting else ()))
        self._table: Optional[torch.Tensor] = None
        self._verify: dict[int, Any] = {}
        self._draft_config: Optional[ModelConfig] = None
        self._draft_params: Any = None
        self._draft_prefill = None
        self._draft_scan: dict[int, Any] = {}
        if self._token_mode:
            self._table = token_embedding_table(config.hidden_size, self._dtype,
                                                device=self.device)
            self._decode_token = build_decode_token_step(config, mesh)
            self._decode_fused_token = {k: build_decode_fused_token(config, mesh, k=k)
                                        for k in self._fused_ks}
        # sampled decode (temperature > 0): the verify returns its logits
        # and the host samples; a cold n-gram drafter runs the γ = 0
        # verify, so a sampled run never dispatches a greedy program
        self._sampled = serving.temperature > 0
        self._verify_probs: dict[int, Any] = {}
        self._spec_commit = None
        if self._sampled:
            probs_gammas = set(self._spec_gammas)
            if serving.speculation == "ngram":
                probs_gammas.add(0)
            self._verify_probs = {g: build_verify_probs(config, mesh, gamma=g)
                                  for g in sorted(probs_gammas)}
            self._spec_commit = build_spec_commit(config, mesh)
            self.registry.inc(
                "serve_sampled_tokens", 0,
                help="tokens committed by the sampled (temperature > 0) "
                     "residual-sampling path")
        if serving.spec_drafting:
            self._verify = {g: build_verify_step(config, mesh, gamma=g)
                            for g in self._spec_gammas}
            self._spec_proposed = self.registry.labeled_counter(
                "serve_spec_proposed_total", "drafter", initial=("ngram", "draft-model"),
                help="draft tokens proposed to the verify step, by drafter")
            self._spec_accepted = self.registry.labeled_counter(
                "serve_spec_accepted_total", "drafter", initial=("ngram", "draft-model"),
                help="draft tokens the target verify accepted, by drafter")
        if serving.speculation == "draft-model":
            self._draft_config = serving.draft_model_config(config)
            if draft_params is None:
                draft_params = init_params(self._draft_config, seed + 1, self.device,
                                           tp_rank=tp_rank, tp=self.tp)
            self._draft_params = draft_params
            self._draft_prefill = build_prefill(self._draft_config, mesh)
            self._draft_scan = {g: build_draft_scan(self._draft_config, mesh, gamma=g)
                                for g in self._spec_gammas}
        self.draft_cache_stats: Optional[dict[str, int]] = None
        # the fleet replica control plane of the current run (run_trace's
        # ``control``); None outside a fleet
        self._control: Any = None
        self._t0 = time.perf_counter()

    # -- clock (monotonic, run-relative) -----------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _from_rank0(self, *values: float):
        """Rank 0's ``values``, broadcast to every rank of the mesh (one
        value back for one value, else a tuple): the scheduler's time-derived
        decisions and its verdicts (its clock and the drain flag once per
        iteration, the scan horizon's steps to the next arrival, the
        watchdog's overrun, a late completion) are rank 0's, so every rank
        takes the same ones."""
        if self.mesh is not None:
            dev = self.device if dist.get_backend(self.mesh.group) == "nccl" else "cpu"
            t = torch.tensor(values, dtype=torch.float64, device=dev)
            dist.broadcast(t, src=self.mesh.global_rank(0), group=self.mesh.group)
            values = tuple(t.tolist())
        return values[0] if len(values) == 1 else values

    def _agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (the watchdog's verdict)."""
        return bool(self._from_rank0(float(flag)))

    # -- device helpers ----------------------------------------------------

    def _sync(self) -> None:
        """Wait for this rank's device work (JAX's ``block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _from_owner(self, y_last: Optional[torch.Tensor], slot: int) -> torch.Tensor:
        """The prefill's ``y_last`` on every rank: broadcast over this
        rank's dp group (the ranks of its tp column) from the dp rank that
        owns ``slot``."""
        if self.dp == 1:
            return y_last
        owner_dp = slot // (self.serving.max_batch // self.dp)
        src = self.mesh.global_rank(owner_dp * self.tp + self.mesh.coords["tp"])
        if y_last is None:
            y_last = torch.empty(self.config.hidden_size, dtype=self._dtype,
                                 device=self.device)
        else:
            y_last = y_last.contiguous()
        dist.broadcast(y_last, src=src, group=self.mesh.axis_groups["dp"])
        return y_last

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the device, from a copy of it taken now: the
        caller may change ``host`` while decode units that read the upload
        are still in flight.  On CUDA the copy is pinned and the upload
        does not wait for the device (the caching host allocator keeps each
        pinned copy until its upload has run), so it never drains the
        in-flight window."""
        t = torch.from_numpy(host.copy())
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _record(self) -> Optional[torch.cuda.Event]:
        """An event after the work enqueued so far (None on the CPU, where
        it has already run)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    # -- setup -------------------------------------------------------------

    def _fresh_carry(self):
        """A zero cache shard (this rank's slots and kv heads, ``lengths``
        whole; the int8 layout under ``kv_quantization="int8"``) and zero
        decode inputs ``[B/dp, 1, H]``."""
        cfg = self.serving
        b_local = cfg.max_batch // self.dp
        create = create_quant_kv_cache if self._quantized else create_kv_cache
        cache = create(local_config(self.config, self.tp), b_local,
                       cfg.num_blocks, cfg.block_size, device=self.device)
        cache = cache._replace(lengths=torch.zeros((cfg.max_batch,), dtype=torch.int32,
                                                   device=self.device))
        x = torch.zeros((b_local, 1, self.config.hidden_size), dtype=self._dtype,
                        device=self.device)
        return (cache, x)

    def _fresh_draft_cache(self) -> Optional[KVCache]:
        """The draft model's own zero cache shard (the target's slot and
        block geometry at the draft's layers and kv heads; ``lengths``
        whole), None without a draft model."""
        if self._draft_config is None:
            return None
        cfg = self.serving
        cache = create_kv_cache(local_config(self._draft_config, self.tp),
                                cfg.max_batch // self.dp, cfg.num_blocks, cfg.block_size,
                                device=self.device)
        return cache._replace(lengths=torch.zeros((cfg.max_batch,), dtype=torch.int32,
                                                  device=self.device))

    def capture_device_traces(self, trace_root: Any) -> list[dict]:
        """JAX's serving capture (``obs/capture.py``): one dedicated prefill
        and one decode scan (fused where the fast path is on, at its
        smallest horizon), each on fresh state, strictly outside every
        timed region; the bench calls this after :meth:`run_trace` has
        returned.  Every rank of the mesh calls it (the programs' tp
        collectives); each returned meta carries its ``phase`` (and the
        decode's ``decode_steps_per_scan``), and a failure is contained in
        the metas as a sweep's is."""
        from dlbb_tpu_torch.obs import capture as obs_capture

        cfg = self.serving
        bucket = cfg.prefill_buckets[0]
        # this rank's first slot, as _compile warms it: every dp rank prefills
        slot = (cfg.max_batch // self.dp) * (0 if self.mesh is None
                                             else self.mesh.coords["dp"])
        kw = dict(group=None if self.mesh is None else self.mesh.group, device=self.device)

        def prefill_payload():
            x = request_embeddings(0, bucket, self.config.hidden_size, dtype=self._dtype,
                                   pad_to=bucket, device=self.device)
            return self._fresh_carry()[0], x

        def prefill_fn(t):
            return self._prefill(t[0], self.params, t[1], slot, bucket)

        metas = [obs_capture.capture_device_trace(
            prefill_fn, prefill_payload, trace_root, label=f"serve_prefill_b{bucket}", **kw)]
        metas[0]["phase"] = "prefill"

        def decode_payload():
            return (self._fresh_carry(),
                    torch.zeros((cfg.max_batch,), dtype=torch.bool, device=self.device),
                    torch.zeros((cfg.max_batch,), dtype=torch.int32, device=self.device))

        fused_k = min(self._fused_ks) if self._fast and self._fused_ks else None
        if fused_k is not None:
            if self._token_mode:
                def decode_fn(t):
                    return self._decode_fused_token[fused_k](t[0], self.params, self._table,
                                                             t[1], t[2])
            else:
                def decode_fn(t):
                    return self._decode_fused[fused_k](t[0], self.params, t[1], t[2])
            label = (f"serve_decode_fused_token_k{fused_k}" if self._token_mode
                     else f"serve_decode_fused_k{fused_k}")
        else:
            if self._token_mode:
                def decode_fn(t):
                    return self._decode_token(t[0], self.params, self._table, t[1])
            else:
                def decode_fn(t):
                    return self._decode(t[0], self.params, t[1])
            label = "serve_decode_token_step" if self._token_mode else "serve_decode_step"
        meta = obs_capture.capture_device_trace(decode_fn, decode_payload, trace_root,
                                                label=label, **kw)
        meta["phase"] = "decode"
        # token steps per captured dispatch: device time is normalised per
        # step, never per dispatch
        meta["decode_steps_per_scan"] = fused_k or 1
        metas.append(meta)
        return metas

    def _infeasible_reason(self, r: Request) -> Optional[str]:
        """Why the envelope can never serve ``r`` (None = feasible)."""
        max_bucket = self.serving.prefill_buckets[-1]
        if r.output_len < 1:
            return f"output_len must be >= 1 (got {r.output_len})"
        if r.prompt_len < 1 or r.prompt_len > max_bucket:
            return (f"prompt_len={r.prompt_len} outside (0, {max_bucket}] "
                    "(largest prefill bucket)")
        if r.total_tokens > self.serving.max_seq:
            return (f"prompt+output={r.total_tokens} exceeds "
                    f"serving.max_seq={self.serving.max_seq} "
                    "(per-slot cache capacity)")
        need = max(1, math.ceil(r.total_tokens / self.serving.block_size))
        if need > self.serving.total_blocks:
            return (f"needs {need} cache blocks, budget is "
                    f"{self.serving.total_blocks} (serving.blocks_budget)")
        return None

    def _validate_trace(self, trace: TrafficTrace) -> None:
        """Fail BEFORE the run on any request the config cannot serve —
        an infeasible request rejected mid-trace would read as load.
        (``serving.reject_infeasible`` flips this into per-request
        runtime rejection, journaled with reason="infeasible".)"""
        for r in trace:
            reason = self._infeasible_reason(r)
            if reason is not None:
                raise ValueError(f"request {r.rid}: {reason}")

    def _chunk_program(self, chunk_index: int):
        """The chunked-prefill program at offset ``chunk_index *
        prefill_chunk`` (JAX's per-offset jit; built on first use)."""
        program = self._chunk_programs.get(chunk_index)
        if program is None:
            chunk = self.serving.prefill_chunk
            program = build_prefill_chunk(self.config, self.mesh, chunk_len=chunk,
                                          start=chunk_index * chunk)
            self._chunk_programs[chunk_index] = program
        return program

    def _attach_program(self, m_chunks: int):
        """The prefix-attach program for ``m_chunks`` matched chunks (JAX's
        per-count jit; built on first use)."""
        program = self._attach_programs.get(m_chunks)
        if program is None:
            program = build_prefix_attach(self.config, self.mesh,
                                          matched_len=m_chunks * self.serving.prefill_chunk,
                                          block_size=self.serving.block_size)
            self._attach_programs[m_chunks] = program
        return program

    def _compile(self, buckets: list[int], max_chunks: int = 0) -> None:
        """Warm every program the trace will run (prefill per bucket or per
        chunk offset, the attach ladder, the inject, the decode step, the
        fused ladder, compaction, the verify ladder, the sampled verify and
        commit, the draft prefill and scans) once on scratch state, so that CUDA
        and cuBLAS start-up never lands in TTFT.  JAX compiles its jits
        here; eager torch compiles nothing, and the report's
        ``compile_time_s`` holds this warm-up's wall time."""
        carry = self._fresh_carry()
        cfg = self.serving
        slot = (cfg.max_batch // self.dp) * (0 if self.mesh is None
                                             else self.mesh.coords["dp"])
        active = torch.zeros((cfg.max_batch,), dtype=torch.bool, device=self.device)
        remaining = torch.zeros((cfg.max_batch,), dtype=torch.int32, device=self.device)
        y_last = None
        for b in buckets:
            dummy = request_embeddings(0, b, self.config.hidden_size,
                                       dtype=self._dtype, pad_to=b, device=self.device)
            cache, y_last = self._prefill(carry[0], self.params, dummy, slot, b)
            carry = (cache, carry[1])
        if max_chunks:
            chunk = cfg.prefill_chunk
            total = max_chunks * chunk
            dummy = request_embeddings(0, total, self.config.hidden_size,
                                       dtype=self._dtype, pad_to=total, device=self.device)
            prefix = create_prefix(self.config, self.mesh, device=self.device)
            cache = carry[0]
            for ci in range(max_chunks):
                cache, prefix, y_last = self._chunk_program(ci)(
                    cache, prefix, self.params, dummy[:, ci * chunk:(ci + 1) * chunk],
                    slot, total)
            if cfg.prefix_caching:
                # a full prompt keeps at least one chunk to compute, so the
                # ladder stops at max_chunks - 1
                for m in range(1, max_chunks):
                    cache, _prefix = self._attach_program(m)(cache, slot, slot)
            carry = (cache, carry[1])
        b_local = cfg.max_batch // self.dp
        if self._sampled:
            # the sampled run's whole decode surface: verify_probs and
            # spec_commit (never a greedy token program)
            carry = _inject_token_sampled(carry, slot, 0, self._table, self.mesh)
            for g in sorted(self._verify_probs):
                ids = torch.zeros((b_local, g), dtype=torch.int32, device=self.device)
                carry, _y = self._verify_probs[g](carry, self.params, self._table, ids, active)
            carry = self._spec_commit(carry, self._table, remaining, remaining, active)
        elif self._token_mode:
            carry, _tok = _inject_token_greedy(carry, slot, y_last, self._table, self.mesh)
            carry, _tok = self._decode_token(carry, self.params, self._table, active)
            for k in self._fused_ks:
                carry, _toks = self._decode_fused_token[k](carry, self.params, self._table,
                                                           active, remaining)
            for g in self._spec_gammas:
                ids = torch.zeros((b_local, g), dtype=torch.int32, device=self.device)
                carry, _tok, _commits = self._verify[g](carry, self.params, self._table, ids,
                                                        active, remaining)
        else:
            carry = _inject_token(carry, slot, y_last, self.mesh)
            carry, _y = self._decode(carry, self.params, active)
            for k in self._fused_ks:
                carry, _ys = self._decode_fused[k](carry, self.params, active, remaining)
        if self._compact_gather is not None:
            bucket = cfg.max_batch // 2
            idx = torch.arange(bucket, device=self.device)
            small = self._compact_gather(carry, idx)
            for k in self._fused_ks:
                small, _ys = self._decode_fused[k](small, self.params, active[:bucket],
                                                   remaining[:bucket])
            carry = self._compact_scatter(carry, small, idx)
        if self._draft_config is not None:
            dcache = self._fresh_draft_cache()
            for b in buckets:
                dummy = request_embeddings(0, b, self.config.hidden_size,
                                           dtype=self._dtype, pad_to=b, device=self.device)
                dcache, _dy = self._draft_prefill(dcache, self._draft_params, dummy, slot, b)
            for g in self._spec_gammas:
                dcache, _ids = self._draft_scan[g](dcache, self._draft_params, self._table,
                                                   carry[1], remaining, active)
        self._sync()

    def _event(self, event: str, rid: int, **extra: Any) -> None:
        if self.journal is not None:
            self.journal.event(event, config=f"request-{rid}", **extra)
        ctl = self._control
        if ctl is not None and getattr(ctl, "on_event", None) is not None:
            # the lifecycle feed to the fleet supervisor (terminal
            # accounting, the hedge winner); a sink failure never takes the
            # replica down: the journal line above is already written
            try:
                ctl.on_event(rid, event, dict(extra))
            except Exception:  # noqa: BLE001 — contained by contract
                pass

    # -- the run -----------------------------------------------------------

    def run_trace(self, trace: TrafficTrace, guard: Optional[PreemptionGuard] = None,
                  collect_raw: bool = False, feed: Any = None,
                  control: Any = None) -> dict[str, Any]:
        """Serve ``trace`` to completion, or to a graceful preemption drain;
        returns the report dict (JAX's keys, ``docs/serving.md``).  Pure
        compute + host scheduling: ``serve/bench.py`` writes the artifacts.

        ``guard``: an installed :class:`PreemptionGuard` (the bench harness
        passes its own); None installs one for the run where it can (the
        main thread).  On SIGTERM (rank 0's, on a mesh) the engine stops
        admission, drains the in-flight window, journals the resident
        requests ``request-preempted`` and returns a report with
        ``preempted=True`` and ``remaining_rids``.  ``collect_raw`` adds the
        raw latency sample lists (``raw_samples``; always on a preempted
        report, for the resume's merge).

        ``feed``/``control`` are the fleet replica hooks (``serve/fleet.py``):
        ``feed`` replaces the static arrivals with a supervisor-fed
        :class:`~dlbb_tpu_torch.serve.fleet.RequestFeed` (``trace`` still
        plans the compiles and the feasibility), and ``control`` is the
        replica control plane (heartbeat, the kill and hang sites, hedge
        cancels, the degradation knobs and the fleet's shared clock
        origin), consulted only at the scheduler loop's boundary.  On a
        mesh every rank passes its own feed and control, which the
        replica's rank 0 keeps equal on every rank."""
        watchdog = _WatchdogThread()
        try:
            if guard is None:
                with PreemptionGuard() as own:
                    return self._serve_trace(trace, own, collect_raw, watchdog, feed, control)
            return self._serve_trace(trace, guard, collect_raw, watchdog, feed, control)
        finally:
            watchdog.close()

    def _serve_trace(self, trace: TrafficTrace, guard: PreemptionGuard,
                     collect_raw: bool, watchdog: _WatchdogThread, feed: Any = None,
                     control: Any = None) -> dict[str, Any]:
        self._control = control
        if not len(trace):
            raise ValueError("cannot serve an empty trace")
        cfg = self.serving
        if cfg.reject_infeasible:
            feasible = [r for r in trace
                        if self._infeasible_reason(r) is None]
            if not feasible:
                raise ValueError(
                    "every request in the trace is infeasible for this "
                    "serving envelope — nothing to serve"
                )
        else:
            self._validate_trace(trace)
            feasible = list(trace)
        if cfg.prefill_chunk is not None:
            buckets: list[int] = []
            max_chunks = max(-(-r.prompt_len // cfg.prefill_chunk) for r in feasible)
        else:
            buckets = sorted({cfg.bucket_for(r.prompt_len) for r in feasible})
            max_chunks = 0
        with Timer() as t_compile:
            self._compile(buckets, max_chunks)
        compile_time = t_compile.elapsed

        ledger = BlockLedger(cfg.total_blocks, cfg.block_size,
                             prefix_caching=cfg.prefix_caching)
        # registry counters are cumulative across an engine's lifetime
        # (Prometheus semantics); the report carries THIS run's deltas
        counts_base = {k: self._requests[k] for k in self._requests}
        shed_base = self._rejections["queue-full"]
        # a fleet supervisor feeds the arrivals (and failovers at the feed's
        # head); a standalone run serves the static trace in arrival order
        pending = (feed if feed is not None
                   else deque(sorted(trace, key=lambda r: (r.arrival_s, r.rid))))
        queue: deque[Request] = deque()
        slots: dict[int, _SlotState] = {}
        free_slots = list(range(cfg.max_batch))
        stats = _RunStats()
        series: dict[str, list] = {
            "t_s": [], "queue_depth": [], "active_slots": [],
            "blocks_in_use": [], "blocks_reserved": [],
        }
        if cfg.prefix_caching:
            series["shared_blocks"] = []
        carry = self._fresh_carry()
        active_np = np.zeros((cfg.max_batch,), bool)
        active_dev = self._upload(active_np)
        rejected_detail: list[dict[str, Any]] = []
        tokens_by_rid: dict[int, list[int]] = {}
        token_mode = self._token_mode
        spec_on = cfg.spec_drafting
        # per-rid token history (the prompt's ids and every committed
        # token): the n-gram drafter's lookup context, whole on every rank
        hist: dict[int, list[int]] = {}
        # the sampled path's host generator, JAX's: a (trace, config) pair
        # replays token for token, and every rank draws the same numbers
        sample_rng = np.random.default_rng(cfg.sample_seed) if self._sampled else None
        # the draft model's cache, and a ledger that mirrors the target's
        draft_cache: list[Optional[KVCache]] = [self._fresh_draft_cache()]
        draft_ledger = (BlockLedger(cfg.total_blocks, cfg.block_size)
                        if draft_cache[0] is not None else None)
        # run-level acceptance EMA (the serve_spec_acceptance_ema gauge)
        accept_ema_run = [-1.0]
        # this rank's slots
        first_slot = (cfg.max_batch // self.dp) * (0 if self.mesh is None
                                                   else self.mesh.coords["dp"])
        local_slots = slice(first_slot, first_slot + cfg.max_batch // self.dp)
        # per-request final outcome map (rid -> "completed" /
        # "rejected[reason]" / "failed[reason]" / "preempted")
        outcomes: dict[int, str] = {}
        # permanent-failure records: the exception chains, never a silent
        # skip
        failed_detail: list[dict[str, Any]] = []
        # the in-flight window: decode units dispatched and not yet synced
        # (a k = 1 unit is synced at once); last_sync anchors each unit's
        # interval, so back-to-back units never count device time twice
        inflight: deque[dict[str, Any]] = deque()
        last_sync = [0.0]
        # EMA of the per-step interval: the scan horizon turns "next arrival
        # in X seconds" into a step budget with it, and the watchdog scales
        # its deadline by it
        step_ema = [0.0]
        # bumped by every carry replacement (a hung or failed unit): a
        # chunked prefill interleaved with the failed unit restarts, and a
        # prefix-attach plan from before one degrades to a full prefill
        carry_resets = [0]
        # host-side active_np mutations are staged; the device mask is
        # re-uploaded lazily, and always before a decode dispatch (a decode
        # interleaved into a chunked prefill must see slots admitted
        # earlier in the same admission loop)
        active_dirty = [False]
        agree = self._agree if self.mesh is not None else None

        def refresh_active() -> None:
            nonlocal active_dev
            if active_dirty[0]:
                active_dev = self._upload(active_np)
                active_dirty[0] = False

        def release(slot: int) -> _SlotState:
            """Free a completed slot's blocks + slot so the next admission
            can reuse them (device order is safe: the unit that completed
            it already masked it inactive)."""
            st = slots.pop(slot)
            ledger.free(slot)
            if draft_ledger is not None:
                draft_ledger.free(slot)
            active_np[slot] = False
            active_dirty[0] = True
            free_slots.append(slot)
            free_slots.sort()
            return st

        def finish(st: _SlotState, done_at: float) -> None:
            """Completion stats + journal at the unit's sync point."""
            lat = done_at - st.req.arrival_s
            stats.e2e_latency_s.append(lat)
            stats.completed_output_tokens += st.req.output_len
            self._requests["completed"] += 1
            outcomes[st.req.rid] = "completed"
            extra: dict[str, Any] = {}
            # served past its SLO: counted, not rejected (rank 0's verdict,
            # whose clock the ranks' completion times differ from)
            if st.req.deadline_s is not None \
                    and self._from_rank0(float(lat > st.req.deadline_s)):
                stats.completed_past_deadline += 1
                self._deadline_counter["completed-late"] += 1
                extra["past_deadline"] = True
            if self.capture_tokens:
                extra["tokens"] = [int(t) for t in
                                   tokens_by_rid.get(st.req.rid, [])]
            self._event("request-completed", st.req.rid,
                        output_tokens=st.req.output_len,
                        latency_s=round(lat, 6), **extra)

        def take_snapshot() -> dict[str, Any]:
            """The pre-dispatch rollback point: the ledgers, the resident
            slots and their token counts, the free slots, the host mask and
            the generated count (host copies).  The device carry needs none:
            every fault site fires before a program launches, or after it in
            host bookkeeping."""
            return {"ledger": ledger.snapshot(),
                    "draft_ledger": (draft_ledger.snapshot()
                                     if draft_ledger is not None else None),
                    "slots": {s: (st, st.tokens_done) for s, st in slots.items()},
                    "free_slots": list(free_slots),
                    "active": active_np.copy(),
                    "generated": stats.generated_tokens}

        def restore_snapshot(snap: dict[str, Any]) -> None:
            ledger.restore(snap["ledger"])
            if draft_ledger is not None:
                draft_ledger.restore(snap["draft_ledger"])
            slots.clear()
            for s, (st, done) in snap["slots"].items():
                st.tokens_done = done
                slots[s] = st
            free_slots[:] = snap["free_slots"]
            active_np[:] = snap["active"]
            active_dirty[0] = True
            stats.generated_tokens = snap["generated"]

        def fail_requests(states: list[_SlotState], exc: BaseException,
                          reason: str) -> None:
            """Fail requests closed: journaled ``request-failed`` with the
            exception chain, outcome recorded, counters bumped."""
            rec = exception_chain(exc)
            rids = []
            for st in states:
                rids.append(st.req.rid)
                outcomes[st.req.rid] = f"failed[{reason}]"
                stats.failed_requests += 1
                self._requests["failed"] += 1
                self._event("request-failed", st.req.rid, reason=reason,
                            error=rec["error"], tokens_done=st.tokens_done)
            failed_detail.append({"reason": reason, "rids": rids, **rec})

        def fail_resident(exc: BaseException, reason: str) -> None:
            """Fail every resident request (a decode unit covers the whole
            resident batch), freeing their slots and blocks."""
            fail_requests([release(s) for s in sorted(list(slots))], exc, reason)

        def reset_carry() -> None:
            """Continue on a fresh carry (and draft cache) after a unit that
            hung or failed: its in-place writes may be half done.  The old
            cache's last references go first, so the card never holds two
            caches."""
            nonlocal carry
            carry = None
            draft_cache[0] = None
            carry = self._fresh_carry()
            draft_cache[0] = self._fresh_draft_cache()
            carry_resets[0] += 1

        def unit_deadline(k: int) -> Optional[float]:
            """The watchdog's deadline for a k-step unit: EMA-scaled, with a
            floor while the EMA is cold; None = watchdog off."""
            f = cfg.dispatch_deadline_factor
            if f is None:
                return None
            return max(cfg.dispatch_deadline_min_s, f * k * step_ema[0])

        def abandon_window(first_unit: dict[str, Any], exc: BaseException) -> None:
            """A unit's sync blew its deadline: every unit still in flight
            chains off the same carry, so the window is abandoned (its events
            and uploads released, never waited on), its requests fail
            closed, completions never confirmed at a sync point among them,
            and the engine continues on a fresh carry."""
            stats.hung_dispatches += 1
            self.registry.inc("serve_hung_dispatches")
            hung = [first_unit] + list(inflight)
            inflight.clear()
            last_sync[0] = time.perf_counter()
            unconfirmed = [st for u in hung for st in u["completions"]]
            fail_requests(unconfirmed, exc, "hung-dispatch")
            fail_resident(exc, "hung-dispatch")
            reset_carry()

        def sync_one() -> None:
            """Wait for the oldest unit in flight (under the watchdog, when
            armed), then its timing, token capture and completions."""
            unit = inflight.popleft()
            if unit["ready"] is not None:
                try:
                    _with_deadline(lambda _cancel: unit["ready"].synchronize(),
                                   unit_deadline(unit["k"]), f"decode[k={unit['k']}]",
                                   "serve-sync", watchdog, agree)
                except DeadlineExceeded as e:
                    abandon_window(unit, e)
                    return
            t_ready = time.perf_counter()
            dt = t_ready - max(unit["t0"], last_sync[0])
            last_sync[0] = t_ready
            stats.decode_step_s.append(dt)
            per_step = dt / unit["k"]
            step_ema[0] = (per_step if step_ema[0] == 0.0
                           else 0.5 * step_ema[0] + 0.5 * per_step)
            for _row, _slot, _rid, steps in unit["rows"]:
                stats.per_token_s.extend([per_step] * steps)
            done_at = self._now()
            ngram_hist = token_mode and cfg.speculation == "ngram"
            if self.capture_tokens or ngram_hist:
                # the device argmax: one int per slot and step comes to host;
                # a token-mode unit's ys are the token ids, which extend the
                # n-gram histories even when capture is off
                ys = unit["ys"]
                toks = ys if token_mode else torch.argmax(ys[..., 0, :], dim=-1)
                if toks.dim() == 1:          # a per-step unit: [B]
                    toks = toks[None]
                toks_np = _gather_dp(toks.to(torch.int32), self.mesh, 1).cpu().numpy()
                for row, _slot, rid, steps in unit["rows"]:
                    ids = [int(t) for t in toks_np[:steps, row]]
                    if ngram_hist and rid in hist:
                        hist[rid].extend(ids)
                    if self.capture_tokens:
                        tokens_by_rid.setdefault(rid, []).extend(ids)
            # finish AFTER the unit's token capture: the completion event
            # carries the request's full committed token list
            for st in unit["completions"]:
                finish(st, done_at)

        def drain() -> None:
            while inflight:
                sync_one()

        def watched(deadline: Optional[float], label: str):
            """``dispatch(fn)``: ``fn()`` (a program call that reads the
            carry when called) under the watchdog, behind the injected hang
            site, which sleeps on the watchdog's thread.  A thread abandoned
            in its hang returns without calling ``fn``."""
            # the watchdog's thread starts on device 0: it takes this rank's
            cuda_index = (torch.cuda.current_device()
                          if deadline is not None and self.device.type == "cuda" else None)

            def dispatch(fn):
                def run(cancel):
                    if cuda_index is not None:
                        torch.cuda.set_device(cuda_index)
                    if inject.fire("serve-decode-hang"):
                        time.sleep(inject.param("hang_seconds"))
                    if cancel is not None and cancel.is_set():
                        return None
                    return fn()
                return _with_deadline(run, deadline, label, "serve-dispatch", watchdog, agree)
            return dispatch

        def bookkeeping_retry(attempt: int, e: BaseException, unit: str) -> int:
            """One more pass of a unit's torn bookkeeping, or the end of
            its retries; returns the attempt number."""
            if attempt >= cfg.max_dispatch_retries:
                raise RuntimeError(f"ledger/slot bookkeeping kept failing after the "
                                   f"{unit} unit completed on device") from e
            attempt += 1
            stats.retries += 1
            self._retry_counter["bookkeeping"] += 1
            if self.journal is not None:
                self.journal.event("dispatch-retry", phase="bookkeeping",
                                   attempt=attempt, error=str(e))
            time.sleep(cfg.retry_backoff_s * (2 ** (attempt - 1)))
            return attempt

        def decode_unit(k: int, steps: dict[int, int], compact: bool,
                        snap: dict[str, Any]) -> None:
            """One decode unit, committed: the dispatch (under the watchdog
            when armed), the torn-protected host bookkeeping at its exit
            (the ledger's known lengths make every step's outcome known at
            dispatch time), and the in-flight window's push and boundary
            sync.  A torn bookkeeping pass restores ``snap`` and replays
            from the device result in hand, never a re-dispatch; every other
            fault raises out to ``dispatch_decode`` with nothing committed."""
            nonlocal carry
            t0 = time.perf_counter()
            dispatch = watched(unit_deadline(k), f"decode[k={k}]")
            # ONE span per dispatched unit, covering the dispatch and the
            # boundary sync below
            span_args: dict[str, Any] = dict(active=len(slots), steps=k)
            if compact:
                span_args["compacted"] = True
            with spans.span("serve-decode", **span_args):
                if inject.fire("serve-decode-fail"):
                    # before any launch: a retry re-dispatches from the
                    # unchanged carry
                    raise TransientFault("injected serve-decode-fail at the decode "
                                         "dispatch boundary")
                if k == 1:
                    if token_mode:
                        carry, ys = dispatch(lambda: self._decode_token(
                            carry, self.params, self._table, active_dev))
                    else:
                        carry, ys = dispatch(lambda: self._decode(carry, self.params,
                                                                  active_dev))
                    stats.single_steps += 1
                    rows = [(s, s, slots[s].req.rid, 1) for s in sorted(steps)]
                elif compact:
                    # the active slots padded with distinct free slots to
                    # the half-size batch
                    bucket = cfg.max_batch // 2
                    act = sorted(slots)
                    idx = self._upload(np.asarray(act + free_slots[:bucket - len(act)],
                                                  np.int64))
                    s_act_np = np.zeros((bucket,), bool)
                    s_act_np[:len(act)] = True
                    s_rem_np = np.zeros((bucket,), np.int32)
                    for i, s in enumerate(act):
                        s_rem_np[i] = steps[s]
                    s_act, s_rem = self._upload(s_act_np), self._upload(s_rem_np)

                    def compact_unit():
                        small = self._compact_gather(carry, idx)
                        small, ys = self._decode_fused[k](small, self.params, s_act, s_rem)
                        return self._compact_scatter(carry, small, idx), ys

                    carry, ys = dispatch(compact_unit)
                    stats.fused_scans += 1
                    stats.fused_steps += k
                    stats.compacted_scans += 1
                    self.registry.inc("serve_fused_scan_steps", k)
                    rows = [(i, s, slots[s].req.rid, steps[s]) for i, s in enumerate(act)]
                else:
                    rem_np = np.zeros((cfg.max_batch,), np.int32)
                    for s, m in steps.items():
                        rem_np[s] = m
                    rem_dev = self._upload(rem_np)
                    if token_mode:
                        carry, ys = dispatch(lambda: self._decode_fused_token[k](
                            carry, self.params, self._table, active_dev, rem_dev))
                    else:
                        carry, ys = dispatch(lambda: self._decode_fused[k](
                            carry, self.params, active_dev, rem_dev))
                    stats.fused_scans += 1
                    stats.fused_steps += k
                    self.registry.inc("serve_fused_scan_steps", k)
                    rows = [(s, s, slots[s].req.rid, steps[s]) for s in sorted(steps)]
                ready = self._record()
                book_attempt = 0
                while True:
                    completions: list[int] = []
                    try:
                        for s, m in sorted(steps.items()):
                            st = slots[s]
                            st.tokens_done += m
                            if inject.fire("serve-cache-torn"):
                                raise TransientFault("injected serve-cache-torn: ledger/"
                                                     "slot bookkeeping torn mid-unit")
                            ledger.append(s, m)
                            if draft_ledger is not None:
                                draft_ledger.append(s, m)
                            stats.generated_tokens += m
                            if st.tokens_done >= st.req.output_len:
                                completions.append(s)
                        break
                    except (TransientFault, CorruptStats) as e:
                        restore_snapshot(snap)
                        book_attempt = bookkeeping_retry(book_attempt, e, "decode")
                stats.decode_steps += k
                stats.decode_units += 1
                self.registry.inc("serve_decode_steps", k)
                done_states = [release(s) for s in completions]
                if completions:
                    refresh_active()
                inflight.append({"t0": t0, "ys": ys, "k": k, "rows": rows,
                                 "completions": done_states, "ready": ready})
                # a k = 1 unit never stays in flight (JAX: its y may alias
                # the donated carry); a fused unit's stacked ys may
                window = 1 if k == 1 else cfg.inflight_window
                while len(inflight) >= window:
                    sync_one()

        def spec_unit(g: int, drafts_np: np.ndarray, snap: dict[str, Any]) -> None:
            """One draft-and-verify unit over the whole resident batch: the
            draft (the n-gram drafts are in ``drafts_np``, whole; the draft
            model's scan runs here), one batched verify, a synchronous read
            of the commits, and the bookkeeping.  It never rides the
            in-flight window: its accounting depends on the device's
            acceptance.  The bookkeeping is JAX's optimistic-then-rollback:
            every slot is first accounted its whole γ+1 window, and a
            shortfall restores ``snap`` and replays the true commits.  The
            fault sites and the watchdog are the decode unit's."""
            nonlocal carry
            refresh_active()
            rows = [(s, slots[s].req.rid) for s in sorted(slots)]
            rem_map = {s: slots[s].req.output_len - slots[s].tokens_done for s, _ in rows}
            deadline = unit_deadline(g + 1)
            label = f"verify[gamma={g}]"
            dispatch = watched(deadline, label)

            def synced(fn):
                return _with_deadline(lambda _cancel: fn(), deadline, label, "serve-sync",
                                      watchdog, agree)

            t0 = time.perf_counter()
            with spans.span("serve-verify", active=len(slots), gamma=g,
                            drafter=cfg.speculation):
                if inject.fire("serve-decode-fail"):
                    raise TransientFault("injected serve-decode-fail at the verify "
                                         "dispatch boundary")
                rem_np = np.zeros((cfg.max_batch,), np.int32)
                for s, _ in rows:
                    rem_np[s] = rem_map[s]
                if cfg.speculation == "draft-model":
                    # the host's committed lengths overwrite the draft
                    # cache's own (advanced by γ last unit): its rollback
                    lengths_np = np.zeros((cfg.max_batch,), np.int32)
                    for s, _ in rows:
                        st = slots[s]
                        lengths_np[s] = st.req.prompt_len + st.tokens_done - 1
                    dlen = self._upload(lengths_np)
                    t_d = time.perf_counter()
                    draft_cache[0], ids = dispatch(lambda: self._draft_scan[g](
                        draft_cache[0], self._draft_params, self._table, carry[1],
                        dlen, active_dev))
                    # host dispatch wall only: the drafts stay on the device
                    stats.spec_draft_s += time.perf_counter() - t_d
                else:
                    ids = self._upload(drafts_np[local_slots])
                committed_ids: Optional[dict[int, list[int]]] = None
                tok = None
                if self._sampled:
                    # the verify commits nothing; the host samples over the
                    # logits of every slot (gathered over dp, so every rank
                    # draws the same numbers in JAX's slot order), and
                    # spec_commit applies the decided commits
                    carry, y = dispatch(lambda: self._verify_probs[g](
                        carry, self.params, self._table, ids, active_dev))
                    y_np = synced(lambda: _gather_dp(y, self.mesh).float().cpu().numpy())
                    ids_np = (_gather_dp(ids, self.mesh).cpu().numpy()
                              if cfg.speculation == "draft-model" else drafts_np)
                    vocab = y_np.shape[-1]
                    commits_np = np.zeros((cfg.max_batch,), np.int32)
                    next_np = np.zeros((cfg.max_batch,), np.int32)
                    committed_ids = {}
                    for s, _rid in rows:
                        p_rows = softmax_np(y_np[s], cfg.temperature)
                        toks: list[int] = []
                        for j in range(g):
                            d_id = int(ids_np[s, j])
                            q = np.zeros((vocab,), np.float64)
                            q[d_id] = 1.0
                            t, ok = speculative_sample(p_rows[j], q, d_id, sample_rng)
                            toks.append(t)
                            if not ok:
                                break
                        else:
                            # every draft accepted: the window's bonus token
                            # is a draw from the last position's law
                            toks.append(int(sample_rng.choice(vocab, p=p_rows[g])))
                        m = min(len(toks), rem_map[s])
                        commits_np[s] = m
                        next_np[s] = toks[m - 1]
                        committed_ids[s] = toks[:m]
                    next_dev, com_dev = self._upload(next_np), self._upload(commits_np)
                    carry = dispatch(lambda: self._spec_commit(
                        carry, self._table, next_dev, com_dev, active_dev))
                    self.registry.inc("serve_sampled_tokens", int(commits_np.sum()))
                else:
                    rem_dev = self._upload(rem_np)
                    carry, tok, commits = dispatch(lambda: self._verify[g](
                        carry, self.params, self._table, ids, active_dev, rem_dev))
                    commits_np = synced(lambda: commits.cpu().numpy())
                t_ready = time.perf_counter()
                dt = t_ready - max(t0, last_sync[0])
                last_sync[0] = t_ready
                # torn-protected bookkeeping (the decode unit's replay): the
                # device result is in hand, so a replay is host recomputation
                book_attempt = 0
                while True:
                    completions: list[int] = []
                    try:
                        for s, _rid in rows:
                            st = slots[s]
                            opt = min(g + 1, rem_map[s])
                            st.tokens_done += opt
                            ledger.append(s, opt)
                            if draft_ledger is not None:
                                draft_ledger.append(s, opt)
                            stats.generated_tokens += opt
                        if inject.fire("serve-cache-torn"):
                            raise TransientFault("injected serve-cache-torn: ledger/slot "
                                                 "bookkeeping torn mid-verify")
                        if any(int(commits_np[s]) != min(g + 1, rem_map[s]) for s, _ in rows):
                            # rejection rollback: the true commits replayed
                            restore_snapshot(snap)
                            for s, _rid in rows:
                                st = slots[s]
                                m = int(commits_np[s])
                                st.tokens_done += m
                                ledger.append(s, m)
                                if draft_ledger is not None:
                                    draft_ledger.append(s, m)
                                stats.generated_tokens += m
                        completions = [s for s, _ in rows
                                       if slots[s].tokens_done >= slots[s].req.output_len]
                        break
                    except (TransientFault, CorruptStats) as e:
                        restore_snapshot(snap)
                        book_attempt = bookkeeping_retry(book_attempt, e, "verify")
                stats.decode_steps += 1
                stats.decode_units += 1
                stats.spec_verify_units += 1
                self.registry.inc("serve_decode_steps", 1)
                stats.decode_step_s.append(dt)
                step_ema[0] = dt if step_ema[0] == 0.0 else 0.5 * step_ema[0] + 0.5 * dt
                drafter = cfg.speculation
                ladder = self._spec_gammas
                unit_acc = 0
                tok_np = (tok.cpu().numpy()
                          if tok is not None and (drafter == "ngram" or self.capture_tokens)
                          else None)
                for s, rid in rows:
                    m = int(commits_np[s])
                    acc = max(m - 1, 0)
                    unit_acc += acc
                    stats.spec_slot_verifies += 1
                    stats.spec_proposed_tokens += g
                    stats.spec_accepted_tokens += acc
                    stats.spec_commit_tokens += m
                    self._spec_proposed[drafter] += g
                    self._spec_accepted[drafter] += acc
                    stats.per_token_s.extend([dt / m] * m)
                    self._event("spec-verify", rid, gamma=g, accepted=acc, committed=m)
                    st = slots[s]
                    if cfg.spec_adaptive:
                        rate = acc / g if g else 0.0
                        st.accept_ema = (rate if st.accept_ema < 0
                                         else 0.5 * st.accept_ema + 0.5 * rate)
                        pos = (ladder.index(st.gamma_eff) if st.gamma_eff in ladder
                               else len(ladder) - 1)
                        if st.accept_ema < 0.25 and pos > 0:
                            st.gamma_eff = ladder[pos - 1]
                        elif st.accept_ema > 0.75 and pos < len(ladder) - 1:
                            st.gamma_eff = ladder[pos + 1]
                    if tok_np is not None or committed_ids is not None:
                        ids_host = (committed_ids[s] if committed_ids is not None
                                    else [int(t) for t in tok_np[s, :m]])
                        if drafter == "ngram" and rid in hist:
                            hist[rid].extend(ids_host)
                        if self.capture_tokens:
                            tokens_by_rid.setdefault(rid, []).extend(ids_host)
                unit_rate = unit_acc / (g * len(rows)) if (rows and g) else 0.0
                accept_ema_run[0] = (unit_rate if accept_ema_run[0] < 0
                                     else 0.5 * accept_ema_run[0] + 0.5 * unit_rate)
                self.registry.set_gauge("serve_spec_acceptance_ema", accept_ema_run[0],
                                        help="EMA of per-verify-unit draft acceptance rate")
                done_states = [release(s) for s in completions]
                if completions:
                    refresh_active()
                done_at = self._now()
                for st in done_states:
                    finish(st, done_at)

        def recover(unit, snap: dict[str, Any]) -> None:
            """Run ``unit()`` (one decode or verify unit) with JAX's
            recovery ladder: a transient fault, raised before any launch or
            in the host bookkeeping, restores ``snap`` and re-issues the unit
            with exponential backoff, and past ``max_dispatch_retries`` fails
            the resident batch closed; a watchdog overrun settles the valid
            in-flight tail and fails the resident batch as
            ``hung-dispatch``; any other exception fails it closed too.  The
            last two continue on a fresh carry."""
            attempt = 0
            while True:
                try:
                    unit()
                    return
                except (TransientFault, CorruptStats) as e:
                    restore_snapshot(snap)
                    if attempt >= cfg.max_dispatch_retries:
                        fail_resident(e, "dispatch-failed")
                        return
                    attempt += 1
                    stats.retries += 1
                    self._retry_counter["decode"] += 1
                    if self.journal is not None:
                        self.journal.event("dispatch-retry", phase="decode",
                                           attempt=attempt, error=str(e))
                    time.sleep(cfg.retry_backoff_s * (2 ** (attempt - 1)))
                except DeadlineExceeded as e:
                    restore_snapshot(snap)
                    stats.hung_dispatches += 1
                    self.registry.inc("serve_hung_dispatches")
                    drain()
                    fail_resident(e, "hung-dispatch")
                    reset_carry()
                    return
                except Exception as e:  # noqa: BLE001 — fail closed
                    restore_snapshot(snap)
                    try:
                        drain()
                    except Exception:  # noqa: BLE001
                        inflight.clear()
                    fail_resident(e, "dispatch-failed")
                    reset_carry()
                    return

        def dispatch_spec() -> bool:
            """One draft-and-verify unit over the resident batch, with the
            decode unit's recovery ladder; False when the n-gram drafter is
            cold (no hit for any resident slot, read from the whole
            histories), and the caller then runs a plain token decode unit,
            so speculation composes with ``decode_horizon`` and the window.
            A sampled run's cold unit is the γ = 0 verify instead: one
            sampled token per slot."""
            # the histories and the bookkeeping must be current before
            # drafting: a fallback's fused units may still be in flight
            drain()
            if not slots:
                return True
            ladder = self._spec_gammas
            g_want = (max(st.gamma_eff for st in slots.values()) if cfg.spec_adaptive
                      else cfg.spec_gamma)
            g = ladder[0]
            for cand in ladder:
                if cand <= g_want:
                    g = cand
            drafts_np = np.zeros((cfg.max_batch, g), np.int32)
            if cfg.speculation == "ngram":
                t_d = time.perf_counter()
                any_hit = False
                for s in sorted(slots):
                    prop = _ngram_propose(hist.get(slots[s].req.rid, []), g)
                    if prop is not None:
                        drafts_np[s] = prop
                        any_hit = True
                stats.spec_draft_s += time.perf_counter() - t_d
                if not any_hit:
                    stats.spec_fallback_units += 1
                    if not self._sampled:
                        return False
                    g = 0
                    drafts_np = np.zeros((cfg.max_batch, 0), np.int32)
            snap = take_snapshot()
            recover(lambda: spec_unit(g, drafts_np, snap), snap)
            return True

        def steps_to_arrival() -> int:
            """The decode steps until the next arrival, from the per-step
            EMA (1 before the first sample: one unit bootstraps it)."""
            if step_ema[0] > 0.0:
                gap = pending[0].arrival_s - self._now()
                return max(1, int(gap / step_ema[0])) if gap > 0 else 1
            return 1

        def dispatch_decode(max_k: Optional[int] = None) -> None:
            """One decode unit over the resident batch: a single step, or,
            when no scheduling event needs an earlier boundary, a fused
            k-step scan (the largest power of two <= the event horizon),
            on a compacted half batch when few slots are resident.
            ``max_k`` caps the horizon (the chunked-prefill interleave
            passes 1).  With a drafter, a draft-and-verify unit comes first,
            but not in the interleave (a verify's window would block the
            admission the interleave serves); a cold n-gram drafter falls
            through to the plain token unit.  Either runs under
            :func:`recover`."""
            refresh_active()
            if spec_on and max_k is None and (control is None or control.spec_enabled):
                if dispatch_spec():
                    return
                refresh_active()
            rem = {s: slots[s].req.output_len - slots[s].tokens_done
                   for s in sorted(slots)}
            # next event: the earliest completion while anything is (or may
            # soon be) waiting for a slot; a quiescent batch fuses through
            # its full drain
            horizon = (min(rem.values()) if (queue or pending)
                       else max(rem.values()))
            horizon = min(cfg.decode_horizon, horizon)
            if control is not None and control.horizon_cap is not None:
                # the degradation ladder (serve/fleet.py): a shorter horizon
                # trades fused-scan throughput for scheduling latency under
                # overload, never silently (each step is journaled)
                horizon = min(horizon, max(1, control.horizon_cap))
            if pending and horizon > 1:
                # a known arrival is an event too: rank 0's estimate of the
                # steps until it
                horizon = min(horizon, int(self._from_rank0(steps_to_arrival())))
            if max_k is not None:
                horizon = min(horizon, max_k)
            k = 1
            for cand in self._fused_ks:
                if cand <= horizon:
                    k = cand
            steps = {s: min(k, r) for s, r in rem.items()}
            compact = (self._compact_gather is not None and k > 1
                       and len(slots) <= cfg.compact_threshold * cfg.max_batch
                       and len(slots) <= cfg.max_batch // 2)
            snap = take_snapshot()
            recover(lambda: decode_unit(k, steps, compact, snap), snap)

        def attach_plan(req: Request) -> dict[str, Any]:
            """The host-side prefix match of one admission: the prompt's
            full-block token-id chain, the trie's longest match and the
            attach point, floored to whole chunks (the suffix prefill
            resumes at a chunk offset) and leaving at least one chunk to
            compute (the final chunk owns ``y_last`` and the slot length);
            matched blocks past it are recomputed privately, the
            copy-on-write tail."""
            bs = cfg.block_size
            chunk = cfg.prefill_chunk
            full_blocks = req.prompt_len // bs
            plan: dict[str, Any] = {
                "chain": [], "attach_blocks": 0, "attach_tokens": 0, "donor": None,
                "cow_blocks": 0, "resets": carry_resets[0], "attached_tokens": 0}
            if full_blocks == 0:
                return plan
            ids = prompt_token_ids(req.seed, req.prompt_len, self.config.hidden_size,
                                   prefix_len=req.prefix_len, prefix_seed=req.prefix_seed)
            chain = [tuple(ids[i * bs:(i + 1) * bs]) for i in range(full_blocks)]
            plan["chain"] = chain
            depth, donor = ledger.match_prefix(chain)
            cap = ((req.prompt_len - 1) // chunk) * chunk
            attach_tokens = min(depth * bs, cap) // chunk * chunk
            if donor is None or attach_tokens <= 0:
                return plan
            plan.update(attach_blocks=attach_tokens // bs, attach_tokens=attach_tokens,
                        donor=donor, cow_blocks=depth - attach_tokens // bs)
            return plan

        def prefill_once(req: Request, slot: int, plan: Optional[dict[str, Any]] = None):
            """The prefill of one admitted request, chunked or monolithic —
            returns ``(bucket, y_last, dt)``; ``y_last`` is the owner's, on
            every rank.  With a prefix-attach ``plan`` the matched chunks
            are replaced by one copy of the donor's blocks and only the
            suffix chunks run; a carry reset since planning degrades it to
            the full prefill.  Raised through by :func:`prefill_dispatch`'s
            retries, and idempotent on a retry (the writes are the same
            values into the same blocks)."""
            nonlocal carry
            if inject.fire("serve-prefill-fail"):
                # before any launch, as serve-decode-fail
                raise TransientFault("injected serve-prefill-fail at the prefill "
                                     "dispatch boundary")
            if cfg.prefill_chunk is None:
                bucket = cfg.bucket_for(req.prompt_len)
                x_prompt = request_embeddings(
                    req.seed, req.prompt_len, self.config.hidden_size,
                    dtype=self._dtype, pad_to=bucket, device=self.device,
                )
                with spans.span("serve-prefill", rid=req.rid, bucket=bucket, slot=slot):
                    t0 = time.perf_counter()
                    cache, y_last = self._prefill(carry[0], self.params, x_prompt,
                                                  slot, req.prompt_len)
                    if self._draft_prefill is not None:
                        # the draft cache is prefilled from the same prompt
                        # embeddings, billed as prefill: the draft model's
                        # admission price
                        draft_cache[0], _dy = self._draft_prefill(
                            draft_cache[0], self._draft_params, x_prompt, slot,
                            req.prompt_len)
                    y_last = self._from_owner(y_last, slot)
                    self._sync()
                    dt = time.perf_counter() - t0
                carry = (cache, carry[1])
                return bucket, y_last, dt
            chunk = cfg.prefill_chunk
            n_chunks = -(-req.prompt_len // chunk)
            bucket = n_chunks * chunk
            m_chunks = 0
            if plan is not None and plan["attach_blocks"]:
                plan["attached_tokens"] = 0
                if carry_resets[0] == plan["resets"]:
                    m_chunks = plan["attach_tokens"] // chunk
            x_prompt = request_embeddings(
                req.seed, req.prompt_len, self.config.hidden_size,
                dtype=self._dtype, pad_to=bucket, prefix_len=req.prefix_len,
                prefix_seed=req.prefix_seed, device=self.device,
            )
            with spans.span("serve-prefill", rid=req.rid, bucket=bucket, slot=slot,
                            chunks=n_chunks - m_chunks):
                t0 = time.perf_counter()
                decode_spent = 0.0
                cache = carry[0]
                if m_chunks:
                    with spans.span("serve-prefix-attach", rid=req.rid, slot=slot,
                                    donor=plan["donor"], blocks=plan["attach_blocks"]):
                        cache, prefix = self._attach_program(m_chunks)(cache, plan["donor"],
                                                                       slot)
                    plan["attached_tokens"] = m_chunks * chunk
                else:
                    prefix = create_prefix(self.config, self.mesh, device=self.device)
                for ci in range(m_chunks, n_chunks):
                    with spans.span("serve-prefill-chunk", rid=req.rid, chunk=ci):
                        cache, prefix, y_last = self._chunk_program(ci)(
                            cache, prefix, self.params,
                            x_prompt[:, ci * chunk:(ci + 1) * chunk], slot, req.prompt_len)
                    stats.prefill_chunks += 1
                    self.registry.inc("serve_prefill_chunks")
                    if ci < n_chunks - 1 and slots:
                        # interleave: the resident batch decodes between
                        # chunks instead of waiting behind the whole prompt
                        carry = (cache, carry[1])
                        td = time.perf_counter()
                        resets = carry_resets[0]
                        dispatch_decode(max_k=1)
                        decode_spent += time.perf_counter() - td
                        if carry_resets[0] != resets:
                            # the resident batch failed and took the carry,
                            # with this request's chunks so far: restart the
                            # prefill on the fresh carry (through the retry)
                            raise TransientFault("carry reset during the chunked-prefill "
                                                 "interleave (resident batch failed closed)")
                        cache = carry[0]
                carry = (cache, carry[1])
                y_last = self._from_owner(y_last, slot)
                self._sync()
                # the interleaved units' time is billed to decode_step_s and
                # per_token_s already: prefill_s stays a prefill cost
                dt = time.perf_counter() - t0 - decode_spent
            return bucket, y_last, dt

        def prefill_dispatch(req: Request, slot: int, plan: Optional[dict[str, Any]] = None):
            """:func:`prefill_once` with bounded retries of a transient
            fault (the chunk counter rolled back, so a retried prefill never
            counts twice); exhaustion raises to the admission loop."""
            attempt = 0
            while True:
                chunks_base = stats.prefill_chunks
                try:
                    return prefill_once(req, slot, plan)
                except (TransientFault, CorruptStats) as e:
                    stats.prefill_chunks = chunks_base
                    if attempt >= cfg.max_dispatch_retries:
                        raise
                    attempt += 1
                    stats.retries += 1
                    self._retry_counter["prefill"] += 1
                    if self.journal is not None:
                        self.journal.event("dispatch-retry", phase="prefill", rid=req.rid,
                                           attempt=attempt, error=str(e))
                    time.sleep(cfg.retry_backoff_s * (2 ** (attempt - 1)))

        def cancel_request(rid: int, reason: str) -> None:
            """A supervisor's cancel (``serve/fleet.py``: the losing hedge
            copy).  Resident: the in-flight window settles first, so the
            release happens at a sync point, then the slot's blocks are
            freed.  Queued or not yet fed: the request is dropped.  An
            unknown rid is a benign race (it completed between the cancel
            decision and this boundary) and a no-op: the tokens are the same
            on both replicas."""
            slot = next((s for s, st in slots.items() if st.req.rid == rid), None)
            if slot is not None:
                drain()
                st_now = slots.get(slot)
                if st_now is None or st_now.req.rid != rid:
                    return  # completed (or failed) at the drain's sync
                st = release(slot)
                hist.pop(rid, None)
                outcomes[rid] = f"canceled[{reason}]"
                self._requests["canceled"] += 1
                self._event("request-canceled", rid, reason=reason,
                            tokens_done=st.tokens_done)
                return
            for r in list(queue):
                if r.rid == rid:
                    queue.remove(r)
                    outcomes[rid] = f"canceled[{reason}]"
                    self._requests["canceled"] += 1
                    self._event("request-canceled", rid, reason=reason, tokens_done=0)
                    return
            if feed is not None and feed.discard(rid):
                outcomes[rid] = f"canceled[{reason}]"
                self._requests["canceled"] += 1
                self._event("request-canceled", rid, reason=reason, tokens_done=0)

        def fail_admission(req: Request, slot: int, exc: BaseException) -> None:
            """A prefill that failed for good fails only its request (its
            reservation undone, journaled with the chain); a real (not
            injected) failure may have written the cache in part, so the
            resident batch fails closed too, on a fresh carry."""
            ledger.free(slot)
            if draft_ledger is not None:
                draft_ledger.free(slot)
            free_slots.append(slot)
            free_slots.sort()
            fail_requests([_SlotState(req=req, tokens_done=0)], exc, "dispatch-failed")
            if not isinstance(exc, InjectedFault):
                fail_resident(exc, "dispatch-failed")
                reset_carry()

        # a fleet shares one clock origin across its replicas (the
        # supervisor releases it once every replica has compiled, so no
        # replica's compile time skews arrivals or deadlines); a standalone
        # run starts its own
        self._t0 = (control.sync_start() if control is not None
                    else time.perf_counter())
        last_sync[0] = self._t0
        preempted = False
        while pending or queue or slots:
            if control is not None:
                # the replica control plane (serve/fleet.py), only at the
                # loop's boundary, so a fence never tears a half-applied
                # unit: heartbeat, the injected kill and hang, the
                # supervisor's cancels (losing hedges)
                control.beat()
                control.check()
                for c_rid, c_reason in control.take_cancels():
                    cancel_request(c_rid, c_reason)
            if inject.fire("serve-preempt"):
                # a real SIGTERM to this process, which the guard turns into
                # the drain flag (an inert flag off the main thread)
                if guard.installed:
                    os.kill(os.getpid(), signal.SIGTERM)
                else:
                    guard.request()
            # the scheduler's clock and the drain flag: rank 0's, since a
            # real SIGTERM reaches the ranks at different times
            now, stop = self._from_rank0(self._now(), float(guard.requested))
            if stop:
                # graceful drain: admission stops here; the window settles
                # below and the resident requests are preempted
                preempted = True
                break
            # 1. arrivals -> admission control (bounded queue)
            while pending and pending[0].arrival_s <= now:
                req = pending.popleft()
                self._requests["arrived"] += 1
                self._event("request-arrived", req.rid,
                            prompt=req.prompt_len, output=req.output_len)
                reason = (self._infeasible_reason(req)
                          if cfg.reject_infeasible else None)
                if reason is not None:
                    self._requests["rejected"] += 1
                    self._rejections["infeasible"] += 1
                    outcomes[req.rid] = "rejected[infeasible]"
                    rejected_detail.append({
                        "rid": req.rid, "reason": "infeasible",
                        "queue_depth": len(queue), "queue_wait_s": 0.0,
                        "detail": reason,
                    })
                    # distinct journal event from the load-shed path:
                    # infeasible is a config/trace mismatch, never load
                    self._event("request-infeasible", req.rid,
                                reason="infeasible", detail=reason)
                elif len(queue) >= cfg.queue_capacity:
                    head_wait = (now - queue[0].arrival_s if queue
                                 else 0.0)
                    self._requests["rejected"] += 1
                    self._rejections["queue-full"] += 1
                    outcomes[req.rid] = "rejected[queue-full]"
                    rejected_detail.append({
                        "rid": req.rid, "reason": "queue-full",
                        "queue_depth": len(queue),
                        "queue_wait_s": round(head_wait, 6),
                    })
                    self._event("request-rejected", req.rid,
                                reason="queue-full",
                                queue_depth=len(queue),
                                queue_wait_s=round(head_wait, 6))
                else:
                    queue.append(req)
                    self._requests["admitted"] += 1
                    self._event("request-admitted", req.rid,
                                queue_depth=len(queue))
            # 2. step-boundary scheduling: grant slots + block
            #    reservations, prefill each granted request.  First,
            #    per-request SLO shedding: a queue head whose wait has
            #    already blown its deadline is shed (reason "deadline",
            #    distinct from queue-full: latency, not capacity)
            while (queue and queue[0].deadline_s is not None
                    and now - queue[0].arrival_s > queue[0].deadline_s):
                req = queue.popleft()
                wait = now - req.arrival_s
                self._requests["rejected"] += 1
                self._rejections["deadline"] += 1
                self._deadline_counter["shed-queued"] += 1
                stats.deadline_shed += 1
                outcomes[req.rid] = "rejected[deadline]"
                rejected_detail.append({
                    "rid": req.rid, "reason": "deadline",
                    "queue_depth": len(queue),
                    "queue_wait_s": round(wait, 6),
                    "deadline_s": req.deadline_s,
                })
                self._event("request-rejected", req.rid, reason="deadline",
                            queue_wait_s=round(wait, 6), deadline_s=req.deadline_s)
            scheduled = False
            if queue and free_slots:
                # settle the in-flight decode before the prefill waits, so
                # its sync lands in decode timing and TTFT stays honest
                drain()
                with spans.span("serve-admission", queue=len(queue),
                                free_slots=len(free_slots)):
                    while queue and free_slots:
                        # prefix admission: blocks the trie already holds
                        # are charged once, so a request whose private
                        # suffix fits is admitted
                        plan = attach_plan(queue[0]) if cfg.prefix_caching else None
                        attach_blocks = plan["attach_blocks"] if plan else 0
                        if not ledger.can_reserve(queue[0].total_tokens,
                                                  shared_blocks=attach_blocks):
                            break
                        req = queue.popleft()
                        slot = free_slots.pop(0)
                        ledger.reserve(slot, req.total_tokens,
                                       chain=plan["chain"] if plan else None,
                                       attach_blocks=attach_blocks)
                        if draft_ledger is not None:
                            draft_ledger.reserve(slot, req.total_tokens)
                        try:
                            bucket, y_last, dt = prefill_dispatch(req, slot, plan)
                        except Exception as e:  # noqa: BLE001 — fail closed
                            fail_admission(req, slot, e)
                            continue
                        if token_mode and self._sampled:
                            # the first token obeys the temperature law too:
                            # the prefill's last logits (the same on every
                            # rank) come to the host, it draws, and the
                            # device embeds the id
                            # comm-lint: disable=host-transfer-in-loop  the host sampler draws the first token from these logits, once per admission
                            p0 = softmax_np(y_last.float().cpu().numpy(), cfg.temperature)
                            first_id = int(sample_rng.choice(p0.shape[-1], p=p0))
                            carry = _inject_token_sampled(carry, slot, first_id, self._table,
                                                          self.mesh)
                        elif token_mode:
                            # greedy token inject: the argmax of y_last,
                            # the same on every rank
                            carry, first_tok = _inject_token_greedy(
                                carry, slot, y_last, self._table, self.mesh)
                            first_id = int(first_tok)
                        else:
                            carry = _inject_token(carry, slot, y_last, self.mesh)
                            first_id = (int(torch.argmax(y_last))
                                        if self.capture_tokens else -1)
                        ledger.append(slot, req.prompt_len)
                        if draft_ledger is not None:
                            draft_ledger.append(slot, req.prompt_len)
                        if plan is not None:
                            reused = plan["attached_tokens"]
                            if reused:
                                stats.prefix_hits += 1
                                stats.prefix_tokens_reused += reused
                                self.registry.inc("serve_prefix_hits")
                                self.registry.inc("serve_prefix_tokens_reused", reused)
                                self._event("prefix-attach", req.rid, slot=slot,
                                            donor=plan["donor"], tokens=reused,
                                            blocks=reused // cfg.block_size)
                                if plan["cow_blocks"]:
                                    # matched deeper than the attach cap: the
                                    # tail blocks were recomputed privately
                                    ledger.note_cow(plan["cow_blocks"])
                                    stats.prefix_cow_blocks += plan["cow_blocks"]
                                    self._event("prefix-cow", req.rid, slot=slot,
                                                blocks=plan["cow_blocks"])
                            # the prefill (attached or full) made the slot a
                            # holder of every block of its chain
                            ledger.register(slot, plan["chain"])
                        t_first = self._now()
                        st = _SlotState(req=req, tokens_done=1, gamma_eff=cfg.spec_gamma)
                        if cfg.speculation == "ngram":
                            # prompt lookup: the prompt's own token ids (host
                            # numpy) and the first committed token
                            hist[req.rid] = prompt_token_ids(
                                req.seed, req.prompt_len, self.config.hidden_size,
                                period=req.prompt_period, prefix_len=req.prefix_len,
                                prefix_seed=req.prefix_seed) + [first_id]
                        slots[slot] = st
                        active_np[slot] = True
                        active_dirty[0] = True
                        stats.ttft_s.append(t_first - req.arrival_s)
                        stats.prefill_s.append(dt)
                        stats.generated_tokens += 1
                        scheduled = True
                        if self.capture_tokens:
                            tokens_by_rid.setdefault(req.rid, []).append(first_id)
                        self._event("request-prefill", req.rid, slot=slot,
                                    bucket=bucket,
                                    ttft_s=round(t_first - req.arrival_s, 6))
                        if st.tokens_done >= req.output_len:
                            finish(release(slot), self._now())
                if scheduled:
                    refresh_active()
            # 3. a decode unit over every resident request: one step, or a
            #    fused scan on the fast path
            if slots:
                dispatch_decode()
            elif pending and not queue:
                # idle until the next arrival (nothing resident, nothing
                # admittable); settle any in-flight tail first
                drain()
                wait = pending[0].arrival_s - self._now()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
            # 4. timeseries sample at the step boundary
            series["t_s"].append(round(self._now(), 6))
            series["queue_depth"].append(len(queue))
            series["active_slots"].append(len(slots))
            series["blocks_in_use"].append(ledger.blocks_in_use)
            series["blocks_reserved"].append(ledger.blocks_reserved)
            self.registry.set_gauge("serve_queue_depth", len(queue),
                                    help="bounded admission queue depth")
            self.registry.set_gauge("serve_active_slots", len(slots),
                                    help="decode slots in use")
            self.registry.set_gauge(
                "serve_decode_batch_occupancy",
                len(slots) / cfg.max_batch,
                help="resident fraction of the decode batch")
            self.registry.set_gauge("serve_cache_blocks_in_use",
                                    ledger.blocks_in_use,
                                    help="cache blocks holding tokens")
            if cfg.prefix_caching:
                series["shared_blocks"].append(ledger.shared_blocks)
                self.registry.set_gauge(
                    "serve_cache_shared_blocks", ledger.shared_blocks,
                    help="trie-indexed blocks counted once fleet-wide")
                self.registry.set_gauge(
                    "serve_cache_prefix_refs", ledger.trie.total_refs(),
                    help="slot references across all shared blocks")
        drain()
        remaining_rids: list[int] = []
        if preempted:
            # graceful drain: the window settled above; the resident
            # requests are preempted (journaled, freed) and replayed by
            # serve/bench.py::resume_serving with the queue and the rest
            for s in sorted(list(slots)):
                st = release(s)
                outcomes[st.req.rid] = "preempted"
                stats.preempted_requests += 1
                self._requests["preempted"] += 1
                remaining_rids.append(st.req.rid)
                self._event("request-preempted", st.req.rid,
                            tokens_done=st.tokens_done, output_len=st.req.output_len)
            remaining_rids += [r.rid for r in queue]
            remaining_rids += [r.rid for r in pending]
            if self.journal is not None:
                self.journal.event("preempted", signal=guard.signal_received,
                                   remaining=len(remaining_rids))
            if self.verbose:
                print(f"[serve] SIGTERM received — drained the in-flight "
                      f"window, {len(remaining_rids)} request(s) remain "
                      "for --resume")
        wall = self._now()
        self.draft_cache_stats = draft_ledger.stats() if draft_ledger is not None else None

        self.registry.set_gauge("serve_queue_depth_peak",
                                max(series["queue_depth"], default=0))
        self.registry.set_gauge("serve_cache_blocks_peak",
                                ledger.peak_in_use)
        goodput = (stats.completed_output_tokens / wall) if wall > 0 else 0.0
        arrived = self._requests["arrived"] - counts_base["arrived"]
        # shed rate counts LOAD shedding only (queue-full) — an
        # infeasible rejection is a config/trace mismatch
        shed = self._rejections["queue-full"] - shed_base
        report = {
            "schema": SERVING_REPORT_SCHEMA,
            "model": {
                "hidden_size": self.config.hidden_size,
                "num_layers": self.config.num_layers,
                "num_heads": self.config.num_heads,
                "kv_heads": self.config.kv_heads,
                "attention": self.config.attention,
                "dtype": self.config.dtype,
            },
            "mesh": {"dp": self.dp, "tp": self.tp},
            "serving": cfg.to_dict(),
            "trace": {
                "kind": trace.kind,
                "seed": trace.seed,
                "num_requests": len(trace),
                "params": dict(trace.params),
                "horizon_s": trace.horizon_s,
            },
            "requests": {
                **{k: self._requests[k] - counts_base[k]
                   for k in ("arrived", "admitted", "rejected",
                             "completed", "failed", "preempted",
                             "canceled")},
                "rejected_rids": [d["rid"] for d in rejected_detail],
                "rejected_detail": rejected_detail,
                "shed_rate": (shed / arrived) if arrived else 0.0,
                "deadline_shed": stats.deadline_shed,
                "completed_past_deadline": stats.completed_past_deadline,
                "outcomes": {str(rid): o
                             for rid, o in sorted(outcomes.items())},
            },
            "goodput_tokens_per_s": goodput,
            "throughput_tokens_per_s": (
                stats.generated_tokens / wall if wall > 0 else 0.0
            ),
            "completed_output_tokens": stats.completed_output_tokens,
            "generated_tokens": stats.generated_tokens,
            "decode_steps": stats.decode_steps,
            "decode_units": stats.decode_units,
            "fast_path": {
                "enabled": self._fast,
                "decode_horizon": cfg.decode_horizon,
                "inflight_window": cfg.inflight_window,
                "prefill_chunk": cfg.prefill_chunk,
                "compact_threshold": cfg.compact_threshold,
                "fused_scans": stats.fused_scans,
                "fused_steps": stats.fused_steps,
                "single_steps": stats.single_steps,
                "prefill_chunks": stats.prefill_chunks,
                "compacted_scans": stats.compacted_scans,
            },
            "speculation": {
                "mode": cfg.speculation,
                "gamma": cfg.spec_gamma,
                "adaptive": cfg.spec_adaptive,
                "temperature": cfg.temperature,
                "sampled": self._sampled,
                "sample_seed": cfg.sample_seed,
                "verify_units": stats.spec_verify_units,
                "fallback_units": stats.spec_fallback_units,
                "proposed_tokens": stats.spec_proposed_tokens,
                "accepted_tokens": stats.spec_accepted_tokens,
                "acceptance_rate": (stats.spec_accepted_tokens / stats.spec_proposed_tokens
                                    if stats.spec_proposed_tokens else 0.0),
                "mean_accepted_len": (stats.spec_commit_tokens / stats.spec_slot_verifies
                                      if stats.spec_slot_verifies else 0.0),
                "draft_overhead_s": stats.spec_draft_s,
            },
            "resilience": {
                "retries": stats.retries,
                "hung_dispatches": stats.hung_dispatches,
                "failed_requests": stats.failed_requests,
                "failed": failed_detail,
            },
            "preempted": preempted,
            "remaining_rids": sorted(remaining_rids),
            "prefix": {
                "enabled": cfg.prefix_caching,
                "kv_quantization": cfg.kv_quantization,
                "hits": stats.prefix_hits,
                "tokens_reused": stats.prefix_tokens_reused,
                "cow_blocks": stats.prefix_cow_blocks,
                "hit_rate": (stats.prefix_hits / len(stats.prefill_s)
                             if stats.prefill_s else 0.0),
            },
            "ttft": summarize(stats.ttft_s),
            "per_token_latency": summarize(stats.per_token_s),
            "e2e_latency": summarize(stats.e2e_latency_s),
            "prefill_time": summarize(stats.prefill_s),
            "decode_step_time": summarize(stats.decode_step_s),
            "cache": ledger.stats(),
            "timeseries": series,
            "compile_time_s": compile_time,
            "wall_seconds": wall,
        }
        if collect_raw or preempted:
            # a preempted report carries them for the resume's merge
            report["raw_samples"] = {
                "ttft_s": list(stats.ttft_s),
                "per_token_s": list(stats.per_token_s),
                "prefill_s": list(stats.prefill_s),
                "decode_step_s": list(stats.decode_step_s),
                "e2e_latency_s": list(stats.e2e_latency_s),
            }
        if self.capture_tokens:
            report["completed_tokens"] = {
                str(rid): toks for rid, toks in sorted(tokens_by_rid.items())
            }
        if self.verbose:
            ttft = report["ttft"]
            ptl = report["per_token_latency"]
            print(
                f"[serve] {trace.kind} x{len(trace)}: "
                f"{report['requests']['completed']} completed / "
                f"{report['requests']['rejected']} rejected, "
                f"goodput {goodput:.0f} tok/s, "
                f"ttft p50 {ttft['median'] * 1e3:.1f} ms "
                f"p99 {ttft['p99'] * 1e3:.1f} ms, "
                f"per-token p50 {ptl['median'] * 1e3:.2f} ms"
            )
        return report
