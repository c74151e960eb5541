"""Analytic expected-collective model (counterpart of
``dlbb_tpu/analysis/expectations.py``).

Maps what a benchmark claims to do (a registry collective of
``comm/ops.py`` or a ``ParallelismPlan`` axis assignment) to the
collective kinds one call of it may issue and the byte volume each may
carry.  The collective audit (``hlo_audit.py``) compares what a call
recorded (``op_capture.py``) against this; anything outside the envelope
is a finding.

The kind vocabulary.  JAX's auditor reads kinds off the lowered HLO; the
port reads the ``c10d`` ops that ``torch.distributed`` dispatches
(``C10D_KINDS``).  An op maps to JAX's kind name where XLA has one:
``allreduce_`` to ``all-reduce``, ``_allgather_base_``/``allgather_`` to
``all-gather``, ``_reduce_scatter_base_``/``reduce_scatter_`` to
``reduce-scatter``, ``alltoall_base_``/``alltoall_`` to ``all-to-all``, and
a ``send``/``recv_`` pair to ``collective-permute``.  ``broadcast``,
``gather``, ``scatter``, ``reduce`` and ``barrier`` have no HLO
counterpart (XLA composes them from symmetric collectives) and are the
port's own kinds (``PORT_KINDS``); ``wire_bytes`` charges them the ring
volumes that ``op_wire_bytes`` charges the registry ops that issue them.

``OP_EXPECTED_KINDS`` names what the port's ``comm/ops.py`` issues.  The
rows that differ from JAX's, where JAX composes a rooted op from a
symmetric collective and the port calls the native one:

- ``broadcast``: ``dist.broadcast`` (``comm/ops.py:171``,
  ``build_broadcast``), where JAX psums a masked contribution
  (``all-reduce``);
- ``gather``: ``dist.gather`` (``comm/ops.py:187``, ``build_gather``),
  where JAX all-gathers;
- ``scatter``: ``dist.scatter`` (``comm/ops.py:200``, ``build_scatter``),
  where JAX psums the root's slab;
- ``reduce``: ``dist.reduce`` (``comm/ops.py:213``, ``build_reduce``),
  where JAX psums.

Every other row is JAX's: ``build_barrier`` (``comm/ops.py:268``) is the
psum barrier (``all-reduce``), ``sendrecv`` one ring hop (``:248``, one
``collective-permute``).  Each row's ``cost_kind`` is the kind JAX lowers
the op to, which the sweep corpus and the cost model price it as
(``obs/corpus.py``).

``plan_expected_kinds`` gives, per parallelism axis, the kinds the axis
may introduce into a model or train step (Megatron tp: all-reduce; ring
sp: collective-permute; Ulysses sp: all-to-all; pp: collective-permute;
ZeRO dp: reduce-scatter/all-gather; ...).  ``wire_bytes`` converts a
collective's per-rank result bytes into the analytic wire volume of the
standard ring algorithm for its kind.

The compressed wire's constants live here (``comm/compression.py`` and
``stats/stats1d.py`` import them), and so does ``op_wire_bytes``, the
registry ops' analytic wire model.  The module imports neither torch nor
CUDA.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

# --- compressed-collective wire model --------------------------------------
COMPRESSIONS = ("int8", "fp8")
# the compressed ops' wire where none is named
DEFAULT_COMPRESSION = "int8"
# payload bytes per element on the wire (int8 and fp8 e4m3 are both 1 B)
COMPRESSED_WIRE_ITEM_BYTES = {"int8": 1, "fp8": 1}
# one fp32 scale per chunk of this many elements: the scale side channel,
# charged to every byte ceiling below
SCALE_CHUNK_ELEMS = 256
SCALE_ITEM_BYTES = 4


def scale_bytes(num_elements: int) -> int:
    """Bytes of the fp32 scale side channel for a quantised payload of
    ``num_elements`` (one scale per ``SCALE_CHUNK_ELEMS``-element chunk)."""
    return -(-num_elements // SCALE_CHUNK_ELEMS) * SCALE_ITEM_BYTES


def padded_elems(num_elements: int) -> int:
    """Elements on the wire for a quantised payload of ``num_elements``:
    ``quantize_chunked`` zero-pads to a whole chunk, and the padding
    travels."""
    return -(-num_elements // SCALE_CHUNK_ELEMS) * SCALE_CHUNK_ELEMS


# --- the kind vocabulary ----------------------------------------------------
# JAX's HLO collective kinds
COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)
# the port's own kinds: rooted ops and the barrier, which XLA composes
PORT_KINDS = ("broadcast", "gather", "scatter", "reduce", "barrier")

# c10d op (``torch.ops.c10d``) -> kind; ``send`` and ``recv_`` pair into one
# ``collective-permute`` (``op_capture.py``, where an op outside this table
# keeps its own name as its kind)
C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast",
    "gather_": "gather",
    "scatter_": "scatter",
    "reduce_": "reduce",
    "barrier": "barrier",
    "monitored_barrier_": "barrier",
}

# Registry op -> allowed kinds, the kind that must appear at least once
# (its defining collective), and ``cost_kind``, JAX's lowering of the op
# (module docstring).
OP_EXPECTED_KINDS: dict[str, dict] = {
    "allreduce": {"required": "all-reduce", "allowed": {"all-reduce"},
                  "cost_kind": "all-reduce"},
    "allreduce_hierarchical": {
        # one all_reduce per mesh axis: >= 2 on a multi-axis mesh
        "required": "all-reduce", "allowed": {"all-reduce"},
        "min_required": 2, "cost_kind": "all-reduce",
    },
    "allgather": {"required": "all-gather", "allowed": {"all-gather"},
                  "cost_kind": "all-gather"},
    # the rooted ops: native c10d calls (module docstring)
    "broadcast": {"required": "broadcast", "allowed": {"broadcast"},
                  "cost_kind": "all-reduce"},
    "gather": {"required": "gather", "allowed": {"gather"},
               "cost_kind": "all-gather"},
    "scatter": {"required": "scatter", "allowed": {"scatter"},
                "cost_kind": "all-reduce"},
    "reduce": {"required": "reduce", "allowed": {"reduce"},
               "cost_kind": "all-reduce"},
    "alltoall": {"required": "all-to-all", "allowed": {"all-to-all"},
                 "cost_kind": "all-to-all"},
    "sendrecv": {
        "required": "collective-permute", "allowed": {"collective-permute"},
        "cost_kind": "collective-permute",
    },
    "reducescatter": {
        "required": "reduce-scatter",
        # JAX's latitude for XLA CPU's all-reduce + slice legalisation
        "allowed": {"reduce-scatter", "all-reduce"},
        "required_any": {"reduce-scatter", "all-reduce"},
        "cost_kind": "reduce-scatter",
    },
    "barrier": {"required": "all-reduce", "allowed": {"all-reduce"},
                "cost_kind": "all-reduce"},
    # the collective-matmul micro-ops, fused schedule; the ring/bidir
    # schedules are audited through ``overlap_op_expectation``
    "ag_matmul": {"required": "all-gather", "allowed": {"all-gather"},
                  "cost_kind": "all-gather"},
    "matmul_rs": {
        "required": "reduce-scatter",
        "allowed": {"reduce-scatter", "all-reduce"},
        "required_any": {"reduce-scatter", "all-reduce"},
        "cost_kind": "reduce-scatter",
    },
}

# Parallelism axis -> collective kinds that axis may introduce (JAX's
# table).  tp allows collective-permute for GSPMD's QKV realignment; the
# port issues none, so the row only widens what is allowed.
AXIS_EXPECTED_KINDS: dict[str, set[str]] = {
    "dp": {"all-reduce", "reduce-scatter", "all-gather"},  # DDP / ZeRO
    "tp": {"all-reduce", "collective-permute"},
    # tp under the overlapped collective-matmul schedule: ring hops, and
    # one activation-sized gather back to the batch layout; an all-reduce
    # surviving means the decomposition collapsed
    "tp_overlap": {"collective-permute", "all-gather"},
    "sp_ring": {"collective-permute"},                      # ring attention
    "sp_ulysses": {"all-to-all"},                           # Ulysses resharding
    "pp": {"collective-permute", "all-reduce"},
    "ep": {"all-reduce"},
    # dp with quantised gradient reduction: ring hops + wire-dtype
    # all-gather; all-reduce only for the scalar loss mean
    "dp_compressed": {"collective-permute", "all-gather", "all-reduce"},
}


def plan_expected_kinds(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
                        ep: int = 1, attention: str = "full",
                        zero_stage: int = 0,
                        tp_overlap: str = "off",
                        compression: str = "none",
                        decode: bool = False) -> set[str]:
    """The union of collective kinds a (plan, attention, ZeRO stage,
    tp_overlap schedule, grad-compression mode) combination may issue,
    JAX's rule.  ``decode=True`` is the serving step (decode and the
    prefill cache append): no gradient reduction, so dp contributes
    nothing and only tp's per-token row sums are legal."""
    if decode:
        if sp > 1 or pp > 1 or ep > 1:
            raise ValueError(
                "decode=True models the serving step, which runs on "
                f"(dp, tp) meshes only (got sp={sp}, pp={pp}, ep={ep})"
            )
        return set(AXIS_EXPECTED_KINDS["tp"]) if tp > 1 else set()
    kinds: set[str] = set()
    if dp > 1:
        if compression not in (None, "none"):
            kinds |= AXIS_EXPECTED_KINDS["dp_compressed"]
        else:
            kinds |= ({"all-reduce"} if zero_stage == 0
                      else AXIS_EXPECTED_KINDS["dp"])
    if tp > 1:
        kinds |= AXIS_EXPECTED_KINDS[
            "tp_overlap" if tp_overlap != "off" else "tp"
        ]
    if sp > 1:
        kinds |= AXIS_EXPECTED_KINDS[
            "sp_ring" if attention == "ring" else "sp_ulysses"
        ]
    if pp > 1:
        kinds |= AXIS_EXPECTED_KINDS["pp"]
    if ep > 1:
        kinds |= AXIS_EXPECTED_KINDS["ep"]
    return kinds


def wire_bytes(kind: str, result_bytes: int, group_size: Optional[int]) -> int:
    """Analytic per-rank wire volume of the standard ring algorithm for
    ``kind``, given the collective's per-rank result bytes (JAX's model,
    and the port's kinds at the volumes ``op_wire_bytes`` charges).

    all-reduce (and broadcast, reduce, barrier): 2(P-1)/P x buffer;
    all-gather (and gather, whose result is the gathered buffer): (P-1)/P
    of it; reduce-scatter: (P-1) x the scattered shard; all-to-all:
    (P-1)/P of the slab; collective-permute: the whole buffer once;
    scatter: the root's whole slab (P x the received row) at all-reduce
    volume."""
    p = group_size or 1
    if p <= 1:
        return 0
    if kind in ("all-reduce", "broadcast", "reduce", "barrier"):
        return int(2 * (p - 1) / p * result_bytes)
    if kind in ("all-gather", "gather"):
        return int((p - 1) / p * result_bytes)
    if kind == "reduce-scatter":
        return int((p - 1) * result_bytes)
    if kind == "all-to-all":
        return int((p - 1) / p * result_bytes)
    if kind == "collective-permute":
        return int(result_bytes)
    if kind == "scatter":
        return int(2 * (p - 1) / p * p * result_bytes)
    return int(result_bytes)


@dataclass
class TargetExpectation:
    """The audit contract for one target (JAX's fields, all of them: the
    collective pass reads ``allowed`` through ``expect_donation``; the
    schedule, memory and numerics passes of ROADMAP Queue 1, Slice F, item
    15, part 15b read the rest).

    allowed:            collective kinds that may appear.
    required_any:       at least one collective of one of these kinds must
                        appear (None: nothing required, e.g. a local
                        program that must stay communication-free).
    min_required:       minimum count among ``required_any``.
    max_bytes_per_instr: per-rank result-byte ceiling per collective.
    max_total_wire_bytes: ceiling on the sum of analytic wire bytes
                        (``wire_bytes``) over every collective of a call.
    expect_donation:    the call must update its state in place (the
                        port's counterpart of JAX's buffer donation:
                        ``op_capture.Capture.has_donation``).
    expect_overlap:     every ring hop must be hidden behind compute.
    max_peak_bytes:     per-rank ceiling on the peak live bytes.
    donated_bytes_expected / donated_bytes_tolerance: analytic bytes of
                        the donated state, and the relative slack.
    policy_dtype:       the target's declared compute dtype, in HLO terms
                        (``policy_dtype_for``).
    expect_bitwise_reproducible: the target claims bitwise-identical
                        results across runs and layouts.
    """

    allowed: set[str] = field(default_factory=set)
    required_any: Optional[set[str]] = None
    min_required: int = 1
    max_bytes_per_instr: Optional[int] = None
    max_total_wire_bytes: Optional[int] = None
    expect_donation: bool = False
    expect_overlap: bool = False
    max_peak_bytes: Optional[int] = None
    donated_bytes_expected: Optional[int] = None
    donated_bytes_tolerance: float = 0.10
    policy_dtype: Optional[str] = None
    expect_bitwise_reproducible: bool = False


# dtype name (``ModelConfig.dtype``, numpy, or a torch dtype's) -> HLO
# element type
_HLO_POLICY_DTYPE = {
    "float32": "f32", "bfloat16": "bf16", "float16": "f16",
    "float64": "f64",
    "f32": "f32", "bf16": "bf16", "f16": "f16", "f64": "f64",
}


def policy_dtype_for(dtype: Any) -> str:
    """The HLO element type a dtype declares: a ``ModelConfig.dtype``
    string or a torch dtype (``torch.bfloat16`` -> ``"bf16"``)."""
    name = str(dtype)
    if name.startswith("torch."):
        name = name[len("torch."):]
    try:
        return _HLO_POLICY_DTYPE[name]
    except KeyError:
        raise ValueError(
            f"no HLO policy dtype for {dtype!r}; known: "
            f"{sorted(_HLO_POLICY_DTYPE)}"
        ) from None


def op_expectation(op_name: str, payload_bytes_per_rank: int,
                   slack: float = 1.25) -> TargetExpectation:
    """Expectation for one ``comm/ops.py`` registry op: its kinds, and a
    byte ceiling of ``slack`` x ``payload_bytes_per_rank`` per collective
    (gather-family callers pass the gathered size)."""
    spec = OP_EXPECTED_KINDS[op_name]
    required_any = spec.get("required_any")
    if required_any is None:
        required_any = {spec["required"]}
    return TargetExpectation(
        allowed=set(spec["allowed"]),
        required_any=set(required_any),
        min_required=spec.get("min_required", 1),
        max_bytes_per_instr=int(payload_bytes_per_rank * slack),
        # registry micro-op payloads are f32 (the audit's make_payload)
        policy_dtype="f32",
    )


def op_wire_bytes(op_name: str, num_elements: int, num_ranks: int,
                  elem_bytes: int,
                  compression: Optional[str] = None) -> Optional[int]:
    """Per-rank analytic wire bytes of one registry op under the standard
    ring algorithms (JAX's model), or None for an op without one (the
    collective-matmul micro-ops, whose wire depends on the schedule).
    ``n`` is the per-rank element count (the ``[P, n]`` slab row for the
    per-peer ops), ``p`` the rank count, ``b`` the element bytes.  For the
    compressed ops the chunk padding and the fp32 scale side channel
    count; ``compression`` defaults to int8."""
    n, p, b = num_elements, num_ranks, elem_bytes
    if p <= 1:
        return 0
    if op_name in ("allreduce", "allreduce_hierarchical", "broadcast",
                   "reduce", "barrier"):
        return int(2 * (p - 1) / p * n * b)
    if op_name in ("allgather", "gather", "alltoall"):
        return int((p - 1) * n * b)
    if op_name == "scatter":
        # the root's whole [P, n] slab at all-reduce volume
        return int(2 * (p - 1) / p * p * n * b)
    if op_name == "sendrecv":
        return int(n * b)
    if op_name == "reducescatter":
        return int((p - 1) * n * b)
    if op_name in ("allreduce_q", "reducescatter_q"):
        w = COMPRESSED_WIRE_ITEM_BYTES[compression or DEFAULT_COMPRESSION]
        if op_name == "reducescatter_q":
            # the ring alone: (P-1) hops of one quantised row and its scales
            return (p - 1) * (padded_elems(n) * w + scale_bytes(n))
        # the ring over ceil(n/P)-element chunks, then the all-gather of
        # the quantised reduced chunks and their scales
        c = -(-n // p)
        ring = (p - 1) * (padded_elems(c) * w + scale_bytes(c))
        gather = int(
            (p - 1) / p * p * (padded_elems(c) * w + scale_bytes(c)))
        return ring + gather
    return None


def compression_wire_ceiling(baseline_bytes: int, analytic_bytes: int,
                             ratio: float = 0.55,
                             slack: float = 1.1) -> int:
    """The compression total-wire ceiling shared by every compressed
    target: ``ratio`` x the uncompressed baseline, or ``slack`` x the op's
    own padding-included analytic wire where compression cannot pay,
    whichever is larger."""
    return max(int(ratio * baseline_bytes), int(slack * analytic_bytes))


def compressed_op_expectation(op_name: str, p: int, num_elements: int,
                              compression: str = "int8",
                              baseline_elem_bytes: int = 2,
                              ratio: float = 0.55) -> TargetExpectation:
    """Expectation for a compressed registry op (``allreduce_q`` /
    ``reducescatter_q``): the quantised ring (collective-permutes, plus
    the wire-dtype all-gather for ``allreduce_q``), whose total wire,
    scales included, stays under ``compression_wire_ceiling`` of the
    uncompressed bf16 wire of the op it replaces (JAX's contract)."""
    w = COMPRESSED_WIRE_ITEM_BYTES[compression]
    if op_name == "allreduce_q":
        baseline = wire_bytes(
            "all-reduce", num_elements * baseline_elem_bytes, p)
        allowed = {"collective-permute", "all-gather"}
        # largest legitimate collective: the quantised all-gather result
        max_instr = p * padded_elems(-(-num_elements // p)) * w
    elif op_name == "reducescatter_q":
        baseline = wire_bytes(
            "reduce-scatter", num_elements * baseline_elem_bytes, p)
        allowed = {"collective-permute"}
        max_instr = padded_elems(num_elements) * w
    else:
        raise ValueError(f"not a compressed registry op: {op_name!r}")
    analytic = op_wire_bytes(op_name, num_elements, p, baseline_elem_bytes,
                             compression=compression)
    return TargetExpectation(
        allowed=allowed,
        required_any={"collective-permute"},
        min_required=p - 1,
        max_bytes_per_instr=int(
            max_instr * 1.25 + scale_bytes(num_elements) * p
        ),
        max_total_wire_bytes=compression_wire_ceiling(
            baseline, analytic, ratio=ratio),
        policy_dtype="bf16",
    )


def decode_scan_expectation(dp: int, tp: int, k: int,
                            act_bytes: int,
                            slack: float = 1.25,
                            policy_dtype: Optional[str] = "f32",
                            ) -> TargetExpectation:
    """Expectation for the fused ``k``-step decode scan: only the per-token
    tp collectives (plus JAX's one boundary all-gather), the row-parallel
    sum at least once per trip (``min_required = k``, each executed call
    counts), every collective within one step's activation bytes, the
    cache updated in place."""
    return TargetExpectation(
        allowed=plan_expected_kinds(dp=dp, tp=tp, decode=True)
        | {"all-gather"},
        required_any={"all-reduce"},
        min_required=k,
        max_bytes_per_instr=int(act_bytes * slack),
        expect_donation=True,
        policy_dtype=policy_dtype,
    )


def verify_step_expectation(dp: int, tp: int, gamma: int,
                            act_bytes: int,
                            slack: float = 1.25,
                            policy_dtype: Optional[str] = "f32",
                            ) -> TargetExpectation:
    """Expectation for the speculative verify step: one batched
    ``[max_batch, γ+1, H]`` forward, so the decode kinds (and the
    all-gather, which the port's verify uses to return ``tok`` and
    ``commits`` whole over dp), at least one row-parallel sum, every
    collective within (γ+1) x one step's activation bytes, the cache
    updated in place."""
    return TargetExpectation(
        allowed=plan_expected_kinds(dp=dp, tp=tp, decode=True)
        | {"all-gather"},
        required_any={"all-reduce"},
        min_required=1,
        max_bytes_per_instr=int(act_bytes * (gamma + 1) * slack),
        expect_donation=True,
        policy_dtype=policy_dtype,
    )


def compact_expectation() -> TargetExpectation:
    """Expectation for the slot-compaction gather/scatter and the prefix
    attach: local data movement, zero collectives."""
    return TargetExpectation(allowed=set(), required_any=None)


def overlap_op_expectation(p: int, chunk_bytes: int,
                           slack: float = 1.25) -> TargetExpectation:
    """Expectation for a ring-decomposed collective matmul (either op,
    either direction): a pure collective-permute chain of at least
    ``p - 1`` hops, each carrying at most one travelling chunk
    (``chunk_bytes``), and no fused collective."""
    return TargetExpectation(
        allowed={"collective-permute"},
        required_any={"collective-permute"},
        min_required=p - 1,
        max_bytes_per_instr=int(chunk_bytes * slack),
        expect_overlap=True,
        policy_dtype="f32",
    )
