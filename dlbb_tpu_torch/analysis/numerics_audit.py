"""The static numerics auditor: dtype flow and precision policy
(counterpart of ``dlbb_tpu/analysis/numerics_audit.py``).

The collective audit proves *what* a call sends, the schedule audit *when*,
the memory audit *how much memory*; this pass proves the call computes in
the *precision* its target declares.  JAX runs a dtype-flow analysis over
the compiled module; the port runs it over the captured graph
(``op_capture.py``), with each rule in its torch form.

Error-bound model (JAX's, copied whole: ``unit_roundoff``,
``accumulation_error_bounds``, the dtype tables and the floors): summing
``n`` terms in a dtype of unit roundoff ``u = 2^-p`` bounds the relative
error, against ``sum(|x_i|)``, by ``(n-1)·u`` in sequential order and
``ceil(log2 n)·u`` in tree order (Higham 2002, §4.2).  The fp64 shadow
(``numerics_shadow.py``) replays flagged shapes against a float64
reference.

Accumulation sites.  A site is an accumulation in its real accumulator's
dtype:

==============================================  ==========================  =============
op                                              terms (n)                   accumulator
==============================================  ==========================  =============
products (``schedule_audit._PRODUCTS``)         the contraction K           f32 (f64 for
                                                                            f64 inputs)
``flash::*`` kernels                            the keys, Sk                f32
``sum``, ``mean``, ``nansum``, ``var``,         input / output elements     f32 (f64)
``std``, ``var_mean``, ``std_mean``,
``linalg_vector_norm``, ``norm``, ``cumsum``
``native_layer_norm``, ``layer_norm``          the normalised elements     f32 (f64)
``_softmax``, ``_log_softmax`` (and their       the softmax dim             f32 (f64)
composite forms)
a chain of elementwise ``add``/``add_``         the terms it sums           its own dtype
==============================================  ==========================  =============

torch accumulates a bf16 or f16 reduction or product in f32 on the CPU and
on CUDA (``acc_type``), so those ops are never a low-precision site.  On
the card cuBLAS may, under ``allow_bf16_reduced_precision_reduction``
(torch's default), combine the partial sums of a split-K bf16 product in
bf16; each partial still accumulates in f32 and a split combines a handful
of partials, far under ``LOW_PRECISION_ACCUM_FLOOR``, so a bf16 product is
not a site there either.  What does accumulate in bf16 or f16 is a chain
of elementwise adds whose operands are equal-sized and whose result feeds
the next add: its terms are the sum of its operands' terms (1 for a value
no add wrote), so a sequential chain ``acc = acc + x_i`` over n values and
a halving ladder ``v = v[0::2] + v[1::2]`` over n elements both reach n.
The site is the chain's last add.

Rules:

- ``low-precision-accumulation`` — a bf16/f16 site of at least
  ``LOW_PRECISION_ACCUM_FLOOR`` terms;
- ``silent-upcast`` — under a bf16/f16 ``policy_dtype``, an f32/f64 tensor
  of at least ``UPCAST_BYTES_FLOOR`` bytes crossing a ``c10d`` op, or held
  as the call's state (JAX's while carry);
- ``quantise-roundtrip`` — an int8/fp8 ``_to_copy`` back into float, then
  scaling or layout ops only, then a ``_to_copy`` to the narrow type again
  (an equal-sized add, or a ``where`` merging two live streams, is real
  work and ends the trace);
- ``nondeterministic-reduction`` — an fp ``allreduce_``/``reduce_scatter``
  over more than one rank: always counted, an error only under
  ``expect_bitwise_reproducible``;
- ``policy-conformance`` — any f64 tensor in the call, a sizeable argument
  stored below the policy's precision, or a short accumulation below it;
- ``convert-churn`` — an identity ``_to_copy`` (its ``dtype=`` its input's,
  on the same device) or an ``A -> wider -> A`` pair whose intermediate has
  no other reader (a narrowing middle is a deliberate clamp).

A convert is a ``_to_copy`` (or, under ``torch.inference_mode``, the
composite ``to`` that reaches the capture whole) or a ``copy_`` that
changes the dtype, or an identity ``_to_copy``.  The per-target meta's ``numerics_*`` keys fold into
the baselines (``schedule_audit.diff_baselines``).  The module imports
neither torch nor the JAX package.
"""

from __future__ import annotations

import json
import time
from math import ceil, log2
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.analysis.expectations import TargetExpectation
from dlbb_tpu_torch.analysis.findings import SEVERITY_ERROR, Finding
from dlbb_tpu_torch.analysis.schedule_audit import (
    contraction_length,
    is_collective,
)

NUMERICS_REPORT_SCHEMA = "dlbb_numerics_audit_v1"
NUMERICS_REPORT_NAME = "numerics_audit.json"

# significand precision in bits, hidden bit included — unit roundoff is
# 2^-p (f32: 2^-24, bf16: 2^-8, f16: 2^-11)
SIGNIFICAND_BITS = {
    "f64": 53, "f32": 24, "f16": 11, "bf16": 8,
    "f8e4m3fn": 4, "f8e4m3": 4, "f8e5m2": 3,
}
LOW_PRECISION_DTYPES = ("bf16", "f16")
# wire dtypes of the quantised collectives: a convert to or from one of
# these is a quantise or dequantise edge for the roundtrip rule
QUANT_DTYPES = ("s8", "u8", "f8e4m3fn", "f8e4m3", "f8e5m2")
_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2}

# an accumulation shorter than this is not worth a finding even in bf16
LOW_PRECISION_ACCUM_FLOOR = 512
# f32 payloads under a bf16 policy smaller than this are side channels
# (quantisation scales, loss scalars) — legal mixed-precision practice
UPCAST_BYTES_FLOOR = 4096
# arguments below policy precision smaller than this are ignored
POLICY_BYTES_FLOOR = 1024

# the reductions and their terms (module docstring)
_REDUCTIONS = ("sum", "mean", "nansum", "var", "std", "var_mean", "std_mean",
               "linalg_vector_norm", "norm", "cumsum")
_SOFTMAX = ("_softmax", "_log_softmax", "softmax", "log_softmax")
_ADDS = ("add", "add_")
# ops a roundtrip trace passes through on their data operand (JAX's layout
# and rounding opcodes; views are no nodes and need no entry)
_PASS_UNARY = frozenset((
    "clone", "copy_", "_unsafe_view", "repeat", "constant_pad_nd", "neg", "abs",
    "floor", "ceil", "round", "trunc",
))
_BIN_SCALE = frozenset(("mul", "mul_", "div", "div_", "add", "add_", "sub", "sub_",
                        "maximum", "minimum"))
_BIN_PASS_EQUAL = frozenset(("mul", "mul_", "div", "div_"))
# ops that make a fill from nothing (a masking select's constant side)
_FILLS = frozenset(("zeros", "ones", "full", "fill_", "zero_", "scalar_tensor",
                    "zeros_like", "ones_like", "full_like", "new_zeros", "new_full",
                    "new_ones", "lift_fresh", "lift_fresh_copy", "_to_copy"))


def unit_roundoff(dtype: str) -> Optional[float]:
    """``2^-p`` for a known fp dtype, None otherwise."""
    bits = SIGNIFICAND_BITS.get(dtype)
    return 2.0 ** -bits if bits else None


def accumulation_error_bounds(n: int, dtype: str) -> tuple[float, float]:
    """(sequential, tree) worst-case relative error bounds — against
    ``sum(|x_i|)`` — for summing ``n`` terms in ``dtype``: ``(n-1)·u``
    and ``ceil(log2 n)·u`` (Higham 2002 §4.2)."""
    u = unit_roundoff(dtype) or 0.0
    if n <= 1:
        return 0.0, 0.0
    return (n - 1) * u, ceil(log2(n)) * u


def _is_fp(dtype: Optional[str]) -> bool:
    return dtype in SIGNIFICAND_BITS


def _precision(dtype: str) -> int:
    return SIGNIFICAND_BITS.get(dtype, 0)


def _base(op: str) -> str:
    return op.split("::", 1)[-1].split(".", 1)[0]


def _acc_dtype(dtype: str) -> str:
    """torch's accumulator of a reduction or product over ``dtype``."""
    return "f64" if dtype == "f64" else "f32"


def _loc(node) -> str:
    loc = f"{node.op}.{node.index}"
    if node.source:
        loc += f" ({node.source})"
    return loc


def _first_read(node, *names):
    for r in node.reads:
        if not names or r.arg in names:
            return r
    return None


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _reduction_terms(node) -> int:
    """The terms one output element of a reduction node sums, 0 if the
    node is none."""
    base = _base(node.op)
    x = _first_read(node, "self", "input", "x")
    if x is None or not node.op.startswith("aten::"):
        return 0
    if base in _REDUCTIONS:
        outs = [t for t in node.outputs if t.dtype == node.outputs[0].dtype]
        out_numel = outs[0].numel if outs else 1
        if base == "cumsum":
            dim = node.args.get("dim", -1)
            return x.shape[dim] if x.shape else 1
        return x.numel // max(out_numel, 1)
    if base in ("native_layer_norm", "layer_norm"):
        shape = node.args.get("normalized_shape") or []
        return _prod(shape)
    if base in _SOFTMAX:
        dim = node.args.get("dim", -1)
        return x.shape[dim] if x.shape else 1
    return 0


def _add_chains(nodes) -> tuple[dict[int, int], set[int]]:
    """The terms of every equal-operand fp add (module docstring) and the
    adds whose result feeds another such add (not chain ends)."""
    terms: dict[int, int] = {}
    fed: set[int] = set()
    for node in nodes:
        if not node.op.startswith("aten::") or _base(node.op) not in _ADDS:
            continue
        operands = [r for r in node.reads if r.arg in ("self", "other")]
        if (len(operands) != 2 or not node.outputs or not _is_fp(node.outputs[0].dtype)
                or operands[0].numel != operands[1].numel):
            continue
        total = 0
        for r in operands:
            t = terms.get(r.writer)
            if t is not None:
                fed.add(r.writer)
                total += t
            else:
                total += 1
        terms[node.index] = min(total, 1 << 40)
    return terms, fed


def reduction_sites(cap) -> list[dict[str, Any]]:
    """Every fp accumulation of the captured call with its terms and both
    analytic error bounds (module docstring's table)."""
    nodes = cap.nodes
    sites: list[dict[str, Any]] = []

    def site(node, kind, dtype, n):
        if n <= 1 or not _is_fp(dtype):
            return
        bound_seq, bound_tree = accumulation_error_bounds(n, dtype)
        sites.append({
            "kind": kind, "dtype": dtype, "elements": int(n),
            "bound_sequential": bound_seq, "bound_tree": bound_tree,
            "location": _loc(node), "op_name": node.op, "execution_count": 1,
        })

    terms, fed = _add_chains(nodes)
    for node in nodes:
        if node.op.startswith("flash::"):
            site(node, "dot", "f32", int(node.args.get("sk", 0)))
            continue
        k = contraction_length(node)
        if k:
            site(node, "dot", _acc_dtype(node.reads[0].dtype), k)
            continue
        n = _reduction_terms(node)
        if n:
            x = _first_read(node, "self", "input", "x")
            site(node, "reduce", _acc_dtype(x.dtype), n)
            continue
        if node.index in terms and node.index not in fed:
            site(node, "add-chain", node.outputs[0].dtype, terms[node.index])
    return sites


def _convert(node) -> Optional[tuple[str, str, bool]]:
    """(source dtype, result dtype, identity) of a convert node, None for
    any other node."""
    base = _base(node.op)
    if base in ("_to_copy", "to"):
        src = _first_read(node, "self")
        dst = node.outputs[0] if node.outputs else None
        if src is None or dst is None:
            return None
        want = node.args.get("dtype")
        if src.dtype != dst.dtype:
            return src.dtype, dst.dtype, False
        if want is not None and src.device == dst.device and node.out_kinds[0] == "new":
            return src.dtype, dst.dtype, True
        return None
    if base == "copy_":
        src = _first_read(node, "src")
        dst = _first_read(node, "self")
        if src is not None and dst is not None and src.dtype != dst.dtype:
            return src.dtype, dst.dtype, False
    return None


def _is_fill(nodes, ref, steps: int = 16) -> bool:
    """Whether ``ref`` holds a constant-like fill: made from nothing, or by
    layout ops over such a value."""
    w = ref.writer
    while steps > 0 and w >= 0:
        node = nodes[w]
        base = _base(node.op)
        tensors = [r for r in node.reads if r.arg in ("self", "input")]
        if base in _FILLS and (base != "_to_copy" or all(_is_fill(nodes, r, steps - 1)
                                                        for r in tensors)):
            return True
        if base in _PASS_UNARY and tensors:
            w, steps = tensors[0].writer, steps - 1
            continue
        return False
    return False


def _data_operands(nodes, node) -> Optional[list]:
    """The reads a roundtrip trace follows through ``node``, or None when
    the node does real work and the trace ends."""
    base = _base(node.op)
    if base in _PASS_UNARY:
        src = _first_read(node, "src") if base == "copy_" else _first_read(node)
        return [src] if src is not None else None
    if base in ("clamp", "clamp_", "clip", "masked_fill", "masked_fill_"):
        return [_first_read(node, "self")]
    if base == "where":
        a, b = _first_read(node, "self"), _first_read(node, "other")
        if a is None or b is None:
            return [r for r in (a, b) if r is not None] or None
        follow = [x for x, sib in ((a, b), (b, a)) if _is_fill(nodes, sib)]
        return follow or None
    if base in _BIN_SCALE:
        ops = [r for r in node.reads if r.arg in ("self", "other")]
        if len(ops) < 2:
            return ops or None   # a Python scalar operand: a scale
        e0, e1 = ops[0].numel, ops[1].numel
        if e0 > e1:
            return [ops[0]]
        if e1 > e0:
            return [ops[1]]
        if base in _BIN_PASS_EQUAL:
            return ops
        return None   # an equal-size combine: real accumulation
    return None


def _find_dequant(nodes, quantise, max_steps: int = 64):
    """Walk back from a quantise convert through pass-through nodes; the
    dequantise convert that feeds it with no arithmetic in between, or
    None."""
    work = [r.writer for r in quantise.reads if r.arg == "self"]
    seen: set[int] = set()
    steps = 0
    while work and steps < max_steps:
        w = work.pop()
        steps += 1
        if w < 0 or w in seen:
            continue
        seen.add(w)
        node = nodes[w]
        conv = _convert(node)
        if conv is not None:
            src, dst, _ = conv
            if src in QUANT_DTYPES and _is_fp(dst):
                return node
            if src != dst:
                continue   # any other convert changes meaning: this path ends
        follow = _data_operands(nodes, node)
        if follow:
            work += [r.writer for r in follow if r is not None]
    return None


# ``dist.ReduceOp`` numbers whose result depends on the summation order:
# SUM, AVG, PREMUL_SUM (MAX, MIN and the bitwise ops do not)
_ORDERED_REDUCE_OPS = (0, 1, 8)


def analyze_numerics(
    cap,
    expectation: TargetExpectation,
    target: str,
    num_devices: int = 1,
    peak_live_bytes: Optional[int] = None,
    top_n: int = 8,
) -> tuple[list[Finding], dict[str, Any]]:
    """The dtype-flow audit of one captured call against its declared
    precision policy.  Returns (findings, meta); the meta carries the
    baseline keys (``numerics_*``) and the top-N site table."""
    nodes = cap.nodes
    findings: list[Finding] = []
    policy = expectation.policy_dtype
    policy_prec = _precision(policy) if policy else 0

    fp_dtypes: set[str] = set()
    for node in nodes:
        for t in (*node.reads, *node.outputs):
            if _is_fp(t.dtype):
                fp_dtypes.add(t.dtype)

    # -- accumulation sites
    sites = reduction_sites(cap)
    low_precision_sites = 0
    max_bound_tree = 0.0
    max_elems = 0
    for site in sites:
        max_elems = max(max_elems, site["elements"])
        max_bound_tree = max(max_bound_tree, site["bound_tree"])
        if site["dtype"] in LOW_PRECISION_DTYPES and site["elements"] >= LOW_PRECISION_ACCUM_FLOOR:
            low_precision_sites += 1
            n, dt = site["elements"], site["dtype"]
            findings.append(Finding(
                pass_name="numerics", rule="low-precision-accumulation",
                severity=SEVERITY_ERROR, target=target,
                message=(
                    f"{dt} accumulator on a {site['kind']} over {n} elements: "
                    f"worst-case relative error {site['bound_sequential']:.3g} "
                    f"sequential / {site['bound_tree']:.3g} tree (vs "
                    f"{accumulation_error_bounds(n, 'f32')[0]:.3g} in f32) — "
                    "accumulate in f32 (sum in one reduction, or upcast the "
                    "accumulator) and round the result"
                ),
                location=site["location"],
                details=dict(site),
            ))

    # -- silent-upcast: f32/f64 where a bf16/f16 policy never priced it
    if policy in LOW_PRECISION_DTYPES:
        policy_bytes = _DTYPE_BYTES[policy]
        for node in nodes:
            if not is_collective(node) or not node.reads:
                continue
            payload = sum(r.bytes for r in node.reads)
            dtype = node.reads[0].dtype
            if dtype in ("f32", "f64") and payload >= UPCAST_BYTES_FLOOR:
                extra = payload - payload * policy_bytes // _DTYPE_BYTES[dtype]
                findings.append(Finding(
                    pass_name="numerics", rule="silent-upcast",
                    severity=SEVERITY_ERROR, target=target,
                    message=(
                        f"{dtype} payload ({payload} B) crosses a {node.kind} under "
                        f"a declared {policy} policy — {extra} B/device of wire per "
                        f"call the plan never priced; cast to {policy} before the "
                        "collective or declare the upcast in the expectation"
                    ),
                    location=_loc(node),
                    details={"kind": node.kind, "dtype": dtype, "payload_bytes": payload,
                             "extra_bytes": extra, "execution_count": 1},
                ))
        for buf in dict.fromkeys(cap.state_buffers):
            info = cap.buffers[buf]
            if info.dtype in ("f32", "f64") and info.nbytes >= UPCAST_BYTES_FLOOR:
                extra = info.nbytes - info.nbytes * policy_bytes // _DTYPE_BYTES[info.dtype]
                details: dict[str, Any] = {"dtype": info.dtype, "carry_bytes": info.nbytes,
                                           "extra_bytes": extra}
                pct = ""
                if peak_live_bytes:
                    details["peak_live_bytes"] = peak_live_bytes
                    pct = f" ({extra / peak_live_bytes:.1%} of the audited peak_live_bytes)"
                findings.append(Finding(
                    pass_name="numerics", rule="silent-upcast",
                    severity=SEVERITY_ERROR, target=target,
                    message=(
                        f"{info.dtype} state tensor ({info.nbytes} B) is resident "
                        f"across every call under a declared {policy} policy — "
                        f"{extra} B of unpriced state{pct}; hold the {policy} "
                        "representation and upcast inside the call"
                    ),
                    details=details,
                ))

    # -- quantise-roundtrip
    for node in nodes:
        conv = _convert(node)
        if conv is None:
            continue
        src, dst, _ = conv
        if dst not in QUANT_DTYPES or not _is_fp(src):
            continue
        dq = _find_dequant(nodes, node)
        if dq is not None:
            dq_src, dq_dst, _ = _convert(dq)
            findings.append(Finding(
                pass_name="numerics", rule="quantise-roundtrip",
                severity=SEVERITY_ERROR, target=target,
                message=(
                    f"dequantise ({dq_src} -> {dq_dst} at {_loc(dq)}) feeds "
                    f"straight back into quantise ({src} -> {dst}) through "
                    "scaling/layout ops only — the roundtrip does no arithmetic "
                    "work and adds a rounding; keep the wire representation "
                    "across the hop"
                ),
                location=_loc(node),
                details={"quantise": _loc(node), "dequantise": _loc(dq), "wire_dtype": dst},
            ))

    # -- nondeterministic-reduction: fp reduction order on the wire
    nondet = 0
    for node in nodes:
        if node.kind not in ("all-reduce", "reduce-scatter") or node.merged:
            continue
        dtype = node.reads[0].dtype if node.reads else ""
        op = node.args.get("reduce_op")
        if (_is_fp(dtype) and (node.group_size or 0) > 1
                and (op is None or op in _ORDERED_REDUCE_OPS)):
            nondet += 1
            if expectation.expect_bitwise_reproducible:
                findings.append(Finding(
                    pass_name="numerics", rule="nondeterministic-reduction",
                    severity=SEVERITY_ERROR, target=target,
                    message=(
                        f"fp {dtype} {node.kind} over {node.group_size} ranks: the "
                        "reduction order is the backend's, so results are not "
                        "bitwise reproducible across runs and topologies — the "
                        "target claims bitwise reproducibility "
                        "(expect_bitwise_reproducible); drop the claim or reduce "
                        "in integer/fixed-point"
                    ),
                    location=_loc(node),
                    details={"kind": node.kind, "dtype": dtype,
                             "group_size": node.group_size},
                ))

    # -- policy-conformance: arguments, short accumulations, any f64
    if policy:
        f64_locs = [_loc(node) for node in nodes
                    if any(t.dtype == "f64" for t in (*node.reads, *node.outputs))]
        if f64_locs:
            findings.append(Finding(
                pass_name="numerics", rule="policy-conformance",
                severity=SEVERITY_ERROR, target=target,
                message=(
                    f"{len(f64_locs)} f64 op(s) in a call whose declared policy is "
                    f"{policy} — a float64 value (a numpy array, a dtype=float64) "
                    f"leaked into the call; first: {f64_locs[0]}"
                ),
                location=f64_locs[0],
                details={"count": len(f64_locs), "locations": f64_locs[:top_n]},
            ))
        for number, buf in enumerate(cap.arg_buffers):
            info = cap.buffers[buf]
            if (_is_fp(info.dtype) and _precision(info.dtype) < policy_prec
                    and info.nbytes >= POLICY_BYTES_FLOOR):
                findings.append(Finding(
                    pass_name="numerics", rule="policy-conformance",
                    severity=SEVERITY_ERROR, target=target,
                    message=(
                        f"parameter arg{number} stores {info.nbytes} B as "
                        f"{info.dtype}, below the declared {policy} policy — "
                        "params/activations must carry at least policy precision "
                        "(f32 master copies above a low policy are fine; storage "
                        "below it is silent quantisation)"
                    ),
                    location=f"arg{number}",
                    details={"dtype": info.dtype, "bytes": info.nbytes, "policy": policy},
                ))
        for site in sites:
            if (_precision(site["dtype"]) < policy_prec
                    and site["elements"] < LOW_PRECISION_ACCUM_FLOOR):
                findings.append(Finding(
                    pass_name="numerics", rule="policy-conformance",
                    severity=SEVERITY_ERROR, target=target,
                    message=(
                        f"{site['dtype']} accumulator on a {site['kind']} under a "
                        f"declared {policy} policy (short reduction, "
                        f"n={site['elements']}) — accumulators must carry at least "
                        "policy precision"
                    ),
                    location=site["location"],
                    details=dict(site, policy=policy),
                ))

    # -- convert-churn: identity converts and widening roundtrips
    readers: dict[int, set[int]] = {}
    for node in nodes:
        for r in node.reads:
            readers.setdefault(r.buf, set()).add(node.index)
    convert_count = 0
    for node in nodes:
        conv = _convert(node)
        if conv is None:
            continue
        convert_count += 1
        src, dst, identity = conv
        if identity:
            findings.append(Finding(
                pass_name="numerics", rule="convert-churn",
                severity=SEVERITY_ERROR, target=target,
                message=f"identity convert {src} -> {dst}: a dead cast",
                location=_loc(node),
                details={"chain": [src, dst]},
            ))
            continue
        ref = _first_read(node, "src") if _base(node.op) == "copy_" else _first_read(node, "self")
        if ref is None or ref.writer < 0:
            continue
        inner = nodes[ref.writer]
        inner_conv = _convert(inner)
        if inner_conv is None:
            continue
        gsrc, mid, _ = inner_conv
        if not (gsrc == dst and _is_fp(gsrc) and _is_fp(mid)
                and _precision(mid) >= _precision(gsrc)):
            continue
        # a narrowing middle is a deliberate clamp; a widening middle read
        # elsewhere is a shared upcast — only a single-use widening pair is churn
        if len(readers.get(ref.buf, ())) > 1:
            continue
        findings.append(Finding(
            pass_name="numerics", rule="convert-churn",
            severity=SEVERITY_ERROR, target=target,
            message=(
                f"redundant convert chain {gsrc} -> {mid} -> {dst}: the widening "
                "intermediate has no other reader, so the roundtrip is a no-op "
                "pair of casts"
            ),
            location=_loc(node),
            details={"chain": [gsrc, mid, dst], "intermediate": _loc(inner)},
        ))

    sites_sorted = sorted(sites, key=lambda s: (s["bound_tree"], s["elements"]),
                          reverse=True)
    meta: dict[str, Any] = {
        "numerics_schema": NUMERICS_REPORT_SCHEMA,
        "policy_dtype": policy,
        "fp_dtypes": sorted(fp_dtypes),
        "reduction_sites": len(sites),
        "max_reduction_elems": max_elems,
        "nondeterministic_reductions": nondet,
        "numerics_low_precision_sites": low_precision_sites,
        "numerics_convert_count": convert_count,
        "numerics_max_rel_error_bound": max_bound_tree,
        "sites": sites_sorted[:top_n],
    }
    return findings, meta


# ---------------------------------------------------------------------------
# manifest and Prometheus surface (`analyze numerics --output DIR`)
# ---------------------------------------------------------------------------


def numerics_metrics(numerics: dict[str, dict], registry=None):
    """The numerics audit as gauges: per-target worst error bound,
    low-precision site count and convert count (JAX's)."""
    from dlbb_tpu_torch.obs.export import MetricsRegistry

    registry = registry or MetricsRegistry()
    for target in sorted(numerics):
        meta = numerics[target]
        registry.set_gauge(
            "analysis_numerics_max_rel_error_bound",
            meta.get("numerics_max_rel_error_bound", 0.0),
            help="worst analytic tree-order accumulation error bound "
                 "(relative, vs sum|x_i|) over the target's fp "
                 "reduction sites",
            target=target,
        )
        registry.set_gauge(
            "analysis_numerics_low_precision_sites",
            meta.get("numerics_low_precision_sites", 0),
            help="bf16/f16 accumulation sites at or above the "
                 "LOW_PRECISION_ACCUM_FLOOR",
            target=target,
        )
        registry.set_gauge(
            "analysis_numerics_convert_count",
            meta.get("numerics_convert_count", 0),
            help="execution-weighted convert instructions in the "
                 "lowered module",
            target=target,
        )
    registry.set_gauge("analysis_numerics_targets", len(numerics),
                       help="targets the numerics audit covered")
    return registry


def write_numerics_artifacts(numerics: dict[str, dict], out_dir: "str | Path") -> Path:
    """``numerics_audit.json`` under ``out_dir``, the aggregate merged into
    its ``sweep_manifest.json`` and the gauges folded into its
    ``metrics.prom`` (the memory audit's convention)."""
    from dlbb_tpu_torch.analysis.memory_audit import _merge_manifest
    from dlbb_tpu_torch.utils.config import atomic_write_text

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {"schema": NUMERICS_REPORT_SCHEMA, "targets": numerics,
              "timestamp": time.time()}
    path = atomic_write_text(json.dumps(report, indent=2, sort_keys=True),
                             out_dir / NUMERICS_REPORT_NAME)
    _merge_manifest(out_dir, "numerics-audit", "numerics_audit", {
        "targets_audited": len(numerics),
        "max_rel_error_bound": {t: numerics[t].get("numerics_max_rel_error_bound")
                                for t in sorted(numerics)},
        "low_precision_sites": {t: numerics[t].get("numerics_low_precision_sites")
                                for t in sorted(numerics)},
    })
    numerics_metrics(numerics).fold_textfile(out_dir / "metrics.prom")
    return path
