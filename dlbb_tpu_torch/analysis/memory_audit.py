"""The static memory auditor: buffer liveness and peak live bytes
(counterpart of ``dlbb_tpu/analysis/memory_audit.py``).

The collective audit proves *what* a call sends, the schedule audit
*when*; this pass proves *how much memory* the call needs.  JAX runs a
buffer-liveness analysis over the compiled module; the port runs JAX's
definition over the captured graph (``op_capture.py``), not the caching
allocator's accounting:

- a buffer is one allocation (a storage), charged its bytes once; a view
  is no allocation and keeps its base alive (JAX's ``ALIAS_OPCODES``),
  since every read of a view is a read of its base's buffer;
- a buffer is live from the node that defines it to its last reader or
  writer; the call's arguments, and any buffer it reads that was made
  before it and outlives it (state a target holds outside its arguments),
  are live for the whole call, its outputs from their definition to the
  end.  A buffer that no recorded op made and that does not outlive the
  call was made inside it where the dispatcher does not see (gloo's
  staging copy of a reduce-scatter, a Python constant): it is live from
  its first use to its last;
- donation: a state tensor (``StateSpec``) that kept its storage across
  the call is donated: it stays resident to the end and the output that
  reuses it is the same buffer, charged zero beyond it, so state is never
  double-counted;
- only buffers on the device of the call's arguments count: on the card a
  gloo hop's host staging buffers (``parallel/ring.py``) are host memory.

Per target the pass reports ``peak_live_bytes``, the live set at the peak,
a top-N transient table, and ``hbm_headroom_bytes`` / ``feasible`` against
the cost tier's capacity.  Eager torch materialises each intermediate that
XLA would fuse away, so a ceiling set for a fused program can be tight for
an eager one; the ceilings stay JAX's.

Rules (JAX's five):

- ``peak-memory-ceiling`` — ``TargetExpectation.max_peak_bytes`` exceeded;
- ``unaliased-donation`` — the target names state tensors (or expects
  donation) but fewer of them kept their storage: input and output state
  are resident at once;
- ``transient-replicated-buffer`` — on a target of more than one rank, a
  transient at least ``num_devices`` x larger than every operand that feeds
  it and than a consumer that shrinks it back (collectives are exempt;
  buffers under ``REPLICATED_FLOOR_BYTES`` are ignored);
- ``serving-cache-drift`` — the donated bytes disagree with
  ``donated_bytes_expected`` beyond the tolerance;
- ``hbm-infeasible`` — warning: the peak exceeds the tier's capacity.

The module imports neither torch nor the JAX package.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.analysis.costmodel import CostTier, hbm_headroom_bytes, memory_feasible
from dlbb_tpu_torch.analysis.expectations import TargetExpectation
from dlbb_tpu_torch.analysis.findings import SEVERITY_ERROR, SEVERITY_WARNING, Finding

# transient-replicated-buffer floor: intermediates below this are noise
REPLICATED_FLOOR_BYTES = 1 << 20

MEMORY_REPORT_SCHEMA = "dlbb_memory_audit_v1"
MEMORY_REPORT_NAME = "memory_audit.json"


@dataclass
class _Buffer:
    """One allocation with its live range."""

    buf: int
    index: int                  # defining node (-1: an argument)
    name: str
    opcode: str
    bytes: int
    last_use: int
    is_param: bool = False
    parameter_number: Optional[int] = None
    donated: bool = False


def _node_name(node) -> str:
    return f"{node.op.split('::', 1)[-1]}.{node.index}"


def liveness(cap) -> tuple[list[_Buffer], int]:
    """The charged buffers of a captured call on its device, with their
    live ranges, and the number of nodes."""
    nodes = cap.nodes
    n = len(nodes)
    first: dict[int, int] = {}
    last: dict[int, int] = {}
    for node in nodes:
        for t in (*node.reads, *node.outputs):
            first.setdefault(t.buf, node.index)
            last[t.buf] = node.index
    params = {b: i for i, b in enumerate(cap.arg_buffers)}
    outputs = set(cap.out_buffers)
    donated = set(cap.donated_buffers)
    out: list[_Buffer] = []
    for buf, info in cap.buffers.items():
        if info.device != cap.device:
            continue
        if buf not in params and info.defined_at < 0:
            if buf not in last:
                continue  # a buffer the call never touched
            if buf not in cap.outlived:
                # made inside the call out of the dispatcher's sight
                out.append(_Buffer(buf=buf, index=first[buf], name=f"unseen{buf}",
                                   opcode=nodes[first[buf]].op, bytes=info.nbytes,
                                   last_use=n if buf in outputs else last[buf]))
                continue
        is_param = buf in params or info.defined_at < 0
        if is_param:
            number = params.get(buf)
            name = f"arg{number}" if number is not None else f"captured{buf}"
            b = _Buffer(buf=buf, index=-1, name=name, opcode="parameter",
                        bytes=info.nbytes, last_use=n, is_param=True,
                        parameter_number=number, donated=buf in donated)
        else:
            node = nodes[info.defined_at]
            b = _Buffer(buf=buf, index=info.defined_at, name=_node_name(node),
                        opcode=node.op, bytes=info.nbytes,
                        last_use=n if buf in outputs else last.get(buf, info.defined_at))
        out.append(b)
    out.sort(key=lambda b: (max(b.index, 0), b.buf))
    return out, n


def sweep(buffers: list[_Buffer], n: int) -> tuple[int, int]:
    """(peak live bytes, the node at the peak) over the call's nodes."""
    if n == 0:
        return sum(b.bytes for b in buffers if b.is_param), 0
    delta = [0] * (n + 1)
    base = 0
    for b in buffers:
        hi = min(b.last_use, n - 1)
        if b.index < 0:
            base += b.bytes
        else:
            delta[b.index] += b.bytes
        delta[hi + 1] -= b.bytes
    live, peak, peak_k = base, 0, 0
    for k in range(n):
        live += delta[k]
        if live > peak:
            peak, peak_k = live, k
    return peak, peak_k


def _check_replicated(cap, buffers: list[_Buffer], n: int, num_devices: int,
                      target: str, findings: list[Finding],
                      floor: int = REPLICATED_FLOOR_BYTES) -> None:
    if num_devices <= 1:
        return
    nodes = cap.nodes
    consumers: dict[int, list[int]] = {}
    for node in nodes:
        for r in node.reads:
            consumers.setdefault(r.buf, []).append(node.index)
    for b in buffers:
        if (b.is_param or b.bytes < floor or b.last_use >= n
                or cap.buffers[b.buf].defined_at != b.index):
            continue  # an argument, small, an output, or made out of sight
        node = nodes[b.index]
        if node.kind is not None or not node.reads:
            # a collective's P x growth is its job; a fill materialises
            # from nothing
            continue
        max_operand = max(r.bytes for r in node.reads)
        if max_operand * num_devices > b.bytes:
            continue  # producer not sharded relative to this buffer
        shrunk = [nodes[c] for c in dict.fromkeys(consumers.get(b.buf, ()))
                  if c != b.index
                  and sum(t.bytes for t in nodes[c].outputs) * num_devices <= b.bytes]
        if not shrunk:
            continue
        findings.append(Finding(
            pass_name="memory",
            rule="transient-replicated-buffer",
            severity=SEVERITY_ERROR,
            target=target,
            message=(
                f"{node.op} {b.name} materialises {b.bytes} B/device — at least "
                f"{num_devices}x every operand that feeds it, and consumer "
                f"{_node_name(shrunk[0])} shrinks it back by the same factor: a "
                "full-size replicated intermediate between sharded producer and "
                "consumer (the transient memory spike class); create the value "
                "directly in its shard instead of materialising the replicated copy"
            ),
            details={
                "name": b.name,
                "opcode": node.op,
                "bytes": b.bytes,
                "max_operand_bytes": max_operand,
                "num_devices": num_devices,
                "computation": target,
                "shrinking_consumers": [_node_name(c) for c in shrunk],
            },
        ))


def analyze_memory(
    cap,
    expectation: TargetExpectation,
    target: str,
    num_devices: int = 1,
    tier: Optional[CostTier] = None,
    top_n: int = 8,
) -> tuple[list[Finding], dict]:
    """The buffer-liveness audit of one captured call.  Returns the findings
    and the per-target memory meta (JAX's keys)."""
    findings: list[Finding] = []
    buffers, n = liveness(cap)
    peak, peak_k = sweep(buffers, n)

    param_bytes = sum(b.bytes for b in buffers if b.is_param)
    donated_bytes = sum(b.bytes for b in buffers if b.is_param and b.donated)
    output_bytes = sum(b.bytes for b in buffers
                       if not b.is_param and b.last_use >= n and b.bytes > 0)
    any_donated = any(b.donated for b in buffers)
    donated_params = [
        {"name": b.name, "parameter_number": b.parameter_number, "bytes": b.bytes,
         "aliased": b.donated}
        for b in buffers if b.is_param and (b.donated or any_donated)
    ]
    live_at_peak = sorted(
        ({"name": b.name, "opcode": b.opcode, "bytes": b.bytes}
         for b in buffers if b.bytes > 0 and b.index <= peak_k <= b.last_use),
        key=lambda r: (-r["bytes"], r["name"]),
    )
    transients = sorted(
        ({"name": b.name, "opcode": b.opcode, "bytes": b.bytes, "computation": target,
          "execution_count": 1, "source": None}
         for b in buffers if not b.is_param and b.bytes > 0 and b.last_use < n),
        key=lambda r: (-r["bytes"], r["name"]),
    )
    meta: dict[str, Any] = {
        "peak_live_bytes": int(peak),
        "peak_instruction": _node_name(cap.nodes[peak_k]) if 0 <= peak_k < n else None,
        "parameter_bytes": int(param_bytes),
        "donated_param_bytes": int(donated_bytes),
        "output_bytes": int(output_bytes),
        "num_buffers": sum(1 for b in buffers if b.bytes > 0 or b.is_param),
        "donated_params": donated_params,
        "live_at_peak": live_at_peak[:top_n],
        "top_transients": transients[:top_n],
        "max_transient_bytes": int(transients[0]["bytes"]) if transients else 0,
    }
    if tier is not None:
        meta["hbm_bytes"] = int(tier.hbm_bytes) or None
        meta["hbm_headroom_bytes"] = hbm_headroom_bytes(peak, tier)
        meta["feasible"] = memory_feasible(peak, tier)
        if meta["feasible"] is False:
            findings.append(Finding(
                pass_name="memory", rule="hbm-infeasible",
                severity=SEVERITY_WARNING, target=target,
                message=(
                    f"audited peak {peak} B/device exceeds the {tier.name} tier's "
                    f"recorded capacity of {int(tier.hbm_bytes)} B — this call "
                    "runs out of memory on that hardware; a plan search must "
                    "prune it"
                ),
                details={"peak_live_bytes": peak, "hbm_bytes": int(tier.hbm_bytes)},
            ))

    if expectation.max_peak_bytes is not None and peak > expectation.max_peak_bytes:
        findings.append(Finding(
            pass_name="memory", rule="peak-memory-ceiling",
            severity=SEVERITY_ERROR, target=target,
            message=(
                f"peak live bytes {peak} B/device exceed the plan ceiling of "
                f"{expectation.max_peak_bytes} B — the call keeps more resident "
                "than the analytic model (params + state + activations + cache) "
                "accounts for; inspect live_at_peak/top_transients for the buffer "
                "the plan does not know about"
            ),
            details={
                "peak_live_bytes": int(peak),
                "max_peak_bytes": expectation.max_peak_bytes,
                "live_at_peak": live_at_peak[:top_n],
            },
        ))

    donors = len(cap.state_buffers)
    aliased = sum(1 for p in donated_params if p["aliased"])
    expected_donors = donors or (1 if expectation.expect_donation else 0)
    if expected_donors and aliased < expected_donors:
        findings.append(Finding(
            pass_name="memory", rule="unaliased-donation",
            severity=SEVERITY_ERROR, target=target,
            message=(
                f"{donors} state tensor(s) named (expectation demands >= "
                f"{expected_donors}) but only {aliased} kept its storage across "
                "the call — the state was reallocated, so input AND output state "
                "stay resident at once"
            ),
            details={"donor_markers": donors, "aliased_parameters": aliased,
                     "donated_params": donated_params},
        ))

    _check_replicated(cap, buffers, n, num_devices, target, findings)

    if expectation.donated_bytes_expected is not None:
        expected = expectation.donated_bytes_expected
        tol = expectation.donated_bytes_tolerance
        if abs(donated_bytes - expected) > tol * expected:
            findings.append(Finding(
                pass_name="memory", rule="serving-cache-drift",
                severity=SEVERITY_ERROR, target=target,
                message=(
                    f"donated state sums to {donated_bytes} B/device but the "
                    f"analytic model (kv_cache_bytes_per_device) prices {expected} B "
                    f"(tolerance {tol:.0%}) — the budget gate and the call disagree "
                    "about the cache footprint; fix whichever drifted and re-pin"
                ),
                details={"donated_param_bytes": int(donated_bytes),
                         "expected_bytes": expected, "tolerance": tol,
                         "donated_params": donated_params},
            ))
        meta["analytic_donated_bytes"] = expected
    return findings, meta


# ---------------------------------------------------------------------------
# manifest and Prometheus surface (`analyze memory --output DIR`)
# ---------------------------------------------------------------------------


def memory_metrics(memory: dict[str, dict], tier: Optional[CostTier] = None,
                   registry=None):
    """The memory audit as gauges: one ``analysis_peak_live_bytes{target}``
    per audited target (and its headroom where the tier records capacity),
    and ``analysis_memory_targets`` (JAX's)."""
    from dlbb_tpu_torch.obs.export import MetricsRegistry

    registry = registry or MetricsRegistry()
    tier_label = tier.name if tier is not None else "unknown"
    for target in sorted(memory):
        meta = memory[target]
        registry.set_gauge(
            "analysis_peak_live_bytes", meta.get("peak_live_bytes", 0),
            help="statically audited per-device peak live bytes "
                 "(buffer-liveness pass)",
            target=target, tier=tier_label,
        )
        headroom = meta.get("hbm_headroom_bytes")
        if headroom is not None:
            registry.set_gauge(
                "analysis_hbm_headroom_bytes", headroom,
                help="tier capacity minus audited peak",
                target=target, tier=tier_label,
            )
    registry.set_gauge("analysis_memory_targets", len(memory),
                       help="targets the memory audit covered", tier=tier_label)
    return registry


def _merge_manifest(out_dir: Path, kind: str, key: str, payload: dict) -> None:
    """Merge ``payload`` under ``key`` into the directory's
    ``sweep_manifest.json`` (a torn manifest is rewritten)."""
    from dlbb_tpu_torch.bench.schedule import MANIFEST_NAME, MANIFEST_SCHEMA
    from dlbb_tpu_torch.utils.config import save_json

    manifest_path = out_dir / MANIFEST_NAME
    manifest: dict[str, Any] = {"schema": MANIFEST_SCHEMA, "kind": kind}
    if manifest_path.exists():
        try:
            manifest = json.loads(manifest_path.read_text())
        except (OSError, json.JSONDecodeError):
            pass
    manifest[key] = payload
    manifest.setdefault("timestamp", time.time())
    save_json(manifest, manifest_path)


def write_memory_artifacts(memory: dict[str, dict], out_dir: "str | Path",
                           tier: Optional[CostTier] = None) -> Path:
    """``memory_audit.json`` under ``out_dir``, the aggregate merged into
    its ``sweep_manifest.json`` and the gauges folded into its
    ``metrics.prom`` without clobbering a co-located export (JAX's)."""
    from dlbb_tpu_torch.utils.config import atomic_write_text

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {
        "schema": MEMORY_REPORT_SCHEMA,
        "tier": tier.name if tier is not None else None,
        "cost_model_version": tier.version if tier is not None else None,
        "targets": memory,
        "timestamp": time.time(),
    }
    path = atomic_write_text(json.dumps(report, indent=2, sort_keys=True),
                             out_dir / MEMORY_REPORT_NAME)
    _merge_manifest(out_dir, "memory-audit", "memory_audit", {
        "tier": tier.name if tier is not None else None,
        "cost_model_version": tier.version if tier is not None else None,
        "targets_audited": len(memory),
        "peak_live_bytes": {t: memory[t].get("peak_live_bytes") for t in sorted(memory)},
    })
    memory_metrics(memory, tier).fold_textfile(out_dir / "metrics.prom")
    return path
