"""The schedule auditor: α–β critical path and overlap proof (counterpart
of ``dlbb_tpu/analysis/schedule_audit.py``).

The collective audit (``hlo_audit``) proves *which* collectives a call
issues and *how many bytes* they move; this pass proves *when* they run.
JAX walks the dependency graph of the compiled HLO module; the port walks
the dataflow graph of the captured call (``op_capture.py``: one node per
op, an edge from the last writer of each buffer read, and from the readers
of a buffer to the op that overwrites it).  Per audit target:

- **Pricing** (``node_flops``): a product node costs ``2·M·N·K`` flops at
  the tier's peak (JAX's ``_dot_flops``), a flash kernel node its own
  visible-pair flops (``ops/flash_attention.kernel_flops``), a collective
  ``α(tier) + wire_bytes/β(tier)`` (the analytic ring wire volume,
  ``expectations.wire_bytes``), a hop's wait nothing (the transfer is
  charged to the hop, as XLA's ``-done`` costs nothing), and every other
  op nothing: elementwise work never hides communication (JAX's
  ``_instr_flops``).  The products are the ops eager torch lowers
  ``matmul``, ``linear``, ``einsum`` and their gradients to, with the
  operands that carry the contraction:

  =========================  ================================  ===========
  op                         operands                          flops
  =========================  ================================  ===========
  ``mm``                     ``self [M,K]``, ``mat2 [K,N]``    2MNK
  ``addmm``                  ``mat1 [M,K]``, ``mat2 [K,N]``    2MNK
  ``bmm``                    ``self [B,M,K]``, ``mat2``        2BMNK
  ``baddbmm``, ``addbmm``    ``batch1``, ``batch2``            2BMNK
  ``mv``, ``addmv``          ``[M,K]``, ``vec [K]``            2MK
  ``dot``, ``vdot``          ``[K]``, ``[K]``                  2K
  ``matmul``, ``linear``     ``[..., K]`` and the other        2·out·K
  ``einsum``                 the equation's operands           2·out·Πc
  ``flash::*``               the kernel's count                its own
  =========================  ================================  ===========

  ``matmul``, ``linear`` and ``einsum`` are composite: under autograd they
  reach the capture as the ``mm``/``bmm`` they lower to, under
  ``torch.inference_mode`` whole (``out`` is the result's elements, ``Πc``
  the product of the equation's contracted sizes).
  The ``.out`` forms price as theirs.
- **Critical path**: ASAP longest-path arrival times over the graph, the
  comm time along the argmax path, priced by ``analysis/costmodel.py``
  (``collective_cost_us``, ``compute_cost_us``, ``dispatch_cost_us``,
  ``resolve_tier``).  One call of the target is one dispatch.
- **Overlap**: for every collective, the product nodes that are neither
  its ancestors nor its descendants (ancestor bitsets), restricted for a
  posted ring hop to the nodes strictly between the hop and its wait
  (``parallel/ring.py::Hop.wait``), JAX's async window.  A ring hop with
  zero straddling flops is a ``serialized-collective`` finding on targets
  whose expectation claims overlap (``expect_overlap``).  JAX marks ring
  hops by a name-stack scope; the port by the hop's call site: a permute
  issued from ``parallel/collective_matmul.py`` is a ring hop, one issued
  from ``comm/compression.py`` a quantised-ring hop, which is exempt (its
  dequantise-accumulate-requantise chain is sequential by design).
- **Divergent collectives**: eager torch has no ``conditional``, so the
  rule cannot compare branches of one program.  Its port compares ranks:
  the audit's launch gathers each rank's ordered sequence of (kind, group
  size, group) (``collective_signature``) and rank 0 checks that any two
  ranks post the same sequence on the groups they both belong to
  (``check_divergent_ranks``), giving JAX's
  ``divergent-branch-collectives`` where they differ, since such ranks
  would post mismatched collectives and hang.  A rank off the target's
  mesh, and a group a rank does not belong to, are left out (a prefill
  runs on the tp group that holds its slot only).
- **Regression baselines**: per-target snapshots under
  ``stats/torch/analysis/baselines/`` (never JAX's directory: they price
  the port's graphs), ``snapshot_baselines``, ``load_baselines`` and
  ``diff_baselines`` with JAX's slacks, copied whole.

The module imports neither torch nor the JAX package.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from dlbb_tpu_torch.analysis.costmodel import (
    COST_MODEL_VERSION,
    CostTier,
    collective_cost_us,
    compute_cost_us,
    dispatch_cost_us,
    resolve_tier,
)
from dlbb_tpu_torch.analysis.expectations import TargetExpectation, wire_bytes
from dlbb_tpu_torch.analysis.findings import (
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    Finding,
)
from dlbb_tpu_torch.analysis.op_capture import WAIT_OP

# the call site that marks JAX's ``ring_hop`` scope (module docstring)
RING_HOP_SITE = "dlbb_tpu_torch/parallel/collective_matmul.py"

# baseline-gate thresholds: growth beyond these fails `analyze diff`
CRITICAL_PATH_SLACK = 1.10
WIRE_SLACK = 1.10
# memory axis (memory_audit.py): the same 10 % contract on peak live bytes
# and on the largest transient buffer
PEAK_MEMORY_SLACK = 1.10
# numerics axis (numerics_audit.py): the worst-case relative error bound
# moves only with reduction shape or accumulator dtype, so 2x absorbs
# shape jitter while any precision downgrade still trips; convert churn
# gets 25 % headroom
NUMERICS_ERROR_SLACK = 2.0
NUMERICS_CONVERT_SLACK = 1.25

DEFAULT_BASELINE_DIR = Path("stats/torch/analysis/baselines")


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

# op (without its overload) -> (the left operand, the right operand)
_PRODUCTS = {
    "mm": ("self", "mat2"),
    "addmm": ("mat1", "mat2"),
    "bmm": ("self", "mat2"),
    "baddbmm": ("batch1", "batch2"),
    "addbmm": ("batch1", "batch2"),
    "mv": ("self", "vec"),
    "addmv": ("mat", "vec"),
    "dot": ("self", "tensor"),
    "vdot": ("self", "other"),
    "matmul": ("self", "other"),
    "linear": ("input", "weight"),
}


def _op_base(op: str) -> str:
    """``aten::mm.out`` -> ``mm``."""
    return op.split("::", 1)[-1].split(".", 1)[0]


def _einsum_sizes(node) -> Optional[tuple[dict, str]]:
    """({letter: size}, the output's letters) of an ``einsum`` node."""
    eq = str(node.args.get("equation") or "").replace(" ", "")
    if "->" not in eq:
        return None
    lhs, out = eq.split("->")
    operands = [r for r in node.reads if r.arg == "tensors"]
    specs = lhs.split(",")
    if len(specs) != len(operands):
        return None
    sizes: dict[str, int] = {}
    for spec, ref in zip(specs, operands):
        head, _, tail = spec.partition("...")
        for i, c in enumerate(head):
            sizes[c] = ref.shape[i]
        for i, c in enumerate(reversed(tail)):
            sizes[c] = ref.shape[len(ref.shape) - 1 - i]
    return sizes, out.replace("...", "")


def product_operands(node):
    """The (left, right) operand refs of a product node, or None."""
    if node.op.startswith("aten::einsum"):
        operands = [r for r in node.reads if r.arg == "tensors"]
        return (operands[0], operands[-1]) if _einsum_sizes(node) and operands else None
    names = _PRODUCTS.get(_op_base(node.op)) if node.op.startswith("aten::") else None
    if names is None:
        return None
    by_arg = {r.arg: r for r in node.reads}
    lhs, rhs = by_arg.get(names[0]), by_arg.get(names[1])
    if lhs is None or rhs is None:
        return None
    return lhs, rhs


def node_flops(node) -> int:
    """Dense flops of one node (module docstring); 0 for everything that is
    not a product or a kernel."""
    if node.flops:
        return int(node.flops)
    ops = product_operands(node)
    if ops is None:
        return 0
    lhs, rhs = ops
    base = _op_base(node.op)
    if base in ("matmul", "linear", "einsum"):
        out = node.outputs[0].numel if node.outputs else 0
        return 2 * out * contraction_length(node)
    if base in ("dot", "vdot"):
        return 2 * lhs.numel
    if base in ("mv", "addmv"):
        return 2 * lhs.numel
    if base in ("mm", "addmm"):
        m, k = lhs.shape
        return 2 * m * k * rhs.shape[-1]
    b, m, k = lhs.shape
    return 2 * b * m * k * rhs.shape[-1]


def contraction_length(node) -> int:
    """K of a product node (the accumulation length of its sums), 0 for
    any other node."""
    ops = product_operands(node)
    if ops is None:
        return 0
    if _op_base(node.op) == "einsum":
        sizes, out = _einsum_sizes(node)
        k = 1
        for c, n in sizes.items():
            if c not in out:
                k *= n
        return k
    return int(ops[0].shape[-1]) if ops[0].shape else 0


def node_wire(node) -> int:
    return wire_bytes(node.kind, node.result_bytes, node.group_size)


def is_collective(node) -> bool:
    """A node that moves data between ranks (a permute pair's earlier op
    and a wait are not)."""
    return node.kind is not None and not node.merged


# ---------------------------------------------------------------------------
# the graph analysis
# ---------------------------------------------------------------------------


@dataclass
class _Stats:
    critical_path_us: float = 0.0
    comm_on_cp_us: float = 0.0
    comm_total_us: float = 0.0
    compute_total_us: float = 0.0
    hidden_comm_us: float = 0.0


def ancestor_sets(nodes) -> list[int]:
    """Each node's ancestors as a bitset (the graph is in execution order:
    every edge points back)."""
    anc = [0] * len(nodes)
    for n, node in enumerate(nodes):
        a = 0
        for d in node.deps:
            a |= anc[d] | (1 << d)
        anc[n] = a
    return anc


def _analyze(nodes, tier: CostTier, target: str) -> tuple[_Stats, list[dict]]:
    n_nodes = len(nodes)
    flops = [node_flops(node) for node in nodes]
    costs: list[tuple[float, float]] = []
    for node, f in zip(nodes, flops):
        if is_collective(node):
            c = collective_cost_us(node_wire(node), tier)
            costs.append((c, c))
        elif f:
            costs.append((compute_cost_us(f, tier), 0.0))
        else:
            costs.append((0.0, 0.0))
    anc = ancestor_sets(nodes)

    finish = [0.0] * n_nodes
    comm_on_path = [0.0] * n_nodes
    for n, node in enumerate(nodes):
        start = comm = 0.0
        for d in node.deps:
            if finish[d] > start:
                start, comm = finish[d], comm_on_path[d]
        finish[n] = start + costs[n][0]
        comm_on_path[n] = comm + costs[n][1]
    stats = _Stats()
    if nodes:
        end = max(range(n_nodes), key=lambda n: finish[n])
        stats.critical_path_us = finish[end]
        stats.comm_on_cp_us = comm_on_path[end]
    stats.compute_total_us = float(sum(compute_cost_us(f, tier) for f in flops if f))

    # a posted hop's wait: the end of its overlap window
    done_pos: dict[int, int] = {}
    for n, node in enumerate(nodes):
        if node.op == WAIT_OP:
            for d in node.deps:
                if is_collective(nodes[d]):
                    done_pos.setdefault(d, n)

    compute = [m for m in range(n_nodes) if flops[m]]
    collectives: list[dict] = []
    for n, node in enumerate(nodes):
        if not is_collective(node):
            continue
        cost = costs[n][0]
        lo, hi = (n + 1, done_pos[n]) if n in done_pos else (0, n_nodes)
        indep_us, indep_flops = 0.0, 0
        for m in compute:
            if m < lo or m >= hi or m == n:
                continue
            if (anc[n] >> m) & 1 or (anc[m] >> n) & 1:
                continue
            indep_us += compute_cost_us(flops[m], tier)
            indep_flops += flops[m]
        site = node.hop_site or ""
        collectives.append({
            "name": f"{node.op.split('::', 1)[1]}.{node.stream_index}",
            "kind": node.kind,
            "cost_us": cost,
            "wire_bytes": node_wire(node),
            "straddling_flops": indep_flops,
            "straddling_compute_us": indep_us,
            "hidden_us": min(cost, indep_us),
            "async": n in done_pos,
            "is_ring_hop": (node.kind == "collective-permute"
                            and site.startswith(RING_HOP_SITE + ":")),
            "op_name": node.op,
            "source": node.source,
            "hop_site": node.hop_site,
            "computation": target,
        })
    stats.comm_total_us = sum(c["cost_us"] for c in collectives)
    stats.hidden_comm_us = sum(c["hidden_us"] for c in collectives)
    return stats, collectives


def schedule_meta(nodes, tier: CostTier, target: str = "") -> dict:
    """The per-target schedule meta (JAX's keys) of a captured graph."""
    stats, collectives = _analyze(nodes, tier, target)
    dispatch_overhead = dispatch_cost_us(1, tier)
    kinds: dict[str, int] = {}
    for c in collectives:
        kinds[c["kind"]] = kinds.get(c["kind"], 0) + 1
    return {
        "cost_model_version": tier.version,
        "tier": tier.name,
        "critical_path_us": round(stats.critical_path_us, 6),
        # the wall prediction for one call: critical path + γ x 1 dispatch
        # (γ = 0 under cm1, the term the cm2 fit supplies)
        "dispatch_count": 1,
        "dispatch_overhead_us": round(dispatch_overhead, 6),
        "predicted_wall_us": round(stats.critical_path_us + dispatch_overhead, 6),
        "comm_on_critical_path_us": round(stats.comm_on_cp_us, 6),
        "comm_total_us": round(stats.comm_total_us, 6),
        "compute_total_us": round(stats.compute_total_us, 6),
        "overlap_efficiency": (round(stats.hidden_comm_us / stats.comm_total_us, 6)
                               if stats.comm_total_us > 0 else None),
        "total_wire_bytes": sum(c["wire_bytes"] for c in collectives),
        "num_collectives": sum(kinds.values()),
        "collective_kinds": dict(sorted(kinds.items())),
        "collectives": collectives,
    }


# ---------------------------------------------------------------------------
# divergent collectives across ranks
# ---------------------------------------------------------------------------


def collective_signature(nodes) -> list[list]:
    """The ordered collectives one rank posted: [kind, group size, group
    name, the group's global ranks] each."""
    out = []
    for node in nodes:
        if is_collective(node):
            name, ranks = node.group or ("", ())
            out.append([node.kind, node.group_size, name, list(ranks)])
    return out


def _shared(sig: list, r: int, s: int) -> list[tuple]:
    """The (kind, group size, group) entries of ``sig`` on the groups that
    hold both ranks ``r`` and ``s``."""
    return [(k, n, g) for k, n, g, ranks in sig if r in ranks and s in ranks]


def check_divergent_ranks(signatures: dict[int, list], target: str) -> list[Finding]:
    """JAX's ``divergent-branch-collectives`` in its port's form: any two
    ranks of one target (``{rank: collective_signature}``, the ranks off
    the target's mesh left out) must post the same sequence on the groups
    they share, or one waits in a collective the other never posts."""
    ranks = sorted(signatures)
    for i, r in enumerate(ranks):
        for s in ranks[i + 1:]:
            a, b = _shared(signatures[r], r, s), _shared(signatures[s], r, s)
            if a == b:
                continue
            return [Finding(
                pass_name="schedule",
                rule="divergent-branch-collectives",
                severity=SEVERITY_ERROR,
                target=target,
                message=(
                    f"rank {r} and rank {s} post different collective sequences on "
                    f"the groups they share ({len(a)} vs {len(b)}) in one call of "
                    "the target — ranks posting mismatched collectives deadlock "
                    "the group; make the sequences identical in kind and order on "
                    "every rank of each group"
                ),
                details={"ranks": {f"rank{r}": [[k, n] for k, n, _ in a],
                                   f"rank{s}": [[k, n] for k, n, _ in b]}},
            )]
    return []


# ---------------------------------------------------------------------------
# the schedule pass (per audit target)
# ---------------------------------------------------------------------------


def analyze_schedule(
    cap,
    expectation: TargetExpectation,
    target: str,
    tier: "Optional[str | CostTier]" = None,
    model: str = COST_MODEL_VERSION,
) -> tuple[list[Finding], dict]:
    """The schedule audit of one captured call (``op_capture.Capture``, or
    its list of nodes).  Returns the findings and the per-target schedule
    meta (the JSON-report and baseline payload).  ``model`` selects cm1 or
    cm2; a resolved :class:`CostTier` may be passed as ``tier``."""
    nodes = getattr(cap, "nodes", cap)
    cost_tier = tier if isinstance(tier, CostTier) else resolve_tier(tier, model=model)
    findings: list[Finding] = []
    meta = schedule_meta(nodes, cost_tier, target)

    if expectation.expect_overlap:
        hops = [c for c in meta["collectives"] if c["is_ring_hop"]]
        if not hops:
            # no hop from the collective matmul (a hand-built fixture): every
            # permute, as JAX falls back (the overlap contract is about the ring)
            hops = [c for c in meta["collectives"] if c["kind"] == "collective-permute"]
        serialized = [c for c in hops if c["straddling_flops"] == 0]
        meta["ring_hops"] = {"total": len(hops), "straddled": len(hops) - len(serialized)}
        for c in serialized:
            findings.append(Finding(
                pass_name="schedule",
                rule="serialized-collective",
                severity=SEVERITY_ERROR,
                target=target,
                message=(
                    f"ring hop {c['name']} ({c['kind']}, {c['wire_bytes']} wire B) "
                    "has no straddling matmul — no dense compute is independent "
                    "of the transfer between its post and its wait, so the hop "
                    "serialises into the critical path and the overlap claim is "
                    "void for this schedule"
                ),
                location=c["hop_site"] or c["source"],
                details={k: c[k] for k in (
                    "name", "kind", "cost_us", "wire_bytes", "straddling_flops",
                    "computation", "op_name")},
            ))
    return findings, meta


# ---------------------------------------------------------------------------
# regression baselines (snapshot / diff gate), JAX's whole
# ---------------------------------------------------------------------------

# keys of the schedule meta that are snapshotted and diffed (the memory
# and numerics gate keys are folded in by analysis.run_analysis: one gate
# file per target)
_BASELINE_KEYS = (
    "cost_model_version", "tier", "critical_path_us",
    "comm_on_critical_path_us", "comm_total_us", "compute_total_us",
    "overlap_efficiency", "total_wire_bytes", "num_collectives",
    "collective_kinds", "peak_live_bytes", "max_transient_bytes",
    "numerics_low_precision_sites", "numerics_convert_count",
    "numerics_max_rel_error_bound",
)


def baseline_path(directory: Path, target: str) -> Path:
    """File for one target's snapshot: the target name slugified (exact
    name kept inside the JSON)."""
    slug = re.sub(r"[^\w.]+", "_", target).strip("_")
    return Path(directory) / f"{slug}.json"


def snapshot_baselines(schedule_meta: dict[str, dict],
                       directory: Path,
                       skipped_targets: tuple[str, ...] = ()) -> list[Path]:
    """Write one baseline JSON per audited target; returns the paths.
    Stale snapshots of targets that no longer exist are removed, but a
    target merely skipped this run (too few ranks) keeps its committed
    baseline."""
    from dlbb_tpu_torch.utils.config import atomic_write_text

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []
    keep = {baseline_path(directory, t).name for t in skipped_targets}
    for target in sorted(schedule_meta):
        meta = schedule_meta[target]
        payload = {"target": target}
        payload.update({k: meta.get(k) for k in _BASELINE_KEYS})
        path = baseline_path(directory, target)
        keep.add(path.name)
        atomic_write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n", path)
        written.append(path)
    for stale in sorted(directory.glob("*.json")):
        if stale.name not in keep:
            stale.unlink()
    return written


def load_baselines(directory: Path) -> dict[str, dict]:
    out: dict[str, dict] = {}
    for path in sorted(Path(directory).glob("*.json")):
        data = json.loads(path.read_text())
        out[data["target"]] = data
    return out


def diff_baselines(
    schedule_meta: dict[str, dict],
    directory: Path,
    skipped_targets: tuple[str, ...] = (),
) -> list[Finding]:
    """Compare one audit run against the committed snapshots.  Errors on
    unexplained growth (> 10 % critical path, wire volume, peak or largest
    transient, numerics drift, any new collective kind or low-precision
    site), on a target with no snapshot, and on cost-model version/tier
    skew; warns when the numbers improved enough that a re-snapshot would
    tighten the gate."""
    findings: list[Finding] = []
    directory = Path(directory)
    baselines = load_baselines(directory) if directory.is_dir() else {}
    if not baselines:
        findings.append(Finding(
            pass_name="schedule", rule="missing-baseline",
            severity=SEVERITY_ERROR, target=str(directory),
            message=(
                f"no committed schedule baselines under {directory} — run "
                "`python -m dlbb_tpu_torch analyze snapshot --simulate 8` and "
                "commit the result"
            ),
        ))
        return findings

    for target in sorted(schedule_meta):
        cur = schedule_meta[target]
        base = baselines.get(target)
        if base is None:
            findings.append(Finding(
                pass_name="schedule", rule="missing-baseline",
                severity=SEVERITY_ERROR, target=target,
                message=(
                    "audited target has no committed baseline snapshot — a new "
                    "target must land with its expectation: run `analyze "
                    f"snapshot` and commit {baseline_path(directory, target)}"
                ),
            ))
            continue
        if (base.get("cost_model_version") != cur.get("cost_model_version")
                or base.get("tier") != cur.get("tier")):
            findings.append(Finding(
                pass_name="schedule", rule="cost-model-mismatch",
                severity=SEVERITY_ERROR, target=target,
                message=(
                    f"baseline priced with cost model {base.get('cost_model_version')}/"
                    f"{base.get('tier')} but this run uses "
                    f"{cur.get('cost_model_version')}/{cur.get('tier')} — numbers "
                    "are not comparable; re-snapshot after a cost-model change"
                ),
            ))
            continue
        new_kinds = sorted(set(cur.get("collective_kinds", {}))
                           - set(base.get("collective_kinds", {})))
        if new_kinds:
            findings.append(Finding(
                pass_name="schedule", rule="new-collective-kind",
                severity=SEVERITY_ERROR, target=target,
                message=(
                    f"collective kind(s) {new_kinds} appear that the baseline does "
                    "not contain — a sharding change introduced a new "
                    "communication pattern; explain it and re-snapshot, or fix "
                    "the sharding"
                ),
                details={
                    "new_kinds": new_kinds,
                    "baseline_kinds": base.get("collective_kinds", {}),
                    "current_kinds": cur.get("collective_kinds", {}),
                },
            ))
        for key, slack, rule in (
            ("critical_path_us", CRITICAL_PATH_SLACK, "critical-path-regression"),
            ("total_wire_bytes", WIRE_SLACK, "wire-volume-regression"),
            ("peak_live_bytes", PEAK_MEMORY_SLACK, "peak-memory-regression"),
            ("max_transient_bytes", PEAK_MEMORY_SLACK, "transient-buffer-regression"),
            ("numerics_max_rel_error_bound", NUMERICS_ERROR_SLACK,
             "numerics-error-regression"),
            ("numerics_convert_count", NUMERICS_CONVERT_SLACK,
             "convert-churn-regression"),
        ):
            b, c = base.get(key), cur.get(key)
            if not b or c is None:
                continue
            if c > b * slack:
                findings.append(Finding(
                    pass_name="schedule", rule=rule,
                    severity=SEVERITY_ERROR, target=target,
                    message=(
                        f"{key} grew {c / b:.2f}x over the committed baseline "
                        f"({b} -> {c}, gate at {slack:.2f}x) — unexplained "
                        + ("memory" if "bytes" in key and "wire" not in key
                           else "schedule")
                        + " regression; investigate, then re-snapshot if the "
                        "growth is intended"
                    ),
                    details={"key": key, "baseline": b, "current": c,
                             "ratio": round(c / b, 4)},
                ))
            elif c < b / slack and key in ("critical_path_us", "peak_live_bytes"):
                findings.append(Finding(
                    pass_name="schedule", rule="baseline-improved",
                    severity=SEVERITY_WARNING, target=target,
                    message=(
                        f"{key} improved {b / max(c, 1e-9):.2f}x under the "
                        "committed baseline — re-snapshot to tighten the "
                        "regression gate"
                    ),
                    details={"key": key, "baseline": b, "current": c},
                ))
        # low-precision accumulation sites gate at exactly zero growth: any
        # new bf16/f16 accumulator is a deliberate precision decision
        b_sites = base.get("numerics_low_precision_sites")
        c_sites = cur.get("numerics_low_precision_sites")
        if b_sites is not None and c_sites is not None and c_sites > b_sites:
            findings.append(Finding(
                pass_name="schedule", rule="new-low-precision-accumulation",
                severity=SEVERITY_ERROR, target=target,
                message=(
                    f"low-precision accumulation sites grew {b_sites} -> {c_sites} "
                    "over the committed baseline — an accumulation dropped below "
                    "f32; confirm the error bound (analyze numerics) and "
                    "re-snapshot if the downgrade is intended"
                ),
                details={"baseline": b_sites, "current": c_sites},
            ))
    audited = set(schedule_meta) | set(skipped_targets)
    for target in sorted(set(baselines) - audited):
        findings.append(Finding(
            pass_name="schedule", rule="stale-baseline",
            severity=SEVERITY_WARNING, target=target,
            message=(
                "committed baseline has no matching audit target — the target "
                "was removed or renamed; run `analyze snapshot` to prune"
            ),
        ))
    return findings
