"""The fp64 shadow cross-check of the static numerics auditor (counterpart
of ``dlbb_tpu/analysis/numerics_shadow.py``).

The ``low-precision-accumulation`` rule (``numerics_audit.py``) prices a
flagged accumulation with two analytic worst-case relative error bounds,
sequential ``(n-1)·u`` and tree ``ceil(log2 n)·u`` against ``sum(|x_i|)``
(Higham, *Accuracy and Stability of Numerical Algorithms*, §4.2).  This
module measures them, with JAX's four cases and seed:

1. **Static side**: each case's accumulation in its torch form, captured
   (``op_capture.capture_call``) and audited (``analyze_numerics``): a
   sequential chain ``acc = acc + x_i`` over n = 4096 values (n terms,
   JAX's reduction length), or a halving ladder ``v = v[0::2] + v[1::2]``,
   in the case's dtype.  torch sums a
   bf16 ``sum`` in f32, so the chain of elementwise adds is the form whose
   accumulator really is the case's dtype.  A flagged case must be flagged,
   the f32 control clean.
2. **Empirical side**: the same adds run in torch at the case's dtype on
   JAX's data (``numpy.random.default_rng(seed).uniform(0.5, 1.5, n)`` per
   case, in order; rounded to f32 first, as JAX's ``jnp.asarray`` of a
   float64 array does with x64 off), against a float64 sum in numpy: the
   measured relative error ``|sum_lp - sum_f64| / sum(|x|)`` must sit
   within the case's bound.
3. A case is **confirmed** when both sides agree (flagged and within the
   bound; the control clean and far under it), **refuted** otherwise.

The committed report is ``stats/torch/analysis/numerics/shadow_report.json``.

The adds run on the card unless ``--device cpu`` is given; on either they
are elementwise adds rounded once to the case's dtype, so the card's
measured errors are the CPU's.

CLI::

    python -m dlbb_tpu_torch.analysis.numerics_shadow --device cpu --output stats/torch/analysis/numerics
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

SHADOW_REPORT_SCHEMA = "dlbb_numerics_shadow_v1"
SHADOW_REPORT_NAME = "shadow_report.json"
DEFAULT_SHADOW_DIR = Path("stats/torch/analysis/numerics")

# torch dtype name per HLO dtype of the shadow cases
_TORCH_DTYPES = {"bf16": "bfloat16", "f16": "float16", "f32": "float32"}


def _sequential(v):
    """``acc = acc + v[i]``: the sequential order, n - 1 adds (JAX's scan
    from zero adds ``0 + v[0]`` first, which is exact)."""
    acc = v[0]
    for i in range(1, v.shape[0]):
        acc = acc + v[i]
    return acc


def _tree(v):
    """The pairwise halving ladder: the tree order."""
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


_ORDERS = {"sequential": _sequential, "tree": _tree}


def _static_audit(n: int, dtype: str, order: str, device) -> tuple[bool, dict]:
    """Capture and audit the case's accumulation; returns (flagged, the
    finding's details or the site count)."""
    import torch

    from dlbb_tpu_torch.analysis.expectations import TargetExpectation
    from dlbb_tpu_torch.analysis.numerics_audit import analyze_numerics
    from dlbb_tpu_torch.analysis.op_capture import capture_call

    x = torch.ones(n, dtype=getattr(torch, _TORCH_DTYPES[dtype]), device=device)
    _, cap = capture_call(_ORDERS[order], (x,), target=f"shadow::{order}[{dtype},{n}]")
    findings, meta = analyze_numerics(cap, TargetExpectation(), f"shadow::{order}[{dtype},{n}]")
    flagged = [f for f in findings if f.rule == "low-precision-accumulation"]
    details = flagged[0].details if flagged else {"reduction_sites": meta.get("reduction_sites", 0)}
    return bool(flagged), details


def _measured_rel_error(data, dtype: str, order: str, device) -> float:
    """Run the accumulation at ``dtype`` in ``order`` on ``data`` and return
    ``|sum - shadow_f64_sum| / sum(|x|)``."""
    import numpy as np
    import torch

    x = torch.from_numpy(data.astype(np.float32)).to(device=device,
                                                     dtype=getattr(torch, _TORCH_DTYPES[dtype]))
    measured = float(_ORDERS[order](x).double().cpu())
    shadow = data.astype(np.float64)
    ref = float(shadow.sum())
    denom = float(np.abs(shadow).sum()) or 1.0
    return abs(measured - ref) / denom


@dataclass(frozen=True)
class ShadowCase:
    """One static-flag and empirical-replay pair."""

    name: str
    dtype: str      # HLO dtype of the accumulator
    n: int          # accumulation length (a power of two: the ladder halves)
    order: str      # "sequential" | "tree"
    expect_flagged: bool = True  # False for the f32 control


DEFAULT_CASES: tuple[ShadowCase, ...] = (
    ShadowCase("bf16-sequential-4096", "bf16", 4096, "sequential"),
    ShadowCase("bf16-tree-4096", "bf16", 4096, "tree"),
    ShadowCase("f16-sequential-4096", "f16", 4096, "sequential"),
    # control: statically clean, and its measured error far below the
    # bf16 bound or the instrument is saturated
    ShadowCase("f32-control-4096", "f32", 4096, "sequential", expect_flagged=False),
)


def run_shadow(cases: tuple[ShadowCase, ...] = DEFAULT_CASES, seed: int = 0,
               device=None) -> dict:
    """Run every case on ``device`` (the card unless the caller names the
    CPU); returns the report dict (JAX's keys)."""
    import numpy as np

    from dlbb_tpu_torch.analysis.numerics_audit import accumulation_error_bounds, unit_roundoff
    from dlbb_tpu_torch.utils.sysinfo import resolve_device

    device = resolve_device(device)

    rng = np.random.default_rng(seed)
    rows = []
    for case in cases:
        # positive, O(1)-magnitude data: the partial sums grow to ~n so the
        # roundoff accrues (a zero-mean stream would hide it in cancellation)
        data = rng.uniform(0.5, 1.5, size=case.n)
        bound_seq, bound_tree = accumulation_error_bounds(case.n, case.dtype)
        bound = bound_seq if case.order == "sequential" else bound_tree
        flagged, details = _static_audit(case.n, case.dtype, case.order, device)
        measured = _measured_rel_error(data, case.dtype, case.order, device)
        if case.expect_flagged:
            confirmed = flagged and measured <= bound
        else:
            confirmed = not flagged and measured <= 8 * case.n * unit_roundoff("f32")
        rows.append({
            "case": case.name,
            "dtype": case.dtype,
            "n": case.n,
            "order": case.order,
            "static_flagged": flagged,
            "static_details": details,
            "predicted_bound_seq": bound_seq,
            "predicted_bound_tree": bound_tree,
            "gating_bound": bound,
            "measured_rel_error": measured,
            "measured_over_bound": measured / bound if bound else None,
            "confirmed": confirmed,
        })
    confirmed = sum(r["confirmed"] for r in rows)
    return {
        "schema": SHADOW_REPORT_SCHEMA,
        "seed": seed,
        "unit_roundoff": {d: unit_roundoff(d) for d in ("f64", "f32", "f16", "bf16")},
        "cases": rows,
        "confirmed": confirmed,
        "refuted": len(rows) - confirmed,
    }


def write_shadow_report(report: dict, out_dir) -> Path:
    from dlbb_tpu_torch.utils.config import atomic_write_text

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / SHADOW_REPORT_NAME
    atomic_write_text(json.dumps(report, indent=2, sort_keys=True) + "\n", path)
    return path


def main(argv: Optional[list[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--output", default=str(DEFAULT_SHADOW_DIR), metavar="DIR",
                    help=f"directory for the shadow report (default: {DEFAULT_SHADOW_DIR})")
    ap.add_argument("--seed", type=int, default=0, help="rng seed for the shadow payloads")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the adds run (default: cuda)")
    args = ap.parse_args(argv)

    report = run_shadow(seed=args.seed, device=args.device)
    path = write_shadow_report(report, args.output)
    for row in report["cases"]:
        status = "confirmed" if row["confirmed"] else "REFUTED"
        print(f"[shadow] {row['case']}: {status} — measured rel err "
              f"{row['measured_rel_error']:.3g} vs bound {row['gating_bound']:.3g} "
              f"({row['order']}, static_flagged={row['static_flagged']})")
    print(f"[shadow] {report['confirmed']} confirmed, {report['refuted']} refuted; "
          f"report at {path}")
    return 0 if report["refuted"] == 0 and report["confirmed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
