"""Artifact validation: what resume and the chaos gate trust (a copy of
``dlbb_tpu/resilience/validate.py``; the port imports nothing of the JAX
package).

Resume trusts an artifact only if it passes :func:`validate_result_json`:
it parses, carries the result schema, and every timing sample is finite.
Anything else is re-measured (with a warning and a journal record), so a
file torn by a process killed mid-``json.dump`` never leaks into the
corpus.  :func:`validate_timings` is the writer's side of the same check.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# the fields every sweep result JSON carries (``bench/runner.py::_run_one``)
# that the stats readers index on
REQUIRED_RESULT_FIELDS = (
    "implementation",
    "operation",
    "num_ranks",
    "num_elements",
    "timings",
)


def validate_result_json(path: "str | Path") -> tuple[bool, str]:
    """Is the artifact at ``path`` a complete, sane sweep result?

    Returns ``(ok, reason)``; ``reason`` is ``"ok"`` or why the artifact
    must not be trusted (truncated or torn JSON, missing schema fields,
    empty or non-finite timings)."""
    path = Path(path)
    if not path.exists():
        return False, "missing"
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        return False, f"unparseable ({type(e).__name__}: {e})"
    if not isinstance(data, dict):
        return False, "not a JSON object"
    missing = [k for k in REQUIRED_RESULT_FIELDS if k not in data]
    if missing:
        return False, f"missing fields {missing}"
    try:
        arr = np.asarray(data["timings"], dtype=np.float64)
    except (TypeError, ValueError) as e:
        return False, f"non-numeric timings ({e})"
    if arr.size == 0:
        return False, "empty timings"
    if not np.isfinite(arr).all():
        bad = int(np.size(arr) - np.isfinite(arr).sum())
        return False, f"non-finite timings ({bad}/{arr.size} samples)"
    if not np.isfinite(np.median(arr)):
        return False, "non-finite median"
    return True, "ok"


def validate_timings(timings) -> tuple[bool, str]:
    """Pre-write check of a just-measured timing matrix: a NaN or Inf
    sample, injected or real, must never reach an artifact."""
    arr = np.asarray(timings, dtype=np.float64)
    if arr.size == 0:
        return False, "empty timings"
    if not np.isfinite(arr).all():
        bad = int(np.size(arr) - np.isfinite(arr).sum())
        return False, f"non-finite timings ({bad}/{arr.size} samples)"
    return True, "ok"
