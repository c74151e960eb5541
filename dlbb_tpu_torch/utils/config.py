"""Config and JSON IO (counterpart of ``dlbb_tpu/utils/config.py``).

``atomic_write_text`` (and ``save_json`` through it) writes through a
temporary file in the destination directory, ``fsync`` and ``os.replace``, so
a killed process leaves the old artifact or the new one, never a truncated
file (``save_json``'s fault sites model the writer that did).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any
from uuid import uuid4


def load_config(path: str | Path) -> dict[str, Any]:
    """Load a YAML experiment config (the JAX package's schema)."""
    import yaml

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"config file not found: {path}")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"config {path} did not parse to a mapping")
    return cfg


def atomic_write_text(text: str, path: str | Path, newline: str = "") -> Path:
    """Replace ``path`` with ``text`` durably, creating parent directories.
    ``newline`` passes through to ``open`` (``""``: no translation, as CSV
    writers need)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{uuid4().hex[:8]}.tmp")
    try:
        with open(tmp, "w", newline=newline) as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def save_json(data: dict[str, Any], path: str | Path) -> Path:
    """``data`` as indented JSON through ``atomic_write_text``.  The fault
    sites ``torn-write`` (a truncated file at the final path, then
    ``TornWrite``: the legacy writer dying mid-dump) and ``kill-mid-write``
    (SIGKILL between the temporary write and the rename) are JAX's."""
    from dlbb_tpu_torch.resilience import inject

    path = Path(path)
    text = json.dumps(data, indent=2, default=_jsonify)
    if inject.fire("torn-write"):
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            f.write(text[:max(1, int(len(text) * inject.param("torn_fraction")))])
        raise inject.TornWrite(str(path))
    if inject.fire("kill-mid-write"):
        import signal

        path.parent.mkdir(parents=True, exist_ok=True)
        path.with_name(f"{path.name}.{os.getpid()}.killed.tmp").write_text(text)
        os.kill(os.getpid(), signal.SIGKILL)
    return atomic_write_text(text, path)


def _jsonify(obj: Any):
    import numpy as np

    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, os.PathLike):
        return str(obj)
    raise TypeError(f"not JSON serialisable: {type(obj)}")
