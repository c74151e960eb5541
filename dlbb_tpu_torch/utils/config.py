"""Config and JSON IO (counterpart of ``dlbb_tpu/utils/config.py``).

``atomic_write_text`` (and ``save_json`` through it) writes through a
temporary file in the destination directory, ``fsync`` and ``os.replace``, so
a killed process leaves the old artifact or the new one, never a truncated
file.
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
    return atomic_write_text(json.dumps(data, indent=2, default=_jsonify), path)


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
