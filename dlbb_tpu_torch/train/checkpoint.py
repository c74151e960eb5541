"""Checkpoint / resume of the train state (counterpart of
``dlbb_tpu/train/checkpoint.py``), on ``torch.save``.

The JAX package saves through orbax, which writes one sharded checkpoint for
all hosts.  Orbax is the JAX package's library, not a format the two
packages share, so the port keeps its policy and its integrity contract on
files of its own:

- each rank of the process group writes its parameters, optimizer state and
  step, as this rank holds them (its tp shards, its ZeRO shards; under
  gradient compression the state's error-feedback residual, this rank's
  row), to
  ``<dir>/<step>/rank_<r>.pt``, through a temporary file and ``os.replace``;
  rank 0 also writes ``layout.json``: the mesh, the ZeRO stage and the
  world size.  A restore onto another layout raises ``ValueError`` (orbax
  can reshard; the port cannot yet, ROADMAP Queue 1, Slice D remainder,
  item 20);
- every save writes, per rank, a checksum manifest (sha256 and size of each
  file it wrote) under ``<dir>/.integrity/<step>/rank_<r>.json``.  A step is
  intact only when every rank's files verify: the ranks take the minimum of
  their verdicts (an all-reduce) before any rank loads, so they all restore
  the same step or none;
- ``restore`` refuses a corrupt step with ``CheckpointCorruption``;
  ``restore_or`` falls back to the newest intact step, saying which step it
  rejected and why;
- ``max_to_keep`` and ``save_interval_steps`` as orbax's: a step is saved
  when it is a multiple of the interval (or forced), and the oldest steps
  beyond ``max_to_keep`` are deleted;
- the ``ckpt-corrupt`` fault site (``resilience/inject.py``) flips and
  truncates this rank's file after its manifest is written.

Without a process group (one device) the checkpointer is the same, with one
rank.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist

from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.resilience.errors import CheckpointCorruption
from dlbb_tpu_torch.train.loop import TrainState
from dlbb_tpu_torch.utils.config import save_json

INTEGRITY_DIRNAME = ".integrity"
INTEGRITY_SCHEMA = "dlbb_ckpt_integrity_v1"
LAYOUT_FILE = "layout.json"


def _file_digest(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


class CheckpointConfig:
    """Checkpoint policy knobs (YAML section ``training.checkpoint``)."""

    def __init__(self, directory: str, save_interval_steps: int = 1,
                 max_to_keep: int = 3, enabled: bool = True,
                 integrity: bool = True) -> None:
        self.directory = str(Path(directory).absolute())
        self.save_interval_steps = int(save_interval_steps)
        self.max_to_keep = int(max_to_keep)
        self.enabled = bool(enabled)
        # per-save checksum manifests; each save reads back what it wrote
        self.integrity = bool(integrity)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CheckpointConfig":
        return cls(directory=d["directory"],
                   save_interval_steps=d.get("save_interval_steps", 1),
                   max_to_keep=d.get("max_to_keep", 3),
                   enabled=d.get("enabled", True),
                   integrity=d.get("integrity", True))


def _flatten(tree: Any) -> list:
    """The leaves of a state tree of dicts and (Named)tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flatten(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _rebuild(like: Any, leaves) -> Any:
    """``like``'s structure with ``leaves`` (an iterator) in its places;
    a tensor must come back with the shape and dtype it had."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, tuple):
        children = [_rebuild(v, leaves) for v in like]
        return type(like)(*children) if hasattr(like, "_fields") else tuple(children)
    leaf = next(leaves)
    if isinstance(like, torch.Tensor):
        if (not isinstance(leaf, torch.Tensor) or leaf.shape != like.shape
                or leaf.dtype != like.dtype):
            raise ValueError(f"checkpoint leaf {getattr(leaf, 'shape', leaf)} does not "
                             f"match the state's {tuple(like.shape)} {like.dtype}")
        return leaf.to(like.device).requires_grad_(like.requires_grad)
    return leaf


class Checkpointer:
    """Saves and restores one rank's ``TrainState`` (module docstring).

    ``layout`` is recorded with every step and must match on restore;
    ``group`` is the process group whose ranks save together (None: one
    process); ``device`` holds the one-element tensors of the ranks'
    agreements (``cuda`` on an NCCL group)."""

    def __init__(self, config: CheckpointConfig, layout: Optional[dict] = None,
                 group=None, device="cpu") -> None:
        self.config = config
        self.layout = dict(layout or {})
        self.group = group
        self.device = torch.device(device)
        self.rank = 0 if group is None else dist.get_rank(group)
        os.makedirs(config.directory, exist_ok=True)

    # ---- the ranks' agreement -------------------------------------------

    def _all(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank (an all-reduce MIN)."""
        if self.group is None:
            return ok
        flag = torch.tensor([int(ok)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag.item())

    def _barrier(self) -> None:
        self._all(True)

    # ---- layout on disk -----------------------------------------------------

    def _base(self) -> Path:
        return Path(self.config.directory)

    def _step_dir(self, step: int) -> Path:
        return self._base() / str(int(step))

    def _rank_file(self, step: int) -> Path:
        return self._step_dir(step) / f"rank_{self.rank:05d}.pt"

    def _manifest_path(self, step: int) -> Path:
        return (self._base() / INTEGRITY_DIRNAME / str(int(step))
                / f"rank_{self.rank:05d}.json")

    def all_steps(self) -> list[int]:
        """The steps on disk, oldest first."""
        return sorted(int(p.name) for p in self._base().iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _own_files(self, step: int) -> list[Path]:
        files = [self._rank_file(step)]
        if self.rank == 0:
            files.append(self._step_dir(step) / LAYOUT_FILE)
        return files

    def _write_integrity(self, step: int) -> None:
        files = {p.name: {"sha256": _file_digest(p), "bytes": p.stat().st_size}
                 for p in self._own_files(step)}
        save_json({"schema": INTEGRITY_SCHEMA, "step": int(step), "rank": self.rank,
                   "files": files}, self._manifest_path(step))

    def verify_step(self, step: int) -> tuple[bool, str]:
        """Do this rank's files of ``step`` match its integrity manifest?
        Returns ``(ok, reason)``; a rank's file missing fails, a missing
        manifest (a save with ``integrity: false``) passes as
        "unverified"."""
        if not self._rank_file(step).is_file():
            return False, f"missing file {self._rank_file(step).name}"
        mpath = self._manifest_path(step)
        if not mpath.exists():
            return True, "unverified (no integrity manifest)"
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, json.JSONDecodeError) as e:
            return False, f"integrity manifest unreadable ({e})"
        for name, meta in manifest.get("files", {}).items():
            p = self._step_dir(step) / name
            if not p.is_file():
                return False, f"missing file {name}"
            if p.stat().st_size != meta["bytes"]:
                return False, f"size mismatch on {name} ({p.stat().st_size} != {meta['bytes']})"
            if _file_digest(p) != meta["sha256"]:
                return False, f"checksum mismatch on {name}"
        return True, "ok"

    def latest_intact_step(self) -> Optional[int]:
        """Newest step whose files verify on every rank (None if none)."""
        for step in reversed(self.all_steps()):
            if self._all(self.verify_step(step)[0]):
                return step
        return None

    # ---- save ------------------------------------------------------------

    def maybe_save(self, state: TrainState, force: bool = False) -> bool:
        """Save at an interval step (or when ``force``), unless the step is
        on disk already; returns whether it saved.  Every rank calls it
        together."""
        if not self.config.enabled:
            return False
        step = int(state.step)
        if not force and step % self.config.save_interval_steps != 0:
            return False
        if not self._all(step not in self.all_steps()):
            return False  # already on disk (e.g. the final save after an interval one)
        step_dir = self._step_dir(step)
        step_dir.mkdir(parents=True, exist_ok=True)
        path = self._rank_file(step)
        tmp = path.with_name(path.name + ".tmp")
        torch.save({"step": step, "leaves": _flatten((state.params, state.opt_state))}, tmp)
        os.replace(tmp, path)
        if self.rank == 0:
            save_json(dict(self.layout, step=step), step_dir / LAYOUT_FILE)
        if self.config.integrity:
            self._write_integrity(step)
            if inject.fire("ckpt-corrupt"):
                # chaos site: rot this rank's file after its manifest, which
                # verification must then refuse
                self._corrupt(path)
        self._barrier()
        if self.rank == 0:
            self._prune()
        self._barrier()
        return True

    def _prune(self) -> None:
        """Delete the oldest steps beyond ``max_to_keep``, with their
        manifests."""
        steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.config.max_to_keep)]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
            shutil.rmtree(self._base() / INTEGRITY_DIRNAME / str(old), ignore_errors=True)

    @staticmethod
    def _corrupt(victim: Path) -> None:
        blob = bytearray(victim.read_bytes())
        mid = len(blob) // 2
        blob[mid] ^= 0xFF
        victim.write_bytes(bytes(blob[:max(1, mid)]))  # flip + truncate

    # ---- restore ---------------------------------------------------------

    def _check_layout(self, step: int) -> None:
        path = self._step_dir(step) / LAYOUT_FILE
        saved = json.loads(path.read_text()) if path.is_file() else {}
        saved.pop("step", None)
        if saved != self.layout:
            raise ValueError(
                f"checkpoint step {step} under {self.config.directory} was saved with "
                f"layout {saved}, this run has {self.layout}: the port restores only "
                "onto the mesh and ZeRO stage it saved")

    def _load(self, like: TrainState, step: int) -> TrainState:
        payload = torch.load(self._rank_file(step), map_location=self.device,
                             weights_only=True)
        leaves = iter(payload["leaves"])
        params, opt_state = _rebuild((like.params, like.opt_state), leaves)
        if next(leaves, None) is not None:
            raise ValueError(f"checkpoint step {step} holds more leaves than the state")
        return TrainState(params, opt_state, int(payload["step"]))

    def restore(self, like: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore ``step`` (default: the latest) into ``like``'s structure.
        Verifies integrity first, on every rank, and raises
        ``CheckpointCorruption`` on a corrupt step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.config.directory}")
        ok, why = self.verify_step(int(step))
        if not self._all(ok):
            raise CheckpointCorruption(
                f"checkpoint step {step} under {self.config.directory} failed "
                f"integrity verification: {why if not ok else 'on another rank'}")
        self._check_layout(int(step))
        return self._load(like, int(step))

    def restore_or(self, state: TrainState) -> TrainState:
        """Resume from the newest step that is intact on every rank; pass
        ``state`` through when there is none.  A rejected step is printed
        with its reason, and the next older one is tried."""
        steps = list(reversed(self.all_steps()))
        for step in steps:
            ok, why = self.verify_step(step)
            if not self._all(ok):
                print(f"[checkpoint] step {step}: integrity FAILED "
                      f"({why if not ok else 'on another rank'}) — falling back to "
                      "the previous step")
                continue
            self._check_layout(step)
            try:
                restored, error = self._load(state, step), None
            except (OSError, RuntimeError, ValueError, KeyError) as e:
                restored, error = None, e
            if self._all(error is None):
                return restored
            print(f"[checkpoint] step {step}: restore failed "
                  f"({type(error).__name__ if error else 'on another rank'}: {error}) — "
                  "falling back to the previous step")
        if steps:
            print(f"[checkpoint] no intact checkpoint among steps {steps} under "
                  f"{self.config.directory}; starting from the initial state")
        return state

    def close(self) -> None:
        """Nothing is left to flush: every save is written before
        ``maybe_save`` returns."""

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
