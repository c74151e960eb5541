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
  rank 0 also writes ``layout.json``: the mesh, the ZeRO stage, the world
  size and (``train_layout``) the model's config;
- a restore onto another layout (another dp, tp, pp, ep or ZeRO stage, as
  orbax restores with ``like``'s shardings) maps every saved rank's file
  (``torch.load(mmap=True)``: a leaf's bytes are read when it is used),
  then one leaf at a time rebuilds the global parameter or optimizer-state
  leaf from the saved layout's shards (tp shards by
  ``sharding.unshard_params``, ZeRO's dp shards by each leaf's dp axis,
  told apart by their shapes), cuts this rank's part of the new one
  (``_Reshard``) and drops the global leaf: a rank's host memory holds its
  own state and one global leaf.  Refused, with the reason:
  a layout without the model's config, another model, and an
  error-feedback residual at another dp (JAX's ``[dp, n]`` array, which
  orbax restores only onto its own shape);
- every save writes, per rank, a checksum manifest (sha256 and size of each
  file it wrote) under ``<dir>/.integrity/<step>/rank_<r>.json``.  A step is
  intact only when every file that the restore reads verifies: each rank
  checks ``layout.json`` and its share of the files (its own on the saving
  layout; on another, saved rank s's on rank s mod world, so each file is
  hashed once), and the ranks take the minimum of their verdicts (an
  all-reduce) before any rank loads, so they all restore the same step or
  none;
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

import dataclasses
import hashlib
import json
import math
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist

from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.models.sharding import shard_leaf, unshard_params
from dlbb_tpu_torch.models.transformer import meta_params
from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.resilience.errors import CheckpointCorruption
from dlbb_tpu_torch.train.loop import TrainState
from dlbb_tpu_torch.train.optim import GradCompressionState
from dlbb_tpu_torch.train.zero import dp_sharded_param_specs, shard_along
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


AXES = ("dp", "sp", "pp", "ep", "tp")


def train_layout(config: ModelConfig, mesh_degrees: dict, zero_stage: int,
                 world_size: int) -> dict:
    """The ``layout`` a train run records with its checkpoints: enough to
    restore them onto another mesh or ZeRO stage (``_Reshard``)."""
    return {"mesh": {a: int(mesh_degrees.get(a, 1)) for a in AXES},
            "zero_stage": int(zero_stage), "world_size": int(world_size),
            "model": dataclasses.asdict(config)}


def _degrees(layout: dict) -> dict:
    mesh = layout.get("mesh", {})
    return {a: int(mesh.get(a, 1)) for a in AXES}


def _coords(deg: dict, rank: int) -> dict:
    """Rank ``rank``'s coordinates on the mesh of degrees ``deg``, in
    ``build_parallelism_mesh``'s row-major order ``(dp[, sp][, pp][, ep],
    tp)``."""
    names = ["dp"] + [a for a in ("sp", "pp", "ep") if deg[a] > 1] + ["tp"]
    out = dict.fromkeys(AXES, 0)
    for a in reversed(names):
        out[a], rank = rank % deg[a], rank // deg[a]
    return out


def _labels(tree: Any, params: Any, tag: Optional[str] = None, path: tuple = ()) -> list:
    """For each leaf of ``tree`` in ``_flatten``'s order: ``("param",
    group, leaf)`` under ``tag`` "param", ``("mirror", group, leaf)`` in an
    optimizer-state subtree with the parameters' structure (Adam's
    moments), ``("residual",)`` for the error-feedback residual, else None
    (``group`` is "ln_f" for the final norm's leaves)."""
    if tag is None and isinstance(tree, dict) and _same_keys(tree, params):
        tag = "mirror"
    if isinstance(tree, GradCompressionState):
        return [("residual",)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _labels(v, params, tag, path + (k,))]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _labels(v, params, tag, path)]
    return [None if tag is None else (tag, path[-2], path[-1])]


def _same_keys(a: Any, b: Any) -> bool:
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            _same_keys(a[k], b[k]) for k in b)
    return not isinstance(a, (dict, tuple))


class _Reshard:
    """One layout's cut of the global train state: for a rank's
    coordinates, each parameter leaf's tp/pp/ep part
    (``sharding.shard_leaf``) and its dp axis (``zero.
    dp_sharded_param_specs``), from which a saved part is recognised as
    whole or as a ZeRO dp shard by its shape."""

    def __init__(self, layout: dict) -> None:
        self.deg = _degrees(layout)
        self.config = ModelConfig(**layout["model"])
        self.meta = meta_params(self.config)
        self._local: dict = {}

    def local(self, c: dict) -> tuple:
        """(this rank's tp/pp/ep part of every leaf, their dp axes) as meta
        trees."""
        key = (c["pp"], c["ep"], c["tp"])
        if key not in self._local:
            d = self.deg
            part = {"layers": {g: {leaf: self._cut(g, leaf, t, c) for leaf, t in sub.items()}
                               for g, sub in self.meta["layers"].items()},
                    "ln_f": dict(self.meta["ln_f"])}
            self._local[key] = (part, dp_sharded_param_specs(part, d["dp"], d["pp"], d["ep"]))
        return self._local[key]

    def _cut(self, group, leaf, t, c):
        d = self.deg
        return shard_leaf(group, leaf, t, self.config, c["tp"], d["tp"], c["pp"], d["pp"],
                          c["ep"], d["ep"])

    def global_leaf(self, label, parts: dict) -> torch.Tensor:
        """The global leaf from ``parts``, each saved rank's tensor by its
        coordinates' ``(dp, pp, ep, tp)`` (sp ranks hold copies)."""
        _, group, leaf = label
        d, tree = self.deg, {}
        for pp in range(d["pp"]):
            for ep in range(d["ep"]):
                for tp in range(d["tp"]):
                    c = dict(dp=0, sp=0, pp=pp, ep=ep, tp=tp)
                    meta, axes = self.local(c)
                    want = tuple(_at(meta, group, leaf).shape)
                    ax = _at(axes, group, leaf)
                    dps = [parts[(i, pp, ep, tp)] for i in range(d["dp"])]
                    if tuple(dps[0].shape) == want:
                        whole = dps[0]
                    elif ax is not None and tuple(dps[0].shape) == _split(want, ax, d["dp"]):
                        whole = torch.cat(dps, ax)
                    else:
                        raise ValueError(
                            f"checkpoint leaf {group}.{leaf} of shape {tuple(dps[0].shape)} "
                            f"is neither the saved layout's part {want} nor its dp shard")
                    tree[(pp, ep, tp)] = whole
        if group == "ln_f":
            return tree[(0, 0, 0)]
        shards = [{"layers": {group: {leaf: tree[(pp, ep, tp)]}}, "ln_f": {}}
                  for pp in range(d["pp"]) for ep in range(d["ep"]) for tp in range(d["tp"])]
        return unshard_params(shards, self.config, d["pp"], d["ep"])["layers"][group][leaf]

    def cut(self, label, full: torch.Tensor, c: dict, like: torch.Tensor) -> torch.Tensor:
        """Rank ``c``'s part of the global leaf ``full``, whole or its dp
        shard as ``like``'s shape says."""
        _, group, leaf = label
        part = full if group == "ln_f" else self._cut(group, leaf, full, c)
        ax = _at(self.local(c)[1], group, leaf)
        if tuple(like.shape) == tuple(part.shape):
            return part.clone(memory_format=torch.contiguous_format)
        if ax is not None and tuple(like.shape) == _split(tuple(part.shape), ax, self.deg["dp"]):
            return shard_along(part, ax, c["dp"], self.deg["dp"]).clone(
                memory_format=torch.contiguous_format)
        raise ValueError(f"state leaf {group}.{leaf} of shape {tuple(like.shape)} is neither "
                         f"this layout's part {tuple(part.shape)} nor its dp shard")


def _at(tree, group, leaf):
    return tree["ln_f"][leaf] if group == "ln_f" else tree["layers"][group][leaf]


def _split(shape: tuple, ax: int, n: int) -> tuple:
    return shape[:ax] + (shape[ax] // n,) + shape[ax + 1:]


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

    def _rank_file(self, step: int, rank: Optional[int] = None) -> Path:
        return self._step_dir(step) / f"rank_{self.rank if rank is None else rank:05d}.pt"

    def _manifest_path(self, step: int, rank: Optional[int] = None) -> Path:
        return (self._base() / INTEGRITY_DIRNAME / str(int(step))
                / f"rank_{self.rank if rank is None else rank:05d}.json")

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

    def verify_step(self, step: int, rank: Optional[int] = None,
                    names: Optional[set] = None) -> tuple[bool, str]:
        """Do rank ``rank``'s files of ``step`` (default: this rank's), or
        those of them in ``names``, match its integrity manifest?  Returns
        ``(ok, reason)``; a rank's file missing fails, a missing manifest (a
        save with ``integrity: false``) passes as "unverified"."""
        own = self._rank_file(step, rank)
        if (names is None or own.name in names) and not own.is_file():
            return False, f"missing file {own.name}"
        mpath = self._manifest_path(step, rank)
        if not mpath.exists():
            return True, "unverified (no integrity manifest)"
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, json.JSONDecodeError) as e:
            return False, f"integrity manifest unreadable ({e})"
        for name, meta in manifest.get("files", {}).items():
            if names is not None and name not in names:
                continue
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
            if self._all(self._verify(step)[0]):
                return step
        return None

    def _saved_layout(self, step: int) -> dict:
        path = self._step_dir(step) / LAYOUT_FILE
        saved = json.loads(path.read_text()) if path.is_file() else {}
        saved.pop("step", None)
        return saved

    def _verify(self, step: int) -> tuple[bool, str]:
        """``verify_step`` of this rank's share of the files that restoring
        ``step`` reads: ``layout.json`` (rank 0's, which every rank reads),
        then its own file on the saving layout, or on another the saved
        ranks' files dealt out over this run's ranks, so that each is hashed
        once.  The caller all-reduces the verdicts (``_all``)."""
        ok, why = self.verify_step(step, 0, names={LAYOUT_FILE})
        if not ok:
            return ok, why
        saved = self._saved_layout(step)
        if saved == self.layout:
            shares = [self.rank]
        else:
            self._check_layout(step, saved)
            world = 1 if self.group is None else dist.get_world_size(self.group)
            shares = range(self.rank, math.prod(_degrees(saved).values()), world)
        for rank in shares:
            ok, why = self.verify_step(step, rank, names={self._rank_file(step, rank).name})
            if not ok:
                return ok, why
        return True, why

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

    def _check_layout(self, step: int, saved: dict) -> None:
        """Refuse a restore of ``step`` (saved on ``saved``) that no
        resharding can serve: a layout without the model's config, or
        another model."""
        where = f"checkpoint step {step} under {self.config.directory}"
        if saved == self.layout:
            return
        if "model" not in saved or "model" not in self.layout:
            raise ValueError(
                f"{where} was saved with layout {saved}, this run has {self.layout}: "
                "without the model's config in both layouts (train_layout) the port "
                "restores only onto the mesh and ZeRO stage it saved")
        if saved["model"] != self.layout["model"]:
            raise ValueError(f"{where} holds another model ({saved['model']}) than this "
                             f"run's ({self.layout['model']})")

    def _load(self, like: TrainState, step: int) -> TrainState:
        """``step`` in ``like``'s structure: this rank's file on the saving
        layout, else the state resharded from every saved rank's files."""
        saved = self._saved_layout(step)
        if saved != self.layout:
            return self._load_resharded(like, step, saved)
        payload = torch.load(self._rank_file(step), map_location=self.device,
                             weights_only=True)
        leaves = iter(payload["leaves"])
        params, opt_state = _rebuild((like.params, like.opt_state), leaves)
        if next(leaves, None) is not None:
            raise ValueError(f"checkpoint step {step} holds more leaves than the state")
        return TrainState(params, opt_state, int(payload["step"]))

    def _load_resharded(self, like: TrainState, step: int, saved: dict) -> TrainState:
        """``step``, saved on the layout ``saved``, cut for this rank of
        ``self.layout`` (module docstring)."""
        where = f"checkpoint step {step} under {self.config.directory}"
        self._check_layout(step, saved)
        old, new = _Reshard(saved), _Reshard(self.layout)
        me = _coords(new.deg, self.rank)
        # mapped, not read: each leaf's bytes are read when it is rebuilt
        payloads = [torch.load(self._rank_file(step, r), map_location="cpu", weights_only=True,
                               mmap=True)
                    for r in range(math.prod(old.deg.values()))]
        coords = [_coords(old.deg, r) for r in range(len(payloads))]
        like_leaves = _flatten((like.params, like.opt_state))
        labels = _labels(like.params, like.params, "param") + _labels(like.opt_state,
                                                                      like.params)
        if any(len(p["leaves"]) != len(like_leaves) for p in payloads):
            raise ValueError(f"{where} holds another state structure than this run's")
        out = []
        for i, (label, want) in enumerate(zip(labels, like_leaves)):
            if label is None:
                leaf = payloads[0]["leaves"][i]
                if isinstance(want, torch.Tensor) and leaf.shape != want.shape:
                    raise ValueError(f"{where}: a state leaf of shape {tuple(leaf.shape)} "
                                     f"has no cut to {tuple(want.shape)}")
                if isinstance(leaf, torch.Tensor):
                    leaf = leaf.clone()
            elif label[0] == "residual":
                rows = [p["leaves"][i] for p, c in zip(payloads, coords)
                        if c["sp"] == c["pp"] == c["ep"] == c["tp"] == 0]
                if len(rows) != new.deg["dp"] or rows[0].shape != want.shape:
                    raise ValueError(
                        f"{where}: the error-feedback residual is JAX's [dp, n] array of "
                        f"shape {(len(rows), *rows[0].shape)}, this run's is "
                        f"{(new.deg['dp'], *want.shape)}: orbax restores it only onto "
                        "its own shape")
                leaf = rows[me["dp"]].clone()
            else:
                full = old.global_leaf(label, {(c["dp"], c["pp"], c["ep"], c["tp"]):
                                               p["leaves"][i]
                                               for p, c in zip(payloads, coords)
                                               if c["sp"] == 0})
                leaf = new.cut(label, full, me, want)
            out.append(leaf)
        params, opt_state = _rebuild((like.params, like.opt_state), iter(out))
        return TrainState(params, opt_state, int(payloads[0]["step"]))

    def restore(self, like: TrainState, step: Optional[int] = None) -> TrainState:
        """Restore ``step`` (default: the latest) into ``like``'s structure.
        Verifies integrity first, on every rank, and raises
        ``CheckpointCorruption`` on a corrupt step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.config.directory}")
        ok, why = self._verify(int(step))
        if not self._all(ok):
            raise CheckpointCorruption(
                f"checkpoint step {step} under {self.config.directory} failed "
                f"integrity verification: {why if not ok else 'on another rank'}")
        self._check_layout(int(step), self._saved_layout(int(step)))
        return self._load(like, int(step))

    def restore_or(self, state: TrainState) -> TrainState:
        """Resume from the newest step that is intact on every rank; pass
        ``state`` through when there is none.  A rejected step is printed
        with its reason, and the next older one is tried."""
        steps = list(reversed(self.all_steps()))
        for step in steps:
            ok, why = self._verify(step)
            if not self._all(ok):
                print(f"[checkpoint] step {step}: integrity FAILED "
                      f"({why if not ok else 'on another rank'}) — falling back to "
                      "the previous step")
                continue
            self._check_layout(step, self._saved_layout(step))
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
