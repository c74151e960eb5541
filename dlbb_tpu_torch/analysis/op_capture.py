"""The op capture: what one call of a target issues (the port's counterpart
of ``dlbb_tpu/analysis/hlo_parse.py``).

JAX's auditors read the compiled, post-SPMD HLO module of a target: its
collective instructions, each with its kind, result shape, replica groups
and execution count.  Eager torch compiles no program, but every
collective the port issues goes through the dispatcher as a ``c10d`` op,
so the port's counterpart of "the lowered program" is the op stream one
call of the target records (``capture_call``, a ``TorchDispatchMode``):

- each ``c10d`` op becomes a ``CollectiveInstr`` with JAX's fields: its
  kind (``analysis/expectations.C10D_KINDS``; a ``send``/``recv_`` pair is
  one ``collective-permute``, as XLA's ppermute is one instruction), the
  per-rank result bytes, the dtype and shape of its first tensor, and the
  group size of its process-group argument (2 for a permute, as JAX reads
  a permute's source-target pairs), with its place in the op stream
  (``index``) and the call site in the repo (``source``).  The stream is
  execution-weighted by nature: each executed call is recorded, which is
  what JAX's while-body trip weighting emulates, so every
  ``execution_count`` is 1;
- the aten op names, in order (the substrate of the schedule pass, ROADMAP
  Queue 1, Slice F, item 15, part 15b);
- the flash kernels' launches, as the deltas of their counters
  (``ops/flash_attention.py``) around the call: the kernels are launched
  through ``ctypes`` and never reach the dispatcher;
- the donation counterpart: a target names its state tensors (parameters,
  optimiser moments, the KV cache).  Their storages are noted before and
  after the call; ``Capture.has_donation`` holds when every state tensor
  kept its storage, that is when the call updated its state in place, as
  XLA does with a donated buffer.

The capture records names, shapes and pointers only: it adds no host sync
and does not change what the target computes.  The module imports torch
lazily, inside ``capture_call``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

from dlbb_tpu_torch.analysis.expectations import C10D_KINDS

FLASH_COUNTERS = ("flash_fwd_launches", "flash_bwd_dq_launches", "flash_bwd_dkv_launches")

_REPO_ROOT = Path(__file__).resolve().parents[2]


@dataclass
class CollectiveInstr:
    """One collective of a captured call (JAX's fields; ``index`` is its
    place in the call's op stream)."""

    kind: str                       # expectations.COLLECTIVE_KINDS or PORT_KINDS
    dtype: str                      # element type of the first tensor
    shape: tuple[int, ...]          # shape of the first tensor
    result_bytes: int               # per-rank result bytes
    replica_groups: str             # the process group, as text
    group_count: Optional[int]
    group_size: Optional[int]
    source: Optional[str]           # "file:line" of the call site
    raw: str = field(repr=False, default="")
    execution_count: int = 1
    computation: str = ""
    name: str = ""
    op_name: Optional[str] = None   # the c10d op ("c10d::allreduce_")
    index: int = 0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "dtype": self.dtype,
            "shape": list(self.shape),
            "result_bytes": self.result_bytes,
            "replica_groups": self.replica_groups,
            "group_count": self.group_count,
            "group_size": self.group_size,
            "source": self.source,
            "execution_count": self.execution_count,
            "computation": self.computation,
            "index": self.index,
        }


@dataclass
class StateSpec:
    """The state tensors of a call: ``before(args)`` in the arguments,
    ``after(out, args)`` the same leaves in what the call returned."""

    before: Callable[[tuple], list]
    after: Callable[[Any, tuple], list]


@dataclass
class Capture:
    """What one call recorded (module docstring)."""

    collectives: list[CollectiveInstr] = field(default_factory=list)
    aten_ops: list[str] = field(default_factory=list)
    flash_launches: dict[str, int] = field(default_factory=dict)
    # storages of the state tensors before and after the call (empty: the
    # target names no state)
    state_before: list[int] = field(default_factory=list)
    state_after: list[int] = field(default_factory=list)

    @property
    def has_donation(self) -> bool:
        """Every state tensor kept its storage: the call updated its state
        in place."""
        return bool(self.state_before) and self.state_before == self.state_after


def _tensors(value) -> list:
    """The tensors of a c10d argument (a tensor, or nested lists of them)."""
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _nbytes(tensors: list) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _group_size(func, args) -> Optional[int]:
    """The size of the op's process-group argument."""
    import torch.distributed as dist

    for i, arg in enumerate(func._schema.arguments):
        if arg.name == "process_group" and i < len(args):
            try:
                return int(dist.ProcessGroup.unbox(args[i]).size())
            except (RuntimeError, AttributeError):
                return None
    return None


def _call_site() -> Optional[str]:
    """``file:line`` of the innermost frame in the repo outside this
    module and torch (the port code that issued the op)."""
    frame = sys._getframe(2)
    here = Path(__file__).resolve()
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        try:
            resolved = path.resolve()
            rel = resolved.relative_to(_REPO_ROOT)
        except (OSError, ValueError):
            frame = frame.f_back
            continue
        if resolved != here and "site-packages" not in rel.parts:
            return f"{rel.as_posix()}:{frame.f_lineno}"
        frame = frame.f_back
    return None


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def _make_mode():
    """A ``TorchDispatchMode`` that records the op stream (built on first
    use: torch is imported lazily)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: list[str] = []
            self.raw: list[tuple] = []   # (index, c10d op, kind, tensors, size, site)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.name()
            index = len(self.ops)
            self.ops.append(name)
            if name.startswith("c10d::"):
                # a c10d op outside the vocabulary keeps its own name as its
                # kind, which no expectation allows: it is flagged, not lost
                kind = C10D_KINDS.get(name.split("::", 1)[1], name)
                first = _tensors(args[0]) if args else []
                if kind == "gather":
                    # the gathered buffer, whether this rank is the root or
                    # not: the group size x the input
                    size = _group_size(func, args) or 1
                    first = _tensors(args[1])
                    nbytes = size * _nbytes(first)
                else:
                    size = _group_size(func, args)
                    nbytes = _nbytes(first)
                self.raw.append((index, name, kind, first, nbytes, size, _call_site()))
            return func(*args, **(kwargs or {}))

    return _Recorder()


def _instr(index, name, kind, tensors, nbytes, size, site, target) -> CollectiveInstr:
    t = tensors[0] if tensors else None
    dtype = str(t.dtype).replace("torch.", "") if t is not None else ""
    shape = tuple(t.shape) if t is not None else ()
    group_size = 2 if kind == "collective-permute" else size
    return CollectiveInstr(
        kind=kind, dtype=dtype, shape=shape, result_bytes=int(nbytes),
        replica_groups=f"{{group of {size}}}" if size else "", group_count=1,
        group_size=group_size, source=site, raw=name, computation=target,
        name=f"{name.split('::', 1)[1]}.{index}", op_name=name, index=index)


def _collectives(raw: list[tuple], target: str) -> list[CollectiveInstr]:
    """The recorded c10d ops as collectives: each ``recv_`` pairs with the
    earliest unpaired ``send`` into one permute (the received buffer is its
    result); a send or receive left unpaired is a permute of its own."""
    out: list[CollectiveInstr] = []
    pending_sends: list[tuple] = []
    pending_recvs: list[tuple] = []
    for rec in raw:
        index, name, kind = rec[0], rec[1], rec[2]
        if kind == "collective-permute":
            if name == "c10d::send":
                if pending_recvs:
                    out.append(_instr(*pending_recvs.pop(0), target))
                else:
                    pending_sends.append(rec)
            elif pending_sends:
                pending_sends.pop(0)
                out.append(_instr(*rec, target))
            else:
                pending_recvs.append(rec)
            continue
        out.append(_instr(*rec, target))
    out += [_instr(*rec, target) for rec in pending_sends + pending_recvs]
    out.sort(key=lambda i: i.index)
    return out


def _flash_counts() -> dict[str, int]:
    from dlbb_tpu_torch.ops import flash_attention as fa

    return {name: getattr(fa, name) for name in FLASH_COUNTERS}


def capture_call(fn: Callable, args: tuple, state: Optional[StateSpec] = None,
                 target: str = "") -> tuple[Any, Capture]:
    """Call ``fn(*args)`` once under the recorder; returns ``(its result,
    the Capture)``.  ``state`` names the call's state tensors (the
    donation counterpart)."""
    cap = Capture()
    if state is not None:
        cap.state_before = [_storage(t) for t in state.before(args)]
    launches = _flash_counts()
    mode = _make_mode()
    with mode:
        out = fn(*args)
    after = _flash_counts()
    cap.flash_launches = {k: after[k] - launches[k] for k in FLASH_COUNTERS}
    cap.aten_ops = mode.ops
    cap.collectives = _collectives(mode.raw, target)
    if state is not None:
        cap.state_after = [_storage(t) for t in state.after(out, args)]
    return out, cap
