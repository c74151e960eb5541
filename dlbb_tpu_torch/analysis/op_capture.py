"""The op capture: what one call of a target issues, as a dataflow graph
(the port's counterpart of ``dlbb_tpu/analysis/hlo_parse.py``).

JAX's auditors read the compiled, post-SPMD HLO module of a target: its
instructions, their operands, shapes and dtypes, and the collectives among
them.  Eager torch compiles no program, but every op it runs goes through
the dispatcher, so the port's counterpart of "the lowered program" is the
op stream one call of the target records (``capture_call``, a
``TorchDispatchMode``), turned into a graph of ``OpNode``s:

- **one node per op**: its name, the tensors it reads and writes (each a
  ``TensorRef``: buffer id, bytes, dtype in HLO's names, shape, device,
  the schema argument it came in, and for a read the node that last wrote
  the buffer), whether each output is a new buffer, a view of an input or
  an in-place write into one, and its scalar arguments as far as pricing
  needs them (dims, ``dtype=``, ``alpha``/``beta``);
- **buffers**: a buffer is one allocation.  It is keyed by its storage's
  ``StorageImpl`` under a weak reference, so that a new tensor at a freed
  address (the caching allocator reuses them) is a new buffer; the capture
  keeps no strong reference to any tensor, so it moves no lifetime the
  memory pass measures.  A view shares its base's buffer;
- **edges**: a node depends on the last writer of each buffer it reads,
  and a node that writes a buffer (in place, or through ``out=``) also on
  the readers since the buffer's last write;
- **collectives**: each ``c10d`` op becomes a node with its kind
  (``analysis/expectations.C10D_KINDS``), per-rank result bytes and group
  size, and a ``CollectiveInstr`` with JAX's fields in
  ``Capture.collectives`` read from the node.  A ``send``/``recv_`` pair
  is one ``collective-permute`` (XLA's ppermute is one instruction): the
  later op of the pair carries it and depends on the earlier, which is
  marked ``merged``; its ``CollectiveInstr`` is read from the pair's
  receive (its place, tensor and bytes), and a send or receive left
  unpaired is a permute of its own.  The stream is execution-weighted by nature (each executed
  call is recorded, which is what JAX's while-body trip weighting
  emulates), so every ``execution_count`` is 1;
- **waits**: ``Work.wait()`` is not a dispatcher op, so a posted ring hop
  marks its wait itself (``parallel/ring.py::Hop.wait`` calls the
  ``capture_hook`` the capture sets there; other code calls
  ``note_wait``): a ``c10d::wait`` node that depends on the hop and
  becomes the writer of the received buffers.  The ops between a hop and
  its wait are its overlap window, as between XLA's async start and done;
- **kernels**: the flash kernels are launched through ``ctypes`` and never
  reach the dispatcher, so each wrapper that counts a launch also hands
  the ``capture_hook`` the capture sets in ``ops/flash_attention.py`` a
  node (``_Recorder.record_kernel``) with its inputs as reads, its outputs
  as writes and its visible-pair flops;
- **donation**: a target names its state tensors (parameters, optimiser
  moments, the KV cache).  Their storages are noted before and after the
  call; ``Capture.has_donation`` holds when every state tensor kept its
  storage, that is when the call updated its state in place, as XLA does
  with a donated buffer.

``Capture.aten_ops`` (the dispatcher's op names, in order) and
``flash_launches`` (the deltas of the kernels' counters) are kept as the
collective audit reads them.  The capture adds no host sync and does not
change what the target computes.  The module imports torch lazily, inside
the functions that record.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

from dlbb_tpu_torch.analysis.expectations import C10D_KINDS

FLASH_COUNTERS = ("flash_fwd_launches", "flash_bwd_dq_launches", "flash_bwd_dkv_launches")

# the node of a posted hop's wait (``note_wait``)
WAIT_OP = "c10d::wait"

# torch dtype name -> HLO element type (the passes speak JAX's names)
HLO_DTYPES = {
    "float64": "f64", "float32": "f32", "float16": "f16", "bfloat16": "bf16",
    "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2", "int8": "s8", "uint8": "u8",
    "int16": "s16", "int32": "s32", "int64": "s64", "bool": "pred",
    "complex64": "c64", "complex128": "c128",
}
_TORCH_DTYPES = {v: k for k, v in HLO_DTYPES.items()}

# the arguments a c10d op writes (its schema carries no alias annotations);
# ``tensors`` is written by every op that takes it but ``send``
_C10D_OUTPUTS = ("output_tensor", "output_tensors", "output", "outputs")

_REPO_ROOT = Path(__file__).resolve().parents[2]
_RING = "dlbb_tpu_torch/parallel/ring.py"

# the capture recording now (``note_wait`` writes into it)
_ACTIVE: Optional["_Recorder"] = None


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


@dataclass(frozen=True)
class TensorRef:
    """One tensor an op read or wrote."""

    buf: int                    # buffer id: one allocation
    bytes: int                  # the tensor's own bytes (numel x itemsize)
    dtype: str                  # HLO element type ("f32", "bf16", "s8", ...)
    shape: tuple[int, ...]
    device: str                 # "cpu" or "cuda"
    arg: str = ""               # schema argument ("self", "mat2", "out", ...)
    writer: int = -1            # a read's last writer (-1: none in the call)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass
class OpNode:
    """One op of the captured call (module docstring)."""

    index: int
    op: str                                       # "aten::mm", "c10d::send", ...
    reads: list[TensorRef] = field(default_factory=list)
    outputs: list[TensorRef] = field(default_factory=list)
    out_kinds: list[str] = field(default_factory=list)   # "new" | "view" | "inplace"
    deps: list[int] = field(default_factory=list)
    args: dict[str, Any] = field(default_factory=dict)
    flops: int = 0                                # kernel nodes: their own count
    stream_index: int = -1                        # place in ``Capture.aten_ops``
    kind: Optional[str] = None                    # a collective's kind
    result_bytes: int = 0                         # a collective's per-rank result
    group_size: Optional[int] = None
    group: Optional[tuple] = None                 # (name, global ranks) of its group
    source: Optional[str] = None                  # a collective's call site
    lead: Optional[TensorRef] = None              # a collective's first tensor
    hop_site: Optional[str] = None                # the caller of the ring hop
    merged: bool = False                          # a permute pair's earlier op
    partner: int = -1                             # the other op of a permute pair

    @property
    def writes(self) -> list[TensorRef]:
        return [t for t, k in zip(self.outputs, self.out_kinds) if k != "view"]


@dataclass
class BufferInfo:
    """One allocation seen by the capture."""

    nbytes: int
    device: str
    dtype: str
    defined_at: int = -1        # the node that created it (-1: before the call)


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
    # the graph
    nodes: list[OpNode] = field(default_factory=list)
    buffers: dict[int, BufferInfo] = field(default_factory=dict)
    arg_buffers: list[int] = field(default_factory=list)     # in argument order
    out_buffers: list[int] = field(default_factory=list)
    state_buffers: list[int] = field(default_factory=list)   # before the call
    outlived: set[int] = field(default_factory=set)          # still allocated after it
    device: str = "cpu"                                      # the arguments' device

    @property
    def has_donation(self) -> bool:
        """Every state tensor kept its storage: the call updated its state
        in place."""
        return bool(self.state_before) and self.state_before == self.state_after

    @property
    def donated_buffers(self) -> list[int]:
        """The state buffers that kept their storage across the call."""
        kept = set(self.state_after)
        return [b for b, s in zip(self.state_buffers, self.state_before) if s in kept]


def _tensors(value) -> list:
    """The tensors of an argument (a tensor, or nested lists of them)."""
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _tree_tensors(tree, depth: int = 0) -> list:
    """The tensors of a call's arguments or result: tensors inside dicts,
    lists, tuples (NamedTuples) and dataclasses, in order."""
    import dataclasses

    import torch

    if depth > 8:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in _tree_tensors(tree[k], depth + 1)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_tensors(v, depth + 1)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tree_tensors(getattr(tree, f.name), depth + 1)]
    return []


def _nbytes(tensors: list) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _group_of(func, args):
    """The op's process group (None where it cannot be read)."""
    import torch.distributed as dist

    for i, arg in enumerate(func._schema.arguments):
        if arg.name == "process_group" and i < len(args):
            try:
                return dist.ProcessGroup.unbox(args[i])
            except (RuntimeError, AttributeError):
                return None
    return None


def _group_size(func, args) -> Optional[int]:
    """The size of the op's process-group argument."""
    pg = _group_of(func, args)
    return None if pg is None else int(pg.size())


def _group_id(func, args) -> Optional[tuple]:
    """(name, global ranks) of the op's process group."""
    import torch.distributed as dist

    pg = _group_of(func, args)
    if pg is None:
        return None
    try:
        return str(pg.group_name), tuple(dist.get_process_group_ranks(pg))
    except (RuntimeError, ValueError, KeyError):
        return None


def _repo_frames(skip: tuple[str, ...] = ()):
    """``file:line`` of each frame in the repo outside this module and
    torch, innermost first (the port code that issued the op), leaving out
    frames of the files in ``skip``."""
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
        name = rel.as_posix()
        if resolved != here and "site-packages" not in rel.parts and name not in skip:
            yield f"{name}:{frame.f_lineno}"
        frame = frame.f_back


def _hlo_dtype(t) -> str:
    name = str(t.dtype).replace("torch.", "")
    return HLO_DTYPES.get(name, name)


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def _device_type(t) -> str:
    return t.device.type


def _scalar(value) -> Any:
    """A non-tensor argument as the passes read it, or None to drop it."""
    import torch

    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    if isinstance(value, torch.dtype):
        name = str(value).replace("torch.", "")
        return HLO_DTYPES.get(name, name)
    if isinstance(value, (list, tuple)) and all(isinstance(v, (int, float)) for v in value):
        return list(value)
    if isinstance(value, torch.device):
        return value.type
    if isinstance(value, torch.ScriptObject) and value._has_method("op"):
        return int(value.op())   # a c10d ReduceOp, as ``dist.ReduceOp``'s number
    return None


class _Recorder:
    """The state of one capture: the buffer table and the graph under
    construction."""

    def __init__(self) -> None:
        self.ops: list[str] = []
        self.nodes: list[OpNode] = []
        self.buffers: dict[int, BufferInfo] = {}
        self._keys: dict[int, tuple[Any, int]] = {}   # StorageImpl -> (weak ref, id)
        self._last_writer: dict[int, int] = {}
        self._readers: dict[int, list[int]] = {}
        self._pending_sends: list[int] = []             # node indices
        self._pending_recvs: list[int] = []

    # -- buffers ------------------------------------------------------------

    def buffer(self, t) -> tuple[int, bool]:
        """(buffer id of ``t``'s storage, whether it is new to the capture)."""
        from torch.multiprocessing.reductions import StorageWeakRef

        storage = t.untyped_storage()
        key = storage._cdata
        hit = self._keys.get(key)
        if hit is not None and not hit[0].expired():
            return hit[1], False
        buf = len(self.buffers)
        self._keys[key] = (StorageWeakRef(storage), buf)
        self.buffers[buf] = BufferInfo(
            nbytes=int(storage.nbytes()), device=_device_type(t),
            dtype=_hlo_dtype(t))
        return buf, True

    def ref(self, t, arg: str = "", read: bool = False) -> TensorRef:
        buf, _ = self.buffer(t)
        return TensorRef(
            buf=buf, bytes=int(t.numel() * t.element_size()), dtype=_hlo_dtype(t),
            shape=tuple(t.shape), device=_device_type(t), arg=arg,
            writer=self._last_writer.get(buf, -1) if read else -1)

    # -- nodes --------------------------------------------------------------

    def add_node(self, node: OpNode) -> OpNode:
        """Wire ``node``'s edges (module docstring) and append it."""
        n = node.index = len(self.nodes)
        deps = set(node.deps)
        for r in node.reads:
            w = self._last_writer.get(r.buf)
            if w is not None:
                deps.add(w)
        for t, k in zip(node.outputs, node.out_kinds):
            if k == "view":
                continue
            w = self._last_writer.get(t.buf)
            if w is not None:
                deps.add(w)
            deps.update(self._readers.get(t.buf, ()))
        deps.discard(n)
        node.deps = sorted(deps)
        for r in node.reads:
            self._readers.setdefault(r.buf, []).append(n)
        for t, k in zip(node.outputs, node.out_kinds):
            if k == "view":
                continue
            if k == "new" and self.buffers[t.buf].defined_at < 0:
                self.buffers[t.buf].defined_at = n
            self._last_writer[t.buf] = n
            self._readers[t.buf] = []
        self.nodes.append(node)
        return node

    def record_op(self, func, args, kwargs, out) -> None:
        schema = func._schema
        name = func.name()
        reads: list[TensorRef] = []
        mutated: list[tuple[str, Any]] = []
        scalars: dict[str, Any] = {}
        c10d = name.startswith("c10d::")
        inputs = list(zip(schema.arguments, args)) + [
            (a, kwargs[a.name]) for a in schema.arguments if a.name in kwargs]
        for a, value in inputs:
            tensors = _tensors(value)
            if tensors:
                for t in tensors:
                    reads.append(self.ref(t, a.name, read=True))
                if c10d:
                    written = a.name in _C10D_OUTPUTS or (a.name == "tensors"
                                                          and name != "c10d::send")
                else:
                    written = a.alias_info is not None and a.alias_info.is_write
                if written:
                    mutated += [(a.name, t) for t in tensors]
            else:
                s = _scalar(value)
                if s is not None or value is None:
                    scalars[a.name] = s
        outputs, kinds = [], []
        mutated_bufs = set()
        for arg, t in mutated:
            ref = self.ref(t, arg)
            mutated_bufs.add(ref.buf)
            outputs.append(ref)
            kinds.append("inplace")
        for t in _tensors(out if isinstance(out, (list, tuple)) else [out]):
            buf, new = self.buffer(t)
            if buf in mutated_bufs:
                continue
            outputs.append(self.ref(t))
            # an output on a buffer seen before aliases it: a view
            kinds.append("new" if new else "view")
        node = OpNode(index=-1, op=name, reads=reads, outputs=outputs, out_kinds=kinds,
                      args=scalars, stream_index=len(self.ops) - 1)
        if c10d:
            self._collective(node, func, args)
        self.add_node(node)
        if node.kind == "collective-permute":
            self._pair(node)

    def _collective(self, node: OpNode, func, args) -> None:
        # a c10d op outside the vocabulary keeps its own name as its kind,
        # which no expectation allows: it is flagged, not lost
        name = node.op
        kind = C10D_KINDS.get(name.split("::", 1)[1], name)
        first = _tensors(args[0]) if args else []
        if kind == "gather":
            # the gathered buffer, whether this rank is the root or not: the
            # group size x the input
            size = _group_size(func, args) or 1
            first = _tensors(args[1])
            nbytes = size * _nbytes(first)
        else:
            size = _group_size(func, args)
            nbytes = _nbytes(first)
        frames = list(_repo_frames())
        node.source = frames[0] if frames else None
        node.hop_site = next((f for f in frames if not f.startswith(_RING + ":")), None)
        node.kind = kind
        node.group = _group_id(func, args)
        node.result_bytes = int(nbytes)
        node.group_size = 2 if kind == "collective-permute" else size
        node.lead = self.ref(first[0]) if first else None

    def _pair(self, node: OpNode) -> None:
        """A permute's send and receive: the later of the two carries the
        pair (module docstring)."""
        mine, other = ((self._pending_sends, self._pending_recvs) if node.op == "c10d::send"
                       else (self._pending_recvs, self._pending_sends))
        if not other:
            mine.append(node.index)
            return
        first = self.nodes[other.pop(0)]
        first.merged, first.partner, node.partner = True, node.index, first.index
        if first.index not in node.deps:
            node.deps = sorted(set(node.deps) | {first.index})
        if node.op == "c10d::send":   # the pair's result is the received buffer
            node.result_bytes = first.result_bytes

    def note_wait(self, tensors) -> None:
        """A posted hop's wait: one node that depends on the hop's
        permutes and writes the received tensors (module docstring)."""
        reads = [self.ref(t, "tensors", read=True) for t in tensors]
        deps = set()
        for r in reads:
            w = self._last_writer.get(r.buf)
            if w is not None:
                node = self.nodes[w]
                deps.add(node.partner if node.merged else w)
        outputs = [self.ref(t, "tensors") for t in tensors]
        self.add_node(OpNode(index=-1, op=WAIT_OP, reads=reads, outputs=outputs,
                             out_kinds=["inplace"] * len(outputs), deps=sorted(deps)))

    def record_kernel(self, op: str, reads: dict, writes: dict, flops: int,
                      args: Optional[dict] = None) -> None:
        """A kernel launched outside the dispatcher: its inputs as reads,
        its outputs as in-place writes (the wrapper allocated them)."""
        rs = [self.ref(t, name, read=True) for name, t in reads.items() if t is not None]
        ws = [self.ref(t, name) for name, t in writes.items() if t is not None]
        self.add_node(OpNode(index=-1, op=op, reads=rs, outputs=ws,
                             out_kinds=["inplace"] * len(ws), flops=int(flops),
                             args=dict(args or {})))


def _make_mode(rec: _Recorder):
    """A ``TorchDispatchMode`` that records into ``rec`` (built on first
    use: torch is imported lazily)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            rec.ops.append(func.name())
            out = func(*args, **kwargs)
            rec.record_op(func, args, kwargs, out)
            return out

    return _Mode()


def note_wait(tensors) -> None:
    """Mark the wait of a posted hop whose received tensors are
    ``tensors`` in the active capture; nothing without one."""
    if _ACTIVE is not None:
        _ACTIVE.note_wait(tensors)


def _instr(node: OpNode, target: str) -> CollectiveInstr:
    t = node.lead
    if node.group is not None:
        size = len(node.group[1])
    else:
        size = None if node.kind == "collective-permute" else node.group_size
    index, name = node.stream_index, node.op
    return CollectiveInstr(
        kind=node.kind, dtype=_TORCH_DTYPES.get(t.dtype, t.dtype) if t else "",
        shape=t.shape if t else (), result_bytes=node.result_bytes,
        replica_groups=f"{{group of {size}}}" if size else "", group_count=1,
        group_size=node.group_size, source=node.source, raw=name, computation=target,
        name=f"{name.split('::', 1)[1]}.{index}", op_name=name, index=index)


def _collectives(nodes: list[OpNode], target: str) -> list[CollectiveInstr]:
    """The graph's collective nodes as collectives, one per permute pair
    (read from its receive) and one per other c10d op, in stream order."""
    out = []
    for node in nodes:
        if node.kind is None or node.merged:
            continue
        if node.op == "c10d::send" and node.partner >= 0:
            node = nodes[node.partner]
        out.append(_instr(node, target))
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
    global _ACTIVE
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.parallel import ring

    cap = Capture()
    rec = _Recorder()
    arg_tensors = _tree_tensors(args)
    cap.arg_buffers = list(dict.fromkeys(rec.buffer(t)[0] for t in arg_tensors))
    if arg_tensors:
        cap.device = _device_type(arg_tensors[0])
    if state is not None:
        before = state.before(args)
        cap.state_before = [_storage(t) for t in before]
        cap.state_buffers = [rec.buffer(t)[0] for t in before]
    launches = _flash_counts()
    outer = _ACTIVE, fa.capture_hook, ring.capture_hook
    _ACTIVE, fa.capture_hook, ring.capture_hook = rec, rec.record_kernel, rec.note_wait
    try:
        with _make_mode(rec):
            out = fn(*args)
    finally:
        _ACTIVE, fa.capture_hook, ring.capture_hook = outer
    after = _flash_counts()
    cap.flash_launches = {k: after[k] - launches[k] for k in FLASH_COUNTERS}
    cap.aten_ops = rec.ops
    cap.collectives = _collectives(rec.nodes, target)
    cap.nodes, cap.buffers = rec.nodes, rec.buffers
    cap.out_buffers = list(dict.fromkeys(rec.buffer(t)[0] for t in _tree_tensors(out)))
    cap.outlived = {buf for ref, buf in rec._keys.values() if not ref.expired()}
    if state is not None:
        cap.state_after = [_storage(t) for t in state.after(out, args)]
    return out, cap
