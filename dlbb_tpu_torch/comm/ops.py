"""Collective operation registry (counterpart of ``dlbb_tpu/comm/ops.py``).

Data model
----------
The JAX builders take a global array whose leading axis is the rank axis,
sharded over the mesh; here each rank holds its own slab of that array,
the reference's per-rank buffer, and a builder's function maps this rank's
input slab to its output slab:

- ``per_rank`` — the slab is one buffer, ``[*shape]`` (row r of the JAX
  global ``[P, *shape]``);
- ``per_peer`` — the slab holds a buffer per peer, ``[P, *shape]`` (slab r
  of the JAX global ``[P, P, *shape]``), as MPI_Scatter's root sendbuf or
  MPI_Alltoall's.

Stacking every rank's output slab gives the JAX builder's global output.
The builders carry the JAX semantics, including where ``torch.distributed``
differs: rooted ops zero the output of every rank but the root (gather,
reduce), where the library leaves it undefined.  No builder writes to its
input: the sweep reuses one payload across ops.

Each ``build_*`` function returns a ``Collective``: ``prepare(x)`` makes the buffer the
call writes, and ``call(x, buf)`` runs the collective; ``fn(x)`` does both.
``torch.distributed``'s allreduce, broadcast and reduce are in place, so
their ``prepare`` copies the payload into a fresh output buffer, where the
reference's ``MPI_Allreduce(sendbuf, recvbuf)`` and the JAX ``psum`` are
out of place with no copy; ``utils.timing.time_collective`` runs
``prepare`` outside the timed interval.  The other ops write a buffer they
allocate, and their ``prepare`` does nothing.

``plain_collective`` computes the whole global output from the stacked
global input in one process with torch ops: the reference the CPU tests
and ``chip_smoke.py`` hold the ``torch.distributed`` result against.
Nothing on the sweep path calls it.

The collective-matmul micro-ops ``ag_matmul``/``matmul_rs`` take the 3D
sweep's ``[B, S, H]`` payload and a deterministic weight shard
(``_synth_weight``, JAX's formula), which their ``prepare`` makes once per
shape, outside the timed interval, where JAX computes it inside its jitted
call.  ``fused`` is the collective then the product (or the product then
the collective); ``ring``/``bidir`` are the decomposed schedules of
``parallel/collective_matmul.py``, selected by the ``overlap_*`` variants.

The quantised-wire micro-ops ``allreduce_q``/``reducescatter_q`` take
``allreduce``'s and ``reducescatter``'s payloads and run the rings of
``comm/compression.py``; ``compression`` and ``accum_dtype`` are the
``Variant.compression``/``Variant.accum_dtype`` knobs.  They are out of
place, so their ``prepare`` copies nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dlbb_tpu_torch.analysis.expectations import DEFAULT_COMPRESSION
from dlbb_tpu_torch.comm.compression import psum_compressed, reduce_scatter_compressed
from dlbb_tpu_torch.comm.mesh import Mesh, mesh_num_ranks
from dlbb_tpu_torch.models.sharding import reduce_scatter_along
from dlbb_tpu_torch.parallel.collective_matmul import _ag_matmul_body, _matmul_rs_body
from dlbb_tpu_torch.parallel.ring import FORWARD, Ring

DEFAULT_PAYLOAD_SEED = 42

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


@dataclass(frozen=True)
class CollectiveOp:
    """One benchmarkable collective.  ``input_kind``/``output_kind`` are
    ``per_rank`` or ``per_peer`` (module docstring); ``build(mesh, root=0)``
    returns the ``Collective`` from this rank's input slab to its output
    slab.  ``transient_kind`` declares the largest intermediate of the
    fused schedule, in the same units, where it exceeds the input and
    output (the gathered activation of ``ag_matmul``, the full partial
    product of ``matmul_rs``)."""

    name: str
    input_kind: str
    output_kind: str
    build: Callable[..., Collective]
    transient_kind: Optional[str] = None


def _no_buffer(x: torch.Tensor) -> None:
    return None


def _copy_of(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@dataclass(frozen=True)
class Collective:
    """This rank's side of a built collective; see the module docstring."""

    call: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
    prepare: Callable[[torch.Tensor], Optional[torch.Tensor]] = _no_buffer

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.call(x, self.prepare(x))


def _reduce_op(reduce_op: str):
    try:
        return _REDUCE_OPS[reduce_op]
    except KeyError:
        raise ValueError(f"unknown reduce op {reduce_op!r}") from None


def _single_axis(mesh: Mesh, name: str) -> None:
    if len(mesh.axis_names) != 1:
        raise ValueError(f"{name} requires a single mesh axis")


def build_allreduce(mesh: Mesh, root: int = 0, reduce_op: str = "sum"):
    """MPI_Allreduce with sum/max/min/prod (reference
    ``collectives/1d/openmpi.py:55-67``, ``test/test_open.py:248``)."""
    op = _reduce_op(reduce_op)

    def call(x, out):
        dist.all_reduce(out, op=op, group=mesh.group)
        return out

    return Collective(call, _copy_of)


def build_allreduce_hierarchical(mesh: Mesh, root: int = 0,
                                 reduce_op: str = "sum"):
    """Allreduce one mesh axis at a time, over each axis subgroup in the
    mesh's axis order (the JAX ring-of-rings psum)."""
    if reduce_op != "sum":
        raise ValueError("hierarchical allreduce supports sum only")
    groups = [mesh.axis_groups[a] for a in mesh.axis_names]

    def call(x, out):
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    return Collective(call, _copy_of)


def build_allgather(mesh: Mesh, root: int = 0):
    """MPI_Allgather: ``[*shape]`` in, every rank's buffer ``[P, *shape]``
    out (reference ``collectives/1d/openmpi.py:84-96``)."""
    p = mesh_num_ranks(mesh)

    def call(x, _):
        out = torch.empty((p,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        # the concatenated view: gloo takes only that, NCCL either
        dist.all_gather_into_tensor(out.view((-1,) + tuple(x.shape[1:])), x,
                                    group=mesh.group)
        return out

    return Collective(call)


def build_broadcast(mesh: Mesh, root: int = 0):
    """MPI_Bcast from ``root`` (reference ``collectives/1d/openmpi.py:98-110``)."""

    def call(x, out):
        dist.broadcast(out, src=root, group=mesh.group)
        return out

    return Collective(call, _copy_of)


def build_gather(mesh: Mesh, root: int = 0):
    """MPI_Gather to ``root``: the root's output ``[P, *shape]`` holds every
    rank's buffer, the others' are zero (reference
    ``collectives/1d/openmpi.py:112-124``)."""
    p = mesh_num_ranks(mesh)

    def call(x, _):
        is_root = mesh.rank == root
        out = (torch.empty if is_root else torch.zeros)(
            (p,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.gather(x, list(out.unbind(0)) if is_root else None,
                    dst=root, group=mesh.group)
        return out

    return Collective(call)


def build_scatter(mesh: Mesh, root: int = 0):
    """MPI_Scatter from ``root``: rank i receives row i of the root's
    ``[P, *shape]`` sendbuf (reference ``collectives/1d/openmpi.py:126-140``)."""

    def call(x, _):
        out = torch.empty(tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.scatter(out, list(x.unbind(0)) if mesh.rank == root else None,
                     src=root, group=mesh.group)
        return out

    return Collective(call)


def build_reduce(mesh: Mesh, root: int = 0, reduce_op: str = "sum"):
    """MPI_Reduce to ``root``: the reduction on the root, zero on the others
    (reference ``collectives/1d/openmpi.py:142-155``)."""
    op = _reduce_op(reduce_op)

    def call(x, out):
        dist.reduce(out, dst=root, op=op, group=mesh.group)
        if mesh.rank != root:
            out.zero_()
        return out

    return Collective(call, _copy_of)


def build_alltoall(mesh: Mesh, root: int = 0):
    """MPI_Alltoall: chunk j of this rank's ``[P, *shape]`` slab goes to rank
    j, and out[j] is rank j's chunk for this rank (reference
    ``collectives/1d/openmpi.py:157-171``)."""
    _single_axis(mesh, "alltoall")

    def call(x, _):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.group)
        return out

    return Collective(call)


def build_sendrecv(mesh: Mesh, root: int = 0):
    """Ring sendrecv: send to (r+1) % P, receive from (r-1) % P, wait for
    both (reference ``collectives/1d/openmpi.py:173-198``): one forward hop
    of ``parallel/ring.py``'s ``Ring``, which stages a CUDA buffer through
    host memory on a gloo group (gloo's point-to-point ops take no CUDA
    tensor).  A ring of one rank sends its buffer to itself, a copy (no
    backend sends to itself)."""
    _single_axis(mesh, "sendrecv ring")
    ring = Ring(mesh.group) if mesh_num_ranks(mesh) > 1 else None

    def call(x, _):
        if ring is None:
            return x.clone()
        return ring.shift([x], FORWARD)[0]

    return Collective(call)


def build_reducescatter(mesh: Mesh, root: int = 0):
    """MPI_Reduce_scatter: rank i gets the sum over ranks of their chunk i,
    as a ``[1, *shape]`` slab (the JAX global ``[P, 1, *shape]``)."""
    _single_axis(mesh, "reducescatter")

    def call(x, _):
        shape = tuple(x.shape[1:])
        out = torch.empty((1,) + shape, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out.view(shape), x.view((-1,) + shape[1:]),
                                   group=mesh.group)
        return out

    return Collective(call)


def build_barrier(mesh: Mesh, root: int = 0):
    """Barrier analogue (reference ``collectives/1d/openmpi.py:60``): a sum
    of a tiny buffer over the mesh, the JAX package's psum barrier."""
    return build_allreduce(mesh, root)


def _require_3d_payload(op_name: str, x: torch.Tensor) -> None:
    """A ``[B, S, H]`` slab for the collective-matmul ops: a flat 1D payload
    fails with a pointer at bench3d."""
    if x.dim() != 3:
        raise ValueError(
            f"{op_name} needs an LLM-shaped (B, S, H) payload — run it "
            "through the 3D sweep (bench3d / Sweep3D), not the flat 1D one"
        )


def _synth_weight(rows: int, cols: int, dtype, device, row_offset: int = 0,
                  col_offset: int = 0) -> torch.Tensor:
    """The JAX package's deterministic dense weight: ``cos(0.37 i + 0.11 j)
    / sqrt(rows)`` in fp32 at global row i and column j, cast to ``dtype``.
    The offsets select a shard of one global matrix, so every rank's shard
    agrees with it and the schedules are comparable bit for bit.  torch's
    fp32 cos and XLA's round differently: the fp32 values agree with JAX's
    within two ulps, the bf16 ones equal them on the shapes the tests draw."""
    i = torch.arange(rows, dtype=torch.float32, device=device)[:, None] + row_offset
    j = torch.arange(cols, dtype=torch.float32, device=device)[None, :] + col_offset
    return (torch.cos(i * 0.37 + j * 0.11) / np.sqrt(rows)).to(dtype)


# the collective-matmul micro-ops: the runner's variant dispatch and its
# memory estimate key off this tuple
MATMUL_OPS = ("ag_matmul", "matmul_rs")

_MICRO_SCHEDULES = ("fused", "ring", "bidir")


def _check_micro_schedule(schedule: str) -> None:
    if schedule not in _MICRO_SCHEDULES:
        raise ValueError(
            f"unknown collective-matmul schedule {schedule!r}; known: "
            f"{_MICRO_SCHEDULES}"
        )


def _weight_cache(make):
    """A ``prepare`` that makes the op's weight shard once per (shape,
    dtype, device) of the payload and hands it to ``call``."""
    cache: dict[tuple, torch.Tensor] = {}

    def prepare(x):
        key = (tuple(x.shape), x.dtype, x.device)
        if key not in cache:
            cache[key] = make(x)
        return cache[key]

    return prepare


def build_ag_matmul(mesh: Mesh, root: int = 0, schedule: str = "fused"):
    """All-gather + matmul (the column-parallel projection alone).  Payload:
    this rank's sequence chunk ``[B, S, H]``; each rank multiplies the
    gathered ``[B, P*S, H]`` sequence by its column shard of a ``[H, H]``
    weight, giving ``[B, P*S, H/P]`` (the input's bytes per rank).
    ``schedule``: "fused", one all-gather then the product; "ring"/"bidir",
    the decomposed overlapped schedule."""
    _single_axis(mesh, "ag_matmul")
    _check_micro_schedule(schedule)
    p = mesh_num_ranks(mesh)
    ring = None if schedule == "fused" else Ring(mesh.group)

    def make(x):
        _require_3d_payload("ag_matmul", x)
        h = x.shape[2]
        if h % p != 0:
            raise ValueError(f"ag_matmul: hidden dim {h} not divisible by {p} ranks")
        hp = h // p
        return _synth_weight(h, hp, x.dtype, x.device, col_offset=mesh.rank * hp)

    def call(x, w):
        if ring is not None:
            return _ag_matmul_body(x, w, ring, schedule == "bidir")
        b, s, h = x.shape
        g = torch.empty((p * b, s, h), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(g, x, group=mesh.group)  # [P, B, S, H]
        return g.view(p, b, s, h).transpose(0, 1).reshape(b, p * s, h) @ w

    return Collective(call, _weight_cache(make))


def build_matmul_rs(mesh: Mesh, root: int = 0, schedule: str = "fused"):
    """Matmul + reduce-scatter (the row-parallel projection alone).
    Payload: this rank's feature shard ``[B, S, H]`` of a ``[B, S, P*H]``
    activation; each rank multiplies by its row shard of a ``[P*H, H]``
    weight and the partial products are reduce-scattered over the sequence
    to ``[B, S/P, H]``.  ``schedule``: "fused", the product then one
    reduce-scatter; "ring"/"bidir", the decomposed overlapped schedule."""
    _single_axis(mesh, "matmul_rs")
    _check_micro_schedule(schedule)
    p = mesh_num_ranks(mesh)
    ring = None if schedule == "fused" else Ring(mesh.group)

    def make(x):
        _require_3d_payload("matmul_rs", x)
        s, h = x.shape[1], x.shape[2]
        if s % p != 0:
            raise ValueError(f"matmul_rs: sequence {s} not divisible by {p} ranks")
        return _synth_weight(h, h, x.dtype, x.device, row_offset=mesh.rank * h)

    def call(x, w):
        if ring is not None:
            return _matmul_rs_body(x, w, ring, schedule == "bidir")
        return reduce_scatter_along(x @ w, 1, mesh.group)

    return Collective(call, _weight_cache(make))


# the compressed (quantised-wire) micro-ops: the runner's variant dispatch
# keys off this tuple
COMPRESSED_OPS = ("allreduce_q", "reducescatter_q")


def build_allreduce_q(mesh: Mesh, root: int = 0, compression: str = DEFAULT_COMPRESSION,
                      accum_dtype=torch.float32):
    """Quantised all-reduce (``compression.psum_compressed``): the ring
    reduce-scatter in the wire dtype, then the all-gather of the quantised
    reduced chunks.  ``allreduce``'s payload, so a sweep prices compressed
    against fused on the same logical bytes."""
    _single_axis(mesh, "allreduce_q")

    def call(x, _):
        return psum_compressed(x, mesh.group, compression=compression,
                               accum_dtype=accum_dtype).to(x.dtype)

    return Collective(call)


def build_reducescatter_q(mesh: Mesh, root: int = 0,
                          compression: str = DEFAULT_COMPRESSION,
                          accum_dtype=torch.float32):
    """Quantised reduce-scatter (``compression.reduce_scatter_compressed``),
    the ring of ``allreduce_q`` alone, on ``reducescatter``'s ``[P, *shape]``
    slab; the ``[1, *shape]`` output holds this rank's reduced row."""
    _single_axis(mesh, "reducescatter_q")

    def call(x, _):
        out = reduce_scatter_compressed(x, mesh.group, compression=compression,
                                        accum_dtype=accum_dtype)
        return out.unsqueeze(0).to(x.dtype)

    return Collective(call)


OPERATIONS: dict[str, CollectiveOp] = {
    op.name: op for op in (
        CollectiveOp("allreduce", "per_rank", "per_rank", build_allreduce),
        CollectiveOp("allgather", "per_rank", "per_peer", build_allgather),
        CollectiveOp("broadcast", "per_rank", "per_rank", build_broadcast),
        CollectiveOp("gather", "per_rank", "per_peer", build_gather),
        CollectiveOp("scatter", "per_peer", "per_rank", build_scatter),
        CollectiveOp("reduce", "per_rank", "per_rank", build_reduce),
        CollectiveOp("alltoall", "per_peer", "per_peer", build_alltoall),
        CollectiveOp("sendrecv", "per_rank", "per_rank", build_sendrecv),
        # the [1, *shape] output holds one reduced row
        CollectiveOp("reducescatter", "per_peer", "per_rank",
                     build_reducescatter),
        CollectiveOp("allreduce_hierarchical", "per_rank", "per_rank",
                     build_allreduce_hierarchical),
        CollectiveOp("ag_matmul", "per_rank", "per_rank", build_ag_matmul,
                     transient_kind="per_peer"),
        CollectiveOp("matmul_rs", "per_rank", "per_rank", build_matmul_rs,
                     transient_kind="per_rank"),
        CollectiveOp("allreduce_q", "per_rank", "per_rank", build_allreduce_q),
        CollectiveOp("reducescatter_q", "per_peer", "per_rank", build_reducescatter_q),
    )
}


def get_op(name: str) -> CollectiveOp:
    try:
        return OPERATIONS[name]
    except KeyError:
        raise KeyError(
            f"unknown collective {name!r}; known: {sorted(OPERATIONS)}") from None


def payload_global_shape(op: CollectiveOp, num_ranks: int, num_elements: int,
                         shape: Optional[Sequence[int]] = None) -> tuple[int, ...]:
    """Shape of the JAX global input array ``make_payload`` slabs are rows of."""
    per_rank_shape = tuple(shape) if shape is not None else (num_elements,)
    if op.input_kind == "per_peer":
        return (num_ranks, num_ranks) + per_rank_shape
    return (num_ranks,) + per_rank_shape


def make_payload(op: CollectiveOp, rank: int, num_ranks: int,
                 num_elements: int, dtype=torch.bfloat16,
                 seed: int = DEFAULT_PAYLOAD_SEED,
                 shape: Optional[Sequence[int]] = None,
                 device="cpu") -> torch.Tensor:
    """This rank's slab of the JAX package's ``make_payload`` global array,
    bit for bit: each rank's buffer is numpy ``default_rng(seed + rank)``
    ``standard_normal`` in fp32 rounded to ``dtype`` (the reference's
    ``seed + rank``, ``collectives/1d/openmpi.py:247-248``); a ``per_peer``
    slab r holds the buffers of ranks ``(i - r) % P`` for i = 0..P-1.
    ``shape`` gives a shaped buffer (the 3D sweeps' ``(B, S, H)``), else a
    flat ``[num_elements]``."""
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    per_rank_shape = tuple(shape) if shape is not None else (num_elements,)

    def buffer(r: int) -> torch.Tensor:
        rng = np.random.default_rng(seed + r)
        return torch.from_numpy(
            rng.standard_normal(per_rank_shape, dtype=np.float32)).to(dtype)

    if op.input_kind == "per_peer":
        host = torch.stack([buffer((i - rank) % num_ranks)
                            for i in range(num_ranks)])
    else:
        host = buffer(rank)
    return host.to(device)


def _reduce(g: torch.Tensor, reduce_op: str, dim: int = 0, keepdim: bool = False):
    if reduce_op == "sum":
        return g.sum(dim, keepdim=keepdim)
    if reduce_op == "max":
        return g.amax(dim, keepdim=keepdim)
    if reduce_op == "min":
        return g.amin(dim, keepdim=keepdim)
    if reduce_op == "prod":
        return g.prod(dim, keepdim=keepdim)
    raise ValueError(f"unknown reduce op {reduce_op!r}")


def plain_collective(name: str, global_array: torch.Tensor, root: int = 0,
                     reduce_op: str = "sum",
                     mesh_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The global output of collective ``name`` from its global input (every
    rank's slab stacked on dim 0), in one process with torch ops.  Sums
    are torch's reductions in the input's dtype.  ``mesh_shape`` orders the
    hierarchical allreduce's sums, one mesh axis at a time."""
    g = global_array
    p = g.shape[0]
    if name in ("allreduce", "allreduce_hierarchical"):
        if name == "allreduce_hierarchical":
            if reduce_op != "sum":
                raise ValueError("hierarchical allreduce supports sum only")
            shape = tuple(mesh_shape) if mesh_shape is not None else (p,)
            total = g.reshape(shape + tuple(g.shape[1:]))
            for axis in range(len(shape)):
                total = total.sum(axis, keepdim=True)
            total = total.reshape(g.shape[1:])
        else:
            total = _reduce(g, reduce_op)
        return total.unsqueeze(0).expand_as(g).clone()
    if name == "allgather":
        return g.unsqueeze(0).expand((p,) + tuple(g.shape)).clone()
    if name == "gather":
        out = torch.zeros((p,) + tuple(g.shape), dtype=g.dtype, device=g.device)
        out[root] = g
        return out
    if name == "broadcast":
        return g[root].unsqueeze(0).expand_as(g).clone()
    if name == "scatter":
        return g[root].clone()
    if name == "reduce":
        out = torch.zeros_like(g)
        out[root] = _reduce(g, reduce_op)
        return out
    if name == "alltoall":
        return g.transpose(0, 1).contiguous()
    if name == "sendrecv":
        return torch.roll(g, 1, dims=0)
    if name == "reducescatter":
        return g.sum(0).unsqueeze(1)
    if name == "ag_matmul":  # [P, B, S, H] -> [P, B, P*S, H/P]
        _, b, s, h = g.shape
        hp = h // p
        w = _synth_weight(h, h, g.dtype, g.device)
        gathered = g.transpose(0, 1).reshape(b, p * s, h)
        return torch.stack([gathered @ w[:, r * hp:(r + 1) * hp] for r in range(p)])
    if name == "matmul_rs":  # [P, B, S, H] -> [P, B, S/P, H]
        h = g.shape[3]

        def partial(r):
            return g[r] @ _synth_weight(h, h, g.dtype, g.device, row_offset=r * h)

        total = partial(0)
        for r in range(1, p):
            total = total + partial(r)
        return torch.stack(total.chunk(p, dim=1))
    raise KeyError(f"no plain version of collective {name!r}")
