"""Process groups for the collective sweeps (counterpart of
``dlbb_tpu/comm/mesh.py``).

The JAX package runs SPMD: one process holds a global ``[P, ...]`` array
sharded over a ``jax.sharding.Mesh``.  The port runs MPMD, like the
reference's MPI harnesses (``collectives/1d/openmpi.py``): one process per
rank, each holding its own buffer, joined by ``torch.distributed``.  A
``MeshSpec`` of P ranks becomes the process group of the first P ranks of
the world, as ``get_mesh`` takes the first P devices in JAX; the ranks past
P sit that mesh out.  A grid shape adds, for each mesh axis, the subgroup
of the ranks that differ only along that axis (row-major rank order, as
``np.reshape`` lays the JAX mesh out), for the hierarchical allreduce.

A mesh starts at rank 0 unless it is built over a rank list (``get_mesh``'s
``ranks``: a serving fleet's replicas, one contiguous group of ranks each).
``Mesh.rank`` is a rank's index in its mesh, and ``Mesh.global_rank`` turns
an index into the global rank that ``torch.distributed`` addresses
(``src`` and ``dst``).  For a fleet a "device" is a rank of the world:
``available_devices``, ``partition_devices`` and ``fault_domain_record``
keep JAX's names, arguments and errors over rank numbers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the flat collective axis of the 1D microbenchmarks: MPI_COMM_WORLD's ranks
DEFAULT_AXIS = "ranks"

# the process group's backend for each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh description: devices per axis and one name per axis,
    e.g. ``(8,)``/``("ranks",)`` or ``(2, 4)``/``("outer", "inner")``."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...] = (DEFAULT_AXIS,)

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axis_names):
            raise ValueError(
                f"shape {self.shape} and axis_names {self.axis_names} "
                "must have the same length")

    @classmethod
    def ring(cls, num_ranks: int, axis: str = DEFAULT_AXIS) -> "MeshSpec":
        """1D ring of ``num_ranks`` ranks, the default microbenchmark mesh."""
        return cls((num_ranks,), (axis,))

    @classmethod
    def grid(cls, shape: Sequence[int], axis_names: Sequence[str]) -> "MeshSpec":
        """Multi-axis mesh, e.g. ``grid((2, 2, 2), ("x", "y", "z"))``."""
        return cls(tuple(shape), tuple(axis_names))

    @property
    def num_ranks(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.shape)


@dataclass(frozen=True)
class Mesh:
    """This process's view of a mesh it belongs to.

    ``group`` spans every rank of the mesh; ``axis_groups[a]`` spans the
    ranks that share this rank's coordinates on every axis but ``a``."""

    spec: MeshSpec
    rank: int
    group: Any
    axis_groups: dict[str, Any]
    # the global rank of each index of the mesh; None: index i is rank i
    ranks: Optional[tuple[int, ...]] = None

    def global_rank(self, index: int) -> int:
        """The global rank of the mesh's ``index``-th rank."""
        return index if self.ranks is None else self.ranks[index]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.spec.axis_names

    @property
    def shape(self) -> dict[str, int]:
        """Ranks per axis, by axis name (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.spec.axis_names, self.spec.shape))

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index along each axis, by axis name."""
        index = np.unravel_index(self.rank, self.spec.shape)
        return {a: int(i) for a, i in zip(self.spec.axis_names, index)}


def initialize_distributed(backend: str, rank: int, world_size: int,
                           init_file: Optional[str] = None,
                           timeout: Optional[float] = None) -> None:
    """Join the default process group (the reference's ``MPI.COMM_WORLD``,
    ``run_mpi.py:29-43``).

    ``init_file`` names a file that does not exist yet: the ranks meet
    through a ``FileStore`` on it (``file://``), so concurrent launches on one
    host never race for a TCP port.  ``None`` reads torchrun's ``env://``
    variables instead.  On ``nccl`` the caller has set this process's CUDA
    device first; it is bound to the group.  ``timeout`` (seconds) bounds
    each collective's wait; None keeps the backend's default.
    """
    if init_file is None:
        init_method = "env://"
    else:
        init_method = Path(init_file).resolve().as_uri()
    kwargs: dict[str, Any] = {}
    if timeout is not None:
        kwargs["timeout"] = timedelta(seconds=timeout)
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)


def destroy_distributed() -> None:
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def available_devices(platform: Optional[str] = None) -> list[int]:
    """The fleet's devices: the ranks of the world (``[0]`` without a
    process group), as JAX's ``available_devices`` lists its devices.
    ``platform`` filters as JAX's does: the ranks when it names this
    world's device type (``cuda``/``gpu`` on an NCCL world or on ranks
    that hold a GPU, ``cpu`` otherwise), else none."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if platform is not None:
        on_gpu = torch.cuda.is_available() and torch.cuda.is_initialized()
        kind = "cuda" if on_gpu or (dist.is_initialized()
                                    and dist.get_backend() == "nccl") else "cpu"
        if {"gpu": "cuda"}.get(platform, platform) != kind:
            return []
    return list(range(world))


def partition_devices(devices: Optional[Sequence] = None,
                      groups: int = 1) -> list[list]:
    """Partition the device list (the ranks, by default) into ``groups``
    contiguous, equal-size, disjoint failure domains: the replicas of the
    serving fleet (``serve/fleet.py``), each a contiguous group of ranks
    that no other replica shares.  Raises when the count does not divide
    evenly (a lopsided fleet would skew every per-replica capacity
    claim), as JAX's does."""
    devs = list(devices) if devices is not None else available_devices()
    if groups < 1:
        raise ValueError(f"need at least one device group, got {groups}")
    if len(devs) % groups != 0:
        raise ValueError(
            f"{len(devs)} device(s) do not partition into {groups} "
            "equal failure domains"
        )
    per = len(devs) // groups
    return [devs[i * per:(i + 1) * per] for i in range(groups)]


def fault_domain_record(groups: Sequence[Sequence]) -> dict[str, list[int]]:
    """JSON-able ``fault_domains`` map (replica id -> its devices: rank
    numbers, or each device's ``id``) for the topology record and the
    serving manifest, JAX's key that keeps fleet runs from aggregating
    with single-replica runs."""
    return {
        str(i): [int(d) if isinstance(d, (int, np.integer)) else int(getattr(d, "id", j))
                 for j, d in enumerate(grp)]
        for i, grp in enumerate(groups)
    }


def get_mesh(spec: MeshSpec, ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The mesh of the first ``spec.num_ranks`` ranks of the world, or of
    ``ranks`` (global ranks, in the mesh's row-major order) when given.

    A collective call: every rank of the world calls it, in the same order
    (``torch.distributed.new_group`` is), and the ranks outside the mesh get
    None.  Raises when the world is smaller than the spec, as JAX's
    ``build_mesh`` does with too few devices."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = spec.num_ranks
    if n > world:
        raise ValueError(f"mesh spec {spec.shape} needs {n} ranks, only "
                         f"{world} in the process group")
    members = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if len(members) != n or len(set(members)) != n or not all(0 <= r < world for r in members):
        raise ValueError(f"mesh spec {spec.shape} needs {n} distinct ranks of the "
                         f"world's {world}, got {members}")
    group = dist.group.WORLD if members == list(range(world)) else dist.new_group(members)
    ids = np.asarray(members).reshape(spec.shape)
    axis_groups: dict[str, Any] = {}
    for i, axis in enumerate(spec.axis_names):
        if len(spec.shape) == 1:
            axis_groups[axis] = group
            continue
        for row in np.moveaxis(ids, i, -1).reshape(-1, spec.shape[i]):
            # comm-lint: disable=host-transfer-in-loop  row is a numpy array on the host, not a tensor
            sub = dist.new_group(row.tolist())
            if rank in row:
                axis_groups[axis] = sub
    if rank not in members:
        return None
    return Mesh(spec, members.index(rank), group, axis_groups,
                None if ranks is None else tuple(members))


def build_parallelism_mesh(data_parallel: int = 1, sequence_parallel: int = 1,
                           pipeline_parallel: int = 1, tensor_parallel: int = 1,
                           expert_parallel: int = 1,
                           ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The model-parallelism mesh of the E2E harness, in the JAX package's
    axis order ``(dp[, sp][, pp][, ep], tp)``: dp always (outermost), sp, pp
    and ep only when above 1, tp always (innermost).  A rank's index in the
    mesh is its row-major index in that grid, and ``axis_groups["tp"]`` holds the
    ranks that differ from it only in their tp index (and so on for each
    axis).  ``ranks`` lays the grid over those global ranks instead of the
    first ones (a fleet replica's).  A collective call, as ``get_mesh``:
    every rank of the world builds every axis group, in the same order; the
    ranks outside the grid get None."""
    shape, names = [data_parallel], ["dp"]
    for size, name in ((sequence_parallel, "sp"), (pipeline_parallel, "pp"),
                       (expert_parallel, "ep")):
        if size > 1:
            shape.append(size)
            names.append(name)
    shape.append(tensor_parallel)
    names.append("tp")
    return get_mesh(MeshSpec.grid(shape, names), ranks=ranks)


def mesh_num_ranks(mesh: Mesh, axes: Optional[Sequence[str]] = None) -> int:
    """Total ranks along ``axes`` (all axes if None)."""
    names = tuple(axes) if axes is not None else mesh.axis_names
    return math.prod(mesh.shape[a] for a in names)


def flat_axes(mesh: Mesh) -> tuple[str, ...]:
    """All axis names of a mesh, for collectives that reduce over the whole
    mesh (the hierarchical allreduce reduces over them one at a time)."""
    return tuple(mesh.axis_names)
