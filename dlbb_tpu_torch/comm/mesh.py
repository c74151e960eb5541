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

Ranks are global ranks throughout: every mesh starts at rank 0, so a rank's
index in its mesh is its global rank.
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


def get_mesh(spec: MeshSpec) -> Optional[Mesh]:
    """The mesh of the first ``spec.num_ranks`` ranks of the world.

    A collective call: every rank of the world calls it, in the same order
    (``torch.distributed.new_group`` is), and the ranks past the mesh get
    None.  Raises when the world is smaller than the spec, as JAX's
    ``build_mesh`` does with too few devices."""
    world, rank = dist.get_world_size(), dist.get_rank()
    n = spec.num_ranks
    if n > world:
        raise ValueError(f"mesh spec {spec.shape} needs {n} ranks, only "
                         f"{world} in the process group")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    ids = np.arange(n).reshape(spec.shape)
    axis_groups: dict[str, Any] = {}
    for i, axis in enumerate(spec.axis_names):
        if len(spec.shape) == 1:
            axis_groups[axis] = group
            continue
        for members in np.moveaxis(ids, i, -1).reshape(-1, spec.shape[i]):
            sub = dist.new_group(members.tolist())
            if rank in members:
                axis_groups[axis] = sub
    if rank >= n:
        return None
    return Mesh(spec, rank, group, axis_groups)


def build_parallelism_mesh(data_parallel: int = 1, sequence_parallel: int = 1,
                           pipeline_parallel: int = 1, tensor_parallel: int = 1,
                           expert_parallel: int = 1) -> Optional[Mesh]:
    """The model-parallelism mesh of the E2E harness, in the JAX package's
    axis order ``(dp[, sp][, pp][, ep], tp)``: dp always (outermost), sp, pp
    and ep only when above 1, tp always (innermost).  A rank's global rank
    is its row-major index in that grid, and ``axis_groups["tp"]`` holds the
    ranks that differ from it only in their tp index (and so on for each
    axis).  A collective call, as ``get_mesh``: every rank of the world
    builds every axis group, in the same order; the ranks past the grid get
    None."""
    shape, names = [data_parallel], ["dp"]
    for size, name in ((sequence_parallel, "sp"), (pipeline_parallel, "pp"),
                       (expert_parallel, "ep")):
        if size > 1:
            shape.append(size)
            names.append(name)
    shape.append(tensor_parallel)
    names.append("tp")
    return get_mesh(MeshSpec.grid(shape, names))


def mesh_num_ranks(mesh: Mesh, axes: Optional[Sequence[str]] = None) -> int:
    """Total ranks along ``axes`` (all axes if None)."""
    names = tuple(axes) if axes is not None else mesh.axis_names
    return math.prod(mesh.shape[a] for a in names)


def flat_axes(mesh: Mesh) -> tuple[str, ...]:
    """All axis names of a mesh, for collectives that reduce over the whole
    mesh (the hierarchical allreduce reduces over them one at a time)."""
    return tuple(mesh.axis_names)
