"""Process groups and collectives (counterpart of ``dlbb_tpu/comm``):
``torch.distributed`` over NCCL on the GPUs, over gloo on the CPU."""

from dlbb_tpu_torch.comm.mesh import (
    DEFAULT_AXIS,
    Mesh,
    MeshSpec,
    build_parallelism_mesh,
    destroy_distributed,
    flat_axes,
    get_mesh,
    initialize_distributed,
    mesh_num_ranks,
)
from dlbb_tpu_torch.comm.ops import (
    OPERATIONS,
    Collective,
    CollectiveOp,
    get_op,
    make_payload,
    plain_collective,
)
from dlbb_tpu_torch.comm.variants import VARIANTS, Variant, get_variant

__all__ = [
    "DEFAULT_AXIS",
    "Mesh",
    "MeshSpec",
    "build_parallelism_mesh",
    "destroy_distributed",
    "flat_axes",
    "get_mesh",
    "initialize_distributed",
    "mesh_num_ranks",
    "OPERATIONS",
    "Collective",
    "CollectiveOp",
    "get_op",
    "make_payload",
    "plain_collective",
    "VARIANTS",
    "Variant",
    "get_variant",
]
