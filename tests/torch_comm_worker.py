"""Rank body of ``tests/test_torch_comm.py``: runs collectives of the PyTorch
port on a gloo group and returns each case's input and output slab.  It
imports torch and the port only, since ``bench.launch`` imports it by name
in every spawned rank."""

import torch.distributed as dist

from dlbb_tpu_torch.comm import MeshSpec, get_mesh, get_op, make_payload
from dlbb_tpu_torch.comm.ops import (
    build_allreduce,
    build_allreduce_hierarchical,
    build_barrier,
    build_reduce,
)


def run_cases(cases, num_elements):
    """``cases``: ``(name, dtype, root, reduce_op, shape, mesh_shape,
    axis_names)`` tuples, the same list on every rank.  Returns
    ``{case: (input slab, output slab)}`` for this rank."""
    rank = dist.get_rank()
    meshes, out = {}, {}
    for case in cases:
        name, dtype, root, reduce_op, shape, mesh_shape, axis_names = case
        key = (mesh_shape, axis_names)
        if key not in meshes:
            meshes[key] = get_mesh(MeshSpec(mesh_shape, axis_names))
        mesh = meshes[key]
        kind = "allreduce" if name == "barrier" else name
        x = make_payload(get_op(kind), rank, mesh.spec.num_ranks, num_elements,
                         dtype=dtype, shape=shape)
        if name == "allreduce":
            fn = build_allreduce(mesh, root, reduce_op)
        elif name == "reduce":
            fn = build_reduce(mesh, root, reduce_op)
        elif name == "allreduce_hierarchical":
            fn = build_allreduce_hierarchical(mesh, root)
        elif name == "barrier":
            fn = build_barrier(mesh, root)
        else:
            fn = get_op(name).build(mesh, root)
        x_before = x.clone()
        y = fn(x)
        if not x.equal(x_before):
            raise AssertionError(f"{case}: the op wrote to its input")
        out[case] = (x, y)
    return out
