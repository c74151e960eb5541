"""Rank body of ``tests/test_torch_collective_matmul.py`` and
``tests/test_torch_context_parallel.py``: the port's sequence-sharded
layouts on a gloo group (the collective-matmul primitives, ring and Ulysses
attention, the model forward with ``tp_overlap`` and sp, the sweep's
matmul ops, and through ``torch_train_worker`` the train step).  It imports
torch and the port only, since ``bench.launch`` imports it by name in every
spawned rank."""

import numpy as np
import torch
import torch_train_worker

from dlbb_tpu_torch.comm import MeshSpec, build_parallelism_mesh, get_mesh, get_op, make_payload
from dlbb_tpu_torch.data import batch_slice
from dlbb_tpu_torch.models import ModelConfig, forward, params_from_jax
from dlbb_tpu_torch.models.sharding import batch_spec, shard_params
from dlbb_tpu_torch.models.transformer import DTYPES, use_tp_overlap
from dlbb_tpu_torch.parallel import (
    allgather_matmul,
    matmul_reducescatter,
    ring_attention,
    ulysses_attention,
)
from dlbb_tpu_torch.parallel.collective_matmul import activation_spec, weight_shard


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy().copy()


def _mesh(key):
    """``("grid", shape, names)``: ``get_mesh``; else ``(dp, sp, tp)``:
    ``build_parallelism_mesh``."""
    if key[0] == "grid":
        return get_mesh(MeshSpec(key[1], key[2]))
    dp, sp, tp = key
    return build_parallelism_mesh(dp, sp, 1, tp, 1)


def _collective_matmul(mesh, spec, arrays):
    """allgather_matmul then matmul_reducescatter of the global x, w1, w2 on
    this rank's parts; the backward of sum(z**2)."""
    c = mesh.coords
    idx, count = activation_spec(mesh)
    x = batch_slice(arrays["x"], c["dp"], mesh.shape["dp"], idx, count)
    x = _t(x).requires_grad_(True)
    w1 = weight_shard(_t(arrays["w1"]), mesh, True).clone().requires_grad_(True)
    w2 = weight_shard(_t(arrays["w2"]), mesh, False).clone().requires_grad_(True)
    y = allgather_matmul(x, w1, mesh, schedule=spec["schedule"])
    z = matmul_reducescatter(y, w2, mesh, schedule=spec["schedule"])
    (z ** 2).sum().backward()
    return {"coords": c, "index": (idx, count), "y": _np(y), "z": _np(z),
            "dx": _np(x.grad), "dw1": _np(w1.grad), "dw2": _np(w2.grad)}


def _forward(mesh, spec, arrays):
    """The model forward on this rank's shards and slice of the batch:
    its output, and where it lies in the global ``[B, S, H]``."""
    cfg = ModelConfig(**spec["fields"])
    dtype = DTYPES[cfg.dtype]
    c = mesh.coords
    local = shard_params(params_from_jax(arrays["weights"][spec["weights"]], cfg), cfg,
                         c["tp"], mesh.shape["tp"])
    b = batch_spec(mesh)
    x = _t(batch_slice(arrays["batches"][spec["batch"]][0], **b), dtype)
    with torch.inference_mode():
        y = forward(local, x, cfg, mesh=mesh)
    seq = activation_spec(mesh) if use_tp_overlap(cfg, mesh) else (b["sp_rank"], b["sp"])
    return {"coords": c, "rows": (b["dp_rank"], b["dp"]), "seq": seq, "y": _np(y)}


def _attention(mesh, spec, arrays):
    """Ring or Ulysses attention of the spec's global q, k, v (``[B, N, S,
    D]``) on this rank's rows and sequence block, and the gradients of
    ``sum(out * cot)``."""
    b = batch_spec(mesh)

    def part(key):
        a = np.moveaxis(spec[key], 2, 1)  # slice [B, S, ...] then back
        return np.moveaxis(batch_slice(a, **b), 1, 2)

    q, k, v = (_t(part(key)).requires_grad_(True) for key in ("q", "k", "v"))
    fn = ring_attention if spec["fn"] == "ring" else ulysses_attention
    out = fn(q, k, v, mesh, causal=spec["causal"])
    (out * _t(part("cot"))).sum().backward()
    return {"batch": b, "out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad)}


def _sweep_op(mesh, spec, arrays):
    """A collective-matmul micro-op on this rank's payload slab."""
    op = get_op(spec["name"])
    b, s, h = spec["shape"]
    x = make_payload(op, mesh.rank, mesh.spec.num_ranks, b * s * h, dtype=spec["dtype"],
                     shape=spec["shape"])
    before = x.clone()
    y = op.build(mesh, 0, schedule=spec["schedule"])(x)
    if not torch.equal(x, before):
        raise AssertionError(f"{spec}: the op wrote to its input")
    return {"x": _np(x), "y": _np(y)}


RUNNERS = {"matmul": _collective_matmul, "forward": _forward, "attention": _attention,
           "sweep_op": _sweep_op}


def run_jobs(jobs, arrays):
    """``jobs``: ``(kind, case id, spec)``, the same list on every rank;
    ``kind`` is a key of ``RUNNERS`` (``spec["mesh"]`` names the mesh, as
    ``_mesh`` reads it), ``"train"`` (``torch_train_worker.
    run_train_cases``'s spec, on ``arrays["weights"]`` and
    ``arrays["batches"]``) or ``"reshard"`` (``torch_train_worker.
    run_reshard``'s, after the train jobs).  Every rank builds every mesh, in the order the
    jobs first name them; the ranks of a mesh run its jobs.  Returns, for
    this rank, ``{case id: result}``."""
    meshes = {}
    for kind, _, spec in jobs:
        if kind not in ("train", "reshard") and spec["mesh"] not in meshes:
            meshes[spec["mesh"]] = _mesh(spec["mesh"])
    out = {}
    for kind, case_id, spec in jobs:
        if kind in ("train", "reshard"):
            continue
        mesh = meshes[spec["mesh"]]
        if mesh is not None:
            out[case_id] = RUNNERS[kind](mesh, spec, arrays)
    train = [(case_id, spec) for kind, case_id, spec in jobs if kind == "train"]
    if train:
        out.update(torch_train_worker.run_train_cases(train, arrays["weights"],
                                                      arrays["batches"]))
    for kind, case_id, spec in jobs:
        if kind == "reshard":
            out[case_id] = torch_train_worker.run_reshard(spec, arrays["weights"],
                                                          arrays["batches"])
    return out
