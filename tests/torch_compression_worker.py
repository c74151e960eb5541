"""Rank body of ``tests/test_torch_compression.py``: the port's compressed
collectives and compressed train step on a gloo group.  It imports torch
and the port only, since ``bench.launch`` imports it by name in every
spawned rank."""

import numpy as np
import torch
import torch.distributed as dist

from dlbb_tpu_torch.comm import build_parallelism_mesh, get_mesh, get_op, make_payload
from dlbb_tpu_torch.comm.compression import (
    count_wire_bytes,
    psum_compressed,
    reduce_scatter_compressed,
)
from dlbb_tpu_torch.comm.mesh import MeshSpec
from dlbb_tpu_torch.data import batch_slice
from dlbb_tpu_torch.models import ModelConfig, params_from_jax
from dlbb_tpu_torch.models.sharding import batch_spec
from dlbb_tpu_torch.models.transformer import DTYPES
from dlbb_tpu_torch.bench.runner import Sweep1D, run_sweep
from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
from dlbb_tpu_torch.train.loop import make_train_step, mse_loss
from dlbb_tpu_torch.train.optim import build_optimizer, tree_leaves, tree_map


def _numpy(tree):
    return tree_map(lambda t: t.detach().float().numpy().copy(), tree)


def _ring_case(spec, mesh):
    """One ring case: ``(output slab as float32 numpy, bytes counted)``."""
    rank, p = mesh.rank, mesh.spec.num_ranks
    kind = "allreduce" if spec["fn"] in ("psum", "allreduce_q") else "reducescatter"
    x = make_payload(get_op(kind), rank, p, spec["n"], dtype=spec["dtype"])
    kwargs = {"compression": spec["comp"], "accum_dtype": spec["accum"]}
    with count_wire_bytes() as counted:
        if spec["fn"] == "psum":
            y = psum_compressed(x, mesh.group, **kwargs)
        elif spec["fn"] == "reduce_scatter":
            y = reduce_scatter_compressed(x, mesh.group, **kwargs)
        else:
            y = get_op(spec["fn"]).build(mesh, **kwargs)(x)
    return y.float().numpy().copy(), counted["bytes"]


def _c_max(state, cfg, x, t, group):
    """A bound on max |c| over the dp ranks before a compressed step: the
    largest local gradient element plus the largest residual element."""
    loss = mse_loss(state.params, x, t, cfg)
    g = torch.autograd.grad(loss, tree_leaves(state.params))
    bound = max(a.abs().max() for a in g) + state.opt_state[1].residual.float().abs().max()
    bound = bound.reshape(1).float()
    dist.all_reduce(bound, op=dist.ReduceOp.MAX, group=group)
    return float(bound)


def _steps(step, state, x, t, n, before=None):
    """``n`` steps; ``before(state)``, where given, is called before each
    and its values returned beside the losses."""
    losses, seen = [], []
    for _ in range(n):
        if before is not None:
            seen.append(before(state))
        state, loss = step(state, x, t)
        losses.append(float(loss))
    return state, losses, seen


def _train_case(spec, mesh, weights, batches):
    cfg = ModelConfig(**spec["fields"])
    dtype = DTYPES[cfg.dtype]
    params = params_from_jax(weights, cfg)
    x, t = (torch.from_numpy(np.ascontiguousarray(batch_slice(a, **batch_spec(mesh))))
            .to(dtype) for a in batches)

    def build():
        return make_train_step(cfg, build_optimizer(spec["train"]), params, mesh=mesh,
                               zero_stage=spec["stage"], grad_compression=spec["comp"],
                               compression_accum=spec.get("accum", "float32"),
                               residual_dtype=spec.get("residual_dtype"),
                               batch_size=batches[0].shape[0])

    step, state = build()
    res = {"residual_dtype": None, "coords": mesh.coords}
    if spec["comp"] != "none":
        res["residual_dtype"] = str(state.opt_state[1].residual.dtype)
    before = (None if spec["comp"] == "none"
              else lambda state: _c_max(state, cfg, x, t, mesh.group))
    state, losses, c_max = _steps(step, state, x, t, spec["steps"], before)
    res.update(losses=losses, step=state.step, params=_numpy(state.params))
    if spec["comp"] != "none":
        res["residual"] = state.opt_state[1].residual.float().numpy().copy()
        res["c_max"] = c_max
    if "checkpoint" in spec:
        layout = {"mesh": {"dp": mesh.shape["dp"], "tp": 1}, "zero_stage": spec["stage"]}
        with Checkpointer(CheckpointConfig(spec["checkpoint"]), layout=layout,
                          group=mesh.group) as ckpt:
            ckpt.maybe_save(state, force=True)
            _, fresh = build()
            restored = ckpt.restore(fresh)
        res["restored_step"] = restored.step
        res["restored_residual"] = restored.opt_state[1].residual.float().numpy().copy()
        resumed, resumed_loss, _ = _steps(step, restored, x, t, 1)
        straight, straight_loss, _ = _steps(step, state, x, t, 1)
        res["resumed_equal"] = resumed_loss == straight_loss and all(
            torch.equal(a, b) for a, b in zip(
                [resumed.opt_state[1].residual] + list(_flat(resumed.params)),
                [straight.opt_state[1].residual] + list(_flat(straight.params))))
    return res


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    else:
        yield tree


def run_compression_cases(ring_cases, train_cases, weights, batches, sweep_dir,
                          variants):
    """``ring_cases``: ``(case id, spec)`` pairs, a spec holding ``fn``
    ("psum", "reduce_scatter", "allreduce_q" or "reducescatter_q"), ``n``,
    ``dtype``, ``comp``, ``accum`` and ``world`` (the ring's ranks, the
    first of the world).  ``train_cases``: ``(case id, spec)`` pairs on a
    pure dp mesh of the whole world, a spec holding ``fields``
    (ModelConfig), ``train``, ``stage``, ``comp``, ``steps`` and optionally
    ``accum``, ``residual_dtype`` and ``checkpoint`` (a directory: save after
    the steps, restore into a fresh state and step once, against one more
    uninterrupted step).  ``weights`` and ``batches``: the JAX parameters
    and the global ``(x, targets)`` as float32 numpy.  Returns this rank's
    ``{"ring": {id: (output, bytes)}, "train": {id: result}}``.  Then
    ``allreduce_q`` and ``reducescatter_q`` at 1KB on the whole world under
    each of ``variants``, into ``sweep_dir/<variant>``."""
    out = {"ring": {}, "train": {}}
    rings = {}
    for case_id, spec in ring_cases:
        world = spec["world"]
        if world not in rings:
            rings[world] = get_mesh(MeshSpec.ring(world))
        if rings[world] is not None:
            out["ring"][case_id] = _ring_case(spec, rings[world])
    mesh = build_parallelism_mesh(dist.get_world_size())
    for case_id, spec in train_cases:
        out["train"][case_id] = _train_case(spec, mesh, weights, batches)
    world = dist.get_world_size()
    for variant in variants:
        result = run_sweep(Sweep1D(
            variant=variant, operations=("allreduce_q", "reducescatter_q"),
            data_sizes=(("1KB", 256),), rank_counts=(world,), warmup_iterations=1,
            measurement_iterations=2, output_dir=f"{sweep_dir}/{variant}"),
            device="cpu", verbose=False)
        if result.failed:
            raise AssertionError(f"{variant}: {result.failed}")
    return out
