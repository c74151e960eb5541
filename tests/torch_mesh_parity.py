"""Shared pieces of the port's parity tests on (dp, sp, pp, ep, tp) meshes
(``tests/test_torch_moe.py``, ``tests/test_torch_pipeline.py``): the JAX
side (``make_train_step`` on the same mesh of the CPU-simulated devices of
``conftest.py``) and the reassembly of the port's per-rank parts into full
leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding

from dlbb_tpu.comm.mesh import build_parallelism_mesh as jax_parallelism_mesh
from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models.sharding import batch_spec
from dlbb_tpu.train import loop as jax_loop
from dlbb_tpu.train import optim as jax_optim
from dlbb_tpu_torch.models import ModelConfig, params_from_jax
from dlbb_tpu_torch.models.sharding import shard_params, unshard_params
from dlbb_tpu_torch.train import optim as pt_optim
from dlbb_tpu_torch.train import zero as pt_zero

LR, SGD_LR = 1e-3, 1024.0
# the bounds of tests/test_torch_zero.py, argued there
LOSS_RTOL, ADAM_ATOL, GRAD_RTOL = 1e-5, 0.1 * LR, 1e-5
ADAM = {"learning_rate": LR}
SGD = {"optimizer": "sgd", "momentum": None, "learning_rate": SGD_LR}


def dims(mesh):
    """``(dp, sp, pp, ep, tp)`` of a case's mesh tuple (``(dp, tp)`` or the
    five)."""
    return mesh if len(mesh) == 5 else (mesh[0], 1, 1, 1, mesh[1])


def jax_mesh(mesh):
    dp, sp, pp, ep, tp = dims(mesh)
    return jax_parallelism_mesh(dp, sp, pp, tp, ep, devices=jax.devices()[:dp * sp * pp * ep * tp])


def jax_train(spec, weights, batches, trajectory=None):
    """(losses, full params as numpy) of JAX's ``make_train_step`` on the
    case's mesh; ``trajectory`` (a list) receives the params before each
    step."""
    cfg = jax_configs.ModelConfig(**spec["fields"])
    mesh = jax_mesh(spec["mesh"])
    params = jax.tree.map(jnp.asarray, weights[spec["weights"]])
    step, state = jax_loop.make_train_step(
        cfg, mesh, jax_optim.build_optimizer(spec["train"]), params,
        zero_stage=spec["stage"], grad_accum=spec["grad_accum"],
        num_microbatches=spec.get("microbatches"),
        moe_aux_weight=spec.get("aux", 0.0),
        pipeline_schedule=spec.get("schedule", "gpipe"))
    del params  # the state holds its own sharded copies
    sharding = NamedSharding(mesh, batch_spec(mesh))
    x, t = (jax.device_put(jnp.asarray(a), sharding) for a in batches[spec["batch"]])
    losses = []
    for i in range(spec["steps"]):
        if trajectory is not None:
            trajectory.append(weights[spec["weights"]] if i == 0
                              else jax.tree.map(np.asarray, state.params))
        state, loss = step(state, x, t)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def _torch(tree):
    return pt_optim.tree_map(torch.from_numpy, tree)


def full_params(ranks, case_id, spec, weights, key="params"):
    """The full leaves (numpy) from every rank's parts after a train case:
    dp shards joined along their axis at stage 3 and checked equal, bit for
    bit, across dp below it; then the (pp, ep, tp) parts joined by
    ``unshard_params``."""
    dp, _, pp, ep, tp = dims(spec["mesh"])
    cfg = ModelConfig(**spec["fields"])
    by = {}
    for r in ranks:
        if case_id in r:
            c = r[case_id]["coords"]
            by[(c["dp"], c.get("pp", 0), c.get("ep", 0), c["tp"])] = _torch(r[case_id][key])
    assert len(by) == dp * pp * ep * tp
    full = params_from_jax(weights[spec["weights"]], cfg)
    parts = []
    for s in range(pp):
        for e in range(ep):
            for j in range(tp):
                shards = [by[(i, s, e, j)] for i in range(dp)]
                if spec["stage"] == 3:
                    local = shard_params(full, cfg, j, tp, s, pp, e, ep)
                    axes = pt_zero.dp_sharded_param_specs(local, dp, pp, ep)
                    parts.append(pt_zero.unshard_tree(shards, axes))
                else:
                    for other in shards[1:]:
                        for a, b in zip(pt_optim.tree_leaves(shards[0]),
                                        pt_optim.tree_leaves(other)):
                            assert torch.equal(a, b), f"{case_id}: dp ranks disagree"
                    parts.append(shards[0])
    return pt_optim.tree_map(lambda t: t.numpy(), unshard_params(parts, cfg, pp, ep))


def losses(ranks, case_id):
    out = [r[case_id]["losses"] for r in ranks if case_id in r]
    assert all(x == out[0] for x in out[1:]), f"{case_id}: ranks report other losses"
    return out[0]


def by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in by_path(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def _noise_elements(spec, trajectory, batches):
    """Per leaf, the elements whose gradient at some step of JAX's
    trajectory is within ``GRAD_RTOL`` of the leaf's largest of zero: the
    gradient bound the ports are held to cannot fix the sign of their Adam
    step (the K columns of the qkv bias, whose gradient is 0 in exact
    arithmetic, since a row's softmax ignores a shift of all its scores,
    are such).  The gradient is the unpipelined one on one device."""
    cfg = jax_configs.ModelConfig(**spec["fields"])
    x, t = (jnp.asarray(a) for a in batches[spec["batch"]])
    noise = None
    for params in trajectory:
        g = jax.grad(jax_loop.mse_loss)(jax.tree.map(jnp.asarray, params), x, t, cfg,
                                        None, None, spec.get("aux", 0.0))
        g = by_path(jax.tree.map(np.asarray, g))
        step = {k: np.abs(v) <= GRAD_RTOL * np.abs(v).max() for k, v in g.items()}
        noise = step if noise is None else {k: noise[k] | step[k] for k in step}
    return noise


def jax_adam_reference(spec, weights, batches):
    """JAX's side of ``check_adam_case``: ``(losses, full params by path,
    noise elements by path)``."""
    trajectory = []
    ref_losses, ref = jax_train(spec, weights, batches, trajectory)
    return ref_losses, by_path(ref), _noise_elements(spec, trajectory, batches)


def hold_adam(got_losses, got, reference, spec):
    """The port's losses and full leaves by path (``got``) against
    ``jax_adam_reference``'s: losses to ``LOSS_RTOL``, leaves to
    ``ADAM_ATOL``.  An element whose step is the sign of a rounding error
    (``_noise_elements``) is held to Adam's own bound instead: it moves at
    most lr per step on either side."""
    ref_losses, ref, noise = reference
    np.testing.assert_allclose(got_losses, ref_losses, rtol=LOSS_RTOL)
    assert set(got) == set(ref)
    for name, p in got.items():
        sure = ~noise[name]
        np.testing.assert_allclose(p[sure], ref[name][sure], atol=ADAM_ATOL, rtol=0,
                                   err_msg=name)
        assert np.all(np.abs(p - ref[name])[~sure] <= 2 * LR * spec["steps"] * (1 + 1e-3)), name


def check_adam_case(ranks, weights, batches, case_id, spec):
    """``hold_adam`` on a train case's ranks against JAX's steps."""
    hold_adam(losses(ranks, case_id), by_path(full_params(ranks, case_id, spec, weights)),
              jax_adam_reference(spec, weights, batches), spec)


def check_sgd_case(ranks, weights, batches, case_id, spec):
    """One SGD step at ``SGD_LR``: ``(p0 - p1) / lr`` is the reduced
    gradient on both sides, held to ``GRAD_RTOL`` of each leaf's largest."""
    ref_losses, ref = jax_train(spec, weights, batches)
    np.testing.assert_allclose(losses(ranks, case_id), ref_losses, rtol=LOSS_RTOL)
    p0 = by_path(weights[spec["weights"]])
    got, ref = by_path(full_params(ranks, case_id, spec, weights)), by_path(ref)
    assert set(got) == set(ref) == set(p0)
    for name in p0:
        g_ref = (p0[name] - ref[name]) / SGD_LR
        g_got = (p0[name] - got[name]) / SGD_LR
        scale = np.abs(g_ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(g_got, g_ref, atol=GRAD_RTOL * scale, rtol=0, err_msg=name)
