"""Rank body of ``tests/test_torch_zero.py`` and ``tests/test_torch_checkpoint.py``:
the port's train step on a gloo group.  It imports torch and the port only,
since ``bench.launch`` imports it by name in every spawned rank."""

import numpy as np
import torch

from dlbb_tpu_torch.comm import build_parallelism_mesh
from dlbb_tpu_torch.models import ModelConfig, params_from_jax
from dlbb_tpu_torch.models.sharding import shard_params
from dlbb_tpu_torch.models.transformer import DTYPES
from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
from dlbb_tpu_torch.train.loop import make_train_step
from dlbb_tpu_torch.train.optim import build_optimizer, tree_map


def _numpy(tree):
    return tree_map(lambda t: t.detach().float().numpy().copy(), tree)


def _state_shapes(state):
    """The shapes of the optimizer state's tensors, by field (NamedTuple
    fields of dicts)."""
    return {name: tree_map(lambda t: tuple(t.shape), field)
            for name, field in state._asdict().items() if isinstance(field, dict)}


def _steps(step, state, x, t, n):
    losses = []
    for _ in range(n):
        state, loss = step(state, x, t)
        losses.append(float(loss))
    return state, losses


def run_train_cases(cases, weights, batches):
    """``cases``: ``(case id, spec)`` pairs, a spec holding ``mesh`` (dp,
    tp), ``fields`` (ModelConfig), ``weights`` and ``batch`` (keys of the
    next two arguments), ``train`` (the ``training:`` section), ``stage``,
    ``grad_accum``, ``steps`` and, for a checkpoint round trip,
    ``checkpoint`` (a directory: save after ``steps - 1`` steps, restore
    into a fresh state, take the last step there and uninterrupted).
    ``weights``: JAX parameter trees as float32 numpy; ``batches``: global
    ``(x, targets)`` float32 numpy pairs.  Every rank builds every mesh, in
    the order the cases first name them; the ranks of a mesh run its
    cases.  Returns, for this rank, ``{case id: result}``."""
    meshes = {}
    for _, spec in cases:
        if spec["mesh"] not in meshes:
            dp, tp = spec["mesh"]
            meshes[spec["mesh"]] = build_parallelism_mesh(dp, 1, 1, tp, 1)
    out = {}
    for case_id, spec in cases:
        mesh = meshes[spec["mesh"]]
        if mesh is None:
            continue
        dp, tp = spec["mesh"]
        c = mesh.coords
        cfg = ModelConfig(**spec["fields"])
        dtype = DTYPES[cfg.dtype]
        local = shard_params(params_from_jax(weights[spec["weights"]], cfg), cfg, c["tp"], tp)
        x, t = (torch.from_numpy(np.ascontiguousarray(np.split(a, dp)[c["dp"]])).to(dtype)
                for a in batches[spec["batch"]])

        def build():
            return make_train_step(cfg, build_optimizer(spec["train"]), local, mesh=mesh,
                                   zero_stage=spec["stage"], grad_accum=spec["grad_accum"])

        step, state = build()
        res = {"coords": c, "opt_shapes": _state_shapes(state.opt_state)}
        if "checkpoint" in spec:
            state, losses = _steps(step, state, x, t, spec["steps"] - 1)
            layout = {"mesh": {"dp": dp, "tp": tp}, "zero_stage": spec["stage"]}
            with Checkpointer(CheckpointConfig(spec["checkpoint"]), layout=layout,
                              group=mesh.group) as ckpt:
                ckpt.maybe_save(state, force=True)
            step2, fresh = build()
            with Checkpointer(CheckpointConfig(spec["checkpoint"]), layout=layout,
                              group=mesh.group) as ckpt:
                restored = ckpt.restore(fresh)
            resumed, resumed_loss = _steps(step2, restored, x, t, 1)
            res.update(resumed_step=restored.step, resumed_loss=resumed_loss[0],
                       resumed_params=_numpy(resumed.params))
            state, last = _steps(step, state, x, t, 1)
            losses += last
        else:
            state, losses = _steps(step, state, x, t, spec["steps"])
        res.update(losses=losses, step=state.step, params=_numpy(state.params))
        out[case_id] = res
    return out


def run_train_resume(config, resume_dir, straight_dir, iters):
    """``run_train`` with a checkpoint in ``resume_dir``, once for
    ``iters[0]`` timed steps and once more, resumed, for ``iters[1]``; and
    uninterrupted in ``straight_dir`` for as many steps in all.  Returns
    this rank's three results and its checkpoint files' tensors at the last
    step of each directory."""
    import copy

    from dlbb_tpu_torch.train.loop import run_train

    def run(directory, n):
        cfg = copy.deepcopy(config)
        cfg["execution"]["benchmark_iterations"] = n
        cfg["training"]["checkpoint"] = {"directory": directory, "max_to_keep": 2}
        return run_train(cfg, device="cpu", verbose=False)

    first = run(resume_dir, iters[0])
    second = run(resume_dir, iters[1])
    warmup = config["execution"]["warmup_iterations"]
    straight = run(straight_dir, iters[0] + iters[1] + warmup)
    rank = torch.distributed.get_rank()
    files = {d: torch.load(f"{d}/{second['final_step']}/rank_{rank:05d}.pt",
                           weights_only=True)["leaves"]
             for d in (resume_dir, straight_dir)}
    return first, second, straight, files


def run_corrupt_restore(fields, weights, directory):
    """Saves of steps 1-3 of a dp=2 x tp=2 ZeRO-1 state with the
    ``ckpt-corrupt:@3`` plan active on rank 0 only; then ``restore`` of
    step 3 and ``restore_or`` on every rank.  Returns this rank's
    (exception name from ``restore`` or None, step ``restore_or`` chose,
    ``latest_intact_step``, ``verify_step(3)``)."""
    from dlbb_tpu_torch.resilience import inject

    mesh = build_parallelism_mesh(2, 1, 1, 2, 1)
    cfg = ModelConfig(**fields)
    local = shard_params(params_from_jax(weights, cfg), cfg, mesh.coords["tp"], 2)
    _, state = make_train_step(cfg, build_optimizer({}), local, mesh=mesh, zero_stage=1)
    plan = "ckpt-corrupt:@3" if torch.distributed.get_rank() == 0 else None
    layout = {"mesh": {"dp": 2, "tp": 2}, "zero_stage": 1}
    with inject.plan_scope(plan), Checkpointer(
            CheckpointConfig(directory, max_to_keep=5), layout=layout,
            group=mesh.group) as ckpt:
        for step in (1, 2, 3):
            assert ckpt.maybe_save(state._replace(step=step), force=True)
        try:
            ckpt.restore(state, step=3)
            error = None
        except Exception as e:  # noqa: BLE001 - the test reads the type
            error = type(e).__name__
        restored = ckpt.restore_or(state._replace(step=0))
        return error, restored.step, ckpt.latest_intact_step(), ckpt.verify_step(3)


def run_preempted(config, directory, plan_rank):
    """``run_train`` with a checkpoint in ``directory`` and the
    ``preempt:@3`` plan active on rank ``plan_rank`` only: a SIGTERM to one
    process.  Returns this rank's result."""
    import copy

    from dlbb_tpu_torch.resilience import inject
    from dlbb_tpu_torch.train.loop import run_train

    cfg = copy.deepcopy(config)
    cfg["training"]["checkpoint"] = {"directory": directory}
    plan = "preempt:@3" if torch.distributed.get_rank() == plan_rank else None
    with inject.plan_scope(plan):
        return run_train(cfg, device="cpu", verbose=False)
