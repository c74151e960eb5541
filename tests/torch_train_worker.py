"""Rank body of ``tests/test_torch_zero.py``, ``tests/test_torch_checkpoint.py``
and (through ``torch_seq_worker``) the sequence-sharded train cases:
the port's train step on a gloo group.  It imports torch and the port only,
since ``bench.launch`` imports it by name in every spawned rank."""

import numpy as np
import torch

from dlbb_tpu_torch.comm import build_parallelism_mesh
from dlbb_tpu_torch.data import batch_slice
from dlbb_tpu_torch.models import ModelConfig, params_from_jax
from dlbb_tpu_torch.models.sharding import batch_spec, shard_params
from dlbb_tpu_torch.models.transformer import DTYPES
from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer, train_layout
from dlbb_tpu_torch.train.loop import make_train_step, step_chunks
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


def _mesh_dims(mesh):
    """``(dp, sp, pp, ep, tp)`` from a case's ``(dp, tp)``, ``(dp, sp, tp)``
    or ``(dp, sp, pp, ep, tp)``."""
    if len(mesh) == 5:
        return mesh
    return (mesh[0], mesh[1], 1, 1, mesh[2]) if len(mesh) == 3 else (mesh[0], 1, 1, 1, mesh[1])


def run_train_cases(cases, weights, batches):
    """``cases``: ``(case id, spec)`` pairs, a spec holding ``mesh`` ((dp,
    tp), (dp, sp, tp) or (dp, sp, pp, ep, tp)), ``fields`` (ModelConfig),
    ``weights`` and ``batch`` (keys of the
    next two arguments), ``train`` (the ``training:`` section), ``stage``,
    ``grad_accum``, ``steps``, optionally ``microbatches``, ``schedule``
    and ``aux`` (``make_train_step``'s ``num_microbatches``,
    ``pipeline_schedule`` and ``moe_aux_weight``) and, for a checkpoint round trip,
    ``checkpoint`` (a directory: save after ``steps - 1`` steps, restore
    into a fresh state, take the last step there and uninterrupted).
    ``weights``: JAX parameter trees as float32 numpy; ``batches``: global
    ``(x, targets)`` float32 numpy pairs, each rank taking its rows of
    each of the step's global micro-batches (``step_chunks``), as
    ``run_train`` lays them.  Every rank builds every mesh, in
    the order the cases first name them; the ranks of a mesh run its
    cases.  Returns, for this rank, ``{case id: result}``."""
    meshes = {}
    for _, spec in cases:
        if spec["mesh"] not in meshes:
            dp, sp, pp, ep, tp = _mesh_dims(spec["mesh"])
            meshes[spec["mesh"]] = build_parallelism_mesh(dp, sp, pp, tp, ep)
    out = {}
    for case_id, spec in cases:
        mesh = meshes[spec["mesh"]]
        if mesh is None:
            continue
        dp, _, pp, ep, tp = _mesh_dims(spec["mesh"])
        c = mesh.coords
        cfg = ModelConfig(**spec["fields"])
        dtype = DTYPES[cfg.dtype]
        local = shard_params(params_from_jax(weights[spec["weights"]], cfg), cfg, c["tp"], tp,
                             c.get("pp", 0), pp, c.get("ep", 0), ep)
        rows = batches[spec["batch"]][0].shape[0]
        chunks = step_chunks(spec["grad_accum"],
                             spec.get("microbatches") or (pp if pp > 1 else None))
        x, t = (torch.from_numpy(np.ascontiguousarray(batch_slice(a, **batch_spec(mesh, chunks))))
                .to(dtype) for a in batches[spec["batch"]])

        def build():
            return make_train_step(cfg, build_optimizer(spec["train"]), local, mesh=mesh,
                                   zero_stage=spec["stage"], grad_accum=spec["grad_accum"],
                                   num_microbatches=spec.get("microbatches"),
                                   pipeline_schedule=spec.get("schedule", "gpipe"),
                                   moe_aux_weight=spec.get("aux", 0.0), batch_size=rows)

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
    _, state = make_train_step(cfg, build_optimizer({}), local, mesh=mesh, zero_stage=1,
                               batch_size=2)
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


def _state_numpy(state):
    """The parameters and the optimizer state's tensors as numpy, by path
    (``params/...`` and ``opt/<field or index>/...``)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, tuple):
            names = getattr(node, "_fields", range(len(node)))
            for k, v in zip(names, node):
                walk(v, f"{path}/{k}")
        elif isinstance(node, torch.Tensor):
            out[path] = node.detach().float().numpy().copy()

    walk(state.params, "params")
    walk(state.opt_state, "opt")
    return out


def run_reshard(spec, weights, batches):
    """A checkpoint saved on one layout and restored onto others:
    ``spec["save"]`` ``(dp, tp, stage)`` takes ``spec["steps"]`` steps and
    saves to ``spec["directory"]``, then one more step (the uninterrupted
    one); each of ``spec["restore"]`` ``(dp, tp, stage)`` (``(1, 1, s)``:
    world 1, rank 0 alone, no process group) builds a fresh state, restores
    the step into it and takes one step.  Returns, for this rank, ``{"save"
    | "restore/<dp>x<tp>/zero<s>": {"coords", "state" (after the save or
    the restore, numpy leaves), "loss" (the step after it)}}``."""
    cfg = ModelConfig(**spec["fields"])
    x_all, t_all = batches[spec["batch"]]
    rows = x_all.shape[0]

    def run(dp, tp, stage, restore):
        mesh = None if dp * tp == 1 else build_parallelism_mesh(dp, 1, 1, tp, 1)
        if mesh is None and (dp * tp > 1 or torch.distributed.get_rank() != 0):
            return None
        c = {"dp": 0, "tp": 0} if mesh is None else mesh.coords
        local = shard_params(params_from_jax(weights[spec["weights"]], cfg), cfg, c["tp"], tp)
        x, t = (torch.from_numpy(np.ascontiguousarray(batch_slice(a, **batch_spec(mesh))))
                for a in (x_all, t_all))
        step, state = make_train_step(cfg, build_optimizer(spec["train"]), local, mesh=mesh,
                                      zero_stage=stage, batch_size=rows)
        layout = train_layout(cfg, {"dp": dp, "tp": tp}, stage, dp * tp)
        with Checkpointer(CheckpointConfig(spec["directory"]), layout=layout,
                          group=None if mesh is None else mesh.group) as ckpt:
            if restore:
                state = ckpt.restore(state)
            else:
                state, _ = _steps(step, state, x, t, spec["steps"])
                ckpt.maybe_save(state, force=True)
        snapshot = _state_numpy(state)
        _, loss = _steps(step, state, x, t, 1)
        return {"coords": c, "state": snapshot, "loss": loss[0], "step": state.step}

    out = {"save": run(*spec["save"], restore=False)}
    for dp, tp, stage in spec["restore"]:
        res = run(dp, tp, stage, restore=True)
        if res is not None:
            out[f"restore/{dp}x{tp}/zero{stage}"] = res
    return out
