"""Rank body of ``tests/test_torch_moe.py`` and ``tests/test_torch_pipeline.py``:
the port's MoE and pipelined forwards, and their gradients, on a gloo
group.  It imports torch and the port only, since ``bench.launch`` imports
it by name in every spawned rank."""

import numpy as np
import torch

from dlbb_tpu_torch.comm import build_parallelism_mesh
from dlbb_tpu_torch.data import batch_slice
from dlbb_tpu_torch.models import ModelConfig, forward, params_from_jax
from dlbb_tpu_torch.models.sharding import batch_spec, shard_params
from dlbb_tpu_torch.parallel.pipeline import pipeline_1f1b_grads
from dlbb_tpu_torch.train.loop import mse_loss
from dlbb_tpu_torch.train.optim import tree_leaves, tree_map


def _numpy(tree):
    return tree_map(lambda t: t.detach().float().numpy().copy(), tree)


def run_model_cases(cases, weights, batches):
    """``cases``: ``(case id, spec)`` pairs, a spec holding ``mesh`` ((dp,
    sp, pp, ep, tp)), ``fields`` (ModelConfig), ``weights`` and ``batch``
    (keys of the next two arguments), ``kind`` and ``microbatches``:

    - ``"forward"``: the forward without gradients, with ``with_aux``;
    - ``"gpipe"``: the loss ``mse_loss`` (``aux`` its aux weight) and its
      gradients by autograd, through the GPipe engine on a pp mesh;
    - ``"1f1b"``: ``pipeline_1f1b_grads``' loss and gradients and its
      ``max_live_inputs``.

    The gradients are this rank's, before any reduction over dp.  Every
    rank builds every mesh, in the order the cases first name them; the
    ranks of a mesh run its cases.  Returns, for this rank, ``{case id:
    result}``."""
    meshes = {}
    for _, spec in cases:
        if spec["mesh"] not in meshes:
            dp, sp, pp, ep, tp = spec["mesh"]
            meshes[spec["mesh"]] = build_parallelism_mesh(dp, sp, pp, tp, ep)
    out = {}
    for case_id, spec in cases:
        mesh = meshes[spec["mesh"]]
        if mesh is None:
            continue
        _, _, pp, ep, tp = spec["mesh"]
        c = mesh.coords
        cfg = ModelConfig(**spec["fields"])
        local = shard_params(params_from_jax(weights[spec["weights"]], cfg), cfg, c["tp"], tp,
                             c.get("pp", 0), pp, c.get("ep", 0), ep)
        x, t = (torch.from_numpy(np.ascontiguousarray(batch_slice(a, **batch_spec(mesh))))
                for a in batches[spec["batch"]])
        m = spec.get("microbatches")
        res = {"coords": c}
        if spec["kind"] == "forward":
            with torch.no_grad():
                y = forward(local, x, cfg, mesh=mesh, num_microbatches=m,
                            with_aux=spec.get("with_aux", False))
            if isinstance(y, tuple):
                y, aux = y
                res["aux"] = float(aux)
            res["y"] = y.numpy().copy()
        elif spec["kind"] == "gpipe":
            leaves = tree_leaves(local)
            for p in leaves:
                p.requires_grad_(True)
            loss = mse_loss(local, x, t, cfg, mesh=mesh, num_microbatches=m,
                            moe_aux_weight=spec.get("aux", 0.0))
            grads = iter(torch.autograd.grad(loss, leaves))
            res.update(loss=float(loss.detach()),
                       grads=_numpy(tree_map(lambda _: next(grads), local)))
        else:
            stats = {}
            loss, grads = pipeline_1f1b_grads(local, x, t, cfg, mesh, num_microbatches=m,
                                              moe_aux_weight=spec.get("aux", 0.0),
                                              stats=stats)
            res.update(loss=float(loss), grads=_numpy(grads), **stats)
        out[case_id] = res
    return out


def run_cases(model_cases, train_cases, weights, batches):
    """``run_model_cases`` on ``model_cases``, then
    ``torch_train_worker.run_train_cases`` on ``train_cases``, in one
    launch: ``(model results, train results)`` of this rank."""
    import torch_train_worker

    return (run_model_cases(model_cases, weights, batches),
            torch_train_worker.run_train_cases(train_cases, weights, batches))


def run_entry_points(config):
    """``run_e2e`` and ``run_train`` on ``config``, on the CPU: this rank's
    two results."""
    from dlbb_tpu_torch.bench.e2e import run_e2e
    from dlbb_tpu_torch.train.loop import run_train

    return (run_e2e(config, device="cpu", verbose=False),
            run_train(config, device="cpu", verbose=False))


def run_memmap_train_case(spec, weight_dir, batch):
    """``torch_train_worker.run_train_cases``' body for one case whose JAX
    weights are ``.npy`` files in ``weight_dir`` (one per ``group.leaf``),
    read through memory maps so that each rank copies only its own part;
    ``batch`` the global ``(x, targets)``.  Returns this rank's result or
    None off the mesh."""
    from dlbb_tpu_torch.models.sharding import shard_leaf
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer

    dp, sp, pp, ep, tp = spec["mesh"]
    mesh = build_parallelism_mesh(dp, sp, pp, tp, ep)
    if mesh is None:
        return None
    c = mesh.coords
    cfg = ModelConfig(**spec["fields"])

    def load(name):
        return torch.from_numpy(np.load(f"{weight_dir}/{name}.npy", mmap_mode="r"))

    groups = ("ln1", "qkv", "out", "ln2", "ffn_up", "ffn_down")
    leaves = {"ln1": ("scale", "bias"), "qkv": ("kernel", "bias"), "out": ("kernel", "bias"),
              "ln2": ("scale", "bias"), "ffn_up": ("kernel", "bias"),
              "ffn_down": ("kernel", "bias")}
    local = {"layers": {g: {p: shard_leaf(g, p, load(f"layers.{g}.{p}"), cfg, c["tp"], tp)
                            .clone() for p in leaves[g]} for g in groups},
             "ln_f": {p: load(f"ln_f.{p}").clone() for p in ("scale", "bias")}}
    x, t = (torch.from_numpy(np.ascontiguousarray(batch_slice(a, **batch_spec(mesh))))
            for a in batch)
    step, state = make_train_step(cfg, build_optimizer(spec["train"]), local, mesh=mesh,
                                  zero_stage=spec["stage"], batch_size=batch[0].shape[0])
    del local
    losses = []
    for _ in range(spec["steps"]):
        state, loss = step(state, x, t)
        losses.append(float(loss))
    return {"coords": c, "losses": losses, "params": _numpy(state.params)}
