"""Rank body of ``tests/test_torch_tp.py``: the port's tensor-parallel
forward, and its gradients, on a gloo group.  It imports torch and the port only, since
``bench.launch`` imports it by name in every spawned rank."""

import torch
import torch.distributed as dist

from dlbb_tpu_torch.comm import build_parallelism_mesh
from dlbb_tpu_torch.data import SyntheticEmbeddingDataset
from dlbb_tpu_torch.models import ModelConfig, forward, params_from_jax
from dlbb_tpu_torch.models.sharding import shard_params, sum_kv_copies
from dlbb_tpu_torch.models.transformer import DTYPES
from dlbb_tpu_torch.train.loop import mse_loss
from dlbb_tpu_torch.train.optim import tree_leaves, tree_map


def run_tp_cases(meshes, cases, weights, batch_shape):
    """``meshes``: ``(dp, tp)`` pairs; ``cases``: ``(case id, ModelConfig
    fields, weights key)``; ``weights``: the JAX parameter trees as float32
    numpy, by key; ``batch_shape``: the global ``(B, S, H)`` batch, seed 42.
    Every rank builds every mesh, in order; the ranks of a mesh run every
    case on its shards and their dp slice of the batch.  Returns, for this
    rank, ``{(dp, tp): {"coords", "groups", case id: float32 output}}``."""
    out = {}
    for dp, tp in meshes:
        mesh = build_parallelism_mesh(dp, 1, 1, tp, 1)
        if mesh is None:
            continue
        c = mesh.coords
        res = {"coords": c, "groups": {a: dist.get_process_group_ranks(g)
                                       for a, g in mesh.axis_groups.items()}}
        for case_id, fields, key in cases:
            cfg = ModelConfig(**fields)
            local = shard_params(params_from_jax(weights[key], cfg), cfg, c["tp"], tp)
            x = SyntheticEmbeddingDataset(*batch_shape, seed=42, dtype=DTYPES[cfg.dtype],
                                          dp_rank=c["dp"], dp=dp).get_batch()
            with torch.inference_mode():
                res[case_id] = forward(local, x, cfg, mesh=mesh).float().numpy()
        out[(dp, tp)] = res
    return out


def run_tp_grads(meshes, cases, weights, batch_shape):
    """The MSE loss against the seed-43 targets and its gradients on this
    rank's shards, with each kv copy's gradient made its source column's
    (``sum_kv_copies``, as the train step does), for every case on every
    ``(1, tp)`` mesh.  Returns ``{(1, tp): {"coords", case id: (loss,
    gradient tree as float32 numpy)}}``."""
    out = {}
    for dp, tp in meshes:
        mesh = build_parallelism_mesh(dp, 1, 1, tp, 1)
        if mesh is None:
            continue
        c = mesh.coords
        res = {"coords": c}
        for case_id, fields, key in cases:
            cfg = ModelConfig(**fields)
            local = shard_params(params_from_jax(weights[key], cfg), cfg, c["tp"], tp)
            leaves = tree_leaves(local)
            for p in leaves:
                p.requires_grad_(True)
            x, t = (SyntheticEmbeddingDataset(*batch_shape, seed=seed, dtype=DTYPES[cfg.dtype])
                    .get_batch() for seed in (42, 43))
            loss = mse_loss(local, x, t, cfg, mesh=mesh)
            grads = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda _: next(grads), local)
            grads["layers"]["qkv"] = {
                leaf: sum_kv_copies(g, cfg, c["tp"], tp, mesh.axis_groups["tp"])
                for leaf, g in grads["layers"]["qkv"].items()}
            res[case_id] = (float(loss), tree_map(lambda g: g.float().numpy(), grads))
        out[(dp, tp)] = res
    return out
