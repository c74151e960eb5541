"""ZeRO stages 0-3 as explicit collectives over the mesh's dp group
(counterpart of the ZeRO layout in ``dlbb_tpu/train/loop.py``, under its
names).

The JAX package declares each stage as a sharding and lets GSPMD insert the
collectives.  The port runs them itself, as the reference's DeepSpeed does
(``test/ccl.py:59-117``):

- stage 0 (DDP): each gradient is all-reduced (SUM) over dp, then divided
  by dp; every rank updates the whole leaf;
- stages 1 and 2: each gradient is reduce-scattered along the leaf's dp
  axis, the rank updates its shard with its shard of the optimizer state,
  and the new parameter is all-gathered.  Stage 2 reduce-scatters each
  micro-step's gradient under gradient accumulation and accumulates the
  shard (``train/loop.py``); stage 1 reduces the accumulated gradient once;
- stage 3 (FSDP): the parameters live as dp shards, gathered on use by the
  forward (``models/transformer.py``, ``sharding.gather_parts``), whose
  backward hands each gradient over already reduce-scattered; the rank
  updates its shard and keeps it.

A leaf's dp axis is ``_dp_shard_spec``'s: the largest dimension that no
other mesh axis cuts (tp's dimension, and under pp the layer dimension,
under ep the expert dimension, as JAX's rule skips every axis its
``PartitionSpec`` already names), that dp divides and whose size is above
1, the first on a tie.
A leaf with no such axis, or whose optimizer state ``opt_state_specs``
leaves replicated (adafactor's factored statistics, sgd without momentum:
no state subtree mirrors the params), takes the stage-0 path; at stage 3 it
all-gathers its gradient and parameter, updates the whole leaf and keeps
its shard of the result.  Adafactor takes RMS statistics over whole leaves
(its update is not elementwise, ``GradientTransformation.elementwise``), so
its state stays replicated and it updates whole leaves even where its
unfactored statistics mirror the params: GSPMD computes those statistics
across the shards in JAX, and the port does not split them.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from dlbb_tpu_torch.models.sharding import (
    PP_DIM,
    all_gather_along,
    all_reduce_sum,
    ep_dim,
    is_moe_tree,
    reduce_scatter_along,
    tp_dim,
)
from dlbb_tpu_torch.train.optim import GradientTransformation, apply_updates, tree_map


def _dp_shard_spec(taken, shape: tuple[int, ...], dp_size: int) -> Optional[int]:
    """The dp axis of a leaf of ``shape`` (this rank's part) whose
    dimensions ``taken`` another mesh axis cuts: the largest other
    dimension that ``dp_size`` divides and whose size is above 1, the first
    such on a tie; None when there is none."""
    candidates = sorted(
        (i for i in range(len(shape))
         if i not in taken and shape[i] % dp_size == 0 and shape[i] > 1),
        key=lambda i: -shape[i])
    return candidates[0] if candidates else None


def taken_dims(group: str, leaf: str, moe: bool, pp: int = 1, ep: int = 1) -> tuple:
    """The dimensions of the stacked leaf ``group.leaf`` that a mesh axis
    other than dp cuts (JAX's ``specs_for_mesh``): tp's (whatever its size,
    as JAX names tp wherever the mesh has it), the layer dimension where pp
    is above 1, the expert dimension where ep is above 1."""
    dims = [d for d in (tp_dim(group, leaf, moe),
                        PP_DIM if pp > 1 else None,
                        ep_dim(group, leaf, moe) if ep > 1 else None) if d is not None]
    return tuple(dims)


def dp_sharded_param_specs(params: Any, dp_size: int, pp: int = 1, ep: int = 1) -> Any:
    """Each leaf's dp axis (``_dp_shard_spec``), as a tree like ``params``
    (this rank's parts on a mesh of degrees ``pp`` and ``ep``): the FSDP
    parameter layout of stage 3, and the optimizer-state and gradient
    layout of stages 1 and 2."""
    moe = is_moe_tree(params)
    return {"layers": {group: {leaf: _dp_shard_spec(taken_dims(group, leaf, moe, pp, ep),
                                                    t.shape, dp_size)
                               for leaf, t in sub.items()}
                       for group, sub in params["layers"].items()},
            "ln_f": {leaf: _dp_shard_spec((), t.shape, dp_size)
                     for leaf, t in params["ln_f"].items()}}


def _mirrors(node: Any, params: Any) -> bool:
    """Whether ``node`` has the structure of ``params`` and, leaf by leaf,
    their shapes."""
    if isinstance(params, dict):
        return (isinstance(node, dict) and node.keys() == params.keys()
                and all(_mirrors(node[k], params[k]) for k in params))
    return isinstance(node, torch.Tensor) and node.shape == params.shape


def opt_state_specs(params: Any, opt_state: Any, zero1: bool, dp_size: int,
                    pp: int = 1, ep: int = 1) -> Any:
    """Each optimizer-state leaf's dp axis, as a tree like ``opt_state``.

    The rule is structural: a state subtree whose structure and leaf shapes
    mirror ``params`` (Adam's mu and nu) takes the params' dp axes when
    ``zero1`` (stage 1 and up), and None (replicated) otherwise; everything
    else (step counts, adafactor's factored statistics, whose shapes differ
    from the params') is replicated."""
    axes = dp_sharded_param_specs(params, dp_size, pp, ep)

    def recur(node):
        if _mirrors(node, params):
            return axes if zero1 else tree_map(lambda _: None, axes)
        if isinstance(node, tuple):  # a NamedTuple state
            return type(node)(*(recur(c) for c in node))
        if isinstance(node, dict):
            return {k: recur(v) for k, v in node.items()}
        return None

    return recur(opt_state)


def _leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and (Named)tuples."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_along(t: torch.Tensor, dim: Optional[int], rank: int,
                size: int) -> torch.Tensor:
    """Rank ``rank``'s 1/``size`` of ``t`` along ``dim`` (a view; ``t``
    itself when ``dim`` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous tensor with storage of its own, so that the
    full tensor it was cut from can be freed."""
    return t.clone(memory_format=torch.contiguous_format)


def shard_tree(tree: Any, axes: Any, rank: int, size: int) -> Any:
    """Each leaf's shard (``shard_along``) as a tensor of its own."""
    return tree_map(lambda t, ax: t if ax is None
                    else _own(shard_along(t, ax, rank, size)), tree, axes)


def unshard_tree(shards: list[Any], axes: Any) -> Any:
    """The full leaves from every dp rank's shards, by dp rank (the inverse
    of ``shard_tree``)."""
    return tree_map(lambda *parts: parts[0] if parts[-1] is None
                    else torch.cat(parts[:-1], parts[-1]), *shards, axes)


class Zero:
    """One rank's side of a ZeRO stage: the layout of its parameters and
    optimizer state, the reduction of its gradients and the update.

    ``params`` are the rank's full (tp-sharded) parameters; ``mesh`` a
    ``comm.Mesh`` with a ``dp`` axis, or None for one device without a
    process group, where every collective is skipped."""

    def __init__(self, stage: int, optimizer: GradientTransformation,
                 params: Any, mesh=None) -> None:
        self.optimizer = optimizer
        self.group = None if mesh is None else mesh.axis_groups["dp"]
        self.dp = 1 if mesh is None else mesh.shape["dp"]
        self.rank = 0 if mesh is None else mesh.coords["dp"]
        pp = 1 if mesh is None else mesh.shape.get("pp", 1)
        ep = 1 if mesh is None else mesh.shape.get("ep", 1)
        self.axes = dp_sharded_param_specs(params, self.dp, pp, ep)
        meta = tree_map(lambda p: torch.empty_like(p, device="meta"), params)
        specs = opt_state_specs(meta, optimizer.init(meta),
                                stage >= 1 and optimizer.elementwise, self.dp, pp, ep)
        state_sharded = any(ax is not None for ax in _leaves(specs))
        # the leaves the optimizer updates as shards
        self.opt_axes = tree_map(lambda ax: ax if state_sharded else None, self.axes)
        # the leaves that live as shards: at stage 3 every leaf with a dp axis
        self.param_axes = (self.axes if stage == 3
                           else tree_map(lambda _: None, self.axes))

    # ---- layout ---------------------------------------------------------

    def init(self, params: Any) -> tuple[Any, Any]:
        """(this rank's parameters, its optimizer state) from its full
        parameters."""
        work = shard_tree(params, self.opt_axes, self.rank, self.dp)
        opt_state = self.optimizer.init(work)
        return shard_tree(params, self.param_axes, self.rank, self.dp), opt_state

    # ---- collectives ----------------------------------------------------

    def _all_reduce(self, t):
        return t if self.group is None else all_reduce_sum(t, self.group)

    def _gather(self, t, ax):
        return t if self.group is None else all_gather_along(t, ax, self.group)

    def _scatter(self, t, ax):
        return t if self.group is None else reduce_scatter_along(t, ax, self.group)

    # ---- gradients --------------------------------------------------------

    def reduce(self, grads: Any) -> Any:
        """The dp sum of this rank's gradients, in the layout the optimizer
        updates: a shard where ``opt_axes`` has an axis, the whole leaf
        elsewhere.  At stage 3 a sharded leaf's gradient arrives summed and
        cut already (``sharding.gather_parts``)."""

        def one(g, ax, opt_ax, p_ax):
            if p_ax is not None:  # stage 3: already the summed shard
                return g if opt_ax is not None else self._gather(g, p_ax)
            if opt_ax is not None:
                return self._scatter(g, opt_ax)
            return self._all_reduce(g)

        return tree_map(one, grads, self.axes, self.opt_axes, self.param_axes)

    def mean(self, grads: Any) -> Any:
        """The reduced gradients divided by dp: the gradient of the global
        batch's mean loss."""
        return grads if self.dp == 1 else tree_map(lambda g: g / self.dp, grads)

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global batch's loss from this rank's (an fp32 scalar)."""
        return loss if self.dp == 1 else self._all_reduce(loss) / self.dp

    # ---- update -----------------------------------------------------------

    def apply(self, params: Any, grads: Any, opt_state: Any) -> tuple[Any, Any]:
        """One optimizer update from the reduced mean ``grads``: (this
        rank's new parameters, its new optimizer state)."""

        def work_param(p, opt_ax, p_ax):
            if p_ax is not None:
                return p if opt_ax is not None else self._gather(p, p_ax)
            return shard_along(p, opt_ax, self.rank, self.dp)

        work = tree_map(work_param, params, self.opt_axes, self.param_axes)
        updates, new_opt = self.optimizer.update(grads, opt_state, work)
        new_work = apply_updates(work, updates)

        def new_param(p, opt_ax, p_ax):
            if p_ax is not None:
                return p if opt_ax is not None else _own(shard_along(p, p_ax, self.rank, self.dp))
            return p if opt_ax is None else self._gather(p, opt_ax)

        return tree_map(new_param, new_work, self.opt_axes, self.param_axes), new_opt
