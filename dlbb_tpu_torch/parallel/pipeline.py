"""Pipeline parallelism over a ``pp`` mesh axis (counterpart of
``dlbb_tpu/parallel/pipeline.py``): a GPipe forward engine, differentiable,
for the forward benchmark and the default training schedule, and a 1F1B
training engine (``pipeline_1f1b_grads``) whose stored activations are
bounded by the stage count, not the microbatch count.

Each stage holds a contiguous block of ``num_layers / pp`` layers (the pp
slice of ``models/sharding.py``); its body is the port's block
(``transformer.run_layers``) on the stage's tp group, with ZeRO-3's gather
over the stage's dp group.  As in JAX, attention "full" runs "dense" inside
a stage (JAX pins its einsum there, so the port has no flash route JAX
lacks), and a stage's remat is full remat, whatever ``remat_policy``.
The m microbatches are the global batch's (JAX's ``reshape``), each laid
over dp by itself (``data.batch_slice`` with ``chunks``): a rank's rows
(replicated over pp) are its part of each microbatch in order, so it cuts
them into ``m`` equal parts, empty on a rank with no rows of a microbatch
that dp does not divide (it still runs every tick, for its stage's
collectives).

**GPipe** (``pipeline_forward``).  The schedule of ``m + pp - 1`` ticks:
at tick t stage i runs microbatch t - i, stage 0 takes it from the batch,
the others from the previous tick's hop, and every stage then hops its
output one stage on (``Ring.shift`` over the pp group, the ring of
``parallel/ring.py`` with its transport, ``hop_transport``: staged through
host memory for CUDA tensors on gloo).  JAX computes every stage at every
tick, on garbage in the bubbles, because an SPMD program issues the same
collectives on every device; here each stage's tp, ep and dp groups lie
inside the stage, so a stage skips its bubble ticks and hops zeros.  The
last stage's outputs reach every stage by a sum over pp in which the
others add zeros (JAX's masked ``psum``), with the gradient passed through
(``sharding.reduce_from_tp``'s pattern over pp), so that the loss every
stage computes from it is not counted pp times; ``ln_f`` then runs on every
rank.  With gradients the engine is one ``torch.autograd.Function``
(``_GPipe``): its forward runs the schedule and keeps each microbatch's
stage graph, its backward runs the ticks in reverse, each stage
backpropagating its microbatch from the cotangent the next stage hopped
back (the last stage from the output's gradient), so the hops of the
backward are as ordered as those of the forward on every rank.  The aux
loss is summed over each stage's layers and valid microbatches, summed
over pp, and averaged over layers and microbatches.

**1F1B** (``pipeline_1f1b_grads``).  ``schedule_1f1b``'s tables, JAX's: in
pair u stage i forwards microbatch ``u - i`` and backwards microbatch
``u - 2(pp-1) + i``.  The forward keeps only the stage input (at most
``2 pp - 1`` of them, the memory contract); the backward recomputes the
stage from it with gradients, the last stage through ``ln_f`` and the
microbatch's MSE at cotangent 1/m, the others from the cotangent hopped
back.  Both hops of a pair go in one ``Ring.start``.  The gradients
accumulate in fp32 in the schedule's order; ``ln_f``'s (the last stage's
only), the loss and the aux are summed over pp.  Bubble slots are skipped,
as in GPipe, and the last stage, whose forward output nobody reads, skips
its no-gradient forward.

Under data parallelism the MoE load-balancing loss of a microbatch is
taken over its tokens on every dp rank (``sharding.token_mean``), as GSPMD
takes JAX's over the global microbatch; the MSE is this rank's share of the
batch mean (``sharding.share_mean``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.models.sharding import (
    all_reduce_sum,
    local_config,
    reduce_from_tp,
    share_mean,
)
from dlbb_tpu_torch.parallel.ring import BACKWARD, FORWARD, Ring


def schedule_1f1b(n_stages: int, m: int):
    """The closed-form 1F1B wavefront schedule: ``(pairs, fwd_mb,
    bwd_mb)``, the pair count ``m + 2(n_stages-1)`` and two ``[pairs,
    n_stages]`` int32 tables: in pair u stage i forwards ``fwd_mb[u, i] =
    u - i`` and backwards ``bwd_mb[u, i] = u - 2(n_stages-1) + i``; entries
    outside ``[0, m)`` are bubble slots.  Activations and cotangents hop
    exactly one pair from producer to consumer, and a stage never holds
    more than ``2 n_stages - 1`` microbatches forwarded and not yet
    backwarded."""
    pairs = m + 2 * (n_stages - 1)
    u = np.arange(pairs)[:, None]
    i = np.arange(n_stages)[None, :]
    fwd_mb = (u - i).astype(np.int32)
    bwd_mb = (u - 2 * (n_stages - 1) + i).astype(np.int32)
    return pairs, fwd_mb, bwd_mb


def validate_pipeline(config: ModelConfig, n_stages: int, batch_size: int,
                      num_microbatches: Optional[int]) -> int:
    """Check divisibility and the attention mode; returns the resolved
    microbatch count (default: one per stage).  JAX's checks and
    messages."""
    m = num_microbatches if num_microbatches is not None else n_stages
    if m < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {m}")
    if config.num_layers % n_stages != 0:
        raise ValueError(
            f"num_layers={config.num_layers} not divisible by "
            f"pipeline_parallel={n_stages}"
        )
    if batch_size % m != 0:
        raise ValueError(
            f"batch_size={batch_size} not divisible by "
            f"num_microbatches={m}"
        )
    if config.attention not in ("full", "dense", "simplified"):
        raise ValueError(
            f"attention={config.attention!r} cannot run under pipeline "
            "parallelism (ring/ulysses/flash need their own shard_map; "
            "use attention='full'/'dense'/'simplified' with "
            "pipeline_parallel > 1)"
        )
    return m


def split_rows(x: torch.Tensor, m: int) -> list[torch.Tensor]:
    """``x`` cut along its rows into ``m`` equal parts (views), empty ones
    too where ``x`` has no rows."""
    rows = x.shape[0] // m
    return [x.narrow(0, i * rows, rows) for i in range(m)]


class _Stage:
    """This rank's pipeline stage: its index and the pp ring, the
    microbatch count, the stage's config (attention "full" as "dense",
    full remat, this rank's tp shard) and its stacked layer leaves in a
    fixed order.  ``batch_rows`` are this rank's (module docstring): JAX's
    checks run on them, which the m parts of each microbatch divide."""

    def __init__(self, params, config: ModelConfig, mesh, num_microbatches,
                 batch_rows: int, dp_axes=None) -> None:
        self.n = mesh.shape["pp"]
        self.index = mesh.coords["pp"]
        self.last = self.index == self.n - 1
        self.m = validate_pipeline(config, self.n, batch_rows, num_microbatches)
        self.ring = Ring(mesh.axis_groups["pp"])
        self.mesh = mesh
        cfg = config.with_(attention="dense") if config.attention == "full" else config
        self.config = local_config(cfg.with_(remat_policy="full"), mesh.shape["tp"])
        stacked = params["layers"]
        self.names = [(g, p) for g, sub in stacked.items() for p in sub]
        self.leaves = [stacked[g][p] for g, p in self.names]
        self.dp_axes = dp_axes

    def tree(self, leaves) -> dict[str, dict[str, torch.Tensor]]:
        out: dict[str, dict[str, torch.Tensor]] = {}
        for (g, p), t in zip(self.names, leaves):
            out.setdefault(g, {})[p] = t
        return out

    def run(self, h, leaves, with_aux: bool):
        """This stage's layers on ``h``: ``(y, aux)``, aux the sum of its
        layers' load-balancing losses where asked for, else None."""
        from dlbb_tpu_torch.models.transformer import layer_list, run_layers

        layers, fsdp = layer_list(self.tree(leaves), self.mesh,
                                  None if self.dp_axes is None else self.dp_axes["layers"])
        return run_layers(h, layers, self.config, self.mesh, fsdp, with_aux)

    # ---- GPipe ------------------------------------------------------------

    def gpipe(self, x, leaves, with_aux: bool, record: bool):
        """The forward schedule: ``(outputs, aux, graphs)``, outputs the
        last stage's ``[B, ...]`` result (zeros elsewhere), aux this stage's
        fp32 sum over its layers and valid microbatches, graphs (where
        ``record``) each microbatch's ``(stage input, output, aux)``."""
        mbs = split_rows(x, self.m)
        self.zero = torch.zeros_like(mbs[0])
        outs = [self.zero] * self.m
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        graphs: list[Any] = [None] * self.m
        recv = None
        ticks = self.m + self.n - 1
        for t in range(ticks):
            i = t - self.index
            send = self.zero
            if 0 <= i < self.m:
                h = mbs[i] if self.index == 0 else recv
                if record:
                    h = h.detach().requires_grad_(self.index > 0 or x.requires_grad)
                y, aux = self.run(h, leaves, with_aux)
                if record:
                    graphs[i] = (h, y, aux)
                if aux is not None:
                    aux_sum = aux_sum + aux.detach().float()
                send = y.detach()
                if self.last:
                    outs[i] = send
            if t < ticks - 1:  # the last tick's hop reaches no stage that needs it
                (recv,) = self.ring.shift([send], FORWARD)
        return torch.cat(outs), aux_sum, graphs

    def gpipe_backward(self, graphs, leaves, grad_y, grad_aux, x_grad: bool):
        """The reverse schedule: each stage backpropagates its microbatch
        at the mirror of its forward tick, from the output's gradient on
        the last stage and from the cotangent the next stage hopped back
        elsewhere.  Returns the leaves' gradients (accumulated in fp32, in
        their dtype) and, where ``x_grad``, the batch's (stage 0's, summed
        over pp: the batch is replicated there)."""
        acc: list[Optional[torch.Tensor]] = [None] * len(leaves)
        gys = split_rows(grad_y, self.m)
        dxs = [self.zero] * self.m
        cot = None
        ticks = self.m + self.n - 1
        for t in reversed(range(ticks)):
            i = t - self.index
            send = self.zero
            if 0 <= i < self.m:
                h, y, aux = graphs[i]
                graphs[i] = None
                outs, cots = [y], [gys[i] if self.last else cot]
                if aux is not None:
                    outs.append(aux)
                    cots.append(grad_aux.to(aux.dtype))
                wrt = ([h] if h.requires_grad else []) + list(leaves)
                grads = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
                if h.requires_grad:
                    dh, grads = grads[0], grads[1:]
                    if self.index == 0:
                        dxs[i] = dh
                    else:
                        send = dh
                for k, g in enumerate(grads):
                    if g is not None:
                        acc[k] = g.float() if acc[k] is None else acc[k] + g.float()
            if t > 0:  # tick 0's input cotangent is stage 0's, for no stage
                (cot,) = self.ring.shift([send], BACKWARD)
        dleaves = [torch.zeros_like(p) if a is None else a.to(p.dtype)
                   for a, p in zip(acc, leaves)]
        dx = all_reduce_sum(torch.cat(dxs), self.ring.group) if x_grad else None
        return dleaves, dx


class _GPipe(torch.autograd.Function):
    """The GPipe schedule with the reverse schedule as its backward (module
    docstring)."""

    @staticmethod
    def forward(ctx, stage, with_aux, x, *leaves):
        detached = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        with torch.enable_grad():
            outputs, aux, graphs = stage.gpipe(x, detached, with_aux, record=True)
        ctx.stage, ctx.graphs, ctx.detached = stage, graphs, detached
        return outputs, aux

    @staticmethod
    def backward(ctx, grad_y, grad_aux):
        dleaves, dx = ctx.stage.gpipe_backward(ctx.graphs, ctx.detached, grad_y,
                                               grad_aux, ctx.needs_input_grad[2])
        ctx.graphs = ctx.detached = None
        return (None, None, dx, *dleaves)


def pipeline_forward(params, x: torch.Tensor, config: ModelConfig, mesh,
                     num_microbatches: Optional[int] = None, with_aux: bool = False,
                     dp_axes=None):
    """The full forward with the layer stack pipelined over the mesh's pp
    group, GPipe (module docstring): ``params`` are this rank's stage
    (``sharding.shard_params`` with its ``pp_rank``), ``x`` its rows of the
    m microbatches, whole over pp; ``ln_f`` runs after the pipeline on every
    rank.  ``with_aux`` also returns the MoE load-balancing loss, averaged
    over layers and microbatches (0.0 for a dense FFN)."""
    from dlbb_tpu_torch.models.transformer import final_norm

    stage = _Stage(params, config, mesh, num_microbatches, x.shape[0], dp_axes)
    moe_aux = with_aux and config.is_moe
    if torch.is_grad_enabled() and any(p.requires_grad for p in stage.leaves):
        outputs, aux = _GPipe.apply(stage, moe_aux, x, *stage.leaves)
    else:
        outputs, aux, _ = stage.gpipe(x, stage.leaves, moe_aux, record=False)
    group = mesh.axis_groups["pp"]
    y = reduce_from_tp(outputs, group)
    out = final_norm(y, params["ln_f"], mesh, None if dp_axes is None else dp_axes["ln_f"])
    if not with_aux:
        return out
    return out, reduce_from_tp(aux, group) / (config.num_layers * stage.m)


def pipeline_1f1b_grads(params, x: torch.Tensor, targets: torch.Tensor,
                        config: ModelConfig, mesh, num_microbatches: Optional[int] = None,
                        moe_aux_weight: float = 0.0, dp_axes=None,
                        stats: Optional[dict] = None, share: float = 1.0):
    """One 1F1B training pass (module docstring): ``(loss, grads)``, the
    loss the unpipelined MSE over this rank's rows (the mean of the equal
    microbatches' means) times its ``share`` of the batch's rows
    (``sharding.share_mean``) plus ``moe_aux_weight`` times the layer and
    microbatch mean of the MoE aux, ``grads`` a tree like ``params`` (the
    stage's layer leaves and ``ln_f``, whose gradient is summed over pp),
    each in its leaf's dtype.  ``stats`` (a dict) receives
    ``max_live_inputs``, the most stage inputs this rank held at once."""
    from dlbb_tpu_torch.models.transformer import final_norm

    stage = _Stage(params, config, mesh, num_microbatches, x.shape[0], dp_axes)
    n, s, m = stage.n, stage.index, stage.m
    with_aux = moe_aux_weight != 0.0 and config.is_moe
    pairs, fwd_tbl, bwd_tbl = schedule_1f1b(n, m)
    leaves = [p.detach().requires_grad_(True) for p in stage.leaves]
    ln_f = {p: t.detach().requires_grad_(True) for p, t in params["ln_f"].items()}
    lnf_names = list(ln_f)
    lnf_axes = None if dp_axes is None else dp_axes["ln_f"]
    aux_cot = moe_aux_weight / (config.num_layers * m)
    mbs, tmbs = split_rows(x, m), split_rows(targets, m)
    zero = torch.zeros_like(mbs[0])
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    acc_lnf = {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for p, t in ln_f.items()}
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    stored: dict[int, torch.Tensor] = {}
    max_live = 0
    recv_f = recv_b = None
    for u in range(pairs):
        send_f = send_b = zero
        f = int(fwd_tbl[u, s])
        if 0 <= f < m:
            h = mbs[f] if s == 0 else recv_f
            stored[f] = h
            max_live = max(max_live, len(stored))
            if not stage.last:
                with torch.no_grad():
                    send_f, _ = stage.run(h, leaves, False)
        b = int(bwd_tbl[u, s])
        if 0 <= b < m:
            h = stored.pop(b).detach().requires_grad_(s > 0)
            with torch.enable_grad():
                y, aux = stage.run(h, leaves, with_aux)
                if stage.last:
                    z = final_norm(y, ln_f, mesh, lnf_axes)
                    loss_b = share_mean((z.float() - tmbs[b].float()) ** 2, share)
                    outs = [loss_b]
                    cots = [torch.full_like(loss_b, 1.0 / m)]
                else:
                    outs, cots = [y], [recv_b]
                if with_aux:
                    outs.append(aux)
                    cots.append(torch.full_like(aux, aux_cot))
                wrt = ([h] if s > 0 else []) + leaves
                if stage.last:
                    wrt += [ln_f[p] for p in lnf_names]
                grads = list(torch.autograd.grad(outs, wrt, cots, allow_unused=True))
            if s > 0:
                send_b = grads.pop(0)
            for k in range(len(leaves)):
                if grads[k] is not None:
                    acc[k] += grads[k].float()
            if stage.last:
                for p, g in zip(lnf_names, grads[len(leaves):]):
                    if g is not None:
                        acc_lnf[p] += g.float()
                loss_sum = loss_sum + loss_b.detach() / m
            if with_aux:
                aux_sum = aux_sum + aux.detach().float() / (config.num_layers * m)
        if u < pairs - 1:  # the last pair's results go to no stage that needs them
            recv_f, recv_b = stage.ring.start([(send_f, FORWARD), (send_b, BACKWARD)]).wait()
    if stats is not None:
        stats["max_live_inputs"] = max_live
    group = mesh.axis_groups["pp"]
    loss = all_reduce_sum(loss_sum, group)
    total = loss + moe_aux_weight * all_reduce_sum(aux_sum, group) if with_aux else loss
    layer_grads = stage.tree([a.to(p.dtype) for a, p in zip(acc, stage.leaves)])
    lnf_grads = {p: all_reduce_sum(acc_lnf[p], group).to(t.dtype)
                 for p, t in params["ln_f"].items()}
    return total, {"layers": layer_grads, "ln_f": lnf_grads}
