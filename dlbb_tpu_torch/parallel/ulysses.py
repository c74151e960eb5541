"""Ulysses (all-to-all) sequence parallelism (counterpart of
``dlbb_tpu/parallel/ulysses.py``).

DeepSpeed-Ulysses context parallelism: the sequence is sharded over the
mesh's sp axis; an all-to-all over the sp group reshards each rank's
``[B, n, S/P, d]`` (sequence-sharded) into ``[B, n/P, S, d]``
(head-sharded), dense attention (``models/attention.py``, as JAX uses
``dense_attention``) runs on the rank's head group over the whole sequence,
and the reverse all-to-all reshards back.  The all-to-alls are JAX's tiled
``lax.all_to_all``s, as ``all_to_all_single`` over the sp group inside an
autograd Function whose backward is the inverse all-to-all (the transpose
of a permutation).  gloo's ``all_to_all_single`` takes CUDA tensors
(``scripts/torch_gloo_p2p_probe.py``), so no host staging is needed.

The model (``models/transformer.py``) calls it on each rank's tp heads, as
it does ring attention.  Where sp does not divide a rank's ``num_heads/tp``
heads, or tp does not divide the heads, the model gathers the heads over tp
first and calls it on all of them, as GSPMD gathers them for JAX's
``shard_map`` (spec ``P(dp, None, sp, None)``), and keeps the rank's own;
JAX's two checks (``num_heads % sp``, ``kv_heads % sp``) are the only ones.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dlbb_tpu_torch.models.attention import dense_attention


def _all_to_all(x: torch.Tensor, group, to_heads: bool) -> torch.Tensor:
    """``to_heads``: ``[B, n, S/P, d]`` -> ``[B, n/P, S, d]``: head group j
    goes to rank j, and the blocks received are concatenated along the
    sequence in rank order.  Otherwise the reverse: sequence block j goes to
    rank j, and the head groups received are concatenated in rank order."""
    p = dist.get_world_size(group)
    b, n, s, d = x.shape
    if to_heads:
        src = x.reshape(b, p, n // p, s, d).transpose(0, 1)
    else:
        src = x.reshape(b, n, p, s // p, d).permute(2, 0, 1, 3, 4)
    src = src.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    if to_heads:  # [P(src), B, n/P, S/P, d]
        return out.permute(1, 2, 0, 3, 4).reshape(b, n // p, p * s, d)
    return out.transpose(0, 1).reshape(b, p * n, s // p, d)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, to_heads):
        ctx.group, ctx.to_heads = group, to_heads
        return _all_to_all(x, group, to_heads)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group, not ctx.to_heads), None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      sp_axis: str = "sp", causal: bool = True) -> torch.Tensor:
    """Exact attention with the sequence sharded over the mesh's ``sp_axis``
    by head resharding.  q: this rank's ``[B, num_heads, S/P, head_dim]``;
    k, v: the same, or grouped-query ``[B, kv_heads, S/P, head_dim]``: both
    head counts must divide by the sp size P (each rank then holds
    ``num_heads/P`` query heads and ``kv_heads/P`` K/V heads, and the dense
    kernel shares K/V by broadcasting).  Returns this rank's block."""
    if sp_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh {tuple(mesh.axis_names)} has no {sp_axis!r} axis for ulysses"
        )
    p = mesh.shape[sp_axis]
    num_heads, kv_heads = q.shape[1], k.shape[1]
    if num_heads % p != 0:
        raise ValueError(
            f"ulysses needs num_heads ({num_heads}) divisible by "
            f"sp={p}; use ring attention instead"
        )
    if kv_heads % p != 0:
        raise ValueError(
            f"ulysses needs kv_heads ({kv_heads}) divisible by sp={p}; "
            "broadcast K/V to num_heads first, or use ring attention "
            "(which keeps grouped K/V for any kv_heads)"
        )
    if p == 1:
        return dense_attention(q, k, v, causal=causal)
    group = mesh.axis_groups[sp_axis]
    qh, kh, vh = (_AllToAll.apply(t, group, True) for t in (q, k, v))
    oh = dense_attention(qh, kh, vh, causal=causal)  # [B, n/P, S, d]
    return _AllToAll.apply(oh, group, False)
