"""Ring attention: exact attention (causal or bidirectional) over a
sequence-sharded mesh axis, with grouped-query K/V (counterpart of
``dlbb_tpu/parallel/ring_attention.py``).

Each rank owns one contiguous block of the sequence: its queries stay, and
the K/V blocks travel the ring of the mesh's sp group.  At ring step ``j``
a rank holds the block that rank ``(rank - j) mod P`` owns; it adds that
block's part to its queries' online softmax (running max ``m``, normaliser
``l``, weighted accumulator ``acc``, all fp32: the flash-attention
recurrence), then passes the block on.  The last block is consumed without
a hop.  Causality is by global positions (the query block is the rank's,
the key block the travelling block's origin), so the result is the causal
attention of the whole sequence; ``causal=False`` drops the mask.  K/V stay
at ``kv_heads`` width in memory and on the ring.

The JAX body is ``jnp`` inside a ``shard_map``, not Pallas, so torch ops
are its counterpart here, and autograd differentiates them.  Torch's
point-to-point calls carry no gradient, where ``lax.ppermute`` transposes
to the reverse permute: the K/V hop is ``parallel/ring.py::ring_shift``,
whose backward sends each gradient one hop back.  The hop waits before the
next block's products (eager autograd), where XLA may overlap it.

The model (``models/transformer.py``) calls it on each rank's tp heads:
JAX's ``shard_map`` leaves the head axis unsharded and GSPMD gathers the
heads over tp, but each head's attention reads only its own q, k and v, so
running the rank's heads gives the same values for those heads.
"""

from __future__ import annotations

import math

import torch

from dlbb_tpu_torch.parallel.ring import Ring, ring_shift

_NEG_INF = -1e30  # finite mask value: avoids exp(-inf + inf) = nan in the
# online-softmax rescale when a block is fully masked


def _ring_body(q, k0, v0, ring: Ring, causal: bool):
    """q: this rank's block ``[B, n, Sl, d]``; k0, v0: ``[B, kv_heads, Sl,
    d]``, kv_heads dividing n (query-head groups share K/V heads by
    broadcasting)."""
    b, n, sl, d = q.shape
    kvh = k0.shape[1]
    g = n // kvh
    scale = 1.0 / math.sqrt(d)
    p, my_block = ring.size, ring.rank

    # grouped view [B, kvh, g, Sl, d]; g == 1 is plain MHA
    q32 = q.float().reshape(b, kvh, g, sl, d)
    pos_q = my_block * sl + torch.arange(sl, device=q.device)

    def attend(j, k_cur, v_cur, m, l, acc):
        src = (my_block - j) % p  # origin rank of the K/V in hand
        logits = torch.einsum("bhgqd,bhkd->bhgqk", q32, k_cur.float()) * scale
        if causal:
            pos_k = src * sl + torch.arange(sl, device=q.device)
            mask = pos_k[None, :] <= pos_q[:, None]  # [Sl_q, Sl_k]
            logits = logits.masked_fill(~mask, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        probs = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + probs.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", probs, v_cur.float())
        return m_new, l_new, acc_new

    m = torch.full(q32.shape[:-1], _NEG_INF, device=q.device)
    l = torch.zeros(q32.shape[:-1], device=q.device)
    acc = torch.zeros_like(q32)
    k_cur, v_cur = k0, v0
    for j in range(p - 1):
        m, l, acc = attend(j, k_cur, v_cur, m, l, acc)
        k_cur, v_cur = ring_shift((k_cur, v_cur), ring)
    m, l, acc = attend(p - 1, k_cur, v_cur, m, l, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, n, sl, d).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   sp_axis: str = "sp", causal: bool = True) -> torch.Tensor:
    """Exact attention with the sequence sharded over the mesh's ``sp_axis``.

    q: this rank's ``[B, num_heads, S/P, head_dim]`` (its contiguous block
    of the sequence); k, v: the same, or grouped-query ``[B, kv_heads, S/P,
    head_dim]`` with ``num_heads % kv_heads == 0``.  Returns this rank's
    block of the output.  The batch may be sharded over dp as well: the
    rows are the rank's own."""
    if sp_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh {tuple(mesh.axis_names)} has no {sp_axis!r} axis for ring attention"
        )
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"num_heads {q.shape[1]} not divisible by kv_heads {k.shape[1]}"
        )
    return _ring_body(q, k, v, Ring(mesh.axis_groups[sp_axis]), causal)
