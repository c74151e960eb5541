"""Dense attention (counterpart of ``dlbb_tpu/models/attention.py``).

fp32 scores, softmax and PV, cast back to the input dtype at the end; causal
masking by ``tril``; grouped-query K/V shared by broadcasting, never
repeated in memory.
"""

from __future__ import annotations

import math

import torch


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: ``[B, num_heads, S, head_dim]`` -> same shape.

    k, v: ``[B, num_heads, S, head_dim]`` or grouped ``[B, kv_heads, S,
    head_dim]`` with ``num_heads % kv_heads == 0``.
    """
    b, n, s, d = q.shape
    kvh = k.shape[1]
    g = n // kvh
    # [B, kvh, g, S, D] against [B, kvh, 1, S, D]: the group axis broadcasts
    q32 = q.float().reshape(b, kvh, g, s, d)
    k32 = k.float().unsqueeze(2)
    v32 = v.float().unsqueeze(2)
    logits = torch.matmul(q32, k32.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs, v32).reshape(b, n, s, d)
    return out.to(q.dtype)
