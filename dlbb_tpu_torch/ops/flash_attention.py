"""Flash attention forward (counterpart of ``dlbb_tpu/ops/flash_attention.py``).

``flash_attention_fwd(q, k, v)`` returns ``(o, lse)`` for ``q: [B, N, S, D]``
and full or grouped ``k, v: [B, kvh, Sk, D]``.  Two implementations of one
function sit here:

- the kernel, ``csrc/flash_fwd.cu``: the hand-written CUDA C++ port of the
  Pallas ``_fwd_kernel``, launched for CUDA tensors (bf16, head_dim in
  ``KERNEL_HEAD_DIMS``, contiguous) and counted in ``flash_fwd_launches``;
- ``flash_fwd_reference``: the plain PyTorch computation of the same
  ``(o, lse)``, taken for CPU tensors only.  A CUDA tensor launches the
  kernel or raises; nothing falls back.

Conventions shared with the JAX kernel (``_masked_scores``,
``_block_visible``, ``_fwd_kernel`` there):

- the causal diagonal is anchored at the end of the key axis: with
  ``offset = sk - s``, key ``c`` is visible to query row ``r`` iff
  ``c <= r + offset`` (KV-cache decode has ``sk > s``);
- masked scores are ``NEG_INF = -1e30``, not ``-inf``;
- scores, softmax statistics and the PV sum are fp32; P is rounded to V's
  dtype before the PV product;
- ``lse = m + log(l)`` per query row; a row that sees no key at all gives
  ``o = 0`` and ``lse = NEG_INF``.  The JAX kernel gives that only where its
  block skip covers the row; where such a row shares a visible Q block with
  rows that do see keys, its masked entries there get ``p = exp(0) = 1`` and
  ``o`` becomes the mean of V.  Here a masked entry always gets ``p = 0``,
  so the result does not depend on tiling.

``lse`` is dense ``[B, N, S]`` fp32, not the TPU's 128-lane replicated
``[B*N, S, 128]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)

# kernel launches since the process started (or the caller last reset it)
flash_fwd_launches = 0


def kernel_accepts(q_shape, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernel takes ``q`` of this shape and dtype."""
    return dtype == torch.bfloat16 and q_shape[-1] in KERNEL_HEAD_DIMS


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q [B, N, S, D] and k, v [B, kvh, Sk, D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if n % k.shape[1] != 0:
        raise ValueError(f"num_heads {n} not divisible by kv_heads {k.shape[1]}")


def flash_fwd_reference(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None):
    """Plain PyTorch ``(o, lse)``: the kernel's function computed in one
    pass over all of Sk (the running max is the row max)."""
    _check_shapes(q, k, v)
    b, n, s, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = n // kvh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q32 = q.float().reshape(b, kvh, g, s, d)
    k32 = k.float().unsqueeze(2)
    scores = torch.matmul(q32, k32.transpose(-1, -2)) * sm_scale
    if causal:
        rows = torch.arange(s, device=q.device).unsqueeze(1)
        cols = torch.arange(sk, device=q.device).unsqueeze(0)
        visible = cols <= rows + (sk - s)
        scores = scores.masked_fill(~visible, NEG_INF)
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m).masked_fill(~visible, 0.0)
    else:
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    # P rounded to V's dtype before PV, as the TPU kernel feeds its MXU
    pv = torch.matmul(p.to(v.dtype).float(), v.float().unsqueeze(2))
    o = (pv / l_safe).to(q.dtype).reshape(b, n, s, d)
    lse = (m + torch.log(l_safe)).reshape(b, n, s)
    return o, lse


def _flash_fwd_cuda(q, k, v, *, causal: bool, sm_scale: float):
    global flash_fwd_launches
    from dlbb_tpu_torch.ops._build import library

    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernel takes bfloat16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the flash kernel takes contiguous tensors ({name})")
    b, n, s, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {d}")
    o = torch.empty_like(q)
    lse = torch.empty((b, n, s), dtype=torch.float32, device=q.device)
    fn = library("flash_fwd").dlbb_flash_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b * n, s, b * kvh, sk, d, float(sm_scale),
                 int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_fwd_launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None):
    """``(o [B, N, S, D], lse [B, N, S] fp32)``; the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_shapes(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _flash_fwd_cuda(q, k, v, causal=causal, sm_scale=sm_scale)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Blocked attention, ``q: [B, num_heads, S, head_dim] -> same``."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)[0]
