"""Flash attention, forward and backward (counterpart of
``dlbb_tpu/ops/flash_attention.py``).

``flash_attention_fwd(q, k, v)`` returns ``(o, lse)`` for ``q: [B, N, S, D]``
and full or grouped ``k, v: [B, kvh, Sk, D]``;
``flash_attention_bwd(q, k, v, o, lse, do)`` returns ``(dq, dk, dv)``, with
dk and dv summed over the query heads that share a K/V head.
``flash_attention`` is differentiable: a ``torch.autograd.Function`` whose
forward saves ``(q, k, v, o, lse)`` and whose backward is
``flash_attention_bwd`` (the JAX package's ``custom_vjp``).  Two
implementations of each function sit here:

- the kernels: ``csrc/flash_fwd.cu``, the hand-written CUDA C++ port of the
  Pallas ``_fwd_kernel``, and ``csrc/flash_bwd.cu``, the ports of
  ``_dq_kernel`` and ``_dkv_kernel`` (all three wgmma, TMA and
  warp-specialised rings on the building blocks of ``csrc/hopper.cuh``);
  launched for CUDA tensors (bf16, head_dim in ``KERNEL_HEAD_DIMS``,
  contiguous, 16-byte-aligned bases for TMA, ``tma_compatible``) and
  counted in ``flash_fwd_launches``, ``flash_bwd_dq_launches`` and
  ``flash_bwd_dkv_launches``; while an op capture records a call
  (``analysis/op_capture.py``), it sets ``capture_hook`` and each launch
  hands it one node priced at its visible-pair flops (``kernel_flops``);
- ``flash_fwd_reference`` and ``flash_bwd_reference``: the plain PyTorch
  computations of the same results, taken for CPU tensors only.  A CUDA
  tensor launches the kernels or raises; nothing falls back.

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
``[B*N, S, 128]``.  The backward recomputes ``p = exp(s - lse)``, 0 on masked
entries and on rows with ``lse <= NEG_INF / 2`` (``_p_from_lse`` there), so a
row that sees no key gets exactly zero dq and adds nothing to dk/dv.
``delta = rowsum(dO * O)`` in fp32 stays one PyTorch expression
(``flash_bwd_delta``), as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
# query rows and keys per tile of the forward kernel (csrc/flash_fwd.cu)
FWD_BLOCK_M = 128
FWD_BLOCK_N = 128

# kernel launches since the process started (or the caller last reset them)
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
# set by an op capture for the call it records: called once per launch with
# (op, reads, writes, flops, args); None otherwise
capture_hook = None


def visible_pairs(s: int, sk: int, causal: bool) -> int:
    """The (query row, key) pairs one head sees: ``s * sk``, or under the
    causal mask anchored at ``offset = sk - s`` the keys ``c <= r + offset``
    of each row ``r``: the last ``m = min(s, sk)`` rows see ``sk - m + 1``
    to ``sk`` keys and any earlier row none."""
    if not causal:
        return s * sk
    m = min(s, sk)
    return m * (2 * sk - m + 1) // 2


def kernel_flops(kernel: str, b: int, n: int, s: int, sk: int, d: int,
                 causal: bool) -> int:
    """The flops of one launch over the visible pairs: 4 D for the forward
    (QK^T, PV), 6 D for dq (QK^T, dO V^T, dS K), 8 D for dk/dv (QK^T, dO V^T,
    P^T dO, dS^T Q) per pair and head."""
    per_pair = {"fwd": 4, "dq": 6, "dkv": 8}[kernel] * d
    return per_pair * visible_pairs(s, sk, causal) * b * n


def kernel_accepts(q_shape, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernel takes ``q`` of this shape and dtype."""
    return dtype == torch.bfloat16 and q_shape[-1] in KERNEL_HEAD_DIMS


def fwd_tile_plan(s: int, sk: int, block_m: int = FWD_BLOCK_M,
                  block_n: int = FWD_BLOCK_N, causal: bool = True):
    """The forward kernel's tile rule, for each tile of ``block_m`` query
    rows: ``(visited, masked)``, the K tiles of ``block_n`` keys it visits
    (from the last down, as the kernel does) and those of them that take the
    per-element mask.  A tile no row of the Q tile sees is not visited (the
    JAX kernel's ``_block_visible``); a tile is left unmasked only where every
    row of the Q tile sees every one of its keys, so only the tiles that cross
    the causal diagonal (key ``c`` visible to row ``r`` iff
    ``c <= r + sk - s``) or the end of the key axis are masked.
    ``csrc/flash_fwd.cu`` computes the same rule."""
    offset = sk - s
    plan = []
    for q_start in range(0, s, block_m):
        q_last = min(q_start + block_m, s) - 1
        kv_end = min(sk, q_last + offset + 1) if causal else sk
        n_vis = -(-kv_end // block_n) if kv_end > 0 else 0
        n_full = sk // block_n
        if causal:
            n_full = min(n_full, max(0, q_start + offset + 1) // block_n)
        n_full = min(n_full, n_vis)
        visited = list(range(n_vis - 1, -1, -1))
        plan.append((visited, [n for n in visited if n >= n_full]))
    return plan


def tma_compatible(t: torch.Tensor) -> bool:
    """Whether the kernels' TMA can read or write ``t`` in place: a
    contiguous tensor whose base address is a multiple of 16 bytes (its row
    strides, D * 2 bytes, are then multiples of 16 too)."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


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


def flash_bwd_delta(o, do) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, ``[B, N, S]``: the backward's one
    reduction outside the kernels (``_bwd`` computes it in XLA)."""
    return (o.float() * do.float()).sum(-1)


def flash_bwd_reference(q, k, v, o, lse, do, *, causal: bool = True,
                        sm_scale: float | None = None):
    """Plain PyTorch ``(dq, dk, dv)``: the backward kernels' function
    computed in one pass over all of Sk.  It rounds where ``_bwd`` rounds:
    ds to K's dtype before ``ds . K``, p to dO's dtype before ``p^T . dO``,
    ds to Q's dtype before ``ds^T . Q``, all sums in fp32.  GQA is grouped
    (``[B, kvh, g, ...]`` against ``[B, kvh, 1, ...]``), never repeated; dk
    and dv sum over the g query heads of a group."""
    _check_shapes(q, k, v)
    b, n, s, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = n // kvh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q32 = q.float().reshape(b, kvh, g, s, d)
    do32 = do.float().reshape(b, kvh, g, s, d)
    k32 = k.float().unsqueeze(2)
    v32 = v.float().unsqueeze(2)
    lse_r = lse.reshape(b, kvh, g, s, 1)
    scores = torch.matmul(q32, k32.transpose(-1, -2)) * sm_scale
    visible = lse_r > NEG_INF / 2
    if causal:
        rows = torch.arange(s, device=q.device).unsqueeze(1)
        cols = torch.arange(sk, device=q.device).unsqueeze(0)
        visible = visible & (cols <= rows + (sk - s))
    p = torch.where(visible, torch.exp(scores - lse_r), 0.0)
    delta = flash_bwd_delta(o, do).reshape(b, kvh, g, s, 1)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    ds = p * (dp - delta) * sm_scale
    dq = torch.matmul(ds.to(k.dtype).float(), k32).reshape(b, n, s, d)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do32).sum(2)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q32).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(named, *, device) -> None:
    """Device, dtype and layout the CUDA kernels take; raises otherwise."""
    for name, t in named:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        want = torch.float32 if name in ("lse", "delta") else torch.bfloat16
        if t.dtype != want:
            raise ValueError(f"the flash kernels take {want} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the flash kernels take contiguous tensors ({name})")


def _check_head_dim(d: int) -> None:
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in {KERNEL_HEAD_DIMS}, got {d}")


def _launch(lib_name: str, fn_name: str, device, argtypes, *args) -> None:
    from dlbb_tpu_torch.ops._build import library

    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")


def _check_tma(kernel: str, named) -> None:
    for name, t in named:
        if not tma_compatible(t):
            raise ValueError(f"{kernel} loads {name} by TMA, which needs a "
                             "16-byte-aligned contiguous tensor; got storage offset "
                             f"{t.storage_offset()}")


def _flash_fwd_cuda(q, k, v, *, causal: bool, sm_scale: float):
    global flash_fwd_launches
    _check_kernel_inputs((("q", q), ("k", k), ("v", v)), device=q.device)
    b, n, s, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    _check_head_dim(d)
    o = torch.empty_like(q)
    lse = torch.empty((b, n, s), dtype=torch.float32, device=q.device)
    if q.numel() == 0:  # a rank with no rows: no grid to launch
        return o, lse
    _check_tma("the flash forward kernel", (("q", q), ("k", k), ("v", v)))
    _launch("flash_fwd", "dlbb_flash_fwd_bf16", q.device,
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b * n, s, b * kvh, sk, d, float(sm_scale), int(causal))
    flash_fwd_launches += 1
    if capture_hook is not None:
        capture_hook("flash::fwd", {"q": q, "k": k, "v": v}, {"o": o, "lse": lse},
                     kernel_flops("fwd", b, n, s, sk, d, causal), {"sk": sk, "causal": causal})
    return o, lse


def _check_bwd_inputs(q, k, v, lse, do, delta) -> None:
    _check_kernel_inputs((("q", q), ("k", k), ("v", v), ("do", do),
                          ("lse", lse), ("delta", delta)), device=q.device)
    b, n, s, d = q.shape
    if do.shape != q.shape or lse.shape != (b, n, s) or delta.shape != (b, n, s):
        raise ValueError(
            f"expected do like q {tuple(q.shape)} and lse, delta [B, N, S]; got "
            f"{tuple(do.shape)}, {tuple(lse.shape)}, {tuple(delta.shape)}")
    _check_head_dim(d)


def _flash_bwd_cuda(q, k, v, lse, do, delta, *, causal: bool, sm_scale: float,
                    dq: bool = True, dkv: bool = True):
    """``(dq, dk, dv)`` from the ``_dq_kernel`` and ``_dkv_kernel`` ports,
    dk and dv summed over each group; ``delta`` from ``flash_bwd_delta``.
    One C call encodes the tensor maps of q, k, v and dO once and launches
    the kernels asked for (the other outputs are None)."""
    global flash_bwd_dq_launches, flash_bwd_dkv_launches
    _check_bwd_inputs(q, k, v, lse, do, delta)
    b, n, s, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    out_dq = torch.empty_like(q) if dq else None
    dk = torch.empty_like(k) if dkv else None
    dv = torch.empty_like(v) if dkv else None
    if q.numel() == 0:  # a rank with no rows: no grid to launch
        return out_dq, dk, dv
    _check_tma("the flash backward kernels", (("q", q), ("k", k), ("v", v), ("do", do)))
    ptr = [0 if t is None else t.data_ptr() for t in (out_dq, dk, dv)]
    _launch("flash_bwd", "dlbb_flash_bwd_bf16", q.device,
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *ptr, b * n, s, b * kvh, sk, d, float(sm_scale),
            int(causal), int(dq) | 2 * int(dkv))
    flash_bwd_dq_launches += int(dq)
    flash_bwd_dkv_launches += int(dkv)
    if capture_hook is not None:
        reads = {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}
        for kernel, launched, writes in (("dq", dq, {"dq": out_dq}),
                                         ("dkv", dkv, {"dk": dk, "dv": dv})):
            if launched:
                capture_hook(f"flash::bwd_{kernel}", reads, writes,
                             kernel_flops(kernel, b, n, s, sk, d, causal),
                             {"sk": sk, "causal": causal})
    return out_dq, dk, dv


def _flash_bwd_dq_cuda(q, k, v, lse, do, delta, *, causal: bool, sm_scale: float):
    """dq alone, from the ``_dq_kernel`` port."""
    return _flash_bwd_cuda(q, k, v, lse, do, delta, causal=causal, sm_scale=sm_scale,
                           dkv=False)[0]


def _flash_bwd_dkv_cuda(q, k, v, lse, do, delta, *, causal: bool, sm_scale: float):
    """(dk, dv) alone, from the ``_dkv_kernel`` port."""
    return _flash_bwd_cuda(q, k, v, lse, do, delta, causal=causal, sm_scale=sm_scale,
                           dq=False)[1:]


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


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        sm_scale: float | None = None):
    """``(dq, dk, dv)`` from the forward's ``(o, lse)`` and the output
    gradient ``do``; the two kernels for CUDA tensors, the plain version
    for CPU tensors."""
    _check_shapes(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                   sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check_kernel_inputs((("o", o),), device=q.device)
    delta = flash_bwd_delta(o, do)
    return _flash_bwd_cuda(q, k, v, lse, do, delta, causal=causal, sm_scale=sm_scale)


class FlashAttention(torch.autograd.Function):
    """``o = attention(q, k, v)`` with the flash backward as its gradient
    (the counterpart of the JAX package's ``custom_vjp``): the forward saves
    ``(q, k, v, o, lse)``, the backward recomputes p from lse blockwise."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # dO arrives strided from the output transpose in the model
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Blocked attention, ``q: [B, num_heads, S, head_dim] -> same``;
    differentiable through ``FlashAttention``."""
    _check_shapes(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, causal, sm_scale)
