"""Compressed collectives: quantised gradient reduction on the wire
(counterpart of ``dlbb_tpu/comm/compression.py``, under its names).

Wire format.  Chunked symmetric quantisation: the flat payload is cut into
``SCALE_CHUNK_ELEMS``-element chunks (zero-padded to a whole chunk), each
with one fp32 scale ``amax(chunk) / qmax`` (qmax 127 for int8, 448 for fp8
e4m3) and its values quantised to the wire dtype.  The scales are the side
channel: they travel beside every quantised hop and count in the wire
bytes (``op_wire_bytes`` in ``analysis/expectations.py``, which holds the
wire model's constants).  fp8 travels bit-cast to ``torch.int8`` (``_to_wire``),
as JAX's does: gloo has no fp8 type, and a wire widened on the way would
double the bytes moved.

Reductions.  ``psum_compressed`` is JAX's ring, on a process group in place
of an axis name: quantise, a ring reduce-scatter in the wire dtype (each
hop dequantises the incoming partial into the accumulation dtype, adds the
local chunk and re-quantises for the next hop), an all-gather of the
quantised reduced chunks and their scales, dequantise.
``reduce_scatter_compressed`` is the ring without the gather.  The order is
JAX's (``dlbb_tpu/comm/compression.py:150-222``): rank r sends to r+1,
starts from its chunk (r-1) % p and adds chunk (r-1-s) % p at step s, so
that the chunk which ends on rank r is chunk r.  Every hop rounds, so the
result depends on that order.  Each hop goes through
``parallel/ring.py``'s ``Ring``: on a gloo group a CUDA tensor is staged
through host memory (``hop_transport``).

Error feedback.  The residual that training carries (``train/loop.py``) is
the local quantiser's error ``c - D(Q(c))`` (``quantization_error``); the
re-quantisation error inside the ring is not fed back, as in JAX.

``count_wire_bytes`` counts, around the calls, the bytes this rank hands to
``torch.distributed``: the tensors it sends in a hop, and (p - 1) times the
input of an all-gather over p ranks, which is what a ring all-gather moves
per rank and what JAX's wire model counts.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist

from dlbb_tpu_torch.analysis.expectations import COMPRESSIONS, SCALE_CHUNK_ELEMS
from dlbb_tpu_torch.parallel.ring import FORWARD, Ring

# symmetric ranges: int8 without the asymmetric -128, fp8 e4m3's finite max
_QMAX = {"int8": 127.0, "fp8": 448.0}

ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _wire_dtype(compression: str) -> torch.dtype:
    if compression == "int8":
        return torch.int8
    if compression == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown compression {compression!r}; known: {COMPRESSIONS}")


def check_compression(compression: str) -> str:
    """Validate (and return) a compression name: an unknown name fails with
    the known set."""
    _wire_dtype(compression)
    return compression


def accum_dtype_of(accum_dtype) -> torch.dtype:
    """A ring accumulation dtype from its name or itself."""
    if isinstance(accum_dtype, torch.dtype):
        return accum_dtype
    try:
        return ACCUM_DTYPES[accum_dtype]
    except KeyError:
        raise ValueError(f"unknown accumulation dtype {accum_dtype!r}; known: "
                         f"{tuple(ACCUM_DTYPES)}") from None


def quantize_chunked(x: torch.Tensor, compression: str = "int8"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked symmetric quantisation of the last axis: ``(q, scales)``,
    ``q`` ``[..., n_chunks, SCALE_CHUNK_ELEMS]`` in the wire dtype (the
    padding zero), ``scales`` ``[..., n_chunks]`` fp32, computed on the
    tensor's device."""
    dtype = _wire_dtype(compression)
    qmax = _QMAX[compression]
    n = x.shape[-1]
    pad = (-n) % SCALE_CHUNK_ELEMS
    xf = x.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    chunks = xf.reshape(xf.shape[:-1] + (-1, SCALE_CHUNK_ELEMS))
    amax = chunks.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which rounds some scales otherwise than the CPU and JAX
    scale = torch.where(amax > 0.0, amax / amax.new_tensor(qmax), torch.ones_like(amax))
    q = chunks / scale
    if compression == "int8":
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(dtype), scale.squeeze(-1)


def dequantize_chunked(q: torch.Tensor, scales: torch.Tensor, num_elements: int,
                       out_dtype=torch.float32) -> torch.Tensor:
    """The inverse of ``quantize_chunked``: ``[..., n_chunks, C]`` and
    ``[..., n_chunks]`` to ``[..., num_elements]`` (padding dropped) in
    ``out_dtype``."""
    x = q.float() * scales[..., None]
    x = x.reshape(x.shape[:-2] + (-1,))[..., :num_elements]
    return x.to(out_dtype)


def _to_wire(q: torch.Tensor, compression: str) -> torch.Tensor:
    """The quantised payload as ``torch.int8`` bytes: fp8 bit-cast, int8 as
    it is."""
    return q.view(torch.int8) if compression == "fp8" else q


def _from_wire(w: torch.Tensor, compression: str) -> torch.Tensor:
    return w.view(torch.float8_e4m3fn) if compression == "fp8" else w


def quantization_error(x: torch.Tensor, compression: str = "int8",
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x - D(Q(x))``, the local quantiser's error: the error-feedback
    residual, in ``x``'s dtype, or rounded once from fp32 into ``out`` (and
    ``out`` returned) where it is given."""
    q, s = quantize_chunked(x, compression)
    deq = dequantize_chunked(q, s, x.shape[-1], torch.float32)
    if out is not None:
        return torch.sub(x.float(), deq, out=out)
    return (x.float() - deq).to(x.dtype)


def _ring_reduce(local_chunk: Callable[[int], torch.Tensor], ring: Ring, p: int,
                 compression: str, accum_dtype: torch.dtype) -> torch.Tensor:
    """The quantised accumulating ring: ``local_chunk(s)`` is this rank's
    part of the travelling accumulator at step s.  Each hop sends the
    quantised partial and its scales to rank r+1, as two messages."""
    part = local_chunk(0).to(accum_dtype)
    for s in range(1, p):
        q, scales = quantize_chunked(part, compression)
        wire, scales = ring.start([(_to_wire(q, compression), FORWARD),
                                   (scales, FORWARD)]).wait()
        incoming = dequantize_chunked(_from_wire(wire, compression), scales,
                                      part.shape[-1], accum_dtype)
        part = incoming + local_chunk(s).to(accum_dtype)
    return part


def _all_gather(t: torch.Tensor, group, p: int) -> torch.Tensor:
    """``[p, *t.shape]``: every rank's ``t``, by rank of ``group``."""
    out = torch.empty((p,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out.view((-1,) + tuple(t.shape[1:])), t.contiguous(),
                                group=group)
    return out


def psum_compressed(x: torch.Tensor, group, compression: str = "int8",
                    accum_dtype=torch.float32) -> torch.Tensor:
    """Quantised all-reduce over ``group``: the ring reduce-scatter in the
    wire dtype, then an all-gather of the quantised reduced chunks.  The
    result has ``x``'s shape and dtype; the sums run in ``accum_dtype``.  A
    group of one rank returns ``x`` as it is, as JAX does."""
    check_compression(compression)
    accum_dtype = accum_dtype_of(accum_dtype)
    p = dist.get_world_size(group)
    if p == 1:
        return x
    flat = x.reshape(-1)
    n = flat.shape[0]
    c = -(-n // p)  # ring-chunk elements
    if p * c != n:
        flat = torch.nn.functional.pad(flat, (0, p * c - n))
    chunks = flat.reshape(p, c)
    ring = Ring(group)
    r = ring.rank
    part = _ring_reduce(lambda s: chunks[(r - 1 - s) % p], ring, p, compression,
                        accum_dtype)
    q, scales = quantize_chunked(part, compression)
    gq = _from_wire(_all_gather(_to_wire(q, compression), group, p), compression)
    gs = _all_gather(scales, group, p)
    rows = dequantize_chunked(gq, gs, c, accum_dtype)  # [P, c]
    return rows.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def reduce_scatter_compressed(rows: torch.Tensor, group, compression: str = "int8",
                              accum_dtype=torch.float32) -> torch.Tensor:
    """Quantised reduce-scatter over ``group``: ``rows`` is this rank's
    ``[P, *chunk]`` slab, row k its contribution to rank k (the ``per_peer``
    layout); returns this rank's reduced chunk.  The wire is the ring of
    ``psum_compressed`` alone."""
    check_compression(compression)
    accum_dtype = accum_dtype_of(accum_dtype)
    p = dist.get_world_size(group)
    chunk_shape = rows.shape[1:]
    if rows.shape[0] != p:
        raise ValueError(f"reduce_scatter_compressed: leading dim {rows.shape[0]} must "
                         f"equal the axis size {p}")
    if p == 1:
        return rows[0]
    flat_rows = rows.reshape(p, -1)
    n = flat_rows.shape[-1]
    ring = Ring(group)
    r = ring.rank
    part = _ring_reduce(lambda s: flat_rows[(r - 1 - s) % p], ring, p, compression,
                        accum_dtype)
    return part[:n].reshape(chunk_shape).to(rows.dtype)


@contextlib.contextmanager
def count_wire_bytes(counter: Optional[dict] = None):
    """Count the bytes this rank hands to ``torch.distributed`` inside the
    block (module docstring) into ``counter["bytes"]``: the tensors sent by
    ``batch_isend_irecv``, and (p - 1) times the input of
    ``all_gather_into_tensor``.  Yields the counter."""
    counter = {"bytes": 0} if counter is None else counter
    counter.setdefault("bytes", 0)
    batch, gather = dist.batch_isend_irecv, dist.all_gather_into_tensor

    def counted_batch(ops):
        counter["bytes"] += sum(op.tensor.nbytes for op in ops if op.op is dist.isend)
        return batch(ops)

    def counted_gather(output, input, group=None, async_op=False):
        counter["bytes"] += (dist.get_world_size(group) - 1) * input.nbytes
        return gather(output, input, group=group, async_op=async_op)

    dist.batch_isend_irecv, dist.all_gather_into_tensor = counted_batch, counted_gather
    try:
        yield counter
    finally:
        dist.batch_isend_irecv, dist.all_gather_into_tensor = batch, gather
