"""Overlapped collective matmul: ring-decomposed tensor-parallel projections
(counterpart of ``dlbb_tpu/parallel/collective_matmul.py``).

The Megatron layout (``models/sharding.py``) ends each row-parallel product
in an all-reduce that sits between the product before it and the one after.
Following Wang et al. (ASPLOS 2023) and the collective-matmul schedules of
Pope et al. (2022), each tensor-parallel projection becomes per-shard
partial products interleaved with a ring of neighbour hops: the column
product is an all-gather-matmul and the row product a matmul-reduce-scatter
(AG + RS moves the bytes of one all-reduce).  Between blocks the residual
stream is sequence-sharded over tp (over (sp, tp) with an sp axis), which
gives each ring step an independent chunk to compute on.

Schedules, as in JAX: ``ring``, p - 1 forward hops of a whole chunk;
``bidir``, both directions at once: the all-gather takes ceil((p-1)/2)
forward and floor((p-1)/2) backward hops (two chunks arrive per step), and
the reduce-scatter sends the front half of the output features clockwise
and the back half counter-clockwise.

The hop is ``parallel/ring.py``'s ``batch_isend_irecv`` over the mesh's tp
group.  XLA's scheduler overlaps JAX's ``ppermute`` with the matmul; in
eager torch the order of issue does it: each body posts hop j+1 before the
product on the chunk in hand and waits for it after.  (On a gloo group a
CUDA tensor's hop is staged through host memory, ``ring.hop_transport``,
and overlaps nothing.)  A one-rank ring makes no hop and no call: the
product is ``x @ w``.

Gradients: ``AllGatherMatmul`` and ``MatmulReduceScatter`` are the custom
VJPs of JAX as autograd Functions.  dx is the mirrored ring (a
matmul-reduce-scatter of dy against w^T, and an all-gather-matmul of dy
against w^T); dw is its own ring over the saved x, or over dy.  JAX psums
dw over the batch-carrying axes (dp, sp) inside the ring body, because its
parameters are replicated over them.  Here dw stays this rank's, from its
own rows: ``train/loop.py`` sums every gradient over sp, and
``train/zero.py::Zero`` reduces it over dp, each exactly once.  The
parameters that every tp rank applies to its own sequence chunk (the
LayerNorms and the row-parallel biases) get partial gradients, which
``train/loop.py`` sums over tp.

Inputs are this rank's tensors: ``x`` its sequence chunk ``[B, S/(sp tp),
H]`` (``seq_chunk`` cuts it from the rank's sp slice; ``activation_spec``
names it in the global sequence) and ``w`` its column or row shard
(``weight_shard``).
"""

from __future__ import annotations

import torch

from dlbb_tpu_torch.parallel.ring import BACKWARD, FORWARD, Ring

SCHEDULES = ("ring", "bidir")


def _check_schedule(schedule: str) -> bool:
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown tp_overlap schedule {schedule!r}; known: {SCHEDULES}"
        )
    return schedule == "bidir"


# ---------------------------------------------------------------------------
# ring bodies (this rank's blocks)
# ---------------------------------------------------------------------------


def _ring_visit(travelling: torch.Tensor, ring: Ring, bidir: bool, visit) -> None:
    """Circulate ``travelling`` (this rank's chunk of a ring-sharded array)
    and call ``visit(chunk, src)`` once per source rank, own chunk first.
    Each hop is posted before the visit of the chunk in hand and waited for
    after it.

    Unidirectional: p-1 forward hops.  Bidirectional: chunks arrive from
    both neighbours each step, ceil((p-1)/2) hops."""
    p, r = ring.size, ring.rank
    n_fwd = p // 2 if bidir else p - 1
    n_bwd = (p - 1) // 2 if bidir else 0
    cur = {FORWARD: travelling, BACKWARD: travelling}

    def post(j):
        sends = [(cur[d], d) for d, n in ((FORWARD, n_fwd), (BACKWARD, n_bwd)) if j <= n]
        return ring.start(sends) if sends else None

    hop = post(1)
    visit(travelling, r)
    for j in range(1, max(n_fwd, n_bwd) + 1):
        got = iter(hop.wait())
        if j <= n_fwd:
            cur[FORWARD] = next(got)   # holds block (r - j)
        if j <= n_bwd:
            cur[BACKWARD] = next(got)  # holds block (r + j)
        hop = post(j + 1)
        if j <= n_fwd:
            visit(cur[FORWARD], (r - j) % p)
        if j <= n_bwd:
            visit(cur[BACKWARD], (r + j) % p)


def _ag_matmul_body(x, w, ring: Ring, bidir: bool):
    """All-gather-matmul: x [b, s, h] (this rank's sequence chunk), w [h, f]
    (its column shard) -> [b, p*s, f] (the gathered sequence, its
    columns).  Row block ``src`` of the output is ``x_src @ w``."""
    if ring.size == 1:
        return x @ w
    b, s, _ = x.shape
    out = x.new_empty((b, ring.size * s, w.shape[1]))

    def visit(chunk, src):
        out[:, src * s:(src + 1) * s] = chunk @ w

    _ring_visit(x, ring, bidir, visit)
    return out


def _matmul_rs_body(x, w, ring: Ring, bidir: bool):
    """Matmul-reduce-scatter: x [b, s, f] (the gathered sequence, this
    rank's feature shard), w [f, h] (its row shard) -> [b, s/p, h] (its
    sequence chunk of the cross-shard sum).

    The accumulator travels the ring: at each step a rank adds its own
    partial product for the chunk the accumulator is bound for, computed
    while the accumulator is on its way."""
    p, r = ring.size, ring.rank
    s = x.shape[1]
    if s % p != 0:
        raise ValueError(
            f"matmul_reducescatter: local sequence {s} not divisible by "
            f"ring size {p}"
        )
    if p == 1:
        return x @ w
    s_out = s // p

    def partial(c, w_shard):
        return x[:, c * s_out:(c + 1) * s_out] @ w_shard

    if not bidir:
        # the accumulator on this rank at add-step j is bound for chunk
        # (r + p - 1 - j) mod p; after the last add it is chunk r
        acc = partial((r + p - 1) % p, w)
        for j in range(1, p):
            hop = ring.start([(acc, FORWARD)])
            part = partial((r + p - 1 - j) % p, w)
            (acc,) = hop.wait()
            acc = acc + part
        return acc
    # front half of the output features reduces clockwise, back half
    # counter-clockwise: half-sized messages both ways every step
    hh = w.shape[1] // 2
    w_f, w_b = w[:, :hh], w[:, hh:]
    acc_f = partial((r + p - 1) % p, w_f)
    acc_b = partial((r + 1) % p, w_b)
    for j in range(1, p):
        hop = ring.start([(acc_f, FORWARD), (acc_b, BACKWARD)])
        part_f = partial((r + p - 1 - j) % p, w_f)
        part_b = partial((r + 1 + j) % p, w_b)
        acc_f, acc_b = hop.wait()
        acc_f, acc_b = acc_f + part_f, acc_b + part_b
    return torch.cat([acc_f, acc_b], dim=-1)


def _ag_grad_w_body(x, dy, ring: Ring, bidir: bool):
    """Weight gradient of the all-gather-matmul from this rank's rows: dw
    [h, f] = the sum over the gathered sequence of x_src^T @ dy[src rows];
    the saved x chunks travel the same ring."""
    s = x.shape[1]
    dw = None

    def visit(chunk, src):
        nonlocal dw
        term = torch.einsum("bsh,bsf->hf", chunk, dy[:, src * s:(src + 1) * s])
        dw = term if dw is None else dw + term

    _ring_visit(x, ring, bidir, visit)
    return dw


def _rs_grad_w_body(x, dy, ring: Ring, bidir: bool):
    """Weight gradient of the matmul-reduce-scatter from this rank's rows:
    dw [f, h] = x^T @ AG(dy) over the sequence; the dy chunks travel the
    ring while the x rows they pair with are contracted."""
    s_out = dy.shape[1]
    dw = None

    def visit(dy_chunk, src):
        nonlocal dw
        term = torch.einsum("bsf,bsh->fh", x[:, src * s_out:(src + 1) * s_out], dy_chunk)
        dw = term if dw is None else dw + term

    _ring_visit(dy, ring, bidir, visit)
    return dw


# ---------------------------------------------------------------------------
# the differentiable products
# ---------------------------------------------------------------------------


class AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ring, bidir):
        ctx.save_for_backward(x, w)
        ctx.ring, ctx.bidir = ring, bidir
        return _ag_matmul_body(x, w, ring, bidir)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        # the cotangent of an all-gather-matmul is a matmul-reduce-scatter
        # of dy against w^T, over the same ring
        dx = _matmul_rs_body(dy, w.t(), ctx.ring, ctx.bidir)
        dw = _ag_grad_w_body(x, dy, ctx.ring, ctx.bidir)
        return dx, dw, None, None


class MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ring, bidir):
        ctx.save_for_backward(x, w)
        ctx.ring, ctx.bidir = ring, bidir
        return _matmul_rs_body(x, w, ring, bidir)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        # mirror image: an all-gather-matmul of dy against w^T
        dx = _ag_matmul_body(dy, w.t(), ctx.ring, ctx.bidir)
        dw = _rs_grad_w_body(x, dy, ctx.ring, ctx.bidir)
        return dx, dw, None, None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _tp_size(mesh, tp_axis: str) -> int:
    if tp_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh {tuple(mesh.axis_names)} has no {tp_axis!r} axis for "
            "overlapped collective matmul"
        )
    return mesh.shape[tp_axis]


def _seq_error(seq: int, mesh, p: int) -> ValueError:
    sp = mesh.shape.get("sp", 1)
    return ValueError(
        f"sequence length {seq} not divisible by the "
        f"sequence-shard count {p * sp} "
        f"(tp={p}{f' x sp={sp}' if sp > 1 else ''}); "
        "tp_overlap needs evenly divisible sequence chunks"
    )


def _validate(x, w, mesh, tp_axis: str, col_parallel: bool) -> None:
    p = _tp_size(mesh, tp_axis)
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(
            f"collective matmul expects x [B, S, features] and w 2D; got "
            f"x {tuple(x.shape)}, w {tuple(w.shape)}"
        )
    if not col_parallel and x.shape[1] % p != 0:
        # x holds the rank's sp slice of the sequence, gathered over tp
        raise _seq_error(x.shape[1] * mesh.shape.get("sp", 1), mesh, p)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh, tp_axis: str = "tp",
                     schedule: str = "ring") -> torch.Tensor:
    """Column-parallel projection with the activation all-gather hidden
    behind per-shard partial products.

    x: this rank's sequence chunk ``[B, S/(sp tp), H]``; w: its column
    shard ``[H, F/tp]``.  Returns ``[B, S/sp, F/tp]``: the sequence
    gathered over tp (still this rank's sp slice), this rank's features.
    Differentiable (module docstring)."""
    bidir = _check_schedule(schedule)
    _validate(x, w, mesh, tp_axis, col_parallel=True)
    return AllGatherMatmul.apply(x, w, Ring(mesh.axis_groups[tp_axis]), bidir)


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, mesh, tp_axis: str = "tp",
                         schedule: str = "ring") -> torch.Tensor:
    """Row-parallel projection with the partial-sum reduce-scatter hidden
    behind per-shard partial products.

    x: ``[B, S/sp, F/tp]`` (this rank's features); w: its row shard
    ``[F/tp, H]``.  Returns this rank's sequence chunk ``[B, S/(sp tp), H]``
    of the sum over tp, the residual-stream layout of the overlapped
    block."""
    bidir = _check_schedule(schedule)
    _validate(x, w, mesh, tp_axis, col_parallel=False)
    return MatmulReduceScatter.apply(x, w, Ring(mesh.axis_groups[tp_axis]), bidir)


def activation_spec(mesh, tp_axis: str = "tp") -> tuple[int, int]:
    """``(index, count)``: this rank's slice of the overlapped residual
    stream's sequence, which is cut into ``count = sp * tp`` chunks in
    (sp, tp) order, batch over dp (JAX's ``P(dp, (sp, tp), None)``)."""
    p = _tp_size(mesh, tp_axis)
    c = mesh.coords
    sp = mesh.shape.get("sp", 1)
    return c.get("sp", 0) * p + c[tp_axis], sp * p


def seq_chunk(x: torch.Tensor, mesh, tp_axis: str = "tp") -> torch.Tensor:
    """This rank's chunk of the overlapped residual stream from ``x``, its
    rows and its sp slice of the sequence ``[B, S/sp, H]``: the tp-th of tp
    equal parts of that slice."""
    p = _tp_size(mesh, tp_axis)
    if x.shape[1] % p != 0:
        raise _seq_error(x.shape[1] * mesh.shape.get("sp", 1), mesh, p)
    n = x.shape[1] // p
    return x.narrow(1, mesh.coords[tp_axis] * n, n)


def weight_shard(w: torch.Tensor, mesh, col_parallel: bool,
                 tp_axis: str = "tp") -> torch.Tensor:
    """This rank's tp shard of a full projection weight: its columns
    (``P(None, tp)``) or its rows (``P(tp, None)``)."""
    p = _tp_size(mesh, tp_axis)
    dim = 1 if col_parallel else 0
    if w.shape[dim] % p != 0:
        raise ValueError(f"weight dim {w.shape[dim]} not divisible by tp={p}")
    n = w.shape[dim] // p
    return w.narrow(dim, mesh.coords[tp_axis] * n, n)
