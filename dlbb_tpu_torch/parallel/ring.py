"""The ring hop of the sequence-sharded layouts: one exchange with both
neighbours on a process group's ring (counterpart of the ``lax.ppermute``
hops of ``dlbb_tpu/parallel/collective_matmul.py`` and
``dlbb_tpu/parallel/ring_attention.py``).

``Ring(group)`` is this rank's place on the ring of ``group``: its index,
the size, and the global ranks of its neighbours.  ``Ring.start`` posts
one hop of several tensors, each forward (to rank r+1, from r-1) or
backward (to r-1, from r+1), as one ``batch_isend_irecv``, and returns a
``Hop`` whose ``wait`` gives the received tensors: the collective matmul
posts hop j+1 before the product on the chunk in hand and waits after it.
``ring_shift`` is the same hop as an autograd Function whose backward
shifts the gradient the other way, which is what ``lax.ppermute``
transposes to; ring attention's K/V blocks travel by it.  A ring of one
rank never hops.

Two tensors of one hop may go to the same peer (forward and backward at
two ranks): each op carries its own tag, and every rank posts the ops in
the same order, which is how NCCL, which ignores tags, matches them.

Transport.  gloo's point-to-point ops read and write the tensor's memory
from the host, so a CUDA tensor gives "Bad address" or aborts the process
(``scripts/torch_gloo_p2p_probe.py``, torch 2.11); its collectives,
``all_to_all_single`` included, take CUDA tensors.  So on a gloo group a
CUDA tensor's hop goes through host memory: sent from a host copy and
received into a host buffer that ``wait`` copies to the device.  The
choice is the group's backend's (``hop_transport``), never a caught
error; NCCL hops move device memory directly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

FORWARD, BACKWARD = 1, -1


def _ring_perms(p: int):
    """(forward, backward) ring permutations, as (source, destination)
    pairs: forward sends i -> i+1 (each rank receives from its left
    neighbour), backward the reverse."""
    fwd = [(i, (i + 1) % p) for i in range(p)]
    bwd = [(i, (i - 1) % p) for i in range(p)]
    return fwd, bwd


def hop_transport(group, device: torch.device) -> str:
    """``"host"`` where a hop of a tensor on ``device`` over ``group`` is
    staged through host memory (gloo and a CUDA tensor), ``"device"``
    where it moves the tensor itself."""
    return ("host" if device.type == "cuda" and dist.get_backend(group) == "gloo"
            else "device")


class Hop:
    """A posted hop: ``wait()`` returns the received tensors, in the order
    of the sends that ``Ring.start`` was given."""

    def __init__(self, works, received, device: Optional[torch.device]):
        self._works = works
        self._received = received
        self._device = device

    def wait(self) -> list[torch.Tensor]:
        for work in self._works:
            work.wait()
        if self._device is None:
            return self._received
        return [t.to(self._device) for t in self._received]


class Ring:
    """This rank's place on the ring of ``group`` (module docstring)."""

    def __init__(self, group) -> None:
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        fwd, bwd = _ring_perms(self.size)
        self._peer = {FORWARD: dist.get_global_rank(group, fwd[self.rank][1]),
                      BACKWARD: dist.get_global_rank(group, bwd[self.rank][1])}

    def start(self, sends: Sequence[tuple[torch.Tensor, int]]) -> Hop:
        """Post one hop: each ``(tensor, direction)`` goes to the neighbour
        on that side (``FORWARD``: rank r+1), and a tensor of its shape
        comes from the neighbour on the other side."""
        device = sends[0][0].device
        staged = hop_transport(self.group, device) == "host"
        ops, received = [], []
        for tag, (t, direction) in enumerate(sends):
            t = t.contiguous()
            if staged:
                # comm-lint: disable=host-transfer-in-loop  gloo's transport stages each tensor of the hop through host memory (module docstring)
                t = t.cpu()
            buf = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, self._peer[direction], self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, self._peer[-direction], self.group, tag))
            received.append(buf)
        return Hop(dist.batch_isend_irecv(ops), received, device if staged else None)

    def shift(self, tensors: Sequence[torch.Tensor], direction: int) -> list[torch.Tensor]:
        """Every tensor one hop in ``direction``, waited for."""
        return self.start([(t, direction) for t in tensors]).wait()


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, direction, *tensors):
        ctx.ring, ctx.direction = ring, direction
        return tuple(ring.shift(tensors, direction))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.ring.shift(grads, -ctx.direction))


def ring_shift(tensors: Sequence[torch.Tensor], ring: Ring,
               direction: int = FORWARD) -> tuple[torch.Tensor, ...]:
    """The tensors one hop around ``ring``, differentiably: the gradient of
    each received tensor goes one hop back to its sender."""
    if ring.size == 1:
        return tuple(tensors)
    return _Shift.apply(ring, direction, *tensors)
