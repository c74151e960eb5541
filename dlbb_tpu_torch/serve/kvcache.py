"""Paged KV-cache: per-rank tensors plus the host block ledger (counterpart
of ``dlbb_tpu/serve/kvcache.py``).

Device side, the cache is a :class:`KVCache` NamedTuple of fixed-shape
tensors:

- ``k``/``v``: ``[L, max_batch, num_blocks, block_size, kv_heads,
  head_dim]`` in the model dtype: every layer, every decode *slot*, the
  slot's block ring, at GQA ``kv_heads`` width (never broadcast to
  ``num_heads``);
- ``lengths``: ``[max_batch]`` int32, the tokens valid per slot.

JAX places the cache on its mesh with ``cache_specs``: the slot dim over
``dp``, the kv-head dim over ``tp``, ``lengths`` replicated.  The port's
shards are explicit per-rank tensors, as ``models/sharding.py``'s are:
:func:`shard_cache` cuts rank ``(dp_rank, tp_rank)``'s part out of a whole
cache, the addressable shard JAX's ``NamedSharding`` gives that device.

:class:`QuantKVCache` is the int8 layout (``serving.kv_quantization=
"int8"``): int8 blocks plus one fp32 scale per (layer, slot, block,
kv-head), the symmetric-amax codec of :func:`quantize_kv_blocks`.  Its
bytes are what ``models/configs.py::kv_cache_bytes(..., "int8")`` prices.

Host side, :class:`BlockLedger` does the alloc/free/append accounting
against a global block budget (admission reserves a request's worst-case
blocks, so a trace never outgrows the cache mid-run; the ledger raising
:class:`CacheOverflow` is an engine bug, not a load condition), and its
:class:`PrefixTrie` content-addresses full prompt blocks for prefix
sharing.  Both are copies of the JAX classes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from dlbb_tpu_torch.models.configs import ModelConfig
from dlbb_tpu_torch.models.transformer import DTYPES
from dlbb_tpu_torch.utils.sysinfo import resolve_device


class KVCache(NamedTuple):
    """The device half of the paged cache (see module docstring)."""

    k: torch.Tensor        # [L, max_batch, num_blocks, block_size, kvh, d]
    v: torch.Tensor        # same
    lengths: torch.Tensor  # [max_batch] int32

    @property
    def max_batch(self) -> int:
        return self.k.shape[1]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[2]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_seq(self) -> int:
        return self.num_blocks * self.block_size


def _plane_shape(config: ModelConfig, max_batch: int, num_blocks: int,
                 block_size: int) -> tuple[int, ...]:
    return (config.num_layers, max_batch, num_blocks, block_size,
            config.kv_heads, config.head_dim)


def create_kv_cache(config: ModelConfig, max_batch: int, num_blocks: int,
                    block_size: int, device=None) -> KVCache:
    """A zero cache on ``device`` (``cuda`` unless the caller names
    another; raises without CUDA), in the model dtype."""
    device = resolve_device(device)
    shape = _plane_shape(config, max_batch, num_blocks, block_size)
    dtype = DTYPES[config.dtype]
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((max_batch,), dtype=torch.int32, device=device),
    )


def gather_cache_slots(cache: KVCache, idx: torch.Tensor) -> KVCache:
    """Repack the slots named by ``idx`` (``[b']`` integer, b' <
    max_batch) into a smaller cache: the device half of slot compaction.
    As in JAX, the slot dim must be unsharded (dp = 1)."""
    return KVCache(
        k=cache.k.index_select(1, idx),
        v=cache.v.index_select(1, idx),
        lengths=cache.lengths.index_select(0, idx),
    )


def scatter_cache_slots(cache: KVCache, small: KVCache,
                        idx: torch.Tensor) -> KVCache:
    """Write a compacted cache's rows back into their big-batch slots (the
    inverse of :func:`gather_cache_slots`; ``idx``'s rows must be
    distinct).  It writes into ``cache``'s tensors and returns ``cache``:
    JAX's serving steps donate the cache, so XLA updates it in place
    too."""
    cache.k.index_copy_(1, idx, small.k)
    cache.v.index_copy_(1, idx, small.v)
    cache.lengths.index_copy_(0, idx, small.lengths)
    return cache


# ---------------------------------------------------------------------------
# int8-quantized cache plane (serving.kv_quantization="int8")
# ---------------------------------------------------------------------------

KV_QMAX = 127.0  # symmetric int8, same codec as comm/compression.py


class QuantKVCache(NamedTuple):
    """The int8 variant of :class:`KVCache`: K/V blocks stored as int8
    with per-block per-kv-head fp32 scales as a side-channel plane, which
    :func:`shard_cache` cuts like the data they scale."""

    k: torch.Tensor        # int8 [L, max_batch, num_blocks, block_size, kvh, d]
    v: torch.Tensor        # same
    k_scale: torch.Tensor  # f32  [L, max_batch, num_blocks, kvh]
    v_scale: torch.Tensor  # same
    lengths: torch.Tensor  # [max_batch] int32

    @property
    def max_batch(self) -> int:
        return self.k.shape[1]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[2]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_seq(self) -> int:
        return self.num_blocks * self.block_size


def create_quant_kv_cache(config: ModelConfig, max_batch: int, num_blocks: int,
                          block_size: int, device=None) -> QuantKVCache:
    """A zero int8 cache on ``device`` (scales start at 1.0, so an untouched
    block dequantises to exact zeros)."""
    device = resolve_device(device)
    shape = _plane_shape(config, max_batch, num_blocks, block_size)
    sc_shape = (config.num_layers, max_batch, num_blocks, config.kv_heads)
    return QuantKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.ones(sc_shape, dtype=torch.float32, device=device),
        v_scale=torch.ones(sc_shape, dtype=torch.float32, device=device),
        lengths=torch.zeros((max_batch,), dtype=torch.int32, device=device),
    )


def quantize_kv_blocks(blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over paged K/V blocks ``[..., block_size, kvh,
    head_dim]`` with one fp32 scale per (block, kv-head): ``scale = amax /
    127``, 1.0 on an all-zero block.  Returns ``(int8 blocks, f32 scales
    [..., kvh])``, bit-equal to JAX's.  The round trip is bit-stable:
    requantising a block dequantised in fp32 reproduces its codes
    (|q·s/s − q| < 2⁻²²·127 ≪ 0.5)."""
    x = blocks.float()
    a = x.abs().amax(dim=(-3, -1))
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which rounds some scales otherwise than the CPU and JAX
    s = torch.where(a > 0.0, a / a.new_tensor(KV_QMAX), torch.ones_like(a))
    # torch.round, as jnp.round, rounds half to even
    q = torch.clamp(torch.round(x / s[..., None, :, None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), s


def dequantize_kv_blocks(q: torch.Tensor, scales: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_blocks` (a broadcast product)."""
    return (q.float() * scales[..., None, :, None]).to(dtype)


def shard_cache(cache: Union[KVCache, QuantKVCache], dp_rank: int, dp: int,
                tp_rank: int, tp: int) -> Union[KVCache, QuantKVCache]:
    """Rank ``(dp_rank, tp_rank)``'s shard of a whole cache: the slot dim
    cut over ``dp``, the kv-head dim (of the data and of the int8 layout's
    scales) over ``tp``, ``lengths`` whole: the addressable shard of JAX's
    ``cache_specs`` on a (dp, tp) mesh.  Each shard is a tensor of its
    own."""
    if cache.max_batch % dp:
        raise ValueError(f"max_batch={cache.max_batch} not divisible by dp={dp} "
                         "(decode slots shard over the dp axis)")
    kvh = cache.k.shape[4]
    if kvh % tp:
        raise ValueError(f"kv_heads={kvh} not divisible by tp={tp}: the KV-cache "
                         "shards its head dim over tp")

    def cut(t: torch.Tensor, head_dim: int) -> torch.Tensor:
        rows, heads = t.shape[1] // dp, t.shape[head_dim] // tp
        return (t.narrow(1, dp_rank * rows, rows)
                .narrow(head_dim, tp_rank * heads, heads).contiguous())

    parts = {name: cut(t, 4 if t.dim() == 6 else 3)
             for name, t in cache._asdict().items() if name != "lengths"}
    return type(cache)(**parts, lengths=cache.lengths.clone())


class CacheOverflow(RuntimeError):
    """A slot used more blocks than were reserved for it — an engine bug
    (reservation-based admission makes this unreachable under load)."""


class PrefixTrie:
    """Host-side radix index over full-block token-id chains.

    One node per *logical* full block, keyed by the tuple of token ids
    it holds under its parent chain — content-addressing, so identical
    prompts dedupe even across trace groups.  A node's refcount is the
    set of slots physically holding that block content; a slot always
    holds a contiguous prefix of its chain starting at the root, so the
    refs at any matched node are valid donors for the WHOLE path above
    it (child refs ⊆ parent refs), and a node with an empty refcount
    has no live reader and is pruned.  Entirely host-side dict walking
    — the device programs never see it (``host-transfer-in-loop``
    stays clean)."""

    def __init__(self) -> None:
        # (parent_node, block token tuple) -> node id; root is node 0
        self._children: dict[tuple[int, tuple[int, ...]], int] = {}
        self._parent: dict[int, tuple[int, tuple[int, ...]]] = {}
        self._refs: dict[int, set[int]] = {}        # node -> holder slots
        self._slot_nodes: dict[int, list[int]] = {}  # slot -> chain nodes
        self._next_id = 1

    @property
    def num_nodes(self) -> int:
        """Logical shared blocks currently indexed (the pool charge)."""
        return len(self._refs)

    def total_refs(self) -> int:
        return sum(len(r) for r in self._refs.values())

    def shared_depth(self, slot: int) -> int:
        return len(self._slot_nodes.get(slot, ()))

    def match(self, chain: list[tuple[int, ...]]) -> tuple[int, Optional[int]]:
        """Longest indexed prefix of ``chain``: returns ``(blocks
        matched, donor slot)`` — the donor (lowest resident slot id, for
        determinism) physically holds every matched block."""
        node, depth, donors = 0, 0, None
        for key in chain:
            child = self._children.get((node, tuple(key)))
            if child is None:
                break
            node, depth, donors = child, depth + 1, self._refs[child]
        if depth == 0 or not donors:
            return 0, None
        return depth, min(donors)

    def attach(self, slot: int, chain: list[tuple[int, ...]],
               depth: int) -> None:
        """Record ``slot`` as a resident holder of the first ``depth``
        blocks of ``chain`` (which must already be indexed — callers
        attach only what :meth:`match` returned)."""
        if slot in self._slot_nodes:
            raise CacheOverflow(f"slot {slot} already holds a chain")
        node, nodes = 0, []
        for key in chain[:depth]:
            node = self._children[(node, tuple(key))]
            self._refs[node].add(slot)
            nodes.append(node)
        self._slot_nodes[slot] = nodes

    def extend(self, slot: int, chain: list[tuple[int, ...]]) -> tuple[int, int]:
        """Index ``slot``'s full chain past what it already holds,
        creating nodes as needed.  Returns ``(created, newly_ref)``:
        ``created`` nodes are new logical pool blocks; ``newly_ref``
        counts every block that moved from the slot's private
        reservation into shared accounting (``created`` ⊆ it — an
        existing node newly ref'd is a dedupe, freeing one block of
        budget)."""
        nodes = self._slot_nodes.setdefault(slot, [])
        node = nodes[-1] if nodes else 0
        created = newly = 0
        for key in chain[len(nodes):]:
            key = tuple(key)
            child = self._children.get((node, key))
            if child is None:
                child = self._next_id
                self._next_id += 1
                self._children[(node, key)] = child
                self._parent[child] = (node, key)
                self._refs[child] = set()
                created += 1
            if slot not in self._refs[child]:
                self._refs[child].add(slot)
                newly += 1
            nodes.append(child)
            node = child
        return created, newly

    def release(self, slot: int) -> int:
        """Drop ``slot``'s residency; prune (deepest-first) every node
        no live slot still holds.  Returns the pruned count — the
        logical blocks actually returned to the pool; blocks other
        slots still read stay charged, so eviction never tears a live
        reader."""
        pruned = 0
        for node in reversed(self._slot_nodes.pop(slot, [])):
            refs = self._refs.get(node)
            if refs is None:
                continue
            refs.discard(slot)
            if not refs:
                parent, key = self._parent.pop(node)
                del self._children[(parent, key)]
                del self._refs[node]
                pruned += 1
        return pruned

    def snapshot(self) -> dict:
        return {
            "children": dict(self._children),
            "parent": dict(self._parent),
            "refs": {n: set(r) for n, r in self._refs.items()},
            "slot_nodes": {s: list(n)
                           for s, n in self._slot_nodes.items()},
            "next_id": self._next_id,
        }

    def restore(self, snap: dict) -> None:
        self._children = dict(snap["children"])
        self._parent = dict(snap["parent"])
        self._refs = {n: set(r) for n, r in snap["refs"].items()}
        self._slot_nodes = {s: list(n)
                            for s, n in snap["slot_nodes"].items()}
        self._next_id = snap["next_id"]


class BlockLedger:
    """Host-side alloc/free/append accounting for the block pool.

    ``total_blocks`` is the global budget (defaults to the physical pool,
    ``max_batch * num_blocks``; configurable lower to model cache
    pressure).  Reservation is all-or-nothing per request; ``append``
    moves a block from reserved to in-use when a token crosses a block
    boundary; ``free`` returns everything.

    With ``prefix_caching`` the ledger carries a :class:`PrefixTrie`:
    every trie node is a logical block charged ONCE to the pool
    (``blocks_reserved`` = private reservations + trie nodes), a slot's
    private reservation shrinks by the blocks it shares, and ``free``
    returns a shared block only when the trie prunes it (refcount hit
    zero)."""

    def __init__(self, total_blocks: int, block_size: int,
                 prefix_caching: bool = False) -> None:
        if total_blocks < 1 or block_size < 1:
            raise ValueError(
                f"ledger needs positive sizes (total_blocks="
                f"{total_blocks}, block_size={block_size})"
            )
        self.total_blocks = total_blocks
        self.block_size = block_size
        self._reserved: dict[int, int] = {}   # slot -> PRIVATE blocks
        self._tokens: dict[int, int] = {}     # slot -> tokens appended
        self._shared: dict[int, int] = {}     # slot -> shared blocks held
        self.trie: Optional[PrefixTrie] = (
            PrefixTrie() if prefix_caching else None)
        self.cow_blocks = 0   # copy-on-write rewrites (monotone)
        self.peak_reserved = 0
        self.peak_in_use = 0
        self.peak_shared = 0

    def blocks_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_size))

    @property
    def shared_blocks(self) -> int:
        """Logical blocks in the shared pool (one per trie node)."""
        return self.trie.num_nodes if self.trie is not None else 0

    @property
    def blocks_reserved(self) -> int:
        return sum(self._reserved.values()) + self.shared_blocks

    @property
    def blocks_in_use(self) -> int:
        private = sum(
            max(0, self.blocks_for(t) - self._shared.get(s, 0)) if t else 0
            for s, t in self._tokens.items())
        return private + self.shared_blocks

    @property
    def blocks_free(self) -> int:
        return self.total_blocks - self.blocks_reserved

    def can_reserve(self, total_tokens: int,
                    shared_blocks: int = 0) -> bool:
        need = max(0, self.blocks_for(total_tokens) - shared_blocks)
        return need <= self.blocks_free

    def match_prefix(self, chain: list[tuple[int, ...]]
                     ) -> tuple[int, Optional[int]]:
        """Longest indexed block-chain prefix → ``(blocks, donor slot)``
        (``(0, None)`` when prefix caching is off or nothing matches)."""
        if self.trie is None or not chain:
            return 0, None
        return self.trie.match(chain)

    def reserve(self, slot: int, total_tokens: int,
                chain: Optional[list[tuple[int, ...]]] = None,
                attach_blocks: int = 0) -> int:
        """Reserve a request's worst-case blocks for ``slot``; returns
        the PRIVATE count.  With ``attach_blocks`` > 0 the slot also
        becomes a refcounted holder of the first ``attach_blocks``
        blocks of ``chain`` (already charged to the shared pool), so
        only the remainder is drawn from the free budget.  Raises when
        the slot is already occupied or the budget cannot cover it
        (callers gate on :meth:`can_reserve`)."""
        if slot in self._reserved:
            raise CacheOverflow(f"slot {slot} already holds a reservation")
        if attach_blocks and self.trie is None:
            raise CacheOverflow("attach requires prefix_caching")
        need = max(0, self.blocks_for(total_tokens) - attach_blocks)
        if need > self.blocks_free:
            raise CacheOverflow(
                f"cannot reserve {need} blocks for slot {slot}: only "
                f"{self.blocks_free}/{self.total_blocks} free"
            )
        if attach_blocks:
            self.trie.attach(slot, chain, attach_blocks)
        self._reserved[slot] = need
        self._tokens[slot] = 0
        self._shared[slot] = attach_blocks
        self.peak_reserved = max(self.peak_reserved, self.blocks_reserved)
        self.peak_shared = max(self.peak_shared, self.shared_blocks)
        return need

    def register(self, slot: int, chain: list[tuple[int, ...]]) -> int:
        """Index ``slot``'s full prompt block-chain in the trie (after
        its prefill completed, so the slot physically holds every
        block).  Blocks newly shared move from the slot's private
        reservation into the pool charge; an already-indexed block this
        slot now also holds is a dedupe that *frees* budget.  Returns
        the number of blocks that moved to shared accounting."""
        if self.trie is None or not chain:
            return 0
        if slot not in self._reserved:
            raise CacheOverflow(f"register of unreserved slot {slot}")
        _, newly = self.trie.extend(slot, chain)
        if newly > self._reserved[slot]:
            raise CacheOverflow(
                f"slot {slot} shared {newly} blocks beyond its private "
                f"reservation of {self._reserved[slot]}"
            )
        self._reserved[slot] -= newly
        self._shared[slot] = self._shared.get(slot, 0) + newly
        self.peak_shared = max(self.peak_shared, self.shared_blocks)
        return newly

    def note_cow(self, blocks: int) -> None:
        """Count copy-on-write block rewrites (the trie matched deeper
        than the request could attach, so the divergent tail is
        recomputed into private blocks).  Monotone, like the peaks."""
        self.cow_blocks += blocks

    def append(self, slot: int, tokens: int = 1) -> None:
        """Account ``tokens`` written into ``slot`` (prefill passes the
        prompt length, decode passes 1)."""
        if slot not in self._reserved:
            raise CacheOverflow(f"append to unreserved slot {slot}")
        self._tokens[slot] += tokens
        entitled = self._reserved[slot] + self._shared.get(slot, 0)
        if self.blocks_for(self._tokens[slot]) > entitled:
            raise CacheOverflow(
                f"slot {slot} outgrew its reservation "
                f"({self._tokens[slot]} tokens > "
                f"{entitled} blocks x {self.block_size})"
            )
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)

    def free(self, slot: int) -> int:
        """Release a slot's reservation; returns the blocks actually
        returned to the pool: its private blocks plus every shared
        block whose refcount dropped to zero (blocks other live slots
        still read stay charged — no torn readers, no double-free)."""
        if slot not in self._reserved:
            raise CacheOverflow(f"free of unreserved slot {slot}")
        blocks = self._reserved.pop(slot)
        self._tokens.pop(slot)
        self._shared.pop(slot, None)
        if self.trie is not None:
            blocks += self.trie.release(slot)
        return blocks

    def snapshot(self) -> dict:
        """Copy of the alloc/append accounting — the serving engine's
        pre-dispatch rollback point (``docs/resilience.md``): a failed
        or torn decode unit restores this before re-issuing.  Includes
        the trie + refcounts, so a retry can never double-free or leak
        a shared block."""
        return {"reserved": dict(self._reserved),
                "tokens": dict(self._tokens),
                "shared": dict(self._shared),
                "trie": (self.trie.snapshot()
                         if self.trie is not None else None)}

    def restore(self, snap: dict) -> None:
        """Roll the accounting back to a :meth:`snapshot`.  The peak
        counters deliberately stay monotone (a rolled-back peak was
        still a real high-water mark of host bookkeeping)."""
        self._reserved.clear()
        self._reserved.update(snap["reserved"])
        self._tokens.clear()
        self._tokens.update(snap["tokens"])
        self._shared.clear()
        self._shared.update(snap.get("shared", {}))
        if self.trie is not None and snap.get("trie") is not None:
            self.trie.restore(snap["trie"])

    def stats(self) -> dict[str, int]:
        return {
            "total_blocks": self.total_blocks,
            "blocks_reserved": self.blocks_reserved,
            "blocks_in_use": self.blocks_in_use,
            "peak_blocks_reserved": self.peak_reserved,
            "peak_blocks_in_use": self.peak_in_use,
            "shared_blocks": self.shared_blocks,
            "peak_shared_blocks": self.peak_shared,
            "prefix_refs": (self.trie.total_refs()
                            if self.trie is not None else 0),
            "cow_blocks": self.cow_blocks,
        }
