"""Serving foundations (counterpart of ``dlbb_tpu/serve``): the paged
KV-cache (``kvcache``: the cache tensors and their int8 layout, slot
gather/scatter, per-rank shards, the host block ledger and prefix trie)
and the seeded request traces (``traffic``).  The engine comes with
ROADMAP Queue 1, Slice E, item 11, and the serving harness and the fleet
with item 12."""

from dlbb_tpu_torch.serve.kvcache import (
    BlockLedger,
    CacheOverflow,
    KVCache,
    PrefixTrie,
    QuantKVCache,
    create_kv_cache,
    create_quant_kv_cache,
    dequantize_kv_blocks,
    gather_cache_slots,
    quantize_kv_blocks,
    scatter_cache_slots,
    shard_cache,
)
from dlbb_tpu_torch.serve.traffic import Request, TrafficTrace, generate_trace

__all__ = [
    "BlockLedger",
    "CacheOverflow",
    "KVCache",
    "PrefixTrie",
    "QuantKVCache",
    "Request",
    "TrafficTrace",
    "create_kv_cache",
    "create_quant_kv_cache",
    "dequantize_kv_blocks",
    "gather_cache_slots",
    "generate_trace",
    "quantize_kv_blocks",
    "scatter_cache_slots",
    "shard_cache",
]
