"""Serving (counterpart of ``dlbb_tpu/serve``): the paged KV-cache
(``kvcache``: the cache tensors and their int8 layout, slot
gather/scatter, per-rank shards, the host block ledger and prefix trie),
the seeded request traces (``traffic``), and the continuous-batching
engine (``engine``: ``ServingConfig``, the prefill and decode programs in
the "off" and "greedy" token modes, the fused multi-step decode and its
in-flight window, chunked prefill, slot compaction, the shared-prefix
attach and int8 KV planes, speculative and sampled decoding, the
failure paths (fault sites, retries and rollback, the dispatch watchdog,
SLO deadlines, the SIGTERM drain), the scheduler and
``ServingEngine.run_trace``, on one device or a (dp, tp) mesh), and the
serving harness (``bench``: ``run_serving``, ``resume_serving``,
``run_serve_from_config``, behind ``cli serve``), and the replica fleet
(``fleet``: ``FleetSupervisor`` and ``run_fleet``, behind ``cli serve
--replicas``).  The other report writers of the serving benchmarks come
with ROADMAP Queue 1, Slice E, item 12, part 12c."""

from dlbb_tpu_torch.serve.engine import (
    SERVING_REPORT_SCHEMA,
    ServingConfig,
    ServingEngine,
    build_compact_gather,
    build_compact_scatter,
    build_decode_fused,
    build_decode_fused_token,
    build_decode_step,
    build_decode_token_step,
    build_prefill,
    build_prefill_chunk,
    build_prefix_attach,
    create_prefix,
)
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
    "SERVING_REPORT_SCHEMA",
    "BlockLedger",
    "CacheOverflow",
    "KVCache",
    "PrefixTrie",
    "QuantKVCache",
    "Request",
    "ServingConfig",
    "ServingEngine",
    "TrafficTrace",
    "build_compact_gather",
    "build_compact_scatter",
    "build_decode_fused",
    "build_decode_fused_token",
    "build_decode_step",
    "build_decode_token_step",
    "build_prefill",
    "build_prefill_chunk",
    "build_prefix_attach",
    "create_kv_cache",
    "create_prefix",
    "create_quant_kv_cache",
    "dequantize_kv_blocks",
    "gather_cache_slots",
    "generate_trace",
    "quantize_kv_blocks",
    "scatter_cache_slots",
    "shard_cache",
]
