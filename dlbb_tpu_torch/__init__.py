"""dlbb_tpu_torch — the PyTorch/CUDA port of ``dlbb_tpu``, for NVIDIA Hopper.

The JAX package ``dlbb_tpu`` stays the reference; every module here mirrors
its counterpart's name and is held against it by the ``tests/test_torch_*``
parity tests (same seeded inputs and weights in, same outputs out, within a
stated tolerance).  This package imports ``torch`` and numpy only — never
``jax`` and never a module of ``dlbb_tpu``.

Ported so far (the single-device forward, the collective sweeps, the
tensor-parallel forward, DDP/ZeRO and tensor-parallel training, the
sequence-sharded layouts: overlapped tensor parallelism and sequence
parallelism, pipeline parallelism and the MoE FFN with expert
parallelism, compressed collectives and training, the reports, the
serving foundations, the serving engine whole and its harness, the serving
fleet, tp over heads it does not divide and Ulysses over heads sp does not
divide per tp rank, the sweep's failure handling and tracing, its
compile-ahead engine and device traces):

- ``models`` — ``ModelConfig``/``MODEL_CONFIGS`` (1B/7B/13B), the decoder
  ``forward`` with the simplified/full/dense/flash attention modes, remat
  ("full", "dots") and the top-k MoE FFN (dense and capacity dispatch, the
  load-balancing loss), ``dense_attention``, and ``params_from_jax`` to
  carry JAX weights across;
- ``ops`` — ``flash_attention``, differentiable through a
  ``torch.autograd.Function``: hand-written CUDA C++ kernels for Hopper
  (``ops/csrc/flash_fwd.cu``, the port of the Pallas ``_fwd_kernel``;
  ``ops/csrc/flash_bwd.cu``, the ports of ``_dq_kernel`` and
  ``_dkv_kernel``) with their plain PyTorch versions beside them;
- ``data`` — the seeded synthetic embedding batch (and its targets);
- ``train`` — ``optim`` (adam, adamw, sgd, adafactor; the constant,
  cosine and warmup_cosine schedules; ``cast_moments``; optax's rounding
  rules), ``zero`` (ZeRO stages 0-3 as explicit collectives over the dp
  group), ``loop`` (``make_train_step`` and ``run_train`` on a (dp, tp)
  mesh, gradient accumulation, preemption) and ``checkpoint`` (per-rank
  ``torch.save`` checkpoints with integrity manifests, restored onto the
  layout they were saved on or onto another mesh or ZeRO stage);
- ``resilience`` — host-only copies of the JAX failure taxonomy, the
  fault-injection plan grammar and the SIGTERM guard;
- ``utils`` — ``summarize``/``Timer``, per-iteration CUDA-event timing,
  config IO, system info;
- ``bench.e2e`` — ``run_e2e``, on one device or on every rank of a (dp,
  sp, pp, ep, tp) process-group mesh; ``cli e2e`` and ``cli train``
  (``--world N``, ``--tp-overlap``, ``train --zero STAGE``);
- ``parallel`` — ``ParallelismPlan`` (the JAX plan's checks and the
  (dp, sp, pp, ep, tp) mesh), the ring-decomposed collective matmuls
  ``allgather_matmul``/``matmul_reducescatter`` (``tp_overlap``),
  ``ring_attention`` and ``ulysses_attention``, on the ring hop of
  ``parallel.ring``, and the GPipe and 1F1B pipeline engines
  (``parallel.pipeline``); ``models.sharding`` — explicit Megatron
  tensor-parallel shards, the pp slice of the layers and the ep slice of
  the experts;
- ``comm`` — process groups (``torch.distributed``: NCCL, or gloo on the
  CPU), the collective ops, payloads and mesh-shape variants;
  the collective-matmul micro-ops and their ``overlap_*`` variants;
  ``bench.runner`` and ``bench.launch`` — the 1D and 3D collective sweeps
  on spawned ranks, with fault injection, the per-config watchdog,
  retries, quarantine, the journal and ``--resume``, and span traces;
  ``bench.schedule`` — the compile-ahead engine (work units, the
  background builder, the measurement gate); ``stats`` — their statistics; ``cli bench1d``,
  ``bench3d``, ``stats1d``, ``stats3d``; the quantised-wire collectives
  and compressed gradient training (``comm.compression``), and the
  derived reports (``stats.compare``, ``variants_report``, ``northstar``,
  ``parallelism_report``; ``cli compare``, ``reports``);
- ``serve`` — the paged KV-cache (``kvcache``: its int8 layout, slot
  gather/scatter, per-rank shards, the block ledger and prefix trie), the
  seeded request traces (``traffic``), and the engine (``engine``:
  ``ServingConfig``, the prefill and decode programs in the "off" and
  "greedy" token modes, the fused multi-step decode and its in-flight
  window, chunked prefill, slot compaction, the shared-prefix attach and
  int8 KV planes, speculative and sampled decoding, the failure paths and
  the SIGTERM drain, the continuous-batching scheduler and
  ``ServingEngine.run_trace``, at world 1 or on a (dp, tp) mesh), and the
  harness (``bench``: the artifact set, the drain's checkpoint and
  ``resume_serving``; ``cli serve``); the serving inputs of ``data`` and
  the KV-cache sizing and serving envelope of ``models.configs``;
  ``stats.serving_report`` (``cli reports``' serving table);
- ``obs`` — the span tracer, the metrics registry, ``sweep_metrics``,
  ``serving_metrics`` and ``fleet_metrics``; ``resilience.journal``; the
  gated device capture over ``torch.profiler`` (``capture``), its analysis
  (``devtrace``, ``analysis.findings``), the sweep-artifact corpus and the
  cm2 fit over it (``corpus``, ``fit``, on ``analysis.costmodel``), span
  attribution against the cost model (``attribution``) and ``cli obs
  trace|devtrace|fit|attribute``; ``utils.profiling`` (``--trace``);
- ``analysis`` — the findings and ``AnalysisReport``, the analytic
  expected-collective and wire model (``expectations``), the AST source
  lint (``source_lint``), the op capture (``op_capture``) and the
  collective audit over the registered targets (``hlo_audit``), ``cli
  analyze lint|hlo``; the schedule, memory and numerics passes over each
  target's captured graph, the fp64 shadow and the baseline gate (``cli
  analyze schedule|memory|numerics|all|snapshot|diff``); the cost-model
  table (``costmodel``);
- ``plan`` — the cm2 plan autotuner and the fleet capacity planner
  (``cli plan --auto|--capacity``), fail-closed without a fit;
- ``resilience`` — the fault sites, the journal, preemption, artifact
  validation and the chaos gate (``cli chaos``).

The root script ``bench_torch.py`` is the port's ``bench.py``: the 1B
forward's tokens/s and ``bench.py``'s extras in one JSON line.  ``python
-m dlbb_tpu_torch`` runs ``cli``.

Not ported yet (see ROADMAP.md): the cost model's calibration and its diff
(ROADMAP Queue 1, Slice F, item 14, part 14b).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit ``"cpu"`` they raise.
"""

__version__ = "0.1.0"
