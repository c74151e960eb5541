#!/usr/bin/env python3
# comm-lint: disable-file=host-transfer-in-loop  every loop here checks results on the host or brackets a timing rep
"""Smoke run of the PyTorch/CUDA port (``dlbb_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,fwd,bwd,e2e,train,time,comm,tp,dtrain,seq,moe,pipe,compress,bench,kv,serve,fleet,chaos,plan,analyze]

Phases (each raises on failure, and the script then exits non-zero).  The
multi-rank runs of phases tp, dtrain, seq, moe, pipe, compress and analyze, processes
on the one card over gloo, are the jobs of one spawn of ``GLOO_WORLD``
processes (``_run_gloo_jobs``), made after phase 1 and before the phases
that check them: each job in turn on the first ranks of one gloo group
(a spawn costs about 17 s before its ranks reach the card).

1. build every CUDA kernel of the port from ``dlbb_tpu_torch/ops/csrc``,
   print each kernel's ``ptxas`` registers and the three kernels' tiles
   and warp roles (``setmaxnreg``), read from their sources, and fail on
   any spill;
2. hold each kernel against its plain PyTorch version on the card, on the
   main path's shape, on the edge cases (GQA, non-causal, ragged S,
   KV-cache decode, fully masked rows) and at the edges of the kernels'
   tiles (a partial Q tile, S = Sk = 130, GQA g = 8, S < Sk non-causal,
   B*N above 65535): the flash forward's ``(o, lse)``, then the flash
   backward's ``(dq, dk, dv)`` from a random bf16 ``dO``;
3. drive the forward path through its entry point: ``run_e2e`` on the 1B
   decoder at full width (24 layers, H=2048, 16 heads, FFN 8192), bf16,
   B=8, S=512, ``attention="full"``; check that every layer went through
   the flash kernel, that the output is finite, and that it agrees with
   the same forward through ``dense_attention``; then one dedicated traced
   forward (``obs/capture.py``, ``torch.profiler`` with CUPTI) whose parsed
   trace (``obs/devtrace.py``) holds exactly as many ``flash_fwd_kernel``
   events as the launch counter counts over it, its device µs per bucket
   printed (where CUPTI gives no kernel, the capture must fail closed, and
   ``cupti: unavailable`` is printed); then (phase 20 (d)) the same forward
   once more under the collective audit's capture;
4. drive the train path through its entry point: ``run_train`` on
   ``dlbb_tpu_torch/configs/train_1b_adam_bf16m.yaml`` (the same 1B decoder,
   remat "dots", Adam with bf16 moments, B=8, S=512); check the flash
   kernels' launches per step (48 forward: 24 in the forward and 24 in the
   remat recompute; 24 dq and 24 dk/dv) and finite losses; (b) that run
   under a span tracer (``obs/spans.py``) into ``chiprun_out/
   chip_smoke_plan/train``: its trace valid, with JAX's train spans (one
   ``compile+warmup``, one ``measure``, a ``train_step`` per timed step
   with its index), and ``cli obs attribute --model cm1 --tier cuda`` on
   the run: its phases sum to the wall within ``ATTR_REL`` and
   ``execute`` covers the ``train_step`` spans; then one step's
   loss and gradients on the same weights and batch through the kernel path
   and through the dense path, which must agree; then one traced step's
   loss and gradients whose ``flash_fwd_kernel``, ``flash_bwd_dq_kernel``
   and ``flash_bwd_dkv_kernel`` events equal the counters' launches over
   the capture's last session (the sum of its ``profile_reps`` calls);
   then (phase 20 (d)) one Adam step of the same config under the
   collective audit's capture;
5. time each kernel alone beside its plain version, one PyTorch library
   call of the same function (a yardstick only: the port never calls it)
   and the least time the card could take, with its TFLOP/s and its share
   of the bound.  The kernels and the library calls are timed by CUDA-graph
   replay, since a wrapper's host enqueue is about as long as its kernel at
   the main shape; the time per call back to back (host included) is
   printed beside it.  The backward's yardstick is SDPA's flash backward
   op alone (``aten._scaled_dot_product_flash_attention_backward`` on its
   forward's saved outputs);
6. drive the collective sweeps through NCCL on a process group of one
   rank on the card: first each op's output on its first call against
   ``plain_collective`` on the same payload (equal, bit for bit, at one
   rank), then ``run_sweep`` on the reference's 1D grid (its 8 ops and
   reducescatter x 1KB-16MB) and on the 3D ops at three LLM shapes up to
   1 GiB per rank, bf16, 10 warmup and 100 timed iterations, every payload
   on the card; check every result JSON (schema keys, one row of finite
   timings per rank), run the 1D and 3D statistics into their CSVs, and
   print the median time per op at 16MB and at (8, 4096, 4096); then (c)
   the sweep's resilience (``COMM_FAULT_OPS`` x 1KB-16MB under
   ``exec-transient:1,exec-hang:@3`` with the watchdog and a span trace):
   the transient retried, the hang abandoned at the deadline and
   quarantined with no late write, the trace valid, and ``resume``
   re-validating every artifact and completing the grid; and (d), last, a
   1D sweep of ``COMM_TRACE_OPS`` at 16MB with the compile-ahead engine on
   and a device capture per config, equal in every non-volatile field to a
   serial untraced run, ``obs devtrace`` on it green, its device events
   printed by bucket and name, and each capture's census of device records;
   then (e) the corpus and the cm2 fit on the phase's own artifacts
   (``obs/corpus.py::build_corpus`` over its output tree: every result JSON
   that validates one sample of tier ``cuda``, every ``sweep_manifest.json``
   one summary, each devtrace report's op rows), and ``obs/fit.py::
   run_fit`` on the ``cuda`` tier, which must fail closed because at world 1
   every per-device wire size is 0 (one message size: β unidentifiable);
7. drive the tensor-parallel forward: the 7B baseline at world 1 through
   ``launch`` over NCCL, equal bit for bit to the forward with no process
   group, and the 1B at tp=2 as two processes on the one card over gloo,
   within ``tp_bf16_bound`` of the world-1 forward;
8. ``dtrain``, multi-rank training: (a) at world 1 over NCCL through
   ``launch``, the 1B train config at full width and depth: two steps of
   ``make_train_step`` at ZeRO stages 0-3, equal bit for bit (losses and
   every parameter) to the two steps with no process group, with 48 flash
   forward, 24 dq and 24 dk/dv launches per step; then ``run_train`` at
   stage 1, and at stage 2 with ``gradient_accumulation: 2`` (twice the
   launches); then a checkpoint save, restore and continued step at full
   width and 2 layers (a cut: 24 layers would write about 7 GB), equal bit
   for bit to the uninterrupted step.  (b) two processes on the one card
   over gloo with CUDA tensors (NCCL puts no two ranks on one GPU): one 1B
   step at full width and 6 of its 24 layers (``DTRAIN_GLOO_LAYERS``) at
   tp=2, stage 1, and at dp=2, stage 3, their loss and gradients
   (reassembled over the shards) against the world-1 step's at that depth
   within the
   bounds argued at ``DTRAIN_*``; then batch 6 in 2 micro-batches of 3 rows
   at dp=2, ZeRO-2 (``DTRAIN_RESHARD``: each micro-batch resharded, 2 rows
   on one rank and 1 on the other), two steps against the world-1 steps on
   the same global batch, JAX's warning once per rank, each rank's flash
   launches following its rows; then, on four processes, tp=4 where it does not divide the heads (``DTRAIN_UNEVEN_MODEL``:
   hidden 384, 6 heads of 64, FFN 1536, through the flash kernel), its
   forward and step against world 1's and its flash launches per rank;
   and the 1B train state (2 layers, as (a)'s checkpoint) saved at ZeRO-1
   on dp=2 and restored onto ZeRO-3 on dp=2 and onto world 1, each
   gathered state bit-equal to the saved one and the next step's loss
   against the uninterrupted step's; errors and wall time printed, not
   timed as a benchmark;
9. ``seq``, the sequence-sharded layouts: (a) at world 1 over NCCL in the
   script's process, the collective-matmul sweep ops ``ag_matmul`` and
   ``matmul_rs`` at phase ``comm``'s three 3D shapes: each schedule's first
   call (fused, ring, bidir) equal bit for bit to the others and to
   ``plain_collective`` (a one-rank ring is one product), then ``run_sweep``
   under the variants ``default``, ``overlap_ring`` and ``overlap_bidir``
   (10 warmup, 100 timed iterations), their medians printed; (b) two
   processes on the card over gloo at the 1B's full width, cut to
   ``SEQ_LAYERS`` layers (the whole script's time limit): tp=2
   with ``tp_overlap`` ring and bidir ("full": the flash kernels on each
   rank's 8 heads over the gathered sequence), and sp=2 with ring and
   Ulysses attention (torch ops, no kernel): the forward against the
   world-1 forward and one ZeRO-1 step of the 1B train config (the loss and
   reduced gradients, and at tp=2 the update: two whole 1B Adam updates do
   not fit on one card beside each other) against the world-1 step, within
   the bounds argued at ``SEQ_*``; the flash launches of each rank and the
   ring hops' transport printed (gloo's point-to-point takes no CUDA
   tensor, so the hops go through host memory); on 8 processes, Ulysses
   where sp does not divide a tp rank's heads
   (``SEQ_ULYSSES_GATHER``: the tests' narrow model, 4 heads at tp=2,
   sp=4, fp32) against the dense path at world 1;
10. ``moe``, the MoE FFN: the 1B with 4 experts, top-2, bf16, at full width
   and depth (3.6 B parameters): (a) ``run_e2e`` at world 1 with the dense
   and the capacity dispatch, B=8, S=512, "full" (24 flash forward launches
   per forward, counted from 0 around each run); (b) ``run_train`` at all
   24 layers, Adam with bf16 moments, remat dots, ``moe_aux_loss_weight``
   0.01, the first step and one timed step (48/24/24 flash launches per
   step), finite losses; (c) ep=2 as two processes on the card over gloo:
   each dispatch's forward, and one step's loss and reduced gradients per
   leaf, against world 1 within ``moe_ep_bounds`` and ``loss_rel_bound``;
11. ``pipe``, pipeline parallelism: the 1B train config at full width and 8
   of its 24 layers (``PIPE_LAYERS``) at pp=2, m=4, as two processes on the
   card over gloo (hops through host memory; a stage runs dense attention,
   JAX's pin, so no flash launch): the forward against world 1's, and one
   GPipe and one 1F1B step (loss, reduced gradients, the Adam update)
   against world 1's and each other, within the bounds argued at
   ``PIPE_*``; the bubble fraction, times and peak memory per stage
   printed;
12. ``compress``, the quantised-wire collectives and compressed gradient
   training (``comm/compression.py``): (a) the quantiser (int8, fp8) on the
   card at the 1B train config's parameter count against its run on the CPU
   copy of the input, bit for bit (wire bytes, scales, dequantised values,
   quantisation error), and quantise plus dequantise timed; (b) at world 1
   over NCCL in the script's process, ``allreduce``, ``allreduce_q``,
   ``reducescatter`` and ``reducescatter_q`` at 1KB-16MB under the variants
   ``default``, ``compress_int8``, ``compress_fp8`` and
   ``compress_int8_bf16acc`` (a one-rank ring is the identity, as in JAX,
   with no byte on the wire), then ``cli stats1d`` and ``cli reports``,
   which must write ``VARIANTS.md`` and ``NORTHSTAR.md`` with rows; (c) the
   compressed ops at world 2 as two processes on the card over gloo against
   the uncompressed ops on the same CUDA payload, within the JAX tests'
   bounds (``COMPRESS_RING_TOL``), every rank's all-reduce equal, and the
   bytes handed to ``torch.distributed`` equal to ``op_wire_bytes``; (d)
   the 1B train config at full width, cut to ``COMPRESS_LAYERS`` layers, at
   dp=2 over gloo: int8 and fp8 at ZeRO-0 and int8 at ZeRO-2 with bf16
   accumulation, 3 steps each: step 0's dp-reduced gradient within a
   wire-step bound of the uncompressed dp=2 run's, the two ranks'
   parameters bit-equal after the steps, each step's loss within
   ``COMPRESS_LOSS_REL`` of the uncompressed run's, the residual finite and
   non-zero, the flash launches per step counted from 0 around each step;
   (e) ``cli train --grad-compression int8`` at world 1 refused with
   JAX's message;
13. ``bench``, the port's headline (``bench_torch.py``, ``bench.py``'s
   counterpart): (a) ``python3 bench_torch.py`` as a subprocess, as it is
   run from the command line: exit 0 and one stdout line with ``bench.py``'s four
   headline keys and every extra (7B simplified and full, 1B full and dense
   at S=512 and S=1024, 1B flash at S=8192, the 1B Adam train step), each
   field finite and positive, no ``failed``; the line printed beside the
   card's name and power limit; (b) in this process, for the headline's
   configuration and each forward extra's, one untimed forward on the
   weights from seed 42 and the benchmark's batch, its flash launches
   counted from 0 (one per layer for "full" and "flash" at S >= 512, none
   for "dense" and "simplified"), and each "full" and "flash" forward held
   against the same forward through "dense" within ``E2E_REL_L2`` (at
   S=8192 on batch row 0: dense holds fp32 scores of [B, 16, S, S]);
14. ``kv``, the serving cache (``serve/kvcache.py``) inside a span trace
   (``obs/spans.py``, written to a temporary directory of the checkout and
   validated): the 1B's cache at 32 slots x 2048 tokens in 16-token
   blocks, K and V each [24, 32, 128, 16, 16, 128] bf16 (12.0 GiB, equal to
   ``kv_cache_bytes``) from a seeded generator; each layer quantised to the
   int8 layout (its bytes equal to ``kv_cache_bytes(..., "int8")``), two
   layers' codes, scales and dequantised values equal to the CPU's bit for
   bit and their fp32 round trip reproducing the codes; quantise plus
   dequantise of the whole cache timed (CUDA events, median of 5) beside its
   bytes bound; ``gather_cache_slots`` and ``scatter_cache_slots`` on 8
   slots equal to the CPU's bit for bit, the round trip the identity.
15. ``serve``, the serving engine's core (``serve/engine.py``) on the 1B
   (H=2048, 24 layers, 16 heads, FFN 8192, bf16, random weights from seed
   42) at world 1: (a) a 1024-token sequence, its first 640 tokens
   prefilled into slot 2 of a 4-slot cache (``max_seq`` 1024, 16-token
   blocks) and the other 384 decoded with the true next inputs fed in,
   every output against the one-shot "full" forward (24 flash launches,
   counted) within ``SERVE_REL_L2``, slot 2's length 1024 and the other
   slots empty; (b) ``run_trace`` on phase kv's cache (32 slots of 2048
   tokens, 12 GiB, ``hbm_budget_gb`` the card's memory less the weights)
   of 64 seeded requests all arriving at t=0 (prompts 128-1024, outputs
   32-128), in the "off" mode and in the "greedy" mode: every request
   completed, none rejected, no block left reserved, the span trace valid
   ((g)1 and (g)2 repeat the greedy run and must give its tokens);
   TTFT, per-token latency, decode-step ms, goodput and peak memory
   printed; (c) the decode step's median against its bytes bound (the
   weights and the whole cache read once at 3.35 TB/s); (d) the fast path
   (fused scans, the in-flight window, chunked prefill, compaction; after
   the fused run, ``capture_device_traces`` on its engine: a prefill and a
   fused decode scan on fresh state, their phases, ``obs devtrace`` green
   on a run recording them, their device µs per bucket) and (e)
   the prefix cache and int8 planes on a shared-prefix trace; (f)
   speculative and sampled decoding: (f)0 ``build_verify_probs`` at γ=4 on
   (a)'s 4-slot cache against γ+1 per-step token steps (bit-equal: the
   verify runs each position in the step's own shapes;
   ``build_verify_step`` commits all γ+1), (f)1 greedy "ngram" and
   adaptive-γ fused "ngram" runs on (b)'s trace and a "draft-model" run on
   the short trace ((b)'s first 16 requests, outputs cut to 32 tokens),
   each request at its full length, both ledgers clean, every request's
   tokens (b)'s greedy tokens (64 of 64; on the short trace their first
   ones) and "ngram" equal to itself on a second run (on the short trace),
   (f)2 sampled "ngram" runs (temperature 0.8) on the short
   trace replayed by seed 3 and moved by seed 4, (f)3 each
   run's verify units, acceptance and tokens per unit, and the verify
   unit's median (from its ``serve-verify`` spans) against its bytes bound;
   (g) resilience and the entry point on (b)'s cache and trace, each part's
   seconds printed: (g)1 ``serve-decode-fail:2`` and (g)2
   ``serve-cache-torn:1`` serve every request with (b)'s greedy tokens and
   no block left; (g)3 ``serve-decode-hang:@3`` under the watchdog
   (``dispatch_deadline_factor`` 50) fails the resident window closed as
   ``hung-dispatch``, completes the rest, resets the carry once, and peaks
   under two caches plus the weights, the decode step printed with the
   watchdog off and on; (g)4 ``serve-preempt:@5`` through
   ``serve/bench.py::run_serving``, then ``resume_serving``: the merged
   artifact set has an uninterrupted run's names and its outcome for every
   request not preempted; (g)5 ``python -m dlbb_tpu_torch.cli serve
   --config dlbb_tpu_torch/configs/serve_1b.yaml --trace poisson --requests
   64`` as a subprocess exits 0 and leaves JAX's artifact set with finite
   goodput and TTFT p50/p99/p999; (h) (before (g)) records shaped as the
   bench scripts' ``BENCH_serve.json``, ``BENCH_spec.json`` and
   ``BENCH_prefix.json`` from (b), (d)1, (e) and (f)1's runs, through the
   port's writers in a temporary directory: each table's rows and
   speedups the phase's own ratios (no request served).
17. ``fleet``, the serving fleet (``serve/fleet.py``) on
   ``dlbb_tpu_torch/configs/serve_1b_fleet.yaml`` (the 1B at full width and
   depth, two replicas of one process each on the card, 16 slots of 2048
   tokens each) over one seeded Poisson trace: (a) the single-engine oracle
   (one engine on the fleet's serving section, in this process), (b) the
   clean 2-replica fleet and (c) the fleet with ``serve-replica-kill``
   firing mid-trace, both through ``serve/fleet.py``'s launch (ranks over
   gloo on the card).  Every request completes with the oracle's greedy
   tokens; (c) fences exactly one replica as ``replica-killed``, fails at
   least one request over, and the survivor ends with no block reserved;
   both leave the fleet artifact set.  Goodput, TTFT p50/p99, the failover
   TTFT penalty, the failovers and each run's peak memory against the
   card's are printed.
18. ``chaos``, the chaos gate (``resilience/chaos.py``, ``cli chaos``):
   ``run_chaos(plan="all", device="cuda")``, its ten fault classes in JAX's
   order on JAX's mini configs (the 1 KB mini-grid at world 1 over NCCL in
   this process, the checkpointer, a SIGKILLed child sweep, the 2-layer
   64-wide serving model in this process, and its fleet as two one-rank
   replica processes on the card), each class's seconds printed; any class
   that is not green fails the run.  The phase's budget is 120 s
   (``CHAOS_BUDGET_S``, printed beside its wall).  Its flash launches,
   counted from 0 around it, are this process's (none: the sweeps run
   collectives and the serving programs attend in plain torch).
19. ``plan``, the package's entry point, attribution and the autotuner
   (``obs/attribution.py``, ``plan/autotune.py``), under
   ``chiprun_out/chip_smoke_plan``: (a) ``python -m dlbb_tpu_torch --help``
   as a subprocess exits 0 and lists ``PLAN_SUBCOMMANDS``; (c) ``cli obs
   attribute --model cm1 --tier cuda`` on phase comm (d)'s traced NCCL
   sweep (its phases sum to its wall, every config's device µs read from
   the card's own Kineto captures) and on the chaos gate's clean serving
   run (its model's width printed), and the same sweep with ``--model
   cm2`` exits 1 (the ``cuda`` tier has no fit); (d) ``cli plan --auto
   --target serving``, ``--target train`` and ``cli plan --capacity`` on
   the ``cuda`` tier each exit 1 with every point of the one-device grid
   journaled ``cm2-fit-missing`` and ``metrics.prom``'s
   ``plan_search_points{outcome="pruned-cm2-fit-missing"}`` equal to
   ``searched``.  Each part's seconds are printed.
20. ``analyze``, the source lint and the collective audit
   (``analysis/{source_lint,op_capture,hlo_audit}.py``, ``cli analyze``):
   (a) ``python -m dlbb_tpu_torch analyze lint --strict-warnings`` as a
   subprocess exits 0 (the files linted and the suppressions printed); (b)
   ``analyze hlo`` with no ``--simulate``, at world 1, exits 1 with
   ``no-targets-audited`` and every default target skipped; (c) a job of
   the one gloo spawn: ``run_hlo_audit`` over every default target (the
   registry ops, the forwards, the train steps and the serving programs)
   on the 8 ranks with CUDA tensors, every target clean, each target's
   kinds, count and wire bytes printed; (d) in phases 3 and 4, the 1B
   forward and the 1B Adam step once more each under the capture
   (``_captured``): 0 collectives, the flash launches the phases count (24
   per forward, 48/24/24 per step), and for the step every parameter and
   Adam moment kept its storage (the step updates its state in place); (e)
   the same gloo job runs the schedule, memory and numerics passes too,
   priced at the committed baselines' tier ``cpu-sim``, and
   ``diff_baselines`` against ``stats/torch/analysis/baselines`` gives no
   error (each target's critical path, overlap, peak and error bound
   printed); (f) in phases 3 and 4 the three passes over the 1B forward's
   and the Adam step's captured graphs at tier ``cuda`` (``_graph_passes``):
   24 and 48/24/24 flash nodes, the static peak live bytes within the
   caching allocator's peak over the same call and its rise above the
   arguments within the allocator's rise, the critical path, the compute
   total and the numerics sites printed; (g) ``python -m
   dlbb_tpu_torch.analysis.numerics_shadow --device cuda``: 4 confirmed, 0
   refuted, each case's measured error the committed CPU report's.

It then prints the card's name and power limit, one JSON line
``{"kernels": [...]}``, and as its last line
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset for a short
check (phase 1 always runs) and then prints no result lines.  Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

# published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# kernel vs plain version, both from the same bf16 inputs with fp32
# statistics: o is bf16 (8 mantissa bits, and the kernel rounds P to bf16
# at its running max where the plain version uses the row max), so about
# 2 bf16 ulps; lse is fp32 and differs only by __expf and summation order
O_ATOL, O_RTOL = 2e-2, 2e-2
LSE_ATOL = 1e-3
# 1B forward, kernel path vs dense path, relative L2 over the whole output:
# both are bf16 forwards (2**-8 relative per rounding) that round attention
# differently (the kernel rounds P and o to bf16, dense keeps fp32 until o)
# and 24 residual layers carry those differences to the output.  The same
# bound holds phase bench's configurations: at S=1024 and S=8192 each o is a
# weighted sum over 2x and 16x more keys, whose independent roundings partly
# cancel, so a layer's difference does not grow with S; the 7B's 32 layers
# carry it through 4/3 the 1B's depth, at most 4/3 the difference if it grew
# linearly (the 1B reads about 1.26e-02 at S=512 on an H100, so 32 layers
# stay near 1.7e-02 at worst).  Phase bench prints each reading.
E2E_REL_L2 = 3e-2
# backward kernels vs plain version, from the same bf16 inputs: both round
# p and ds to bf16 before their products, but from fp32 scores summed in
# another order, so a term can land one bf16 ulp (2**-8) apart; dk and dv
# sum S * g such terms, so their error follows the size of the sum and not
# each element: each output is held to atol = BWD_ATOL_REL * max|plain| and
# rtol = BWD_RTOL, about two bf16 ulps of the output's scale
BWD_ATOL_REL, BWD_RTOL = 1e-2, 2e-2
# 1B train step, kernel path vs dense path on the same weights and batch:
# the loss (an fp32 mean over 8M squared differences) moves by the forward's
# bf16 differences (E2E_REL_L2 above) only through their correlation with
# the residual, so relatively far less; each gradient leaf is a bf16 sum
# over the batch that carries the forward's differences and the backward's
# own roundings (p and ds rounded to bf16 in the kernels, fp32 softmax
# gradient in dense) through 24 layers, held by relative L2
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 1e-1
TRAIN_CONFIG = "dlbb_tpu_torch/configs/train_1b_adam_bf16m.yaml"

MAIN_SHAPE = dict(b=8, n=16, kvh=16, s=512, sk=512, d=128, causal=True)
LONG_SHAPE = dict(b=1, n=16, kvh=16, s=8192, sk=8192, d=128, causal=True)
CASES = {
    "main_b8_n16_s512": MAIN_SHAPE,
    "gqa_kvh4": dict(b=2, n=16, kvh=4, s=512, sk=512, d=128, causal=True),
    "noncausal": dict(b=2, n=8, kvh=8, s=384, sk=384, d=128, causal=False),
    "ragged_s96": dict(b=2, n=4, kvh=4, s=96, sk=96, d=128, causal=True),
    "ragged_s96_d64": dict(b=2, n=4, kvh=2, s=96, sk=96, d=64, causal=True),
    "decode_s1_sk2048": dict(b=4, n=16, kvh=4, s=1, sk=2048, d=128, causal=True),
    "masked_rows_s200_sk72": dict(b=2, n=4, kvh=4, s=200, sk=72, d=128, causal=True),
}
# at the edges of the kernels' tiles: the forward's 128-row Q and 128-key
# K/V tiles, the dq kernel's 128-row Q and 64-key K/V tiles, the dk/dv
# kernel's 128-key blocks and 64-row Q tiles; B*N above 65535
EDGE_CASES = {
    "partial_q_tile_s320": dict(b=2, n=8, kvh=8, s=320, sk=320, d=128, causal=True),
    "ragged_s130_sk130": dict(b=2, n=4, kvh=4, s=130, sk=130, d=128, causal=True),
    "ragged_s130_noncausal_d64": dict(b=2, n=4, kvh=2, s=130, sk=130, d=64, causal=False),
    "gqa_g8_n16_kvh2": dict(b=2, n=16, kvh=2, s=512, sk=512, d=128, causal=True),
    "noncausal_s256_sk768": dict(b=2, n=8, kvh=8, s=256, sk=768, d=128, causal=False),
    "bn65600_s128_d64": dict(b=4100, n=16, kvh=16, s=128, sk=128, d=64, causal=True),
}
# the mma.sync forward kernel this design replaced, at the two timed shapes:
# phase 5 on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md's kernel table)
FWD_BEFORE_MS = {"main": 0.1259, "long": 2.5038}
PHASES = ("build", "fwd", "bwd", "e2e", "train", "time", "comm", "tp", "dtrain", "seq",
          "moe", "pipe", "compress", "bench", "kv", "serve", "fleet", "chaos", "plan",
          "analyze")
TP_CONFIG = "dlbb_tpu_torch/configs/baseline_config.yaml"
# the 3D sweep's LLM shapes (batch, seq, hidden) on the card: the largest is
# 1 GiB of bf16 per rank
COMM_SHAPES_3D = ((1, 2048, 2048), (8, 4096, 4096), (16, 8192, 4096))
# result JSON keys every sweep config must carry (the JAX runner's schema)
COMM_RESULT_KEYS = (
    "implementation", "mpi_implementation", "operation", "num_ranks",
    "num_elements", "dtype", "warmup_iterations", "measurement_iterations",
    "compile_seconds", "compile_cache_hit", "retries", "timing_mode",
    "timing_method", "timing_granularity", "forced_completion_s", "timings",
    "variant", "mesh_shape", "mesh_axis_names", "payload_bytes_per_rank",
    "timestamp", "system_info")


def _stopwatch():
    """The wall seconds since this call, as a function: a phase's or a
    job's span, its checks included, which is printed and not a
    measurement (so no timed region of the source lint)."""
    start = time.perf_counter()
    return lambda: time.perf_counter() - start


def _inputs(torch, shape, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*dims):
        return torch.randn(dims, generator=g, device="cuda", dtype=torch.bfloat16)

    q = randn(shape["b"], shape["n"], shape["s"], shape["d"])
    k = randn(shape["b"], shape["kvh"], shape["sk"], shape["d"])
    v = randn(shape["b"], shape["kvh"], shape["sk"], shape["d"])
    return q, k, v


def _time_ms(torch, fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_graph_ms(torch, fn, reps, per_graph=20):
    """Device time of one ``fn()`` from a CUDA graph of ``per_graph`` calls,
    replayed: the host's enqueue (Python checks, tensor-map encoding, the
    ctypes call; about 0.04 ms for the flash forward) drops out, where
    back-to-back calls timed by events measure it once it is as long as
    the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    ms = _time_ms(torch, graph.replay, max(1, reps // per_graph)) / per_graph
    del graph
    return ms


def _visible_pairs(shape):
    """The (row, key) pairs one head sees, counted row by row (the causal
    mask anchored at ``sk - s``)."""
    s, sk = shape["s"], shape["sk"]
    if shape["causal"]:
        return sum(min(sk, max(0, r + sk - s + 1)) for r in range(s))
    return s * sk


def _kernel_flops(shape, kernel):
    """The kernel's flops over the visible (row, key) pairs at ``shape``:
    4 D per pair for the forward (QK^T, PV), 6 D for dq (QK^T, dO V^T,
    dS K), 8 D for dk/dv (QK^T, dO V^T, P^T dO, dS^T Q)."""
    per_pair = {"fwd": 4, "dq": 6, "dkv": 8}[kernel] * shape["d"]
    return per_pair * _visible_pairs(shape) * shape["b"] * shape["n"]


def _bound(shape):
    """Least time for the flash forward at ``shape``: each of q, k, v read
    once, o and lse written once, over the memory rate; the QK^T and PV
    flops of the visible (row, key) pairs over the bf16 tensor rate."""
    b, n, kvh, s, sk, d = (shape[x] for x in ("b", "n", "kvh", "s", "sk", "d"))
    nbytes = 2 * (2 * b * n * s * d + 2 * b * kvh * sk * d) + 4 * b * n * s
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, _kernel_flops(shape, "fwd") / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build(build):
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {len(build.sources())} CUDA source(s) built and loaded in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s)")
    spills = []
    for src in build.sources():
        for line in build.ptxas_report(src.stem).splitlines():
            low = line.lower()
            if any(w in low for w in ("registers", "spill", "warning", "setmaxnreg", "wgmma")):
                print(f"[build] {src.stem}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append(f"{src.stem}: {line.strip()}")
    if spills:
        raise AssertionError("ptxas spilled registers: " + "; ".join(spills))
    fwd, bwd = _design(build, "flash_fwd"), _design(build, "flash_bwd")
    roles = (f"1 producer warpgroup at {fwd['producer_regs']} registers + 2 consumer "
             f"warpgroups at {fwd['consumer_regs']} (setmaxnreg)")
    print(f"[build] flash_fwd: {fwd['block_m']} query rows x {fwd['block_n']}-key tiles, "
          f"{fwd['stages']}-stage K and V rings, {roles}; ptxas registers at entry "
          f"{fwd['ptxas_registers']}; no spills")
    roles = (f"1 producer warpgroup at {bwd['producer_regs']} registers + 2 consumer "
             f"warpgroups at {bwd['consumer_regs']} (setmaxnreg)")
    print(f"[build] flash_bwd dq: {bwd['dq_block_m']} query rows per block, "
          f"{bwd['dq_block_n']}-key K/V tiles in a {bwd['dq_stages']}-stage ring; dk/dv: "
          f"{bwd['dkv_block_n']} keys per block, {bwd['dkv_block_m']}-row Q/dO tiles in a "
          f"{bwd['dkv_stages']}-stage ring; {roles}; ptxas registers at entry "
          f"{bwd['ptxas_registers']}; no spills")
    return fwd, bwd


def _design(build, stem):
    """A kernel source's design: its tile and warp-role constants as
    ``csrc/<stem>.cu`` declares them, and the registers ``ptxas`` gave each
    kernel built from it in this run, by kernel and head_dim."""
    src = (build.CSRC / f"{stem}.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    regs, kernel = {}, None
    for line in build.ptxas_report(stem).splitlines():
        m = re.search(r"Function properties for \w*?\d(flash_[a-z_]+?_kernel)ILi(\d+)E", line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            regs[kernel] = int(m.group(1))
    design = {"kind": "wgmma + TMA 3-D maps, 1 producer and 2 consumer warpgroups, "
                      "mbarrier rings (csrc/hopper.cuh)",
              "producer_regs": const["kProducerRegs"],
              "consumer_regs": const["kConsumerRegs"], "ptxas_registers": regs}
    if stem == "flash_fwd":
        design.update(block_m=const["kBlockM"], block_n=const["kBlockN"],
                      stages=const["kStages"])
    else:
        design.update(dq_block_m=const["kDqBlockM"], dq_block_n=const["kDqBlockN"],
                      dq_stages=const["kDqStages"], dkv_block_n=const["kDkvBlockN"],
                      dkv_block_m=const["kDkvBlockM"], dkv_stages=const["kDkvStages"])
    return design


def phase_kernel_vs_plain(torch, fa):
    worst_o = worst_lse = 0.0
    for i, (name, shape) in enumerate({**CASES, **EDGE_CASES}.items()):
        plan = fa.fwd_tile_plan(shape["s"], shape["sk"], causal=shape["causal"])
        visited = sum(len(v) for v, _ in plan)
        masked = sum(len(m) for _, m in plan)
        print(f"[kernel] flash_fwd {name}: {len(plan)} Q tile(s) per head, "
              f"{visited} K/V tiles visited, {masked} of them masked per element")
        q, k, v = _inputs(torch, shape, seed=100 + i)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=shape["causal"])
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal=shape["causal"])
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        print(f"[kernel] flash_fwd {name}: max|o - plain| {err_o:.3e} "
              f"(atol {O_ATOL} rtol {O_RTOL}), max|lse - plain| {err_lse:.3e} "
              f"(atol {LSE_ATOL})")
        torch.testing.assert_close(o.float(), o_ref.float(), atol=O_ATOL, rtol=O_RTOL)
        torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0.0)
        masked = max(0, shape["s"] - shape["sk"]) if shape["causal"] else 0
        if masked:
            if not bool((o[:, :, :masked] == 0).all()):
                raise AssertionError(f"{name}: fully masked rows are not exactly 0")
            if not bool((lse[:, :, :masked] <= fa.NEG_INF / 2).all()):
                raise AssertionError(f"{name}: fully masked rows' lse is not NEG_INF")
            print(f"[kernel] flash_fwd {name}: {masked} fully masked rows exactly 0")
        worst_o, worst_lse = max(worst_o, err_o), max(worst_lse, err_lse)
    return worst_o, worst_lse


def _bwd_bound(shape, kernel):
    """Least time for one backward kernel at ``shape``: q, k, v, dO, lse and
    delta read once and its outputs written once, over the memory rate; its
    flops (``_kernel_flops``) over the bf16 tensor rate."""
    b, n, kvh, s, sk, d = (shape[x] for x in ("b", "n", "kvh", "s", "sk", "d"))
    q_bytes, kv_bytes = 2 * b * n * s * d, 2 * b * kvh * sk * d
    nbytes = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * b * n * s
    nbytes += q_bytes if kernel == "dq" else 2 * kv_bytes
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, _kernel_flops(shape, kernel) / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_bwd_vs_plain(torch, fa):
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for i, (name, shape) in enumerate({**CASES, **EDGE_CASES}.items()):
        q, k, v = _inputs(torch, shape, seed=200 + i)
        causal = shape["causal"]
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        g = torch.Generator(device="cuda")
        g.manual_seed(300 + i)
        do = torch.randn(q.shape, generator=g, device="cuda", dtype=torch.bfloat16)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_bwd_reference(q, k, v, o, lse, do, causal=causal)
        parts = []
        for label, a, r in zip(("dq", "dk", "dv"), got, ref):
            a, r = a.float(), r.float()
            scale = r.abs().max().item()
            err = (a - r).abs().max().item()
            parts.append(f"{label} max|d| {err:.3e} (|plain| max {scale:.3e})")
            torch.testing.assert_close(a, r, atol=BWD_ATOL_REL * scale, rtol=BWD_RTOL)
            worst[label] = max(worst[label], err)
        print(f"[kernel] flash_bwd {name}: " + ", ".join(parts)
              + f" (atol {BWD_ATOL_REL} x max|plain|, rtol {BWD_RTOL})")
        masked = max(0, shape["s"] - shape["sk"]) if causal else 0
        if masked:
            if not bool((got[0][:, :, :masked] == 0).all()):
                raise AssertionError(f"{name}: fully masked rows' dq is not exactly 0")
            print(f"[kernel] flash_bwd {name}: {masked} fully masked rows' dq exactly 0")
        del q, k, v, o, lse, do, got, ref
    _empty_batch_check(torch, fa)
    return worst


def _empty_batch_check(torch, fa):
    """A dp rank with no rows of a micro-batch (``train/loop.py``) runs the
    step on an empty batch: the forward and backward through
    ``flash_attention`` on ``[0, N, S, D]`` give empty outputs and
    gradients and launch no kernel (a zero-size grid is a launch error)."""
    s = MAIN_SHAPE
    q, k, v = (torch.empty((0, s["n"], s["s"], s["d"]), device="cuda", dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    _zero_flash_counts(fa)
    o = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), grad_outputs=torch.empty_like(o))
    torch.cuda.synchronize()
    counts = _flash_counts(fa)
    print(f"[kernel] empty batch {tuple(q.shape)}: o {tuple(o.shape)}, grads "
          f"{[tuple(g.shape) for g in grads]}, launches {counts}")
    if o.shape != q.shape or any(g.shape != q.shape for g in grads):
        raise AssertionError("the flash path on an empty batch gave other shapes")
    if any(counts.values()):
        raise AssertionError(f"the flash path launched on an empty batch: {counts}")


def phase_main_path(torch, fa, gpu_line):
    from dlbb_tpu_torch.bench.e2e import run_e2e
    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params

    warmup, iters = 3, 10
    config = {
        "experiment": {"name": "chip_smoke_1b_full_s512"},
        "model": {"size": "1B", "attention": "full", "dtype": "bfloat16"},
        "parallelism": {"world_size": 1, "data_parallel": 1},
        "input": {"batch_size": 8, "sequence_length": 512, "seed": 42},
        "execution": {"warmup_iterations": warmup, "benchmark_iterations": iters},
    }
    model_cfg = ModelConfig.from_dict(config["model"])
    fa.flash_fwd_launches = 0
    result = run_e2e(config, device="cuda", verbose=True)
    launches = fa.flash_fwd_launches
    expected = model_cfg.num_layers * (warmup + iters)
    print(f"[e2e] flash_fwd launches over the run: {launches} "
          f"(expected {model_cfg.num_layers} layers x {warmup + iters} forwards "
          f"= {expected}); in the timed forwards: {result['flash_launches']}")
    if launches != expected or result["flash_launches"] != model_cfg.num_layers * iters:
        raise AssertionError("the main path did not run the flash kernel once per layer")
    ft = result["forward_time"]
    print(f"[e2e] 1B forward, bf16, B=8, S=512, attention=full on {gpu_line}: "
          f"mean {ft['mean'] * 1e3:.3f} ms, median {ft['median'] * 1e3:.3f} ms, "
          f"{result['tokens_per_second']:.0f} tokens/s, "
          f"{result['achieved_tflops_per_second']:.1f} TFLOP/s (model flops)")

    # the same parameters and batch through the kernel path and the dense path
    params = init_params(model_cfg, 42, "cuda")
    batch = create_dataset_from_config(
        config, dtype=torch.bfloat16, device="cuda",
        hidden_size=model_cfg.hidden_size).get_batch()
    with torch.inference_mode():
        y_full = forward(params, batch, model_cfg)
        y_dense = forward(params, batch, model_cfg.with_(attention="dense"))
    torch.cuda.synchronize()
    if y_full.shape != batch.shape or not bool(torch.isfinite(y_full).all()):
        raise AssertionError(f"1B forward output: shape {tuple(y_full.shape)}, "
                             "expected finite values of the input's shape")
    diff = (y_full.float() - y_dense.float())
    rel = (diff.norm() / y_dense.float().norm()).item()
    print(f"[e2e] kernel path vs dense path on the same weights: relative L2 "
          f"{rel:.3e} (tolerance {E2E_REL_L2}), max abs {diff.abs().max().item():.3e}, "
          f"output |y| max {y_dense.float().abs().max().item():.2f}")
    if not rel <= E2E_REL_L2:
        raise AssertionError("the kernel path disagrees with the dense path")
    # one traced forward, outside the timed run
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_",
                                     dir=Path(__file__).resolve().parent) as tmp, \
            torch.inference_mode():
        _traced_flash(torch, fa, "e2e_forward_1b", lambda _: forward(params, batch, model_cfg),
                      tmp, gpu_line, ("flash_fwd",))

    # phase analyze (d): the same forward once more under the collective
    # audit's capture
    def forward_once(p, x):
        with torch.inference_mode():
            return forward(p, x, model_cfg)

    _captured(torch, "e2e", "the 1B forward", forward_once, (params, batch),
              {"flash_fwd": model_cfg.num_layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    return launches, result


def phase_train(torch, fa, gpu_line):
    import shutil

    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.train.loop import mse_loss, run_train
    from dlbb_tpu_torch.train.optim import tree_leaves
    from dlbb_tpu_torch.utils.config import load_config

    config = load_config(TRAIN_CONFIG)
    model_cfg = ModelConfig.from_dict(config["model"])
    ex = config["execution"]
    steps = ex["warmup_iterations"] + ex["benchmark_iterations"]
    layers = model_cfg.num_layers
    # remat recomputes the flash forward in the backward: 2 per layer
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    from dlbb_tpu_torch.obs import spans

    run_dir = PLAN_OUT / "train"
    shutil.rmtree(run_dir, ignore_errors=True)
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = fa.flash_bwd_dkv_launches = 0
    with spans.tracing(run_dir / "spans.json", meta={"cmd": "train"}):
        result = run_train(config, device="cuda", output_dir=str(run_dir), verbose=True)
    launches = {"flash_fwd": fa.flash_fwd_launches,
                "flash_bwd_dq": fa.flash_bwd_dq_launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv_launches}
    print(f"[train] launches over the run ({steps} steps): {launches}; per timed "
          f"step: {result['kernel_launches_per_step']} (expected {per_step})")
    for name, n in per_step.items():
        if launches[name] != n * steps or result["kernel_launches_per_step"][name] != n:
            raise AssertionError(f"the train path did not launch {name} {n} times per step")
    losses = result["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train losses {losses}")
    st = result["step_time"]
    print(f"[train] 1B Adam step (bf16 moments, remat dots), bf16, B=8, S=512, "
          f"attention=full on {gpu_line}: mean {st['mean'] * 1e3:.3f} ms, median "
          f"{st['median'] * 1e3:.3f} ms, {result['tokens_per_second']:.0f} tokens/s, "
          f"{result['achieved_tflops_per_second']:.1f} TFLOP/s (model flops); "
          f"losses {', '.join(f'{x:.5f}' for x in losses)}")
    _train_attribution(run_dir, ex["benchmark_iterations"], gpu_line)

    # one step's loss and gradients, same weights and batch, kernel vs dense
    params = init_params(model_cfg, config["input"]["seed"], "cuda")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch, targets = (create_dataset_from_config(
        config, dtype=torch.bfloat16, device="cuda", hidden_size=model_cfg.hidden_size,
        seed_offset=off).get_batch() for off in (0, 1))

    def loss_and_grads(cfg):
        loss = mse_loss(params, batch, targets, cfg)
        return loss.item(), torch.autograd.grad(loss, leaves)

    before = fa.flash_bwd_dq_launches
    loss_k, grads_k = loss_and_grads(model_cfg)
    if fa.flash_bwd_dq_launches - before != layers:
        raise AssertionError("the kernel-path gradient did not run the dq kernel per layer")
    loss_d, grads_d = loss_and_grads(model_cfg.with_(attention="dense"))
    loss_rel = abs(loss_k - loss_d) / abs(loss_d)
    names = [f"{group}.{leaf}" for group, sub in params["layers"].items() for leaf in sub]
    names += [f"ln_f.{leaf}" for leaf in params["ln_f"]]
    rels = {}
    for name, gk, gd in zip(names, grads_k, grads_d):
        if not bool(torch.isfinite(gk).all()):
            raise AssertionError(f"non-finite kernel-path gradient {name}")
        rels[name] = ((gk.float() - gd.float()).norm() / gd.float().norm()).item()
    worst = max(rels, key=rels.get)
    print(f"[train] kernel path vs dense path, one step on the same weights: loss "
          f"{loss_k:.6f} vs {loss_d:.6f} (relative {loss_rel:.3e}, tolerance "
          f"{TRAIN_LOSS_REL}); gradient relative L2 per leaf: "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
          + f" (worst {worst}, tolerance {TRAIN_GRAD_REL_L2})")
    if not loss_rel <= TRAIN_LOSS_REL:
        raise AssertionError("the kernel-path loss disagrees with the dense path")
    if not rels[worst] <= TRAIN_GRAD_REL_L2:
        raise AssertionError(f"the kernel-path gradient {worst} disagrees with the dense path")
    # one traced step's loss and gradients, outside the timed run
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_",
                                     dir=Path(__file__).resolve().parent) as tmp:
        _traced_flash(torch, fa, "train_step_1b", lambda _: loss_and_grads(model_cfg), tmp,
                      gpu_line, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))

    # phase analyze (d): one Adam step of the same run under the collective
    # audit's capture, its parameters and moments updated in place
    from dlbb_tpu_torch.analysis.hlo_audit import _train_state_spec
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer

    del params, leaves, grads_k, grads_d
    step, state = make_train_step(model_cfg, build_optimizer(config["training"]),
                                  init_params(model_cfg, config["input"]["seed"], "cuda"),
                                  batch_size=config["input"]["batch_size"])
    new_state, loss = _captured(torch, "train", "one 1B Adam step", step,
                                (state, batch, targets), per_step, _train_state_spec())
    print(f"[train] (d) the captured step's loss {float(loss):.5f}, step {new_state.step}")
    return launches, result


def _captured(torch, phase, what, fn, args, want, state=None):
    """Phase analyze (d): ``fn(*args)`` once under the collective audit's
    capture (``analysis/op_capture.py``): no collective at world 1, the
    flash launches ``want`` by kernel, and with ``state`` the donation
    counterpart (every state tensor kept its storage).  (f): the schedule,
    memory and numerics passes over the same captured graph at tier
    ``cuda`` (``_graph_passes``).  Returns the call's result."""
    from dlbb_tpu_torch.analysis.op_capture import capture_call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out, cap = capture_call(fn, args, state=state, target=what)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    allocator = (resident, torch.cuda.max_memory_allocated())
    launches = {k[:-len("_launches")]: n for k, n in cap.flash_launches.items()}
    kept = (f"; {len(cap.state_before)} state tensors, every one kept its storage: "
            f"{cap.has_donation}" if state is not None else "")
    print(f"[{phase}] (d) {what} under the capture: {len(cap.collectives)} collectives, "
          f"flash launches {launches} (expected {want}), {len(cap.aten_ops)} aten ops"
          f"{kept}; {seconds:.1f} s")
    if cap.collectives or launches != want or (state is not None and not cap.has_donation):
        raise AssertionError(f"{what} under the capture: {[c.to_dict() for c in cap.collectives]}"
                             f", launches {launches}, in place {cap.has_donation}")
    _graph_passes(phase, what, cap, want, allocator)
    return out


def _graph_passes(phase, what, cap, want, allocator):
    """Phase analyze (f): the schedule, memory and numerics passes over one
    captured 1B call at tier ``cuda``: its flash kernels are nodes of the
    graph, one per launch; the static peak live bytes stay within the
    caching allocator's peak over the same call (``reset_peak_memory_stats``
    before it), and its rise above the call's arguments within the
    allocator's rise above what was resident."""
    from dlbb_tpu_torch.analysis.costmodel import resolve_tier
    from dlbb_tpu_torch.analysis.expectations import TargetExpectation
    from dlbb_tpu_torch.analysis.memory_audit import analyze_memory
    from dlbb_tpu_torch.analysis.numerics_audit import analyze_numerics
    from dlbb_tpu_torch.analysis.schedule_audit import analyze_schedule

    t0 = time.perf_counter()
    tier = resolve_tier("cuda")
    # no declared policy, as JAX's model and train targets declare none: the
    # step's optimizer rounds its Python constants through f64 scalars on
    # the host (``train/optim.py::_weak``), which a policy would flag
    exp = TargetExpectation()
    sf, sched = analyze_schedule(cap, exp, what, tier=tier)
    mf, mem = analyze_memory(cap, exp, what, tier=tier)
    nf, num = analyze_numerics(cap, exp, what, peak_live_bytes=mem["peak_live_bytes"])
    seconds = time.perf_counter() - t0
    nodes = {k: sum(1 for n in cap.nodes if n.op == f"flash::{k[len('flash_'):]}")
             for k in want}
    resident, peak = allocator
    static_rise = mem["peak_live_bytes"] - mem["parameter_bytes"]
    print(f"[{phase}] (f) {what}: {len(cap.nodes)} graph nodes, flash nodes {nodes} "
          f"(expected {want}); critical path {sched['critical_path_us']:.1f} us, "
          f"compute_total_us {sched['compute_total_us']:.1f}, comm {sched['comm_total_us']} us "
          f"at tier cuda; static peak_live_bytes {mem['peak_live_bytes']} vs allocator peak "
          f"{peak} (ratio {mem['peak_live_bytes'] / peak:.4f}), rise above the arguments "
          f"{static_rise} vs the allocator's {peak - resident} (ratio "
          f"{static_rise / max(peak - resident, 1):.4f}); numerics: "
          f"{num['reduction_sites']} sites, {num['numerics_low_precision_sites']} "
          f"low-precision, {num['numerics_convert_count']} converts, max bound "
          f"{num['numerics_max_rel_error_bound']:.3g}, fp dtypes {num['fp_dtypes']} (f64 "
          f"on {sum(1 for n in cap.nodes if any(t.dtype == 'f64' for t in n.outputs))} "
          f"nodes); "
          f"findings {[f.rule for f in sf + mf + nf]}; {seconds:.1f} s of passes")
    if nodes != want:
        raise AssertionError(f"{what}: the graph's flash nodes {nodes}, launches {want}")
    # each flash node's flops against this script's own row-by-row count
    for n in cap.nodes:
        if n.op.startswith("flash::"):
            q = next(r for r in n.reads if r.arg == "q")
            shape = {"b": q.shape[0], "n": q.shape[1], "s": q.shape[2], "d": q.shape[3],
                     "sk": n.args["sk"], "causal": n.args["causal"]}
            kernel = n.op.split("::", 1)[1].replace("bwd_", "")
            if n.flops != _kernel_flops(shape, kernel):
                raise AssertionError(f"{what}: node {n.index} ({n.op}) prices "
                                     f"{n.flops} flops, the row count gives "
                                     f"{_kernel_flops(shape, kernel)}")
    if mem["peak_live_bytes"] > peak or static_rise > peak - resident:
        raise AssertionError(f"{what}: static peak {mem['peak_live_bytes']} (rise "
                             f"{static_rise}) over the allocator's {peak} (rise "
                             f"{peak - resident})")
    if sched["compute_total_us"] <= 0 or [f for f in sf + mf + nf if f.severity == "error"]:
        raise AssertionError(f"{what}: {[f.render() for f in sf + mf + nf]}")


# phase train's run and phase plan's runs write under this directory
PLAN_OUT = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_plan"
# the phases of an attribution sum to its wall (a partition)
ATTR_REL = 1e-6


def _attribute(run_dir, out_dir, model="cm1", extra=()):
    """``cli obs attribute --tier cuda`` on ``run_dir``: its exit code, and
    for cm1 the record (the CLI writes only the MD and CSV; the record is
    the same call's)."""
    from dlbb_tpu_torch import cli
    from dlbb_tpu_torch.obs.attribution import run_attribution

    rc = cli.main(["obs", "attribute", "--journal", str(run_dir), "--tier", "cuda",
                   "--model", model, "--output", str(out_dir), *extra])
    if model != "cm1":
        return rc, None
    return rc, run_attribution(run_dir, out_dir=out_dir, tier="cuda", verbose=False)


def _check_partition(record, where):
    covered = sum(record["phases_us"].values())
    if not (record["wall_us"] > 0
            and abs(covered - record["wall_us"]) <= ATTR_REL * record["wall_us"]):
        raise AssertionError(f"{where}: phases cover {covered} us of a {record['wall_us']} "
                             "us wall")


def _train_attribution(run_dir, iterations, gpu_line):
    """Phase train (b): the 1B run's span trace holds JAX's train spans,
    and ``obs attribute`` partitions its wall with ``execute`` covering the
    ``train_step`` spans."""
    from dlbb_tpu_torch.obs.spans import load_trace, validate_trace_events

    t0 = time.perf_counter()
    events = load_trace(run_dir / "spans.json")["traceEvents"]
    problems = validate_trace_events(events)
    names = [ev["name"] for ev in events if ev["ph"] == "B"]
    steps = [ev.get("args", {}).get("step") for ev in events
             if ev["ph"] == "B" and ev["name"] == "train_step"]
    if problems or names.count("compile+warmup") != 1 or names.count("measure") != 1 \
            or steps != list(range(iterations)):
        raise AssertionError(f"the 1B run's span trace: {problems}, spans {names}")
    opened, step_us = {}, 0.0
    for ev in events:
        if ev["ph"] == "B":
            opened[ev["name"]] = ev["ts"]
        elif ev["ph"] == "E" and ev["name"] == "train_step":
            step_us += ev["ts"] - opened["train_step"]
    rc, record = _attribute(run_dir, PLAN_OUT / "attribution")
    _check_partition(record, "the 1B run's attribution")
    phases = record["phases_us"]
    if rc != 0 or record["source"] != "span-trace" or not phases.get("execute", 0) >= step_us:
        raise AssertionError(f"obs attribute on the 1B run: exit {rc}, {record['source']}, "
                             f"phases {phases}, train_step spans {step_us} us")
    print(f"[train] (b) span trace of the 1B run: compile+warmup, measure and "
          f"{len(steps)} train_step spans, valid; obs attribute (cm1, tier cuda) on "
          f"{gpu_line}: wall {record['wall_us'] / 1e3:.3f} ms = "
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in phases.items())
          + f" ms; train_step spans {step_us / 1e3:.3f} ms (host enqueue: the measure span "
          f"ends at the events' sync); {time.perf_counter() - t0:.1f} s")


def _sdpa_bwd_ms(torch, q, k, v, do, causal, reps):
    """SDPA's backward, by graph replay: the library's flash backward op
    alone, on the saved outputs of its flash forward op; and
    ``F.scaled_dot_product_attention`` with the backend it picks on this card
    (named in the result), as forward + backward less forward."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    aten = torch.ops.aten
    # (out, lse, cum_seq_q, cum_seq_k, max_q, max_k, rng seed, rng offset)
    saved = aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal, False)[:8]
    flash_ms = _time_graph_ms(torch, lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, *saved[:6], 0.0, causal, *saved[6:]), reps)

    backend = SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal)).name
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        torch.autograd.grad(out, (qg, kg, vg), do)

    default_ms = _time_graph_ms(torch, sdpa_fwd_bwd, reps) - _time_graph_ms(torch, sdpa_fwd, reps)
    return flash_ms, default_ms, backend


def _time_bwd(torch, fa, shape, reps, plain_reps):
    q, k, v = _inputs(torch, shape, seed=11)
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    do = torch.randn(q.shape, generator=g, device="cuda", dtype=torch.bfloat16)
    causal = shape["causal"]
    scale = 1.0 / math.sqrt(shape["d"])
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.flash_bwd_delta(o, do)
    fns = {"dq": lambda: fa._flash_bwd_dq_cuda(q, k, v, lse, do, delta, causal=causal,
                                                sm_scale=scale),
           "dkv": lambda: fa._flash_bwd_dkv_cuda(q, k, v, lse, do, delta, causal=causal,
                                                  sm_scale=scale)}
    times = {kernel: (_time_graph_ms(torch, fn, reps), _time_ms(torch, fn, reps))
             for kernel, fn in fns.items()}
    plain_ms = _time_ms(torch, lambda: fa.flash_bwd_reference(
        q, k, v, o, lse, do, causal=causal), plain_reps, warmup=1)
    sdpa_ms, default_ms, backend = _sdpa_bwd_ms(torch, q, k, v, do, causal, reps)
    label = "B={b} N={n} S={s} D={d}".format(**shape)
    out = {}
    for kernel, (ms, event_ms) in times.items():
        bound_ms, bound_by = _bwd_bound(shape, kernel)
        tflops = _kernel_flops(shape, kernel) / (ms * 1e-3) / 1e12
        out[kernel] = {"shape": label, "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
                       "library_ms": sdpa_ms, "sdpa_default_ms": default_ms,
                       "sdpa_default_backend": backend,
                       "bound_ms": bound_ms, "bound_by": bound_by, "tflops": tflops,
                       "bound_share": bound_ms / ms}
        print(f"[time] flash_bwd_{kernel} {label}: kernel {ms:.4f} ms by graph replay "
              f"({tflops:.1f} TFLOP/s, {bound_ms / ms:.1%} of the bound; {event_ms:.4f} ms "
              f"per call back to back, host enqueue included), bound {bound_ms:.4f} ms "
              f"({bound_by}); plain backward (dq, dk, dv) {plain_ms:.4f} ms; SDPA "
              f"backward (the pair) {sdpa_ms:.4f} ms (aten flash backward op alone), "
              f"{default_ms:.4f} ms with its default backend here, {backend} (forward + "
              "backward less forward), both by graph replay")
    return out


def phase_timing(torch, fa, shape, reps, before_ms):
    """``before_ms`` is the time PERF.md records for the kernel this design
    replaced, printed beside the new one and not put in the result."""
    import torch.nn.functional as F

    q, k, v = _inputs(torch, shape, seed=7)
    causal = shape["causal"]

    def kernel():
        fa.flash_attention_fwd(q, k, v, causal=causal)

    def library():
        F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    event_ms = _time_ms(torch, kernel, reps)
    ms = _time_graph_ms(torch, kernel, reps)
    plain_ms = _time_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, causal=causal),
                        max(1, reps // 4), warmup=1)
    library_ms = _time_graph_ms(torch, library, reps)
    bound_ms, bound_by = _bound(shape)
    tflops = _kernel_flops(shape, "fwd") / (ms * 1e-3) / 1e12
    label = "B={b} N={n} S={s} D={d}".format(**shape)
    print(f"[time] flash_fwd {label}: kernel {ms:.4f} ms by graph replay ({tflops:.1f} "
          f"TFLOP/s, {bound_ms / ms:.1%} of the bound; {event_ms:.4f} ms per call "
          f"back to back, host enqueue included), plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms by graph replay, bound {bound_ms:.4f} ms ({bound_by}); "
          f"the mma.sync kernel it replaced took {before_ms:.4f} ms (NVIDIA H100 80GB "
          f"HBM3, 700.00 W; PERF.md)")
    return {"shape": label, "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": tflops, "bound_share": bound_ms / ms}


def tp_bf16_bound(layers, tp):
    """Relative L2 bound of a bf16 forward at tp against the world-1 forward
    on the same card: each row-parallel product's fp32 sum is rounded to
    bf16 once at world 1, and at tp once per partial sum and once per
    addition of the all-reduce, tp - 1 extra roundings of at most 2**-8
    relative to the partials; two such products per layer add to the
    residual stream over ``layers`` layers.  Everything else (the column
    products, the flash kernel on each head, the LayerNorms) computes the
    same values at every tp."""
    return 2 * layers * (tp - 1) * 2.0**-8


def _tp_worker(configs):
    """One rank of phase ``tp``, in a process ``launch`` started: each
    config through ``run_e2e``, then its output through the same TP path
    for the check.  Returns (result, flash forward launches over the run,
    output on the host) per config."""
    from dlbb_tpu_torch.bench.e2e import run_e2e
    from dlbb_tpu_torch.ops import flash_attention as fa

    out = []
    for config in configs:
        fa.flash_fwd_launches = 0
        result = run_e2e(config, device="cuda", verbose=True)
        out.append((result, fa.flash_fwd_launches, _tp_output(config)))
    return out


def _tp_output(config, plan=None):
    """The TP forward's output on this rank, on the host; ``plan`` is the
    config's plan on the process group unless given (``_job_plan``)."""
    import torch

    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.parallel import ParallelismPlan

    model_cfg = ModelConfig.from_dict(config["model"])
    plan = plan or ParallelismPlan.from_config(config, model_cfg)
    coords = plan.mesh.coords
    params = init_params(model_cfg, config["input"]["seed"], "cuda",
                         tp_rank=coords["tp"], tp=plan.tp)
    batch = create_dataset_from_config(
        config, dtype=torch.bfloat16, device="cuda", hidden_size=model_cfg.hidden_size,
        dp_rank=coords["dp"], dp=plan.dp).get_batch()
    with torch.inference_mode():
        y = forward(params, batch, model_cfg, mesh=plan.mesh)
    return y.cpu()


def _tp_gloo_job(config, device):
    """Phase tp's job of the one gloo spawn: the 1B forward at tp=2 on the
    first two ranks, on the host; None past them."""
    from dlbb_tpu_torch.models import ModelConfig

    plan = _job_plan(config, ModelConfig.from_dict(config["model"]))
    return None if plan is None else _tp_output(config, plan)


# the script's one gloo spawn (``_run_gloo_jobs``): every phase's multi-rank
# runs, processes on the one card, a job at a time on the first ranks of the
# group (a spawn costs about 17 s before its ranks reach the card)
GLOO_WORLD = 8


def _gloo_job_bodies():
    """Each job kind's body, called as ``body(*args, device)`` on every rank
    of the spawn (its mesh is a collective call): the rank's result, None
    past the job's mesh."""
    return {"tp": _tp_gloo_job, "step": _dtrain_gloo_step, "reshard": _dtrain_reshard_steps,
            "uneven": _dtrain_uneven_run, "ckpt": _dtrain_ckpt_run, "seq": _seq_gloo_runs,
            "moe": _moe_ep_job, "pipe": _pipe_job, "compress_ring": _compress_ring_ops,
            "compress_train": _compress_train_runs, "analyze": _analyze_gloo_job}


def _analyze_gloo_job(device):
    """Phase analyze (c) and (e), a job of the one gloo spawn: the
    collective audit and the schedule, memory and numerics passes
    (``analysis/hlo_audit.py::run_hlo_audit``) over every default target,
    on every rank with the rank's tensors on ``device``, priced at the
    committed baselines' tier (``cpu-sim``); rank 0 returns its report and
    each target's meta, the others None."""
    import torch.distributed as dist

    from dlbb_tpu_torch.analysis.hlo_audit import default_targets, run_hlo_audit

    metas = {}
    report = run_hlo_audit(default_targets(), device=device, metas=metas,
                           passes=("hlo", "schedule", "memory", "numerics"), tier="cpu-sim")
    return (report.to_dict(), metas) if dist.get_rank() == 0 else None


def _gloo_ranks(rank, world, init_file, jobs, device, out_dir):
    """One rank of the one gloo spawn: each job ``(kind, *args)`` in turn,
    with its seconds in the rank; the ``(result, seconds)`` pairs, in job
    order, written to ``out_dir/r<rank>.pt``."""
    import torch

    from dlbb_tpu_torch.comm import destroy_distributed, initialize_distributed

    if device == "cuda":
        torch.cuda.set_device(0)
    initialize_distributed("gloo", rank, world, init_file, timeout=900)
    try:
        bodies, out = _gloo_job_bodies(), []
        for kind, *args in jobs:
            t0 = time.perf_counter()
            out.append((bodies[kind](*args, device), time.perf_counter() - t0))
            if device == "cuda":
                torch.cuda.empty_cache()
        torch.save(out, f"{out_dir}/r{rank}.pt")
    finally:
        destroy_distributed()


def _run_gloo_jobs(torch, jobs, device="cuda"):
    """Every phase's gloo jobs (``{phase: [job, ...]}``) in one spawn of
    ``GLOO_WORLD`` processes on cuda:0 (or on the CPU, to rehearse); returns
    ``{phase: [{"ranks": the results of the job's ranks, "seconds": rank
    0's time in it}, ...]}``.  Rank 0 is in every job's mesh, so it waits
    for no earlier job there, where a rank past the meshes waits in the
    next job's mesh for the ranks still at work."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    flat = [job for phase_jobs in jobs.values() for job in phase_jobs]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        mp.start_processes(_gloo_ranks, args=(GLOO_WORLD, os.path.join(tmp, "store"), flat,
                                              device, tmp),
                           nprocs=GLOO_WORLD, join=True, start_method="spawn")
        per_rank = [torch.load(os.path.join(tmp, f"r{r}.pt"), weights_only=False)
                    for r in range(GLOO_WORLD)]
    out, k = {}, 0
    for phase, phase_jobs in jobs.items():
        out[phase] = []
        for _ in phase_jobs:
            out[phase].append({"ranks": [r[k][0] for r in per_rank if r[k][0] is not None],
                               "seconds": per_rank[0][k][1]})
            k += 1
    return out


def _job_mesh(config, model_cfg):
    """A gloo spawn's mesh for one job of ``config``: its plan checked
    against its own rank count (``check_plan``) and laid over the first
    ranks of the world, so that one spawn serves jobs of several sizes; a
    collective call, every rank in the same order; None past the mesh."""
    import math

    from dlbb_tpu_torch.comm import build_parallelism_mesh
    from dlbb_tpu_torch.parallel.plan import check_plan, degrees

    dp, sp, pp, ep, tp = check_plan(config, model_cfg, math.prod(degrees(config)))
    return build_parallelism_mesh(dp, sp, pp, tp, ep)


def _job_plan(config, model_cfg):
    """``ParallelismPlan.from_config`` for a job of the one spawn: the plan
    of ``_job_mesh``'s mesh; None past the mesh."""
    from dlbb_tpu_torch.parallel.plan import ParallelismPlan, degrees, microbatches

    mesh = _job_mesh(config, model_cfg)
    return (None if mesh is None
            else ParallelismPlan(*degrees(config), microbatches(config, model_cfg), mesh))


# phase tp's gloo job: the 1B decoder at tp=2 (``_tp_gloo_job``)
TP_GLOO_CONFIG = {"experiment": {"name": "chip_smoke_1b_tp2_gloo"},
                  "model": {"size": "1B", "attention": "full", "dtype": "bfloat16"},
                  "parallelism": {"world_size": 2, "data_parallel": 1},
                  "input": {"batch_size": 8, "sequence_length": 512, "seed": 42}}


def phase_tp(torch, gpu_line, jobs):
    """Phase tp (module docstring); ``jobs``: its gloo job's results
    (``_run_gloo_jobs``)."""
    import copy

    from dlbb_tpu_torch.bench.launch import launch
    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.utils.config import load_config

    torch.cuda.empty_cache()
    base = load_config(TP_CONFIG)
    base["parallelism"]["world_size"] = 1
    ex = base["execution"]
    forwards = ex["warmup_iterations"] + ex["benchmark_iterations"]
    configs = []
    for attention in ("simplified", "full"):
        config = copy.deepcopy(base)
        config["model"]["attention"] = attention
        config["experiment"]["name"] = f"chip_smoke_7b_{attention}_world1"
        configs.append(config)
    t0 = time.perf_counter()
    runs = launch(_tp_worker, 1, "cuda", args=(configs,), timeout=900)[0]
    print(f"[tp] 7B world-1 TP runs through launch (NCCL): "
          f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for config, (result, launches, y) in zip(configs, runs):
        model_cfg = ModelConfig.from_dict(config["model"])
        attention, layers = model_cfg.attention, model_cfg.num_layers
        per_forward = layers if attention == "full" else 0
        if (launches != per_forward * forwards
                or result["flash_launches"] != per_forward * ex["benchmark_iterations"]):
            raise AssertionError(f"7B {attention}: {launches} flash launches over "
                                 f"{forwards} forwards, {result['flash_launches']} timed; "
                                 f"expected {per_forward} per forward")
        if result["mesh"] != {"dp": 1, "sp": 1, "pp": 1, "ep": 1, "tp": 1}:
            raise AssertionError(f"7B {attention}: mesh {result['mesh']}")
        if result["system_info"].get("comm_backend") != "nccl":
            raise AssertionError(f"7B {attention}: not run in an NCCL process group")
        params = init_params(model_cfg, config["input"]["seed"], "cuda")
        batch = create_dataset_from_config(
            config, dtype=torch.bfloat16, device="cuda",
            hidden_size=model_cfg.hidden_size).get_batch()
        with torch.inference_mode():
            ref = forward(params, batch, model_cfg)
        del params
        y = y.cuda()
        if y.shape != batch.shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"7B {attention}: output of shape {tuple(y.shape)}, "
                                 "expected finite values of the input's shape")
        if not torch.equal(y, ref):
            raise AssertionError(f"7B {attention}: the world-1 TP forward over NCCL is "
                                 "not equal to the forward with no process group")
        del y, ref, batch
        torch.cuda.empty_cache()
        ft = result["forward_time"]
        print(f"[tp] 7B forward, world 1 (NCCL, tp group of 1), bf16, B=8, S=512, "
              f"attention={attention} on {gpu_line}: mean {ft['mean'] * 1e3:.3f} ms, "
              f"median {ft['median'] * 1e3:.3f} ms, {result['tokens_per_second']:.0f} "
              f"tokens/s, {result['achieved_tflops_per_second']:.1f} TFLOP/s (model "
              f"flops); flash launches {launches} ({per_forward} per forward); equal "
              "to the forward with no process group, bit for bit")
        out[attention] = {"result": result, "launches": launches}

    # the 1B decoder at tp=2, two processes on the one card over gloo
    config = TP_GLOO_CONFIG
    model_cfg = ModelConfig.from_dict(config["model"])
    [job] = jobs
    ys = job["ranks"]
    if not torch.equal(ys[0], ys[1]):
        raise AssertionError("1B tp=2: the two ranks' outputs differ")
    params = init_params(model_cfg, 42, "cuda")
    one = copy.deepcopy(config)
    one["parallelism"]["world_size"] = 1
    batch = create_dataset_from_config(one, dtype=torch.bfloat16, device="cuda",
                                       hidden_size=model_cfg.hidden_size).get_batch()
    with torch.inference_mode():
        ref = forward(params, batch, model_cfg).float()
    y = ys[0].cuda().float()
    rel = ((y - ref).norm() / ref.norm()).item()
    bound = tp_bf16_bound(model_cfg.num_layers, 2)
    print(f"[tp] 1B forward at tp=2, two processes on one card over gloo (CUDA "
          f"tensors), attention=full: relative L2 against the world-1 forward "
          f"{rel:.3e} (bound {bound:.3e}), max abs {(y - ref).abs().max().item():.3e}; "
          f"{job['seconds']:.1f} s in the ranks, not timed")
    if not bool(torch.isfinite(y).all()) or not rel <= bound:
        raise AssertionError("the 1B tp=2 forward disagrees with the world-1 forward")
    del params, ref, y, ys
    torch.cuda.empty_cache()
    out["gloo_tp2_rel_l2"] = rel
    return out


# phase dtrain (b): the 1B train step sharded over two processes against the
# world-1 step on the same weights and global batch, both bf16 on the card,
# at the 1B's full width and DTRAIN_GLOO_LAYERS of its 24 layers (as phase
# seq (b)), so that the whole script keeps its time.
# - dp=2, stage 3: the same kernels on half the rows each, the gradients
#   summed by a bf16 reduce-scatter (one more rounding, 2**-8) and GEMMs that
#   may sum in another order at the other row count.  The kernel-vs-dense
#   bounds of phase 4 (TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2) hold two paths
#   that differ by far more (another attention arithmetic in all 24 layers),
#   so they bound this one at any depth up to 24.
# - tp=2, stage 1: the forward differs from the world-1 forward by at most
#   ``tp_bf16_bound`` (relative L2).  The loss moves by at most 2 ||dpred|| /
#   ||pred - targets|| relative, and ||pred|| <= ||pred - targets|| for these
#   independent targets of the same scale: 2 x ``tp_bf16_bound``.  Each
#   gradient carries the backward's own bf16 differences over the 24-layer
#   stack, which TRAIN_GRAD_REL_L2 bounds, plus the forward's, through the
#   activations it multiplies, at most their relative size, tp_bf16_bound.
DTRAIN_GLOO_RUNS = ((2, 1, 1), (1, 2, 3))  # (tp, dp, ZeRO stage)
DTRAIN_STAGES = (0, 1, 2, 3)
DTRAIN_CKPT_LAYERS = 2
DTRAIN_GLOO_LAYERS = 6


def dtrain_bounds(layers, tp):
    """(loss relative, gradient relative L2 per leaf) bounds of the sharded
    1B step against the world-1 step (comment above)."""
    if tp == 1:
        return TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2
    return 2 * tp_bf16_bound(layers, tp), TRAIN_GRAD_REL_L2 + tp_bf16_bound(layers, tp)


def _flash_counts(fa):
    return {"flash_fwd": fa.flash_fwd_launches, "flash_bwd_dq": fa.flash_bwd_dq_launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_launches}


def _zero_flash_counts(fa):
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = fa.flash_bwd_dkv_launches = 0


# the flash kernels' names in the card's traces, by launch counter
FLASH_KERNEL_NAMES = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
                      "flash_bwd_dkv": "flash_bwd_dkv_kernel"}
# the card's trace verdict, set by the first capture (True: CUPTI gave the
# kernels; False: it gave none and the captures fail closed)
CUPTI: dict[str, bool] = {}


def _cupti_verdict(metas, where):
    """Whether CUPTI served ``metas`` (device captures of one check): all
    of them parsed, or all failed closed for want of device events; a mix
    or another failure raises.  Prints the captures whose work left a
    launch unrecorded, and ``cupti: unavailable`` once."""
    failed = [m for m in metas if "error" in m]
    closed = [m for m in failed if "no device events" in m["error"]]
    if failed and len(closed) != len(metas):
        raise AssertionError(f"{where}: captures failed: "
                             f"{[(m['error'], m.get('device_records')) for m in failed]}")
    ok = not failed
    partial = [(m["label"], m["device_records"], m["attempts"]) for m in metas
               if (m.get("device_records") or {}).get("launches_without_record")]
    if ok and partial:
        # CUPTI's known loss (PERF.md §7): recorded in the meta, printed
        print(f"[trace] {where}: launches of the work left no record after the sessions "
              f"taken (census, sessions): {partial}")
    if CUPTI.setdefault("ok", ok) != ok:
        raise AssertionError(f"{where}: CUPTI served one capture and not another: "
                             f"{[(m['label'], m.get('device_records')) for m in metas]}")
    if not ok and not CUPTI.get("printed"):
        CUPTI["printed"] = True
        print(f"cupti: unavailable ({where}: {closed[0]['error']})")
    return ok


def _devtrace_rc(run_dir, out_dir, want_ok):
    """``obs devtrace`` on ``run_dir``: exit 0 where CUPTI served the
    captures, else exit 1 with the captures' "no device events" (JAX's
    fail-closed contract)."""
    from dlbb_tpu_torch.analysis.findings import EXIT_CLEAN, EXIT_FINDINGS
    from dlbb_tpu_torch.obs import run_obs

    rc = run_obs("devtrace", journal=str(run_dir), output=str(out_dir), verbose=False)
    report = json.loads((Path(out_dir) / f"{Path(run_dir).name}.json").read_text())
    if want_ok and rc != EXIT_CLEAN:
        raise AssertionError(f"obs devtrace on {run_dir} exited {rc}: {report['findings']}")
    if not want_ok and (rc != EXIT_FINDINGS or not any(
            "no device events" in f["message"] for f in report["findings"])):
        raise AssertionError(f"obs devtrace on {run_dir} did not fail closed: exit {rc}")
    return rc, report


def _bucket_line(analysis):
    return ", ".join(f"{b} {v:.1f}" for b, v in analysis["buckets_us"].items())


def _traced_flash(torch, fa, what, fn, trace_root, gpu_line, kernels, profile_reps=1):
    """One dedicated traced session of ``profile_reps`` calls of ``fn``
    (``obs/capture.py``), outside every timed run: the parsed trace must
    hold exactly as many events of each of ``kernels`` as its launch
    counter counted over the session (where CUPTI serves the card; else
    the capture fails closed, checked).  A capture that retakes its session
    (a launch left unrecorded) keeps the last session's trace, so the
    counts held against it are the sum of the last session's
    ``profile_reps`` calls.  Prints the device µs per bucket and the
    check's seconds."""
    from dlbb_tpu_torch.obs.capture import capture_device_trace
    from dlbb_tpu_torch.obs.devtrace import analyze_capture, parse_capture
    from dlbb_tpu_torch.utils.config import save_json

    elapsed = _stopwatch()
    calls = []

    def counted(x):
        before = _flash_counts(fa)
        out = fn(x)
        calls.append({k: v - before[k] for k, v in _flash_counts(fa).items()})
        return out

    meta = capture_device_trace(counted, lambda: None, trace_root, what,
                                profile_reps=profile_reps, device="cuda")
    launched = {k: sum(c[k] for c in calls[-profile_reps:]) for k in FLASH_KERNEL_NAMES}
    if not _cupti_verdict([meta], what):
        save_dir = Path(trace_root) / f"{what}_run"
        save_dir.mkdir(parents=True, exist_ok=True)
        save_json({"operation": what, "timings": [[0.0]], "device_trace": meta},
                  save_dir / f"{what}.json")
        _devtrace_rc(save_dir, Path(trace_root) / f"{what}_report", want_ok=False)
        print(f"[trace] {what}: the capture failed closed (no device events), obs devtrace "
              f"exit 1; flash launches {launched} in {elapsed():.1f} s")
        return launched
    analysis = analyze_capture(parse_capture(meta["perfetto_trace"]))
    events = {k: sum(r["count"] for r in analysis["per_op"] if FLASH_KERNEL_NAMES[k] in r["name"])
              for k in FLASH_KERNEL_NAMES}
    print(f"[trace] {what} on {gpu_line}: device us per bucket: {_bucket_line(analysis)}; "
          f"flash kernel events {events}, launch counters {launched}; "
          f"{sum(r['count'] for r in analysis['per_op'])} device events of "
          f"{len(analysis['per_op'])} names; {meta['trace_bytes']} trace bytes; "
          f"{meta['attempts']} session(s); {elapsed():.1f} s")
    for k in kernels:
        if launched[k] == 0 or events[k] != launched[k]:
            raise AssertionError(f"the traced {what}: {events[k]} {FLASH_KERNEL_NAMES[k]} "
                                 f"events, the counter counted {launched[k]} launches")
    return launched


def _dtrain_batch(config, model_cfg, device, coords=None, dp=1):
    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models.transformer import DTYPES

    coords = coords or {"dp": 0}
    return tuple(create_dataset_from_config(
        config, dtype=DTYPES[model_cfg.dtype], device=device, hidden_size=model_cfg.hidden_size,
        seed_offset=off, dp_rank=coords["dp"], dp=dp).get_batch() for off in (0, 1))


def _dtrain_world1(config, ckpt_dir, device="cuda"):
    """Phase dtrain (a), in the process ``launch`` started: a process group
    of one rank (NCCL on the card).  Returns what the parent checks."""
    import copy

    import torch

    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.parallel import ParallelismPlan
    from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from dlbb_tpu_torch.train.loop import make_train_step, run_train
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_leaves

    model_cfg = ModelConfig.from_dict(config["model"])
    seed = config["input"]["seed"]
    plan = ParallelismPlan.from_config(config, model_cfg)
    batch, targets = _dtrain_batch(config, model_cfg, device)
    out = {"comm_backend": torch.distributed.get_backend(), "stages": {}}

    def steps(cfg, mesh, stage, n=2):
        step, state = make_train_step(cfg, build_optimizer(config["training"]),
                                      init_params(cfg, seed, device), mesh=mesh,
                                      zero_stage=stage,
                                      batch_size=config["input"]["batch_size"])
        losses = []
        for _ in range(n):
            _zero_flash_counts(fa)
            state, loss = step(state, batch, targets)
            losses.append(float(loss))
        return losses, state, _flash_counts(fa), step

    ref_losses, ref_state, _, _ = steps(model_cfg, None, 0)
    for stage in DTRAIN_STAGES:
        t0 = time.perf_counter()
        losses, state, launches, _ = steps(model_cfg, plan.mesh, stage)
        equal = losses == ref_losses and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(state.params),
                                              tree_leaves(ref_state.params)))
        out["stages"][stage] = {"losses": losses, "equal": equal, "launches": launches,
                                "seconds": time.perf_counter() - t0}
        del state
        torch.cuda.empty_cache()
    out["ref_losses"] = ref_losses
    del ref_state
    torch.cuda.empty_cache()

    out["runs"] = []
    for stage, accum in ((1, 1), (2, 2)):
        cfg = copy.deepcopy(config)
        cfg["training"]["gradient_accumulation"] = accum
        cfg["experiment"]["name"] = f"chip_smoke_1b_train_zero{stage}_ga{accum}"
        _zero_flash_counts(fa)
        result = run_train(cfg, zero_stage=stage, device=device, verbose=True)
        out["runs"].append({"stage": stage, "accum": accum, "result": result,
                            "launches": _flash_counts(fa)})
        torch.cuda.empty_cache()

    # checkpoint round trip at full width, DTRAIN_CKPT_LAYERS layers
    cut = model_cfg.with_(num_layers=DTRAIN_CKPT_LAYERS)
    layout = {"mesh": plan.mesh_dict(), "zero_stage": 1}
    _, state, _, step = steps(cut, plan.mesh, 1, n=1)
    with Checkpointer(CheckpointConfig(ckpt_dir), layout=layout,
                      group=plan.mesh.group, device=device) as ckpt:
        ckpt.maybe_save(state, force=True)
        _, fresh, _, step2 = steps(cut, plan.mesh, 1, n=0)
        restored = ckpt.restore(fresh)
    resumed, loss_resumed = step2(restored, batch, targets)
    straight, loss_straight = step(state, batch, targets)
    out["ckpt"] = {
        "restored_step": restored.step,
        "equal": float(loss_resumed) == float(loss_straight) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params),
                                              tree_leaves(straight.params))),
        "bytes": sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*.pt")),
        "loss": float(loss_straight)}
    return out


def _dtrain_gloo_step(config, stage, device):
    """A rank's run of phase dtrain (b): the loss and reduced gradients of
    one step, then the step."""
    import torch

    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    model_cfg = ModelConfig.from_dict(config["model"])
    mesh = _job_mesh(config, model_cfg)
    if mesh is None:
        return None
    c = mesh.coords
    batch, targets = _dtrain_batch(config, model_cfg, device, c, mesh.shape["dp"])
    step, state = make_train_step(
        model_cfg, build_optimizer(config["training"]),
        init_params(model_cfg, config["input"]["seed"], device, tp_rank=c["tp"],
                    tp=mesh.shape["tp"]), mesh=mesh, zero_stage=stage,
        batch_size=config["input"]["batch_size"])
    elapsed = _stopwatch()
    loss, grads = step.grads(state, batch, targets)
    grads = tree_map(lambda g: g.cpu(), grads)
    state, step_loss = step(state, batch, targets)
    return {"coords": c, "loss": float(loss), "step_loss": float(step_loss),
            "grads": grads, "axes": step.zero.opt_axes, "seconds": elapsed()}


# phase dtrain (b), tp that does not divide the heads (item 20): JAX's
# (hidden 96, 6 heads, FFN 384) at tp=4 has a head of 16, which the flash
# kernel does not take (``KERNEL_HEAD_DIMS``), so the card runs its ratios
# at head_dim 64: hidden 384, 6 heads, FFN 1536, at the 1B train config's
# depth in (b), B=8, S=512, "full" (the flash kernel).  Each rank gathers
# the qkv activations over tp and attends over the 2 heads its 96 features
# overlap: one flash forward launch per layer per rank, twice under remat
# "dots" in a step, one dq and one dk/dv.  Against the world-1 forward and
# step on the same weights: the column shards give the same products and
# the row-parallel partial sums round as at any tp=4, ``tp_bf16_bound`` and
# ``dtrain_bounds`` at tp=4.
DTRAIN_UNEVEN_MODEL = {"hidden_size": 384, "num_heads": 6, "ffn_intermediate": 1536}
DTRAIN_UNEVEN_TP = 4


def _dtrain_uneven_run(config, stage, device):
    """A rank's run of phase dtrain (b)'s uneven heads: the forward
    (inference), one step's loss and reduced gradients, then the step, with
    the flash launches of each counted from 0."""
    import torch

    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    model_cfg = ModelConfig.from_dict(config["model"])
    mesh = _job_mesh(config, model_cfg)
    if mesh is None:
        return None
    elapsed = _stopwatch()
    c = mesh.coords
    params = init_params(model_cfg, config["input"]["seed"], device, tp_rank=c["tp"],
                         tp=mesh.shape["tp"])
    batch, targets = _dtrain_batch(config, model_cfg, device, c, mesh.shape["dp"])
    _zero_flash_counts(fa)
    with torch.inference_mode():
        y = forward(params, batch, model_cfg, mesh=mesh).float().cpu()
    fwd_launches = _flash_counts(fa)
    step, state = make_train_step(model_cfg, build_optimizer(config["training"]), params,
                                  mesh=mesh, zero_stage=stage,
                                  batch_size=config["input"]["batch_size"])
    _zero_flash_counts(fa)
    loss, grads = step.grads(state, batch, targets)
    step_launches = _flash_counts(fa)
    state, step_loss = step(state, batch, targets)
    return {"coords": c, "y": y, "loss": float(loss), "step_loss": float(step_loss),
            "grads": tree_map(lambda g: g.cpu(), grads), "fwd_launches": fwd_launches,
            "step_launches": step_launches, "seconds": elapsed()}


def _state_cpu(state):
    """A train state's tensors on the host, by path (``params/...``,
    ``opt/...``)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, tuple):
            for k, v in zip(getattr(node, "_fields", range(len(node))), node):
                walk(v, f"{path}/{k}")
        elif hasattr(node, "detach"):
            out[path] = node.detach().cpu()

    walk(state.params, "params")
    walk(state.opt_state, "opt")
    return out


def _gather_dp_state(torch, snaps, param_axes, opt_axes):
    """The dp ranks' ``_state_cpu`` snapshots, by dp rank, joined: a
    parameter (moment) leaf along its ``param_axes`` (``opt_axes``) entry
    where it names a dp axis, else dp rank 0's."""
    def axis(axes, path):
        parts = path.split("/")
        if "layers" in parts:
            i = len(parts) - 1 - parts[::-1].index("layers")
            return axes["layers"][parts[i + 1]][parts[i + 2]]
        if "ln_f" in parts:
            return axes["ln_f"][parts[-1]]
        return None

    out = {}
    for path, t in snaps[0].items():
        ax = axis(param_axes if path.startswith("params/") else opt_axes, path)
        out[path] = t if ax is None or len(snaps) == 1 else torch.cat(
            [snap[path] for snap in snaps], ax)
    return out


def _dtrain_ckpt_run(config, stage, device):
    """A rank's run of phase dtrain (b)'s checkpoint across layouts (item
    20): one step at ZeRO-``stage`` on the config's dp, saved, and the
    uninterrupted second step; then a fresh ZeRO-3 state on the same dp
    restored from the save, and its next step."""
    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer, train_layout
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer

    model_cfg = ModelConfig.from_dict(config["model"])
    mesh = _job_mesh(config, model_cfg)
    if mesh is None:
        return None
    t0 = time.perf_counter()
    ckpt = CheckpointConfig(config["training"]["checkpoint"]["directory"])
    batch, targets = _dtrain_batch(config, model_cfg, device, mesh.coords, mesh.shape["dp"])
    out = {"coords": mesh.coords}
    for z in (stage, 3):
        step, state = make_train_step(
            model_cfg, build_optimizer(config["training"]),
            init_params(model_cfg, config["input"]["seed"], device), mesh=mesh, zero_stage=z,
            batch_size=config["input"]["batch_size"])
        layout = train_layout(model_cfg, mesh.shape, z, mesh.spec.num_ranks)
        with Checkpointer(ckpt, layout=layout, group=mesh.group) as ck:
            if z == stage:
                state, _ = step(state, batch, targets)
                ck.maybe_save(state, force=True)
            else:
                state = ck.restore(state)
        out[z] = {"state": _state_cpu(state), "step": state.step,
                  "axes": (step.zero.param_axes, step.zero.opt_axes),
                  "next_loss": float(step(state, batch, targets)[1])}
        del step, state
    out["seconds"] = time.perf_counter() - t0
    return out


def _dtrain_uneven_config(config):
    """Phase dtrain (b)'s uneven heads on ``config``'s depth: its job's
    config."""
    import copy

    cfg = copy.deepcopy(config)
    cfg["model"].update(DTRAIN_UNEVEN_MODEL)
    cfg["parallelism"] = {"world_size": DTRAIN_UNEVEN_TP, "data_parallel": 1}
    return cfg


def _dtrain_uneven_ref(torch, cfg, device):
    """The uneven heads' world-1 forward and step's loss and gradients with
    no process group: what ``_dtrain_uneven_check`` holds the ranks
    against."""
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer

    model_cfg = ModelConfig.from_dict(cfg["model"])
    params = init_params(model_cfg, cfg["input"]["seed"], device)
    batch, targets = _dtrain_batch(cfg, model_cfg, device)
    _zero_flash_counts(fa)
    with torch.inference_mode():
        y = forward(params, batch, model_cfg).float()
    launches = _flash_counts(fa)
    step, state = make_train_step(model_cfg, build_optimizer(cfg["training"]), params,
                                  batch_size=cfg["input"]["batch_size"])
    loss, grads = step.grads(state, batch, targets)
    return {"cfg": model_cfg, "y": y, "loss": float(loss), "grads": grads,
            "launches": launches}


def _dtrain_uneven_check(torch, ref, ranks):
    """The uneven-heads ranks against the world-1 forward and step."""
    from dlbb_tpu_torch.models.sharding import unshard_params

    model_cfg, layers = ref["cfg"], ref["cfg"].num_layers
    recs = sorted(ranks, key=lambda r: r["coords"]["tp"])
    device = ref["y"].device
    want_fwd = {"flash_fwd": layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    want_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    if device.type != "cuda":  # attention runs dense on the CPU: no kernel launches
        want_fwd = want_step = dict.fromkeys(want_fwd, 0)
    fwd_rel = max(_rel_l2(r["y"].to(device), ref["y"]) for r in recs)
    got = _by_name(unshard_params([r["grads"] for r in recs], model_cfg))
    rels = {n: _rel_l2(got[n].to(g.device), g) for n, g in _by_name(ref["grads"]).items()}
    worst = max(rels, key=rels.get)
    loss_rel = abs(recs[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    fwd_bound = tp_bf16_bound(layers, DTRAIN_UNEVEN_TP)
    loss_bound, grad_bound = dtrain_bounds(layers, DTRAIN_UNEVEN_TP)
    print(f"[dtrain] uneven heads: hidden {model_cfg.hidden_size}, {model_cfg.num_heads} heads "
          f"of {model_cfg.head_dim}, FFN {model_cfg.ffn_intermediate}, {layers} layers, bf16, "
          f"at tp={DTRAIN_UNEVEN_TP} (tp does not divide the heads), {len(recs)} processes on "
          f"one card over gloo: forward relative L2 against world 1 {fwd_rel:.3e} (bound "
          f"{fwd_bound:.3e}); step loss {recs[0]['loss']:.6f} vs world 1 {ref['loss']:.6f} "
          f"(relative {loss_rel:.3e}, bound {loss_bound:.3e}); gradient relative L2 worst "
          f"{worst} {rels[worst]:.3e} (bound {grad_bound:.3e}); flash launches per rank: "
          f"forward {[r['fwd_launches'] for r in recs]} (world 1 {ref['launches']}), step "
          f"{recs[0]['step_launches']}; {max(r['seconds'] for r in recs):.1f} s in the ranks, "
          "not timed")
    if any(r["fwd_launches"] != want_fwd or r["step_launches"] != want_step for r in recs):
        raise AssertionError(f"uneven heads: flash launches per rank, expected {want_fwd} "
                             f"(forward) and {want_step} (step)")
    if len({r["loss"] for r in recs}) != 1 or not (
            fwd_rel <= fwd_bound and loss_rel <= loss_bound and rels[worst] <= grad_bound
            and all(math.isfinite(r["step_loss"]) for r in recs)):
        raise AssertionError("the uneven-heads tp=4 run disagrees with world 1")
    return {"fwd_rel_l2": fwd_rel, "loss_rel": loss_rel, "worst_grad_rel_l2": rels[worst],
            "worst_leaf": worst, "fwd_launches": recs[0]["fwd_launches"],
            "step_launches": recs[0]["step_launches"]}


def _dtrain_ckpt_check(torch, config, ranks, device):
    """The checkpoint saved at ZeRO-1 on dp=2, restored onto ZeRO-3 on dp=2
    by the ranks and onto world 1 here: each restored state, gathered,
    bit-equal to the saved one; the restored next step's loss against the
    uninterrupted second step's (equal at ZeRO-3 on the same dp: the same
    parameters and rows; at world 1 within ``dtrain_bounds`` at tp=1, the
    same rows in one group)."""
    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer, train_layout
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer

    model_cfg = ModelConfig.from_dict(config["model"])
    by = {r["coords"]["dp"]: r for r in ranks}
    snaps = [by[i] for i in range(len(by))]

    def gathered(z):
        return _gather_dp_state(torch, [r[z]["state"] for r in snaps], *snaps[0][z]["axes"])

    saved, zero3 = gathered(1), gathered(3)
    step, state = make_train_step(model_cfg, build_optimizer(config["training"]),
                                  init_params(model_cfg, config["input"]["seed"], device),
                                  batch_size=config["input"]["batch_size"])
    with Checkpointer(CheckpointConfig(config["training"]["checkpoint"]["directory"]),
                      layout=train_layout(model_cfg, {}, 0, 1)) as ck:
        state = ck.restore(state)
    world1 = _state_cpu(state)
    batch, targets = _dtrain_batch(config, model_cfg, device)
    w1_loss = float(step(state, batch, targets)[1])
    del step, state
    uninterrupted = snaps[0][1]["next_loss"]
    same = {name: set(got) == set(saved) and all(torch.equal(got[k], saved[k]) for k in saved)
            for name, got in (("ZeRO-3 dp=2", zero3), ("world 1", world1))}
    w1_rel = abs(w1_loss - uninterrupted) / abs(uninterrupted)
    bound = dtrain_bounds(model_cfg.num_layers, 1)[0]
    print(f"[dtrain] checkpoint across layouts (1B, {model_cfg.num_layers} layers, Adam bf16 "
          f"moments, {len(saved)} state tensors): saved at ZeRO-1 on dp=2 at step 1; restored "
          f"onto ZeRO-3 on dp=2 (step {snaps[0][3]['step']}) and onto world 1, the gathered "
          f"state bit-equal to the saved one: {same}; next step's loss: uninterrupted "
          f"{uninterrupted:.6f}, ZeRO-3 {snaps[0][3]['next_loss']:.6f}, world 1 {w1_loss:.6f} "
          f"(relative {w1_rel:.3e}, bound {bound:.3e}); "
          f"{max(r['seconds'] for r in ranks):.1f} s in the ranks")
    if not all(same.values()) or snaps[0][3]["step"] != 1 or not all(
            r[3]["next_loss"] == uninterrupted for r in snaps) or w1_rel > bound:
        raise AssertionError("the checkpoint restored onto another layout disagrees")
    return {"bit_equal": same, "world1_loss_rel": w1_rel}


# phase dtrain (b), the resharded micro-batch: batch 6 in 2 micro-batches of
# 3 rows at dp=2 (2 rows of each on rank 0, 1 on rank 1), ZeRO-2 (each
# micro-step's gradient reduce-scattered, each rank's loss weighted by its
# share of the rows), two steps, against the world-1 step with no process
# group on the same global batch and accumulation.  The two runs sum the
# same rows in other groupings, as the dp=2 run above does, so the same
# bounds hold (dtrain_bounds at tp=1): each step's loss and the first
# step's reduced gradient per leaf.  The parameters after the first step
# are held as phase pipe holds its updates (the first Adam step from the
# start on the rank's own reduced gradient, ``_adam_first_step_misses``,
# argued at ``PIPE_*``), and the ranks' parameters after both steps must be
# equal bit for bit (ZeRO-2 gathers one update).
DTRAIN_RESHARD = dict(batch=6, grad_accum=2, dp=2, stage=2, steps=2)


def _dtrain_reshard_steps(config, stage, device):
    """A rank's run of phase dtrain (b)'s resharded case: the step built
    (JAX's warning recorded), the first step's loss and reduced gradients,
    then two steps with the flash kernels' counts set to 0 just before and
    read just after."""
    import warnings

    import torch

    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.models.sharding import batch_spec
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.train.loop import make_train_step, step_chunks
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    r = DTRAIN_RESHARD
    model_cfg = ModelConfig.from_dict(config["model"])
    mesh = _job_mesh(config, model_cfg)
    if mesh is None:
        return None
    x, t = (create_dataset_from_config(
        config, dtype=torch.bfloat16, device=device, hidden_size=model_cfg.hidden_size,
        seed_offset=off, **batch_spec(mesh, step_chunks(r["grad_accum"], None))).get_batch()
        for off in (0, 1))
    elapsed = _stopwatch()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step, state = make_train_step(
            model_cfg, build_optimizer(config["training"]),
            init_params(model_cfg, config["input"]["seed"], device), mesh=mesh,
            zero_stage=stage, grad_accum=r["grad_accum"], batch_size=r["batch"])
    loss0, grads = step.grads(state, x, t)
    grads = tree_map(lambda g: g.cpu(), grads)
    _zero_flash_counts(fa)
    losses, params = [], []
    for _ in range(r["steps"]):
        state, loss = step(state, x, t)
        losses.append(float(loss))
        params.append(tree_map(lambda p: p.detach().cpu(), state.params))
    return {"coords": mesh.coords, "rows": x.shape[0], "loss0": float(loss0),
            "warnings": [str(w.message) for w in caught
                         if issubclass(w.category, UserWarning)],
            "grads": grads, "axes": step.zero.opt_axes, "losses": losses,
            "launches": _flash_counts(fa), "params": params,
            "seconds": elapsed()}


def _dtrain_reshard_config(config):
    """Phase dtrain (b)'s resharded case on ``config`` (the 1B train config
    at ``DTRAIN_GLOO_LAYERS`` layers): its job's config."""
    import copy

    r = DTRAIN_RESHARD
    cfg = copy.deepcopy(config)
    cfg["input"]["batch_size"] = r["batch"]
    cfg["training"]["gradient_accumulation"] = r["grad_accum"]
    cfg["parallelism"] = {"world_size": 1, "data_parallel": r["dp"]}
    return cfg


def _dtrain_reshard_ref(torch, cfg, device):
    """The resharded case's world-1 steps with no process group: what
    ``_dtrain_reshard_check`` holds the ranks against."""
    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    r = DTRAIN_RESHARD
    model_cfg = ModelConfig.from_dict(cfg["model"])
    layers = model_cfg.num_layers
    # remat "dots": the forward runs twice a micro-step (phase 4); none on the CPU
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    if device != "cuda":
        per_step = dict.fromkeys(per_step, 0)
    p0 = init_params(model_cfg, cfg["input"]["seed"], device)
    step, state = make_train_step(model_cfg, build_optimizer(cfg["training"]),
                                  tree_map(torch.clone, p0), grad_accum=r["grad_accum"],
                                  batch_size=r["batch"])
    batch, targets = _dtrain_batch(cfg, model_cfg, device)
    ref_loss0, ref_grads = step.grads(state, batch, targets)
    ref_losses = []
    for i in range(r["steps"]):
        state, loss = step(state, batch, targets)
        ref_losses.append(float(loss))
        if i == 0:
            ref_p1 = tree_map(lambda p: p.detach().clone(), state.params)
    del step, state
    return {
        "cfg": cfg, "layers": layers, "per_step": per_step, "p0": p0,
        "ref_loss0": ref_loss0, "ref_grads": ref_grads, "ref_losses": ref_losses,
        "ref_p1": ref_p1}


def _dtrain_reshard_check(torch, ref, ranks, wall):
    """The resharded case's ranks (``_dtrain_reshard_steps``) against
    ``_dtrain_reshard_ref``'s world-1 steps; returns its errors."""
    from dlbb_tpu_torch.data.synthetic import dp_rows
    from dlbb_tpu_torch.train import zero as zero_mod

    r = DTRAIN_RESHARD
    cfg, per_step, p0 = ref["cfg"], ref["per_step"], ref["p0"]
    ref_loss0, ref_grads, ref_losses, ref_p1 = (ref[k] for k in (
        "ref_loss0", "ref_grads", "ref_losses", "ref_p1"))
    by = {x["coords"]["dp"]: x for x in ranks}
    grads = zero_mod.unshard_tree([by[i]["grads"] for i in range(r["dp"])], by[0]["axes"])
    got_g, p0 = _by_name(grads), _by_name(p0)
    g_rel = {n: _rel_l2(got_g[n].to(g.device), g) for n, g in _by_name(ref_grads).items()}
    lr = cfg["training"]["learning_rate"]
    ref_g, ref_p1 = _by_name(ref_grads), _by_name(ref_p1)
    ref_misses = sum(_adam_first_step_misses(torch, p0[n], ref_p1[n], ref_g[n], lr)[0]
                     for n in p0)
    got_p1 = _by_name(by[0]["params"][0])
    misses = sum(_adam_first_step_misses(torch, p0[n], got_p1[n], got_g[n], lr)[0]
                 for n in p0)
    same_params = all(torch.equal(a, b) for step_a, step_b in zip(by[0]["params"],
                                                                  by[1]["params"])
                      for a, b in zip(_by_name(step_a).values(), _by_name(step_b).values()))
    micro = r["batch"] // r["grad_accum"]
    want_launches = {}
    for i in range(r["dp"]):
        n = dp_rows(micro, i, r["dp"])[1]
        want_launches[i] = {k: r["steps"] * r["grad_accum"] * v * (n > 0)
                            for k, v in per_step.items()}
    warned = [x["warnings"] for x in ranks]
    print(f"[dtrain] resharded micro-batches: JAX's warning, once per rank's step: "
          f"{warned[0][0] if warned[0] else None!r}")
    loss_bound, grad_bound = dtrain_bounds(ref["layers"], 1)
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip([ranks[0]["loss0"]] + ranks[0]["losses"], [float(ref_loss0)] + ref_losses))
    worst_g = max(g_rel, key=g_rel.get)
    print(f"[dtrain] 1B step ({ref['layers']} of its 24 layers), batch {r['batch']} in "
          f"{r['grad_accum']} micro-batches of {micro} rows at dp={r['dp']} (rows per rank "
          f"{[by[i]['rows'] for i in range(r['dp'])]}), ZeRO-{r['stage']}, two processes on one "
          f"card over gloo, {r['steps']} steps: losses {ranks[0]['losses']} vs world 1 "
          f"{ref_losses} (first step's loss {ranks[0]['loss0']:.6f} vs {float(ref_loss0):.6f}; "
          f"worst relative {loss_rel:.3e}, bound {loss_bound:.3e}); reduced gradient relative "
          f"L2 worst {worst_g} {g_rel[worst_g]:.3e} (bound {grad_bound:.3e}); parameters "
          f"after the first step off the first Adam step of their gradient {misses} (bound "
          f"0; world 1's {ref_misses}); the ranks' parameters after each step equal bit for "
          f"bit: {same_params}; flash launches by rank "
          f"{[by[i]['launches'] for i in range(r['dp'])]} (expected {want_launches}); "
          f"{max(x['seconds'] for x in ranks):.1f} s in the ranks ({wall:.1f} s for the job "
          f"in the gloo spawn), not timed")
    if not all(len(w) == 1 and "not divisible by dp=2; each micro-step reshards" in w[0]
               and "results/torch/parallelism/" in w[0] for w in warned):
        raise AssertionError(f"the resharded step did not warn once with JAX's text: {warned}")
    if any(by[i]["launches"] != want_launches[i] for i in range(r["dp"])):
        raise AssertionError("the resharded step's flash launches do not follow its rows")
    if not (len({tuple(x["losses"]) for x in ranks}) == 1 and same_params
            and loss_rel <= loss_bound and g_rel[worst_g] <= grad_bound
            and misses == ref_misses == 0 and all(math.isfinite(x) for x in ref_losses)):
        raise AssertionError("the resharded 1B step disagrees with the world-1 step")
    return {"loss_rel": loss_rel, "worst_grad_rel_l2": g_rel[worst_g],
            "update_misses": misses, "wall_s": wall,
            "launches": {i: by[i]["launches"] for i in range(r["dp"])}}


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _dtrain_gloo_jobs(job_dir, config=None):
    """Phase dtrain (b)'s gloo jobs, from the configs alone (the one spawn
    runs before the phase): the sharded steps (``DTRAIN_GLOO_RUNS``), the
    resharded micro-batches, the uneven heads and the checkpoint restored
    onto other layouts (saved under ``job_dir``), on ``config`` (the 1B
    train config by default) at ``DTRAIN_GLOO_LAYERS`` layers."""
    import copy
    import os

    from dlbb_tpu_torch.models import ModelConfig
    from dlbb_tpu_torch.utils.config import load_config

    config = copy.deepcopy(config or load_config(TRAIN_CONFIG))
    layers = ModelConfig.from_dict(config["model"]).num_layers
    config["model"]["num_layers"] = min(layers, DTRAIN_GLOO_LAYERS)
    jobs = []
    for tp, dp, stage in DTRAIN_GLOO_RUNS:
        cfg = copy.deepcopy(config)
        cfg["parallelism"] = {"world_size": tp, "data_parallel": dp}
        jobs.append(("step", cfg, stage))
    ckpt_cfg = copy.deepcopy(config)
    ckpt_cfg["model"]["num_layers"] = min(layers, DTRAIN_CKPT_LAYERS)
    ckpt_cfg["parallelism"] = {"world_size": 1, "data_parallel": 2}
    ckpt_cfg["training"]["checkpoint"] = {"directory": os.path.join(job_dir, "dtrain_ckpt")}
    return jobs + [("reshard", _dtrain_reshard_config(config), DTRAIN_RESHARD["stage"]),
                   ("uneven", _dtrain_uneven_config(config), 0), ("ckpt", ckpt_cfg, 1)]


def phase_dtrain(torch, gpu_line, jobs, results, config=None, device="cuda"):
    """Phase 8 (module docstring).  ``jobs`` and ``results``: (b)'s gloo
    jobs (``_dtrain_gloo_jobs``) and their results (``_run_gloo_jobs``).
    ``config`` and ``device`` default to the 1B train config on the card; a
    smaller config on the CPU rehearses the phase's control flow."""
    import copy
    import tempfile

    from dlbb_tpu_torch.bench.launch import launch
    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.models.sharding import unshard_params
    from dlbb_tpu_torch.train import zero as zero_mod
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map
    from dlbb_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.empty_cache()
    config = config or load_config(TRAIN_CONFIG)
    model_cfg = ModelConfig.from_dict(config["model"])
    layers = model_cfg.num_layers
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    if device != "cuda":  # attention runs dense on the CPU: no kernel launches
        per_step = dict.fromkeys(per_step, 0)

    # (a) world 1 over NCCL, through launch
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        t0 = time.perf_counter()
        a = launch(_dtrain_world1, 1, device, args=(config, ckpt_dir, device),
                   timeout=900)[0]
        print(f"[dtrain] world 1 over {a['comm_backend']} through launch: "
              f"{time.perf_counter() - t0:.1f} s")
    if device == "cuda" and a["comm_backend"] != "nccl":
        raise AssertionError(f"world-1 training ran over {a['comm_backend']}, not NCCL")
    for stage, r in a["stages"].items():
        print(f"[dtrain] ZeRO-{stage}, world 1, two 1B steps: losses "
              f"{', '.join(f'{x:.6f}' for x in r['losses'])} (no process group: "
              f"{', '.join(f'{x:.6f}' for x in a['ref_losses'])}); losses and every "
              f"parameter equal bit for bit: {r['equal']}; flash launches in the second "
              f"step {r['launches']}; {r['seconds']:.1f} s")
        if not r["equal"]:
            raise AssertionError(f"ZeRO-{stage} at world 1 differs from the step with "
                                 "no process group")
        if r["launches"] != per_step:
            raise AssertionError(f"ZeRO-{stage}: launches per step {r['launches']}, "
                                 f"expected {per_step}")
    runs = {}
    for run in a["runs"]:
        result, accum = run["result"], run["accum"]
        want = {k: accum * n for k, n in per_step.items()}
        ex = result["config"]["execution"]
        steps = ex["warmup_iterations"] + ex["benchmark_iterations"]
        if (result["kernel_launches_per_step"] != want
                or run["launches"] != {k: n * steps for k, n in want.items()}):
            raise AssertionError(f"run_train ZeRO-{run['stage']}, accumulation {accum}: "
                                 f"launches {run['launches']} over {steps} steps, per timed "
                                 f"step {result['kernel_launches_per_step']}; expected {want}")
        if not all(math.isfinite(x) for x in result["losses"]):
            raise AssertionError(f"non-finite losses {result['losses']}")
        st = result["step_time"]
        print(f"[dtrain] run_train ZeRO-{run['stage']}, gradient_accumulation {accum}, "
              f"1B (bf16, B=8, S=512, remat dots, Adam bf16 moments), world 1 over "
              f"{result['system_info'].get('comm_backend')} on {gpu_line}: step mean "
              f"{st['mean'] * 1e3:.3f} ms, median {st['median'] * 1e3:.3f} ms, "
              f"{result['tokens_per_second']:.0f} tokens/s, "
              f"{result['achieved_tflops_per_second']:.1f} TFLOP/s (model flops); flash "
              f"launches per optimizer step {result['kernel_launches_per_step']}; losses "
              f"{', '.join(f'{x:.5f}' for x in result['losses'])}")
        runs[(run["stage"], accum)] = run
    ck = a["ckpt"]
    print(f"[dtrain] checkpoint (1B at full width, {DTRAIN_CKPT_LAYERS} layers, ZeRO-1, "
          f"{ck['bytes'] / 2**20:.0f} MiB): saved at step 1, restored at step "
          f"{ck['restored_step']}, the continued step equal bit for bit to the "
          f"uninterrupted one: {ck['equal']}")
    if not ck["equal"] or ck["restored_step"] != 1:
        raise AssertionError("the checkpoint round trip did not continue bit for bit")

    # (b) processes on the one device over gloo, against the world-1 step at
    # the same depth
    n = len(DTRAIN_GLOO_RUNS)
    (_, reshard_cfg, _), (_, uneven_cfg, _), (_, ckpt_cfg, _) = jobs[n:]
    config = copy.deepcopy(jobs[0][1])
    model_cfg = ModelConfig.from_dict(config["model"])
    opt = build_optimizer(config["training"])
    step, state = make_train_step(model_cfg, opt, init_params(
        model_cfg, config["input"]["seed"], device), batch_size=config["input"]["batch_size"])
    batch, targets = _dtrain_batch(config, model_cfg, device)
    ref_loss, ref = step.grads(state, batch, targets)
    ref_loss = float(ref_loss)
    del state, step
    wall = sum(job["seconds"] for job in results)
    print(f"[dtrain] (b)'s {len(jobs)} runs in the one gloo spawn: {wall:.1f} s in the "
          "ranks")
    errors = {}
    for i, (tp, dp, stage) in enumerate(DTRAIN_GLOO_RUNS):
        ranks = results[i]["ranks"]
        by = {(r["coords"]["dp"], r["coords"]["tp"]): r for r in ranks}
        tp_shards = []
        for j in range(tp):
            parts = [by[(i, j)]["grads"] for i in range(dp)]
            tp_shards.append(parts[0] if dp == 1
                             else zero_mod.unshard_tree(parts, by[(0, j)]["axes"]))
        got = unshard_params(tp_shards, model_cfg)
        rels = {}
        for group, sub in ref["layers"].items():
            for leaf, g in sub.items():
                rels[f"{group}.{leaf}"] = _rel_l2(got["layers"][group][leaf].to(g.device), g)
        for leaf, g in ref["ln_f"].items():
            rels[f"ln_f.{leaf}"] = _rel_l2(got["ln_f"][leaf].to(g.device), g)
        losses = {r["loss"] for r in ranks}
        loss = ranks[0]["loss"]
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        loss_bound, grad_bound = dtrain_bounds(model_cfg.num_layers, tp)
        worst = max(rels, key=rels.get)
        label = f"tp={tp}, ZeRO-{stage}" if tp > 1 else f"dp={dp}, ZeRO-{stage}"
        print(f"[dtrain] 1B step ({model_cfg.num_layers} of its {layers} layers) at {label}, "
              f"two processes on one card over gloo (CUDA "
              f"tensors): loss {loss:.6f} vs world 1 {ref_loss:.6f} (relative "
              f"{loss_rel:.3e}, bound {loss_bound:.3e}); gradient relative L2 per leaf: "
              + ", ".join(f"{n} {v:.3e}" for n, v in rels.items())
              + f" (worst {worst}, bound {grad_bound:.3e}); step loss "
              f"{ranks[0]['step_loss']:.6f}; "
              f"{max(r['seconds'] for r in ranks):.1f} s in the ranks, not timed")
        if len(losses) != 1:
            raise AssertionError(f"{label}: the ranks' losses differ: {losses}")
        if not (loss_rel <= loss_bound and rels[worst] <= grad_bound
                and all(math.isfinite(r["step_loss"]) for r in ranks)):
            raise AssertionError(f"the 1B step at {label} disagrees with the world-1 step")
        errors[label] = {"loss_rel": loss_rel, "worst_grad_rel_l2": rels[worst],
                         "worst_leaf": worst, "wall_s": results[i]["seconds"]}
    del ref, got
    if device == "cuda":
        torch.cuda.empty_cache()
    errors["resharded"] = _dtrain_reshard_check(
        torch, _dtrain_reshard_ref(torch, reshard_cfg, device), results[n]["ranks"],
        results[n]["seconds"])
    if device == "cuda":
        torch.cuda.empty_cache()
    errors["uneven_heads"] = _dtrain_uneven_check(
        torch, _dtrain_uneven_ref(torch, uneven_cfg, device), results[n + 1]["ranks"])
    if device == "cuda":
        torch.cuda.empty_cache()
    errors["reshard_checkpoint"] = _dtrain_ckpt_check(
        torch, ckpt_cfg, results[n + 2]["ranks"], device)
    if device == "cuda":
        torch.cuda.empty_cache()
    print(f"[dtrain] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return {"runs": runs, "stages": a["stages"], "gloo": errors}


def _check_first_calls(torch, comm, mesh, x, ops, label):
    """Each op's output on its first call on payload ``x`` against its plain
    version on the same payload: equal at one rank, bit for bit."""
    for name in ops:
        out = comm.get_op(name).build(mesh)(x)
        torch.cuda.synchronize()
        ref = comm.plain_collective(name, x.unsqueeze(0))
        got = out.unsqueeze(0)
        if got.shape != ref.shape or got.dtype != ref.dtype or not torch.equal(got, ref):
            raise AssertionError(f"NCCL {name} at {label} differs from its plain version")
        del out, ref, got


def _check_results(sweep_result, expected, iterations):
    if sweep_result.failed:
        raise AssertionError(f"failed sweep configs: {sweep_result.failed}")
    if len(sweep_result.written) != expected:
        raise AssertionError(f"{len(sweep_result.written)} result files, expected {expected}")
    for path in sweep_result.written:
        data = json.loads(path.read_text())
        missing = [k for k in COMM_RESULT_KEYS if k not in data]
        if missing:
            raise AssertionError(f"{path.name} lacks {missing}")
        t = data["timings"]
        if len(t) != 1 or len(t[0]) != iterations or not all(
                math.isfinite(v) and v > 0 for v in t[0]):
            raise AssertionError(f"{path.name}: timings are not one row of "
                                 f"{iterations} finite positive samples")


# phase comm (c): the sweep's resilience (item 13, part 13a) on the card's
# NCCL group of one rank: a transient on the first config (retried), a hang
# on the third (abandoned at the deadline, quarantined, its late write
# suppressed), a span trace, then ``resume`` completes the grid
COMM_FAULT_OPS = ("allreduce", "allgather", "broadcast")
COMM_DEADLINE_S, COMM_HANG_S = 2.0, 4.0


def _comm_faults(runner, out, warmup, iters, device="cuda"):
    from dataclasses import replace

    from dlbb_tpu_torch.obs.spans import validate_trace_events
    from dlbb_tpu_torch.resilience.journal import read_journal
    from dlbb_tpu_torch.resilience.validate import validate_result_json

    n = len(COMM_FAULT_OPS) * len(runner.DATA_SIZES_1D)
    trace = out / "spans.json"
    sweep = runner.Sweep1D(
        operations=COMM_FAULT_OPS, rank_counts=(1,), warmup_iterations=warmup,
        measurement_iterations=iters, output_dir=str(out), unit_deadline_seconds=COMM_DEADLINE_S,
        fault_plan=f"exec-transient:1,exec-hang:@3,hang_seconds={COMM_HANG_S}",
        span_trace=str(trace))
    t0 = time.perf_counter()
    first = runner.run_sweep(sweep, device=device, verbose=False)
    wall = time.perf_counter() - t0
    man = json.loads((out / runner.MANIFEST_NAME).read_text())
    res = man["resilience"]
    (quarantined,) = res["quarantined"] or [None]
    evs = json.loads(trace.read_text())["traceEvents"]
    cats = {e.get("cat") for e in evs}
    if (len(first.written) != n - 1 or res["retries_total"] != 1
            or res["watchdog"]["abandoned_measurements"] != 1 or quarantined is None
            or "DeadlineExceeded" not in quarantined["error"] or wall > COMM_HANG_S
            or validate_trace_events(evs)
            or not {"sweep", "config", "measure", "payload", "io", "journal"} <= cats):
        raise AssertionError(f"the faulted sweep: {len(first.written)} of {n} written, "
                             f"{res}, {wall:.1f} s, trace categories {sorted(map(str, cats))}")
    time.sleep(max(0.0, t0 + COMM_HANG_S + 1.0 - time.perf_counter()))
    if (out / quarantined["config"]).exists():
        raise AssertionError("the abandoned measurement wrote its quarantined config")
    resumed = runner.run_sweep(replace(sweep, fault_plan=None, span_trace=None, resume=True),
                               device=device, verbose=False)
    _check_results(resumed, n, iters)
    configs = json.loads((out / runner.MANIFEST_NAME).read_text())["configs"]
    events, torn = read_journal(out)
    if (configs["resumed"] != n - 1 or configs["measured"] != 1 or torn
            or not all(validate_result_json(p)[0] for p in resumed.written)):
        raise AssertionError(f"the resumed grid: {configs}, torn journal lines {torn}")
    print(f"[comm] (c) faulted 1D sweep ({n} configs, NCCL, 1 rank): the transient retried "
          f"once, the hung {quarantined['config']} abandoned at {COMM_DEADLINE_S} s and "
          f"quarantined, {len(first.written)} written in {wall:.1f} s (the hang "
          f"{COMM_HANG_S} s), no late write; span trace valid ({len(evs)} events); "
          f"--resume re-validated {configs['resumed']} and measured {configs['measured']}: "
          f"the grid whole, every artifact valid; journal {len(events)} events")


# phase comm (d): a device-traced sweep (the compile-ahead engine on, one
# dedicated profile rep per config) against a serial untraced one
COMM_TRACE_OPS = ("allreduce", "allgather", "alltoall", "sendrecv")
# the result fields that differ between two runs of one config (JAX's set)
COMM_VOLATILE = {
    "timings", "timestamp", "compile_seconds", "compile_cache_hit", "forced_completion_s",
    "forced_completion_probe_skipped", "system_info", "device_trace", "per_iter_sanity_failed",
    "per_iter_median_s", "measurement_iterations", "warmup_iterations", "time_budget_s",
    "time_budget_clamped",
}


def _comm_traced(runner, out, warmup, iters, gpu_line, device="cuda"):
    t0 = time.perf_counter()
    base = dict(operations=COMM_TRACE_OPS, data_sizes=(("16MB", runner.DATA_SIZES_1D["16MB"]),),
                rank_counts=(1,), warmup_iterations=warmup, measurement_iterations=iters)
    traced = runner.run_sweep(runner.Sweep1D(
        output_dir=str(out / "traced"), device_trace_dir=str(out / "traced_dev"), pipeline=True,
        **base), device=device, verbose=False)
    plain = runner.run_sweep(runner.Sweep1D(output_dir=str(out / "untraced"), pipeline=False,
                                            **base), device=device, verbose=False)
    _check_results(traced, len(COMM_TRACE_OPS), iters)
    _check_results(plain, len(COMM_TRACE_OPS), iters)
    metas = []
    for pt, pu in zip(sorted(traced.written), sorted(plain.written)):
        dt, du = json.loads(pt.read_text()), json.loads(pu.read_text())
        if pt.name != pu.name or "device_trace" not in dt or "device_trace" in du \
                or sorted(set(dt) - COMM_VOLATILE) != sorted(set(du) - COMM_VOLATILE) \
                or any(dt[k] != du[k] for k in set(dt) & set(du) - COMM_VOLATILE):
            raise AssertionError(f"the traced {pt.name} differs from the untraced one")
        metas.append(dt["device_trace"])
    man = json.loads((out / "traced" / runner.MANIFEST_NAME).read_text())
    ok = _cupti_verdict(metas, "comm (d)")
    _rc, report = _devtrace_rc(out / "traced", out / "devtrace", ok)
    if man["pipeline"] is not True or man["work_units"]["unique"] != len(COMM_TRACE_OPS) \
            or man["observability"]["device_captures"] != (len(metas) if ok else 0):
        raise AssertionError(f"the traced sweep's manifest: {man['work_units']}, "
                             f"{man['observability']}")
    for c in report["captures"]:
        if "error" in c:
            continue
        names = ", ".join(f"{r['name'][:60]} [{r['bucket']}] x{r['count']} "
                          f"{r['total_us']:.1f} us" for r in c["per_op"])
        print(f"[comm] (d) {c['label']} on {gpu_line}: device us per bucket: "
              f"{_bucket_line(c)}; events: {names}")
    print("[comm] (d) device records (found, excluded, launches of the work that left "
          "none) and sessions: " + ", ".join(
              f"{m['label']} {m.get('device_records')} {m.get('attempts')}" for m in metas))
    print(f"[comm] (d) {len(metas)} configs traced (compile-ahead on, one profile rep each) "
          f"equal to the serial untraced sweep in every field but the volatile set; "
          f"build seconds {man['compile_seconds_total']:.6f}; obs devtrace exit "
          f"{0 if ok else 1}; {time.perf_counter() - t0:.1f} s")


def _comm_fit(out, gpu_line):
    """Phase comm (e): the corpus of the phase's own artifacts and the cm2
    fit of the ``cuda`` tier, which must fail closed at world 1."""
    from dlbb_tpu_torch.obs.corpus import build_corpus
    from dlbb_tpu_torch.obs.fit import FitError, run_fit
    from dlbb_tpu_torch.resilience.validate import validate_result_json

    t0 = time.perf_counter()
    corpus = build_corpus([out])
    valid = sorted(str(p) for p in out.rglob("*.json") if validate_result_json(p)[0])
    rows = [s for s in corpus["samples"] if s.get("source") != "devtrace"]
    dev_rows = [s for s in corpus["samples"] if s.get("source") == "devtrace"]
    manifests = sorted(str(p) for p in out.rglob("sweep_manifest.json"))
    reports = [d for d in (json.loads(p.read_text()) for p in out.rglob("*.json"))
               if isinstance(d, dict) and d.get("schema") == "dlbb_devtrace_v1"]
    op_rows = sum(len(r["op_samples"]) for r in reports)
    if (sorted(s["file"] for s in rows) != valid or {s["tier"] for s in rows} != {"cuda"}
            or sorted(m["file"] for m in corpus["manifests"]) != manifests
            or not reports or len(dev_rows) != op_rows):
        raise AssertionError(
            f"the corpus of {out}: {len(rows)} result samples of tiers "
            f"{sorted({s['tier'] for s in rows})} against {len(valid)} valid results, "
            f"{len(corpus['manifests'])} summaries against {len(manifests)} manifests, "
            f"{len(dev_rows)} devtrace rows against {op_rows} in {len(reports)} report(s)")
    wires = sorted({s["wire_bytes"] for s in corpus["samples"] if s["tier"] == "cuda"})
    try:
        run_fit([out], tiers=["cuda"], fit_dir=out / "costmodel_fit", verbose=False)
    except FitError as e:
        reason = str(e)
    else:
        raise AssertionError("the cuda fit at world 1 succeeded: it must fail closed")
    if "single message size" not in reason:
        raise AssertionError(f"the cuda fit failed for another reason: {reason}")
    print(f"[comm] (e) corpus of {out} on {gpu_line}: {len(rows)} result samples (tier "
          f"cuda) = {len(valid)} valid result JSONs, {len(corpus['manifests'])} manifest "
          f"summaries, {len(dev_rows)} devtrace op rows from {len(reports)} report(s), "
          f"{len(corpus['skipped'])} skipped; per-device wire sizes {wires}; the cuda fit "
          f"failed closed: {reason}; {time.perf_counter() - t0:.1f} s")


def phase_comm(torch, gpu_line):
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from dlbb_tpu_torch import comm
    from dlbb_tpu_torch.bench import runner
    from dlbb_tpu_torch.stats import process_1d_results, process_3d_results

    out = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_comm"
    shutil.rmtree(out, ignore_errors=True)
    ops_1d = runner.OPERATIONS_1D + ("reducescatter",)
    warmup, iters = 10, 100
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_comm_") as tmp:
        comm.initialize_distributed("nccl", 0, 1, os.path.join(tmp, "store"))
        try:
            mesh = comm.get_mesh(comm.MeshSpec.ring(1))
            for label, n in runner.DATA_SIZES_1D.items():
                for kind in ("per_rank", "per_peer"):
                    ops = [o for o in ops_1d if comm.get_op(o).input_kind == kind]
                    x = comm.make_payload(comm.get_op(ops[0]), 0, 1, n, device="cuda")
                    _check_first_calls(torch, comm, mesh, x, ops, label)
            print(f"[comm] first calls of {len(ops_1d)} ops x {len(runner.DATA_SIZES_1D)} "
                  "sizes through NCCL equal their plain versions, bit for bit")
            t0 = time.perf_counter()
            r1 = runner.run_sweep(runner.Sweep1D(
                operations=ops_1d, rank_counts=(1,), warmup_iterations=warmup,
                measurement_iterations=iters, output_dir=str(out / "1d")),
                device="cuda", verbose=False)
            _check_results(r1, len(ops_1d) * len(runner.DATA_SIZES_1D), iters)
            print(f"[comm] 1D sweep: {len(r1.written)} configs in "
                  f"{time.perf_counter() - t0:.1f} s")
            n3 = 0
            for b, s, h in COMM_SHAPES_3D:
                x = comm.make_payload(comm.get_op("allreduce"), 0, 1, 0, shape=(b, s, h),
                                      device="cuda")
                _check_first_calls(torch, comm, mesh, x, runner.OPERATIONS_3D,
                                   f"({b}, {s}, {h})")
                del x
                t0 = time.perf_counter()
                r3 = runner.run_sweep(runner.Sweep3D(
                    batch_sizes=(b,), seq_lengths=(s,), hidden_dims=(h,), rank_counts=(1,),
                    warmup_iterations=warmup, measurement_iterations=iters,
                    output_dir=str(out / "3d")), device="cuda", verbose=False)
                _check_results(r3, len(runner.OPERATIONS_3D), iters)
                n3 += len(r3.written)
                print(f"[comm] 3D sweep at ({b}, {s}, {h}), {b * s * h * 2 / 2**20:.0f} MiB "
                      f"per rank: first calls equal their plain versions; "
                      f"{len(r3.written)} configs in {time.perf_counter() - t0:.1f} s")
                torch.cuda.empty_cache()
            _comm_faults(runner, out / "faults", warmup, iters)
            # (d) last, after the 3D sweeps, where captures placed by the
            # card's own timestamps lost their records (PERF.md §7)
            _comm_traced(runner, out, warmup, iters, gpu_line)
        finally:
            comm.destroy_distributed()
    s1 = process_1d_results(out / "1d", out / "stats1d", verbose=False)
    s3 = process_3d_results(out / "3d", out / "stats3d", "torch_nccl", verbose=False)
    csvs = [out / "stats1d" / "benchmark_statistics.csv",
            out / "stats3d" / "benchmark_statistics_3d_torch_nccl_standard.csv",
            out / "stats3d" / "benchmark_statistics_3d_torch_nccl_transpose.csv"]
    if len(s1) != len(r1.written) or len(s3) != n3 or not all(p.is_file() for p in csvs):
        raise AssertionError("the statistics did not cover every result")
    at_16mb = {r["operation"]: r["median_time_us"] for r in s1 if r["data_size_name"] == "16MB"}
    at_8 = {r["operation"]: r["median_time_ms"] * 1e3 for r in s3
            if (r["batch"], r["seq_len"], r["hidden_dim"]) == (8, 4096, 4096)}
    at_1g = {r["operation"]: r["median_time_ms"] * 1e3 for r in s3
             if (r["batch"], r["seq_len"], r["hidden_dim"]) == (16, 8192, 4096)}
    nccl = json.loads(r1.written[0].read_text())["system_info"]["nccl_version"]
    print(f"[comm] statistics: {len(s1)} 1D rows, {len(s3)} 3D rows, CSVs in {out}")
    # at one rank an op that writes a new buffer (allgather, gather) reads
    # its payload and writes it once: twice the payload's bytes over the
    # memory rate.  The in-place ops (allreduce, broadcast, reduce) get a
    # buffer refreshed outside the events, and at one rank have no bytes to
    # move in them: their least time is NCCL's call alone
    for label, medians, nbytes in (
            ("16MB", at_16mb, 2 * runner.DATA_SIZES_1D["16MB"]),
            ("(8, 4096, 4096)", at_8, 2 * 8 * 4096 * 4096),
            ("(16, 8192, 4096)", at_1g, 2 * 16 * 8192 * 4096)):
        floor_us = 2 * nbytes / PEAK_BYTES_PER_S * 1e6
        print(f"[comm] NCCL {nccl}, 1 rank, bf16, on {gpu_line}: median us per op at "
              f"{label} ({nbytes / 2**20:.0f} MiB per rank; copy bound of the out-of-place ops {floor_us:.2f} us): "
              + ", ".join(f"{k} {v:.2f}" for k, v in medians.items()))
    at_1kb = {r["operation"]: r["median_time_us"] for r in s1 if r["data_size_name"] == "1KB"}
    print(f"[comm] NCCL {nccl}, 1 rank, on {gpu_line}: median us per op at 1KB (the cuda "
          f"tier's alpha): " + ", ".join(f"{k} {v:.2f}" for k, v in at_1kb.items())
          + f"; their median {statistics.median(at_1kb.values()):.2f}")
    _comm_fit(out, gpu_line)


# phase seq (b): the sequence-sharded 1B paths against world 1, both bf16
# on the card, one seed.
# - tp=2, tp_overlap ring/bidir, "full": the matmul-reduce-scatter rounds
#   each partial product to bf16 and adds the tp partials in tp - 1 bf16
#   additions, as many roundings as the all-reduce ``tp_bf16_bound`` counts;
#   the flash kernel runs on each rank's heads over the gathered sequence,
#   the same values per head.  Forward: ``tp_bf16_bound``; step:
#   ``dtrain_bounds`` at tp=2 (argued above).
# - sp=2, ring or Ulysses, against world 1's "full" (the flash kernel):
#   ring attention is fp32 throughout and Ulysses runs dense attention, where
#   the kernel rounds P and o to bf16: the kernel-vs-dense difference that
#   phase 3 bounds by E2E_REL_L2 (ring's online softmax sums the same fp32
#   terms in another order).  The projections run on half the rows each,
#   where a GEMM may sum in another order and round a product one bf16 ulp
#   apart: at most ``tp_bf16_bound(layers, 2)`` more.  Step: the loss moves
#   by at most twice the forward's relative difference (as in dtrain), each
#   gradient by the kernel-vs-dense backward bound TRAIN_GRAD_REL_L2 plus
#   the forward's.
SEQ_RUNS = {
    "tp": (("tp2_ring", {"world_size": 2}, {"tp_overlap": "ring"}),
           ("tp2_bidir", {"world_size": 2}, {"tp_overlap": "bidir"})),
    "sp": (("sp2_ring", {"world_size": 1, "sequence_parallel": 2}, {"attention": "ring"}),
           ("sp2_ulysses", {"world_size": 1, "sequence_parallel": 2},
            {"attention": "ulysses"})),
}
# (b)'s Ulysses where sp does not divide a tp rank's heads (item 19): the
# 1B reaches that case only at 32 ranks or more (16 heads: tp * sp > 16
# with sp not dividing 16 / tp), so the card runs the CPU tests' narrow
# model (hidden 64, 4 heads, FFN 128, 2 layers) at tp=2, sp=4 on 8 gloo
# ranks, fp32, against the port's dense path at world 1: the same fp32
# arithmetic summed in another order, the forward and the loss to
# ``SEQ_GATHER_FP32`` relative and each gradient element to it times the
# gradient's largest (a leaf whose exact gradient is 0, the key bias, is
# rounding noise on both sides); dense attention, no flash launch.
SEQ_ULYSSES_GATHER = ("ulysses_tp2_sp4", {"world_size": 2, "sequence_parallel": 4},
                      {"hidden_size": 64, "num_heads": 4, "ffn_intermediate": 128,
                       "num_layers": 2, "attention": "ulysses", "dtype": "float32"})
SEQ_GATHER_FP32 = 1e-5
SEQ_SCHEDULES = ("fused", "ring", "bidir")
# (b)'s depth: a quarter of the 1B's 24 layers, so that the whole script
# keeps its time with phase serve's parts 11b-11d and the entry point; every
# bound of (b) is argued per layer and takes the depth
SEQ_LAYERS = 6
SEQ_VARIANTS = ("default", "overlap_ring", "overlap_bidir")


def seq_bounds(layers, kind):
    """(forward relative L2, loss relative, gradient relative L2 per leaf)
    of a phase seq (b) run against world 1 (comment above)."""
    if kind == "tp":
        fwd = tp_bf16_bound(layers, 2)
        return (fwd, *dtrain_bounds(layers, 2))
    fwd = E2E_REL_L2 + tp_bf16_bound(layers, 2)
    return fwd, 2 * fwd, TRAIN_GRAD_REL_L2 + fwd


def _seq_gloo_runs(config, runs, device):
    """Phase seq (b) on this rank of a gloo group: for each run, on the
    first ranks of the group (``_job_mesh``), the forward (inference) and
    one ZeRO-1 step's loss and reduced gradients, then the update, with the
    flash launches of each, on this rank's part."""
    import copy

    import torch

    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.models.sharding import batch_spec
    from dlbb_tpu_torch.models.transformer import DTYPES, ring_transport, use_tp_overlap
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.parallel.collective_matmul import activation_spec
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    out = {}
    for name, par, model in runs:
        elapsed = _stopwatch()
        if device == "cuda":  # each run's own peak
            torch.cuda.reset_peak_memory_stats()
        cfg = copy.deepcopy(config)
        cfg["parallelism"] = par
        cfg["model"].update(model)
        model_cfg = ModelConfig.from_dict(cfg["model"])
        mesh = _job_mesh(cfg, model_cfg)
        if mesh is None:
            continue
        tp, sp = mesh.shape["tp"], mesh.shape.get("sp", 1)
        params = init_params(model_cfg, cfg["input"]["seed"], device,
                             tp_rank=mesh.coords["tp"], tp=tp)
        batch, targets = (create_dataset_from_config(
            cfg, dtype=DTYPES[model_cfg.dtype], device=device,
            hidden_size=model_cfg.hidden_size, seed_offset=off,
            **batch_spec(mesh)).get_batch() for off in (0, 1))
        _zero_flash_counts(fa)
        with torch.inference_mode():
            y = forward(params, batch, model_cfg, mesh=mesh).cpu()
        fwd_launches = _flash_counts(fa)
        step, state = make_train_step(model_cfg, build_optimizer(cfg["training"]),
                                      params, mesh=mesh, zero_stage=1,
                                      batch_size=cfg["input"]["batch_size"])
        del params
        _zero_flash_counts(fa)
        loss, grads = step.grads(state, batch, targets)
        step_launches = _flash_counts(fa)
        grads = tree_map(lambda g: g.cpu(), grads)
        peak_grads = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        # the update too where the ranks hold half the model: two whole 1B
        # Adam updates (fp32 moments and updates, ~30 GiB each) do not fit
        # on one card beside each other
        step_loss = float("nan")
        if tp > 1:
            state, step_loss = step(state, batch, targets)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        seq = (activation_spec(mesh) if use_tp_overlap(model_cfg, mesh)
               else (mesh.coords.get("sp", 0), sp))
        out[name] = {"coords": mesh.coords, "seq": seq, "y": y, "loss": float(loss),
                     "grads": grads, "step_loss": float(step_loss),
                     "fwd_launches": fwd_launches, "step_launches": step_launches,
                     "transport": ring_transport(model_cfg, mesh, torch.device(device)),
                     "peak_gib": (peak_grads / 2**30, peak / 2**30),
                     "seconds": elapsed()}
        del state, step, grads, y
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _seq_sweeps(torch, gpu_line):
    """Phase seq (a): the collective-matmul sweep ops at world 1 over NCCL."""
    import os
    import shutil
    import tempfile

    from dlbb_tpu_torch import comm
    from dlbb_tpu_torch.bench import runner
    from dlbb_tpu_torch.comm.ops import MATMUL_OPS

    out = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_seq"
    shutil.rmtree(out, ignore_errors=True)
    warmup, iters = 10, 100
    medians = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seq_") as tmp:
        comm.initialize_distributed("nccl", 0, 1, os.path.join(tmp, "store"))
        try:
            mesh = comm.get_mesh(comm.MeshSpec.ring(1))
            for b, s, h in COMM_SHAPES_3D:
                for name in MATMUL_OPS:
                    op = comm.get_op(name)
                    x = comm.make_payload(op, 0, 1, 0, shape=(b, s, h), device="cuda")
                    ref = comm.plain_collective(name, x.unsqueeze(0))[0]
                    for schedule in SEQ_SCHEDULES:
                        y = op.build(mesh, 0, schedule=schedule)(x)
                        torch.cuda.synchronize()
                        if y.shape != ref.shape or not torch.equal(y, ref):
                            raise AssertionError(f"{name} {schedule} at ({b}, {s}, {h}) over "
                                                 "NCCL differs from its plain version")
                        del y
                    del x, ref
                t0 = time.perf_counter()
                for variant in SEQ_VARIANTS:
                    r = runner.run_sweep(runner.Sweep3D(
                        operations=MATMUL_OPS, variant=variant, batch_sizes=(b,),
                        seq_lengths=(s,), hidden_dims=(h,), rank_counts=(1,),
                        warmup_iterations=warmup, measurement_iterations=iters,
                        output_dir=str(out / variant)), device="cuda", verbose=False)
                    _check_results(r, len(MATMUL_OPS), iters)
                    for path in r.written:
                        data = json.loads(path.read_text())
                        key = (variant, data["operation"], (b, s, h))
                        medians[key] = sorted(data["timings"][0])[iters // 2] * 1e6
                torch.cuda.empty_cache()
                print(f"[seq] ({b}, {s}, {h}), {b * s * h * 2 / 2**20:.0f} MiB per rank: "
                      f"fused, ring and bidir equal to plain_collective bit for bit; "
                      f"{len(SEQ_VARIANTS) * len(MATMUL_OPS)} sweep configs in "
                      f"{time.perf_counter() - t0:.1f} s")
        finally:
            comm.destroy_distributed()
    for b, s, h in COMM_SHAPES_3D:
        flops = 2 * b * s * h * h
        print(f"[seq] NCCL world 1, bf16, ({b}, {s}, {h}) on {gpu_line}: median us per call "
              + ", ".join(f"{name}/{variant} {medians[(variant, name, (b, s, h))]:.2f}"
                          for name in MATMUL_OPS for variant in SEQ_VARIANTS)
              + f"; one product of {flops / 1e12:.2f} TFLOP, "
              f"{flops / PEAK_BF16_FLOPS * 1e6:.2f} us at the bf16 peak")
    return medians


def _seq_gloo_jobs():
    """Phase seq (b)'s gloo job: its config (the 1B train config at
    ``SEQ_LAYERS``) and its runs."""
    from dlbb_tpu_torch.utils.config import load_config

    config = load_config(TRAIN_CONFIG)
    config["model"]["num_layers"] = SEQ_LAYERS
    return [("seq", config,
             [run for runs in SEQ_RUNS.values() for run in runs] + [SEQ_ULYSSES_GATHER])]


def phase_seq(torch, gpu_line, jobs, results):
    """Phase 9 (module docstring); ``jobs`` and ``results``: (b)'s gloo job
    (``_seq_gloo_jobs``) and its result (``_run_gloo_jobs``)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    medians = _seq_sweeps(torch, gpu_line)
    [(_, config, _)], [job] = jobs, results
    print(f"[seq] (b)'s runs in the one gloo spawn: {job['seconds']:.1f} s in the ranks")
    gloo = _seq_model(torch, config, job["ranks"])
    print(f"[seq] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return {"sweeps_us": medians, "gloo": gloo}


def _seq_model(torch, config, ranks, device="cuda"):
    """Phase seq (b) on ``config``, against its ranks' runs (``ranks``); on
    the card by default, where a smaller config on the CPU rehearses its
    control flow (no kernel runs there, and CPU tensors hop directly)."""
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.models.sharding import unshard_params
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer

    model_cfg = ModelConfig.from_dict(config["model"])
    layers = model_cfg.num_layers
    params = init_params(model_cfg, config["input"]["seed"], device)
    batch, targets = _dtrain_batch(config, model_cfg, device)
    with torch.inference_mode():
        ref_y = forward(params, batch, model_cfg).float()
    step, state = make_train_step(model_cfg, build_optimizer(config["training"]), params,
                                  batch_size=config["input"]["batch_size"])
    del params
    ref_loss, ref = step.grads(state, batch, targets)
    ref_loss = float(ref_loss)
    del state, step, batch, targets
    if device == "cuda":  # the two ranks' steps need the parent's cache
        torch.cuda.empty_cache()
        print(f"[seq] parent holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    heads_tp2 = {"flash_fwd": layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    step_tp2 = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    none = dict.fromkeys(heads_tp2, 0)
    if device != "cuda":  # attention runs dense on the CPU: no kernel launches
        heads_tp2 = step_tp2 = none
    hop = "host" if device == "cuda" else "device"
    out = {}
    for kind, runs in SEQ_RUNS.items():
        fwd_bound, loss_bound, grad_bound = seq_bounds(layers, kind)
        for name, _, _ in runs:
            recs = sorted((r[name] for r in ranks if name in r), key=lambda r: r["seq"][0])
            want_fwd, want_step = (heads_tp2, step_tp2) if kind == "tp" else (none, none)
            for r in recs:
                if r["fwd_launches"] != want_fwd or r["step_launches"] != want_step:
                    raise AssertionError(f"{name}: flash launches {r['fwd_launches']} "
                                         f"(forward), {r['step_launches']} (step); expected "
                                         f"{want_fwd}, {want_step}")
                # Ulysses makes no ring hop: its all-to-alls take CUDA tensors
                want = None if name.endswith("ulysses") else hop
                if r["transport"] != want:
                    raise AssertionError(f"{name}: ring hops moved by {r['transport']!r}, "
                                         f"expected {want!r}")
            y = torch.cat([r["y"] for r in recs], dim=1).to(device).float()
            if y.shape != ref_y.shape or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{name}: output of shape {tuple(y.shape)}, expected "
                                     "finite values of the world-1 output's shape")
            fwd_rel = _rel_l2(y, ref_y)
            del y
            if kind == "tp":
                got = unshard_params([r["grads"] for r in recs], model_cfg)
            else:
                got = recs[0]["grads"]
                for a, b in zip(_leaves(got), _leaves(recs[1]["grads"])):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name}: the sp ranks' summed gradients differ")
            rels = {f"{group}.{leaf}": _rel_l2(got["layers"][group][leaf].to(device), g)
                    for group, sub in ref["layers"].items() for leaf, g in sub.items()}
            rels.update({f"ln_f.{leaf}": _rel_l2(got["ln_f"][leaf].to(device), g)
                         for leaf, g in ref["ln_f"].items()})
            worst = max(rels, key=rels.get)
            losses = {r["loss"] for r in recs}
            loss_rel = abs(recs[0]["loss"] - ref_loss) / abs(ref_loss)
            print(f"[seq] 1B {name}, two processes on one {device} device over gloo (ring "
                  f"hops: {recs[0]['transport'] or 'none'}): forward relative L2 against "
                  f"world 1 {fwd_rel:.3e} (bound {fwd_bound:.3e}); ZeRO-1 step loss "
                  f"{recs[0]['loss']:.6f} vs world 1 {ref_loss:.6f} (relative {loss_rel:.3e}, "
                  f"bound {loss_bound:.3e}); gradient relative L2 worst {worst} "
                  f"{rels[worst]:.3e} (bound {grad_bound:.3e}); flash launches per rank: "
                  f"forward {recs[0]['fwd_launches']}, step {recs[0]['step_launches']}; step "
                  f"loss {recs[0]['step_loss']:.6f}; peak allocated per rank (GiB, gradients "
                  f"/ update) {[tuple(round(x, 2) for x in r['peak_gib']) for r in recs]}; "
                  f"{max(r['seconds'] for r in recs):.1f} s in the ranks, not timed")
            if len(losses) != 1:
                raise AssertionError(f"{name}: the ranks' losses differ: {losses}")
            if not (fwd_rel <= fwd_bound and loss_rel <= loss_bound
                    and rels[worst] <= grad_bound
                    and (kind != "tp" or all(math.isfinite(r["step_loss"]) for r in recs))):
                raise AssertionError(f"the 1B {name} run disagrees with world 1")
            out[name] = {"fwd_rel_l2": fwd_rel, "loss_rel": loss_rel,
                         "worst_grad_rel_l2": rels[worst], "worst_leaf": worst,
                         "fwd_launches": recs[0]["fwd_launches"],
                         "step_launches": recs[0]["step_launches"]}
    out[SEQ_ULYSSES_GATHER[0]] = _seq_ulysses_gather(torch, config, ranks, device)
    return out


def _seq_ulysses_gather(torch, config, ranks, device):
    """Phase seq (b)'s Ulysses over tp-gathered heads against the dense
    path at world 1 (``SEQ_ULYSSES_GATHER``)."""
    import copy

    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.models.sharding import unshard_params
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer

    name, _, model = SEQ_ULYSSES_GATHER
    cfg = copy.deepcopy(config)
    cfg["model"].update(model, attention="dense")
    dense = ModelConfig.from_dict(cfg["model"])
    params = init_params(dense, cfg["input"]["seed"], device)
    batch, targets = _dtrain_batch(cfg, dense, device)
    with torch.inference_mode():
        ref_y = forward(params, batch, dense)
    step, state = make_train_step(dense, build_optimizer(cfg["training"]), params,
                                  batch_size=cfg["input"]["batch_size"])
    ref_loss, ref = step.grads(state, batch, targets)
    recs = [r[name] for r in ranks if name in r]
    by = {(r["coords"]["sp"], r["coords"]["tp"]): r for r in recs}
    sp, tp = 1 + max(k[0] for k in by), 1 + max(k[1] for k in by)
    y = torch.cat([by[(i, 0)]["y"] for i in range(sp)], dim=1).to(device)
    fwd_rel = _rel_l2(y, ref_y)
    got = _by_name(unshard_params([by[(0, j)]["grads"] for j in range(tp)], dense))
    ref = _by_name(ref)
    scale = max(float(g.abs().max()) for g in ref.values())
    worst = max(ref, key=lambda n: float((got[n].to(device) - ref[n]).abs().max()))
    diff = float((got[worst].to(device) - ref[worst]).abs().max())
    loss_rel = abs(recs[0]["loss"] - float(ref_loss)) / abs(float(ref_loss))
    none = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    print(f"[seq] Ulysses at num_heads=4, tp=2, sp=4 (sp does not divide the 2 heads a tp "
          f"rank holds: the heads gathered over tp), fp32, {len(recs)} processes on one "
          f"{device} device over gloo, against the dense path at world 1: forward relative "
          f"L2 {fwd_rel:.3e}, loss {recs[0]['loss']:.8f} vs {float(ref_loss):.8f} (relative "
          f"{loss_rel:.3e}), largest gradient difference {diff:.3e} at {worst} (bound "
          f"{SEQ_GATHER_FP32} x the largest gradient element {scale:.3e}; forward and loss "
          f"bound {SEQ_GATHER_FP32}); flash launches per rank "
          f"{recs[0]['fwd_launches']} (forward), {recs[0]['step_launches']} (step)")
    if (len(recs) != 8 or len({r["loss"] for r in recs}) != 1
            or any(r["fwd_launches"] != none or r["step_launches"] != none for r in recs)
            or fwd_rel > SEQ_GATHER_FP32 or loss_rel > SEQ_GATHER_FP32
            or diff > SEQ_GATHER_FP32 * scale):
        raise AssertionError(f"{name} disagrees with the dense path at world 1")
    return {"fwd_rel_l2": fwd_rel, "loss_rel": loss_rel, "grad_max_diff": diff,
            "grad_scale": scale, "fwd_launches": recs[0]["fwd_launches"],
            "step_launches": recs[0]["step_launches"]}


# phase moe: the 1B with 4 experts, top-2, at full width and depth, bf16.
# - ep=2 against world 1: the router, the attention and every expert run
#   on the same values at both, but each ep rank rounds the combine of its
#   2 experts to bf16 and the two halves are added over gloo, where world 1
#   rounds the 4-expert combine once: one extra rounding of the FFN output
#   per layer, at most 2**-8 relative, half ``tp_bf16_bound``'s two per
#   layer.  Those differences reach the next layers' router logits, and a
#   token whose 2nd and 3rd expert are that close changes one of its
#   experts: its FFN output then differs wholly.  The bound allows
#   MOE_FLIP_SHARE of the tokens to do so, sqrt(share) of the output's
#   relative L2.
# - The ep=2 step's loss against world 1's (``loss_rel_bound``), its aux
#   term apart: a token that changes one of its k experts moves 1/(N k) of
#   the slot shares f_e between two experts, so the aux E sum_e f_e P_e
#   (P_e <= 1) moves by at most 2 E share / k, times the aux weight.
# - The ep=2 step's reduced gradients against world 1's, per leaf, relative
#   L2: the backward adds the forward's extra rounding per layer (each rank
#   rounds its experts' share of the FFN input's gradient, then the halves
#   are summed over ep), half ``tp_bf16_bound``, to the forward's
#   difference, which reaches each gradient through the activations it
#   multiplies, at most their relative size (the forward's bound).  A leaf
#   that lost the other rank's experts' share of its gradient (no sum over
#   ep) is about half its size away.
MOE_MODEL = {"size": "1B", "num_experts": 4, "moe_top_k": 2, "attention": "full",
             "dtype": "bfloat16"}
MOE_DISPATCHES = ("dense", "capacity")
MOE_AUX_WEIGHT = 0.01
MOE_FLIP_SHARE = 1e-2
# two losses whose outputs differ by rounding and routing: held to this many
# standard deviations of their difference (``loss_rel_bound``)
LOSS_SIGMAS = 6


def moe_ep_bounds(layers):
    """(output relative L2, gradient relative L2 per leaf, aux term of the
    loss) bounds of the ep=2 MoE forward and step against world 1 (comment
    above)."""
    fwd = tp_bf16_bound(layers, 2) / 2 + math.sqrt(MOE_FLIP_SHARE)
    aux = MOE_AUX_WEIGHT * 2 * MOE_MODEL["num_experts"] * MOE_FLIP_SHARE / MOE_MODEL["moe_top_k"]
    return fwd, fwd + tp_bf16_bound(layers, 2) / 2, aux


def loss_rel_bound(y, ref, ref_loss, extra=0.0):
    """Relative bound of the difference between two runs' MSE losses
    (``ref_loss`` the reference's) whose outputs are ``y`` and ``ref``, the
    same N elements.  The losses differ by (sum(y**2) - sum(ref**2)) / N,
    measured here, and -2/N sum(t * (y - ref)): the targets t are a
    standard normal draw independent of the outputs, so that term is
    Gaussian with standard deviation 2 |y - ref| / N, held to LOSS_SIGMAS
    of it.  ``extra`` (absolute) bounds any other term of the loss."""
    y, ref = y.double(), ref.double()
    squares = abs(((y * y).sum() - (ref * ref).sum()).item())
    noise = 2 * LOSS_SIGMAS * (y - ref).norm().item()
    return ((squares + noise) / ref.numel() + extra) / abs(ref_loss)


def _moe_config(dispatch, **parallelism):
    import copy

    from dlbb_tpu_torch.utils.config import load_config

    config = load_config(TRAIN_CONFIG)
    config["experiment"]["name"] = f"chip_smoke_1b_moe_{dispatch}"
    config["model"] = dict(MOE_MODEL, moe_dispatch=dispatch)
    config["parallelism"] = {"world_size": 1, "data_parallel": 1, **parallelism}
    config["training"]["moe_aux_loss_weight"] = MOE_AUX_WEIGHT
    config["execution"] = {"warmup_iterations": 2, "benchmark_iterations": 5}
    return copy.deepcopy(config)


def _moe_ep_job(device):
    """Phase moe's job of the one gloo spawn, on its first two ranks (ep=2):
    the forward of each dispatch, then one step's loss and reduced gradients
    with the aux loss (dense dispatch); None past them."""
    import torch

    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    torch.cuda.reset_peak_memory_stats()
    out = {"y": {}, "fwd_ms": {}}
    for dispatch in MOE_DISPATCHES:
        config = _moe_config(dispatch, expert_parallel=2)
        model_cfg = ModelConfig.from_dict(config["model"])
        plan = _job_plan(config, model_cfg)
        if plan is None:
            continue
        params = init_params(model_cfg, config["input"]["seed"], device, **plan.coords())
        batch, targets = _dtrain_batch(config, model_cfg, device)
        with torch.inference_mode():
            forward(params, batch, model_cfg, mesh=plan.mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = forward(params, batch, model_cfg, mesh=plan.mesh)
            torch.cuda.synchronize()
        out["fwd_ms"][dispatch] = (time.perf_counter() - t0) * 1e3
        out["y"][dispatch] = y.cpu()
        del y
        if dispatch == "dense":
            step, state = make_train_step(model_cfg, build_optimizer(config["training"]),
                                          params, mesh=plan.mesh,
                                          moe_aux_weight=MOE_AUX_WEIGHT,
                                          batch_size=config["input"]["batch_size"])
            del params
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = step.grads(state, batch, targets)
            out["loss"] = float(loss)
            out["grad_ms"] = (time.perf_counter() - t0) * 1e3
            out["grads"] = tree_map(lambda g: g.cpu(), grads)
            del step, state, grads
        else:
            del params
        torch.cuda.empty_cache()
        out["coords"] = plan.mesh.coords
    if "coords" not in out:
        return None
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _leaf_rel_l2(torch, got, ref):
    """Per ``group.leaf`` name, the relative L2 of ``got`` against ``ref``
    (parameter trees on the host), each pair compared on the card."""
    got = _by_name(got)
    return {name: _rel_l2(got[name].cuda(), t.cuda()) for name, t in _by_name(ref).items()}


def phase_moe(torch, fa, gpu_line, results):
    """Phase 10 (module docstring); ``results``: its gloo job's
    (``_run_gloo_jobs``)."""
    from dlbb_tpu_torch.bench.e2e import run_e2e
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.models.sharding import ep_dim, unshard_params
    from dlbb_tpu_torch.train.loop import make_train_step, run_train
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    elapsed = _stopwatch()
    torch.cuda.empty_cache()
    layers = ModelConfig.from_dict(MOE_MODEL).num_layers
    out = {"e2e": {}, "train": None, "ep": {}}
    # (a) the forward through run_e2e at world 1, both dispatches
    for dispatch in MOE_DISPATCHES:
        config = _moe_config(dispatch)
        ex = config["execution"]
        forwards = ex["warmup_iterations"] + ex["benchmark_iterations"]
        torch.cuda.reset_peak_memory_stats()
        _zero_flash_counts(fa)
        result = run_e2e(config, device="cuda", verbose=True)
        launches = _flash_counts(fa)
        if (launches["flash_fwd"] != layers * forwards
                or result["flash_launches"] != layers * ex["benchmark_iterations"]):
            raise AssertionError(f"MoE {dispatch}: flash launches {launches} over {forwards} "
                                 f"forwards; expected {layers} per forward")
        ft = result["forward_time"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[moe] 1B MoE forward (4 experts, top-2, {dispatch} dispatch, "
              f"{result['model']['num_parameters'] / 1e9:.3f} B parameters), world 1, bf16, "
              f"B=8, S=512, attention=full on {gpu_line}: mean {ft['mean'] * 1e3:.3f} ms, "
              f"median {ft['median'] * 1e3:.3f} ms, {result['tokens_per_second']:.0f} "
              f"tokens/s, {result['achieved_tflops_per_second']:.1f} TFLOP/s (model flops); "
              f"flash forward launches {launches['flash_fwd']} ({layers} per forward); peak "
              f"allocated {peak:.2f} GiB")
        out["e2e"][dispatch] = {"result": result, "launches": launches["flash_fwd"],
                                "peak_gib": peak}
        torch.cuda.empty_cache()
    # (b) one run_train step at full width and depth with the aux loss (the
    # first step and one timed step: run_train times at least one)
    config = _moe_config("dense")
    config["execution"] = {"warmup_iterations": 1, "benchmark_iterations": 1}
    # the 1B train config's remat (TRAIN_CONFIG): "dots", the flash forward
    # recomputed in the backward
    config["model"].update(remat=True, remat_policy="dots")
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts(fa)
    result = run_train(config, device="cuda", verbose=True)
    launches = _flash_counts(fa)
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    if (result["kernel_launches_per_step"] != per_step
            or launches != {k: 2 * n for k, n in per_step.items()}):
        raise AssertionError(f"MoE run_train: launches {launches} over 2 steps, per timed "
                             f"step {result['kernel_launches_per_step']}; expected {per_step}")
    if not all(math.isfinite(x) for x in result["losses"]):
        raise AssertionError(f"MoE run_train: non-finite losses {result['losses']}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = result["step_time"]
    print(f"[moe] run_train, 1B MoE at full width and depth ({layers} layers), Adam with bf16 "
          f"moments, remat dots, moe_aux_loss_weight {MOE_AUX_WEIGHT}, world 1 on {gpu_line}: "
          f"step {st['mean'] * 1e3:.3f} ms (one timed step after the first), losses "
          f"{', '.join(f'{x:.6f}' for x in result['losses'])}; flash launches per step "
          f"{result['kernel_launches_per_step']}; peak allocated {peak:.2f} GiB")
    out["train"] = {"result": result, "launches": launches, "peak_gib": peak}
    torch.cuda.empty_cache()
    # (c) ep=2, two processes on the one card over gloo, against world 1
    refs = {}
    for dispatch in MOE_DISPATCHES:
        config = _moe_config(dispatch)
        model_cfg = ModelConfig.from_dict(config["model"])
        params = init_params(model_cfg, config["input"]["seed"], "cuda")
        batch, targets = _dtrain_batch(config, model_cfg, "cuda")
        with torch.inference_mode():
            refs[dispatch] = forward(params, batch, model_cfg).float().cpu()
        if dispatch == "dense":
            step, state = make_train_step(model_cfg, build_optimizer(config["training"]),
                                          params, moe_aux_weight=MOE_AUX_WEIGHT,
                                          batch_size=config["input"]["batch_size"])
            loss, grads = step.grads(state, batch, targets)
            refs["loss"] = float(loss)
            refs["grads"] = tree_map(lambda g: g.cpu(), grads)
            del step, state, grads
        del params, batch, targets
        torch.cuda.empty_cache()
    [job] = results
    ranks, wall = sorted(job["ranks"], key=lambda r: r["coords"]["ep"]), job["seconds"]
    fwd_bound, grad_bound, aux_bound = moe_ep_bounds(layers)
    for dispatch in MOE_DISPATCHES:
        ys = [r["y"][dispatch] for r in ranks]
        if not torch.equal(ys[0], ys[1]):
            raise AssertionError(f"MoE ep=2 {dispatch}: the ranks' outputs differ")
        y = ys[0].float()
        ref = refs[dispatch]
        if y.shape != ref.shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"MoE ep=2 {dispatch}: output of shape {tuple(y.shape)}, "
                                 "expected finite values of the world-1 output's shape")
        rel = _rel_l2(y, ref)
        print(f"[moe] 1B MoE forward at ep=2 ({dispatch} dispatch), two processes on one card "
              f"over gloo (the combine's all-reduce takes CUDA tensors): relative L2 against "
              f"world 1 {rel:.3e} (bound {fwd_bound:.3e}); "
              f"{max(r['fwd_ms'][dispatch] for r in ranks):.3f} ms per forward (second "
              f"forward, wall, slowest rank) on {gpu_line}")
        if not rel <= fwd_bound:
            raise AssertionError(f"the 1B MoE ep=2 {dispatch} forward disagrees with world 1")
        out["ep"][dispatch] = {"fwd_rel_l2": rel,
                               "fwd_ms": max(r["fwd_ms"][dispatch] for r in ranks)}
    losses = {r["loss"] for r in ranks}
    loss = ranks[0]["loss"]
    loss_rel = abs(loss - refs["loss"]) / abs(refs["loss"])
    loss_bound = loss_rel_bound(ranks[0]["y"]["dense"], refs["dense"], refs["loss"], aux_bound)
    # the leaves the ranks hold whole (all but the experts) carry gradients
    # summed over ep: equal on both
    g0, g1 = (_by_name(r["grads"]) for r in ranks)
    split = {name for name in g0 if ep_dim(*name.split("."), True) is not None}
    if any(not torch.equal(t, g1[name]) for name, t in g0.items() if name not in split):
        raise AssertionError("MoE ep=2: the ranks' gradients of their whole leaves differ")
    grads = unshard_params([r["grads"] for r in ranks], model_cfg, ep=2)
    rels = _leaf_rel_l2(torch, grads, refs["grads"])
    worst = max(rels, key=rels.get)
    print(f"[moe] ep=2 step (dense dispatch, aux {MOE_AUX_WEIGHT}): loss {loss:.6f} vs world 1 "
          f"{refs['loss']:.6f} (relative {loss_rel:.3e}, bound {loss_bound:.3e}); reduced "
          f"gradients' relative L2 against world 1 worst {worst} {rels[worst]:.3e} (bound "
          f"{grad_bound:.3e}), experts' worst "
          f"{max(rels[n] for n in split):.3e}; loss and reduced gradients "
          f"{max(r['grad_ms'] for r in ranks):.1f} ms (wall, slowest rank); peak allocated "
          f"per rank {[round(r['peak_gib'], 2) for r in ranks]} GiB; {wall:.1f} s in the "
          f"ranks on {gpu_line}")
    if len(losses) != 1 or not (loss_rel <= loss_bound and rels[worst] <= grad_bound):
        raise AssertionError("the 1B MoE ep=2 step disagrees with world 1")
    out["ep"].update(loss_rel=loss_rel, loss_bound=loss_bound, worst_grad_rel_l2=rels[worst],
                     worst_leaf=worst, peak_gib=[r["peak_gib"] for r in ranks])
    print(f"[moe] phase wall time {elapsed():.1f} s")
    return out


# phase pipe: the 1B (bf16, full width and depth) at pp=2, m=4, two
# processes on the one card over gloo, against world 1.
# - Forward, and each schedule's reduced gradients: a stage runs "dense"
#   attention (JAX's pin) where world 1's "full" runs the flash kernel, and
#   its projections run on a quarter of the rows, where a GEMM may sum in
#   another order: the sp=2 runs of phase seq differ from world 1 in the
#   same two ways, so ``seq_bounds(layers, "sp")`` bounds them.  The loss:
#   ``loss_rel_bound`` on the forward's outputs.
# - GPipe against 1F1B: both compute each microbatch's stage gradients from
#   the same inputs and cotangents with the same kernels (1F1B's recompute
#   is the same forward; the loss's cotangent 1/m x 1/(N/m) is GPipe's 1/N
#   exactly, N and m powers of two) and sum the 4 microbatches' in fp32 in
#   another order, so a layer's bf16 gradient or updated bf16 parameter
#   differs only where that sum straddles a rounding boundary or the
#   gradient is within fp32 rounding of 0: PIPE_UNEQUAL_SHARE of each layer
#   leaf's elements at most.  ``ln_f`` is not such a leaf: GPipe takes its
#   gradient over the whole batch, 1F1B per microbatch (JAX's split), so it
#   is held against world 1 only, as above.  The loss sums the same squared
#   differences grouped otherwise, PIPE_LOSS_REL.
# - Updated parameters: each side's (both stages' and world 1's) must be
#   the first Adam step from the same start on its own gradient, whose sign
#   and size the gradient checks above hold against world 1's.  That step
#   is u = -lr m^ / (sqrt(v^) + eps): with bf16 gradients and moments,
#   m^ / sqrt(v^) is |g| (1 +- PIPE_STEP_SPREAD) (bf16(0.1) and bf16(0.001)
#   as the moment weights, the bf16 roundings of g*g and of each weighted
#   term), so |u| <= lr (1 + spread) everywhere, and where |g| >=
#   PIPE_SURE_GRAD (100 eps) u = -lr sign(g) r with r in [(1 - spread) /
#   1.01, 1 + spread]; the result is p + u rounded to bf16 (through fp32),
#   within one bf16 ulp of that interval.  A step with the wrong sign, of
#   the wrong size, missing, or taken on another stage's layers fails it.
PIPE_MICROBATCHES = 4
PIPE_UNEQUAL_SHARE = 1e-3
PIPE_LOSS_REL = 1e-5
PIPE_SURE_GRAD = 1e-6
PIPE_STEP_SPREAD = 2.0**-6
PIPE_SCHEDULES = ("gpipe", "1f1b")
# the 1B at full width and a third of its depth (4 layers a stage), so that
# the whole script keeps its time; the bounds above take the depth
PIPE_LAYERS = 8


def _pipe_config():
    from dlbb_tpu_torch.utils.config import load_config

    config = load_config(TRAIN_CONFIG)
    config["experiment"]["name"] = "chip_smoke_1b_pp2"
    config["model"]["num_layers"] = PIPE_LAYERS
    config["parallelism"] = {"world_size": 1, "data_parallel": 1, "pipeline_parallel": 2,
                             "num_microbatches": PIPE_MICROBATCHES}
    return config


def _pipe_job(device):
    """Phase pipe's job of the one gloo spawn, on its first two ranks
    (pp=2): the forward, then for each schedule one step's loss and reduced
    gradients and the step, the flash launches counted from 0 around each;
    None past them."""
    import torch

    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.parallel.ring import hop_transport
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    config = _pipe_config()
    model_cfg = ModelConfig.from_dict(config["model"])
    plan = _job_plan(config, model_cfg)
    if plan is None:
        return None
    mesh = plan.mesh
    params = init_params(model_cfg, config["input"]["seed"], "cuda", **plan.coords())
    batch, targets = _dtrain_batch(config, model_cfg, "cuda")
    out = {"coords": mesh.coords, "ms": {}, "peak_gib": {}, "launches": {},
           "transport": hop_transport(mesh.axis_groups["pp"], torch.device("cuda"))}
    _zero_flash_counts(fa)
    with torch.inference_mode():
        forward(params, batch, model_cfg, mesh=mesh, num_microbatches=plan.num_microbatches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = forward(params, batch, model_cfg, mesh=mesh,
                    num_microbatches=plan.num_microbatches)
        torch.cuda.synchronize()
    out["ms"]["forward"] = (time.perf_counter() - t0) * 1e3
    out["y"] = y.cpu()
    out["launches"]["forward"] = _flash_counts(fa)
    del y
    for schedule in PIPE_SCHEDULES:
        torch.cuda.reset_peak_memory_stats()
        # a copy: the step updates the parameters it is given in place
        step, state = make_train_step(
            model_cfg, build_optimizer(config["training"]), tree_map(torch.clone, params),
            mesh=mesh, num_microbatches=plan.num_microbatches, pipeline_schedule=schedule,
            batch_size=config["input"]["batch_size"])
        _zero_flash_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step.grads(state, batch, targets)
        torch.cuda.synchronize()
        out["ms"][f"{schedule}_grads"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        state, step_loss = step(state, batch, targets)
        torch.cuda.synchronize()
        out["ms"][f"{schedule}_step"] = (time.perf_counter() - t0) * 1e3
        out["launches"][schedule] = _flash_counts(fa)
        out["peak_gib"][schedule] = torch.cuda.max_memory_allocated() / 2**30
        out[schedule] = {"loss": float(loss), "step_loss": float(step_loss),
                         "grads": tree_map(lambda g: g.cpu(), grads),
                         "params": tree_map(lambda p: p.detach().cpu(), state.params)}
        del step, state, grads
        torch.cuda.empty_cache()
    return out


def _by_name(tree):
    """A parameter tree's leaves by ``group.leaf`` name."""
    out = {f"{g}.{leaf}": t for g, sub in tree["layers"].items() for leaf, t in sub.items()}
    out.update({f"ln_f.{leaf}": t for leaf, t in tree["ln_f"].items()})
    return out


def _adam_first_step_misses(torch, p0, p1, g, lr):
    """The elements of one leaf whose updated value ``p1`` is not the first
    Adam step from ``p0`` on the gradient ``g`` (comment above), as a count,
    and the share of the leaf where ``|g| >= PIPE_SURE_GRAD``; on the
    card."""
    p0, p1, g = (t.cuda().double() for t in (p0, p1, g))
    spread = PIPE_STEP_SPREAD
    sure = g.abs() >= PIPE_SURE_GRAD
    big, small = lr * (1 + spread), lr * (1 - spread) / (1 + 1e-8 / PIPE_SURE_GRAD)
    sign = torch.sign(g)
    lo = torch.where(sure, p0 - sign * torch.where(sign > 0, big, small), p0 - big)
    hi = torch.where(sure, p0 - sign * torch.where(sign > 0, small, big), p0 + big)

    def ulp(x):  # one bf16 ulp at |x| (8 significant bits)
        return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)

    ok = (p1 >= lo - ulp(lo)) & (p1 <= hi + ulp(hi))
    return int((~ok).sum()), float(sure.double().mean())


def phase_pipe(torch, gpu_line, results):
    """Phase 11 (module docstring); ``results``: its gloo job's
    (``_run_gloo_jobs``)."""
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.models.sharding import unshard_params
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    elapsed = _stopwatch()
    torch.cuda.empty_cache()
    config = _pipe_config()
    one = dict(config, parallelism={"world_size": 1, "data_parallel": 1})
    model_cfg = ModelConfig.from_dict(config["model"])
    layers, m, pp = model_cfg.num_layers, PIPE_MICROBATCHES, 2
    lr = config["training"]["learning_rate"]
    # world 1: the forward, one step's loss and gradients, and the step
    params = init_params(model_cfg, config["input"]["seed"], "cuda")
    p0 = _by_name(tree_map(lambda p: p.cpu(), params))
    batch, targets = _dtrain_batch(one, model_cfg, "cuda")
    with torch.inference_mode():
        ref_y = forward(params, batch, model_cfg).float().cpu()
    step, state = make_train_step(model_cfg, build_optimizer(config["training"]), params,
                                  batch_size=config["input"]["batch_size"])
    del params
    ref_loss, ref_grads = step.grads(state, batch, targets)
    ref_loss = float(ref_loss)
    ref_grads = tree_map(lambda g: g.cpu(), ref_grads)
    state, _ = step(state, batch, targets)
    ref_params = tree_map(lambda p: p.detach().cpu(), state.params)
    del step, state, batch, targets
    torch.cuda.empty_cache()

    [job] = results
    ranks, wall = sorted(job["ranks"], key=lambda r: r["coords"]["pp"]), job["seconds"]
    fwd_bound, _, grad_bound = seq_bounds(layers, "sp")
    bubble = (pp - 1) / (m + pp - 1)
    # a stage runs dense attention: no flash launch on any path of the phase
    launches = {part: {k: sum(r["launches"][part][k] for r in ranks)
                       for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                for part in ("forward", *PIPE_SCHEDULES)}
    for r in ranks:
        if r["transport"] != "host":
            raise AssertionError(f"pp=2 rank {r['coords']}: hops by {r['transport']}")
    if any(n for counts in launches.values() for n in counts.values()):
        raise AssertionError(f"pp=2: flash launches {launches} (a stage runs dense attention)")
    if not torch.equal(ranks[0]["y"], ranks[1]["y"]):
        raise AssertionError("pp=2: the stages' outputs differ (the broadcast over pp)")
    y = ranks[0]["y"].float()
    if y.shape != ref_y.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"pp=2: output of shape {tuple(y.shape)}, expected finite "
                             "values of the world-1 output's shape")
    fwd_rel = _rel_l2(y, ref_y)
    loss_bound = loss_rel_bound(y, ref_y, ref_loss)
    print(f"[pipe] 1B forward ({layers} layers, full width) at pp=2, m={m} (bubble fraction "
          f"(pp-1)/(m+pp-1) = {bubble:.3f}), "
          f"two processes on one card over gloo (hops through host memory), attention full "
          f"(dense inside a stage) on {gpu_line}: relative L2 against world "
          f"1 {fwd_rel:.3e} (bound {fwd_bound:.3e}); "
          f"{max(r['ms']['forward'] for r in ranks):.3f} ms per forward (second forward, wall, "
          f"slowest stage); flash launches (both stages) {launches}")
    if not fwd_rel <= fwd_bound:
        raise AssertionError("the 1B pp=2 forward disagrees with world 1")
    out = {"fwd_rel_l2": fwd_rel, "bubble": bubble, "ms": {}, "wall_s": wall,
           "launches": launches}
    got = {}
    ref_by_name = _by_name(ref_params)
    n_all = sum(t.numel() for t in ref_by_name.values())
    # the check on world 1's own step
    ref_g = _by_name(ref_grads)
    ref_checks = {name: _adam_first_step_misses(torch, p0[name], t, ref_g[name], lr)
                  for name, t in ref_by_name.items()}
    ref_misses = sum(c[0] for c in ref_checks.values())
    ref_sure = sum(c[1] * p0[n].numel() for n, c in ref_checks.items()) / n_all
    if ref_misses:
        raise AssertionError(f"world 1's Adam step: {ref_misses} elements off its first step")
    for schedule in PIPE_SCHEDULES:
        recs = [r[schedule] for r in ranks]
        grads = unshard_params([r["grads"] for r in recs], model_cfg, pp=pp)
        rels = _leaf_rel_l2(torch, grads, ref_grads)
        worst = max(rels, key=rels.get)
        grads = _by_name(grads)
        loss = recs[0]["loss"]
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        params = _by_name(unshard_params([r["params"] for r in recs], model_cfg, pp=pp))
        got[schedule] = {"loss": loss, "grads": grads, "params": params}
        misses = {name: _adam_first_step_misses(torch, p0[name], params[name], grads[name], lr)[0]
                  for name in p0}
        unequal = sum(int((params[name] != t).sum()) for name, t in ref_by_name.items()) / n_all
        ms = {k: max(r["ms"][f"{schedule}_{k}"] for r in ranks) for k in ("grads", "step")}
        print(f"[pipe] {schedule} step at pp=2, m={m}, ZeRO-0, Adam bf16 moments: loss "
              f"{loss:.6f} vs world 1 {ref_loss:.6f} (relative {loss_rel:.3e}, bound "
              f"{loss_bound:.3e}); gradient relative L2 worst {worst} {rels[worst]:.3e} "
              f"(bound {grad_bound:.3e}); updated parameters off the first Adam step of their "
              f"gradient {sum(misses.values())} (bound 0; world 1's {ref_misses}; gradient "
              f"sure of its sign on {ref_sure:.3f} of the elements), unequal to world 1's "
              f"{unequal:.3e} of the elements; loss and gradients {ms['grads']:.1f} ms, step "
              f"{ms['step']:.1f} ms (wall, slowest stage, not a benchmark); peak allocated "
              f"per stage {[round(r['peak_gib'][schedule], 2) for r in ranks]} GiB on {gpu_line}")
        if len({r["loss"] for r in recs}) != 1:
            raise AssertionError(f"pp=2 {schedule}: the stages' losses differ")
        if not (loss_rel <= loss_bound and rels[worst] <= grad_bound
                and not any(misses.values())
                and all(math.isfinite(r["step_loss"]) for r in recs)):
            raise AssertionError(f"the 1B pp=2 {schedule} step disagrees with world 1")
        out["ms"][schedule] = ms
        out[schedule] = {"loss_rel": loss_rel, "loss_bound": loss_bound,
                         "worst_grad_rel_l2": rels[worst], "worst_leaf": worst,
                         "update_misses": sum(misses.values()), "unequal_share": unequal,
                         "peak_gib": [r["peak_gib"][schedule] for r in ranks]}
    # GPipe against 1F1B
    a, b = got["gpipe"], got["1f1b"]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    unequal = {f"{key} {name}": (t != b[key][name]).float().mean().item()
               for key in ("grads", "params") for name, t in a[key].items()
               if not name.startswith("ln_f.")}
    worst = max(unequal, key=unequal.get)
    print(f"[pipe] GPipe against 1F1B: loss relative {loss_rel:.3e} (bound {PIPE_LOSS_REL:.0e}); "
          f"largest share of unequal elements {unequal[worst]:.3e} in {worst} (bound "
          f"{PIPE_UNEQUAL_SHARE:.0e}); {wall:.1f} s in the two stages")
    if not (loss_rel <= PIPE_LOSS_REL and unequal[worst] <= PIPE_UNEQUAL_SHARE):
        raise AssertionError("the GPipe and 1F1B steps disagree")
    out["gpipe_vs_1f1b"] = {"loss_rel": loss_rel, "unequal_share": unequal[worst]}
    print(f"[pipe] phase wall time {elapsed():.1f} s")
    return out


# phase compress: the quantised-wire collectives and compressed gradient
# training of comm/compression.py.  The bounds are the JAX package's own
# (tests/test_compression.py): a compressed ring's output within int8 0.04,
# fp8 0.15 and int8 with bf16 accumulation 0.08 of the largest exact sum
# from the uncompressed op's output on the same payload, and each step's
# loss of the compressed dp=2 step within int8 0.02 and fp8 0.05 relative of
# the uncompressed dp=2 step's; beside them the dp=2 gradient's wire-step
# bound (_compress_train).  The quantiser on the card must equal its run
# on the CPU bit for bit: every value is scaled into +-127 or +-448, where the
# IEEE division, round-half-even and the fp8 conversion round alike.
COMPRESS_RING_TOL = {("int8", "float32"): 0.04, ("fp8", "float32"): 0.15,
                     ("int8", "bfloat16"): 0.08}
COMPRESS_LOSS_REL = {"int8": 0.02, "fp8": 0.05}
# the coarsest wire step as a fraction of a chunk's amax (int8: amax / 127;
# fp8 e4m3: the top binade [256, 448] is spaced by 32, amax / 14), and the
# bf16 roundings beside the wire, both in the dp=2 gradient bound
# (_compress_train)
COMPRESS_QSTEP = {"int8": 127.0, "fp8": 14.0}
COMPRESS_BF16_SLACK = 8 * 2.0 ** -8
COMPRESS_VARIANTS = ("default", "compress_int8", "compress_fp8", "compress_int8_bf16acc")
COMPRESS_OPS = ("allreduce", "allreduce_q", "reducescatter", "reducescatter_q")
# (grad_compression, ZeRO stage, accumulation) of the dp=2 runs, the
# uncompressed one first
COMPRESS_RUNS = (("none", 0, "float32"), ("int8", 0, "float32"), ("fp8", 0, "float32"),
                 ("int8", 2, "bfloat16"))
# the 1B train config's depth in the dp=2 runs: two ranks' states, flat fp32
# gradients and residuals share one card, and the phase stays short
COMPRESS_LAYERS = 8
COMPRESS_STEPS = 3
COMPRESS_RING_N = 4194304  # the sweep's "16MB" label, here in fp32
DP1_REFUSAL = ("training.grad_compression with data_parallel=1 has no gradient "
               "reduction to compress")


def _compress_quantizer(torch, n, gpu_line):
    """The quantiser at ``n`` elements on the card against its run on the
    CPU copy of the input: the wire bytes, scales, dequantised values and
    quantisation error, each compared bit for bit; then quantise plus
    dequantise timed by CUDA events (median of 10)."""
    from dlbb_tpu_torch.comm import compression as qc
    from dlbb_tpu_torch.analysis.expectations import padded_elems, scale_bytes

    g = torch.Generator(device="cuda").manual_seed(42)
    x = torch.randn(n, generator=g, device="cuda")
    # magnitudes over five decades, as gradients span them
    x.mul_(torch.pow(10.0, torch.randint(-3, 2, (n,), generator=g, device="cuda",
                                         dtype=torch.int8).float()))
    host = x.cpu()
    out, reps = {}, 10
    for comp in qc.COMPRESSIONS:
        q, s = qc.quantize_chunked(x, comp)
        qh, sh = qc.quantize_chunked(host, comp)
        diff = {"wire": int((qc._to_wire(q, comp).cpu() != qc._to_wire(qh, comp)).sum()),
                "scales": int((s.cpu().view(torch.int32) != sh.view(torch.int32)).sum())}
        d = qc.dequantize_chunked(q, s, n).cpu().view(torch.int32)
        diff["dequantized"] = int((d != qc.dequantize_chunked(qh, sh, n).view(torch.int32)).sum())
        del q, s, qh, sh, d
        e = qc.quantization_error(x, comp).cpu().view(torch.int32)
        diff["error"] = int((e != qc.quantization_error(host, comp).view(torch.int32)).sum())
        del e
        times = []
        for i in range(reps + 1):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            qq, ss = qc.quantize_chunked(x, comp)
            y = qc.dequantize_chunked(qq, ss, n)
            end.record()
            torch.cuda.synchronize()
            if i:  # the first call is a warmup
                times.append(start.elapsed_time(end))
            del qq, ss, y
        torch.cuda.empty_cache()
        # quantise reads x and writes the wire and scales, dequantise reads
        # them and writes fp32
        nbytes = 4 * n + 2 * (padded_elems(n) + scale_bytes(n)) + 4 * n
        ms = statistics.median(times)
        out[comp] = {"mismatches": diff, "ms": ms, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
        print(f"[compress] quantiser {comp} at {n} elements (the 1B train config's "
              f"parameters), cuda against the CPU: differing wire bytes "
              f"{diff['wire']}, scales {diff['scales']}, dequantised values "
              f"{diff['dequantized']}, quantisation errors {diff['error']}; quantise + "
              f"dequantise {ms:.3f} ms (median of {reps}, CUDA events; bytes bound "
              f"{out[comp]['bound_ms']:.3f} ms) on {gpu_line}")
        if any(diff.values()):
            raise AssertionError(f"the {comp} quantiser on the card differs from the CPU: {diff}")
    del x, host
    return out


def _compress_sweeps(torch, gpu_line):
    """The compressed ops and their baselines under each variant at world 1
    over NCCL at ``runner.DATA_SIZES_1D``, then ``cli stats1d`` and ``cli
    reports`` over the results; returns the largest size's medians."""
    import os
    import shutil
    import tempfile

    from dlbb_tpu_torch import cli, comm
    from dlbb_tpu_torch.bench import runner

    sizes, warmup, iters = list(runner.DATA_SIZES_1D.items()), 10, 100
    out = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_compress"
    shutil.rmtree(out, ignore_errors=True)
    impls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_compress_") as tmp:
        comm.initialize_distributed("nccl", 0, 1, os.path.join(tmp, "store"))
        try:
            mesh = comm.get_mesh(comm.MeshSpec.ring(1))
            for kind in ("allreduce", "reducescatter"):
                x = comm.make_payload(comm.get_op(kind), 0, 1, sizes[-1][1], device="cuda")
                want = comm.get_op(kind).build(mesh)(x)
                for v in COMPRESS_VARIANTS[1:]:
                    compression, accum = comm.get_variant(v).compressed_wire()
                    got = comm.get_op(kind + "_q").build(
                        mesh, compression=compression, accum_dtype=accum)(x)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{kind}_q under {v} at one rank is not "
                                             f"{kind}: a ring of one rank is the identity")
            for v in COMPRESS_VARIANTS:
                impl = "torch_nccl" + ("" if v == "default" else f"_{v}")
                t0 = time.perf_counter()
                r = runner.run_sweep(runner.Sweep1D(
                    variant=v, operations=COMPRESS_OPS, data_sizes=tuple(sizes),
                    rank_counts=(1,), warmup_iterations=warmup,
                    measurement_iterations=iters,
                    output_dir=str(out / "results" / "1d" / impl)), device="cuda",
                    verbose=False)
                _check_results(r, len(COMPRESS_OPS) * len(sizes), iters)
                impls[v] = impl
                print(f"[compress] sweep under {v}: {len(r.written)} configs in "
                      f"{time.perf_counter() - t0:.1f} s")
        finally:
            comm.destroy_distributed()
    stats = out / "stats"
    for v, impl in impls.items():
        if cli.main(["stats1d", "--input", str(out / "results" / "1d" / impl),
                     "--output", str(stats / "variants" / impl)]) != 0:
            raise AssertionError(f"stats1d failed on {impl}")
    shutil.copytree(stats / "variants" / impls["default"], stats / "1d" / impls["default"])
    if cli.main(["reports", "--stats", str(stats), "--results", str(out / "results"),
                 "--impl", impls["default"]]) != 0:
        raise AssertionError("cli reports wrote nothing")
    for report, table in (("variants/VARIANTS.md", "variants/variants_comparison.csv"),
                          ("northstar/NORTHSTAR.md", "northstar/northstar_allreduce.csv")):
        with (stats / table).open() as f:
            rows = list(csv.DictReader(f))
        if not (stats / report).is_file() or not rows:
            raise AssertionError(f"cli reports left {report} without rows")
        print(f"[compress] cli reports: {stats / report}, {len(rows)} rows in {table}")
    medians = {}
    label = sizes[-1][0]
    for v, impl in impls.items():
        with (stats / "variants" / impl / "benchmark_statistics.csv").open() as f:
            for row in csv.DictReader(f):
                if row["data_size_name"] == label:
                    medians[(v, row["operation"])] = (float(row["median_time_us"]),
                                                      int(row["bytes_on_wire"] or 0))
    print(f"[compress] world 1 over nccl, bf16, {label} ({sizes[-1][1]} elements) on "
          f"{gpu_line}: median us per op (at one rank the compressed ring is the identity, "
          "as in JAX, and bytes_on_wire is 0 for every op: these times are the call alone) "
          + ", ".join(f"{v}/{op} {m:.2f} ({w} B on the wire)"
                      for (v, op), (m, w) in sorted(medians.items())))
    return medians


def _compress_ring_ops(device):
    """Phase compress (c)'s job of the one gloo spawn, on a ring of its first
    two ranks: the uncompressed and compressed ops on the same CUDA payload,
    and the bytes each compressed call handed to ``torch.distributed``;
    None past the ring."""
    import torch

    from dlbb_tpu_torch.comm import MeshSpec, get_mesh, get_op, make_payload
    from dlbb_tpu_torch.comm.compression import count_wire_bytes

    mesh = get_mesh(MeshSpec.ring(2))
    if mesh is None:
        return None
    res = {}
    for kind in ("allreduce", "reducescatter"):
        x = make_payload(get_op(kind), mesh.rank, 2, COMPRESS_RING_N,
                         dtype=torch.float32, device=device)
        res[kind] = get_op(kind).build(mesh)(x).cpu()
        for comp, accum in COMPRESS_RING_TOL:
            with count_wire_bytes() as counted:
                y = get_op(f"{kind}_q").build(mesh, compression=comp,
                                              accum_dtype=accum)(x)
            res[(kind, comp, accum)] = {"out": y.cpu(), "bytes": counted["bytes"],
                                        "device": str(y.device)}
    return res


def _compress_ring(torch, ranks):
    """Phase compress (c)'s checks on the ranks' ``_compress_ring_ops``."""
    from dlbb_tpu_torch.comm import get_op, make_payload
    from dlbb_tpu_torch.analysis.expectations import op_wire_bytes

    world, n = 2, COMPRESS_RING_N
    errors = {}
    for kind in ("allreduce", "reducescatter"):
        xs = [make_payload(get_op(kind), r, world, n, dtype=torch.float32).double()
              for r in range(world)]
        exact = sum(xs)  # allreduce: [n]; reducescatter: [P, n], row k to rank k
        for (comp, accum), tol in COMPRESS_RING_TOL.items():
            outs = [r[(kind, comp, accum)] for r in ranks]
            want = op_wire_bytes(f"{kind}_q", n, world, 4, compression=comp)
            worst = 0.0
            for rank, (o, r) in enumerate(zip(outs, ranks)):
                ref = exact if kind == "allreduce" else exact[rank:rank + 1]
                scale = ref.abs().max().item()
                worst = max(worst, (o["out"].double() - ref).abs().max().item() / scale,
                            (o["out"].double() - r[kind].double()).abs().max().item() / scale)
            same = all(torch.equal(o["out"], outs[0]["out"]) for o in outs)
            counted = [o["bytes"] for o in outs]
            print(f"[compress] {kind}_q {comp}, {accum} accumulation, world 2 over gloo "
                  f"(CUDA tensors, hops through host memory), {n} fp32 elements: largest "
                  f"difference from the exact sum and from {kind} {worst:.3e} of the largest "
                  f"sum (bound {tol}); bytes handed to torch.distributed per rank {counted} "
                  f"(op_wire_bytes {want}, uncompressed fp32 "
                  f"{op_wire_bytes(kind, n, world, 4)}); a correctness check, not a speed")
            if worst > tol or counted != [want] * world or not all(
                    o["device"].startswith("cuda") for o in outs):
                raise AssertionError(f"{kind}_q {comp}/{accum} at world 2 failed its check")
            if kind == "allreduce" and not same:
                raise AssertionError(f"allreduce_q {comp}/{accum}: the ranks' results differ")
            errors[f"{kind}_q/{comp}/{accum}"] = {"rel_err": worst, "bytes": want}
    return errors


def _compress_config():
    from dlbb_tpu_torch.utils.config import load_config

    config = load_config(TRAIN_CONFIG)
    config["experiment"]["name"] = "chip_smoke_1b_compressed_dp2"
    config["model"]["num_layers"] = COMPRESS_LAYERS
    config["parallelism"] = {"world_size": 1, "data_parallel": 2}
    return config


def _params_digest(params):
    """sha256 of the parameters' bytes, leaf by leaf in ``tree_leaves``
    order: equal on two ranks exactly when their parameters are bit-equal."""
    import hashlib

    import torch

    from dlbb_tpu_torch.train.optim import tree_leaves

    h = hashlib.sha256()
    for p in tree_leaves(params):
        h.update(p.detach().reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def _compress_train_runs(config, device):
    """Phase compress (d)'s job of the one gloo spawn, on its first two
    ranks (dp=2), None past them.  For each run:
    step 0's dp-reduced gradient against the uncompressed run's (same
    parameters, same batch), then ``COMPRESS_STEPS`` steps with the flash
    launches counted from 0 around each, the losses, a digest of the
    parameters after them, the share of parameters that differ from the
    uncompressed run's, and the residual."""
    import torch
    import torch.distributed as dist

    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.train.loop import make_train_step, mse_loss
    from dlbb_tpu_torch.train.optim import build_optimizer, moments_dtype, tree_leaves, tree_map
    from dlbb_tpu_torch.train.zero import shard_along

    model_cfg = ModelConfig.from_dict(config["model"])
    plan = _job_plan(config, model_cfg)
    if plan is None:
        return None
    group = plan.mesh.axis_groups["dp"]
    batch, targets = _dtrain_batch(config, model_cfg, "cuda", plan.mesh.coords, plan.dp)
    out, base = {}, {}
    for comp, stage, accum in COMPRESS_RUNS:
        train = dict(config["training"], grad_compression=comp,
                     compression_accum_dtype=accum)
        step, state = make_train_step(
            model_cfg, build_optimizer(train),
            init_params(model_cfg, config["input"]["seed"], "cuda"), mesh=plan.mesh,
            zero_stage=stage, grad_compression=comp, compression_accum=accum,
            residual_dtype=moments_dtype(train),
            batch_size=config["input"]["batch_size"])
        rec = {"losses": [], "launches": []}
        # step 0's reduced gradient: no update has run, so every run
        # starts from the same parameters and batch
        _, grads = step.grads(state, batch, targets)
        if comp == "none":
            base["grads"] = grads
            # the largest local gradient element over the dp ranks,
            # which bounds every partial sum on the ring
            loss = mse_loss(state.params, batch, targets, model_cfg)
            g = torch.autograd.grad(loss, tree_leaves(state.params))
            c_max = torch.stack([a.float().abs().max() for a in g]).max().reshape(1).cpu()
            del loss, g
            dist.all_reduce(c_max, op=dist.ReduceOp.MAX, group=group)
            base["c_max"] = float(c_max)
        else:
            # under ZeRO-2 a rank holds its shard of the reduced gradient
            ref = tree_map(lambda g, ax: shard_along(g, ax, step.zero.rank, plan.dp),
                           base["grads"], step.zero.opt_axes)
            rec["grad_diff"] = max(float((a.float() - b.float()).abs().max())
                                   for a, b in zip(tree_leaves(grads), tree_leaves(ref)))
            rec["grad_max"] = max(float(b.float().abs().max()) for b in tree_leaves(ref))
        rec["c_max"] = base["c_max"]
        del grads
        t0 = time.perf_counter()
        for _ in range(COMPRESS_STEPS):
            _zero_flash_counts(fa)
            state, loss = step(state, batch, targets)
            rec["losses"].append(float(loss))
            rec["launches"].append(_flash_counts(fa))
        rec["seconds"] = time.perf_counter() - t0
        rec["params_digest"] = _params_digest(state.params)
        if comp == "none":
            base["params"] = tree_map(lambda p: p.detach().clone(), state.params)
        else:
            pairs = list(zip(tree_leaves(state.params), tree_leaves(base["params"])))
            rec["params_differ"] = (sum(int((a != b).sum()) for a, b in pairs)
                                    / sum(a.numel() for a, _ in pairs))
            res = state.opt_state[1].residual
            rec.update(residual_finite=bool(torch.isfinite(res).all()),
                       residual_absmax=float(res.float().abs().max()),
                       residual_dtype=str(res.dtype), residual_numel=res.numel())
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del step, state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[(comp, stage, accum)] = rec
    return out


def _compress_train(torch, gpu_line, ranks):
    """Phase compress (d): the dp=2 runs and their checks (module docstring).

    Step 0's reduced gradient of a compressed run against the uncompressed
    run's, element by element: at dp=2 a value passes two quantisers (the
    ring's hop and the gather), each partial is at most 2 c_max (c_max the
    largest local gradient element over the ranks), and each rounds by less
    than one wire step of its chunk's amax (``COMPRESS_QSTEP``), so the sum
    differs by at most 2 * 2 c_max / QSTEP and the dp mean by
    dp * c_max / QSTEP; the bf16 roundings beside it (the gradients, the
    uncompressed sum, the cast of the result and, with bf16 accumulation,
    the hop's dequantise and add) add at most 8 half-ulps of c_max,
    ``COMPRESS_BF16_SLACK``.  A ring that was skipped or a mean that was not
    divided by dp moves the gradient by the size of the gradient itself.
    The parameters after the steps must be bit-equal on the two ranks: a
    rank that updated on its own gradient would diverge.  The losses must
    track the uncompressed run within JAX's bounds."""
    from dlbb_tpu_torch.models import ModelConfig
    from dlbb_tpu_torch.models.transformer import num_parameters

    config = _compress_config()
    model_cfg = ModelConfig.from_dict(config["model"])
    layers, dp = model_cfg.num_layers, 2
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    base = ranks[0][COMPRESS_RUNS[0]]["losses"]
    out = {"launches": None, "runs": {}}
    for run in COMPRESS_RUNS:
        recs = [r[run] for r in ranks]
        comp, stage, accum = run
        losses = recs[0]["losses"]
        if any(r["losses"] != losses for r in recs) or not all(map(math.isfinite, losses)):
            raise AssertionError(f"dp=2 {run}: losses differ across ranks or are not finite")
        if any(r["params_digest"] != recs[0]["params_digest"] for r in recs):
            raise AssertionError(f"dp=2 {run}: the ranks' parameters differ after "
                                 f"{COMPRESS_STEPS} steps")
        for r in recs:
            if any(n != per_step for n in r["launches"]):
                raise AssertionError(f"dp=2 {run}: flash launches {r['launches']}, "
                                     f"expected {per_step} per step")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base))
        line = (f"[compress] {config['model'].get('size', 'the')} train config, hidden "
                f"{model_cfg.hidden_size}, {layers} layers, dp=2, "
                f"ZeRO-{stage}, two processes on one card over gloo: grad_compression "
                f"{comp}" + (f", {accum} accumulation" if comp != "none" else "")
                + f": losses {', '.join(f'{x:.6f}' for x in losses)}; the ranks' "
                f"parameters bit-equal after {COMPRESS_STEPS} steps")
        if comp != "none":
            c_max = recs[0]["c_max"]
            grad_bound = c_max * (dp / COMPRESS_QSTEP[comp] + COMPRESS_BF16_SLACK)
            grad_diff = max(r["grad_diff"] for r in recs)
            grad_max = max(r["grad_max"] for r in recs)
            bound = COMPRESS_LOSS_REL[comp]
            res_ok = all(r["residual_finite"] and r["residual_absmax"] > 0 for r in recs)
            line += (f"; step 0's reduced gradient against the uncompressed run's: largest "
                     f"difference {grad_diff:.3e} (bound {grad_bound:.3e} from c_max "
                     f"{c_max:.3e}; the largest reduced gradient element is {grad_max:.3e}); "
                     f"share of parameters that differ from the uncompressed run's after "
                     f"{COMPRESS_STEPS} steps {max(r['params_differ'] for r in recs):.3e}; "
                     f"largest relative difference from the uncompressed losses {rel:.3e} "
                     f"(bound {bound}); residual {recs[0]['residual_dtype']} "
                     f"[{recs[0]['residual_numel']}], finite and non-zero: {res_ok}, "
                     f"max |r| {max(r['residual_absmax'] for r in recs):.3e}")
            if (grad_diff > grad_bound or rel > bound or not res_ok
                    or recs[0]["residual_numel"] != num_parameters(model_cfg)):
                raise AssertionError(f"the compressed dp=2 run {run} failed its check")
            out["launches"] = recs[0]["launches"][-1]
        line += (f"; flash launches per step per rank {recs[0]['launches'][-1]}; "
                 f"{max(r['seconds'] for r in recs):.1f} s for {COMPRESS_STEPS} steps, peak "
                 f"{max(r['peak_gib'] for r in recs):.2f} GiB per rank; not timed, on {gpu_line}")
        print(line)
        out["runs"][f"{comp}/zero{stage}/{accum}"] = {
            "losses": losses, "loss_rel": rel,
            "grad_diff": max(r.get("grad_diff", 0.0) for r in recs),
            "seconds": max(r["seconds"] for r in recs)}
    return out


def _compress_gloo_jobs():
    """Phase compress's gloo jobs: (c)'s ring ops and (d)'s train runs."""
    return [("compress_ring",), ("compress_train", _compress_config())]


def phase_compress(torch, gpu_line, results):
    """Phase 12 (module docstring); ``results``: its gloo jobs'
    (``_compress_gloo_jobs``, ``_run_gloo_jobs``)."""
    from dlbb_tpu_torch import cli
    from dlbb_tpu_torch.models import ModelConfig
    from dlbb_tpu_torch.models.transformer import num_parameters
    from dlbb_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    # the 1B's flat gradient, as run_train counts it
    quant_n = num_parameters(ModelConfig.from_dict(load_config(TRAIN_CONFIG)["model"]))
    out = {"quantizer": _compress_quantizer(torch, quant_n, gpu_line)}
    torch.cuda.empty_cache()
    out["sweeps"] = _compress_sweeps(torch, gpu_line)
    ring, train = results
    print(f"[compress] (c) and (d) in the one gloo spawn: {ring['seconds']:.1f} and "
          f"{train['seconds']:.1f} s in the ranks")
    out["ring"] = _compress_ring(torch, ring["ranks"])
    out["train"] = _compress_train(torch, gpu_line, train["ranks"])
    try:
        cli.main(["train", "--config", TRAIN_CONFIG, "--grad-compression", "int8"])
    except ValueError as e:
        if DP1_REFUSAL not in str(e):
            raise
        print(f"[compress] cli train --grad-compression int8 at world 1 refused: {e}")
    else:
        raise AssertionError("cli train --grad-compression int8 at world 1 was not refused")
    print(f"[compress] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# phase bench: bench_torch.py runs in a subprocess under this limit (its 7B
# extras each init 13 GB of weights)
BENCH_TIMEOUT_S = 900


def _run_bench_script(torch, gpu_line):
    """``python3 bench_torch.py`` in a subprocess, as it is run from the
    command line: exit 0, one stdout line with bench.py's keys, every extra, finite
    positive fields, and no ``failed``."""
    import subprocess

    import bench_torch

    torch.cuda.empty_cache()  # the script's 7B needs the card's memory
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "bench_torch.py"], capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S,
                          cwd=Path(__file__).resolve().parent)
    for line in proc.stderr.splitlines():
        print(f"[bench] bench_torch.py: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {proc.returncode}: {proc.stdout!r}")
    lines = proc.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench_torch.py printed {len(lines)} stdout lines, not 1")
    out = json.loads(lines[0])
    want = [bench_torch.extra_key(*e) for e in bench_torch.EXTRAS] + [bench_torch.TRAIN_EXTRA]
    if list(out)[:4] != ["metric", "value", "unit", "vs_baseline"] or "failed" in out:
        raise AssertionError(f"bench_torch.py's line: {lines[0]}")
    if list(out.get("extras", {})) != want:
        raise AssertionError(f"extras {list(out.get('extras', {}))}, expected {want}")
    for name, extra in [("headline", {"value": out["value"]}), *out["extras"].items()]:
        for key, x in extra.items():
            if key != "remat_policy" and not (math.isfinite(x) and x > 0):
                raise AssertionError(f"bench_torch.py {name}.{key} = {x}")
    print(f"[bench] {gpu_line}: {lines[0]}")
    print(f"[bench] bench_torch.py: {time.perf_counter() - t0:.1f} s wall")


def phase_bench(torch, fa, gpu_line):
    """Phase 13 (module docstring)."""
    import bench_torch
    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params

    _run_bench_script(torch, gpu_line)
    configs = [("1B", "simplified", bench_torch.E2E_SEQ), *bench_torch.EXTRAS]
    launches = {}
    for size in sorted({c[0] for c in configs}, reverse=True):
        model_cfg = ModelConfig.from_dict({"size": size})
        params = init_params(model_cfg, 42, "cuda")
        for sz, attention, seq in configs:
            if sz != size:
                continue
            key = ("headline" if (sz, attention, seq) == configs[0]
                   else bench_torch.extra_key(sz, attention, seq))
            cfg = model_cfg.with_(attention=attention)
            batch = create_dataset_from_config(
                {"input": {"batch_size": bench_torch.E2E_BATCH, "sequence_length": seq,
                           "seed": 42}, "model": {}},
                dtype=torch.bfloat16, device="cuda",
                hidden_size=cfg.hidden_size).get_batch()
            fa.flash_fwd_launches = 0
            with torch.inference_mode():
                y = forward(params, batch, cfg)
            torch.cuda.synchronize()
            launches[key] = fa.flash_fwd_launches
            expected = cfg.num_layers if attention in ("full", "flash") and seq >= 512 else 0
            if launches[key] != expected:
                raise AssertionError(f"{key}: {launches[key]} flash launches per forward, "
                                     f"expected {expected}")
            if y.shape != batch.shape or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{key}: output {tuple(y.shape)} not finite of the "
                                     "input's shape")
            note = f"{key}: {launches[key]} flash launches per forward (expected {expected})"
            if attention in ("full", "flash"):
                # at S=8192 dense attention holds fp32 scores of [B, 16, S, S]:
                # 34 GB per tensor at B=8, 4.3 GB for batch row 0 alone
                rows = slice(0, 1) if seq > 1024 else slice(None)
                with torch.inference_mode():
                    y_dense = forward(params, batch[rows], cfg.with_(attention="dense"))
                rel = _rel_l2(y[rows], y_dense)
                note += (f"; against dense on {'batch row 0' if seq > 1024 else 'the batch'}"
                         f": relative L2 {rel:.3e} (tolerance {E2E_REL_L2})")
                if not rel <= E2E_REL_L2:
                    raise AssertionError(f"{key}: the kernel path disagrees with dense")
                del y_dense
            print(f"[bench] {size} {note}")
            del y, batch
        del params
        torch.cuda.empty_cache()
    return launches


KV_MAX_BATCH, KV_MAX_SEQ, KV_BLOCK = 32, 2048, 16
KV_CPU_LAYERS = (0, 23)   # the layers whose codes and scales the CPU checks
KV_SLOTS = 8              # slots gathered and scattered back
KV_REPS = 5


def phase_kv(torch, gpu_line):
    """Phase 14 (module docstring)."""
    import tempfile

    from dlbb_tpu_torch.obs import spans

    with tempfile.TemporaryDirectory(prefix="chip_smoke_kv_",
                                     dir=Path(__file__).resolve().parent) as out:
        trace = Path(out) / "spans.json"
        with spans.tracing(trace, meta={"phase": "kv", "device": gpu_line}):
            _kv(torch, gpu_line)
        events = spans.load_trace(trace)["traceEvents"]
    problems = spans.validate_trace_events(events)
    if problems:
        raise AssertionError(f"phase kv's span trace: {problems}")
    print(f"[kv] span trace of {len(events)} events: valid "
          f"({', '.join(e['name'] for e in events if e['ph'] == 'B')})")


def _kv(torch, gpu_line):
    from dlbb_tpu_torch.models import ModelConfig
    from dlbb_tpu_torch.models.configs import kv_cache_bytes
    from dlbb_tpu_torch.obs import spans
    from dlbb_tpu_torch.serve import kvcache as kv

    cfg = ModelConfig.from_dict({"size": "1B"})
    nb = KV_MAX_SEQ // KV_BLOCK
    with spans.span("kv-build", cat="kv"):
        cache = kv.create_kv_cache(cfg, KV_MAX_BATCH, nb, KV_BLOCK, device="cuda")
        g = torch.Generator(device="cuda")
        g.manual_seed(42)
        for plane in (cache.k, cache.v):
            for layer in plane:
                layer.normal_(generator=g)
        # all-zero blocks and heads take the guarded scale 1.0
        cache.k[KV_CPU_LAYERS[0], 3, 5] = 0
        cache.v[KV_CPU_LAYERS[1], 7, :4, :, 2] = 0
        cache.lengths.copy_(torch.randint(0, KV_MAX_SEQ + 1, (KV_MAX_BATCH,), generator=g,
                                          device="cuda", dtype=torch.int32))
    plane_bytes = cache.k.nbytes
    want = kv_cache_bytes(cfg, KV_MAX_BATCH, KV_MAX_SEQ)
    print(f"[kv] 1B serving cache on the card: K and V each {list(cache.k.shape)} "
          f"{cache.k.dtype}, {plane_bytes} bytes per plane, {2 * plane_bytes / 2**30:.1f} GiB "
          f"in all; kv_cache_bytes {want}")
    if 2 * plane_bytes != want or plane_bytes != 6_442_450_944:
        raise AssertionError("the cache's bytes are not kv_cache_bytes")

    with spans.span("kv-quantize", cat="kv"):
        qc = kv.create_quant_kv_cache(cfg, KV_MAX_BATCH, nb, KV_BLOCK, device="cuda")
        for name in ("k", "v"):
            for layer, x in enumerate(getattr(cache, name)):
                q, s = kv.quantize_kv_blocks(x)
                getattr(qc, name)[layer].copy_(q)
                getattr(qc, f"{name}_scale")[layer].copy_(s)
        qc.lengths.copy_(cache.lengths)
    q_bytes = sum(getattr(qc, f).nbytes for f in ("k", "v", "k_scale", "v_scale"))
    q_want = kv_cache_bytes(cfg, KV_MAX_BATCH, KV_MAX_SEQ, "int8", KV_BLOCK)
    print(f"[kv] int8 cache: {q_bytes} bytes of codes and scales; kv_cache_bytes(int8, "
          f"block_size={KV_BLOCK}) {q_want}")
    if q_bytes != q_want:
        raise AssertionError("the int8 cache's bytes are not kv_cache_bytes(int8)")

    with spans.span("kv-cpu-check", cat="kv", layers=str(KV_CPU_LAYERS)):
        for layer in KV_CPU_LAYERS:
            for name in ("k", "v"):
                q_cpu, s_cpu = kv.quantize_kv_blocks(getattr(cache, name)[layer].cpu())
                q, s = getattr(qc, name)[layer], getattr(qc, f"{name}_scale")[layer]
                codes = int((q.cpu() != q_cpu).sum())
                scales = int((s.cpu() != s_cpu).sum())
                deq = kv.dequantize_kv_blocks(q, s, torch.bfloat16).cpu()
                deq_diff = int((deq != kv.dequantize_kv_blocks(q_cpu, s_cpu,
                                                               torch.bfloat16)).sum())
                q2, _ = kv.quantize_kv_blocks(kv.dequantize_kv_blocks(q, s, torch.float32))
                requant = int((q2 != q).sum())
                zero_blocks = int((s_cpu == 1.0).sum())
                print(f"[kv] layer {layer} {name.upper()}: card vs CPU {codes} codes, "
                      f"{scales} scales, {deq_diff} dequantised bf16 values differ of "
                      f"{q.numel()} and {s.numel()}; requantised codes differing "
                      f"{requant}; {zero_blocks} scales at the guard 1.0")
                if codes or scales or deq_diff or requant:
                    raise AssertionError("the quantiser on the card is not the CPU's")
                del q_cpu, s_cpu, deq, q2

    def roundtrip():
        for plane in (cache.k, cache.v):
            for x in plane:
                q, s = kv.quantize_kv_blocks(x)
                kv.dequantize_kv_blocks(q, s, x.dtype)

    with spans.span("kv-time", cat="kv", reps=KV_REPS):
        roundtrip()
        times = []
        for _ in range(KV_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            roundtrip()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    # quantise reads the bf16 cache and writes codes and scales; dequantise
    # reads those and writes the bf16 cache
    moved = 2 * (want + q_want)
    bound_ms = moved / PEAK_BYTES_PER_S * 1e3
    print(f"[kv] quantise + dequantise of the whole cache (48 layer planes, torch ops) on "
          f"{gpu_line}: median {ms:.3f} ms of {KV_REPS} ({', '.join(f'{t:.3f}' for t in times)}); "
          f"bytes bound {bound_ms:.3f} ms ({moved} bytes at {PEAK_BYTES_PER_S / 1e12:.2f} "
          f"TB/s), {ms / bound_ms:.1f}x the bound")
    del qc

    with spans.span("kv-slots", cat="kv", slots=KV_SLOTS):
        gen = torch.Generator().manual_seed(7)
        idx = torch.randperm(KV_MAX_BATCH, generator=gen)[:KV_SLOTS]
        perm = idx[torch.randperm(KV_SLOTS, generator=gen)]
        host = kv.KVCache(*(t.cpu() for t in cache))

        def same(card, cpu):
            return all(_same_planes(torch, x, y) for x, y in zip(card, cpu))

        small = kv.gather_cache_slots(cache, idx.cuda())
        small_host = kv.gather_cache_slots(host, idx)
        gathered = same(small, small_host)
        kv.scatter_cache_slots(cache, small, idx.cuda())
        identity = same(cache, host)
        kv.scatter_cache_slots(cache, small, perm.cuda())
        kv.scatter_cache_slots(host, small_host, perm)
        permuted = same(cache, host)
    print(f"[kv] slots {idx.tolist()} gathered ({list(small.k.shape)}) and scattered back: "
          f"gather equal to the CPU's {gathered}, round trip the identity {identity}, "
          f"scattered to {perm.tolist()} equal to the CPU's {permuted}")
    if not (gathered and identity and permuted):
        raise AssertionError("slot gather/scatter on the card is not the CPU's")


# phase serve (a): one sequence of SERVE_SEQ tokens, a SERVE_PROMPT-token
# prompt prefilled into slot SERVE_SLOT, the rest decoded with the true next
# inputs fed in (tests/test_serve.py's equivalence case at the 1B's width)
SERVE_EQUIV = dict(max_batch=4, block_size=16, max_seq=1024)
SERVE_SEQ, SERVE_PROMPT, SERVE_SLOT = 1024, 640, 2
# The cached path against the one-shot "full" forward, relative L2 over the
# prompt's last output and the 384 decoded ones.  The serving programs are a
# dense-attention forward computed in pieces: fp32 scores and softmax as
# dense_attention (the prefill calls it; decode's cached attention is the
# same math on one query row), while "full" at S=1024 runs the flash kernel,
# which rounds P and o to bf16.  So their difference is the kind the kernel
# path has from dense (E2E_REL_L2's argument; phase bench reads it for the
# 1B at S=1024), plus the bf16 roundings of GEMMs at another shape (M=1 per
# decode step against M=1024), each within a bf16 half-ulp (2^-9 relative)
# of the same exact product, carried by the same 24 residual layers as the
# kernel's: the same bound holds both.
SERVE_REL_L2 = E2E_REL_L2
# (a'): the prompt prefilled again in SERVE_CHUNK-token chunks (3, the last
# partial) into the same slot of a fresh cache.  Chunked attention is the
# monolithic prefill's fp32 math over the same bf16 K/V (the prefix carry is
# the earlier chunks' exact values), and only the GEMMs run at another shape
# (M=256 against M=640): bf16 roundings, each within a half-ulp of the same
# exact product, carried by 24 residual layers, the second part of
# SERVE_REL_L2's argument without the flash kernel's rounding, so the same
# bound holds the chunked outputs and K/V rows against the monolithic ones,
# and the chunked output at the last prompt position against "full".
SERVE_CHUNK = 256
# The int8 prefill's blocks against the bf16 prefill's: attention runs over
# the exact values, so both write the same K/V and the int8 one rounds each
# to q*s with s = amax/127 per block and kv head; |x - q*s| <= s/2 plus the
# fp32 roundings of x/s and of q*s (each within 127 * 2^-24 of s), so every
# error stays under (0.5 + 2^-10) / 127 of its block's and head's amax.
SERVE_INT8_REL = (0.5 + 2 ** -10) / 127
# phase serve (b): the cache of phase kv, 64 requests on 32 slots
SERVE_ENGINE = dict(max_batch=32, block_size=16, max_seq=2048, queue_capacity=64)
SERVE_REQUESTS = 64
SERVE_PROMPTS, SERVE_OUTPUTS = (128, 1024), (32, 128)
# once in each mode; (g)1 and (g)2 serve the greedy run again, under faults,
# and must give its tokens
SERVE_MODES = ("off", "greedy")
# phase serve (d): the fast path on (b)'s trace.  ServingConfig.validate
# (JAX's) refuses compaction, int8 planes and the prefix cache in a token
# mode, so (d)2 and (e) run in "off" and compare with "off" runs.
SERVE_FAST = (
    ("fused", "greedy", dict(decode_horizon=8, inflight_window=2)),
    ("fused+chunked+compact", "off", dict(decode_horizon=8, inflight_window=2,
                                          prefill_chunk=SERVE_CHUNK, compact_threshold=0.5)),
)
# phase serve (e): a shared-prefix trace (4 groups sharing 512-token prefixes)
SERVE_PREFIX_PROMPTS, SERVE_PREFIX_GROUPS, SERVE_PREFIX_LEN = (600, 1024), 4, 512
SERVE_PREFIX_RUNS = (
    ("chunked", dict(prefill_chunk=SERVE_CHUNK)),
    ("prefix", dict(prefill_chunk=SERVE_CHUNK, prefix_caching=True)),
    ("prefix+int8", dict(prefill_chunk=SERVE_CHUNK, prefix_caching=True,
                         kv_quantization="int8")),
)
# each group's first request of the first wave of 32 misses; the other 28
# find a resident group member
SERVE_PREFIX_MIN_HITS = 28
# phase serve (f): speculative and sampled decoding.  (f)0 on (a)'s 4-slot
# cache, each slot holding one of these prompts (request seeds 100-103)
SERVE_VERIFY_PROMPTS = (640, 300, 1000, 128)
SERVE_SPEC_GAMMA = 4
# the "ngram" verify unit at γ=4 when it ran every position in one batched
# call, so that its rows were not the decode step's bits: phase serve (f)3
# on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §5)
SERVE_VERIFY_BEFORE_MS = 52.973
# (f)1, greedy speculation on (b)'s engine and trace
SERVE_SPEC_GREEDY = (
    ("ngram", dict(speculation="ngram", spec_gamma=SERVE_SPEC_GAMMA)),
    ("draft-model", dict(speculation="draft-model", spec_gamma=SERVE_SPEC_GAMMA,
                         spec_draft_layers=1)),
    ("ngram+adaptive+fused", dict(speculation="ngram", spec_gamma=8, spec_adaptive=True,
                                  decode_horizon=8, inflight_window=2)),
)
# (f)2, sampled speculation: "ngram" with these knobs under each seed
SERVE_SPEC_SAMPLED = dict(speculation="ngram", spec_gamma=SERVE_SPEC_GAMMA, temperature=0.8)
SERVE_SPEC_SEEDS = (3, 3, 4)
# (f)1's second "ngram" run and (f)2's runs serve the short trace: (b)'s
# first 16 requests, each output cut to at most 32 tokens (a greedy run's
# tokens are then the first ones of (b)'s).  On (b)'s whole trace a sampled
# run took about 28 s at a 125 ms verify unit (202 units).
SERVE_SPEC_SHORT = (16, 32)
# (f)1's "draft-model" run serves the short trace too: on (b)'s whole trace
# it took 35 s (202 verify units at 155 ms, acceptance 0.0007: the one-layer
# random draft almost never agrees), the script's time limit
SERVE_SPEC_ON_SHORT = ("draft-model",)
# phase serve (g): the fault plans, on (b)'s greedy engine and trace.  The
# hang outlasts the watchdog's deadline (50 x the step EMA, about 2.3 s at
# 46 ms a step) by more than twice, so the abandoned thread wakes after the
# engine has moved on.
SERVE_FAULT_RUNS = (
    ("(g)1", "serve-decode-fail:2", {}),
    ("(g)2", "serve-cache-torn:1", {}),
    ("(g)3", "serve-decode-hang:@3,hang_seconds=6", dict(dispatch_deadline_factor=50.0)),
)
SERVE_PREEMPT = "serve-preempt:@5"
SERVE_CONFIG = "dlbb_tpu_torch/configs/serve_1b.yaml"
SERVE_ARTIFACTS = ("metrics.prom", "serving_manifest.json", "serving_serve_1b.json",
                   "sweep_journal.jsonl", "trace_serve_1b.json")


class _SpecTally:
    """A journal stand-in for the engine (it calls ``event``): the
    ``spec-verify`` events' commits summed in memory, with no file or
    fsync in the timed run."""

    def __init__(self):
        self.committed = 0
        self.slot_verifies = 0

    def event(self, event, config=None, **extra):
        if event == "spec-verify":
            self.committed += extra["committed"]
            self.slot_verifies += 1


def phase_serve(torch, fa, gpu_line):
    """Phase 15 (module docstring)."""
    import tempfile

    from dlbb_tpu_torch.obs import spans

    t0 = time.perf_counter()
    launches = _serve_equivalence(torch, fa, gpu_line)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_",
                                     dir=Path(__file__).resolve().parent) as tmp:
        trace = Path(tmp) / "spans.json"
        with spans.tracing(trace, meta={"phase": "serve", "device": gpu_line}):
            runs, spec, ctx, tables = _serve_engine(torch, gpu_line)
        events = spans.load_trace(trace)["traceEvents"]
    problems = spans.validate_trace_events(events)
    if problems:
        raise AssertionError(f"phase serve's span trace: {problems}")
    begins = [e for e in events if e["ph"] == "B"]
    counts = {n: sum(1 for e in begins if e["name"] == n)
              for n in ("serve-admission", "serve-prefill", "serve-prefill-chunk",
                        "serve-prefix-attach", "serve-decode", "serve-verify")}
    fused = sum(1 for e in begins if e["name"] == "serve-decode" and e["args"]["steps"] > 1)
    print(f"[serve] span trace of {len(events)} events: valid; B spans {counts}, "
          f"{fused} of the serve-decode ones fused scans")
    verify_units = sum(r["speculation"]["verify_units"] for r in runs)
    want = {"serve-prefill": sum(len(r["completed_tokens"]) for r in runs),
            "serve-decode": sum(r["decode_units"] for r in runs) - verify_units,
            "serve-verify": verify_units,
            "serve-prefill-chunk": sum(r["fast_path"]["prefill_chunks"] for r in runs),
            "serve-prefix-attach": sum(r["prefix"]["hits"] for r in runs)}
    if any(counts[n] != v for n, v in want.items()) \
            or fused != sum(r["fast_path"]["fused_scans"] for r in runs):
        raise AssertionError(f"the span trace does not match the reports: {want}")
    _serve_spec_numbers(spec, events, gpu_line)
    _serve_bench_tables(tables, spec)
    _serve_faults(torch, gpu_line, *ctx)
    print(f"[serve] phase wall {time.perf_counter() - t0:.1f} s")
    return launches


def _serve_bench_tables(tables, spec):
    """(h): records shaped as the bench scripts' ``BENCH_serve.json``,
    ``BENCH_spec.json`` and ``BENCH_prefix.json`` from this phase's runs
    ((b)'s greedy per-step run and (d)1's fused one; (f)1's greedy
    speculative runs on (b)'s whole trace against (b)'s greedy run; (e)'s prefix
    runs against its no-sharing one), through the port's three writers in a
    temporary directory: each table's rows and speedups must be the ratios
    this phase measured.  No request is served."""
    import tempfile

    from dlbb_tpu_torch.stats import serving_report as sr
    from dlbb_tpu_torch.utils.config import save_json

    def tps(report):
        v = report["goodput_tokens_per_s"]
        return {"median": v, "min": v, "max": v, "reps": [v]}

    def ms(report, key):
        return round(report[key]["median"] * 1e3, 3)

    def row(report, **keys):
        return {"output_tokens_per_s": tps(report), "ttft_p50_ms": ms(report, "ttft"),
                "per_token_p50_ms": ms(report, "per_token_latency"),
                "decode_units": report["decode_units"], **keys}

    per, (fused, knobs) = tables["per_step"], tables["fused"]
    k = knobs["decode_horizon"]
    serve = {"schema": "dlbb_bench_serve_v1", "baseline": "per_step", "settings": {
        "per_step": row(per, trace="b", decode_horizon=1),
        f"fused_k{k}": row(fused, trace="b", decode_horizon=k)}}
    want_serve = {"per_step": 1.0, f"fused_k{k}": round(
        fused["goodput_tokens_per_s"] / per["goodput_tokens_per_s"], 3)}
    greedy = dict(SERVE_SPEC_GREEDY)
    spec_rows = {"greedy_per_step": row(per, speculation="greedy", decode_horizon=1)}
    want_spec = {"greedy_per_step": 1.0}
    for run in spec:
        if run["goodput_ratio"] is None:  # the short trace's runs
            continue
        s = run["report"]["speculation"]
        spec_rows[run["label"]] = row(
            run["report"], speculation=s["mode"], spec_gamma=run["gamma"],
            decode_horizon=greedy[run["label"]].get("decode_horizon", 1),
            acceptance_rate=s["acceptance_rate"], mean_accepted_len=s["mean_accepted_len"],
            draft_overhead_s=s["draft_overhead_s"], token_identical=True)
        want_spec[run["label"]] = round(run["goodput_ratio"], 3)
    spec_b = {"schema": "dlbb_bench_spec_v1", "baseline": "greedy_per_step",
              "settings": spec_rows}
    base_label = SERVE_PREFIX_RUNS[0][0]
    base = tables["prefix"][base_label]
    ptrace = tables["ptrace"]
    prefix_rows, want_prefix = {}, {}
    for label, pknobs in SERVE_PREFIX_RUNS:
        rep = tables["prefix"][label]
        ttft = round(ms(base, "ttft") / ms(rep, "ttft"), 3)
        good = round(rep["goodput_tokens_per_s"] / base["goodput_tokens_per_s"], 3)
        prefix_rows[f"e/{label}"] = row(
            rep, trace="e", prefix_caching=pknobs.get("prefix_caching", False),
            kv_quantization=pknobs.get("kv_quantization", "none"),
            prefix_hit_rate=rep["prefix"]["hit_rate"],
            tokens_reused=rep["prefix"]["tokens_reused"],
            baseline=f"e/{base_label}", ttft_speedup_vs_baseline=ttft,
            goodput_speedup_vs_baseline=good)
        want_prefix[f"e/{label}"] = (ttft, good)
    prefix_b = {"schema": "dlbb_bench_prefix_v1", "settings": prefix_rows, "traces": {"e": {
        "shared_token_share": sum(r.prefix_len or 0 for r in ptrace)
        / sum(r.prompt_len for r in ptrace),
        "prefix_groups": SERVE_PREFIX_GROUPS, "prefix_len": SERVE_PREFIX_LEN}}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tables_",
                                     dir=Path(__file__).resolve().parent) as tmp:
        got = {}
        for name, bench, writer, md in (
                ("fastpath", serve, sr.write_fastpath_report, "FASTPATH.md"),
                ("speculative", spec_b, sr.write_speculative_report, "SPECULATIVE.md"),
                ("prefix", prefix_b, sr.write_prefix_report, "PREFIX.md")):
            path = save_json(bench, Path(tmp) / f"{name}.json")
            got[name] = ({r["setting"]: r for r in writer(path, Path(tmp))},
                         (Path(tmp) / md).read_text())
    fast, fast_md = got["fastpath"]
    sp, sp_md = got["speculative"]
    pf, pf_md = got["prefix"]
    ok = ({n: r["speedup_vs_baseline"] for n, r in fast.items()} == want_serve
          and {n: r["speedup_vs_baseline"] for n, r in sp.items()} == want_spec
          and {n: (r["ttft_speedup"], r["goodput_speedup"]) for n, r in pf.items()}
          == want_prefix
          and all(f"{v:.2f}x" in fast_md for v in want_serve.values())
          and all(f"{v:.2f}x" in sp_md for v in want_spec.values())
          and all(f"{t:.2f}x | {g:.2f}x |" in pf_md for t, g in want_prefix.values()))
    print(f"[serve] (h) the bench writers on this phase's runs: FASTPATH.md speedups "
          f"{want_serve}; SPECULATIVE.md speedups against (b)'s greedy run {want_spec}; "
          f"PREFIX.md (TTFT, goodput) speedups against (e)1 {want_prefix}; each table's "
          f"rows the phase's ratios: {ok}")
    if not ok:
        raise AssertionError("a bench writer's table differs from the phase's own ratios")


def _span_durations_ms(events, name, within):
    """The durations of the ``name`` spans that begin inside each
    ``(t0, t1)`` of ``within`` (µs), one list per interval."""
    out = [[] for _ in within]
    begun = None
    for e in events:
        if e.get("name") != name or e["ph"] not in ("B", "E"):
            continue
        if e["ph"] == "B":
            begun = e["ts"]
            continue
        for i, (a, b) in enumerate(within):
            if a <= begun <= b:
                out[i].append((e["ts"] - begun) / 1e3)
    return out


def _serve_spec_numbers(spec, events, gpu_line):
    """(f)3, printed and not gated: each speculative run's verify units,
    fallbacks, proposed, accepted and committed tokens, tokens per verify
    unit, and the verify unit's median against its bytes bound (the
    weights and the whole cache read once, the γ+1 rows of every slot
    written, and for the draft model its γ steps over its own weights and
    cache), from the ``serve-verify`` spans of the run."""
    intervals, labels = [], []
    for e in events:
        if e.get("name") == "smoke-run" and e["ph"] == "B":
            labels.append(e["args"]["run"])
            intervals.append([e["ts"], None])
        elif e.get("name") == "smoke-run" and e["ph"] == "E":
            intervals[-1][1] = e["ts"]
    verify_ms = dict(zip(labels, _span_durations_ms(events, "serve-verify", intervals)))
    for run in spec:
        report, tally, label = run["report"], run["tally"], run["label"]
        s = report["speculation"]
        ms = verify_ms[label]
        median = statistics.median(ms) if ms else float("nan")
        bound = run["bound_bytes"] / PEAK_BYTES_PER_S * 1e3
        print(f"[serve] (f)3 {label} on {gpu_line}: {s['verify_units']} verify units, "
              f"{s['fallback_units']} fallbacks, {s['proposed_tokens']} tokens proposed, "
              f"{s['accepted_tokens']} accepted ({s['acceptance_rate']:.4f}), "
              f"{tally.committed} committed in {tally.slot_verifies} slot verifies "
              f"({tally.committed / max(s['verify_units'], 1):.2f} tokens per verify unit); "
              f"verify unit median {median:.3f} ms over {len(ms)} spans against its bytes bound "
              f"{bound:.3f} ms ({run['bound_bytes']} bytes at {PEAK_BYTES_PER_S / 1e12:.2f} "
              f"TB/s, gamma {run['gamma']}): {median / bound:.2f}x"
              + (f" (the batched verify, whose rows were not the step's: "
                 f"{SERVE_VERIFY_BEFORE_MS} ms)" if label == "ngram" else "")
              + f"; TTFT median "
              f"{report['ttft']['median'] * 1e3:.1f} ms; goodput "
              f"{report['goodput_tokens_per_s']:.1f} tokens/s, "
              + (f"{run['goodput_ratio']:.3f}x (b)'s greedy run's"
                 if run["goodput_ratio"] is not None else "on the short trace"))
        if len(ms) != s["verify_units"]:
            raise AssertionError(f"run {label}: {len(ms)} serve-verify spans for "
                                 f"{s['verify_units']} verify units")


def _serve_equivalence(torch, fa, gpu_line):
    """(a) and (a'): the 1B's prefill and decode programs against its
    one-shot "full" forward, then the chunked and the int8 prefills of the
    same prompt; returns that forward's flash launches (one per layer)."""
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.serve.engine import (
        ServingConfig,
        _inject_token,
        build_decode_step,
        build_prefill,
        build_prefill_chunk,
        create_prefix,
    )
    from dlbb_tpu_torch.serve.kvcache import create_kv_cache, create_quant_kv_cache

    cfg = ModelConfig.from_dict({"size": "1B"})
    params = init_params(cfg, 42, "cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(42)
    x = torch.randn((1, SERVE_SEQ, cfg.hidden_size), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    _zero_flash_counts(fa)
    with torch.inference_mode():
        y_full = forward(params, x, cfg)
    torch.cuda.synchronize()
    launches = fa.flash_fwd_launches
    with torch.inference_mode():
        y_dense = forward(params, x, cfg.with_(attention="dense"))
    print(f"[serve] 1B \"full\" forward of {SERVE_SEQ} tokens: {launches} flash_fwd "
          f"launches (expected {cfg.num_layers})")
    if launches != cfg.num_layers:
        raise AssertionError("the reference forward did not run the flash kernel per layer")

    sv = ServingConfig(**SERVE_EQUIV)
    sv.validate(cfg)
    cache = create_kv_cache(cfg, sv.max_batch, sv.num_blocks, sv.block_size, device="cuda")
    prefill, decode = build_prefill(cfg), build_decode_step(cfg)
    xp = torch.zeros((1, sv.bucket_for(SERVE_PROMPT), cfg.hidden_size), device="cuda",
                     dtype=torch.bfloat16)
    xp[:, :SERVE_PROMPT] = x[:, :SERVE_PROMPT]
    t0 = time.perf_counter()
    cache, y_last = prefill(cache, params, xp, SERVE_SLOT, SERVE_PROMPT)
    rows = [y_last]
    carry = (cache, torch.zeros((sv.max_batch, 1, cfg.hidden_size), device="cuda",
                                dtype=torch.bfloat16))
    active = torch.zeros(sv.max_batch, dtype=torch.bool, device="cuda")
    active[SERVE_SLOT] = True
    for i in range(SERVE_PROMPT, SERVE_SEQ):
        carry = _inject_token(carry, SERVE_SLOT, x[0, i])
        carry, y = decode(carry, params, active)
        rows.append(y[SERVE_SLOT, 0])
    got = torch.stack(rows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cache = carry[0]
    ref = y_full[0, SERVE_PROMPT - 1:]
    rel = _rel_l2(got, ref)
    rel_dense = _rel_l2(got, y_dense[0, SERVE_PROMPT - 1:])
    others = [s for s in range(sv.max_batch) if s != SERVE_SLOT]
    empty = all(int(p[:, s].count_nonzero()) == 0 for p in (cache.k, cache.v) for s in others)
    lengths = cache.lengths.tolist()
    print(f"[serve] 1B prefill of {SERVE_PROMPT} tokens (bucket {xp.shape[1]}) into slot "
          f"{SERVE_SLOT} and {SERVE_SEQ - SERVE_PROMPT} decode steps ({wall:.2f} s) on "
          f"{gpu_line}: relative L2 against the \"full\" forward {rel:.3e} (tolerance "
          f"{SERVE_REL_L2}), against the dense forward {rel_dense:.3e}; lengths {lengths}; "
          f"the other slots' planes zero {empty}")
    if not (bool(torch.isfinite(got).all()) and rel <= SERVE_REL_L2):
        raise AssertionError("the serving programs disagree with the one-shot forward")
    if lengths != [SERVE_SEQ if s == SERVE_SLOT else 0 for s in range(sv.max_batch)] \
            or not empty:
        raise AssertionError("the programs touched a slot they were not given")

    # (a'): the chunked prefill of the same prompt into a fresh cache
    def prompt_rows(c):
        """Slot SERVE_SLOT's K and V rows of the prompt, [L, 640, kvh, d]."""
        return [p[:, SERVE_SLOT].reshape(cfg.num_layers, -1, cfg.kv_heads,
                                         cfg.head_dim)[:, :SERVE_PROMPT] for p in (c.k, c.v)]

    n_chunks = -(-SERVE_PROMPT // SERVE_CHUNK)
    xc = torch.zeros((1, n_chunks * SERVE_CHUNK, cfg.hidden_size), device="cuda",
                     dtype=torch.bfloat16)
    xc[:, :SERVE_PROMPT] = x[:, :SERVE_PROMPT]
    chunked = create_kv_cache(cfg, sv.max_batch, sv.num_blocks, sv.block_size, device="cuda")
    prefix = create_prefix(cfg, device="cuda")
    t0 = time.perf_counter()
    for ci in range(n_chunks):
        chunked, prefix, y_chunk = build_prefill_chunk(cfg, chunk_len=SERVE_CHUNK,
                                                     start=ci * SERVE_CHUNK)(
            chunked, prefix, params, xc[:, ci * SERVE_CHUNK:(ci + 1) * SERVE_CHUNK],
            SERVE_SLOT, SERVE_PROMPT)
    torch.cuda.synchronize()
    chunk_wall = time.perf_counter() - t0
    mono_k, mono_v = prompt_rows(cache)
    chunk_k, chunk_v = prompt_rows(chunked)
    rels = {"y_last vs monolithic": _rel_l2(y_chunk, rows[0]),
            "K rows vs monolithic": _rel_l2(chunk_k, mono_k),
            "V rows vs monolithic": _rel_l2(chunk_v, mono_v),
            "y_last vs \"full\"": _rel_l2(y_chunk, y_full[0, SERVE_PROMPT - 1])}
    print(f"[serve] (a') chunked prefill of {SERVE_PROMPT} tokens in {n_chunks} chunks of "
          f"{SERVE_CHUNK} into slot {SERVE_SLOT} ({chunk_wall:.3f} s, prefix carry "
          f"{list(prefix[0].shape)}): relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tolerance {SERVE_REL_L2}); length {int(chunked.lengths[SERVE_SLOT])}")
    if not (bool(torch.isfinite(y_chunk).all()) and max(rels.values()) <= SERVE_REL_L2
            and int(chunked.lengths[SERVE_SLOT]) == SERVE_PROMPT):
        raise AssertionError("the chunked prefill disagrees with the monolithic one")
    del chunked, prefix

    # (a'): the int8 prefill's blocks against the bf16 prefill's
    quant = create_quant_kv_cache(cfg, sv.max_batch, sv.num_blocks, sv.block_size,
                                  device="cuda")
    quant, y_q = prefill(quant, params, xp, SERVE_SLOT, SERVE_PROMPT)
    # the prompt's blocks (the bf16 cache's later ones hold (a)'s decoded rows)
    wb = SERVE_PROMPT // sv.block_size
    worst = 0.0
    for name in ("k", "v"):
        exact = getattr(cache, name)[:, SERVE_SLOT, :wb].float()   # [L, wb, bs, kvh, d]
        deq = (getattr(quant, name)[:, SERVE_SLOT, :wb].float()
               * getattr(quant, f"{name}_scale")[:, SERVE_SLOT, :wb][:, :, None, :, None])
        amax = exact.abs().amax(dim=(2, 4))                            # [L, wb, kvh]
        err = (deq - exact).abs().amax(dim=(2, 4))
        worst = max(worst, float((err / torch.where(amax > 0, amax, 1.0)).max()))
    same_y = bool(torch.equal(y_q, rows[0]))
    print(f"[serve] (a') int8 prefill of the same prompt: its dequantised blocks against the "
          f"bf16 prefill's, worst error per block and kv head {worst:.4e} of the block's amax "
          f"(bound {SERVE_INT8_REL:.4e}); y_last equal to the bf16 prefill's bit for bit "
          f"{same_y}")
    if worst > SERVE_INT8_REL:
        raise AssertionError("the int8 prefill's blocks exceed the quantisation bound")
    del quant, cache, carry
    _serve_verify_program(torch, gpu_line, cfg, params)
    return launches


def _serve_verify_program(torch, gpu_line, cfg, params):
    """(f)0: the verify program against the per-step token decode.  From
    one cache of (a)'s geometry with its 4 slots prefilled, γ+1 per-step
    greedy token steps, then one ``build_verify_probs`` at γ with the
    per-step tokens as drafts: its γ+1 outputs bit-equal to the per-step
    ones (each position runs the step's own calls); ``build_verify_step``
    on the same inputs commits all γ+1."""
    from dlbb_tpu_torch.data.synthetic import request_embeddings, token_embedding_table
    from dlbb_tpu_torch.serve.engine import (
        ServingConfig,
        _inject_token_greedy,
        build_decode_step,
        build_prefill,
        build_verify_probs,
        build_verify_step,
    )
    from dlbb_tpu_torch.serve.kvcache import create_kv_cache

    g, h = SERVE_SPEC_GAMMA, cfg.hidden_size
    sv = ServingConfig(**SERVE_EQUIV)
    table = token_embedding_table(h, torch.bfloat16, device="cuda")
    carry = (create_kv_cache(cfg, sv.max_batch, sv.num_blocks, sv.block_size, device="cuda"),
             torch.zeros((sv.max_batch, 1, h), device="cuda", dtype=torch.bfloat16))
    prefill = build_prefill(cfg)
    for slot, prompt in enumerate(SERVE_VERIFY_PROMPTS):
        xp = request_embeddings(100 + slot, prompt, h, dtype=torch.bfloat16,
                                pad_to=sv.bucket_for(prompt), device="cuda")
        cache, y_last = prefill(carry[0], params, xp, slot, prompt)
        carry, _tok = _inject_token_greedy((cache, carry[1]), slot, y_last, table)

    def clone(c):
        cache, x = c
        return cache._replace(k=cache.k.clone(), v=cache.v.clone(),
                              lengths=cache.lengths.clone()), x.clone()

    active = torch.ones(sv.max_batch, dtype=torch.bool, device="cuda")
    decode = build_decode_step(cfg)
    step_carry, ys, toks = clone(carry), [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(g + 1):
        (cache, y), _ = decode(step_carry, params, active)
        tok = torch.argmax(y[:, 0], dim=-1).to(torch.int32)
        step_carry = (cache, table.index_select(0, tok)[:, None, :])
        ys.append(y[:, 0])
        toks.append(tok)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    ys, toks = torch.stack(ys, dim=1), torch.stack(toks, dim=1)       # [B, g+1, H], [B, g+1]
    drafts = toks[:, :g].contiguous()
    start.record()
    _carry, y_ver = build_verify_probs(cfg, gamma=g)(clone(carry), params, table, drafts, active)
    end.record()
    torch.cuda.synchronize()
    verify_ms = start.elapsed_time(end)
    rel = _rel_l2(y_ver, ys)
    bits = bool(torch.equal(y_ver, ys))
    same = int((torch.argmax(y_ver, dim=-1).to(torch.int32) == toks).sum())
    remaining = torch.full((sv.max_batch,), g + 1, dtype=torch.int32, device="cuda")
    vcarry, _vtok, commits = build_verify_step(cfg, gamma=g)(clone(carry), params, table,
                                                             drafts, active, remaining)
    lengths_equal = vcarry[0].lengths.tolist() == step_carry[0].lengths.tolist()
    print(f"[serve] (f)0 verify program on {gpu_line}: 4 slots (prompts "
          f"{list(SERVE_VERIFY_PROMPTS)}), {g + 1} per-step greedy token steps "
          f"({step_ms:.2f} ms) against one build_verify_probs at gamma {g} with their tokens "
          f"as drafts ({verify_ms:.2f} ms): bit-equal {bits} (relative L2 {rel:.3e}); "
          f"{same} of {toks.numel()} tokens equal; build_verify_step commits "
          f"{commits.tolist()}, lengths equal to the per-step run's {lengths_equal}")
    if not (bool(torch.isfinite(y_ver).all()) and bits
            and commits.tolist() == [g + 1] * sv.max_batch and lengths_equal):
        raise AssertionError("the verify program disagrees with the per-step token decode")


def _serve_run(torch, engine, trace, label, gpu_line):
    """One ``run_trace`` with peak memory and wall time, its numbers
    printed; returns the report."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = engine.run_trace(trace, collect_raw=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    req, ms = report["requests"], 1e3
    fp, pfx = report["fast_path"], report["prefix"]

    def q(block):
        return (f"median {report[block]['median'] * ms:.3f} ms, "
                f"p99 {report[block]['p99'] * ms:.3f} ms")

    print(f"[serve] run {label} on {gpu_line}: {req['completed']} completed, "
          f"{req['rejected']} rejected; TTFT {q('ttft')}; per-token latency "
          f"{q('per_token_latency')}; decode step (one per unit) {q('decode_step_time')} over "
          f"{report['decode_steps']} steps in {report['decode_units']} units "
          f"({fp['fused_scans']} fused scans, {fp['compacted_scans']} compacted, "
          f"{fp['single_steps']} single steps); prefill {q('prefill_time')} "
          f"({fp['prefill_chunks']} chunks); prefix hits {pfx['hits']} "
          f"({pfx['tokens_reused']} tokens reused); goodput "
          f"{report['goodput_tokens_per_s']:.1f} tokens/s; run wall "
          f"{report['wall_seconds']:.2f} s (warm-up {report['compile_time_s']:.2f} s, call "
          f"{wall:.2f} s); peak memory {peak} bytes ({peak / 2**30:.2f} GiB); blocks reserved "
          f"at the end {report['cache']['blocks_reserved']}")
    if req["completed"] != len(trace) or req["rejected"] != 0 \
            or report["cache"]["blocks_reserved"] != 0:
        raise AssertionError(f"run {label} did not serve every request")
    return report


def _serve_engine(torch, gpu_line):
    """(b)-(f): ``run_trace`` at the cache of phase kv, per-step in each mode
    of ``SERVE_MODES``, the fast path, the prefix cache and the int8 planes,
    the decode steps against their bytes bounds, then speculative and
    sampled decoding; returns the reports and (f)'s runs."""
    import dataclasses

    from dlbb_tpu_torch.models import ModelConfig, init_params, num_parameters
    from dlbb_tpu_torch.models.configs import kv_cache_bytes
    from dlbb_tpu_torch.serve.engine import ServingConfig, ServingEngine
    from dlbb_tpu_torch.serve.traffic import generate_trace

    cfg = ModelConfig.from_dict({"size": "1B"})
    params = init_params(cfg, 42, "cuda")
    weight_bytes = num_parameters(cfg) * 2
    total = torch.cuda.get_device_properties(0).total_memory
    budget_gb = (total - weight_bytes) / 2**30
    cache_bytes = kv_cache_bytes(cfg, SERVE_ENGINE["max_batch"], SERVE_ENGINE["max_seq"])
    int8_bytes = kv_cache_bytes(cfg, SERVE_ENGINE["max_batch"], SERVE_ENGINE["max_seq"],
                                "int8", SERVE_ENGINE["block_size"])

    def at_t0(trace):
        # every arrival at t=0: twice as many requests as slots, so slots are
        # freed and granted again, in an order that does not depend on timing
        return dataclasses.replace(trace, requests=tuple(
            dataclasses.replace(r, arrival_s=0.0) for r in trace.requests))

    def engine(mode, **knobs):
        sv = ServingConfig(**SERVE_ENGINE, hbm_budget_gb=budget_gb, speculation=mode, **knobs)
        # the draft model's weights come from seed 43, as JAX derives its
        # draft from the engine's seed + 1
        return ServingEngine(cfg, sv, params=params, capture_tokens=True, verbose=False,
                             device="cuda", seed=42)

    def same_tokens(a, b):
        return sum(a["completed_tokens"][rid] == b["completed_tokens"][rid]
                   for rid in a["completed_tokens"])

    trace = at_t0(generate_trace("poisson", SERVE_REQUESTS, seed=42, prompt_range=SERVE_PROMPTS,
                                 output_range=SERVE_OUTPUTS))
    print(f"[serve] engine: 1B bf16, {SERVE_ENGINE}, hbm_budget_gb {budget_gb:.3f} (the "
          f"card's {total} bytes less {weight_bytes} bytes of weights); the cache "
          f"{cache_bytes} bytes; {SERVE_REQUESTS} requests at t=0, prompts "
          f"{sum(r.prompt_len for r in trace)} tokens, outputs "
          f"{sum(r.output_len for r in trace)} tokens")
    reports, steps = [], []
    engines = {}
    per_step = {}
    tables = {}
    for i, mode in enumerate(SERVE_MODES):
        if mode not in engines:
            engines[mode] = engine(mode)
        report = _serve_run(torch, engines[mode], trace, f"{i + 1} ({mode})", gpu_line)
        reports.append(report)
        steps.append((f"{i + 1} ({mode})", report, cache_bytes))
        per_step.setdefault(mode, []).append(report)
    del engines

    # (d) the fast path on the same trace
    for i, (label, mode, knobs) in enumerate(SERVE_FAST):
        eng = engine(mode, **knobs)
        report = _serve_run(torch, eng, trace, f"(d){i + 1} {label} ({mode}, {knobs})",
                            gpu_line)
        if label == "fused":
            _serve_capture(torch, eng, gpu_line)
        del eng
        reports.append(report)
        steps.append((f"(d){i + 1} {label}", report, cache_bytes))
        fp = report["fast_path"]
        same = same_tokens(report, per_step[mode][0])
        print(f"[serve] (d){i + 1}: tokens equal to the per-step {mode} run's for {same} of "
              f"{SERVE_REQUESTS} requests")
        if label == "fused" and not (same == SERVE_REQUESTS and fp["fused_scans"] > 0
                                     and report["decode_units"] < report["decode_steps"]):
            raise AssertionError("the fused decode differs from the per-step one")
        if label == "fused":
            tables["fused"] = (report, knobs)
        if label != "fused" and not (fp["prefill_chunks"] > 0 and fp["compacted_scans"] > 0):
            raise AssertionError("chunked prefill or compaction did not engage")

    # (e) the prefix cache and the int8 planes on a shared-prefix trace
    ptrace = at_t0(generate_trace("poisson", SERVE_REQUESTS, seed=42,
                                  prompt_range=SERVE_PREFIX_PROMPTS, output_range=SERVE_OUTPUTS,
                                  prefix_groups=SERVE_PREFIX_GROUPS,
                                  prefix_len=SERVE_PREFIX_LEN))
    print(f"[serve] (e) shared-prefix trace: {SERVE_REQUESTS} requests at t=0 in "
          f"{SERVE_PREFIX_GROUPS} groups sharing {SERVE_PREFIX_LEN}-token prefixes, prompts "
          f"{sum(r.prompt_len for r in ptrace)} tokens, outputs "
          f"{sum(r.output_len for r in ptrace)} tokens")
    prefix_runs = {}
    for i, (label, knobs) in enumerate(SERVE_PREFIX_RUNS):
        report = _serve_run(torch, engine("off", **knobs), ptrace,
                            f"(e){i + 1} {label} (off, {knobs})", gpu_line)
        reports.append(report)
        steps.append((f"(e){i + 1} {label}", report,
                      int8_bytes if "int8" in label else cache_bytes))
        prefix_runs[label] = report
    base, pfx, quant = (prefix_runs[k] for k, _ in SERVE_PREFIX_RUNS)
    hits = pfx["prefix"]["hits"]
    same = same_tokens(pfx, base)
    cache = pfx["cache"]
    print(f"[serve] (e)2: tokens equal to the no-sharing run's for {same} of {SERVE_REQUESTS} "
          f"requests; {hits} hits (at least {SERVE_PREFIX_MIN_HITS}), "
          f"{pfx['prefix']['tokens_reused']} tokens reused, peak shared blocks "
          f"{cache['peak_shared_blocks']}; at the end shared blocks {cache['shared_blocks']}, "
          f"prefix refs {cache['prefix_refs']}, blocks reserved {cache['blocks_reserved']}")
    if not (same == SERVE_REQUESTS and hits >= SERVE_PREFIX_MIN_HITS
            and pfx["prefix"]["tokens_reused"] == SERVE_PREFIX_LEN * hits
            and cache["shared_blocks"] == cache["prefix_refs"] == cache["blocks_reserved"] == 0):
        raise AssertionError("the prefix cache changed tokens, missed, or kept blocks")
    print(f"[serve] (e)3: tokens equal to (e)2's for {same_tokens(quant, pfx)} of "
          f"{SERVE_REQUESTS} requests; {quant['prefix']['hits']} hits; the int8 cache "
          f"{int8_bytes} bytes against the bf16 layout's {cache_bytes} "
          f"({int8_bytes / cache_bytes:.4f})")
    for label, report, kv_bytes in steps:
        bound = (weight_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3
        # a unit's interval holds its k steps: the mean step is their sum
        # over the steps
        step_ms = sum(report["raw_samples"]["decode_step_s"]) * 1e3 / report["decode_steps"]
        median = report["decode_step_time"]["median"] * 1e3
        print(f"[serve] {label}: decode step {step_ms:.3f} ms (mean over "
              f"{report['decode_steps']} steps; unit median {median:.3f} ms) against its bytes "
              f"bound {bound:.3f} ms (weights {weight_bytes} + the whole cache {kv_bytes} "
              f"bytes read once at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; the step reads the "
              f"whole cache, masked, whatever the lengths): {step_ms / bound:.2f}x; per unit "
              f"median {median / bound:.2f}x")
    spec = _serve_spec_runs(torch, gpu_line, cfg, engine, trace,
                            per_step["greedy"][0], weight_bytes + cache_bytes)
    tables.update(per_step=per_step["greedy"][0], prefix=prefix_runs, ptrace=ptrace)
    return (reports + [run["report"] for run in spec], spec,
            (engine, trace, per_step["greedy"][0], weight_bytes, cache_bytes), tables)


def _serve_capture(torch, eng, gpu_line):
    """(d): after the fused run, ``capture_device_traces`` on the same
    engine: one prefill and one fused decode scan on fresh state, their
    phases, and ``obs devtrace`` on a run directory that records them."""
    from dlbb_tpu_torch.obs.devtrace import analyze_capture, parse_capture
    from dlbb_tpu_torch.utils.config import save_json

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_",
                                     dir=Path(__file__).resolve().parent) as tmp:
        metas = eng.capture_device_traces(Path(tmp) / "dev")
        if [m.get("phase") for m in metas] != ["prefill", "decode"] \
                or metas[1].get("decode_steps_per_scan", 0) < 1:
            raise AssertionError(f"the serving capture's metas: {metas}")
        ok = _cupti_verdict(metas, "serve (d) capture")
        run = Path(tmp) / "run"
        run.mkdir()
        save_json({"schema": "dlbb_serving_report_v1", "observability": {
            "device_trace_dir": str(Path(tmp) / "dev"), "device_captures": metas}},
            run / "serving_chip_smoke.json")
        _devtrace_rc(run, Path(tmp) / "report", ok)
        for m in metas if ok else ():
            a = analyze_capture(parse_capture(m["perfetto_trace"]))
            flash = sum(r["count"] for r in a["per_op"] if "flash_" in r["name"])
            print(f"[serve] (d) capture {m['label']} ({m['phase']}"
                  + (f", {m['decode_steps_per_scan']} steps per scan" if m["phase"] == "decode"
                     else "")
                  + f") on {gpu_line}: device us per bucket: {_bucket_line(a)}; "
                    f"{sum(r['count'] for r in a['per_op'])} device events, {flash} flash; "
                    f"{m['attempts']} session(s)")
    print(f"[serve] (d) capture_device_traces: phases {[m['phase'] for m in metas]}, obs "
          f"devtrace exit {0 if ok else 1}; {time.perf_counter() - t0:.1f} s")


def _serve_faults(torch, gpu_line, engine, trace, greedy, weight_bytes, cache_bytes):
    """(g): part 11d's failure paths and item 12's entry point on (b)'s
    engine and trace, outside the span trace of (b)-(f) (a retried or
    abandoned unit opens spans no report counts); each part's seconds
    printed and each check raising."""
    import os
    import subprocess
    import tempfile

    from dlbb_tpu_torch.resilience import inject

    def same_tokens(report):
        return sum(report["completed_tokens"].get(rid) == toks
                   for rid, toks in greedy["completed_tokens"].items())

    ms = 1e3
    for label, plan, knobs in SERVE_FAULT_RUNS:
        t0 = time.perf_counter()
        eng = engine("greedy", **knobs)
        fresh = eng._fresh_carry
        carries = []

        def counted(fresh=fresh, carries=carries):
            carries.append(1)
            return fresh()

        eng._fresh_carry = counted
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with inject.plan_scope(plan):
            report = eng.run_trace(trace, collect_raw=True)
        peak = torch.cuda.max_memory_allocated()
        req, res, cache = report["requests"], report["resilience"], report["cache"]
        # one fresh carry for the warm-up, one for the run; the rest resets
        resets = len(carries) - 2
        same = same_tokens(report)
        print(f"[serve] {label} {plan} on {gpu_line}: {req['completed']} completed, "
              f"{req['failed']} failed ({sorted(set(req['outcomes'].values()))}); retries "
              f"{res['retries']}, hung dispatches {res['hung_dispatches']}, carry resets "
              f"{resets}; tokens equal to (b)'s greedy run for {same} of {SERVE_REQUESTS} "
              f"requests; blocks reserved {cache['blocks_reserved']}, in use "
              f"{cache['blocks_in_use']}; decode step median "
              f"{report['decode_step_time']['median'] * ms:.3f} ms (watchdog "
              f"{'on' if knobs else 'off'}); peak memory {peak} bytes ({peak / 2**30:.2f} GiB); "
              f"{time.perf_counter() - t0:.1f} s; first failure "
              f"{res['failed'][0]['error'] if res['failed'] else None}")
        if cache["blocks_reserved"] or cache["blocks_in_use"]:
            raise AssertionError(f"{label} left blocks in the ledger")
        if label != "(g)3":
            if not (req["completed"] == SERVE_REQUESTS and same == SERVE_REQUESTS
                    and res["retries"] >= 1 and resets == 0):
                raise AssertionError(f"{label} did not recover every request with (b)'s tokens")
            continue
        failed = [rid for rid, o in req["outcomes"].items() if o == "failed[hung-dispatch]"]
        if not (res["hung_dispatches"] == 1 and resets == 1 and failed
                and req["failed"] == len(failed)
                and req["completed"] == SERVE_REQUESTS - len(failed)
                and peak < 2 * cache_bytes + weight_bytes):
            raise AssertionError("(g)3: the hung window did not fail closed on one reset "
                                 "within two caches and the weights")
        print(f"[serve] (g)3 decode step on {gpu_line}: watchdog off (b) "
              f"{greedy['decode_step_time']['median'] * ms:.3f} ms, on "
              f"{report['decode_step_time']['median'] * ms:.3f} ms (median per unit); "
              f"{len(failed)} requests of the hung window failed, peak {peak / 2**30:.2f} GiB "
              f"against two caches and the weights {(2 * cache_bytes + weight_bytes) / 2**30:.2f} "
              "GiB")
    del eng
    torch.cuda.empty_cache()

    from dlbb_tpu_torch.serve.bench import RESUME_CHECKPOINT, resume_serving, run_serving
    from dlbb_tpu_torch.utils.config import load_config

    root = Path(__file__).resolve().parent
    config = load_config(root / SERVE_CONFIG)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_g_", dir=root) as tmp:
        t0 = time.perf_counter()
        ref, out = Path(tmp) / "ref", Path(tmp) / "preempted"
        whole = run_serving(config, trace, str(ref), verbose=False)
        first = run_serving(config, trace, str(out), verbose=False, fault_plan=SERVE_PREEMPT)
        preempted = {rid for rid, o in first["requests"]["outcomes"].items() if o == "preempted"}
        checkpoint = (out / RESUME_CHECKPOINT).exists()
        merged = resume_serving(str(out), verbose=False)
        names = sorted(p.name for p in out.iterdir())
        moved = [rid for rid, o in whole["requests"]["outcomes"].items()
                 if rid not in preempted and merged["requests"]["outcomes"].get(rid) != o]
        print(f"[serve] (g)4 {SERVE_PREEMPT} through run_serving on {gpu_line}: preempted "
              f"{first['preempted']} after {first['requests']['completed']} completed, "
              f"{len(first['remaining_rids'])} remaining ({len(preempted)} resident), checkpoint "
              f"{checkpoint}; resume_serving: {merged['requests']['completed']} completed over "
              f"{merged['requests']['sessions']} sessions; artifact names {names}, equal to an "
              f"uninterrupted run's {names == sorted(p.name for p in ref.iterdir())}; outcomes "
              f"of the requests not preempted that differ {moved}; uninterrupted goodput "
              f"{whole['goodput_tokens_per_s']:.1f}, merged {merged['goodput_tokens_per_s']:.1f} "
              f"tokens/s; {time.perf_counter() - t0:.1f} s")
        if not (first["preempted"] and checkpoint and preempted
                and merged["requests"]["sessions"] == 2
                and merged["requests"]["completed"] == SERVE_REQUESTS
                and names == sorted(p.name for p in ref.iterdir()) == sorted(SERVE_ARTIFACTS)
                and not moved):
            raise AssertionError("(g)4: the resumed run is not the uninterrupted one")

        t0 = time.perf_counter()
        cli_out = Path(tmp) / "cli"
        cmd = [sys.executable, "-m", "dlbb_tpu_torch.cli", "serve", "--config", SERVE_CONFIG,
               "--trace", "poisson", "--requests", str(SERVE_REQUESTS), "--output",
               str(cli_out)]
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(root)})
        names = sorted(p.name for p in cli_out.iterdir()) if cli_out.is_dir() else []
        result = (json.loads((cli_out / "serving_serve_1b.json").read_text())
                  if "serving_serve_1b.json" in names else {})
        ttft = result.get("ttft", {})
        numbers = [result.get("goodput_tokens_per_s", math.nan)] + [
            ttft.get(q, math.nan) for q in ("median", "p99", "p999")]
        print(f"[serve] (g)5 `python -m dlbb_tpu_torch.cli serve --config {SERVE_CONFIG} "
              f"--trace poisson --requests {SERVE_REQUESTS}` on {gpu_line}: rc "
              f"{proc.returncode}; {proc.stdout.strip().splitlines()[-1:]}; artifacts {names}; "
              f"completed {result.get('requests', {}).get('completed')}; goodput "
              f"{numbers[0]:.1f} tokens/s, TTFT p50 {numbers[1] * ms:.3f} ms, p99 "
              f"{numbers[2] * ms:.3f} ms, p999 {numbers[3] * ms:.3f} ms; "
              f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0 or names != sorted(SERVE_ARTIFACTS) \
                or not all(math.isfinite(x) and x > 0 for x in numbers):
            raise AssertionError(f"(g)5: cli serve failed: {proc.stderr[-2000:]}")


def _serve_spec_runs(torch, gpu_line, cfg, engine, trace, greedy, base_bytes):
    """(f)1 and (f)2 on (b)'s engine setup and trace: greedy speculation
    ("ngram", "draft-model" on the short trace, and "ngram" with adaptive γ
    on the fused fast path), every request served at its full length with
    both ledgers clean, every request's tokens (b)'s greedy run's and
    "ngram" equal to itself on a second run, on the short trace
    (``SERVE_SPEC_SHORT``);
    then sampled speculation on the short trace, replayed by its seed and
    moved by another.  Each run inside a ``smoke-run`` span; returns the
    runs for (f)3."""
    import dataclasses
    import warnings

    from dlbb_tpu_torch.models import num_parameters
    from dlbb_tpu_torch.models.configs import kv_cache_bytes
    from dlbb_tpu_torch.obs import spans

    n_short, out_short = SERVE_SPEC_SHORT
    short = dataclasses.replace(trace, requests=tuple(
        dataclasses.replace(r, output_len=min(r.output_len, out_short))
        for r in trace.requests[:n_short]))
    # the rows a verify unit writes: K and V of every slot's γ+1 positions
    row_bytes = 2 * cfg.num_layers * SERVE_ENGINE["max_batch"] * cfg.kv_heads * cfg.head_dim * 2
    runs = []

    def run(label, knobs, on=trace):
        lengths = {str(r.rid): r.output_len for r in on}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = engine(knobs.pop("speculation"), **knobs)
        if not any(w.category is RuntimeWarning and "slower than greedy" in str(w.message)
                   for w in caught):
            raise AssertionError(f"the {label} engine on the card did not warn that "
                                 "speculation is slower than greedy decoding there")
        tally = _SpecTally()
        eng.journal = tally
        with spans.span("smoke-run", run=label):
            report = _serve_run(torch, eng, on, f"(f) {label} ({knobs})", gpu_line)
        draft = eng.draft_cache_stats
        full = all(len(t) == lengths[rid] for rid, t in report["completed_tokens"].items())
        print(f"[serve] (f) {label}: every request at its full output length {full}; the "
              f"draft ledger's blocks reserved at the end "
              f"{None if draft is None else draft['blocks_reserved']}")
        if not full or (draft is not None and draft["blocks_reserved"] != 0):
            raise AssertionError(f"run {label} cut a request short or kept draft blocks")
        gamma = eng.serving.spec_gamma
        bound = base_bytes + row_bytes * (gamma + 1)
        if eng.serving.speculation == "draft-model":
            dcfg = eng.serving.draft_model_config(cfg)
            bound += gamma * (num_parameters(dcfg) * 2 + kv_cache_bytes(
                dcfg, SERVE_ENGINE["max_batch"], SERVE_ENGINE["max_seq"]))
        runs.append({"label": label, "report": report, "tally": tally, "gamma": gamma,
                     "bound_bytes": bound,
                     "goodput_ratio": (report["goodput_tokens_per_s"]
                                       / greedy["goodput_tokens_per_s"] if on is trace
                                       else None)})
        return report

    # (f)1; a run on the short trace gives the first tokens of (b)'s
    greedy_spec = []
    for label, knobs in SERVE_SPEC_GREEDY:
        on = short if label in SERVE_SPEC_ON_SHORT else trace
        report = run(label, dict(knobs), on)
        ref = greedy["completed_tokens"]
        diff = {rid: next(i for i, (a, b) in enumerate(zip(got, ref[rid])) if a != b)
                for rid, got in report["completed_tokens"].items()
                if got != ref[rid][:len(got)]}
        print(f"[serve] (f)1 {label}: {len(on) - len(diff)} of {len(on)} requests "
              f"token-identical to (b)'s greedy run{'' if on is trace else ' (its first tokens)'}"
              f"; first differing position by request {diff}")
        if diff or report["speculation"]["verify_units"] == 0:
            raise AssertionError(f"greedy speculation ({label}) left (b)'s greedy tokens")
        if on is trace:
            greedy_spec.append(report)
        if label == "ngram":
            first_ngram = report
    agree = sum(len({tuple(r["completed_tokens"][rid]) for r in greedy_spec}) == 1
                for rid in greedy["completed_tokens"])
    print(f"[serve] (f)1 the {len(greedy_spec)} greedy speculative runs on (b)'s trace give one "
          f"another's tokens for {agree} of {SERVE_REQUESTS} requests (printed, not gated)")
    again = run("ngram again", dict(SERVE_SPEC_GREEDY[0][1]), short)
    same = sum(t == first_ngram["completed_tokens"][rid][:len(t)]
               for rid, t in again["completed_tokens"].items())
    print(f"[serve] (f)1 \"ngram\" run again on the short trace ((b)'s first {n_short} "
          f"requests, outputs cut to {out_short} tokens): {same} of {n_short} requests give "
          f"the first run's first tokens")
    if same != n_short:
        raise AssertionError("a second greedy \"ngram\" run gave other tokens")

    # (f)2
    sampled = [run(f"sampled seed {seed} #{i + 1}",
                   dict(SERVE_SPEC_SAMPLED, sample_seed=seed), short)
               for i, seed in enumerate(SERVE_SPEC_SEEDS)]
    replay = sampled[0]["completed_tokens"] == sampled[1]["completed_tokens"]
    moved = sum(sampled[0]["completed_tokens"][rid] != t
                for rid, t in sampled[2]["completed_tokens"].items())
    s = sampled[0]["speculation"]
    print(f"[serve] (f)2 sampled (temperature {s['temperature']}): seed "
          f"{SERVE_SPEC_SEEDS[0]} replayed token for token {replay}; seed {SERVE_SPEC_SEEDS[2]} "
          f"moved {moved} of {n_short} requests of the short trace; sampled {s['sampled']}, "
          f"{s['verify_units']} verify units")
    if not (replay and moved > 0 and s["sampled"] and s["verify_units"] > 0):
        raise AssertionError("the sampled runs did not replay by seed, or did not sample")
    return runs


# phase fleet: the fleet config's trace, one seeded Poisson stream of 32
# requests arriving over about 1.3 s (each replica's 16 slots hold its
# share), and the kill of (c), at the fleet's 100th loop boundary (both
# replicas counted): about halfway through the replicas' decoding, so
# residents fail over.
FLEET_CONFIG = "dlbb_tpu_torch/configs/serve_1b_fleet.yaml"
FLEET_TRACE = dict(kind="poisson", n=32, seed=7, rate=24.0, prompt_range=(128, 512),
                   output_range=(32, 96))
FLEET_KILL = "serve-replica-kill:@100"
FLEET_ARTIFACTS = ("fleet_serve_1b_fleet.json", "metrics.prom", "serving_manifest.json",
                   "sweep_journal.jsonl", "trace_serve_1b_fleet.json")


def _fleet_smoke_rank(*args):
    """One rank of phase fleet's launches: ``serve/fleet.py::fleet_rank``
    with the flash kernels' counts set to 0 just before and read just
    after, and the rank's peak device memory."""
    import torch

    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.serve.fleet import fleet_rank

    _zero_flash_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    out = fleet_rank(*args)
    out["flash_launches"] = _flash_counts(fa)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_fleet(torch, gpu_line):
    """Phase 17 (module docstring); returns the flash launches of the fleet
    runs' ranks (their serving programs run none)."""
    import os
    import tempfile

    from dlbb_tpu_torch.models import ModelConfig
    from dlbb_tpu_torch.serve.engine import ServingConfig, ServingEngine
    from dlbb_tpu_torch.serve.fleet import launch_fleet
    from dlbb_tpu_torch.serve.traffic import generate_trace
    from dlbb_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    config = load_config(FLEET_CONFIG)
    spec = dict(FLEET_TRACE)
    trace = generate_trace(spec.pop("kind"), spec.pop("n"), **spec)
    card = torch.cuda.get_device_properties(0).total_memory
    gib = 2 ** 30
    ms = 1e3

    def engine_time(label, rep):
        """One engine's decode-step median and the share of its run's wall
        its decode steps and prefills took, each time from dispatch to the
        device's completion: with two replicas on the card, a step median
        near the oracle's and a low share put the lost goodput on the host,
        a step median about twice the oracle's on the shared card."""
        d, p = rep["decode_step_time"], rep["prefill_time"]
        busy = sum(x["mean"] * x["count"] for x in (d, p) if x["count"])
        print(f"[fleet] {label}: decode step median {d['median'] * ms:.3f} ms, p99 "
              f"{d['p99'] * ms:.3f} ms over {d['count']} units; prefill median "
              f"{p['median'] * ms:.3f} ms over {p['count']}; steps and prefills "
              f"{busy:.2f} s of its {rep['wall_seconds']:.2f} s wall "
              f"({busy / rep['wall_seconds']:.3f})")

    def numbers(label, rep, peak, t0):
        ttft = rep["ttft"]
        print(f"[fleet] {label} on {gpu_line}: {rep['requests']['completed']} of {len(trace)} "
              f"completed; goodput {rep['goodput_tokens_per_s']:.1f} tokens/s, TTFT p50 "
              f"{ttft['median'] * ms:.3f} ms, p99 {ttft['p99'] * ms:.3f} ms; peak memory "
              f"{peak / gib:.2f} GiB of the card's {card / gib:.2f} GiB; "
              f"{time.perf_counter() - t0:.1f} s")

    # (a) the oracle: one engine on the fleet's serving section
    t0 = time.perf_counter()
    model = ModelConfig.from_dict(config["model"])
    serving = ServingConfig.from_dict(config["serving"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, serving, seed=config["input"]["seed"], verbose=False,
                           capture_tokens=True, device="cuda")
    oracle = engine.run_trace(trace)
    numbers("(a) single-engine oracle", oracle, torch.cuda.max_memory_allocated(), t0)
    engine_time("(a) single-engine oracle", oracle)
    del engine
    torch.cuda.empty_cache()
    if oracle["requests"]["completed"] != len(trace):
        raise AssertionError("the oracle did not complete every request")

    launches = {}
    for label, plan in (("(b) clean fleet", None), ("(c) killed fleet", FLEET_KILL)):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_",
                                         dir=Path(__file__).resolve().parent) as out:
            ranks = launch_fleet(_fleet_smoke_rank, config, trace, output_dir=out,
                                 verbose=False, fault_plan=plan, device="cuda", timeout=600)
            names = sorted(os.listdir(out))
        rep = ranks[0]["report"]
        peak = sum(r["peak_bytes"] for r in ranks)
        numbers(label, rep, peak, t0)
        for r in rep["replicas"]:
            if r["report"] is not None:
                where = "a thread of the supervisor's process" if r["replica"] == 0 \
                    else "a process of its own"
                engine_time(f"{label} replica {r['replica']} ({where})", r["report"])
        for r in ranks:
            for k, v in r["flash_launches"].items():
                launches[k] = launches.get(k, 0) + v
        fenced = [r for r in rep["replicas"] if r["status"] == "fenced"]
        survivors = [r for r in rep["replicas"] if r["status"] == "ok"]
        outcomes = set(rep["requests"]["outcomes"].values())
        same = sum(rep["completed_tokens"].get(rid) == toks
                   for rid, toks in oracle["completed_tokens"].items())
        fences = [(r["replica"], r["fence_reason"]) for r in fenced]
        print(f"[fleet] {label}: outcomes {sorted(outcomes)}; {same} of {len(trace)} requests "
              f"with the oracle's tokens; fenced {fences}; "
              f"failovers {rep['failovers']['total']} {rep['failovers']['by_reason']}; failover "
              f"TTFT penalty {rep['failover_ttft_penalty_s']} s; routed "
              f"{rep['routing']['per_replica']}; survivors' blocks reserved "
              f"{[r['report']['cache']['blocks_reserved'] for r in survivors]}; each rank's "
              f"peak {[round(r['peak_bytes'] / gib, 2) for r in ranks]} GiB; artifacts {names}")
        if outcomes != {"completed"} or same != len(trace) or names != sorted(FLEET_ARTIFACTS) \
                or any(r["report"]["cache"]["blocks_reserved"] != 0 for r in survivors) \
                or peak > card:
            raise AssertionError(f"{label} did not serve every request with the oracle's tokens")
        if plan is None and (fenced or rep["failovers"]["total"]):
            raise AssertionError("the clean fleet fenced a replica")
        if plan is not None and not (
                [r["fence_reason"] for r in fenced] == ["replica-killed"]
                and len(survivors) == 1 and rep["failovers"]["total"] >= 1
                and rep["failover_ttft_penalty_s"] is not None):
            raise AssertionError("the kill did not fence one replica and fail its residents over")
    print(f"[fleet] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


CHAOS_BUDGET_S = 120.0


def phase_chaos(torch, fa, gpu_line):
    """Phase 18 (module docstring); returns its flash launches, counted
    from 0 around it."""
    import shutil

    from dlbb_tpu_torch.resilience.chaos import run_chaos

    out = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_chaos"
    shutil.rmtree(out, ignore_errors=True)
    _zero_flash_counts(fa)
    t0 = time.perf_counter()
    rc = run_chaos(plan="all", output=str(out), device="cuda")
    wall = time.perf_counter() - t0
    launches = _flash_counts(fa)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"the chaos gate exited {rc}: a class was not green")
    print(f"[chaos] ten classes green on {gpu_line} in {wall:.1f} s (budget "
          f"{CHAOS_BUDGET_S:.0f} s: {'within' if wall <= CHAOS_BUDGET_S else 'OVER'}); "
          f"flash launches {launches}")
    return launches


# phase plan (a): the subcommands of ``python -m dlbb_tpu_torch`` (JAX's
# thirteen)
PLAN_SUBCOMMANDS = {"bench1d", "bench3d", "stats1d", "stats3d", "compare", "reports", "e2e",
                    "train", "serve", "analyze", "obs", "chaos", "plan"}
PLAN_FIT_MISSING = "cm2-fit-missing"


def phase_plan(torch, gpu_line):
    """Phase 19 (module docstring)."""
    import shutil
    import subprocess

    from dlbb_tpu_torch import cli
    from dlbb_tpu_torch.obs.attribution import _serving_report
    from dlbb_tpu_torch.resilience.journal import read_journal

    root = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    # (a) the package's entry point
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "dlbb_tpu_torch", "--help"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    listed = set(run.stdout.split("{", 1)[-1].split("}", 1)[0].split(","))
    if run.returncode != 0 or listed != PLAN_SUBCOMMANDS:
        raise AssertionError(f"python -m dlbb_tpu_torch --help: exit {run.returncode}, "
                             f"subcommands {sorted(listed)}; {run.stderr[-2000:]}")
    print(f"[plan] (a) python -m dlbb_tpu_torch --help: exit 0, {len(listed)} subcommands "
          f"{sorted(listed)}; {time.perf_counter() - t0:.1f} s")

    # (c) obs attribute on the runs earlier phases left: comm (d)'s traced
    # NCCL sweep (its device captures) and the chaos gate's clean serving run
    t0 = time.perf_counter()
    out = PLAN_OUT / "attribution"
    sweep = root / "chiprun_out" / "chip_smoke_comm" / "traced"
    if sweep.is_dir():
        rc, record = _attribute(sweep, out)
        _check_partition(record, "the comm sweep's attribution")
        configs = [e for e in record["entities"] if e.get("iterations")]
        with_dev = [e for e in configs if e.get("device_us")]
        cupti = CUPTI.get("ok", True)
        if rc != 0 or len(configs) != len(COMM_TRACE_OPS) \
                or (cupti and (len(with_dev) != len(configs)
                               or not record["device_us"].get("execute", 0) > 0)):
            raise AssertionError(f"obs attribute on {sweep}: exit {rc}, {len(configs)} "
                                 f"configs, {len(with_dev)} with device us, "
                                 f"{record['device_us']}")
        rc2, _ = _attribute(sweep, out / "cm2", model="cm2")
        if rc2 != 1:
            raise AssertionError(f"obs attribute --model cm2 on the cuda tier exited {rc2}: "
                                 "it must fail closed (no cuda fit)")
        print(f"[plan] (c) obs attribute (cm1, tier cuda) of comm (d)'s NCCL sweep on "
              f"{gpu_line}: {record['source']}, wall {record['wall_us'] / 1e3:.3f} ms = "
              + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in record["phases_us"].items())
              + " ms; device us per timed iteration (Kineto, one captured rep): "
              + ", ".join(f"{e['name']} {e.get('device_us')}" for e in configs)
              + f"; device execute {record['device_us'].get('execute')} us against "
              f"measured {sum(e['execute_us'] for e in configs):.1f} us and cm1's "
              f"{record['predicted_us']['execute']:.1f} us; --model cm2 exit 1 (no cuda fit)")
    else:
        print("[plan] (c) phase comm did not run in this call: no sweep to attribute")
    serve_runs = sorted((root / "chiprun_out" / "chip_smoke_chaos").rglob("serve_ref"))
    if serve_runs:
        rc, record = _attribute(serve_runs[0], out)
        _check_partition(record, "the chaos serving run's attribution")
        model = _serving_report(serve_runs[0])["model"]
        if rc != 0 or record["kind"] != "serving" or not record["entities"]:
            raise AssertionError(f"obs attribute on {serve_runs[0]}: exit {rc}, "
                                 f"{record['kind']}, {len(record['entities'])} requests")
        print(f"[plan] (c) obs attribute (cm1, tier cuda) of the chaos gate's clean serving "
              f"run (hidden {model['hidden_size']}, {model['num_layers']} layers, "
              f"{model['dtype']}; the gate's mini model, not the 1B): {record['source']}, "
              f"{len(record['entities'])} requests, wall {record['wall_us'] / 1e3:.3f} ms = "
              + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in record["phases_us"].items())
              + f" ms; {time.perf_counter() - t0:.1f} s")
    else:
        print("[plan] (c) phase chaos did not run in this call: no serving run to attribute")

    # (d) the autotuner and the capacity planner fail closed on the cuda tier
    t0 = time.perf_counter()
    for label, args, sub in (("auto serving", ["--auto", "--target", "serving"], ""),
                             ("auto train", ["--auto", "--target", "train"], ""),
                             ("capacity", ["--capacity"], "static_search")):
        out_dir = PLAN_OUT / label.replace(" ", "_")
        shutil.rmtree(out_dir, ignore_errors=True)
        rc = cli.main(["plan", *args, "--tier", "cuda", "--output", str(out_dir)])
        search = out_dir / sub if sub else out_dir
        manifest = json.loads((search / "sweep_manifest.json").read_text())
        events, torn = read_journal(search)
        pruned = [e for e in events if e.get("event") == "plan-pruned"]
        prom = (search / "metrics.prom").read_text()
        n = manifest["searched"]
        line = f'dlbb_plan_search_points_total{{outcome="pruned-{PLAN_FIT_MISSING}"}} {n}'
        if rc != 1 or not n or torn or len(pruned) != n \
                or any(e["reason"] != PLAN_FIT_MISSING for e in pruned) or line not in prom:
            raise AssertionError(f"plan {label} on the cuda tier: exit {rc}, {n} searched, "
                                 f"{len(pruned)} journaled pruned")
        print(f"[plan] (d) plan {label} (tier cuda, {torch.cuda.device_count()} device): "
              f"exit 1, {n} points searched, each journaled {PLAN_FIT_MISSING}, "
              f"metrics.prom pruned-{PLAN_FIT_MISSING} = searched")
    print(f"[plan] (d) {time.perf_counter() - t0:.1f} s; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")


# phase analyze: the port's own files lint clean, and the collective audit
# at world 1 audits nothing (every default target needs 4 or 8 ranks)
ANALYZE_TARGETS = 41


def phase_analyze(gpu_line, results):
    """Phase 20 (module docstring)."""
    import subprocess

    from dlbb_tpu_torch.analysis.hlo_audit import default_targets

    root = Path(__file__).resolve().parent
    names = [t.name for t in default_targets()]
    if len(names) != ANALYZE_TARGETS:
        raise AssertionError(f"{len(names)} default audit targets, not {ANALYZE_TARGETS}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analyze_", dir=root) as tmp:
        reports = {}
        for part, which, want in (("a", ["lint", "--strict-warnings"], 0), ("b", ["hlo"], 1)):
            t0 = time.perf_counter()
            path = Path(tmp) / f"{which[0]}.json"
            run = subprocess.run([sys.executable, "-m", "dlbb_tpu_torch", "analyze", *which,
                                  "--json", str(path)], cwd=root, capture_output=True,
                                 text=True, timeout=300)
            if run.returncode != want or not path.is_file():
                raise AssertionError(f"analyze {' '.join(which)}: exit {run.returncode} (want "
                                     f"{want}); {run.stdout[-2000:]} {run.stderr[-2000:]}")
            reports[which[0]] = json.loads(path.read_text())
            summary = reports[which[0]]["summary"]
            print(f"[analyze] ({part}) python -m dlbb_tpu_torch analyze {' '.join(which)}: "
                  f"exit {run.returncode}, {summary['errors']} error(s), "
                  f"{summary['warnings']} warning(s), {summary['suppressed']} suppressed, "
                  f"{summary['files_linted']} file(s) linted, "
                  f"{len(summary['targets_audited'])} target(s) audited, "
                  f"{len(summary['skipped_targets'])} skipped; "
                  f"{time.perf_counter() - t0:.1f} s")
    lint, hlo = reports["lint"], reports["hlo"]
    if lint["findings"] or lint["summary"]["files_linted"] <= 80:
        raise AssertionError(f"the lint: {lint['findings']}, "
                             f"{lint['summary']['files_linted']} files")
    rules = [f["rule"] for f in hlo["findings"]]
    skipped = [s["target"] for s in hlo["summary"]["skipped_targets"]]
    if rules != ["no-targets-audited"] or skipped != names or hlo["summary"]["targets_audited"]:
        raise AssertionError(f"analyze hlo at world 1: findings {rules}, skipped {skipped}")

    # (c) the audit on the gloo spawn's 8 ranks, CUDA tensors on the card
    (report, metas), = results[0]["ranks"]
    audited = report["summary"]["targets_audited"]
    for name in audited:
        meta = metas[name]
        kinds = sorted({c["kind"] for c in meta["collectives"]})
        print(f"[analyze] (c) {name}: {meta['num_collectives']} collective(s) {kinds}, "
              f"{meta['total_wire_bytes']} wire B/rank"
              + (f", state in place {meta['has_donation']}" if meta["has_donation"] else ""))
    print(f"[analyze] (c) run_hlo_audit on {GLOO_WORLD} gloo ranks on {gpu_line}, CUDA "
          f"tensors: {len(audited)} target(s) audited, {report['summary']['errors']} "
          f"error(s), {report['summary']['warnings']} warning(s); the job "
          f"{results[0]['seconds']:.1f} s of rank 0")
    if report["findings"] or audited != names:
        raise AssertionError(f"the audit on the gloo ranks: {report['findings']}, audited "
                             f"{len(audited)} of {len(names)}")
    _analyze_baselines(report, root, gpu_line)
    _analyze_shadow(root, gpu_line)


def _analyze_baselines(report, root, gpu_line):
    """Phase analyze (e): the same job's schedule, memory and numerics metas
    of the 41 targets on CUDA tensors, priced at ``cpu-sim``, held against
    the committed baselines (``diff_baselines``): no error finding."""
    from dlbb_tpu_torch.analysis import AnalysisReport, fold_gate_keys
    from dlbb_tpu_torch.analysis.schedule_audit import DEFAULT_BASELINE_DIR, diff_baselines

    t0 = time.perf_counter()
    folded = fold_gate_keys(AnalysisReport(schedule=report["schedule"], memory=report["memory"],
                                           numerics=report["numerics"]))
    for name in sorted(folded.schedule):
        s = folded.schedule[name]
        print(f"[analyze] (e) {name}: critical_path_us {s['critical_path_us']}, "
              f"overlap_efficiency {s['overlap_efficiency']}, peak_live_bytes "
              f"{s['peak_live_bytes']}, numerics_max_rel_error_bound "
              f"{s['numerics_max_rel_error_bound']}")
    findings = diff_baselines(folded.schedule, root / DEFAULT_BASELINE_DIR)
    errors = [f.render() for f in findings if f.severity == "error"]
    print(f"[analyze] (e) {len(folded.schedule)} targets' schedule, memory and numerics "
          f"passes on {GLOO_WORLD} gloo ranks on {gpu_line}, CUDA tensors, tier cpu-sim: "
          f"diff against the committed baselines {len(errors)} error(s), "
          f"{len(findings) - len(errors)} warning(s) {[f.rule for f in findings]}; the diff "
          f"{time.perf_counter() - t0:.1f} s (the passes ran in (c)'s job)")
    if len(folded.schedule) != ANALYZE_TARGETS or errors:
        raise AssertionError(f"the passes against the committed baselines: {errors}")


def _analyze_shadow(root, gpu_line):
    """Phase analyze (g): the fp64 shadow on the card: 4 confirmed, 0
    refuted, each case's measured error the committed CPU report's."""
    import subprocess

    from dlbb_tpu_torch.analysis.numerics_shadow import DEFAULT_SHADOW_DIR, SHADOW_REPORT_NAME

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shadow_", dir=root) as tmp:
        run = subprocess.run([sys.executable, "-m", "dlbb_tpu_torch.analysis.numerics_shadow",
                              "--device", "cuda", "--output", tmp], cwd=root,
                             capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise AssertionError(f"numerics_shadow on the card: exit {run.returncode}; "
                                 f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
        got = json.loads((Path(tmp) / SHADOW_REPORT_NAME).read_text())
    cpu = json.loads((root / DEFAULT_SHADOW_DIR / SHADOW_REPORT_NAME).read_text())
    for g, c in zip(got["cases"], cpu["cases"], strict=True):
        print(f"[analyze] (g) {g['case']}: confirmed {g['confirmed']}, measured_rel_error "
              f"{g['measured_rel_error']!r} on the card vs {c['measured_rel_error']!r} on the "
              f"CPU, bound {g['gating_bound']!r}")
        if g["measured_rel_error"] != c["measured_rel_error"] or g["confirmed"] != c["confirmed"]:
            raise AssertionError(f"the shadow's {g['case']} on the card differs from the CPU's")
    print(f"[analyze] (g) python -m dlbb_tpu_torch.analysis.numerics_shadow --device cuda on "
          f"{gpu_line}: {got['confirmed']} confirmed, {got['refuted']} refuted; "
          f"{time.perf_counter() - t0:.1f} s")
    if (got["confirmed"], got["refuted"]) != (4, 0):
        raise AssertionError(f"the shadow on the card: {got['confirmed']} confirmed, "
                             f"{got['refuted']} refuted")


def _same_planes(torch, got, host):
    """A card tensor equal to a host tensor bit for bit, compared one slice
    of the leading dim at a time."""
    if got.shape != host.shape or got.dtype != host.dtype:
        return False
    if got.dim() < 2:
        return bool(torch.equal(got.cpu(), host))
    return all(bool(torch.equal(got[i].cpu(), host[i])) for i in range(got.shape[0]))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _seq_launches(seq, name):
    """A kernel's launches per rank on each path of phase seq (b): the
    forward and the step's gradients of each run."""
    return {f"{run}_{part}": r[f"{part}_launches"][name] for run, r in seq["gloo"].items()
            for part in ("fwd", "step")}


def _dtrain_launches(dtrain, name):
    """A kernel's launches per optimizer step on each path of phase dtrain:
    the four ZeRO stages' steps, the two ``run_train`` runs, each rank of
    (b)'s resharded micro-batches, and a rank of (b)'s uneven heads (its
    forward and its step)."""
    out = {f"zero{stage}": r["launches"][name] for stage, r in dtrain["stages"].items()}
    for (stage, accum), run in dtrain["runs"].items():
        out[f"run_train_zero{stage}_ga{accum}"] = run["result"]["kernel_launches_per_step"][name]
    for rank, n in dtrain["gloo"]["resharded"]["launches"].items():
        out[f"resharded_rank{rank}"] = n[name] / DTRAIN_RESHARD["steps"]
    uneven = dtrain["gloo"]["uneven_heads"]
    out["uneven_heads_tp4_forward_per_rank"] = uneven["fwd_launches"][name]
    out["uneven_heads_tp4_step_per_rank"] = uneven["step_launches"][name]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    phases = set(parser.parse_args().phases.split(","))
    if not phases <= set(PHASES):
        parser.error(f"unknown phase(s) {sorted(phases - set(PHASES))}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from dlbb_tpu_torch.ops import _build
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu_line = gpu_name_and_power_limit() or "nvidia-smi unavailable"
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    walls = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        walls[name] = time.perf_counter() - t0
        print(f"[time] phase {name}: {walls[name]:.1f} s wall")
        return out

    fwd_design, bwd_design = timed("build", phase_build, _build)
    # every phase's multi-rank runs in one gloo spawn, before the phases
    # that check them (the kernels are built)
    job_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_jobs_")
    makers = {"tp": lambda: [("tp", TP_GLOO_CONFIG)],
              "dtrain": lambda: _dtrain_gloo_jobs(job_dir.name), "seq": _seq_gloo_jobs,
              "moe": lambda: [("moe",)], "pipe": lambda: [("pipe",)],
              "compress": _compress_gloo_jobs, "analyze": lambda: [("analyze",)]}
    jobs = {phase: make() for phase, make in makers.items() if phase in phases}
    gloo = timed("gloo", _run_gloo_jobs, torch, jobs) if jobs else {}
    if "fwd" in phases:
        err_o, err_lse = timed("fwd", phase_kernel_vs_plain, torch, fa)
    if "bwd" in phases:
        err_bwd = timed("bwd", phase_bwd_vs_plain, torch, fa)
    if "e2e" in phases:
        launches, _ = timed("e2e", phase_main_path, torch, fa, gpu_line)
    if "train" in phases:
        train_launches, _ = timed("train", phase_train, torch, fa, gpu_line)
    if "time" in phases:
        t0 = time.perf_counter()
        main_t = phase_timing(torch, fa, MAIN_SHAPE, reps=50, before_ms=FWD_BEFORE_MS["main"])
        long_t = phase_timing(torch, fa, LONG_SHAPE, reps=10, before_ms=FWD_BEFORE_MS["long"])
        main_b = _time_bwd(torch, fa, MAIN_SHAPE, reps=50, plain_reps=10)
        long_b = _time_bwd(torch, fa, LONG_SHAPE, reps=10, plain_reps=2)
        walls["time"] = time.perf_counter() - t0
        print(f"[time] phase time: {walls['time']:.1f} s wall")
    if "comm" in phases:
        timed("comm", phase_comm, torch, gpu_line)
    if "tp" in phases:
        tp = timed("tp", phase_tp, torch, gpu_line, gloo["tp"])
    if "dtrain" in phases:
        dtrain = timed("dtrain", phase_dtrain, torch, gpu_line, jobs["dtrain"], gloo["dtrain"])
    if "seq" in phases:
        seq = timed("seq", phase_seq, torch, gpu_line, jobs["seq"], gloo["seq"])
    if "moe" in phases:
        moe = timed("moe", phase_moe, torch, fa, gpu_line, gloo["moe"])
    if "pipe" in phases:
        pipe = timed("pipe", phase_pipe, torch, gpu_line, gloo["pipe"])
    if "compress" in phases:
        compress = timed("compress", phase_compress, torch, gpu_line, gloo["compress"])
    if "bench" in phases:
        bench_launches = timed("bench", phase_bench, torch, fa, gpu_line)
    if "kv" in phases:
        timed("kv", phase_kv, torch, gpu_line)
    if "serve" in phases:
        serve = timed("serve", phase_serve, torch, fa, gpu_line)
    if "fleet" in phases:
        fleet = timed("fleet", phase_fleet, torch, gpu_line)
    if "chaos" in phases:
        chaos = timed("chaos", phase_chaos, torch, fa, gpu_line)
    if "plan" in phases:
        timed("plan", phase_plan, torch, gpu_line)
    if "analyze" in phases:
        timed("analyze", phase_analyze, gpu_line, gloo["analyze"])
    job_dir.cleanup()
    print(f"[time] phases {', '.join(f'{k} {v:.1f}' for k, v in walls.items())} s; "
          f"{sum(walls.values()):.1f} s in all")
    if phases != set(PHASES):
        print(f"chip_smoke: phases {sorted(phases)} passed; no result printed for a subset")
        return 0

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "dlbb_tpu_torch/ops/csrc/flash_fwd.cu",
        "design": fwd_design,
        "replaces": "dlbb_tpu/ops/flash_attention.py:99",
        "launches": launches,
        "train_launches": train_launches["flash_fwd"],
        "tp_launches": tp["full"]["launches"],
        "dtrain_launches_per_step": _dtrain_launches(dtrain, "flash_fwd"),
        "seq_launches_per_rank": _seq_launches(seq, "flash_fwd"),
        "moe_launches": {d: r["launches"] for d, r in moe["e2e"].items()},
        "moe_train_launches": moe["train"]["launches"]["flash_fwd"],
        "pipe_launches": {part: n["flash_fwd"] for part, n in pipe["launches"].items()},
        "compress_launches_per_step": compress["train"]["launches"]["flash_fwd"],
        "bench_launches_per_forward": bench_launches,
        "serve_launches": serve,
        "fleet_launches": fleet["flash_fwd"],
        "chaos_launches": chaos["flash_fwd"],
        "max_abs_err": err_o,
        "lse_max_abs_err": err_lse,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "tflops": main_t["tflops"],
        "shape": main_t["shape"],
        "long": long_t,
    }]
    for kernel, line, errs in (("dq", 212, ("dq",)), ("dkv", 247, ("dk", "dv"))):
        t = main_b[kernel]
        kernels.append({
            "name": f"flash_bwd_{kernel}",
            "route": "cuda",
            "source": "dlbb_tpu_torch/ops/csrc/flash_bwd.cu",
            "design": bwd_design,
            "replaces": f"dlbb_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[f"flash_bwd_{kernel}"],
            "dtrain_launches_per_step": _dtrain_launches(dtrain, f"flash_bwd_{kernel}"),
            "seq_launches_per_rank": _seq_launches(seq, f"flash_bwd_{kernel}"),
            "moe_train_launches": moe["train"]["launches"][f"flash_bwd_{kernel}"],
            "pipe_launches": {part: n[f"flash_bwd_{kernel}"]
                              for part, n in pipe["launches"].items()},
            "compress_launches_per_step": compress["train"]["launches"][f"flash_bwd_{kernel}"],
            "chaos_launches": chaos[f"flash_bwd_{kernel}"],
            "max_abs_err": max(err_bwd[e] for e in errs),
            "ms": t["ms"],
            "event_ms": t["event_ms"],
            "plain_ms": t["plain_ms"],
            "plain_note": "the whole plain backward (dq, dk, dv in one pass)",
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_note": "SDPA backward (the aten flash backward op alone, graph "
                            "replay), dq, dk and dv together",
            "sdpa_default_ms": t["sdpa_default_ms"],
            "sdpa_default_note": f"F.scaled_dot_product_attention's backward with its "
                                 f"default backend ({t['sdpa_default_backend']}), forward + "
                                 "backward less forward, graph replay",
            "tflops": t["tflops"],
            "bound_share": t["bound_share"],
            "shape": t["shape"],
            "long": long_b[kernel],
        })
    print(gpu_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
