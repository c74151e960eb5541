#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dlbb_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,fwd,bwd,e2e,train,time,comm,tp,dtrain]

Phases (each raises on failure, and the script then exits non-zero):

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
   the same forward through ``dense_attention``;
4. drive the train path through its entry point: ``run_train`` on
   ``dlbb_tpu_torch/configs/train_1b_adam_bf16m.yaml`` (the same 1B decoder,
   remat "dots", Adam with bf16 moments, B=8, S=512); check the flash
   kernels' launches per step (48 forward: 24 in the forward and 24 in the
   remat recompute; 24 dq and 24 dk/dv) and finite losses; then one step's
   loss and gradients on the same weights and batch through the kernel path
   and through the dense path, which must agree;
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
   print the median time per op at 16MB and at (8, 4096, 4096);
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
   step at tp=2, stage 1, and at dp=2, stage 3, their loss and gradients
   (reassembled over the shards) against the world-1 step's within the
   bounds argued at ``DTRAIN_*``; errors and wall time printed, not timed
   as a benchmark.

It then prints the card's name and power limit, one JSON line
``{"kernels": [...]}``, and as its last line
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset for a short
check (phase 1 always runs) and then prints no result lines.  Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
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
# and 24 residual layers carry those differences to the output
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
PHASES = ("build", "fwd", "bwd", "e2e", "train", "time", "comm", "tp", "dtrain")
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


def _fwd_flops(shape):
    """The QK^T and PV flops of the visible (row, key) pairs."""
    return 4 * shape["d"] * _visible_pairs(shape) * shape["b"] * shape["n"]


def _bound(shape):
    """Least time for the flash forward at ``shape``: each of q, k, v read
    once, o and lse written once, over the memory rate; the QK^T and PV
    flops of the visible (row, key) pairs over the bf16 tensor rate."""
    b, n, kvh, s, sk, d = (shape[x] for x in ("b", "n", "kvh", "s", "sk", "d"))
    nbytes = 2 * (2 * b * n * s * d + 2 * b * kvh * sk * d) + 4 * b * n * s
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, _fwd_flops(shape) / PEAK_BF16_FLOPS
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


def _visible_pairs(shape):
    s, sk = shape["s"], shape["sk"]
    if shape["causal"]:
        return sum(min(sk, max(0, r + sk - s + 1)) for r in range(s))
    return s * sk


def _bwd_flops(shape, kernel):
    """6 D (dq: QK^T, dO V^T, dS K) or 8 D (dk/dv: QK^T again, dO V^T,
    P^T dO, dS^T Q) flops per visible (row, key) pair."""
    return ((6 if kernel == "dq" else 8) * shape["d"] * _visible_pairs(shape)
            * shape["b"] * shape["n"])


def _bwd_bound(shape, kernel):
    """Least time for one backward kernel at ``shape``: q, k, v, dO, lse and
    delta read once and its outputs written once, over the memory rate; its
    flops (``_bwd_flops``) over the bf16 tensor rate."""
    b, n, kvh, s, sk, d = (shape[x] for x in ("b", "n", "kvh", "s", "sk", "d"))
    q_bytes, kv_bytes = 2 * b * n * s * d, 2 * b * kvh * sk * d
    nbytes = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * b * n * s
    nbytes += q_bytes if kernel == "dq" else 2 * kv_bytes
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, _bwd_flops(shape, kernel) / PEAK_BF16_FLOPS
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
    return worst


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
    return launches, result


def phase_train(torch, fa, gpu_line):
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
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = fa.flash_bwd_dkv_launches = 0
    result = run_train(config, device="cuda", verbose=True)
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
    return launches, result


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
        tflops = _bwd_flops(shape, kernel) / (ms * 1e-3) / 1e12
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
    tflops = _fwd_flops(shape) / (ms * 1e-3) / 1e12
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


def _tp_output(config):
    """The TP forward's output on this rank, on the host."""
    import torch

    from dlbb_tpu_torch.data import create_dataset_from_config
    from dlbb_tpu_torch.models import ModelConfig, forward, init_params
    from dlbb_tpu_torch.parallel import ParallelismPlan

    model_cfg = ModelConfig.from_dict(config["model"])
    plan = ParallelismPlan.from_config(config, model_cfg)
    coords = plan.mesh.coords
    params = init_params(model_cfg, config["input"]["seed"], "cuda",
                         tp_rank=coords["tp"], tp=plan.tp)
    batch = create_dataset_from_config(
        config, dtype=torch.bfloat16, device="cuda", hidden_size=model_cfg.hidden_size,
        dp_rank=coords["dp"], dp=plan.dp).get_batch()
    with torch.inference_mode():
        y = forward(params, batch, model_cfg, mesh=plan.mesh)
    return y.cpu()


def _gloo_tp_rank(rank, world, init_file, config, out_dir):
    """One rank of the gloo tp run on the one card (spawned by
    ``_gloo_tp``): its output goes to ``out_dir/y_<rank>.pt``."""
    import torch

    from dlbb_tpu_torch.comm import destroy_distributed, initialize_distributed

    torch.cuda.set_device(0)
    initialize_distributed("gloo", rank, world, init_file, timeout=600)
    try:
        torch.save(_tp_output(config), f"{out_dir}/y_{rank}.pt")
    finally:
        destroy_distributed()


def _gloo_tp(torch, config, world):
    """Run the TP forward of ``config`` as ``world`` processes on cuda:0 over
    gloo; returns each rank's output."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        mp.start_processes(_gloo_tp_rank, args=(world, os.path.join(tmp, "store"),
                                                config, tmp),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"y_{r}.pt")) for r in range(world)]


def phase_tp(torch, gpu_line):
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
    config = {"experiment": {"name": "chip_smoke_1b_tp2_gloo"},
              "model": {"size": "1B", "attention": "full", "dtype": "bfloat16"},
              "parallelism": {"world_size": 2, "data_parallel": 1},
              "input": {"batch_size": 8, "sequence_length": 512, "seed": 42}}
    model_cfg = ModelConfig.from_dict(config["model"])
    t0 = time.perf_counter()
    ys = _gloo_tp(torch, config, 2)
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
          f"{time.perf_counter() - t0:.1f} s, not timed")
    if not bool(torch.isfinite(y).all()) or not rel <= bound:
        raise AssertionError("the 1B tp=2 forward disagrees with the world-1 forward")
    del params, ref, y, ys
    torch.cuda.empty_cache()
    out["gloo_tp2_rel_l2"] = rel
    return out


# phase dtrain (b): the 1B train step sharded over two processes against the
# world-1 step on the same weights and global batch, both bf16 on the card.
# - dp=2, stage 3: the same kernels on half the rows each, the gradients
#   summed by a bf16 reduce-scatter (one more rounding, 2**-8) and GEMMs that
#   may sum in another order at the other row count.  The kernel-vs-dense
#   bounds of phase 4 (TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2) hold two paths
#   that differ by far more (another attention arithmetic in all 24 layers),
#   so they bound this one.
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


def _dtrain_batch(config, model_cfg, device, coords=None, dp=1):
    import torch

    from dlbb_tpu_torch.data import create_dataset_from_config

    coords = coords or {"dp": 0}
    return tuple(create_dataset_from_config(
        config, dtype=torch.bfloat16, device=device, hidden_size=model_cfg.hidden_size,
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
                                      zero_stage=stage)
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


def _dtrain_gloo_rank(rank, world, init_file, config, stage, out_dir, device="cuda"):
    """One rank of phase dtrain (b), spawned by ``_dtrain_gloo``: the loss
    and reduced gradients of one step, then the step; written to
    ``out_dir/r<rank>.pt``."""
    import torch

    from dlbb_tpu_torch.comm import destroy_distributed, initialize_distributed
    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.parallel import ParallelismPlan
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import build_optimizer, tree_map

    if device == "cuda":
        torch.cuda.set_device(0)
    initialize_distributed("gloo", rank, world, init_file, timeout=900)
    try:
        model_cfg = ModelConfig.from_dict(config["model"])
        plan = ParallelismPlan.from_config(config, model_cfg)
        c = plan.mesh.coords
        batch, targets = _dtrain_batch(config, model_cfg, device, c, plan.dp)
        step, state = make_train_step(
            model_cfg, build_optimizer(config["training"]),
            init_params(model_cfg, config["input"]["seed"], device, tp_rank=c["tp"],
                        tp=plan.tp), mesh=plan.mesh, zero_stage=stage)
        t0 = time.perf_counter()
        loss, grads = step.grads(state, batch, targets)
        grads = tree_map(lambda g: g.cpu(), grads)
        state, step_loss = step(state, batch, targets)
        step_loss = float(step_loss)
        torch.save({"coords": c, "loss": float(loss), "step_loss": step_loss,
                    "grads": grads, "axes": step.zero.opt_axes,
                    "seconds": time.perf_counter() - t0}, f"{out_dir}/r{rank}.pt")
    finally:
        destroy_distributed()


def _dtrain_gloo(torch, config, stage, device="cuda"):
    """The train step of ``config`` as two processes on one device over
    gloo; returns each rank's record."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dtrain_") as tmp:
        mp.start_processes(_dtrain_gloo_rank,
                           args=(2, os.path.join(tmp, "store"), config, stage, tmp, device),
                           nprocs=2, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"r{r}.pt"), weights_only=False)
                for r in range(2)]


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def phase_dtrain(torch, gpu_line, config=None, device="cuda"):
    """Phase 8 (module docstring).  ``config`` and ``device`` default to
    the 1B train config on the card; a smaller config on the CPU rehearses
    the phase's control flow."""
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

    # (b) two processes on the one device over gloo, against the world-1 step
    opt = build_optimizer(config["training"])
    step, state = make_train_step(model_cfg, opt, init_params(
        model_cfg, config["input"]["seed"], device))
    batch, targets = _dtrain_batch(config, model_cfg, device)
    ref_loss, ref = step.grads(state, batch, targets)
    ref_loss = float(ref_loss)
    del state, step
    errors = {}
    for tp, dp, stage in DTRAIN_GLOO_RUNS:
        cfg = copy.deepcopy(config)
        cfg["parallelism"] = {"world_size": tp, "data_parallel": dp}
        t0 = time.perf_counter()
        ranks = _dtrain_gloo(torch, cfg, stage, device)
        wall = time.perf_counter() - t0
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
        loss_bound, grad_bound = dtrain_bounds(layers, tp)
        worst = max(rels, key=rels.get)
        label = f"tp={tp}, ZeRO-{stage}" if tp > 1 else f"dp={dp}, ZeRO-{stage}"
        print(f"[dtrain] 1B step at {label}, two processes on one card over gloo (CUDA "
              f"tensors): loss {loss:.6f} vs world 1 {ref_loss:.6f} (relative "
              f"{loss_rel:.3e}, bound {loss_bound:.3e}); gradient relative L2 per leaf: "
              + ", ".join(f"{n} {v:.3e}" for n, v in rels.items())
              + f" (worst {worst}, bound {grad_bound:.3e}); step loss "
              f"{ranks[0]['step_loss']:.6f}; {wall:.1f} s wall, "
              f"{max(r['seconds'] for r in ranks):.1f} s in the ranks, not timed")
        if len(losses) != 1:
            raise AssertionError(f"{label}: the ranks' losses differ: {losses}")
        if not (loss_rel <= loss_bound and rels[worst] <= grad_bound
                and all(math.isfinite(r["step_loss"]) for r in ranks)):
            raise AssertionError(f"the 1B step at {label} disagrees with the world-1 step")
        errors[label] = {"loss_rel": loss_rel, "worst_grad_rel_l2": rels[worst],
                         "worst_leaf": worst, "wall_s": wall}
    del ref, got
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


def _dtrain_launches(dtrain, name):
    """A kernel's launches per optimizer step on each path of phase dtrain:
    the four ZeRO stages' steps and the two ``run_train`` runs."""
    out = {f"zero{stage}": r["launches"][name] for stage, r in dtrain["stages"].items()}
    for (stage, accum), run in dtrain["runs"].items():
        out[f"run_train_zero{stage}_ga{accum}"] = run["result"]["kernel_launches_per_step"][name]
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

    fwd_design, bwd_design = phase_build(_build)
    if "fwd" in phases:
        err_o, err_lse = phase_kernel_vs_plain(torch, fa)
    if "bwd" in phases:
        err_bwd = phase_bwd_vs_plain(torch, fa)
    if "e2e" in phases:
        launches, _ = phase_main_path(torch, fa, gpu_line)
    if "train" in phases:
        train_launches, _ = phase_train(torch, fa, gpu_line)
    if "time" in phases:
        main_t = phase_timing(torch, fa, MAIN_SHAPE, reps=50, before_ms=FWD_BEFORE_MS["main"])
        long_t = phase_timing(torch, fa, LONG_SHAPE, reps=10, before_ms=FWD_BEFORE_MS["long"])
        main_b = _time_bwd(torch, fa, MAIN_SHAPE, reps=50, plain_reps=10)
        long_b = _time_bwd(torch, fa, LONG_SHAPE, reps=10, plain_reps=2)
    if "comm" in phases:
        phase_comm(torch, gpu_line)
    if "tp" in phases:
        tp = phase_tp(torch, gpu_line)
    if "dtrain" in phases:
        dtrain = phase_dtrain(torch, gpu_line)
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
