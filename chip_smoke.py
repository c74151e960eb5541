#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dlbb_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,fwd,bwd,e2e,train,time]

Phases (each raises on failure, and the script then exits non-zero):

1. build every CUDA kernel of the port from ``dlbb_tpu_torch/ops/csrc``,
   print each kernel's ``ptxas`` registers and the forward's warp roles
   (``setmaxnreg``), and fail on any spill;
2. hold each kernel against its plain PyTorch version on the card, on the
   main path's shape and on the edge cases (GQA, non-causal, ragged S,
   KV-cache decode, fully masked rows): the flash forward's ``(o, lse)``,
   also at the edges of its 128 x 128 tiles (a partial Q tile, S = Sk = 130,
   GQA g = 8, S < Sk non-causal, B*N above 65535), then the flash
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
   and the least time the card could take; for the forward also its
   TFLOP/s, its share of the bound and the time of the kernel it replaced.
   The forward and SDPA are timed by CUDA-graph replay, since the
   forward's host enqueue is about as long as its kernel at the main shape.

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
# the forward alone, at the edges of its 128-row Q and 128-key K/V tiles
FWD_EDGE_CASES = {
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
PHASES = ("build", "fwd", "bwd", "e2e", "train", "time")


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
    design = _fwd_design(build)
    print(f"[build] flash_fwd: {design['block_m']} query rows x {design['block_n']}-key "
          f"tiles, {design['stages']}-stage K and V rings, 1 producer warpgroup at "
          f"{design['producer_regs']} registers + 2 consumer warpgroups at "
          f"{design['consumer_regs']} (setmaxnreg); ptxas {design['ptxas_registers']} "
          f"registers at entry (D = 64, 128); no spills")
    return design


def _fwd_design(build):
    """The forward kernel's design: its tile and warp-role constants as
    ``csrc/flash_fwd.cu`` declares them, and the registers ``ptxas`` gave
    each build of it in this run."""
    src = (build.CSRC / "flash_fwd.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", build.ptxas_report("flash_fwd"))]
    return {"kind": "wgmma + TMA 3-D maps, 1 producer and 2 consumer warpgroups, "
                    "mbarrier K and V rings (csrc/hopper.cuh)",
            "block_m": const["kBlockM"], "block_n": const["kBlockN"],
            "stages": const["kStages"], "producer_regs": const["kProducerRegs"],
            "consumer_regs": const["kConsumerRegs"], "ptxas_registers": regs}


def phase_kernel_vs_plain(torch, fa):
    worst_o = worst_lse = 0.0
    for i, (name, shape) in enumerate({**CASES, **FWD_EDGE_CASES}.items()):
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


def _bwd_bound(shape, kernel):
    """Least time for one backward kernel at ``shape``: q, k, v, dO, lse and
    delta read once and its outputs written once, over the memory rate; 6 D
    (dq: QK^T, dO V^T, dS K) or 8 D (dk/dv: QK^T again, dO V^T, P^T dO,
    dS^T Q) flops per visible (row, key) pair over the bf16 tensor rate."""
    b, n, kvh, s, sk, d = (shape[x] for x in ("b", "n", "kvh", "s", "sk", "d"))
    q_bytes, kv_bytes = 2 * b * n * s * d, 2 * b * kvh * sk * d
    nbytes = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * b * n * s
    nbytes += q_bytes if kernel == "dq" else 2 * kv_bytes
    flops = (6 if kernel == "dq" else 8) * d * _visible_pairs(shape) * b * n
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_bwd_vs_plain(torch, fa):
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for i, (name, shape) in enumerate(CASES.items()):
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


def _time_bwd(torch, fa, shape, reps, plain_reps):
    import torch.nn.functional as F

    q, k, v = _inputs(torch, shape, seed=11)
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    do = torch.randn(q.shape, generator=g, device="cuda", dtype=torch.bfloat16)
    causal = shape["causal"]
    scale = 1.0 / math.sqrt(shape["d"])
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = fa.flash_bwd_delta(o, do)
    dq_ms = _time_ms(torch, lambda: fa._flash_bwd_dq_cuda(
        q, k, v, lse, do, delta, causal=causal, sm_scale=scale), reps)
    dkv_ms = _time_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
        q, k, v, lse, do, delta, causal=causal, sm_scale=scale), reps)
    plain_ms = _time_ms(torch, lambda: fa.flash_bwd_reference(
        q, k, v, o, lse, do, causal=causal), plain_reps, warmup=1)
    # the library yardstick for the pair: SDPA's backward, as its forward
    # plus backward less its forward
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        torch.autograd.grad(out, (qg, kg, vg), do)

    sdpa_bwd_ms = _time_ms(torch, sdpa_fwd_bwd, reps) - _time_ms(torch, sdpa_fwd, reps)
    label = "B={b} N={n} S={s} D={d}".format(**shape)
    out = {}
    for kernel, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
        bound_ms, bound_by = _bwd_bound(shape, kernel)
        out[kernel] = {"shape": label, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": sdpa_bwd_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}
        print(f"[time] flash_bwd_{kernel} {label}: kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); plain backward (dq, dk, dv) "
              f"{plain_ms:.4f} ms; SDPA backward (the pair) {sdpa_bwd_ms:.4f} ms")
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

    design = phase_build(_build)
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
    if phases != set(PHASES):
        print(f"chip_smoke: phases {sorted(phases)} passed; no result printed for a subset")
        return 0

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "dlbb_tpu_torch/ops/csrc/flash_fwd.cu",
        "design": design,
        "replaces": "dlbb_tpu/ops/flash_attention.py:99",
        "launches": launches,
        "train_launches": train_launches["flash_fwd"],
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
            "replaces": f"dlbb_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[f"flash_bwd_{kernel}"],
            "max_abs_err": max(err_bwd[e] for e in errs),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "plain_note": "the whole plain backward (dq, dk, dv in one pass)",
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_note": "SDPA backward (forward + backward less forward), "
                            "dq, dk and dv together",
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
