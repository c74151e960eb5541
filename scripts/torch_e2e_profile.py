#!/usr/bin/env python3
"""Where the time of the port's 1B forward, of its 1B train step, or of its
1B serving decode step or verify unit goes on one NVIDIA GPU.

    python3 scripts/torch_e2e_profile.py --out DIR [--batch 8] [--seq 512]
                                         [--reps 3] [--train | --decode [--int8]
                                                     | --verify [--gamma G]
                                                     | --verify-vs-step [--gamma G]]

Builds the 1B decoder of ``dlbb_tpu_torch`` at full width (bf16,
``attention="full"``, random weights from seed 42), runs a few warm
forwards, then traces ``--reps`` forwards with ``torch.profiler`` and reads
the Chrome trace it exports: device time by kernel class (the flash kernels,
matrix products, copies, other elementwise and reductions), the top kernels
by name, and the device's idle share over the traced window (1 - the union
of kernel intervals / the window from the first forward's start to the last
kernel's end).  Also times the same forwards with CUDA events and no
profiler.  Prints one JSON line as its last line and writes the trace and
that JSON under ``--out``.

With ``--train`` it does the same for the train step of
``dlbb_tpu_torch/configs/train_1b_adam_bf16m.yaml`` (remat "dots", Adam with
bf16 moments) through ``make_train_step``, and also splits the device time
by phase: the forward, the backward (kernels launched by the autograd
engine's thread, the remat recompute included) and the optimizer update.

With ``--decode`` it does the same for one decode step of the serving
engine (``serve/engine.py::build_decode_step``, the "off" mode) on the
cache of ``chip_smoke.py`` phase serve: 32 slots of 2048 tokens in 16-token
blocks (12 GiB of bf16), every slot active at length 1024 (the step reads
the whole cache whatever the lengths); ``--batch`` and ``--seq`` are not
used.  ``--int8`` puts that cache in the int8 layout
(``kv_quantization="int8"``: 6 GiB of codes and their scales), whose step
dequantises each layer, appends, and requantises the touched blocks.

With ``--verify`` it does the same for one greedy draft-and-verify unit
(``serve/engine.py::build_verify_step``) on that cache: every slot's
pending token and ``--gamma`` drafts (default 4) as one ``[32, γ+1, H]``
pass, every slot active from length 1024 and advancing by its commits.

With ``--verify-vs-step`` it profiles nothing: it asks whether one verify
unit computes the per-step decode's bits.  From one carry (the 1B over that
cache geometry, K/V rows drawn from seed 0 below lengths spread over
128..1151, every slot's pending input a token's embedding), it runs γ+1
per-step greedy token steps, then one verify over the same carry with the
steps' own tokens as drafts, recording every layer norm and matrix product
of both.  It prints, for position 0, the first layer and sub-op (ln1, the
qkv product, the attention's logits and PV products, the out product, ln2,
the two ffn products) whose output is not bit-equal to the step's, each
sub-op's verdict on the first layers, and for every position i whether the
verify's output row i is bit-equal to step i's output and gives its token.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLASSES = (
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("flash_fwd", ("flash_fwd",)),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_")),
    ("copy", ("copy",)),
    ("reduce", ("reduce",)),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise_other"


def union_length(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def by_phase(events, kernels) -> dict[str, dict[str, float]]:
    """Kernel microseconds by the phase that launched them and by class.
    The phases: "optimizer" (launched inside the ``optimizer`` range),
    "backward" (launched from another thread than that range's: the
    autograd engine's, remat recompute included), "forward" (the rest)."""
    # the host-side ranges (the profiler also draws each range on the
    # device's timeline, as a "gpu_user_annotation")
    opt = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
           if e.get("ph") == "X" and e.get("name") == "optimizer"
           and e.get("cat") == "user_annotation"]
    if not opt:
        raise RuntimeError("the trace holds no optimizer range")
    main_tid = opt[0][2]
    launch = {e["args"]["correlation"]: (e["ts"], e["tid"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out: dict[str, dict[str, float]] = {}
    for e in kernels:
        ts_tid = launch.get(e.get("args", {}).get("correlation"))
        if ts_tid is None:
            phase = "unattributed"
        elif ts_tid[1] != main_tid:
            phase = "backward"
        elif any(a <= ts_tid[0] <= b for a, b, _ in opt):
            phase = "optimizer"
        else:
            phase = "forward"
        row = out.setdefault(phase, {})
        cls = classify(e["name"])
        row[cls] = row.get(cls, 0.0) + e["dur"]
    return out


def _train_step(torch, record_function, x, args):
    """The 1B train step of the shipped config through ``make_train_step``,
    its optimizer update inside a profiler range named ``optimizer``."""
    from dlbb_tpu_torch.data import SyntheticEmbeddingDataset
    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.train.loop import make_train_step
    from dlbb_tpu_torch.train.optim import GradientTransformation, build_optimizer
    from dlbb_tpu_torch.utils.config import load_config

    config = load_config(Path(__file__).resolve().parents[1] / "dlbb_tpu_torch"
                         / "configs" / "train_1b_adam_bf16m.yaml")
    cfg = ModelConfig.from_dict(config["model"])
    inner = build_optimizer(config["training"])

    def update(grads, state, params=None):
        with record_function("optimizer"):
            return inner.update(grads, state, params)

    step_fn, state = make_train_step(cfg, GradientTransformation(inner.init, update),
                                     init_params(cfg, 42, "cuda"), batch_size=args.batch)
    targets = SyntheticEmbeddingDataset(args.batch, args.seq, cfg.hidden_size,
                                        seed=43, device="cuda").get_batch()
    holder = [state]

    def step():
        holder[0], loss = step_fn(holder[0], x, targets)
        return loss

    return step, cfg


def _decode_step(torch, cfg, int8=False):
    """One serving decode step of the 1B over phase serve's cache (in the
    int8 layout with ``int8``), every slot active: ``step()`` runs it and
    feeds its output back, as the engine does."""
    from dlbb_tpu_torch.models import init_params
    from dlbb_tpu_torch.serve.engine import build_decode_step
    from dlbb_tpu_torch.serve.kvcache import create_kv_cache, create_quant_kv_cache

    slots, max_seq, block = 32, 2048, 16
    params = init_params(cfg, 42, "cuda")
    create = create_quant_kv_cache if int8 else create_kv_cache
    cache = create(cfg, slots, max_seq // block, block, device="cuda")
    cache.lengths.fill_(max_seq // 2)
    x = torch.randn((slots, 1, cfg.hidden_size), device="cuda", dtype=torch.bfloat16)
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    decode = build_decode_step(cfg)
    carry = [(cache, x)]

    def step():
        carry[0], y = decode(carry[0], params, active)
        return y

    return step


def _verify_unit(torch, cfg, gamma):
    """One greedy verify unit of the 1B at ``gamma`` over phase serve's
    cache, every slot active: ``step()`` runs it on the carry it returned
    last, as the engine does (drafts of token 0, so most commit one or two
    tokens per unit)."""
    from dlbb_tpu_torch.data.synthetic import token_embedding_table
    from dlbb_tpu_torch.models import init_params
    from dlbb_tpu_torch.serve.engine import build_verify_step
    from dlbb_tpu_torch.serve.kvcache import create_kv_cache

    slots, max_seq, block = 32, 2048, 16
    params = init_params(cfg, 42, "cuda")
    cache = create_kv_cache(cfg, slots, max_seq // block, block, device="cuda")
    cache.lengths.fill_(max_seq // 2)
    x = torch.randn((slots, 1, cfg.hidden_size), device="cuda", dtype=torch.bfloat16)
    table = token_embedding_table(cfg.hidden_size, torch.bfloat16, device="cuda")
    drafts = torch.zeros((slots, gamma), dtype=torch.int32, device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    remaining = torch.full((slots,), max_seq, dtype=torch.int32, device="cuda")
    verify = build_verify_step(cfg, gamma=gamma)
    carry = [(cache, x)]

    def step():
        carry[0], tok, _commits = verify(carry[0], params, table, drafts, active, remaining)
        return tok

    return step


SUBOPS = ("ln1", "qkv", "logits", "pv", "out", "ln2", "ffn_up", "ffn_down")


def _recorder(torch, eng, params):
    """A context that records, in call order, every layer norm and matrix
    product the serving programs run: ``(layer, sub-op) -> [outputs]``.
    Projections are named by their weight, layer norms by their scale, and
    the attention's two products by the shape of their second operand
    (``[..., d, S]`` the logits, ``[..., S, d]`` PV), in the layer of the
    qkv product before them.  A weight is known by its storage address
    (the programs unbind the stacked leaves anew on every call)."""
    from contextlib import contextmanager

    from torch.overrides import TorchFunctionMode

    from dlbb_tpu_torch.models.transformer import layer_list

    names = {}
    for i, layer in enumerate(layer_list(params["layers"])[0]):
        for name in ("qkv", "out", "ffn_up", "ffn_down"):
            names[layer[name]["kernel"].data_ptr()] = (i, name)
        for name in ("ln1", "ln2"):
            names[layer[name]["scale"].data_ptr()] = (i, name)
    names[params["ln_f"]["scale"].data_ptr()] = (-1, "ln_f")
    rec: dict = {}
    current = [0]

    def put(key, out):
        rec.setdefault(key, []).append(out.detach().clone())

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul):
                key = names.get(args[1].data_ptr())
                if key is not None:
                    current[0] = key[0]
                    put(key, out)
                else:
                    put((current[0], "logits" if args[1].shape[-2] < args[1].shape[-1]
                         else "pv"), out)
            return out

    layernorm = eng._layernorm

    def recorded_layernorm(x, scale, bias, out=None):
        out = layernorm(x, scale, bias, out=out)
        key = names.get(scale.data_ptr())
        if key is not None:
            put(key, out)
        return out

    @contextmanager
    def recording():
        rec.clear()
        eng._layernorm = recorded_layernorm
        try:
            with Mode():
                yield rec
        finally:
            eng._layernorm = layernorm

    return recording


def _position(t, sub, b, g, i):
    """Position ``i`` of a verify sub-op output that holds all ``g``
    positions (``[B, g, ...]``, or ``[B, kvh, grp * g, ...]`` for the
    attention's products), as the step's shape for one position."""
    if sub in ("logits", "pv"):
        bb, kvh, rows, last = t.shape
        return t.reshape(bb, kvh, rows // g, g, last)[:, :, :, i]
    return t[:, i:i + 1]


def verify_vs_step(torch, cfg, params, carry, table, active, gamma):
    """The comparison of ``--verify-vs-step`` (module docstring) on one
    carry; returns its findings as a dict.  The carry is cloned for each
    side."""
    from dlbb_tpu_torch.serve import engine as eng

    def clone(c):
        cache, x = c
        return cache._replace(k=cache.k.clone(), v=cache.v.clone(),
                              lengths=cache.lengths.clone()), x.clone()

    recording = _recorder(torch, eng, params)
    b, g1 = carry[1].shape[0], gamma + 1
    # position 0's keys: the verify's logits product also meets the rows the
    # later positions appended, which the length mask then drops
    s_max = carry[0].max_seq
    valid0 = (torch.arange(s_max, device=carry[1].device)[None, :]
              <= carry[0].lengths[:, None])[:, None, None, :]
    decode = eng.build_decode_step(cfg)
    step_carry, ys, toks = clone(carry), [], []
    with recording() as rec:
        for _ in range(g1):
            (cache, y), _ = decode(step_carry, params, active)
            tok = torch.argmax(y[:, 0], dim=-1).to(torch.int32)
            step_carry = (cache, table.index_select(0, tok)[:, None, :].to(y.dtype))
            ys.append(y)
            toks.append(tok)
        step_rec = {k: list(v) for k, v in rec.items()}
    drafts = torch.stack(toks[:gamma], dim=1).contiguous()
    verify = eng.build_verify_probs(cfg, gamma=gamma)
    with recording() as rec:
        _c, y_ver = verify(clone(carry), params, table, drafts, active)
        ver_rec = {k: list(v) for k, v in rec.items()}

    subops = []
    first = None
    for layer in range(cfg.num_layers):
        for sub in SUBOPS:
            want = step_rec[(layer, sub)][0]
            got_all = ver_rec[(layer, sub)]
            got = (got_all[0] if len(got_all) > 1
                   else _position(got_all[0], sub, b, g1, 0))
            if sub == "logits":
                got, want = got * valid0, want * valid0
            same = bool(torch.equal(got, want))
            diff = float((got.float() - want.float()).abs().max())
            subops.append({"layer": layer, "subop": sub, "bit_equal": same,
                           "max_abs_diff": diff,
                           "verify_shape": list(got_all[0].shape),
                           "step_shape": list(want.shape)})
            if not same and first is None:
                first = {"layer": layer, "subop": sub, "max_abs_diff": diff}
    rows = []
    for i in range(g1):
        want, got = ys[i][:, 0], y_ver[:, i]
        rows.append({"position": i, "bit_equal": bool(torch.equal(got, want)),
                     "rows_bit_equal": int(sum(torch.equal(got[s], want[s])
                                               for s in range(b))),
                     "tokens_equal": int((torch.argmax(got, dim=-1).to(torch.int32)
                                          == toks[i]).sum()),
                     "max_abs_diff": float((got.float() - want.float()).abs().max())})
    return {"first_difference_at_position_0": first,
            "subops_first_layers": [r for r in subops if r["layer"] < 2],
            "subops_differing": sum(not r["bit_equal"] for r in subops),
            "subops_compared": len(subops),
            "positions": rows}


def _verify_vs_step_1b(torch, cfg, gamma):
    """``--verify-vs-step`` on the 1B (module docstring)."""
    from dlbb_tpu_torch.data.synthetic import token_embedding_table
    from dlbb_tpu_torch.models import init_params
    from dlbb_tpu_torch.serve.kvcache import create_kv_cache

    slots, max_seq, block = 32, 2048, 16
    params = init_params(cfg, 42, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cache = create_kv_cache(cfg, slots, max_seq // block, block, device="cuda")
    lengths = torch.randint(128, 1152, (slots,), generator=gen, device="cuda",
                            dtype=torch.int32)
    pos = torch.arange(max_seq, device="cuda")[None, :] < lengths[:, None]
    for plane in (cache.k, cache.v):
        rows = plane.view(cfg.num_layers, slots, max_seq, -1)
        rows.normal_(generator=gen)
        rows.mul_(pos[None, :, :, None])
    cache.lengths.copy_(lengths)
    table = token_embedding_table(cfg.hidden_size, torch.bfloat16, device="cuda")
    tok = torch.randint(0, cfg.hidden_size, (slots,), generator=gen, device="cuda")
    x = table.index_select(0, tok)[:, None, :]
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        return verify_vs_step(torch, cfg, params, (cache, x), table, active, gamma)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True,
                   help="directory for the trace and the JSON summary")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--reps", type=int, default=3)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile the 1B Adam train step instead of the forward")
    mode.add_argument("--decode", action="store_true",
                      help="profile the serving engine's decode step instead")
    mode.add_argument("--verify", action="store_true",
                      help="profile one greedy verify unit of the serving engine instead")
    mode.add_argument("--verify-vs-step", action="store_true", dest="verify_vs_step",
                      help="compare one verify unit with the per-step decode, bit for bit")
    p.add_argument("--int8", action="store_true",
                   help="with --decode: the cache in the int8 layout")
    p.add_argument("--gamma", type=int, default=None,
                   help="with --verify: drafts per slot (default 4)")
    args = p.parse_args()
    if args.int8 and not args.decode:
        p.error("--int8 needs --decode")
    if args.gamma is not None and not (args.verify or args.verify_vs_step):
        p.error("--gamma needs --verify or --verify-vs-step")
    gamma = 4 if args.gamma is None else args.gamma

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("torch_e2e_profile: no CUDA device", file=sys.stderr)
        return 1
    from dlbb_tpu_torch.data import SyntheticEmbeddingDataset
    from dlbb_tpu_torch.models import MODEL_CONFIGS, forward, init_params
    from dlbb_tpu_torch.ops import flash_attention as fa
    from dlbb_tpu_torch.utils.config import save_json
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit

    cfg = MODEL_CONFIGS["1B"].with_(attention="full")
    if args.verify_vs_step:
        result = {"gpu": gpu_name_and_power_limit(), "gamma": gamma,
                  **_verify_vs_step_1b(torch, cfg, gamma)}
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        save_json(result, out / f"verify_vs_step_1b_g{gamma}.json")
        print(json.dumps(result))
        return 0
    x = SyntheticEmbeddingDataset(args.batch, args.seq, cfg.hidden_size,
                                  seed=42, device="cuda").get_batch()
    if args.train:
        step, cfg = _train_step(torch, record_function, x, args)
        what = "step"
    elif args.decode:
        step = _decode_step(torch, cfg, int8=args.int8)
        what = "decode_step_int8" if args.int8 else "decode_step"
    elif args.verify:
        step = _verify_unit(torch, cfg, gamma)
        what = f"verify_unit_g{gamma}"
    else:
        params = init_params(cfg, 42, "cuda")
        what = "forward"

        @torch.inference_mode()
        def step():
            return forward(params, x, cfg)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        step()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / args.reps

    def launch_counts():
        return {"flash_fwd": fa.flash_fwd_launches,
                "flash_bwd_dq": fa.flash_bwd_dq_launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv_launches}

    launches0 = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.reps):
            with record_function(f"{what}_{i}"):
                step()
        torch.cuda.synchronize()
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / f"trace_1b_{what}.json"
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())
    events = events.get("traceEvents", events)
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    marks = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith(f"{what}_")]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    t0 = min(e["ts"] for e in marks) if marks else min(e["ts"] for e in kernels)
    t1 = max(e["ts"] + e["dur"] for e in kernels)
    window_us = t1 - t0
    busy_us = union_length([(e["ts"], e["ts"] + e["dur"]) for e in kernels])

    by_class: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        cls = classify(e["name"])
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"]
        rec = by_name.setdefault(e["name"][:120], [0.0, 0, cls])
        rec[0] += e["dur"]
        rec[1] += 1
    reps = args.reps
    kernel_total_ms = sum(by_class.values()) / 1e3 / reps
    result = {
        "gpu": gpu_name_and_power_limit(),
        "shape": {"model": "1B",
                  **({"slots": 32, "max_seq": 2048, "block_size": 16,
                      "kv_quantization": "int8" if args.int8 else "none"}
                     if args.decode or args.verify
                     else {"batch": args.batch, "seq": args.seq}),
                  **({"gamma": gamma} if args.verify else {}),
                  "dtype": "bfloat16", "attention": "full",
                  "remat_policy": cfg.remat_policy if cfg.remat else None},
        f"{what}_ms_cuda_events": event_ms,
        f"traced_window_ms_per_{what}": window_us / 1e3 / reps,
        f"device_busy_ms_per_{what}": busy_us / 1e3 / reps,
        "device_idle_share": 1.0 - busy_us / window_us,
        f"kernel_ms_per_{what}": kernel_total_ms,
        f"kernels_per_{what}": len(kernels) / reps,
        f"flash_launches_per_{what}": {k: v / reps for k, v in launches.items()},
        f"ms_per_{what}_by_class": {k: v / 1e3 / reps for k, v in
                                    sorted(by_class.items(), key=lambda kv: -kv[1])},
        "share_by_class": {k: v / 1e3 / reps / kernel_total_ms for k, v in
                           sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": n, "class": c, f"ms_per_{what}": t / 1e3 / reps,
             f"calls_per_{what}": k / reps}
            for n, (t, k, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        ],
    }
    if args.train:
        phases = by_phase(events, kernels)
        result["ms_per_step_by_phase"] = {
            k: sum(v.values()) / 1e3 / reps for k, v in phases.items()}
        result["ms_per_step_by_phase_and_class"] = {
            k: {c: t / 1e3 / reps for c, t in sorted(v.items(), key=lambda kv: -kv[1])}
            for k, v in phases.items()}
    for row in result["top_kernels"]:
        print(f"{row[f'ms_per_{what}']:9.3f} ms  x{row[f'calls_per_{what}']:6.1f}  "
              f"[{row['class']}] {row['name']}")
    save_json(result, out / f"profile_1b_{what}.json")
    if trace_path.stat().st_size > 48 * 2**20:  # keep what is brought back small
        os.remove(trace_path)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
