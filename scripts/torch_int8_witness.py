#!/usr/bin/env python3
"""Why int8 KV flips greedy tokens: the witness behind the equivalence gate
of ``scripts/torch_bench_prefix.py``.

    python3 scripts/torch_int8_witness.py [--requests N] [--device cpu]
                                          [--output results/torch/int8_witness.json]

Serves the prefix bench's two seeded shared-prefix traces through the
no-sharing fp engine and the prefix-cached int8 engine with token capture
on (the gate's runs, the same sizes and model), then decodes every request
again with a plain reference: the model's ``forward`` over the whole
sequence at each step (no cache), the output hidden state appended as the
next input, as the engine's "off" mode feeds it, in fp32 (the engine's
bf16 weights cast up, TF32 off) and in bf16.  It prints and writes:

- the share of requests whose tokens each decode gives identically to the
  fp engine's: the int8 engine (the gate's count), the fp32 reference (how
  far the bf16 engine itself sits from exact arithmetic), the bf16
  reference (another summation order at the engine's precision), and the
  int8 engine against the fp32 reference;
- for each request where int8 leaves the fp engine, the first differing
  position, the fp32 reference's top-2 output gap there (the argmax's
  margin), that gap over the output's standard deviation, and whether the
  fp32 reference still agreed with the fp engine up to that position;
- the median top-2 gap over every position of every request, for scale.

A near-tie gap at the flips and an fp32 flip rate of the same order as
int8's say the flips are the random model's sensitivity, not the int8
rule.  On the card (the default) the model is the 1B of ``serve_1b.yaml``;
``--device cpu`` runs the prefix bench's small model on its CPU ranks and
the references in this process.  Nothing is gated: the script exits 0
once every decode ran.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from _torch_serve_bench import SMALL_MODEL, bench_model, card_mesh, serve_settings  # noqa: E402
from torch_bench_prefix import MESH, MODES, SERVE, _traces  # noqa: E402

ENGINES = ("off_none", "on_int8")


def _reference_tokens(torch, params, cfg, trace, dev):
    """Per request id: (greedy tokens, top-2 gap and output std at each
    position) of the plain decode at ``cfg``'s dtype."""
    from dlbb_tpu_torch.data.synthetic import request_embeddings
    from dlbb_tpu_torch.models import forward
    from dlbb_tpu_torch.models.transformer import DTYPES

    dtype = DTYPES[cfg.dtype]
    out = {}
    with torch.inference_mode():
        for r in trace.requests:
            seq = request_embeddings(r.seed, r.prompt_len, cfg.hidden_size, dtype=dtype,
                                     prefix_len=r.prefix_len, prefix_seed=r.prefix_seed,
                                     device=dev)
            toks, gaps, stds = [], [], []
            for _ in range(r.output_len):
                y = forward(params, seq, cfg)[:, -1:]
                top = torch.topk(y[0, 0].float(), 2).values
                toks.append(int(torch.argmax(y[0, 0])))
                gaps.append(float(top[0] - top[1]))
                stds.append(float(y.float().std()))
                seq = torch.cat([seq, y.to(dtype)], dim=1)
            out[str(r.rid)] = (toks, gaps, stds)
    return out


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=16,
                    help="requests per trace (default 16, the prefix bench's)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--output", default=str(REPO / "results" / "torch" / "int8_witness.json"))
    args = ap.parse_args(argv)

    import torch

    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.models.transformer import DTYPES
    from dlbb_tpu_torch.train.optim import tree_map
    from dlbb_tpu_torch.utils.config import atomic_write_text
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit, resolve_device

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_name_and_power_limit() if dev.type == "cuda" else None
    if gpu:
        print(gpu)
    model, seed = bench_model(dev.type, SMALL_MODEL)
    mesh = card_mesh(*MESH, dev.type)
    traces = _traces(args.requests)
    runs = [{"name": f"{t}/{m}", "mesh": "m", "trace": t,
             "serving": dict(SERVE, **MODES[m]), "capture": True}
            for t in traces for m in ENGINES]
    captures = serve_settings(model, seed, {"m": mesh}, runs, traces, 0, dev)["captures"]

    cfg = ModelConfig.from_dict(model)
    params = init_params(cfg, seed, dev)
    refs = {}
    for dtype in ("float32", "bfloat16"):
        rcfg = dataclasses.replace(cfg, dtype=dtype, attention="dense")
        p = tree_map(lambda t: t.to(DTYPES[dtype]), params)
        refs[dtype] = {t: _reference_tokens(torch, p, rcfg, trace, dev)
                       for t, trace in traces.items()}

    result = {"model": model, "seed": seed, "serving": dict(SERVE), "device": gpu or dev.type,
              "traces": {}}
    all_gaps = []
    for tname, trace in traces.items():
        fp = captures[f"{tname}/off_none"]
        q8 = captures[f"{tname}/on_int8"]
        f32 = {rid: v[0] for rid, v in refs["float32"][tname].items()}
        b16 = {rid: v[0] for rid, v in refs["bfloat16"][tname].items()}
        all_gaps += [g for v in refs["float32"][tname].values() for g in v[1]]
        flips = []
        for rid in sorted(fp, key=int):
            at = _first_diff(q8[rid], fp[rid])
            if at is None:
                continue
            _, gaps, stds = refs["float32"][tname][rid]
            ref_at = _first_diff(f32[rid], fp[rid])
            flips.append({"rid": int(rid), "position": at, "of": len(fp[rid]),
                          "fp32_gap": gaps[at], "fp32_gap_over_std": gaps[at] / stds[at],
                          "fp32_agrees_with_fp_up_to_it": ref_at is None or ref_at >= at})
        n = len(fp)
        rec = {
            "requests": n,
            "identical_to_fp_engine": {
                "int8_engine": sum(q8[r] == fp[r] for r in fp),
                "fp32_reference": sum(f32[r] == fp[r] for r in fp),
                "bf16_reference": sum(b16[r] == fp[r] for r in fp),
            },
            "int8_engine_identical_to_fp32_reference": sum(q8[r] == f32[r] for r in fp),
            "int8_flips": flips,
        }
        result["traces"][tname] = rec
        same = rec["identical_to_fp_engine"]
        print(f"[{tname}] of {n} requests identical to the fp engine: int8 engine "
              f"{same['int8_engine']}, fp32 reference {same['fp32_reference']}, bf16 "
              f"reference {same['bf16_reference']}; int8 engine vs fp32 reference "
              f"{rec['int8_engine_identical_to_fp32_reference']}")
        for f in flips:
            print(f"[{tname}] request {f['rid']}: int8 leaves fp at position {f['position']} "
                  f"of {f['of']}; fp32 top-2 gap there {f['fp32_gap']:.4e} "
                  f"({f['fp32_gap_over_std']:.4e} of the output's std); fp32 agrees with "
                  f"fp up to it {f['fp32_agrees_with_fp_up_to_it']}")
    all_gaps.sort()
    result["median_fp32_gap_all_positions"] = all_gaps[len(all_gaps) // 2]
    print(f"median fp32 top-2 gap over all {len(all_gaps)} positions: "
          f"{result['median_fp32_gap_all_positions']:.4e}")
    out = Path(args.output)
    atomic_write_text(json.dumps(result, indent=1) + "\n", out)
    print(f"int8 witness -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
