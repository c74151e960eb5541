"""Shared pieces of the port's serving bench scripts
(``scripts/torch_bench_{serving,speculative,prefix}.py``): the device and
the model they run, the run of their settings on each rank, and the
records every ``BENCH_*.json`` carries.

``run_settings`` is the rank body: every rank builds the meshes, each
mesh's parameters once (its tp shards from the seed; the engines of a mesh
share them), then serves the capture runs (token capture on: the gates'
inputs), then builds one engine per timed setting, replays each setting's
trace once untimed (first-call costs), and replays them in turn ``reps``
times, settings interleaved within each repetition, so that drift of the
host cancels across settings.  A rank outside a setting's mesh skips it.
On the card every mesh is one rank in this process (NCCL puts no two ranks
of a communicator on one GPU); with ``--device cpu`` the ranks are gloo
processes launched by ``bench/launch.py``, as JAX runs its settings on
simulated devices.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

# JAX's bench scripts serve this 2-layer model (``scripts/bench_*.py``'s
# BENCH_MODEL, with ``bench_serving.py``'s width and kv heads where noted)
SMALL_MODEL = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128,
                   dtype="float32", attention="full")
CARD_CONFIG = "dlbb_tpu_torch/configs/serve_1b.yaml"


def median(vals):
    vals = sorted(vals)
    return vals[len(vals) // 2]


def spread(vals) -> dict:
    return {"median": median(vals), "min": min(vals), "max": max(vals), "reps": list(vals)}


def bench_model(device_type: str, small: dict) -> tuple[dict, int]:
    """``(model fields, seed)``: the 1B of ``serve_1b.yaml`` at its
    ``input.seed`` on the card, JAX's small model at JAX's engine seed 0 on
    the CPU."""
    if device_type == "cpu":
        return dict(small), 0
    from dlbb_tpu_torch.utils.config import load_config

    config = load_config(CARD_CONFIG)
    return dict(config["model"]), int(config["input"]["seed"])


def device_record(dev, gpu: Optional[str], world: int) -> dict[str, Any]:
    """The keys every bench file carries about where it ran."""
    import torch

    return {
        "backend": f"torch_{dev.type}",
        "device": gpu or dev.type,
        "world": world,
        "torch_version": torch.__version__,
        "host_cpu_count": os.cpu_count(),
        "timestamp": time.time(),
        "chip": ({"status": "measured", "device": gpu} if dev.type == "cuda" else
                 {"status": "not measured", "device": "cpu",
                  "note": "CPU ranks over gloo: correctness and the schedule, not speed"}),
    }


def card_mesh(dp: int, tp: int, device_type: str) -> tuple[int, int]:
    """The (dp, tp) a setting's mesh takes: JAX's on the CPU ranks, one rank
    on the card."""
    return (dp, tp) if device_type == "cpu" else (1, 1)


def _mesh(dp: int, tp: int, world: int):
    from dlbb_tpu_torch.comm import build_parallelism_mesh

    return None if world == 1 else build_parallelism_mesh(dp, 1, 1, tp, 1)


def run_settings(model: dict, seed: int, meshes: dict, runs: list, traces: dict,
                 reps: int, device: str) -> Optional[dict]:
    """One rank of a bench (module docstring).  ``meshes``: key -> (dp, tp);
    ``runs``: dicts with ``name``, ``mesh`` (a key), ``serving`` (the
    ``ServingConfig`` fields), ``trace`` (a key of ``traces``) and
    ``capture`` (a gate's run, before the timed ones).  Returns, on rank 0,
    ``{"captures": {name: completed tokens}, "timed": {name: [report with
    its "wall_s", per repetition]}}``; None on the other ranks."""
    import torch.distributed as dist

    from dlbb_tpu_torch.models import ModelConfig, init_params
    from dlbb_tpu_torch.serve.engine import ServingConfig, ServingEngine
    from dlbb_tpu_torch.utils.sysinfo import resolve_device

    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = ModelConfig.from_dict(model)
    built = {key: _mesh(dp, tp, world) for key, (dp, tp) in meshes.items()}
    params: dict = {}
    drafts: dict = {}

    def engine(run, capture):
        mesh = built[run["mesh"]]
        serving = ServingConfig(**run["serving"])
        tp_rank = 0 if mesh is None else mesh.coords["tp"]
        tp = 1 if mesh is None else mesh.shape["tp"]
        if run["mesh"] not in params:
            params[run["mesh"]] = init_params(cfg, seed, dev, tp_rank=tp_rank, tp=tp)
        draft = None
        if serving.speculation == "draft-model":
            key = (run["mesh"], serving.spec_draft_layers)
            if key not in drafts:
                drafts[key] = init_params(serving.draft_model_config(cfg), seed + 1, dev,
                                          tp_rank=tp_rank, tp=tp)
            draft = drafts[key]
        return ServingEngine(cfg, serving, mesh, params=params[run["mesh"]], seed=seed,
                             verbose=False, capture_tokens=capture, device=dev,
                             draft_params=draft)

    def mine(run):
        return world == 1 or built[run["mesh"]] is not None

    lead = world == 1 or dist.get_rank() == 0
    captures = {}
    for run in runs:
        if run["capture"] and mine(run):
            report = engine(run, True).run_trace(traces[run["trace"]])
            captures[run["name"]] = report["completed_tokens"]
    timed = {run["name"]: (run, engine(run, False)) for run in runs
             if not run["capture"] and mine(run)}
    for run, eng in timed.values():
        eng.run_trace(traces[run["trace"]])
    out: dict = {name: [] for name in timed}
    for _ in range(reps):
        for name, (run, eng) in timed.items():
            t0 = time.perf_counter()
            report = eng.run_trace(traces[run["trace"]])
            report["wall_s"] = time.perf_counter() - t0
            report.pop("completed_tokens", None)
            out[name].append(report)
    return {"captures": captures, "timed": out} if lead else None


def serve_settings(model: dict, seed: int, meshes: dict, runs: list, traces: dict,
                   reps: int, dev) -> dict:
    """``run_settings`` in this process on the card (or at one rank), else
    on as many gloo ranks as the largest mesh; rank 0's result."""
    import math

    world = max(math.prod(m) for m in meshes.values())
    args = (model, seed, meshes, runs, traces, reps, dev.type)
    if world == 1:
        return run_settings(*args)
    from dlbb_tpu_torch.bench.launch import launch

    return launch(run_settings, world, dev.type, args=args, timeout=3600,
                  group_timeout=3600)[0]
