"""Command line (counterpart of ``dlbb_tpu/cli.py``; ``python -m
dlbb_tpu_torch`` runs it too).

    python -m dlbb_tpu_torch.cli e2e --config CONFIG.yaml [--output DIR]
                                     [--world N] [--device cuda|cpu]
                                     [--tp-overlap off|ring|bidir] [--trace DIR]
                                     [--span-trace FILE]
    python -m dlbb_tpu_torch.cli train --config CONFIG.yaml [--output DIR]
                                       [--world N] [--zero STAGE | --zero1]
                                       [--device cuda|cpu]
                                       [--tp-overlap off|ring|bidir]
                                       [--grad-compression none|int8|fp8] [--trace DIR]
                                       [--span-trace FILE]
    python -m dlbb_tpu_torch.cli bench1d [--ops ...] [--sizes ...] [--ranks ...]
                                         [--world N] [--device cuda|cpu]
                                         [--fault-plan PLAN] [--deadline SEC]
                                         [--max-retries N] [--no-journal]
                                         [--span-trace FILE] [--pipeline | --no-pipeline]
                                         [--prefetch K] [--compile-cache auto|off]
                                         [--device-trace DIR] [--trace DIR] ...
    python -m dlbb_tpu_torch.cli bench3d [--ops ...] [--batch ...] [--seq ...]
                                         [--hidden ...] [--ranks ...] ...
    python -m dlbb_tpu_torch.cli stats1d --input DIR --output DIR
    python -m dlbb_tpu_torch.cli stats3d --input DIR --output DIR [--impl NAME]
    python -m dlbb_tpu_torch.cli compare --reference ROOT [--own-1d DIR]
                                         [--own-3d DIR] [--own-e2e DIR]
                                         [--output DIR] [--impl NAME]
    python -m dlbb_tpu_torch.cli reports [--stats DIR] [--results DIR] [--impl NAME]
    python -m dlbb_tpu_torch.cli serve [--config CONFIG.yaml] [--trace KIND|PATH]
                                       [--requests N] [--world N] [--device cuda|cpu]
                                       [--output DIR] [--resume] [--fault-plan PLAN]
                                       [--device-trace DIR] [--xplane-trace DIR] ...
    python -m dlbb_tpu_torch.cli obs trace|devtrace --journal DIR [--output PATH]
    python -m dlbb_tpu_torch.cli obs fit [--results DIR ...] [--tier TIER]
                                         [--fit-dir DIR] [--min-samples N] [--host STR]
    python -m dlbb_tpu_torch.cli obs attribute --journal DIR [--span-trace-file FILE]
                                               [--model cm1|cm2] [--tier TIER]
                                               [--fit-dir DIR] [--output DIR]
    python -m dlbb_tpu_torch.cli analyze lint|hlo [--simulate N] [--json PATH]
                                         [--root DIR] [--strict-warnings]
                                         [--output DIR]
    python -m dlbb_tpu_torch.cli chaos [--plan CLASS|all] [--world N]
                                       [--device cuda|cpu] [--output DIR]
    python -m dlbb_tpu_torch.cli plan --auto|--capacity [--target serving|train]
                                      [--simulate N] [--tier TIER] [--fit-dir DIR]
                                      [--top-k K] [--no-measure] [--output DIR]
                                      [--bench-out FILE] ...

The sweeps launch ``--world`` ranks (default: the largest of ``--ranks``)
through ``bench/launch.py``: NCCL with one GPU per rank on ``cuda``, gloo
on ``cpu``.  ``e2e`` does the same with ``--world`` ranks (default: the
config's mesh, dp x tp x sp x pp x ep), and so does ``train``; at world 1
they run in this process with no process group.  Under ``torchrun`` they
run in place as their rank.  ``--tp-overlap`` overrides the config's
``model.tp_overlap``, so one YAML sweeps fused against ring and bidir.
The YAML's ``parallelism:`` section sets every axis of the JAX package's
mesh, ``pipeline_parallel`` (with ``num_microbatches``) and
``expert_parallel`` included; ``model.num_experts``, ``moe_top_k`` and
``moe_dispatch`` select the MoE FFN, and ``training.pipeline_schedule``
("gpipe" or "1f1b") and ``training.moe_aux_loss_weight`` the pipeline's
training schedule and the load-balancing loss.  ``--grad-compression``
overrides ``training.grad_compression`` (the quantised dp reduction with
error feedback; ``training.compression_accum_dtype`` picks its
accumulation), and the sweeps take the compressed ops ``allreduce_q`` and
``reducescatter_q`` under the ``compress_*`` variants.

Every default output of the port lies under ``results/torch``: the sweeps
write to ``results/torch/1d`` and ``results/torch/3d``, and the configs'
``e2e`` results to ``results/torch/e2e``, never into the JAX package's
corpus under ``results/``.  ``compare`` and ``reports`` are file
processing over the port's own results: their default trees are
``results/torch`` and ``stats/torch`` (``stats/torch/1d/<impl>``,
``stats/torch/variants/<impl>``, ``results/torch/parallelism``,
``results/torch/serving`` and ``results/torch/BENCH_fleet.json`` into
``stats/torch/serving``).

``serve`` is JAX's serving benchmark (``serve/bench.py``): a synthetic
traffic trace through the continuous-batching engine, JAX's flags and
defaults, on ``--world`` ranks (default 1, auto-planned into (dp, tp) as
JAX plans ``--simulate``'s devices; a config's ``parallelism:`` section
sets the mesh instead) through ``bench/launch.py``, written by rank 0 to
``results/torch/serving`` unless ``--output`` names another directory.
``--replicas N`` serves through the replica fleet (``serve/fleet.py``): N
failure domains of one replica's mesh each, on N x that mesh's ranks, which
share the GPUs over gloo.  The
reference corpus of ``compare`` is not in this repository: ``--reference``
names its root.

Device traces (``utils/profiling.py``, ``obs/capture.py``): ``--trace DIR``
on ``e2e``, ``train`` and the sweeps (``--xplane-trace DIR`` on ``serve``,
whose ``--trace`` names the traffic) writes a ``torch.profiler`` trace of
the whole run, each launched rank its own ``DIR/rank<r>/``;
``--device-trace DIR`` on the sweeps and ``serve`` captures dedicated
profile reps (one per measured config; one prefill and one decode scan
after the trace is served) outside every timed region.  ``obs devtrace
--journal RUN_DIR`` parses a run's captures into per-op device timelines
(``obs/devtrace.py``), ``obs trace --journal RUN_DIR`` rebuilds its
timeline from the journal.  ``obs fit`` walks results trees into the
corpus (``obs/corpus.py``) and appends a cm2 fit per tier to the port's own
DB, ``stats/torch/analysis/costmodel_fit`` (``obs/fit.py``).

``e2e`` and ``train`` run under rank 0's host span tracer when
``--span-trace FILE`` (else ``DLBB_SPANS``) names a file, as JAX's do; the
train loop emits JAX's ``compile+warmup``, ``train_step`` and ``measure``
spans.  ``obs attribute --journal RUN_DIR`` partitions a run's span trace
(else its journal) into phases priced by the cost model
(``obs/attribution.py``); ``--model cm2`` on a tier with no fit exits 1.

``chaos`` is JAX's chaos gate (``resilience/chaos.py``): each fault class
drives the sweep, the checkpointer, the serving harness or the fleet under
an injected fault and checks JAX's invariants; ``--world`` and
``--device`` take the place of JAX's ``--simulate``.

``plan`` is JAX's autotuner and capacity planner (``plan/autotune.py``):
``--simulate N`` searches N gloo ranks' plan space on the CPU (tier
``cpu-sim``), else the visible GPUs' (tier ``cuda``); measured plans run
on their own ranks through ``bench/launch.py``.  A tier with no cm2 fit
(the card's ``cuda`` tier at world 1) journals every point
``cm2-fit-missing`` and exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys

_DEVICE_HELP = "cuda (the default) or cpu; without a CUDA device only an explicit cpu runs"
_OVERLAP_HELP = ("override model.tp_overlap: ring-decomposed overlapped "
                 "tensor-parallel projections (needs tp > 1)")


def _add_sweep_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--variant", default="default", help="named tuning variant")
    p.add_argument("--ranks", type=int, nargs="+", default=None,
                   help="rank counts to sweep")
    p.add_argument("--world", type=int, default=None,
                   help="ranks to launch (default: the largest of --ranks)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float16", "float32"])
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--output", default=None, help="output directory for result JSONs")
    p.add_argument("--max-config-seconds", type=float, default=None,
                   help="wall-time cap per config (iteration counts scale down)")
    p.add_argument("--max-global-bytes", type=int, default=None,
                   help="skip configs whose global input+output exceeds this")
    p.add_argument("--resume", action="store_true",
                   help="skip configs whose result JSON already exists and validates")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    p.add_argument("--fault-plan", default=None, metavar="PLAN",
                   help="deterministic fault-injection plan (e.g. "
                        "'exec-transient:2,seed=7'; DLBB_FAULT_PLAN env is the default)")
    p.add_argument("--deadline", type=float, default=None, metavar="SEC",
                   dest="unit_deadline",
                   help="wall-clock watchdog per config; an overrun is abandoned "
                        "and quarantined (DLBB_UNIT_DEADLINE env default)")
    p.add_argument("--max-retries", type=int, default=2, metavar="N",
                   help="bounded retries with exponential backoff for transient "
                        "per-config failures (default 2)")
    p.add_argument("--no-journal", action="store_true",
                   help="disable the append-only sweep_journal.jsonl (on by default)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="build each config's callable inline, no compile-ahead thread "
                        "(serial debug mode; identical result schema and timing)")
    p.add_argument("--pipeline", action="store_true",
                   help="force the compile-ahead thread on (default: auto — enabled "
                        "only on hosts with spare cores)")
    p.add_argument("--prefetch", type=int, default=2, metavar="K",
                   help="configs built ahead of the one measuring (pipelined mode; "
                        "default 2)")
    p.add_argument("--compile-cache", default="auto", metavar="auto|off",
                   help="JAX's persistent compilation cache: eager torch has none, so "
                        "'auto' and 'off' record it as disabled and a directory is "
                        "refused")
    p.add_argument("--device-trace", default=None, metavar="DIR", dest="device_trace",
                   help="capture a torch.profiler device trace per config on a "
                        "DEDICATED profile rep (excluded from the stats series) under "
                        "DIR; DLBB_DEVICE_TRACE env is the default")
    _add_trace(p)


def _add_trace(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the whole run to DIR (each "
                        "launched rank to DIR/rank<r>); DLBB_TRACE_DIR env is the "
                        "default")
    p.add_argument("--span-trace", default=None, metavar="FILE", dest="span_trace",
                   help="write rank 0's host-side span trace of the whole run (Chrome "
                        "trace-event JSON, Perfetto-loadable) to FILE; DLBB_SPANS env "
                        "is the default")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dlbb_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    e2 = sub.add_parser("e2e", help="end-to-end transformer forward benchmark")
    e2.add_argument("--config", required=True, help="YAML experiment config")
    e2.add_argument("--output", default=None)
    e2.add_argument("--world", type=int, default=None,
                    help="ranks to launch (default: the config's mesh size)")
    e2.add_argument("--device", default=None, help=_DEVICE_HELP)
    e2.add_argument("--tp-overlap", choices=("off", "ring", "bidir"), default=None,
                    help=_OVERLAP_HELP)
    _add_trace(e2)
    tr = sub.add_parser("train", help="DDP/ZeRO-{1,2,3} training-loop benchmark")
    tr.add_argument("--config", required=True, help="YAML experiment config")
    tr.add_argument("--zero1", action="store_true", help="shard optimizer state (ZeRO-1)")
    tr.add_argument("--zero", type=int, default=None, choices=(0, 1, 2, 3),
                    metavar="STAGE", dest="zero_stage",
                    help="ZeRO stage: 0=DDP, 1=opt-state sharding, "
                         "2=+grad reduce-scatter, 3=FSDP param sharding")
    tr.add_argument("--output", default=None)
    tr.add_argument("--world", type=int, default=None,
                    help="ranks to launch (default: the config's mesh size)")
    tr.add_argument("--device", default=None, help=_DEVICE_HELP)
    tr.add_argument("--tp-overlap", choices=("off", "ring", "bidir"), default=None,
                    help=_OVERLAP_HELP)
    tr.add_argument("--grad-compression", choices=("none", "int8", "fp8"), default=None,
                    help="override training.grad_compression: quantised dp "
                         "gradient reduction with error feedback (needs dp > 1)")
    _add_trace(tr)

    b1 = sub.add_parser("bench1d", help="1D collective microbenchmark sweep")
    _add_sweep_args(b1)
    b1.add_argument("--ops", nargs="+", default=None, help="collectives to benchmark")
    b1.add_argument("--sizes", nargs="+", default=None,
                    help="size labels (1KB 64KB 1MB 16MB 64MB 256MB 1GB) or 'extended'")
    b3 = sub.add_parser("bench3d", help="3D (batch, seq, hidden) tensor collective sweep")
    _add_sweep_args(b3)
    b3.add_argument("--ops", nargs="+", default=None)
    b3.add_argument("--batch", type=int, nargs="+", default=None)
    b3.add_argument("--seq", type=int, nargs="+", default=None)
    b3.add_argument("--hidden", type=int, nargs="+", default=None)

    s1 = sub.add_parser("stats1d", help="process 1D result JSONs to stats + CSV")
    s1.add_argument("--input", required=True)
    s1.add_argument("--output", required=True)
    s1.add_argument("--algorithm-bandwidth", action="store_true",
                    help="per-op bus-bandwidth factors instead of the "
                         "reference's uniform formula")
    s3 = sub.add_parser("stats3d", help="process 3D result JSONs to standard+transposed CSVs")
    s3.add_argument("--input", required=True)
    s3.add_argument("--output", required=True)
    s3.add_argument("--impl", default="torch_nccl", help="names the CSV files")

    cp = sub.add_parser("compare", help="reference-vs-port head-to-head comparison "
                                        "report (CSV + markdown, per-config verdicts)")
    cp.add_argument("--reference", required=True,
                    help="reference repo root (holds collectives/{1d,3d}/results)")
    cp.add_argument("--own-1d", default="results/torch/1d",
                    help="the port's 1D result JSONs (bench1d's default output)")
    cp.add_argument("--own-3d", default="results/torch/3d",
                    help="the port's 3D result JSONs (bench3d's default output)")
    cp.add_argument("--own-e2e", default="results/torch/e2e",
                    help="the port's run_e2e result JSONs")
    cp.add_argument("--baseline", default="bench_baseline_cpu.json",
                    help="the reference-stack torch-CPU E2E baseline")
    cp.add_argument("--output", default="stats/torch/compare")
    cp.add_argument("--impl", default="torch_nccl", help="the port's side of the join")

    rp = sub.add_parser("reports", help="regenerate the derived reports (variant "
                                        "tuning 1D + 3D winners, parallelism families, "
                                        "the north-star curve) from the port's results "
                                        "and stats: file processing, no device")
    rp.add_argument("--stats", default="stats/torch", help="stats tree root")
    rp.add_argument("--results", default="results/torch",
                    help="results tree root (parallelism results)")
    rp.add_argument("--impl", default="torch_nccl",
                    help="the baseline implementation of the variant tables and "
                         "the north-star curve's stats")
    _add_serve_parser(sub)
    _add_analyze_parser(sub)

    ob = sub.add_parser(
        "obs", help="observability: journal->trace reconstruction (trace), the "
                    "device-trace analysis of a run's captures (devtrace), the cm2 "
                    "cost-model fit (fit) and span-level time attribution (attribute); "
                    "exit codes 0 clean / 1 findings / 2 crash")
    ob.add_argument("which", choices=("trace", "calibrate", "diff", "fit", "attribute",
                                      "devtrace"),
                    help="trace = rebuild a Perfetto timeline from a run's journal; "
                         "devtrace = parse the run's device captures into per-op device "
                         "timelines and buckets (MD+CSV+JSON under "
                         "stats/torch/analysis/devtrace/); fit = regress cm2 (alpha, "
                         "beta, peak, per-dispatch gamma) from the sweep-artifact corpus "
                         "into the versioned fitted DB; attribute = join a run's span "
                         "trace/journal against the cost model into a per-phase 'where did "
                         "the time go' report (MD+CSV under stats/torch/analysis/"
                         "attribution/); calibrate and diff are not ported yet (item 14, "
                         "part 14b, over item 15, part 15b's baselines)")
    ob.add_argument("--journal", default=None, metavar="DIR",
                    help="the run's output directory (sweep_journal.jsonl for trace, "
                         "the captured results for devtrace, the span trace or journal "
                         "for attribute)")
    ob.add_argument("--output", default=None,
                    help="output path (trace JSON) or report directory (devtrace, "
                         "attribute; the fitted-DB directory of fit when --fit-dir is not "
                         "given)")
    ob.add_argument("--strict-warnings", action="store_true",
                    help="warnings also exit 1")
    ob.add_argument("--results", nargs="+", default=None, metavar="DIR",
                    help="results tree(s) the fit ingests (default: results/torch)")
    ob.add_argument("--tier", default=None, metavar="TIER",
                    help="cost-model tier (cpu-sim, cuda, ...): fit's tier (default: "
                         "every tier in the corpus; an explicit tier that cannot be "
                         "fitted exits 1), attribute's pricing tier (default: the one "
                         "the run's artifacts record)")
    ob.add_argument("--model", default="cm1", choices=("cm1", "cm2"),
                    help="cost model for attribute: cm1 the analytic constants, cm2 the "
                         "fitted DB (a tier with no fit exits 1)")
    ob.add_argument("--span-trace-file", default=None, metavar="FILE",
                    dest="span_trace_file",
                    help="explicit span-trace JSON for obs attribute (default: "
                         "auto-detect in --journal DIR)")
    ob.add_argument("--fit-dir", default=None, metavar="DIR", dest="fit_dir",
                    help="fitted-DB directory (default stats/torch/analysis/"
                         "costmodel_fit)")
    ob.add_argument("--min-samples", type=int, default=None, dest="min_samples",
                    help="minimum corpus samples per tier before the fit refuses "
                         "(default 16)")
    ob.add_argument("--host", default=None, dest="host_filter",
                    help="substring filter on the corpus host fingerprint: fit the "
                         "tier for the host you will predict on")

    ch = sub.add_parser(
        "chaos", help="chaos gate: mini-sweeps, a checkpoint and mini serving runs "
                      "under each injected fault class, asserting the resilience "
                      "invariants; exit 0 green / 1 a class failed / 2 unknown class")
    ch.add_argument("--plan", default="all",
                    help="fault class to exercise (compile, transient, nan, torn, hang, "
                         "ckpt, preempt, kill, serve, fleet) or 'all'")
    ch.add_argument("--world", type=int, default=None,
                    help="ranks of the mini-grid and the serving layouts (default: 4 "
                         "gloo ranks on cpu, JAX's layouts; 1 on cuda, one NCCL rank "
                         "per card)")
    ch.add_argument("--device", default=None, help=_DEVICE_HELP)
    ch.add_argument("--output", default=None,
                    help="workdir for the gate's artifacts (default: a fresh temp dir, "
                         "kept on failure)")
    _add_plan_parser(sub)
    return p


def _add_analyze_parser(sub) -> None:
    """``analyze``: JAX's positional pass and flags (``dlbb_tpu/cli.py:150-204``),
    its ``--simulate N`` as N gloo ranks on the CPU."""
    an = sub.add_parser(
        "analyze",
        help="comm-lint: the source lint (lint) and the collective audit of every "
             "registered target's c10d ops (hlo); the schedule, memory and numerics "
             "passes and the baseline gate are not ported yet (ROADMAP Queue 1, Slice F, "
             "item 15, part 15b) and exit 2.  Exit codes 0 clean / 1 findings / 2 crash")
    an.add_argument("which", nargs="?", default="all",
                    choices=("hlo", "lint", "schedule", "memory", "numerics", "all",
                             "snapshot", "diff"),
                    help="pass to run: hlo = collective audit, lint = AST source lint; "
                         "schedule, memory, numerics, all, snapshot and diff exit 2 "
                         "(part 15b)")
    an.add_argument("--simulate", type=int, default=0, metavar="N",
                    help="run the collective audit on N gloo ranks on the CPU (targets "
                         "needing more ranks are skipped; without it every target is)")
    an.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable findings report here")
    an.add_argument("--root", default=".",
                    help="repo root for the source lint (default: cwd)")
    an.add_argument("--strict-warnings", action="store_true",
                    help="exit nonzero on warnings too")
    an.add_argument("--baselines", default=None, metavar="DIR",
                    help="baseline directory of snapshot/diff (part 15b)")
    an.add_argument("--tier", default=None, metavar="TIER",
                    help="cost-model tier of the schedule pass (part 15b)")
    an.add_argument("--model", default="cm1", choices=("cm1", "cm2"),
                    help="cost model of the schedule pass (part 15b)")
    an.add_argument("--output", default=None, metavar="DIR",
                    help="fold the per-pass analysis_findings{pass,severity} gauges "
                         "into DIR/metrics.prom")


def _add_plan_parser(sub) -> None:
    """``plan``: JAX's flags and defaults (``dlbb_tpu/cli.py:474-541``), its
    ``--simulate N`` as N gloo ranks on the CPU."""
    pl = sub.add_parser(
        "plan",
        help="cm2-driven parallelism-plan autotuner: enumerate the full plan space, "
             "statically prune (validate_*/HBM, every pruned point journaled with its "
             "reason), rank by the fitted cost model, measure the top-k through the "
             "real engines (--auto); or price a fleet capacity curve over a traffic "
             "trace + SLO (--capacity); exit 1 when the tier has no cm2 fit")
    mode = pl.add_mutually_exclusive_group(required=True)
    mode.add_argument("--auto", action="store_true",
                      help="run the predict-prune-measure plan search")
    mode.add_argument("--capacity", action="store_true",
                      help="run the fleet capacity planner (predicted vs measured "
                           "goodput/TTFT per plan + replicas-for-N-users curve, "
                           "published to stats/torch/serving/SERVING.md)")
    pl.add_argument("--target", default="serving", choices=("serving", "train"),
                    help="which engine's plan space to search (--auto)")
    pl.add_argument("--top-k", type=int, default=2, dest="top_k",
                    help="cm2-ranked plans to validate with real measured runs (the "
                         "default heuristic plan is always measured too)")
    pl.add_argument("--no-measure", action="store_true", dest="no_measure",
                    help="static search only: enumerate, prune, rank — skip the "
                         "measured validation runs")
    pl.add_argument("--no-mesh-champions", action="store_true", dest="no_mesh_champions",
                    help="measure only the overall top-k (default: also measure the "
                         "predicted-best plan of every surviving mesh factorization)")
    pl.add_argument("--trace", default="poisson",
                    help="traffic kind for the measured serving runs (poisson, bursty, "
                         "diurnal) or a saved trace")
    pl.add_argument("--requests", type=int, default=24,
                    help="requests per measured serving run")
    pl.add_argument("--rate", type=float, default=None,
                    help="mean arrival rate in req/s (default 32)")
    pl.add_argument("--seed", type=int, default=42,
                    help="trace seed (shared by every measured run)")
    pl.add_argument("--prompt-range", type=int, nargs=2, default=None, dest="prompt_range",
                    metavar=("MIN", "MAX"), help="generated traces only: prompt-length bounds")
    pl.add_argument("--output-range", type=int, nargs=2, default=None, dest="output_range",
                    metavar=("MIN", "MAX"), help="generated traces only: output-length bounds")
    pl.add_argument("--slo", type=float, default=30.0,
                    help="TTFT SLO in seconds (--capacity; stamps the trace's deadline_s)")
    pl.add_argument("--user-rate", type=float, default=0.2, dest="user_rate",
                    help="req/s one user issues (--capacity curve)")
    pl.add_argument("--users", type=int, nargs="+", default=(4, 8, 16, 32, 64),
                    help="N-user points on the capacity curve")
    pl.add_argument("--fit-dir", default=None, dest="fit_dir",
                    help="cm2 fitted-coefficient DB directory (default stats/torch/"
                         "analysis/costmodel_fit; a missing fit fails the search closed: "
                         "every point is journaled cm2-fit-missing)")
    pl.add_argument("--tier", default=None,
                    help="cost-model tier (default: cpu-sim with --simulate, else cuda)")
    pl.add_argument("--output", default=None,
                    help="output directory (default results/torch/autotune or "
                         "results/torch/capacity)")
    pl.add_argument("--bench-out", default=None, dest="bench_out",
                    help="also write the bench artifact (BENCH_autotune.json, read by "
                         "`cli reports` from RESULTS/; --auto only)")
    pl.add_argument("--simulate", type=int, default=0, metavar="N",
                    help="N gloo ranks on the CPU (default: the visible GPUs, NCCL)")


def _add_serve_parser(sub) -> None:
    """``serve``: JAX's flags and defaults (``dlbb_tpu/cli.py:303-470``),
    with ``--world`` and ``--device`` for its ``--simulate``."""
    sv = sub.add_parser(
        "serve",
        help="continuous-batching serving benchmark: a synthetic traffic "
             "trace served through the paged-KV-cache inference engine; "
             "reports goodput, TTFT / per-token latency p50/p99/p99.9, "
             "queue depth and cache occupancy")
    sv.add_argument("--config", default=None,
                    help="experiment YAML with model/parallelism/serving sections "
                         "(default: a small GQA model on an auto-planned (dp, tp) mesh)")
    sv.add_argument("--trace", default="poisson",
                    help="arrival process (poisson, bursty, diurnal) or a path to a "
                         "saved trace JSON (replay)")
    sv.add_argument("--requests", type=int, default=100,
                    help="requests to generate (generated traces only)")
    sv.add_argument("--rate", type=float, default=None,
                    help="mean arrival rate in req/s (default 32)")
    sv.add_argument("--seed", type=int, default=42,
                    help="trace seed (arrivals, lengths, embeddings)")
    for flag, kind, hlp in (
        ("--max-batch", int, "decode slots (default 8)"),
        ("--block-size", int, "KV-cache tokens per block (default 16)"),
        ("--max-seq", int, "per-slot prompt+output ceiling (default 256)"),
        ("--queue-capacity", int, "admission-control queue bound (default 64)"),
        ("--decode-horizon", int, "fuse up to K decode steps into one unit "
                                  "(default 1 = per-step)"),
        ("--inflight-window", int, "decode units in flight before the host waits "
                                   "(default 1)"),
        ("--prefill-chunk", int, "chunked prefill: tokens per chunk, a block-size "
                                 "multiple (default: monolithic)"),
        ("--compact-threshold", float, "occupancy fraction (0, 0.5] at or below which "
                                       "fused scans run on a compacted half batch "
                                       "(dp=1 only; default: off)"),
        ("--spec-gamma", int, "draft tokens proposed per verify step"),
        ("--temperature", float, "sampled decode's softmax temperature (needs a "
                                 "drafting speculation mode; default 0 = greedy)"),
        ("--sample-seed", int, "host RNG seed of the sampled path"),
        ("--dispatch-retries", int, "bounded retries of a transiently failed "
                                    "prefill/decode dispatch (default 2)"),
        ("--dispatch-deadline-factor", float, "arm the dispatch watchdog: abandon a "
                                              "decode unit past FACTOR x K x the "
                                              "per-step EMA (default: off)"),
        ("--hedge-factor", float, "fleet hedging: duplicate a request still resident "
                                  "past F x the observed p99 latency onto another "
                                  "replica; first completion wins, the loser is "
                                  "canceled (needs --replicas >= 2)"),
    ):
        dest = ("max_dispatch_retries" if flag == "--dispatch-retries"
                else flag[2:].replace("-", "_"))
        sv.add_argument(flag, type=kind, default=None, dest=dest, help=hlp)
    sv.add_argument("--speculation", default=None,
                    choices=["off", "greedy", "ngram", "draft-model"],
                    help="decode feedback / drafting mode")
    sv.add_argument("--spec-adaptive", action="store_true", default=None,
                    dest="spec_adaptive", help="per-request adaptive γ")
    sv.add_argument("--prefix-caching", action="store_true", default=None,
                    dest="prefix_caching",
                    help="shared-prefix KV reuse (needs --prefill-chunk, dp=1)")
    sv.add_argument("--kv-quantization", default=None, dest="kv_quantization",
                    choices=["none", "int8"], help="KV-cache plane dtype")
    sv.add_argument("--prefix-groups", type=int, default=None, dest="prefix_groups",
                    metavar="G", help="generated traces only: G populations sharing "
                                      "a prompt prefix")
    sv.add_argument("--prefix-len", type=int, default=None, dest="prefix_len",
                    metavar="TOKENS", help="shared-prefix length for --prefix-groups")
    sv.add_argument("--slo", type=float, default=None, metavar="SEC",
                    help="per-request deadline stamped on every generated request: "
                         "queued requests past it are shed, late completions counted")
    sv.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="serve through the replica-level fleet supervisor: N failure "
                         "domains, each its own engine, with health-fencing, failover, "
                         "hedging and the overload degradation ladder; the parallelism "
                         "section (or auto-plan) then describes ONE replica's mesh")
    sv.add_argument("--fault-plan", default=None, metavar="PLAN",
                    help="fault-injection plan of the serving chaos harness (e.g. "
                         "'serve-decode-fail:1'; DLBB_FAULT_PLAN env is the default)")
    sv.add_argument("--resume", action="store_true",
                    help="finish a preempted run from serving_resume.json in --output")
    sv.add_argument("--output", default=None,
                    help="output directory (default results/torch/serving)")
    sv.add_argument("--world", type=int, default=None,
                    help="ranks to launch (default: the config's mesh, else 1)")
    sv.add_argument("--device", default=None, help=_DEVICE_HELP)
    sv.add_argument("--xplane-trace", default=None, metavar="DIR", dest="xplane_trace",
                    help="write a torch.profiler trace of the whole run to DIR (each "
                         "launched rank to DIR/rank<r>; JAX's flag name, the --trace "
                         "flag of the other levels); DLBB_TRACE_DIR env is the default")
    sv.add_argument("--span-trace", default=None, metavar="FILE", dest="span_trace",
                    help="rank 0's host span trace (Chrome trace-event JSON); "
                         "DLBB_SPANS env is the default")
    sv.add_argument("--device-trace", default=None, metavar="DIR", dest="device_trace",
                    help="capture one prefill and one decode scan through the obs/capture "
                         "gate AFTER the trace is served (outside every timed region) "
                         "under DIR; DLBB_DEVICE_TRACE env is the default; parsed by "
                         "`obs devtrace`")


def _sweep(args):
    from dlbb_tpu_torch.bench import runner

    common = dict(
        variant=args.variant, dtype=args.dtype, warmup_iterations=args.warmup,
        measurement_iterations=args.iters, max_config_seconds=args.max_config_seconds,
        max_global_bytes=args.max_global_bytes, resume=args.resume,
        fault_plan=args.fault_plan, unit_deadline_seconds=args.unit_deadline,
        max_retries=args.max_retries, journal=not args.no_journal,
        span_trace=args.span_trace, pipeline=_pipeline_arg(args), prefetch=args.prefetch,
        compile_cache=args.compile_cache, device_trace_dir=args.device_trace)
    if args.ranks:
        common["rank_counts"] = tuple(args.ranks)
    if args.ops:
        common["operations"] = tuple(args.ops)
    if args.cmd == "bench3d":
        for flag, name in (("batch", "batch_sizes"), ("seq", "seq_lengths"),
                           ("hidden", "hidden_dims")):
            if getattr(args, flag):
                common[name] = tuple(getattr(args, flag))
        return runner.Sweep3D(output_dir=args.output or "results/torch/3d", **common)
    if args.sizes == ["extended"]:
        common["data_sizes"] = tuple(runner.EXTENDED_DATA_SIZES_1D.items())
    elif args.sizes:
        table = runner.EXTENDED_DATA_SIZES_1D
        unknown = [s for s in args.sizes if s not in table]
        if unknown:
            raise SystemExit(f"unknown size labels {unknown}; known: {list(table)}")
        common["data_sizes"] = tuple((s, table[s]) for s in args.sizes)
    return runner.Sweep1D(output_dir=args.output or "results/torch/1d", **common)


def _pipeline_arg(args):
    """--no-pipeline > --pipeline > None (host-auto), JAX's."""
    if args.no_pipeline:
        return False
    if args.pipeline:
        return True
    return None


def _traced(trace_dir, device):
    """``maybe_trace`` of this rank's share of ``--trace DIR``."""
    from dlbb_tpu_torch.utils.profiling import maybe_trace, rank_trace_dir

    return maybe_trace(rank_trace_dir(trace_dir), device)


def _span_path(args):
    """``--span-trace``, else ``DLBB_SPANS``: the file rank 0's span trace
    is written to (None: no trace)."""
    from dlbb_tpu_torch.obs import spans

    return args.span_trace or spans.default_span_path()


def _span_tracing(span_trace, cmd):
    """JAX's ``spans.tracing`` around a command (``dlbb_tpu/cli.py:605-625``),
    held by rank 0 alone: the other ranks record nothing."""
    import torch.distributed as dist

    from dlbb_tpu_torch.obs import spans

    lead = not dist.is_initialized() or dist.get_rank() == 0
    return spans.tracing(span_trace if lead else None, meta={"cmd": cmd})


def e2e_worker(config, output_dir, device, trace_dir=None, span_trace=None):
    """One rank of ``e2e`` (launched by name); rank 0 records the span
    trace ``span_trace`` when set."""
    from dlbb_tpu_torch.bench.e2e import run_e2e

    with _span_tracing(span_trace, "e2e"), _traced(trace_dir, device):
        return run_e2e(config, device=device, output_dir=output_dir)


def train_worker(config, output_dir, device, zero1, zero_stage, trace_dir=None,
                 span_trace=None):
    """One rank of ``train`` (launched by name); rank 0 records the span
    trace ``span_trace`` when set."""
    from dlbb_tpu_torch.train.loop import run_train

    with _span_tracing(span_trace, "train"), _traced(trace_dir, device):
        return run_train(config, zero1=zero1, zero_stage=zero_stage, device=device,
                         output_dir=output_dir)


def _launched(args, worker, *extra):
    """``worker`` on ``--world`` ranks (default: the config's mesh size), or
    in this process at world 1; rank 0's result."""
    import math
    import os

    from dlbb_tpu_torch.bench.launch import launch
    from dlbb_tpu_torch.parallel.plan import degrees
    from dlbb_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    if args.tp_overlap is not None:
        config.setdefault("model", {})["tp_overlap"] = args.tp_overlap
    if getattr(args, "grad_compression", None) is not None:
        config.setdefault("training", {})["grad_compression"] = args.grad_compression
    output_dir = args.output or config.get("experiment", {}).get("output_dir")
    world = args.world or math.prod(degrees(config))
    worker_args = (config, output_dir, args.device, *extra)
    if world == 1 and "WORLD_SIZE" not in os.environ:
        return worker(*worker_args)
    return launch(worker, world, args.device, args=worker_args)[0]


def sweep_worker(sweep, device, trace_dir=None):
    """One rank of ``bench1d``/``bench3d`` (launched by name)."""
    from dlbb_tpu_torch.bench.runner import run_sweep

    with _traced(trace_dir, device):
        return run_sweep(sweep, device=device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "analyze":
        from dlbb_tpu_torch.analysis import run_analysis

        # --baselines, --tier and --model are read by part 15b's passes
        return run_analysis(which=args.which, root=args.root, json_path=args.json,
                            strict_warnings=args.strict_warnings, output=args.output,
                            simulate=args.simulate)
    if args.cmd == "obs":
        from dlbb_tpu_torch.obs import run_obs

        return run_obs(args.which, journal=args.journal, output=args.output,
                       strict_warnings=args.strict_warnings, results=args.results,
                       tier=args.tier, fit_dir=args.fit_dir, min_samples=args.min_samples,
                       host_filter=args.host_filter, model=args.model,
                       trace=args.span_trace_file)
    if args.cmd == "chaos":
        from dlbb_tpu_torch.resilience.chaos import run_chaos

        return run_chaos(plan=args.plan, output=args.output, device=args.device,
                         world=args.world)
    if args.cmd == "e2e":
        result = _launched(args, e2e_worker, args.trace, _span_path(args))
        print(f"forward mean {result['forward_time']['mean'] * 1e3:.3f} ms "
              f"over {len(result['per_host_means_s'])} rank(s)")
        return 0
    if args.cmd == "train":
        result = _launched(args, train_worker, args.zero1, args.zero_stage, args.trace,
                           _span_path(args))
        if result.get("preempted") and "step_time" not in result:
            print(f"preempted at step {result['preempted_at_step']}; "
                  "checkpoint saved — resume to continue")
            return 0
        print(f"step mean {result['step_time']['mean'] * 1e3:.3f} ms over "
              f"{len(result['per_host_means_s'])} rank(s)")
        return 0
    if args.cmd in ("bench1d", "bench3d"):
        from dlbb_tpu_torch.bench.launch import launch

        sweep = _sweep(args)
        world = args.world or max(sweep.rank_counts)
        results = launch(sweep_worker, world, args.device,
                         args=(sweep, args.device, args.trace))
        failed = [f for r in results for f in r.failed]
        print(f"{len(results[0].written)} result artifacts in {sweep.output_dir}; "
              f"{len(failed)} failed config(s) over {world} rank(s)")
        for f in failed:
            print(f"  failed: {f['config']}: {f['error']}")
        return 1 if failed else 0
    if args.cmd == "stats1d":
        from dlbb_tpu_torch.stats import process_1d_results

        results = process_1d_results(args.input, args.output,
                                     algorithm_bandwidth=args.algorithm_bandwidth)
        print(f"processed {len(results)} result files")
        return 0
    if args.cmd == "stats3d":
        from dlbb_tpu_torch.stats import process_3d_results

        results = process_3d_results(args.input, args.output, args.impl)
        print(f"processed {len(results)} result files")
        return 0
    if args.cmd == "compare":
        from pathlib import Path

        from dlbb_tpu_torch.stats.compare import write_comparison

        summary = write_comparison(
            Path(args.reference), Path(args.own_1d), Path(args.own_3d), Path(args.output),
            impl=args.impl, own_e2e=Path(args.own_e2e), baseline_json=Path(args.baseline))
        for dim in ("1d", "3d"):
            s = summary[dim]
            print(f"{dim}: {s['configs']} configs — {s['beat']} beat, "
                  f"{s['match']} match, {s['lose']} lose")
        print(f"report written to {args.output}/COMPARISON.md")
        return 0
    if args.cmd == "reports":
        return _reports(args)
    if args.cmd == "serve":
        return _serve(args)
    if args.cmd == "plan":
        return _plan(args)
    return 2


def _plan(args) -> int:
    """``cli plan``: JAX's runs (``dlbb_tpu/cli.py:998-1041``); the device
    count is ``--simulate``'s gloo ranks on the CPU, else the visible GPUs,
    and a tier with no cm2 fit exits 1, the capacity planner's included."""
    from dlbb_tpu_torch.analysis.costmodel import FitMissingError
    from dlbb_tpu_torch.plan.autotune import PRUNE_FIT, run_capacity_plan, run_plan_search

    if args.simulate:
        device, n_dev = "cpu", args.simulate
    else:
        import torch

        from dlbb_tpu_torch.utils.sysinfo import resolve_device

        device = "cuda"
        resolve_device(device)
        n_dev = torch.cuda.device_count()
    tier_name = args.tier or ("cpu-sim" if device == "cpu" else "cuda")
    trace_params = {}
    if args.prompt_range:
        trace_params["prompt_range"] = tuple(args.prompt_range)
    if args.output_range:
        trace_params["output_range"] = tuple(args.output_range)
    if args.capacity:
        try:
            run_capacity_plan(
                n_devices=n_dev, slo=args.slo, users=tuple(args.users),
                user_rate=args.user_rate, trace=args.trace, num_requests=args.requests,
                seed=args.seed, rate=args.rate, trace_params=trace_params or None,
                output_dir=args.output or "results/torch/capacity", tier_name=tier_name,
                fit_dir=args.fit_dir, device=device)
        except FitMissingError as e:
            print(f"plan --capacity: {PRUNE_FIT}: {e}")
            return 1
        return 0
    result = run_plan_search(
        target=args.target, n_devices=n_dev, top_k=args.top_k,
        output_dir=args.output or "results/torch/autotune", trace=args.trace,
        num_requests=args.requests, seed=args.seed, rate=args.rate,
        trace_params=trace_params or None, tier_name=tier_name, fit_dir=args.fit_dir,
        measure=not args.no_measure, mesh_champions=not args.no_mesh_champions,
        device=device, bench_out=args.bench_out)
    return 1 if result.get("error") else 0


_SERVE_OVERRIDES = ("max_batch", "block_size", "max_seq", "queue_capacity",
                    "decode_horizon", "inflight_window", "prefill_chunk",
                    "compact_threshold", "speculation", "spec_gamma", "spec_adaptive",
                    "max_dispatch_retries", "dispatch_deadline_factor", "prefix_caching",
                    "kv_quantization", "temperature", "sample_seed", "hedge_factor")


def _serve(args) -> int:
    """``cli serve``: JAX's run and summary lines (``dlbb_tpu/cli.py:927-995``)."""
    from dlbb_tpu_torch.obs import spans
    from dlbb_tpu_torch.serve.bench import run_serve_from_config

    result = run_serve_from_config(
        args.config, trace=args.trace, num_requests=args.requests, seed=args.seed,
        rate=args.rate, output_dir=args.output,
        overrides={k: getattr(args, k) for k in _SERVE_OVERRIDES},
        resume=args.resume, fault_plan=args.fault_plan, slo=args.slo,
        device_trace=args.device_trace, prefix_groups=args.prefix_groups,
        prefix_len=args.prefix_len, replicas=args.replicas, world=args.world,
        device=args.device, span_trace=args.span_trace or spans.default_span_path(),
        xplane_trace=args.xplane_trace)
    req = result["requests"]
    if "failovers" in result:
        live = sum(1 for r in result["replicas"] if r["status"] == "ok")
        print(f"fleet: {live}/{len(result['replicas'])} replica(s) healthy, "
              f"{result['failovers']['total']} failover(s), "
              f"{result['hedges']['issued']} hedge(s) issued, degrade level "
              f"{result['degrade']['level']} ({result['degrade']['name']})")
    if result.get("prefix", {}).get("enabled"):
        pre = result["prefix"]
        print(f"prefix cache: {pre['hits']} hit(s), {pre['tokens_reused']} token(s) "
              f"reused (hit rate {pre['hit_rate']:.2f})")
    if result.get("preempted"):
        print(f"preempted after {req['completed']} completed request(s); "
              f"{len(result['remaining_rids'])} remain — finish with `serve --resume`")
        return 0
    print(f"goodput {result['goodput_tokens_per_s']:.0f} tok/s over "
          f"{req['completed']} completed / {req['rejected']} rejected request(s)")
    return 0


def _reports(args) -> int:
    """``cli reports``: the JAX CLI's reports, with its summary lines.  The
    serving report reads the port's own ``serving_*.json`` and
    ``fleet_*.json`` under ``RESULTS/serving``, the fleet, fast-path and
    autotuner reports the port's ``RESULTS/BENCH_fleet.json``,
    ``RESULTS/BENCH_serve.json`` and ``RESULTS/BENCH_autotune.json`` (never
    the root ``BENCH_*.json``, which hold the JAX package's TPU runs)."""
    from pathlib import Path

    from dlbb_tpu_torch.stats.northstar import default_stats_1d_csv, write_northstar_report
    from dlbb_tpu_torch.stats.serving_report import (
        write_fastpath_report,
        write_fleet_report,
        write_serving_report,
    )
    from dlbb_tpu_torch.stats.parallelism_report import (
        DEFAULT_FAMILIES,
        write_autotune_report,
        write_cp_scaling_report,
        write_parallelism_report,
    )
    from dlbb_tpu_torch.stats.variants_report import (
        write_variants3d_report,
        write_variants_report,
    )

    stats_root, results_root = Path(args.stats), Path(args.results)
    serve_dir = results_root / "serving"
    produced = 0
    summary = write_variants_report(stats_root / "variants", baseline_impl=args.impl)
    if summary["winners"]:
        produced += 1
        print(f"variants: {len(summary['winners'])} sizes across rank "
              f"counts {sorted(summary.get('ranks', {}))} -> "
              f"{stats_root / 'variants' / 'VARIANTS.md'}")
    else:
        print(f"variants: no stats under {stats_root / 'variants'} — skipped")
    rows3d = write_variants3d_report(stats_root / "variants3d", baseline_impl=args.impl)
    if rows3d:
        produced += 1
        print(f"variants3d: {len(rows3d)} joined configs -> "
              f"{stats_root / 'variants3d' / 'VARIANTS3D.md'}")
    else:
        print(f"variants3d: no stats under {stats_root / 'variants3d'} — skipped")
    # only (re)write the parallelism report when its inputs exist: a typo'd
    # --results must not replace a report with an all-null table
    par_dir = results_root / "parallelism"
    if any(par_dir.glob("train_*.json")):
        rows = write_parallelism_report(par_dir, stats_root / "parallelism",
                                        DEFAULT_FAMILIES)
        measured = [r for r in rows if r["step_time_mean_s"] is not None]
        produced += 1
        print(f"parallelism: {len(measured)} measured members -> "
              f"{stats_root / 'parallelism' / 'PARALLELISM.md'}")
    else:
        print(f"parallelism: no train_*.json under {par_dir} — skipped")
    cp_dir = par_dir / "cp_scaling"
    if any(cp_dir.glob("train_ddp_cp_s*.json")):
        cp_rows = write_cp_scaling_report(cp_dir, stats_root / "parallelism")
        produced += 1
        print(f"cp_scaling: {len(cp_rows)} (S, sp) cells -> "
              f"{stats_root / 'parallelism' / 'CP_SCALING.md'}")
    else:
        print(f"cp_scaling: no train_ddp_cp_s*.json under {cp_dir} — skipped")
    ns_csv = default_stats_1d_csv(stats_root, args.impl)
    ns = write_northstar_report(ns_csv, stats_root / "northstar")
    if ns:
        produced += 1
        print(f"northstar: {sum(ns.values())} size rows across "
              f"{list(ns)} -> {stats_root / 'northstar' / 'NORTHSTAR.md'}")
    else:
        print(f"northstar: no north-star rows in {ns_csv} — skipped")
    serve_rows = write_serving_report(serve_dir, stats_root / "serving")
    if serve_rows:
        produced += 1
        print(f"serving: {len(serve_rows)} run(s) -> "
              f"{stats_root / 'serving' / 'SERVING.md'}")
    else:
        print(f"serving: no serving_*.json under {serve_dir} — skipped")
    bench_fleet = results_root / "BENCH_fleet.json"
    if bench_fleet.exists():
        flrows = write_fleet_report(bench_fleet, stats_root / "serving")
        if flrows:
            produced += 1
            print(f"fleet: {len(flrows)} setting(s) -> "
                  f"{stats_root / 'serving' / 'FLEET.md'}")
    else:
        print(f"fleet: no BENCH_fleet.json under {results_root} — skipped")
    bench_serve = results_root / "BENCH_serve.json"
    if bench_serve.exists():
        frows = write_fastpath_report(bench_serve, stats_root / "serving")
        if frows:
            produced += 1
            print(f"fastpath: {len(frows)} setting(s) -> "
                  f"{stats_root / 'serving' / 'FASTPATH.md'}")
    else:
        print(f"fastpath: no BENCH_serve.json under {results_root} — skipped")
    bench_autotune = results_root / "BENCH_autotune.json"
    if bench_autotune.exists():
        arows = write_autotune_report(bench_autotune, stats_root / "parallelism")
        if arows:
            produced += 1
            print(f"autotune: {len(arows)} measured plan(s) -> "
                  f"{stats_root / 'parallelism' / 'AUTOTUNE.md'}")
    else:
        print(f"autotune: no BENCH_autotune.json under {results_root} — skipped")
    if produced == 0:
        print("error: nothing to report — check --stats/--results point at the "
              "port's trees")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
