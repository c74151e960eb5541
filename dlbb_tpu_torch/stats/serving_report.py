"""Serving-level report (counterpart of ``dlbb_tpu/stats/serving_report.py``):
consolidate ``serving_*.json`` results into ``serving.csv`` and a markdown
table (``SERVING.md``), and fold an existing ``capacity.json`` (the
capacity planner's record) into it, read-only.  Pure file processing, no
device.  The CSV and the table are JAX's byte for byte on the same
reports; the prose names the port's command.  ``write_fleet_report``
writes ``FLEET.md`` from the port's ``BENCH_fleet.json``
(``scripts/torch_bench_fleet.py``), JAX's table but for the script its
prose names.  The capacity curve's publisher and the other reports of the
``BENCH_*.json`` tables come with ROADMAP Queue 1, Slice E, item 12, part
12c.
"""

from __future__ import annotations

import csv
import io
import json
from pathlib import Path
from typing import Any, Optional

from dlbb_tpu_torch.utils.config import atomic_write_text

CSV_COLUMNS = (
    "name", "trace", "requests", "completed", "rejected", "failed",
    "shed_rate", "deadline_shed", "past_deadline",
    "rej_queue_wait_ms", "mesh",
    "max_batch", "block_size", "max_seq",
    "goodput_tok_s", "throughput_tok_s",
    "ttft_p50_ms", "ttft_p99_ms", "ttft_p999_ms",
    "per_token_p50_ms", "per_token_p99_ms", "per_token_p999_ms",
    "peak_queue_depth", "peak_blocks_in_use", "decode_steps",
    "fused_steps", "prefill_chunks", "retries",
    "speculation", "spec_gamma", "acceptance_rate", "mean_accepted_len",
    "draft_overhead_s",
    "kv_quant", "prefix_hit_rate", "prefix_tokens_reused",
    "prefix_cow_blocks",
    "replicas", "failovers", "failover_penalty_ms",
    "hedges_issued", "hedges_won", "degrade_level",
    "wall_seconds",
)


def _ms(summary: dict[str, Any], key: str) -> Optional[float]:
    v = summary.get(key)
    return None if v is None else round(float(v) * 1e3, 3)


def _rejection_stats(req: dict[str, Any]) -> tuple[Optional[float],
                                                   Optional[float]]:
    """(shed_rate, mean queue-head wait at rejection in ms) — the
    admission-tuning signals.  ``rejected_detail`` is absent from
    pre-fast-path reports; both then fall back gracefully (shed rate
    from the counters, wait to None)."""
    arrived = req.get("arrived")
    rejected = req.get("rejected")
    shed = req.get("shed_rate")
    if shed is None and arrived:
        shed = (rejected or 0) / arrived
    detail = req.get("rejected_detail")
    wait_ms = None
    if detail:
        waits = [d["queue_wait_s"] for d in detail
                 if d.get("reason") == "queue-full"
                 and d.get("queue_wait_s") is not None]
        if waits:
            wait_ms = round(sum(waits) / len(waits) * 1e3, 3)
    return (None if shed is None else round(shed, 4)), wait_ms


def serving_row(report: dict[str, Any], name: str) -> dict[str, Any]:
    """One CSV/markdown row from a serving report JSON."""
    req = report.get("requests", {})
    ttft = report.get("ttft", {})
    ptl = report.get("per_token_latency", {})
    cache = report.get("cache", {})
    mesh = report.get("mesh", {})
    series = report.get("timeseries", {})
    serving = report.get("serving", {})
    fast = report.get("fast_path", {})
    spec = report.get("speculation", {})
    pre = report.get("prefix", {})
    shed_rate, rej_wait_ms = _rejection_stats(req)
    acc = spec.get("acceptance_rate")
    mal = spec.get("mean_accepted_len")
    draft_s = spec.get("draft_overhead_s")
    hit_rate = pre.get("hit_rate")
    return {
        "name": name,
        "trace": report.get("trace", {}).get("kind"),
        "requests": report.get("trace", {}).get("num_requests"),
        "completed": req.get("completed"),
        "rejected": req.get("rejected"),
        "failed": req.get("failed"),
        "shed_rate": shed_rate,
        "deadline_shed": req.get("deadline_shed"),
        "past_deadline": req.get("completed_past_deadline"),
        "retries": report.get("resilience", {}).get("retries"),
        "rej_queue_wait_ms": rej_wait_ms,
        "fused_steps": fast.get("fused_steps"),
        "prefill_chunks": fast.get("prefill_chunks"),
        "mesh": "x".join(f"{k}{v}" for k, v in sorted(mesh.items())
                         if isinstance(v, int) and v > 1) or "1",
        "max_batch": serving.get("max_batch"),
        "block_size": serving.get("block_size"),
        "max_seq": serving.get("max_seq"),
        "goodput_tok_s": round(report.get("goodput_tokens_per_s", 0.0), 1),
        "throughput_tok_s": round(
            report.get("throughput_tokens_per_s", 0.0), 1),
        "ttft_p50_ms": _ms(ttft, "median"),
        "ttft_p99_ms": _ms(ttft, "p99"),
        "ttft_p999_ms": _ms(ttft, "p999"),
        "per_token_p50_ms": _ms(ptl, "median"),
        "per_token_p99_ms": _ms(ptl, "p99"),
        "per_token_p999_ms": _ms(ptl, "p999"),
        "peak_queue_depth": max(series.get("queue_depth", [0]) or [0]),
        "peak_blocks_in_use": cache.get("peak_blocks_in_use"),
        "decode_steps": report.get("decode_steps"),
        # speculative decoding (docs/serving.md): absent from
        # pre-speculation reports and "off" runs — all None then
        "speculation": spec.get("mode"),
        "spec_gamma": spec.get("gamma"),
        "acceptance_rate": None if acc is None else round(acc, 4),
        "mean_accepted_len": None if mal is None else round(mal, 3),
        "draft_overhead_s": None if draft_s is None else round(draft_s, 4),
        # shared-prefix cache + quantized KV (docs/serving.md, "Prefix
        # cache & quantized KV"): absent from pre-prefix reports and
        # prefix-off runs — all None then
        "kv_quant": (pre.get("kv_quantization")
                     or serving.get("kv_quantization")),
        "prefix_hit_rate": (None if not pre.get("enabled") or
                            hit_rate is None else round(hit_rate, 4)),
        "prefix_tokens_reused": (pre.get("tokens_reused")
                                 if pre.get("enabled") else None),
        "prefix_cow_blocks": (pre.get("cow_blocks")
                              if pre.get("enabled") else None),
        # fleet-level robustness (docs/fleet.md): absent from
        # single-replica engine reports — all None then
        "replicas": (len(report["replicas"])
                     if report.get("replicas") else None),
        "failovers": report.get("failovers", {}).get("total"),
        "failover_penalty_ms": _ms(report, "failover_ttft_penalty_s"),
        "hedges_issued": report.get("hedges", {}).get("issued"),
        "hedges_won": report.get("hedges", {}).get("won"),
        "degrade_level": report.get("degrade", {}).get("name"),
        "wall_seconds": round(report.get("wall_seconds", 0.0), 3),
    }


def write_serving_report(results_dir: "str | Path",
                         output_dir: "str | Path") -> list[dict[str, Any]]:
    """Consolidate every ``serving_*.json`` under ``results_dir`` into
    ``output_dir``'s ``serving.csv`` + ``SERVING.md``.  Returns the rows
    (empty when there is nothing to report — callers skip, never clobber
    a committed report with an empty table)."""
    results_dir = Path(results_dir)
    rows = []
    paths = sorted(list(results_dir.rglob("serving_*.json"))
                   + list(results_dir.rglob("fleet_*.json")))
    for path in paths:
        if path.name == "serving_manifest.json":
            continue
        try:
            report = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        schema = report.get("schema", "")
        if schema.startswith(("dlbb_serving_report", "dlbb_fleet_report")):
            prefix = ("serving_" if path.name.startswith("serving_")
                      else "fleet_")
            rows.append(serving_row(report, path.stem[len(prefix):]))
    if not rows:
        return rows
    out = Path(output_dir)
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=CSV_COLUMNS)
    writer.writeheader()
    writer.writerows(rows)
    atomic_write_text(buf.getvalue(), out / "serving.csv", newline="")

    lines = [
        "# Serving benchmark report",
        "",
        "Trace-driven continuous-batching runs "
        "(`python -m dlbb_tpu_torch.cli serve`, docs/serving.md).  Goodput is "
        "completed-request output tokens per second; TTFT is "
        "arrival-to-first-token (queueing included); per-token latency "
        "is the decode-step interval each resident request observed.  "
        "Shed rate is queue-full rejections/arrived (infeasible "
        "rejections are a config/trace mismatch and excluded); "
        "\"rej wait\" is the mean time "
        "the queue HEAD had been waiting when an arrival was shed "
        "(high values = the queue bound is doing its job under real "
        "backlog; near-zero = capacity is set too low) — the "
        "admission-tuning signals (`requests.rejected_detail` carries "
        "the per-rejection reason + wait).  \"failed\" counts requests "
        "failed closed by the resilience layer (dispatch failure / "
        "hung dispatch, `docs/resilience.md`); \"late\" counts "
        "requests COMPLETED past their per-request SLO deadline and "
        "\"dl shed\" those shed from the queue because their deadline "
        "had already passed (distinct from queue-full shedding).  "
        "\"spec\" is the speculative-decoding drafter (with γ), "
        "\"acc\" the fraction of drafted tokens the target verify "
        "accepted, \"acc len\" the mean tokens committed per verify "
        "unit (accepted prefix + the verify's own bonus token), and "
        "\"draft s\" the host wall spent dispatching the draft model "
        "(docs/serving.md, \"Speculative decoding\").  \"kv\" is the "
        "KV-cache wire layout (int8 = quantized planes + fp32 scales), "
        "\"pfx hit\" the shared-prefix attach rate (prefix-cache hits / "
        "prefills) and \"pfx tok\" the prompt tokens whose prefill was "
        "skipped by attaching refcounted donor blocks (docs/serving.md, "
        "\"Prefix cache & quantized KV\").  Fleet rows "
        "(`fleet_*.json`, `cli serve --replicas N`, docs/fleet.md) add "
        "\"repl\" (failure domains; the mesh column is then ONE "
        "replica's mesh), \"failover\" (requests re-prefilled off a "
        "fenced replica, with the mean TTFT penalty vs clean requests "
        "in ms), \"hedge\" (duplicates won / issued) and \"degrade\" "
        "(the overload ladder's final level).",
        "",
        "| run | trace | req | done | rej | failed | shed | dl shed | "
        "late | rej wait ms | mesh | "
        "goodput tok/s | "
        "TTFT p50/p99/p99.9 ms | tok p50/p99/p99.9 ms | peak queue | "
        "peak blocks | spec | acc | acc len | draft s | kv | pfx hit | "
        "pfx tok | repl | failover (pen ms) | hedge | degrade |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"
        "---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        shed = ("-" if r["shed_rate"] is None
                else f"{r['shed_rate'] * 100:.0f}%")
        wait = ("-" if r["rej_queue_wait_ms"] is None
                else r["rej_queue_wait_ms"])
        failed = "-" if r["failed"] is None else r["failed"]
        dl_shed = "-" if r["deadline_shed"] is None else r["deadline_shed"]
        late = "-" if r["past_deadline"] is None else r["past_deadline"]
        spec = ("-" if not r["speculation"] or r["speculation"] == "off"
                else (r["speculation"]
                      + (f" γ{r['spec_gamma']}" if r["spec_gamma"] else "")))
        acc = ("-" if r["acceptance_rate"] is None
               else f"{r['acceptance_rate']:.2f}")
        mal = ("-" if r["mean_accepted_len"] is None
               else f"{r['mean_accepted_len']:.2f}")
        draft_s = ("-" if r["draft_overhead_s"] is None
                   else f"{r['draft_overhead_s']:.3f}")
        kv = r["kv_quant"] or "-"
        pfx_hit = ("-" if r["prefix_hit_rate"] is None
                   else f"{r['prefix_hit_rate'] * 100:.0f}%")
        pfx_tok = ("-" if r["prefix_tokens_reused"] is None
                   else r["prefix_tokens_reused"])
        # fleet columns (docs/fleet.md): "-" on single-replica rows
        repl = "-" if r["replicas"] is None else r["replicas"]
        if r["failovers"] is None:
            fo = "-"
        elif r["failover_penalty_ms"] is not None:
            fo = f"{r['failovers']} ({r['failover_penalty_ms']:.1f})"
        else:
            fo = f"{r['failovers']}"
        hedge = ("-" if r["hedges_issued"] is None
                 else f"{r['hedges_won']}/{r['hedges_issued']}")
        degrade = r["degrade_level"] or "-"
        # per-token latency / cache peaks are engine-level; a fleet
        # row's aggregate view doesn't carry them
        ptl = ("-" if r["per_token_p50_ms"] is None else
               f"{r['per_token_p50_ms']}/{r['per_token_p99_ms']}/"
               f"{r['per_token_p999_ms']}")
        peak_blocks = ("-" if r["peak_blocks_in_use"] is None
                       else r["peak_blocks_in_use"])
        lines.append(
            f"| {r['name']} | {r['trace']} | {r['requests']} | "
            f"{r['completed']} | {r['rejected']} | {failed} | {shed} | "
            f"{dl_shed} | {late} | {wait} | "
            f"{r['mesh']} | "
            f"{r['goodput_tok_s']} | "
            f"{r['ttft_p50_ms']}/{r['ttft_p99_ms']}/{r['ttft_p999_ms']} | "
            f"{ptl} | "
            f"{r['peak_queue_depth']} | {peak_blocks} | "
            f"{spec} | {acc} | {mal} | {draft_s} | {kv} | {pfx_hit} | "
            f"{pfx_tok} | {repl} | {fo} | {hedge} | {degrade} |"
        )
    lines.append("")
    # the capacity planner's durable record lives next to the report —
    # regenerating SERVING.md from serving_*.json must not drop the
    # published capacity curve (docs/autotune.md)
    cap_path = out / "capacity.json"
    if cap_path.exists():
        try:
            cap = json.loads(cap_path.read_text())
        except (OSError, json.JSONDecodeError):
            cap = None
        if cap:
            lines.extend(_capacity_lines(cap))
    atomic_write_text("\n".join(lines), out / "SERVING.md")
    return rows


def _capacity_lines(report: dict[str, Any]) -> list[str]:
    """Markdown section for one capacity-planner report
    (``dlbb_capacity_v1``, ``cli plan --capacity``)."""
    trace = report.get("trace", {})
    lines = [
        "## Fleet capacity curve",
        "",
        f"cm2-predicted vs measured per-replica serving capacity "
        f"(`cli plan --capacity`, docs/autotune.md).  SLO = TTFT within "
        f"{report.get('slo_s', '?')} s (the trace's `deadline_s`); one "
        f"**measured** run per plotted plan on the seeded "
        f"{trace.get('kind', '?')} trace "
        f"(n={trace.get('num_requests', '?')}, "
        f"seed={trace.get('seed', '?')}); a user issues "
        f"{report.get('user_rate_req_per_s', '?')} req/s of "
        f"~{report.get('mean_output_tokens', '?')} output tokens.  "
        f"Replica scaling is linear extrapolation (independent engines "
        f"behind round-robin admission) anchored at the measured "
        f"single-replica numbers.",
        "",
        "| plan | pred tok/s | meas tok/s | pred TTFT ms | "
        "meas TTFT p50 ms | done | SLO ok |",
        "|---|---|---|---|---|---|---|",
    ]
    for p in report.get("plans", []):
        lines.append(
            f"| {p['plan']} | "
            f"{p['predicted_goodput_tokens_per_s']:.0f} | "
            f"{p['measured_goodput_tokens_per_s']:.0f} | "
            f"{p['predicted_ttft_s'] * 1e3:.1f} | "
            f"{p['measured_ttft_p50_s'] * 1e3:.1f} | "
            f"{p['completed']}/{p['total']} | "
            f"{'yes' if p['slo_attainable'] else 'NO'} |"
        )
    users = [c["users"] for c in
             (report.get("plans") or [{}])[0].get("curve", [])]
    if users:
        lines += [
            "",
            "Replicas needed to serve N users within SLO "
            "(predicted / measured; `—` = the plan's TTFT blows the "
            "SLO at any replica count):",
            "",
            "| plan | " + " | ".join(f"N={n}" for n in users) + " |",
            "|---|" + "---|" * len(users),
        ]
        for p in report.get("plans", []):
            cells = []
            for c in p.get("curve", []):
                rp = c.get("replicas_predicted")
                rm = c.get("replicas_measured")
                cells.append(f"{rp if rp is not None else '—'} / "
                             f"{rm if rm is not None else '—'}")
            lines.append(f"| {p['plan']} | " + " | ".join(cells) + " |")
    lines.append("")
    return lines


def write_fleet_report(bench_path: "str | Path",
                       output_dir: "str | Path") -> list[dict[str, Any]]:
    """The fleet fault-tolerance table: consolidate ``BENCH_fleet.json``
    (``scripts/torch_bench_fleet.py``: single-engine oracle vs clean
    2-replica fleet vs replica-killed fleet over the same seeded trace) into
    ``FLEET.md``.  Returns the rows (empty when the bench artifact is
    missing/unreadable: callers skip, never clobber)."""
    bench_path = Path(bench_path)
    try:
        bench = json.loads(bench_path.read_text())
    except (OSError, json.JSONDecodeError):
        return []
    settings = bench.get("settings", {})
    if not settings:
        return []
    rows = []
    for name, s in settings.items():
        tps = s.get("goodput_tokens_per_s", {})
        fo = s.get("failovers", {})
        rows.append({
            "setting": name,
            "goodput_median": tps.get("median"),
            "goodput_min": tps.get("min"),
            "goodput_max": tps.get("max"),
            "ttft_p50_ms": s.get("ttft_p50_ms"),
            "ttft_p99_ms": s.get("ttft_p99_ms"),
            "failovers": fo.get("median"),
            "token_identical": s.get("token_identical"),
        })
    failover = bench.get("failover", {})
    pen = failover.get("ttft_penalty_ms", {})
    fleet = bench.get("fleet", {})
    trace = bench.get("trace", {})
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    lines = [
        "# Replica-level fault tolerance: the cost of a failover",
        "",
        f"Source: `{bench_path.name}` "
        "(`scripts/torch_bench_fleet.py` — the SAME seeded "
        f"{trace.get('kind', '?')} trace "
        f"(n={trace.get('requests', '?')}, seed={trace.get('seed', '?')}) "
        "through a single replica-sized engine (the token oracle), a "
        f"clean {fleet.get('replicas', '?')}-replica fleet, and the same "
        "fleet with `serve-replica-kill` fired mid-trace; settings "
        "interleaved within each repetition, medians with min/max "
        "spread; docs/fleet.md).  Every fleet run — clean AND killed — "
        "is gated token-identical to the oracle before publishing, so "
        "the penalty prices recovery of the SAME answer, not a "
        "different one.  The TTFT penalty is failed-over minus clean "
        "requests WITHIN the kill run (queueing drift between runs "
        "cancels).",
        "",
        "| setting | goodput tok/s (min..max) | TTFT p50 ms | "
        "TTFT p99 ms | failovers | identical |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        tps = ("-" if r["goodput_median"] is None else
               f"{r['goodput_median']:.0f} "
               f"({r['goodput_min']:.0f}..{r['goodput_max']:.0f})")
        fo = "-" if r["failovers"] is None else r["failovers"]
        ident = ("-" if r["token_identical"] is None
                 else ("yes" if r["token_identical"] else "NO"))
        lines.append(
            f"| {r['setting']} | {tps} | {r['ttft_p50_ms']} | "
            f"{r['ttft_p99_ms']} | {fo} | {ident} |"
        )
    if pen:
        lines += [
            "",
            f"**Failover TTFT penalty: {pen.get('median', '?')} ms** "
            f"({pen.get('min', '?')}..{pen.get('max', '?')} across "
            f"reps), {failover.get('failovers_per_run', {}).get('median', '?')} "
            "failover(s) per kill run; goodput retained "
            f"**{failover.get('goodput_retained_vs_clean_fleet', '?')}x** "
            "vs the unfaulted fleet.",
        ]
    lines.append("")
    atomic_write_text("\n".join(lines), out / "FLEET.md")
    return rows
