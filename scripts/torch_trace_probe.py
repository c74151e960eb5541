#!/usr/bin/env python3
"""Which device events ``torch.profiler`` (CUPTI) records on this card.

    python3 scripts/torch_trace_probe.py [--sessions N] [--rounds N] [--out DIR]

Captures, each in its own ``obs/capture.py`` session on the card: a tensor
copy (``clone``: a device-to-device memcpy), a fill (``zero_``), an
elementwise kernel (``x + 1``), a GEMM, and then, in a one-rank NCCL
process group, each 1D sweep op at 16MB as the sweep calls it.  Prints, per
capture, the events by Kineto category, the device events that
``obs/devtrace.py`` keeps, the census of its device records
(``device_records``: found, excluded, launches of the work that left
none; the session's own guard launches are among the excluded) and the
median time from each record's launch (its ``cuda_runtime`` call, by
correlation id) to its start on the device's timeline, with the card's
name and power limit.  Then it runs ``chip_smoke.py`` phase comm's 3D
sweeps (up to 1 GiB per rank) and, after them:

- ``--sessions`` sessions opened straight on ``torch.profiler`` for each
  of ``FIRST_LAUNCH_CASES`` (no guard, holds of 2 s, launches of the
  session's own before and after the work) around 20 one-kernel launches
  2 ms apart: the positions of the work's launches that left no record;
- ``--rounds`` rounds through the port's capture: a whole 1D sweep, a
  device-traced 1D sweep of four ops at 16MB and three one-kernel
  captures, with the captures that kept no device event, the sessions
  taken again (``obs/capture.py::CAPTURE_ATTEMPTS``), the records
  found, excluded and absent, those that a record's own timestamp would
  have placed outside its rep's window, and the launch-to-start spread.

Exits 1 without CUDA.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import sys
import tempfile
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _trace(meta):
    return json.loads(gzip.decompress(Path(meta["perfetto_trace"]).read_bytes()))["traceEvents"]


def _lags(events):
    """Start on the device's timeline minus its launch call's start on the
    host, in us, of every device record whose launch the trace holds."""
    launches = {e["args"].get("correlation"): e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and isinstance(e.get("args"), dict)}
    return [e["ts"] - launches[c] for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and (c := (e.get("args") or {}).get("correlation")) in launches]


def _own_time_outside(events):
    """The device records whose launch lies inside a ``profile_rep:``
    window but whose own midpoint lies outside every one: those that
    placing a record by its own timestamp, not its launch, would drop."""
    from dlbb_tpu_torch.obs.devtrace import _launches

    wins = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X"
            and str((e.get("args") or {}).get("long_name") or e.get("name", ""))
            .startswith("profile_rep:")]
    launches = _launches(events)

    def inside(ts, dur):
        return any(lo <= ts + dur / 2 <= hi for lo, hi in wins)

    return sum(1 for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and (launch := launches.get((e.get("args") or {}).get("correlation")))
               and inside(launch["ts"], launch["dur"]) and not inside(e["ts"], e["dur"]))


def _summary(meta):
    from dlbb_tpu_torch.obs.devtrace import CaptureError, analyze_capture, parse_capture

    events = _trace(meta)
    cats = Counter(e.get("cat") for e in events if e.get("ph") == "X")
    lags = sorted(_lags(events))
    lag = f"{lags[len(lags) // 2]:.1f} us" if lags else "-"
    try:
        a = analyze_capture(parse_capture(meta["perfetto_trace"]))
        kept = ", ".join(f"{r['name'][:50]} [{r['bucket']}] x{r['count']}" for r in a["per_op"])
    except CaptureError as e:
        kept = f"none ({str(e).split(': ', 1)[1][:60]})"
    return (f"categories {dict(cats)}; device events kept: {kept}; records "
            f"{meta.get('device_records')}; launch to device start (median) {lag}")


class _Tally:
    """Of a set of captures: how many failed or were taken again, and their
    device records' census, summed."""

    def __init__(self):
        self.n = self.failed = self.total = self.excluded = self.absent = self.own = 0
        self.retaken = 0
        self.lags: list[float] = []

    def add(self, meta):
        self.n += 1
        self.failed += "error" in meta
        self.retaken += meta.get("attempts", 1) - 1
        rec = meta.get("device_records") or {}
        self.total += rec.get("total", 0)
        self.excluded += rec.get("excluded", 0)
        self.absent += rec.get("launches_without_record", 0)
        if meta.get("perfetto_trace"):
            events = _trace(meta)
            self.own += _own_time_outside(events)
            self.lags += _lags(events)

    def line(self):
        lags = sorted(self.lags)
        spread = (f"{lags[0]:.1f} / {lags[len(lags) // 2]:.1f} / {lags[-1]:.1f} us"
                  if lags else "-")
        return (f"{self.failed} of {self.n} captures kept no device event, "
                f"{self.retaken} sessions taken again; device records "
                f"{self.total}, excluded {self.excluded} (by their own time: {self.own}), "
                f"launches that left no record {self.absent}; launch to device start "
                f"(min / median / max) {spread}")


SHAPES_3D = ((1, 2048, 2048), (8, 4096, 4096), (16, 8192, 4096))
TRACED_OPS = ("allreduce", "allgather", "alltoall", "sendrecv")


def _big_sweeps(torch, tmp):
    """The 3D sweeps of ``chip_smoke.py`` phase comm, up to 1 GiB per rank."""
    from dlbb_tpu_torch.bench import runner

    for b, s, h in SHAPES_3D:
        runner.run_sweep(runner.Sweep3D(
            batch_sizes=(b,), seq_lengths=(s,), hidden_dims=(h,), rank_counts=(1,),
            warmup_iterations=10, measurement_iterations=100,
            output_dir=os.path.join(tmp, "3d")), device="cuda", verbose=False)
        torch.cuda.empty_cache()


def _lost_launches(path):
    """The positions, in launch order, of the launches whose record the
    trace at ``path`` lacks, and the number of launches."""
    from dlbb_tpu_torch.obs.devtrace import _launches, load_trace_events

    events = load_trace_events(path)
    launches = sorted(_launches(events).items(), key=lambda kv: float(kv[1]["ts"]))
    recorded = {(e.get("args") or {}).get("correlation") for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    return [i for i, (c, _) in enumerate(launches) if c not in recorded], len(launches)


# the sessions of the first-launch study: (name, launches before the work,
# seconds held before and after it, launches after it)
FIRST_LAUNCH_CASES = (
    ("no guard", 0, 0.0, 0),
    ("held 2 s", 0, 2.0, 0),
    ("1 launch before", 1, 0.0, 0),
    ("5 launches before and 5 after", 5, 0.0, 5),
)


def _first_launch_session(torch, tmp, case, i, x):
    """One session of ``case`` (``FIRST_LAUNCH_CASES``): the positions of
    the work's launches that left no record."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from dlbb_tpu_torch.utils.profiling import annotate

    name, before, hold, after = case
    path = Path(tmp) / "first_launch" / f"{name.split(' (')[0].replace(' ', '_')}_{i}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(before):
            x.fill_(0)
        torch.cuda.synchronize()
        time.sleep(hold)
        with annotate("profile_rep:first_launch"):
            for _ in range(20):
                x.add_(1)
                # comm-lint: disable=host-transfer-in-loop  the probe syncs after each launch on purpose
                torch.cuda.synchronize()
                time.sleep(0.002)
        time.sleep(hold)
        for _ in range(after):
            x.fill_(0)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    missing, n = _lost_launches(path)
    if n != before + 20 + after:
        raise RuntimeError(f"the trace holds {n} launches, not {before + 20 + after}")
    return [j - before for j in missing if before <= j < before + 20]


def _first_launch_study(torch, tmp, sessions):
    """Sessions opened straight on ``torch.profiler`` (not through
    ``profile_session``) over 20 one-kernel launches 2 ms apart, for each
    of ``FIRST_LAUNCH_CASES``: which launches of the work left no record,
    by position in launch order."""
    x = torch.randn(1 << 20, device="cuda")
    for case in FIRST_LAUNCH_CASES:
        lost: list = []
        for i in range(sessions):
            try:
                lost.append(_first_launch_session(torch, tmp, case, i, x))
            except Exception as e:  # noqa: BLE001 — report the case and go on
                lost.append(f"{type(e).__name__}: {e}"[:120])
        print(f"[probe] first launch, after the 3D sweeps, {case[0]}: launches of the work "
              f"without a record, by position of 20, per session: {lost}")


def _capture_study(torch, tmp, rounds):
    """Through the port's own capture (``obs/capture.py``): ``rounds``
    rounds of a whole 1D sweep at world 1, a device-traced 1D sweep of
    ``TRACED_OPS`` at 16MB (one profile rep each) and three one-kernel
    captures."""
    from dlbb_tpu_torch.bench import runner
    from dlbb_tpu_torch.obs.capture import capture_device_trace

    x = torch.randn(1 << 20, device="cuda")
    ops = runner.OPERATIONS_1D + ("reducescatter",)
    sweeps, kernels = _Tally(), _Tally()
    for i in range(rounds):
        runner.run_sweep(runner.Sweep1D(
            operations=ops, rank_counts=(1,), warmup_iterations=10,
            measurement_iterations=100, output_dir=os.path.join(tmp, f"s{i}")),
            device="cuda", verbose=False)
        traced = runner.run_sweep(runner.Sweep1D(
            operations=TRACED_OPS, data_sizes=(("16MB", runner.DATA_SIZES_1D["16MB"]),),
            rank_counts=(1,), warmup_iterations=10, measurement_iterations=100,
            output_dir=os.path.join(tmp, f"t{i}"), device_trace_dir=os.path.join(tmp, f"d{i}"),
            pipeline=True), device="cuda", verbose=False)
        for path in traced.written:
            sweeps.add(json.loads(Path(path).read_text())["device_trace"])
        for _ in range(3):
            kernels.add(capture_device_trace(lambda _: x + 1, lambda: None, tmp, "one_kernel",
                                             device="cuda"))
    print(f"[probe] capture, after the 3D sweeps, {rounds} rounds: traced 1D sweeps: "
          f"{sweeps.line()}")
    print(f"[probe] capture, after the 3D sweeps, {rounds} rounds: one-kernel captures: "
          f"{kernels.line()}")


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--sessions", type=int, default=3)
    parser.add_argument("--out", default=None,
                        help="keep the traces and sweep results here (default: a temporary "
                             "directory)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_probe: no CUDA device", file=sys.stderr)
        return 1
    from dlbb_tpu_torch import comm
    from dlbb_tpu_torch.bench.runner import DATA_SIZES_1D, OPERATIONS_1D
    from dlbb_tpu_torch.obs.capture import capture_device_trace
    from dlbb_tpu_torch.utils.sysinfo import gpu_name_and_power_limit

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{gpu_name_and_power_limit()}")
    x = torch.randn(4 << 20, device="cuda")
    a = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16)
    with (contextlib.nullcontext(args.out) if args.out
          else tempfile.TemporaryDirectory()) as tmp:
        os.makedirs(tmp, exist_ok=True)
        for label, fn in (("clone", lambda _: x.clone()), ("zero_", lambda _: x.clone().zero_()),
                          ("add", lambda _: x + 1), ("gemm", lambda _: a @ a)):
            meta = capture_device_trace(fn, lambda: None, tmp, label, device="cuda")
            print(f"[probe] {label}: {meta.get('error', 'ok')[:60]}; {_summary(meta)}")
        comm.initialize_distributed("nccl", 0, 1, os.path.join(tmp, "store"))
        try:
            mesh = comm.get_mesh(comm.MeshSpec.ring(1))
            n = DATA_SIZES_1D["16MB"]
            for name in OPERATIONS_1D + ("reducescatter",):
                op = comm.get_op(name)
                fn = op.build(mesh)
                payload = comm.make_payload(op, 0, 1, n, device="cuda")
                meta = capture_device_trace(fn, lambda: payload, tmp, f"nccl_{name}",
                                            device="cuda")
                print(f"[probe] NCCL world 1 {name}: {meta.get('error', 'ok')[:60]}; "
                      f"{_summary(meta)}")
            meta = capture_device_trace(lambda _: x + 1, lambda: None, tmp, "add_after_nccl",
                                        device="cuda")
            print(f"[probe] add after NCCL init: {_summary(meta)}")
            _big_sweeps(torch, tmp)
            _first_launch_study(torch, tmp, args.sessions)
            _capture_study(torch, tmp, args.rounds)
        finally:
            comm.destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
