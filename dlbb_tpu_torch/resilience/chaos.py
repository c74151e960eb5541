"""Chaos gate: mini-sweeps, a checkpoint and mini serving runs under each
fault class, asserting the resilience invariants (``python -m
dlbb_tpu_torch.cli chaos``; counterpart of ``dlbb_tpu/resilience/chaos.py``,
with its names, messages and invariants).

Each class activates a deterministic fault plan (``resilience/inject.py``),
drives the real execution path (the sweep runner with its compile-ahead
engine, the checkpointer, the serving harness, the fleet) and asserts:

- **no corrupt artifact survives** where resume or the stats pipeline
  would trust it: every surviving result JSON passes
  ``resilience/validate.py::validate_result_json``;
- **transients recover**: retried configs complete with ``retries >= 1``
  and finite stats;
- **permanent faults fail closed**: the config lands in
  ``sweep_manifest.json`` as quarantined with its exception chain, and the
  journal records ``failed``;
- **resume completes the grid exactly**: after a torn write, a SIGTERM or
  a SIGKILL mid-write, a resumed run produces the artifact set of an
  uninterrupted run of the same grid (file names, schema keys, finite
  stats);
- the serving matrix (``serve``) and the replica matrix (``fleet``) as in
  JAX: retries with rollback, fail-closed requests with their chains, the
  watchdog, deadlines, the drain and resume; failover with the unfaulted
  single replica's greedy tokens, torn failover, heartbeat fencing,
  hedging, prefix affinity.

**Where the classes run.**  JAX runs one process on a simulated mesh; the
port runs one process per rank.  On the CPU the gate keeps JAX's layouts
on gloo ranks: the mini-grid on ``world`` ranks (default 4), the serve
class at dp=2 x tp=4 (its prefix case dp=1 x tp=4), the fleet at 2
replicas of dp=2 x tp=2 (its prefix case 2 of dp=1 x tp=4).  On a card one
NCCL rank holds one GPU, so there the mini-grid runs at world 1, the serve
class in this process, and the fleet's replicas as one-rank processes
sharing the card.  The six sweep classes run together: every rank runs
each class's sweeps and the same checks on the same files and on rank 0's
lists (the gate's process itself at world 1, one launch of ``world`` ranks
otherwise).  The ``kill`` class SIGKILLs rank 0 of a launched child sweep
(the ``kill-mid-write`` site fires between the temporary write and the
rename), because a SIGKILL of this process would take the gate down.  The
serve and fleet runs take one launch each (two for serve on the CPU,
whose prefix case has its own mesh) and return their reports, which the
gate then checks in JAX's order; the serve and fleet references are
shared by their scenarios, as in JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Optional

from dlbb_tpu_torch.resilience.journal import read_journal
from dlbb_tpu_torch.resilience.validate import validate_result_json

# Mini-grid shared by every sweep class: 2 ops x 1 size on the world's
# ranks, two configs, two work units, seconds per class (JAX's).
_MINI = dict(
    implementation="chaos",
    operations=("allreduce", "broadcast"),
    data_sizes=(("1KB", 256),),
    rank_counts=(4,),
    dtype="float32",
    warmup_iterations=1,
    measurement_iterations=3,
    compile_cache="off",
    pipeline=True,
)


def _grid_files(world: int) -> list[str]:
    return sorted(f"chaos_{op}_ranks{world}_1KB_fp32.json" for op in _MINI["operations"])


_GRID_FILES = _grid_files(4)

# the serving classes' model (JAX's, ``chaos.py:329-331``)
_SERVE_MODEL = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
                    ffn_intermediate=128, dtype="float32", attention="full")
# the exec-hang class's watchdog (JAX's 1 s), and on gloo ranks the floor
# their collectives need on a loaded host (the serving tests' 5 s)
_HANG_DEADLINE_S = {True: 5.0, False: 1.0}
# the serve class's dispatch watchdog: JAX's at one rank, and on gloo
# ranks the serving tests' (``WATCHDOG_RANKS``)
_SERVE_WATCHDOG = {False: dict(dispatch_deadline_factor=50.0, dispatch_deadline_min_s=0.5),
                   True: dict(dispatch_deadline_factor=1000.0, dispatch_deadline_min_s=5.0)}
# the launches' bound on the whole run and on each collective's wait
_LAUNCH_TIMEOUT_S, _GROUP_TIMEOUT_S = 600.0, 300.0


class ChaosFailure(AssertionError):
    """An invariant did not hold under an injected fault."""


@dataclass(frozen=True)
class _Gate:
    """Where the gate runs: the device and the mini-grid's world.  At
    world 1 every serving layout is one rank; above it, JAX's."""

    device: str
    world: int

    @property
    def grid_files(self) -> list[str]:
        return _grid_files(self.world)

    @property
    def jax_layouts(self) -> bool:
        """JAX's multi-rank serving layouts (above world 1)."""
        return self.world > 1

    def layout(self, dp: int, tp: int) -> dict[str, int]:
        """A serving mesh's ``parallelism:`` section (JAX's ``world_size``
        is tp)."""
        if not self.jax_layouts:
            dp = tp = 1
        return {"data_parallel": dp, "world_size": tp}

    def mini(self, **kw) -> dict[str, Any]:
        cfg = dict(_MINI, rank_counts=(self.world,))
        cfg.update(kw)
        return cfg


def _rank0(value):
    """Rank 0's ``value`` on every rank of the world (itself without one)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _sweep(out_dir: str, gate: _Gate, **kw) -> list[Path]:
    """One mini-sweep on every rank of the world; rank 0's written files
    (every rank returns them, after rank 0's manifest is on disk)."""
    from dlbb_tpu_torch.bench.runner import Sweep1D, run_sweep

    res = run_sweep(Sweep1D(output_dir=out_dir, **gate.mini(**kw)), device=gate.device,
                    verbose=False)
    return [Path(p) for p in _rank0([str(p) for p in res.written])]


def _manifest(out_dir: str) -> dict:
    with open(Path(out_dir) / "sweep_manifest.json") as f:
        return json.load(f)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ChaosFailure(msg)


def _assert_all_valid(paths) -> None:
    for p in paths:
        ok, why = validate_result_json(p)
        _check(ok, f"corrupt artifact survived: {p} ({why})")


def _assert_grid_equivalent(out_dir: str, reference_dir: str) -> None:
    """Same artifact set as an uninterrupted run: same filenames, same
    schema keys, finite stats (values differ: they are measurements)."""
    got = sorted(p.name for p in Path(out_dir).glob("chaos_*.json"))
    ref = sorted(p.name for p in Path(reference_dir).glob("chaos_*.json"))
    _check(got == ref, f"artifact sets differ: {got} != {ref}")
    for name in got:
        a = json.loads((Path(out_dir) / name).read_text())
        b = json.loads((Path(reference_dir) / name).read_text())
        _check(sorted(a) == sorted(b),
               f"{name}: schema keys differ after recovery")
        ok, why = validate_result_json(Path(out_dir) / name)
        _check(ok, f"{name}: invalid after recovery ({why})")


# ---------------------------------------------------------------------------
# the sweep classes (run on every rank of the world)
# ---------------------------------------------------------------------------


def _class_compile(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    out = str(work / "compile")
    files = _sweep(out, gate, fault_plan="compile-fail:@1", max_retries=0)
    man = _manifest(out)
    _check(man["configs"]["failed"] == 1,
           f"compile failure not quarantined: {man['configs']}")
    q = man["resilience"]["quarantined"]
    _check(len(q) == 1 and "InjectedFault" in q[0]["error"]
           and q[0]["traceback"],
           "quarantine record lacks the exception chain")
    _check(len(files) == len(gate.grid_files) - 1,
           "surviving configs did not all measure")
    _assert_all_valid(files)
    ev, _ = read_journal(out)
    _check(any(e["event"] == "failed" for e in ev),
           "journal has no failed record for the poisoned config")
    log("compile-fail: quarantined with exception chain; grid drained")


def _class_transient(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    out = str(work / "transient")
    files = _sweep(out, gate, fault_plan="exec-transient:1", max_retries=2)
    _check(len(files) == len(gate.grid_files),
           "transient fault was not retried to completion")
    _assert_all_valid(files)
    retries = [json.loads(Path(p).read_text())["retries"] for p in files]
    _check(sum(retries) == 1,
           f"expected exactly one retried config, got retries={retries}")
    _check(_manifest(out)["resilience"]["retries_total"] == 1,
           "manifest retries_total wrong")
    log("transient: retried with backoff, artifact flags retries=1")


def _class_nan(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    out = str(work / "nan")
    files = _sweep(out, gate, fault_plan="stats-nan:1", max_retries=2)
    _check(len(files) == len(gate.grid_files),
           "NaN-corrupted config did not re-measure")
    _assert_all_valid(files)  # finite medians everywhere
    retries = [json.loads(Path(p).read_text())["retries"] for p in files]
    _check(sum(retries) >= 1, "NaN corruption was not detected pre-write")
    log("stats-nan: corrupt stats never written; re-measured from scratch")


def _class_torn(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    out = str(work / "torn")
    _sweep(out, gate, fault_plan="torn-write:@1", max_retries=0)
    man = _manifest(out)
    _check(man["configs"]["failed"] == 1, "torn write not failed closed")
    torn = [p for p in sorted(Path(out).glob("chaos_*.json"))
            if not validate_result_json(p)[0]]
    _check(len(torn) == 1, "expected exactly one torn artifact on disk")
    # resume must re-validate, refuse the torn file, and re-measure it
    files = _sweep(out, gate, resume=True)
    _check(len(files) == len(gate.grid_files), "resume did not complete grid")
    _assert_all_valid(files)
    ev, _ = read_journal(out)
    _check(any(e["event"] == "resume-invalid" for e in ev),
           "journal has no resume-invalid record for the torn artifact")
    log("torn-write: resume re-validated, re-measured; no corrupt artifact "
        "trusted")


def _class_hang(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    # 120 s hang vs a 60 s wall budget: wide enough that a loaded host's
    # own build+measure time can never trip the assertion, narrow enough
    # that blocking behind the hang always does
    out = str(work / "hang")
    deadline = _HANG_DEADLINE_S[gate.jax_layouts]
    t0 = time.perf_counter()
    files = _sweep(out, gate, fault_plan="exec-hang:@1,hang_seconds=120",
                   unit_deadline_seconds=deadline, max_retries=0)
    wall = _rank0(time.perf_counter() - t0)
    man = _manifest(out)
    _check(man["resilience"]["watchdog"]["abandoned_measurements"] == 1,
           "watchdog did not abandon the hung measurement")
    _check(man["configs"]["failed"] == 1, "hung unit not quarantined")
    _check(len(files) == len(gate.grid_files) - 1,
           "pipeline did not drain past the hung unit")
    _check(wall < 60.0,
           f"sweep blocked behind the hang ({wall:.1f}s vs 120s sleep)")
    _assert_all_valid(files)
    log(f"exec-hang: abandoned at the {deadline:.0f} s deadline, drained in {wall:.1f}s "
        "(hang was 120s)")


def _class_preempt(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    out = str(work / "preempt")
    clean = str(work / "preempt_reference")
    _sweep(clean, gate)
    files = _sweep(out, gate, fault_plan="preempt:@2")
    man = _manifest(out)
    _check(man["resilience"]["preempted"], "SIGTERM did not journal a stop")
    _check(len(files) == 1, "preemption should stop before config 2")
    ev, _ = read_journal(out)
    _check(any(e["event"] == "preempted" for e in ev),
           "journal has no preempted record")
    files = _sweep(out, gate, resume=True)
    _check(len(files) == len(gate.grid_files),
           "resume after preemption did not complete the grid")
    _assert_grid_equivalent(out, clean)
    log("preempt: SIGTERM -> journaled stop; resume completed the grid "
        "equivalently")


def _rank_classes(names: list[str], work: str, gate: _Gate) -> dict[str, tuple]:
    """The sweep classes ``names`` on this rank, in order: each class's
    ``(status, message, seconds, log lines)``.  Every rank reaches the same
    verdict: the checks read rank 0's files and rank 0's lists."""
    out = {}
    for name in names:
        lines: list[str] = []
        t0 = time.perf_counter()
        try:
            CHAOS_CLASSES[name](Path(work), lines.append, gate)
        except ChaosFailure as e:
            out[name] = ("FAIL", str(e), time.perf_counter() - t0, lines)
        except Exception as e:  # noqa: BLE001 — the gate reports, never dies
            out[name] = ("ERROR", f"{type(e).__name__}: {e}", time.perf_counter() - t0,
                         lines)
        else:
            out[name] = ("ok", "", time.perf_counter() - t0, lines)
    return out


@contextlib.contextmanager
def _world_group(gate: _Gate):
    """A one-rank process group of the device's backend around the block,
    unless one is open already (a caller's)."""
    import torch
    import torch.distributed as dist

    from dlbb_tpu_torch.comm.mesh import BACKENDS, destroy_distributed, initialize_distributed

    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError(f"the gate runs world 1 in this process; its process group "
                               f"has {dist.get_world_size()} ranks")
        yield
        return
    if gate.device == "cuda":
        torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="dlbb_chaos_group_") as tmp:
        initialize_distributed(BACKENDS[gate.device], 0, 1, os.path.join(tmp, "store"))
        try:
            yield
        finally:
            destroy_distributed()


def _on_world(fn: Callable, gate: _Gate, args: tuple, world: Optional[int] = None,
              group: bool = False):
    """``fn(*args)`` on ``world`` ranks (the gate's by default), rank 0's
    result: in this process at world 1 (inside a one-rank group when
    ``group``), else launched."""
    from dlbb_tpu_torch.bench.launch import launch

    world = gate.world if world is None else world
    if world == 1:
        with _world_group(gate) if group else contextlib.nullcontext():
            return fn(*args)
    return launch(fn, world, gate.device, args=args, timeout=_LAUNCH_TIMEOUT_S,
                  group_timeout=_GROUP_TIMEOUT_S)[0]


# ---------------------------------------------------------------------------
# the classes of the gate's own process
# ---------------------------------------------------------------------------


def _class_ckpt(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    import torch

    from dlbb_tpu_torch.resilience import inject
    from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer
    from dlbb_tpu_torch.train.loop import TrainState

    def state(step: int) -> TrainState:
        return TrainState({"w": torch.full((8, 8), float(step), device=gate.device)},
                          {"m": torch.zeros((8,), device=gate.device)}, step)

    d = str(work / "ckpt")
    with inject.plan_scope("ckpt-corrupt:@3"):
        with Checkpointer(CheckpointConfig(d, max_to_keep=5), device=gate.device) as ckpt:
            for s in (1, 2, 3):
                _check(ckpt.maybe_save(state(s), force=True),
                       f"save of step {s} failed")
            ok, why = ckpt.verify_step(3)
            _check(not ok, "corrupted step 3 passed verification")
            _check(ckpt.latest_intact_step() == 2,
                   "latest intact step should be 2")
            restored = ckpt.restore_or(state(0))
            _check(int(restored.step) == 2
                   and float(restored.params["w"][0, 0]) == 2.0
                   and restored.params["w"].device.type == gate.device,
                   "restore_or did not fall back to the intact step")
    log(f"ckpt-corrupt: step 3 refused ({why.split('(')[0].strip()}); "
        "fell back to intact step 2")


def _sweep_child(cfg: dict[str, Any], device: str) -> list[str]:
    """One rank of the kill class's child sweep (launched by name), with
    no fault plan of the environment's (JAX's child drops it)."""
    from dlbb_tpu_torch.bench.runner import Sweep1D, run_sweep
    from dlbb_tpu_torch.resilience import inject

    os.environ.pop(inject.ENV_VAR, None)
    return [str(p) for p in run_sweep(Sweep1D(**cfg), device=device, verbose=False).written]


def _class_kill(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    """SIGKILL mid-write (a launched child): the atomic writer must leave
    no destination artifact; resume completes the grid equivalently."""
    from torch.multiprocessing.spawn import ProcessException

    from dlbb_tpu_torch.bench.launch import launch

    out = work / "kill"
    clean = work / "kill_reference"

    def run_child(out_dir: str, **kw) -> int:
        cfg = gate.mini(**kw)
        cfg["output_dir"] = out_dir
        try:
            launch(_sweep_child, gate.world, gate.device, args=(cfg, gate.device),
                   timeout=_LAUNCH_TIMEOUT_S, group_timeout=_GROUP_TIMEOUT_S)
        except ProcessException as e:
            # rank 0 writes: its exit code is the child's (the peers fail
            # in their next collective with it, or are stopped)
            rc = getattr(e, "exitcodes", [None])[0]
            if rc != -9:
                raise ChaosFailure(
                    f"chaos child failed unexpectedly (rc={rc}):\n{str(e)[-2000:]}") from e
            return rc
        except TimeoutError as e:
            raise ChaosFailure(f"chaos child did not end: {e}") from e
        return 0

    # the preempt class's unfaulted grid, where it ran, is this class's
    # reference too
    shared = work / "preempt_reference"
    if sorted(p.name for p in shared.glob("chaos_*.json")) == gate.grid_files and \
            all(validate_result_json(p)[0] for p in shared.glob("chaos_*.json")):
        clean = shared
    else:
        rc = run_child(str(clean))
        _check(rc == 0, "reference child sweep failed")
    rc = run_child(str(out), fault_plan="kill-mid-write:@1")
    _check(rc == -9, f"kill-mid-write child should die by SIGKILL, rc={rc}")
    survivors = list(out.glob("chaos_*.json"))
    _check(not survivors,
           f"SIGKILL mid-write left destination artifacts: {survivors}")
    # (uniquely-named *.tmp litter from the killed write is permitted:
    # nothing ever trusts or collides with it)
    ev, _ = read_journal(out)
    _check(any(e["event"] == "started" for e in ev)
           and not any(e["event"] == "completed" for e in ev),
           "journal should show started-but-not-completed after SIGKILL")
    rc = run_child(str(out), resume=True)
    _check(rc == 0, "resume child sweep failed")
    _assert_grid_equivalent(str(out), str(clean))
    log("kill: SIGKILL mid-write left no trusted artifact; resume "
        "re-measured to an equivalent grid")


def _serve_cfg(gate: _Gate, name: str, dp: int = 2, tp: int = 4, **serving) -> dict:
    base = {"max_batch": 8, "block_size": 8, "max_seq": 64,
            "queue_capacity": 64, "hbm_budget_gb": None}
    base.update(serving)
    return {"experiment": {"name": name}, "model": dict(_SERVE_MODEL),
            "parallelism": gate.layout(dp, tp), "serving": base}


def _serve_trace():
    from dlbb_tpu_torch.serve.traffic import generate_trace

    return generate_trace("poisson", 10, seed=5, rate=200.0,
                          prompt_range=(4, 12), output_range=(3, 6))


def _prefix_trace():
    from dlbb_tpu_torch.serve.traffic import generate_trace

    return generate_trace("poisson", 10, seed=5, rate=200.0,
                          prompt_range=(17, 28), output_range=(3, 6),
                          prefix_groups=2, prefix_len=16)


def _deadline_trace():
    from dlbb_tpu_torch.serve.traffic import Request, TrafficTrace

    return TrafficTrace(
        kind="poisson", seed=0, params={"deadline_s": 0.02},
        requests=tuple(
            Request(rid=i, arrival_s=0.0, prompt_len=8, output_len=4,
                    seed=100 + i, deadline_s=0.02)
            for i in range(12)
        ),
    )


def _serve_runs(work: str, gate: _Gate) -> dict[str, Any]:
    """The serve class's runs on the dp=2 x tp=4 mesh (one rank at world
    1), every rank of it calling each with the same arguments, in JAX's
    order; what the checks read between runs is recorded as it stood."""
    from dlbb_tpu_torch.serve.bench import RESUME_CHECKPOINT, resume_serving, run_serving

    work_dir = Path(work)
    trace = _serve_trace()
    dev = gate.device
    watchdog = _SERVE_WATCHDOG[gate.jax_layouts]
    runs: dict[str, Any] = {}
    runs["transient"] = run_serving(
        _serve_cfg(gate, "t"), trace, str(work_dir / "serve_transient"), verbose=False,
        fault_plan="serve-prefill-fail:1,serve-decode-fail:1", device=dev)
    runs["torn"] = run_serving(_serve_cfg(gate, "c"), trace, str(work_dir / "serve_torn"),
                               verbose=False, fault_plan="serve-cache-torn:1", device=dev)
    runs["perm"] = run_serving(_serve_cfg(gate, "p", max_dispatch_retries=0), trace,
                               str(work_dir / "serve_perm"), verbose=False,
                               fault_plan="serve-decode-fail:*", device=dev)
    t0 = time.perf_counter()
    runs["hang"] = run_serving(_serve_cfg(gate, "h", **watchdog), trace,
                               str(work_dir / "serve_hang"), verbose=False,
                               fault_plan="serve-decode-hang:@1,hang_seconds=120", device=dev)
    runs["hang_wall"] = time.perf_counter() - t0
    runs["deadline"] = run_serving(_serve_cfg(gate, "d"), _deadline_trace(),
                                   str(work_dir / "serve_deadline"), verbose=False,
                                   device=dev)
    ref, out = work_dir / "serve_ref", work_dir / "serve_preempt"
    run_serving(_serve_cfg(gate, "x"), trace, str(ref), verbose=False, device=dev)
    runs["preempt"] = run_serving(_serve_cfg(gate, "x"), trace, str(out), verbose=False,
                                  fault_plan="serve-preempt:@3", device=dev)
    runs["preempt_files"] = {"checkpoint": (out / RESUME_CHECKPOINT).exists(),
                             "result": (out / "serving_x.json").exists()}
    runs["merged"] = resume_serving(str(out), verbose=False, device=dev)
    return runs


def _serve_prefix_run(work: str, gate: _Gate) -> dict[str, Any]:
    """The serve class's torn-refcount run on its dp=1 x tp=4 mesh."""
    from dlbb_tpu_torch.serve.bench import run_serving

    pcfg = _serve_cfg(gate, "cp", dp=1, tp=4, prefill_chunk=8, prefix_caching=True)
    return run_serving(pcfg, _prefix_trace(), str(Path(work) / "serve_torn_prefix"),
                       verbose=False, fault_plan="serve-cache-torn:1", device=gate.device)


def _class_serve(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    """The serving fault matrix (``cli chaos --plan serve``): every
    serving fault class either recovers or fails closed with journaled
    reasons, and SIGTERM-mid-trace + resume yields an artifact set
    equivalent (names + schema + per-request outcomes for non-preempted
    requests) to an uninterrupted run."""
    from dlbb_tpu_torch.obs.spans import journal_to_trace, load_trace
    from dlbb_tpu_torch.resilience import inject
    from dlbb_tpu_torch.serve.bench import RESUME_CHECKPOINT
    from dlbb_tpu_torch.serve.traffic import TrafficTrace

    runs = _serve_runs_on(str(work), gate)
    trace = _serve_trace()

    # -- transient prefill/decode dispatch failures: retried, recovered
    out = work / "serve_transient"
    rep = runs["transient"]
    _check(rep["resilience"]["retries"] >= 2,
           f"transient serve faults not retried: {rep['resilience']}")
    _check(rep["requests"]["completed"] == len(trace),
           "transient serve faults did not recover to full completion")
    _check(all(v == "completed"
               for v in rep["requests"]["outcomes"].values()),
           f"unexpected outcomes: {rep['requests']['outcomes']}")
    ev, _ = read_journal(out)
    _check(any(e["event"] == "dispatch-retry" for e in ev),
           "journal has no dispatch-retry record")
    _check(json.loads((out / "serving_t.json").read_text())["schema"]
           == "dlbb_serving_report_v1", "result artifact invalid")
    log("serve transient: prefill+decode dispatch faults retried with "
        "rollback; all requests completed")

    # -- torn ledger/slot bookkeeping: rolled back + replayed
    rep = runs["torn"]
    _check(rep["requests"]["completed"] == len(trace),
           "torn bookkeeping did not recover")
    _check(rep["resilience"]["retries"] >= 1,
           "torn bookkeeping was not replayed")
    _check(rep["cache"]["blocks_reserved"] == 0,
           "ledger left dangling reservations after rollback")
    log("serve cache-torn: half-applied accounting rolled back to the "
        "pre-dispatch snapshot and replayed; ledger consistent")

    # -- torn accounting over REFCOUNTED shared blocks: the rollback
    #    snapshot covers the prefix trie and its refcounts too
    prep = runs["torn_prefix"]
    _check(prep["requests"]["completed"] == len(_prefix_trace()),
           "torn refcount bookkeeping did not recover")
    _check(prep["resilience"]["retries"] >= 1,
           "torn refcount bookkeeping was not replayed")
    _check(prep["prefix"]["hits"] >= 1,
           "prefix trace produced no shared-prefix attach")
    _check(prep["cache"]["blocks_reserved"] == 0,
           "refcounted ledger left dangling reservations after rollback")
    _check(prep["cache"]["shared_blocks"] == 0,
           "prefix trie leaked shared blocks after drain "
           f"({prep['cache']})")
    _check(prep["cache"]["prefix_refs"] == 0,
           f"prefix trie leaked refcounts after drain ({prep['cache']})")
    log("serve cache-torn (prefix): refcounts + trie rolled back with "
        "the ledger; no double-free, no leaked shared block")

    # -- permanent decode failure: affected requests fail CLOSED with
    #    chains; the run itself survives
    out = work / "serve_perm"
    rep = runs["perm"]
    _check(rep["requests"]["failed"] > 0,
           "permanent decode failure failed no requests")
    _check(rep["resilience"]["failed"]
           and rep["resilience"]["failed"][0]["traceback"],
           "failure record lacks the exception chain")
    _check(len(rep["requests"]["outcomes"]) == len(trace),
           "some requests have no terminal outcome")
    ev, _ = read_journal(out)
    _check(any(e["event"] == "request-failed" for e in ev),
           "journal has no request-failed record")
    log("serve permanent: exhausted retries failed only the affected "
        "requests, chains journaled; run drained")

    # -- hung dispatch: the watchdog abandons it, the engine continues
    rep, wall = runs["hang"], runs["hang_wall"]
    _check(wall < 60.0,
           f"serve blocked behind the hung dispatch ({wall:.1f}s vs "
           "120s hang)")
    _check(rep["resilience"]["hung_dispatches"] == 1,
           "watchdog did not abandon the hung dispatch")
    _check(any(v == "failed[hung-dispatch]"
               for v in rep["requests"]["outcomes"].values()),
           "hung unit's requests not journaled failed[hung-dispatch]")
    _check(rep["requests"]["completed"] >= 1,
           "engine did not continue past the hung dispatch")
    log(f"serve hang: watchdog abandoned at deadline, engine continued "
        f"on a fresh carry ({wall:.1f}s wall vs 120s hang)")

    # -- corrupt trace load: fails closed, publishes nothing
    path = work / "trace_corrupt.json"
    trace.save(path)
    with inject.plan_scope("serve-trace-corrupt:@1"):
        try:
            TrafficTrace.load(path)
        except ValueError as e:
            _check("corrupt or truncated" in str(e)
                   and e.__cause__ is not None,
                   f"corrupt-trace error lacks cause/chain: {e}")
        else:
            raise ChaosFailure("corrupt trace loaded without error")
    log("serve trace-corrupt: load failed closed with a chained error")

    # -- per-request deadlines: shed distinct from queue-full (a t=0 burst
    #    with a 20 ms SLO: 8 admitted at once complete late, the queue heads
    #    left behind are shed)
    out = work / "serve_deadline"
    rep = runs["deadline"]
    _check(rep["requests"]["deadline_shed"] >= 1,
           "no queued request was shed by deadline under a 20ms SLO")
    _check(rep["requests"]["completed_past_deadline"] >= 1,
           "no completion was counted past its deadline")
    _check(rep["requests"]["shed_rate"] == 0.0,
           "deadline sheds leaked into the queue-full shed rate")
    ev, _ = read_journal(out)
    _check(any(e.get("reason") == "deadline" for e in ev
               if e["event"] == "request-rejected"),
           "journal has no deadline rejection record")
    log("serve deadline: blown-SLO queue heads shed "
        "(reason=deadline, distinct from queue-full); late "
        "completions counted")

    # -- SIGTERM mid-trace -> drain + checkpoint; resume merges to an
    #    artifact set equivalent to an uninterrupted run
    ref = work / "serve_ref"
    out = work / "serve_preempt"
    rep = runs["preempt"]
    _check(rep["preempted"], "serve-preempt did not drain gracefully")
    _check(runs["preempt_files"]["checkpoint"],
           "preempted session wrote no resume checkpoint")
    _check(not runs["preempt_files"]["result"],
           "preempted session wrote a result artifact")
    preempted_rids = {rid for rid, o in rep["requests"]["outcomes"]
                      .items() if o == "preempted"}
    ev, _ = read_journal(out)
    _check(any(e["event"] == "preempted" for e in ev),
           "journal has no preempted record")
    merged = runs["merged"]
    _check(not (out / RESUME_CHECKPOINT).exists(),
           "resume left the checkpoint behind")
    names_ref = sorted(p.name for p in ref.iterdir())
    names_out = sorted(p.name for p in out.iterdir())
    _check(names_ref == names_out,
           f"artifact sets differ: {names_out} != {names_ref}")
    a = json.loads((ref / "serving_x.json").read_text())
    b = json.loads((out / "serving_x.json").read_text())
    _check(sorted(a) == sorted(b),
           "serving report schema keys differ after resume")
    oa, ob = a["requests"]["outcomes"], b["requests"]["outcomes"]
    for rid in oa:
        if rid in preempted_rids:
            continue
        _check(oa[rid] == ob[rid],
               f"request {rid} outcome differs after resume: "
               f"{ob[rid]} != {oa[rid]}")
    _check(merged["requests"]["sessions"] == 2,
           "merged report does not record both sessions")
    # the journal alone reconstructs the preempted lifecycle
    timeline, _n, _torn = journal_to_trace(out, out / "timeline.json")
    cats = {e.get("cat") for e in load_trace(timeline)["traceEvents"]}
    _check("config-preempted" in cats,
           "journal timeline has no preempted request span")
    (out / "timeline.json").unlink()
    log("serve preempt: SIGTERM drained + checkpointed; resume "
        "merged to an equivalent artifact set (outcomes pinned for "
        "non-preempted requests)")


def _serve_runs_on(work: str, gate: _Gate) -> dict[str, Any]:
    """The serve class's runs: on the CPU one launch per mesh (dp=2 x tp=4,
    then the prefix case's dp=1 x tp=4), at world 1 in this process."""
    runs = _on_world(_serve_runs, gate, (work, gate), world=8 if gate.jax_layouts else 1)
    runs["torn_prefix"] = _on_world(_serve_prefix_run, gate, (work, gate),
                                    world=4 if gate.jax_layouts else 1)
    return runs


def _fleet_cfg(gate: _Gate, name: str, fleet: Optional[dict] = None, dp: int = 2,
               tp: int = 2, **serving) -> dict:
    base = {"max_batch": 8, "block_size": 8, "max_seq": 64,
            "queue_capacity": 64, "hbm_budget_gb": None}
    base.update(serving)
    # per-replica parallelism: 2 replicas x (dp=2 x tp=2), JAX's layout
    return {"experiment": {"name": name}, "model": dict(_SERVE_MODEL),
            "parallelism": gate.layout(dp, tp), "serving": base,
            "fleet": {"replicas": 2, **(fleet or {})}}


def _kill_trace():
    from dlbb_tpu_torch.serve.traffic import generate_trace

    return generate_trace("poisson", 16, seed=5, rate=60.0,
                          prompt_range=(4, 12), output_range=(4, 8))


def _burst_trace():
    from dlbb_tpu_torch.serve.traffic import Request, TrafficTrace

    return TrafficTrace(
        kind="poisson", seed=0, params={},
        requests=tuple(
            Request(rid=i, arrival_s=0.0, prompt_len=8, output_len=6,
                    seed=300 + i)
            for i in range(16)
        ),
    )


def _fleet_references(gate: _Gate) -> dict[str, Any]:
    """The unfaulted single-replica references of the kill trace and the
    burst, on one replica's mesh (every rank of it calls each)."""
    from dlbb_tpu_torch.serve.bench import run_serving

    def ref_cfg(name: str) -> dict:
        c = _fleet_cfg(gate, name)
        del c["fleet"]
        return c

    return {"kill": run_serving(ref_cfg("flr"), _kill_trace(), verbose=False, journal=False,
                                capture_tokens=True, device=gate.device),
            "burst": run_serving(ref_cfg("fbr"), _burst_trace(), verbose=False, journal=False,
                                 capture_tokens=True, device=gate.device)}


def _fleet_scenarios(gate: _Gate, work: Path) -> list[tuple]:
    """The fleet class's runs in JAX's order: (label, config, trace, output
    directory, fault plan)."""
    prefix = _fleet_cfg(gate, "fp", dp=1, tp=4, prefill_chunk=8, prefix_caching=True)
    return [
        ("kill", _fleet_cfg(gate, "fk"), _kill_trace(), work / "fleet_kill",
         "serve-replica-kill:@8"),
        ("torn", _fleet_cfg(gate, "ft"), _kill_trace(), work / "fleet_torn",
         "serve-replica-kill:@8,serve-failover-torn:1"),
        ("hang", _fleet_cfg(gate, "fh", fleet={"heartbeat_min_s": 1.0,
                                               "heartbeat_factor": 4.0}),
         _kill_trace(), work / "fleet_hang", "serve-replica-hang:@8,hang_seconds=120"),
        ("hedge", _fleet_cfg(gate, "fg", fleet={"heartbeat_min_s": 30.0,
                                                "hedge_min_completions": 4},
                             hedge_factor=1.25),
         _burst_trace(), work / "fleet_hedge", "serve-replica-hang:@6,hang_seconds=4.0"),
        ("prefix", prefix, _prefix_trace(), work / "fleet_prefix", "serve-replica-kill:@10"),
    ]


def _fleet_rank_runs(work: str, gate: _Gate, box_dir: str) -> dict[str, Any]:
    """Every fleet scenario on this rank of one launch, one after another
    (``serve/fleet.py::fleet_rank``, each with a mailbox of its own); rank
    0's reports and walls (each scenario's time in rank 0's supervisor)."""
    from dlbb_tpu_torch.serve.fleet import fleet_rank

    out: dict[str, Any] = {}
    for i, (label, config, trace, out_dir, plan) in enumerate(
            _fleet_scenarios(gate, Path(work))):
        t0 = time.perf_counter()
        res = fleet_rank(config, trace, str(out_dir), True, False, plan, True, gate.device,
                         os.path.join(box_dir, f"mailbox_{i}"))
        out[label] = (res["report"], time.perf_counter() - t0)
    return out


def _fleet_runs(work: Path, gate: _Gate) -> dict[str, Any]:
    """The fleet class's references and scenarios, and each scenario's
    report and wall: the references on one replica's mesh (this process at
    world 1, else one launch), the scenarios in one launch of the fleet's
    ranks (JAX's five ``run_fleet`` calls; each scenario's replicas
    partition the same ranks)."""
    from dlbb_tpu_torch.bench.launch import launch

    refs = _on_world(_fleet_references, gate, (gate,), world=4 if gate.jax_layouts else 1)
    world = 8 if gate.jax_layouts else 2
    with tempfile.TemporaryDirectory(prefix="dlbb_chaos_fleet_") as box_dir:
        ranks = launch(_fleet_rank_runs, world, gate.device, shared=True,
                       args=(str(work), gate, box_dir), timeout=_LAUNCH_TIMEOUT_S)
    return {"references": refs, "scenarios": ranks[0]}


def _class_fleet(work: Path, log: Callable[[str], None], gate: _Gate) -> None:
    """Replica-level fault tolerance (``cli chaos --plan fleet``): a
    2-replica fleet survives a replica SIGKILL mid-trace (residents failed
    over, every surviving request's tokens identical to an unfaulted
    single-replica run, zero leaked ledger blocks), a torn failover rolls
    back and retries without double-routing, a hung replica is fenced by
    the heartbeat watchdog long before the hang expires, and a straggler
    is hedged: first completion wins, the loser is canceled without
    corrupting the ledger."""
    from dlbb_tpu_torch.obs.spans import journal_to_trace, load_trace

    runs = _fleet_runs(work, gate)
    ref, bref = runs["references"]["kill"], runs["references"]["burst"]
    scen = runs["scenarios"]

    def _tokens_match(rep: dict, ref: dict, what: str) -> None:
        """Greedy tokens depend only on (params seed, request), so a fleet
        run on rank subsets must reproduce the single-replica reference
        exactly, including for failed-over and hedged rids."""
        got, want = rep["completed_tokens"], ref["completed_tokens"]
        _check(sorted(got) == sorted(want),
               f"{what}: completed-token rid sets differ")
        for rid in want:
            _check(got[rid] == want[rid],
                   f"{what}: request {rid} tokens diverged after fleet "
                   f"recovery: {got[rid]} != {want[rid]}")

    def _no_leak(replica: dict, what: str) -> None:
        cache = replica["report"]["cache"]
        _check(cache["blocks_reserved"] == 0,
               f"{what}: replica {replica['replica']} leaked ledger "
               f"blocks after drain ({cache})")
        _check(cache.get("shared_blocks", 0) == 0,
               f"{what}: replica {replica['replica']} leaked shared "
               f"blocks ({cache})")
        _check(cache.get("prefix_refs", 0) == 0,
               f"{what}: replica {replica['replica']} leaked prefix "
               f"refcounts ({cache})")

    # -- replica SIGKILL mid-trace: fence + failover re-prefill; every
    #    request completes with tokens identical to the unfaulted
    #    single-replica reference; the survivor's ledger drains to zero
    out = work / "fleet_kill"
    rep, _wall = scen["kill"]
    dead = [r for r in rep["replicas"]
            if r["fence_reason"] == "replica-killed"]
    _check(len(dead) == 1, f"expected one killed replica, got "
           f"{[r['fence_reason'] for r in rep['replicas']]}")
    _check(all(v == "completed"
               for v in rep["requests"]["outcomes"].values()),
           f"kill: not all requests recovered: "
           f"{rep['requests']['outcomes']}")
    _check(rep["failovers"]["total"] >= 1,
           "kill fired but no resident was failed over")
    _check(rep["failovers"]["by_reason"]["replica-killed"]
           == rep["failovers"]["total"],
           f"failover reasons inconsistent: {rep['failovers']}")
    _tokens_match(rep, ref, "kill")
    survivor = [r for r in rep["replicas"] if r["status"] == "ok"]
    _check(len(survivor) == 1, "kill: no surviving replica")
    _no_leak(survivor[0], "kill")
    _check(rep["failover_ttft_penalty_s"] is not None,
           "failover TTFT penalty not measured")
    ev, torn = read_journal(out)
    _check(torn == 0, f"kill: journal has {torn} torn lines")
    fo = [e for e in ev if e["event"] == "request-failover"]
    _check(len(fo) == rep["failovers"]["total"],
           "failover count diverges from the journal")
    _check(all(e.get("reason") == "replica-killed" and e.get("error")
               for e in fo),
           "request-failover records lack reason + exception chain")
    _check(any(e["event"] == "replica-fenced"
               and e.get("reason") == "replica-killed" for e in ev),
           "journal has no replica-fenced record")
    # the journal alone reconstructs the fleet lifecycle, one Perfetto
    # track group per replica
    timeline, _n, _t = journal_to_trace(out, out / "timeline.json")
    tl = load_trace(timeline)
    names = {e["args"]["name"] for e in tl["traceEvents"]
             if e.get("name") == "process_name"}
    _check({"fleet", "replica-0", "replica-1"} <= names,
           f"timeline lacks per-replica track groups: {names}")
    _check(any(e.get("cat") == "fleet" for e in tl["traceEvents"]),
           "timeline has no fleet lifecycle instants")
    (out / "timeline.json").unlink()
    log(f"fleet kill: replica fenced mid-trace, "
        f"{rep['failovers']['total']} residents failed over and "
        f"completed with reference-identical tokens; survivor ledger "
        f"drained (TTFT penalty "
        f"{rep['failover_ttft_penalty_s'] * 1e3:.1f}ms)")

    # -- torn failover: the routing mutation rolls back to its snapshot
    #    and retries; no request is double-routed or lost
    out = work / "fleet_torn"
    rep, _wall = scen["torn"]
    _check(rep["failovers"]["total"] >= 1,
           "torn: kill fired but no resident was failed over")
    fo_rids = [r["rid"] for r in rep["failovers"]["requests"]]
    _check(len(fo_rids) == len(set(fo_rids)),
           f"torn failover double-routed a request: {fo_rids}")
    _check(all(v == "completed"
               for v in rep["requests"]["outcomes"].values()),
           f"torn: not all requests recovered: "
           f"{rep['requests']['outcomes']}")
    _tokens_match(rep, ref, "torn")
    ev, _ = read_journal(out)
    _check(any(e["event"] == "failover-torn" for e in ev),
           "journal has no failover-torn rollback record")
    log("fleet torn: torn routing table rolled back + retried; "
        "no double-routed request, tokens pinned")

    # -- replica hang: the heartbeat watchdog fences the replica long
    #    before the 120 s hang expires
    out = work / "fleet_hang"
    rep, wall = scen["hang"]
    _check(wall < 60.0,
           f"fleet blocked behind the hung replica ({wall:.1f}s vs "
           "120s hang)")
    _check(any(r["fence_reason"] == "replica-hung"
               for r in rep["replicas"]),
           f"hung replica not fenced: "
           f"{[r['fence_reason'] for r in rep['replicas']]}")
    _check(all(v == "completed"
               for v in rep["requests"]["outcomes"].values()),
           f"hang: not all requests recovered: "
           f"{rep['requests']['outcomes']}")
    _tokens_match(rep, ref, "hang")
    ev, _ = read_journal(out)
    _check(any(e["event"] == "replica-fenced"
               and e.get("reason") == "replica-hung" and e.get("error")
               for e in ev),
           "replica-hung fence lacks a journaled heartbeat chain")
    log(f"fleet hang: heartbeat fenced the silent replica, residents "
        f"failed over ({wall:.1f}s wall vs 120s hang)")

    # -- hedge-cancel race: a burst pins residents on a replica that then
    #    hangs briefly; past p99 x hedge_factor the supervisor duplicates
    #    them onto the survivor, first completion wins, and the losing
    #    copy is canceled without corrupting either ledger
    out = work / "fleet_hedge"
    rep, _wall = scen["hedge"]
    _check(rep["hedges"]["issued"] >= 1,
           f"straggling residents were never hedged: {rep['hedges']}")
    _check(rep["hedges"]["won"] >= 1,
           f"no hedge duplicate won the race: {rep['hedges']}")
    _check(rep["hedges"]["won"] + rep["hedges"]["lost"]
           <= rep["hedges"]["issued"],
           f"hedge accounting inconsistent: {rep['hedges']}")
    _check(all(v == "completed"
               for v in rep["requests"]["outcomes"].values()),
           f"hedge: not all requests completed: "
           f"{rep['requests']['outcomes']}")
    _tokens_match(rep, bref, "hedge")
    # the brief hang recovered: neither replica fenced, both ledgers
    # drained (the canceled losing copies released their blocks)
    _check(all(r["status"] == "ok" for r in rep["replicas"]),
           f"hedge: replica fenced unexpectedly: "
           f"{[(r['status'], r['fence_reason']) for r in rep['replicas']]}")
    for r in rep["replicas"]:
        _no_leak(r, "hedge")
    ev, _ = read_journal(out)
    _check(any(e["event"] == "request-hedged" for e in ev),
           "journal has no request-hedged record")
    _check(any(e["event"] == "request-canceled"
               and e.get("reason") == "hedge-lost" for e in ev),
           "losing hedge copy was never canceled")
    log(f"fleet hedge: {rep['hedges']['issued']} hedges issued, "
        f"{rep['hedges']['won']} won; losers canceled, both ledgers "
        "drained, tokens pinned")

    # -- prefix affinity under fire: a shared-prefix trace routes sticky,
    #    the kill re-homes the dead replica's prefix group, and the
    #    survivor's trie refcounts still drain to zero
    rep, _wall = scen["prefix"]
    _check(rep["routing"]["prefix_affinity_hits"] >= 1,
           "prefix trace produced no affinity-routed request")
    _check(all(v == "completed"
               for v in rep["requests"]["outcomes"].values()),
           f"prefix: not all requests recovered: "
           f"{rep['requests']['outcomes']}")
    survivor = [r for r in rep["replicas"] if r["status"] == "ok"]
    _check(len(survivor) == 1, "prefix: no surviving replica")
    _no_leak(survivor[0], "prefix kill")
    log(f"fleet prefix: affinity routing held "
        f"({rep['routing']['prefix_affinity_hits']} hits), killed "
        "replica's prefix group re-homed, survivor trie drained")


CHAOS_CLASSES: dict[str, Callable[[Path, Callable[[str], None], _Gate], None]] = {
    "compile": _class_compile,
    "transient": _class_transient,
    "nan": _class_nan,
    "torn": _class_torn,
    "hang": _class_hang,
    "ckpt": _class_ckpt,
    "preempt": _class_preempt,
    "kill": _class_kill,
    "serve": _class_serve,
    "fleet": _class_fleet,
}
# the classes whose sweeps run on every rank of the world, together
_RANK_CLASSES = ("compile", "transient", "nan", "torn", "hang", "preempt")


def run_chaos(plan: str = "all", output: Optional[str] = None,
              verbose: bool = True, device=None, world: Optional[int] = None) -> int:
    """Run the chaos gate; returns a process exit code: 0 every invariant
    held, 1 a class failed, 2 an unknown class.  ``device`` is ``cuda``
    unless the caller names ``cpu``; ``world`` is the mini-grid's ranks
    (default 4 on the CPU, 1 on a card; module docstring)."""
    from dlbb_tpu_torch.utils.sysinfo import resolve_device

    def log(msg: str) -> None:
        if verbose:
            print(f"[chaos] {msg}")

    names = list(CHAOS_CLASSES) if plan == "all" else [plan]
    unknown = [n for n in names if n not in CHAOS_CLASSES]
    if unknown:
        print(f"[chaos] unknown class(es) {unknown}; "
              f"known: {list(CHAOS_CLASSES)} + 'all'")
        return 2
    dev = resolve_device(device)
    gate = _Gate(dev.type, world if world is not None else (4 if dev.type == "cpu" else 1))
    workroot = Path(output) if output else Path(tempfile.mkdtemp(
        prefix="dlbb_chaos_"))
    workroot.mkdir(parents=True, exist_ok=True)
    failures = []
    on_ranks: Optional[dict[str, tuple]] = None
    for name in names:
        t0 = time.perf_counter()
        if name in _RANK_CLASSES:
            if on_ranks is None:
                batch = [n for n in names if n in _RANK_CLASSES]
                try:
                    on_ranks = _on_world(_rank_classes, gate, (batch, str(workroot), gate),
                                         group=True)
                except Exception as e:  # noqa: BLE001 — gate must report, not die
                    on_ranks = {n: ("ERROR", f"{type(e).__name__}: {e}", 0.0, [])
                                for n in batch}
                log(f"sweep classes {batch} on {gate.world} {gate.device} rank(s): "
                    f"{time.perf_counter() - t0:.1f}s")
            status, msg, seconds, lines = on_ranks[name]
            for line in lines:
                log(line)
            if status == "ok":
                log(f"{name} ok ({seconds:.1f}s)")
            else:
                failures.append((name, msg))
                print(f"[chaos] {status} {name}: {msg}")
            continue
        try:
            CHAOS_CLASSES[name](workroot, log, gate)
        except ChaosFailure as e:
            failures.append((name, str(e)))
            print(f"[chaos] FAIL {name}: {e}")
        except Exception as e:  # noqa: BLE001 — gate must report, not die
            failures.append((name, f"{type(e).__name__}: {e}"))
            print(f"[chaos] ERROR {name}: {type(e).__name__}: {e}")
        else:
            log(f"{name} ok ({time.perf_counter() - t0:.1f}s)")
    if failures:
        print(f"[chaos] {len(failures)}/{len(names)} class(es) FAILED "
              f"(workdir kept: {workroot})")
        return 1
    print(f"[chaos] all {len(names)} fault class(es) green "
          f"(workdir: {workroot})")
    return 0
