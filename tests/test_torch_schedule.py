"""The sweep's compile-ahead engine (ROADMAP Queue 1, Slice F, item 13, part
13b: ``dlbb_tpu_torch/bench/schedule.py`` and the runner's planning pass),
mirroring JAX's 13 engine tests ``tests/test_schedule.py``: dedup keys never
collide across variants or rank sets, a poisoned work unit skips its configs
while the pipeline drains, a config that cannot be planned is contained,
serial and pipelined runs write the same artifacts, the scheduler builds
each unit once and in order, and the payload cache evicts by its budget.

The port times per iteration only and has no compilation cache: JAX's
chained-mode and persistent-cache tests here assert the port's stated
refusal and its manifest record.  The sweeps run on one launch of 4 gloo
ranks (``_sweeps``), shared by every test that reads them.
"""

import json
import os
import threading

import pytest
import torch

from dlbb_tpu_torch.bench import runner
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.bench.schedule import (
    NO_CACHE_REASON,
    CompileAheadScheduler,
    PayloadCache,
    WorkUnit,
    compile_cache_record,
    default_pipeline,
    work_unit_key,
)
from dlbb_tpu_torch.comm.mesh import Mesh, MeshSpec

WORLD = 4


def _mesh(ranks=None):
    return Mesh(MeshSpec.ring(WORLD), 0, None, {}, ranks)


def _key(variant="default", op="allreduce", n=256, mesh=None, backend="gloo",
         dtype=torch.float32, root=0):
    mesh = mesh if mesh is not None else _mesh()
    return work_unit_key(op, variant, mesh, ("ranks",), root, (n,), dtype, backend)


def test_work_unit_key_identity_and_variant_collision():
    """Equal build parameters intern to one key; the same payload under a
    different variant, op, size, dtype, root or backend never shares one;
    the chained timing fingerprint is refused."""
    assert _key() == _key()
    assert _key(variant="default") != _key(variant="hier2x2x2")
    assert _key(op="allreduce") != _key(op="broadcast")
    assert _key(n=256) != _key(n=512)
    assert _key(dtype=torch.float32) != _key(dtype=torch.bfloat16)
    assert _key(root=0) != _key(root=1)
    assert _key(backend="gloo") != _key(backend="nccl")
    with pytest.raises(ValueError, match="per iteration"):
        work_unit_key("allreduce", "default", _mesh(), ("ranks",), 0, (256,),
                      torch.float32, "gloo", mode="chained")


def test_work_unit_key_mesh_identity():
    """The same mesh shape on another set of ranks is another unit."""
    assert _key(mesh=_mesh()) != _key(mesh=_mesh(ranks=(3, 2, 1, 0)))
    assert _key(mesh=_mesh()) == _key(mesh=_mesh(ranks=None))


def _tiny(out, **kw):
    """JAX's ``_tiny`` sweep: 2 configs on a 4-rank mesh, pipelined."""
    defaults = dict(implementation="xla_test", operations=("allreduce", "broadcast"),
                    data_sizes=(("1KB", 256),), rank_counts=(WORLD,), dtype="float32",
                    warmup_iterations=1, measurement_iterations=3, output_dir=str(out),
                    pipeline=True)
    defaults.update(kw)
    return runner.Sweep1D(**defaults)


def _boom_build(mesh, root=0):
    raise RuntimeError("poisoned work unit")


def _sweep_jobs(jobs):
    """A rank body: each ``(name, sweep)`` in turn, the ``boom`` op (whose
    build raises) registered; ``{name: (written names, failed configs)}``."""
    from dlbb_tpu_torch.comm.ops import OPERATIONS, CollectiveOp

    OPERATIONS["boom"] = CollectiveOp("boom", "per_rank", "per_rank", _boom_build)
    out = {}
    for name, sweep in jobs:
        result = runner.run_sweep(sweep, device="cpu", verbose=False)
        out[name] = ([p.name for p in result.written], [f["config"] for f in result.failed])
    return out


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Every sweep the tests read, on one launch of 4 gloo ranks."""
    root = tmp_path_factory.mktemp("schedule")
    jobs = [
        ("pipe", _tiny(root / "pipe")),
        ("serial", _tiny(root / "serial", pipeline=False)),
        ("boom", _tiny(root / "boom", operations=("boom", "allreduce", "broadcast"))),
        ("plan", _tiny(root / "plan", operations=("nosuchop", "allreduce"),
                       max_global_bytes=1 << 30)),
        ("warm", _tiny(root / "warm", compile_cache="auto")),
    ]
    results = launch(_sweep_jobs, WORLD, "cpu", args=(jobs,), timeout=300)
    manifests = {name: json.loads((root / name / runner.MANIFEST_NAME).read_text())
                 for name, _ in jobs}
    return root, results, manifests


def test_serial_and_pipelined_results_equivalent(sweeps):
    """--no-pipeline and the pipelined engine write the same artifact set
    with the same schema and identical non-timing fields."""
    root, results, manifests = sweeps
    assert results[0]["pipe"][0] == results[0]["serial"][0]
    assert len(results[0]["pipe"][0]) == 2
    for name in results[0]["pipe"][0]:
        dp = json.loads((root / "pipe" / name).read_text())
        ds = json.loads((root / "serial" / name).read_text())
        assert sorted(dp) == sorted(ds)
        for k in ("implementation", "operation", "num_ranks", "num_elements", "dtype",
                  "timing_mode", "mesh_shape"):
            assert dp[k] == ds[k], k
        for d in (dp, ds):
            assert d["compile_seconds"] >= 0.0
            assert isinstance(d["compile_cache_hit"], bool)
    assert manifests["pipe"]["pipeline"] is True
    assert manifests["serial"]["pipeline"] is False
    assert all(manifests[m]["configs"]["measured"] == 2 for m in ("pipe", "serial"))


def test_compile_failure_contained_pipeline_drains(sweeps):
    """A unit whose build raises skips its config on every rank, the
    pipeline drains, and the manifest records the failure."""
    _root, results, manifests = sweeps
    names = sorted(results[0]["boom"][0])
    assert names == ["xla_test_allreduce_ranks4_1KB_fp32.json",
                     "xla_test_broadcast_ranks4_1KB_fp32.json"]
    assert all(r["boom"][1] == ["xla_test_boom_ranks4_1KB_fp32.json"] for r in results)
    man = manifests["boom"]
    assert man["configs"]["failed"] == 1
    assert man["configs"]["measured"] == 2
    assert man["work_units"]["compile_failed"] == 1
    [q] = man["resilience"]["quarantined"]
    assert q["phase"] == "compile" and "poisoned work unit" in q["error"]


def test_planning_failure_contained(sweeps):
    """A config that cannot be planned (an unknown op, met first by the
    memory cap's estimate) fails alone; the rest of the sweep proceeds."""
    _root, results, manifests = sweeps
    assert results[0]["plan"][0] == ["xla_test_allreduce_ranks4_1KB_fp32.json"]
    man = manifests["plan"]
    assert man["configs"]["failed"] == 1
    assert man["configs"]["measured"] == 1
    assert man["resilience"]["quarantined"][0]["phase"] == "planning"


def test_chained_mode_through_engine(tmp_path):
    """The port times per iteration only: a chained sweep is refused before
    it plans anything (JAX AOT-compiles the donating timing loop)."""
    with pytest.raises(NotImplementedError, match="per iteration only"):
        runner.run_sweep(_tiny(tmp_path, timing_mode="chained"), device="cpu")
    assert not tmp_path.joinpath(runner.MANIFEST_NAME).exists()


def test_warm_persistent_cache_hits(sweeps, tmp_path):
    """No compilation cache to warm: an explicit directory is refused with
    the reason, and a sweep under JAX's default records the cache disabled,
    every unit it built a miss and every first artifact no hit."""
    with pytest.raises(ValueError, match="eager torch compiles no program"):
        runner.run_sweep(_tiny(tmp_path, compile_cache=str(tmp_path / "shared")),
                         device="cpu")
    root, results, manifests = sweeps
    cache = manifests["warm"]["compile_cache"]
    assert cache == {"dir": None, "enabled": False, "reason": NO_CACHE_REASON,
                     "persistent_hits": 0, "persistent_misses": 2}
    for name in results[0]["warm"][0]:
        assert json.loads((root / "warm" / name).read_text())["compile_cache_hit"] is False


def test_default_pipeline_env_overrides(monkeypatch):
    monkeypatch.setenv("DLBB_SWEEP_PIPELINE", "1")
    assert default_pipeline() is True
    monkeypatch.setenv("DLBB_SWEEP_PIPELINE", "off")
    assert default_pipeline() is False
    monkeypatch.delenv("DLBB_SWEEP_PIPELINE")
    monkeypatch.setenv("DLBB_COMPILE_OVERLAP", "1")
    assert default_pipeline() is True
    monkeypatch.delenv("DLBB_COMPILE_OVERLAP")
    assert default_pipeline() is ((os.cpu_count() or 1) >= 4)


def test_cache_scope_restores_prior_config(monkeypatch):
    """JAX scopes its cache to the sweep and restores the caller's; the
    port's record touches no process state, and ``DLBB_XLA_CACHE`` (JAX's
    override) overrides the sweep's setting either way."""
    env_before = dict(os.environ)
    assert compile_cache_record("auto") == compile_cache_record("off")
    assert dict(os.environ) == env_before
    monkeypatch.setenv("DLBB_XLA_CACHE", "results/.xla_cache")
    with pytest.raises(ValueError, match="no compilation cache"):
        compile_cache_record("off")
    monkeypatch.setenv("DLBB_XLA_CACHE", "off")
    assert compile_cache_record("some/dir")["enabled"] is False


def test_configure_compilation_cache_off(monkeypatch, tmp_path):
    for value in ("off", "0", "none", "", "disabled"):
        monkeypatch.setenv("DLBB_XLA_CACHE", value)
        assert compile_cache_record("auto")["enabled"] is False
    monkeypatch.delenv("DLBB_XLA_CACHE")
    d = tmp_path / "explicit"
    with pytest.raises(ValueError, match="no compilation cache"):
        compile_cache_record(str(d))
    assert not d.exists()
    assert compile_cache_record(None) == {"dir": None, "enabled": False,
                                          "reason": NO_CACHE_REASON}


def test_scheduler_dedup_and_drain():
    """Each unit builds exactly once however many configs consume it, and
    a failing build never wedges the worker."""
    builds = []

    def make_build(name, fail=False):
        def build():
            builds.append(name)
            if fail:
                raise ValueError(f"{name} failed")
            return lambda x: x
        return build

    units = [WorkUnit(key=("a",), build=make_build("a")),
             WorkUnit(key=("b",), build=make_build("b", fail=True)),
             WorkUnit(key=("c",), build=make_build("c"))]
    sched = CompileAheadScheduler(units, prefetch=1, pipeline=True)
    sched.start()
    for u in (units[0], units[0], units[1], units[2]):
        sched.get(u)
    sched.close()
    assert builds == ["a", "b", "c"]
    assert units[0].error is None and units[0].consumers == 2
    assert isinstance(units[1].error, ValueError)
    assert units[2].error is None and units[2].fn(3) == 3


def test_scheduler_serial_mode_compiles_inline():
    built = threading.Event()
    unit = WorkUnit(key=("x",), build=lambda: (built.set() or (lambda x: x)))
    sched = CompileAheadScheduler([unit], pipeline=False)
    sched.start()  # no thread in serial mode
    assert not built.is_set()
    got = sched.get(unit)
    assert built.is_set() and got.error is None
    sched.close()


def test_payload_cache_lru_and_invalidate():
    class FakeArr:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    cache = PayloadCache(max_bytes=100)
    a = cache.get(("a",), lambda: FakeArr(40))
    assert cache.get(("a",), lambda: FakeArr(999)) is a  # hit, no rebuild
    cache.get(("b",), lambda: FakeArr(40))
    cache.get(("c",), lambda: FakeArr(40))  # evicts the LRU entry, "a"
    assert cache.evictions == 1
    assert cache.get(("a",), lambda: FakeArr(40)) is not a  # rebuilt
    big = cache.get(("big",), lambda: FakeArr(1000))
    assert cache.get(("big",), lambda: FakeArr(1000)) is not big
    cache.invalidate(("a",))
    assert isinstance(cache.get(("a",), lambda: FakeArr(40)), FakeArr)
    stats = cache.stats()
    assert stats["budget_bytes"] == 100
    assert stats["hits"] >= 1 and stats["misses"] >= 4
