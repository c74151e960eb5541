"""The serving fleet (ROADMAP Queue 1, Slice E, item 12, part 12b:
``dlbb_tpu_torch/serve/fleet.py``, the engine's ``feed``/``control`` hooks,
``comm/mesh.py``'s device partition, ``obs/export.fleet_metrics``,
``stats/serving_report.write_fleet_report`` and ``cli serve --replicas``)
against the JAX package, on the CPU.

- ``tests/test_fleet.py``'s 17 tests, mirrored.  The host-side ones run
  one call sequence through JAX's ``FleetSupervisor`` and through the
  port's (both built with ``meshes=[object()] * R``, which only counts
  them): JAX's assertions hold on both sides, and their journal events,
  counters, routing tables and feeds are equal.  The port's supervisor
  talks to in-process replica leaders (``ReplicaControl``) through a
  mailbox on a ``HashStore``, the control plane a launched fleet runs over
  its ``FileStore``: what JAX's tests read off a replica's feed or control
  is read where the port's replica receives it, after a loop boundary.  The AST pin is the
  port's.  The two engine smokes share one JAX oracle and killed fleet
  (JAX's ``SMOKE_CONFIG`` on 8 simulated devices) and one port oracle and
  killed fleet (2 replicas x dp=2 on 4 gloo ranks, through
  ``tests/torch_serve_worker.py``): every request completes, with the
  tokens of its side's oracle and of the other side's.
- More: every rank of the killed replica raises ``ReplicaKilled`` at the
  same loop boundary, the survivor's ranks complete, and no collective of
  the run goes over the world group; a launch with a rank outside every
  replica's mesh is refused; a hung replica is fenced and never serves a
  request twice.
- ``fleet_metrics`` byte-equal to JAX's on a fixture report,
  ``write_fleet_report`` equal to JAX's on a fixture ``BENCH_fleet.json``
  but for the script its prose names, ``run_trace`` taking a feed and a
  control, ``cli reports`` with a fleet result present, and ``cli serve
  --replicas 2`` on CPU ranks.
"""

import ast
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch.distributed as dist
import torch_serve_worker
from test_torch_serve import _jax_weights

from dlbb_tpu.comm import mesh as jax_mesh
from dlbb_tpu.models.configs import ModelConfig as JaxModelConfig
from dlbb_tpu.obs.export import fleet_metrics as jax_fleet_metrics
from dlbb_tpu.resilience import inject as jax_inject
from dlbb_tpu.serve import fleet as jax_fleet
from dlbb_tpu.serve.bench import run_serving as jax_run_serving
from dlbb_tpu.serve.engine import ServingConfig as JaxServingConfig
from dlbb_tpu.serve.traffic import Request as JaxRequest
from dlbb_tpu.serve.traffic import generate_trace as jax_generate_trace
from dlbb_tpu.stats.serving_report import write_fleet_report as jax_write_fleet_report
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.comm import mesh as pt_mesh
from dlbb_tpu_torch.models import ModelConfig
from dlbb_tpu_torch.obs.export import fleet_metrics
from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.serve import fleet
from dlbb_tpu_torch.serve.engine import ServingConfig, ServingEngine
from dlbb_tpu_torch.serve.traffic import Request, generate_trace
from dlbb_tpu_torch.stats.serving_report import write_fleet_report

REPO = Path(__file__).resolve().parents[1]

MODEL = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
             ffn_intermediate=128, dtype="float32", attention="full")
SERVING = dict(max_batch=8, block_size=8, max_seq=64, queue_capacity=64,
               hbm_budget_gb=None)

# JAX's SMOKE_CONFIG: 2 replicas x (dp=2 x tp=2) on its 8 simulated devices
SMOKE_CONFIG = {
    "experiment": {"name": "fleet_smoke"},
    "model": dict(MODEL),
    "parallelism": {"data_parallel": 2, "world_size": 2},
    "serving": dict(SERVING),
    "fleet": {"replicas": 2},
}
# the port's: 2 replicas x dp=2 on 4 gloo ranks
PORT_SMOKE_CONFIG = {**SMOKE_CONFIG, "parallelism": {"data_parallel": 2, "world_size": 1}}
SMOKE_TRACE = dict(kind="poisson", n=16, seed=5, rate=60.0, prompt_range=(4, 12),
                   output_range=(4, 8))
KILL_PLAN = "serve-replica-kill:@8"


class _Journal:
    """Captures journal lines like SweepJournal.event would."""

    def __init__(self):
        self.events = []

    def event(self, event, config=None, **extra):
        self.events.append({"event": event, "config": config, **extra})

    def of(self, kind):
        return [e for e in self.events if e["event"] == kind]

    def lines(self):
        """The events without tracebacks (each side's own file paths)."""
        return [{k: v for k, v in e.items() if k != "traceback"} for e in self.events]


class _Side:
    """One package's fleet and the modules its tests call.  JAX's replicas
    share the supervisor's process: a replica's control and feed are the
    supervisor's own objects."""

    def __init__(self, fleet_mod, request, inject_mod, model_cls, serving_cls, mesh_mod):
        self.fleet = fleet_mod
        self.Request = request
        self.inject = inject_mod
        self.mesh = mesh_mod
        self.model = model_cls.from_dict(MODEL)
        self.serving = serving_cls.from_dict(SERVING)
        self.Serving = serving_cls

    def sup(self, replicas=2, journal=None, serving=None, **fleet_kw):
        return self.fleet.FleetSupervisor(
            self.model, serving or self.serving,
            self.fleet.FleetConfig(replicas=replicas, **fleet_kw),
            meshes=[object()] * replicas, journal=journal)

    def req(self, rid, prompt=8, out=4, deadline=None, prefix_seed=None, prefix_len=None):
        return self.Request(rid=rid, arrival_s=0.0, prompt_len=prompt, output_len=out,
                            seed=100 + rid, deadline_s=deadline, prefix_seed=prefix_seed,
                            prefix_len=prefix_len)

    def replica(self, sup, idx):
        """Replica ``idx``'s control, after what the supervisor sent it
        arrived (a loop boundary's worth)."""
        return sup.controls[idx]

    def queue(self, sup, idx):
        """The requests replica ``idx``'s feed holds, in order."""
        return list(sup.feeds[idx])

    def same(self, a, b):
        """``a`` is the request ``b`` (the same object in one process)."""
        return a is b

    def feed_closed(self, sup, idx):
        return sup.feeds[idx].closed


class _PortSide(_Side):
    """The port's supervisor reaches its replicas through a mailbox: here
    on a ``HashStore``, each replica's leader a ``ReplicaControl`` in this
    process with its own handle on the store."""

    def __init__(self, *args):
        super().__init__(*args)
        self._leaders = {}

    def sup(self, replicas=2, journal=None, serving=None, **fleet_kw):
        return self.fleet.FleetSupervisor(
            self.model, serving or self.serving,
            self.fleet.FleetConfig(replicas=replicas, **fleet_kw),
            meshes=[object()] * replicas, journal=journal,
            mailbox=self.fleet._Mailbox(dist.HashStore()))

    def leader(self, sup, idx):
        """Replica ``idx``'s leader on ``sup``'s mailbox (one per replica)."""
        key = (id(sup), idx)
        if key not in self._leaders:
            box = self.fleet._Mailbox(sup._mailbox._store)
            self._leaders[key] = (sup, self.fleet.ReplicaControl(idx, box))
        return self._leaders[key][1]

    def replica(self, sup, idx):
        ctl = self.leader(sup, idx)
        ctl.beat()   # a loop boundary: the leader reads its mailbox
        return ctl

    def queue(self, sup, idx):
        return list(self.replica(sup, idx).feed)

    def same(self, a, b):
        # the request crossed the mailbox: a copy, every field equal
        return a == b and a is not b

    def feed_closed(self, sup, idx):
        return self.replica(sup, idx).feed.closed


JAX = _Side(jax_fleet, JaxRequest, jax_inject, JaxModelConfig, JaxServingConfig, jax_mesh)
PORT = _PortSide(fleet, Request, inject, ModelConfig, ServingConfig, pt_mesh)


def _both(scenario):
    """``scenario(side)`` on JAX's side and on the port's: the port's
    observations must equal JAX's."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want
    return got


def _counters(sup):
    return {name: {k: int(c[k]) for k in c} for name, c in (
        ("failovers", sup._failover_counter), ("hedges", sup._hedge_counter),
        ("degrade", sup._degrade_counter))}


# ---------------------------------------------------------------- feed


def _feed_semantics(side):
    feed = side.fleet.RequestFeed()
    assert bool(feed)            # open-but-empty: more work may come
    assert len(feed) == 0
    assert feed[0].arrival_s > 1e11 and feed[0].rid == -1  # horizon
    a, b, c = side.req(0), side.req(1), side.req(2)
    feed.push(a)
    feed.push(b)
    feed.push_front(c)           # failover re-admission jumps the line
    assert [r.rid for r in feed] == [2, 0, 1]
    assert feed[0].rid == 2
    with pytest.raises(IndexError):
        feed[1]                  # feeds only expose the head
    assert feed.discard(0) and not feed.discard(99)
    assert feed.popleft().rid == 2
    feed.close()
    with pytest.raises(RuntimeError):
        feed.push(side.req(3))
    with pytest.raises(RuntimeError):
        feed.push_front(side.req(3))
    assert feed.popleft().rid == 1
    assert not feed              # drained AND closed -> loop exits
    with pytest.raises(IndexError):
        feed[0]


def test_request_feed_semantics():
    _both(_feed_semantics)


def _control_heartbeat_and_kill(side):
    sup = side.sup(replicas=1)
    # the supervisor's end of the control, and the replica's
    theirs = sup.controls[0]
    ctl = side.replica(sup, 0)
    beats = ctl.beats
    ctl.beat()
    ctl.beat()
    assert ctl.started and ctl.beats == beats + 2 and ctl.beat_ema is not None
    ctl.check()                  # no kill flag, no active plan: no-op
    theirs.cancel(7, "hedge-lost")
    ctl = side.replica(sup, 0)
    assert ctl.take_cancels() == [(7, "hedge-lost")]
    assert ctl.take_cancels() == []
    theirs.request_kill("replica-hung")
    theirs.request_kill("second-reason-ignored")
    assert theirs.kill_reason == "replica-hung"
    ctl = side.replica(sup, 0)
    assert ctl.kill_reason == "replica-hung"
    with pytest.raises(side.fleet.ReplicaKilled, match="replica-hung") as e:
        ctl.check()              # fenced replica can never dispatch again
    return str(e.value)


def test_replica_control_heartbeat_and_kill():
    _both(_control_heartbeat_and_kill)


# -------------------------------------------------------------- config


def _config_roundtrip(side):
    cfg = side.fleet.FleetConfig.from_dict({"replicas": 3, "tick_s": 0.01})
    assert cfg.replicas == 3 and cfg.tick_s == 0.01
    assert side.fleet.FleetConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()
    with pytest.raises(ValueError, match="max_replicas") as e:
        side.fleet.FleetConfig.from_dict({"max_replicas": 3})
    return cfg.to_dict(), str(e.value)


def test_fleet_config_roundtrip_and_unknown_key():
    _both(_config_roundtrip)


@pytest.mark.parametrize("bad", [
    {"replicas": 0},
    {"heartbeat_factor": 0.5},
    {"heartbeat_min_s": 0.0},
    {"stall_timeout_s": -1.0},
    {"degrade_high_water": 0.0},
    {"tick_s": 0.0},
    {"hedge_min_completions": 0},
])
def test_fleet_config_validate_rejects(bad):
    def scenario(side):
        with pytest.raises(ValueError) as e:
            side.fleet.FleetConfig.from_dict(bad).validate()
        return str(e.value)

    _both(scenario)


def _admission_ladder(side):
    f = side.fleet
    messages = []

    def rejected(*args, match=None):
        with pytest.raises(ValueError, match=match) as e:
            f.validate_fleet(*args)
        messages.append(str(e.value))

    cfg = {"parallelism": {"data_parallel": 2, "world_size": 2}}
    assert f.validate_fleet(cfg, side.model, side.serving, f.FleetConfig(2), 8) == (2, 2)
    # rung 1: fleet knobs
    rejected(cfg, side.model, side.serving, f.FleetConfig(0), 8, match="replicas")
    # non-(dp, tp) axes rejected before any partitioning
    rejected({"parallelism": {"pipeline_parallel": 2}}, side.model, side.serving,
             f.FleetConfig(2), 8, match="pipeline_parallel")
    # rung 2: lopsided fleet
    rejected(cfg, side.model, side.serving, f.FleetConfig(3), 8,
             match="equal failure domains")
    # rung 3: per-replica plan outgrows its domain
    rejected({"parallelism": {"data_parallel": 2, "world_size": 4}}, side.model,
             side.serving, f.FleetConfig(2), 8, match="failure")
    # rung 4: per-replica serving envelope (each replica carries its OWN
    # full KV planes, so the HBM budget is checked per domain)
    tight = side.Serving.from_dict(dict(SERVING, hbm_budget_gb=1e-9))
    rejected(cfg, side.model, tight, f.FleetConfig(2), 8)
    return messages


def test_validate_fleet_admission_ladder():
    _both(_admission_ladder)


def test_validate_fleet_prices_the_shared_card():
    """The port's fifth rung: replicas that share a card are priced
    together against it (weights, cache and transient copies of every
    rank), and no replica's budget may claim more than its share."""
    model = ModelConfig.from_dict(dict(size="1B", attention="full", dtype="bfloat16"))
    cfg = {"parallelism": {"data_parallel": 1, "world_size": 1}}
    sv = ServingConfig.from_dict(dict(max_batch=16, block_size=16, max_seq=2048,
                                      hbm_budget_gb=36.0))
    need = fleet.rank_bytes(model, sv, 1, 1)
    assert need["kv_cache"] == 6 * 2 ** 30 and need["transient"] == 2 ** 30
    card = 80 * 10 ** 9
    assert fleet.validate_fleet(cfg, model, sv, fleet.FleetConfig(2), 2, card_bytes=card) == (1, 1)
    # four replicas of one rank on one card: their budgets overrun it
    with pytest.raises(ValueError, match="its share"):
        fleet.validate_fleet(cfg, model, sv, fleet.FleetConfig(4), 4, card_bytes=card)
    # without a budget, nine replicas' weights, caches and copies (9.25 GiB
    # each) overrun it
    free = ServingConfig.from_dict(dict(max_batch=16, block_size=16, max_seq=2048,
                                        hbm_budget_gb=None))
    with pytest.raises(ValueError, match="9 rank\\(s\\) on one card need"):
        fleet.validate_fleet(cfg, model, free, fleet.FleetConfig(9), 9, card_bytes=card)
    # the same eight over four cards: two to a card
    assert fleet.validate_fleet(cfg, model, free, fleet.FleetConfig(8), 8, card_bytes=card,
                                cards=4) == (1, 1)


def _partition(side):
    devs = [SimpleNamespace(id=i) for i in range(8)]
    groups = side.mesh.partition_devices(devs, 2)
    assert [[d.id for d in g] for g in groups] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="partition") as e:
        side.mesh.partition_devices(devs, 3)
    with pytest.raises(ValueError):
        side.mesh.partition_devices(devs, 0)
    rec = side.mesh.fault_domain_record(groups)
    assert rec == {"0": [0, 1, 2, 3], "1": [4, 5, 6, 7]}
    assert json.loads(json.dumps(rec)) == rec  # manifest-serialisable
    return rec, str(e.value)


def test_partition_devices_and_fault_domains():
    _both(_partition)
    # the port's devices are ranks: a replica's fault domain is its ranks
    groups = pt_mesh.partition_devices(list(range(8)), 4)
    assert pt_mesh.fault_domain_record(groups) == {
        "0": [0, 1], "1": [2, 3], "2": [4, 5], "3": [6, 7]}
    assert pt_mesh.available_devices() == [0]  # no process group: one rank


# ------------------------------------------------------------- routing


def _routing(side):
    reqs = [side.req(i) for i in range(6)]

    def route_all():
        sup = side.sup()
        for r in reqs:
            sup._route(r)
        return dict(sup._assign), list(sup._routed_count), sup

    a1, c1, sup = route_all()
    a2, c2, _ = route_all()
    assert a1 == a2 and c1 == c2  # same trace -> same routing table
    # equal-size requests alternate: least-loaded, ties to the lower id
    assert [a1[i] for i in range(6)] == [0, 1, 0, 1, 0, 1]
    assert c1 == [3, 3]
    assert [r.rid for r in side.queue(sup, 0)] == [0, 2, 4]
    assert sup._blocks[0] == sum(
        sup._blocks_for(r) for r in reqs if a1[r.rid] == 0)
    return a1, c1, list(sup._blocks)


@pytest.mark.fleet_smoke
def test_routing_deterministic_least_loaded():
    _both(_routing)


def _affinity(side):
    sup = side.sup()
    # two shared-prefix populations, interleaved arrivals
    reqs = [side.req(i, prefix_seed=7 if i % 2 == 0 else 9, prefix_len=4)
            for i in range(8)]
    for r in reqs:
        sup._route(r)
    homes = {seed: {sup._assign[r.rid] for r in reqs
                    if r.prefix_seed == seed} for seed in (7, 9)}
    assert all(len(h) == 1 for h in homes.values())  # group -> ONE home
    # first member of each group misses (homes the prefix), rest hit
    assert sup._affinity_misses == 2
    assert sup._affinity_hits == 6
    # a plain trace never touches the affinity counters
    plain = side.sup()
    for i in range(8):
        plain._route(side.req(i))
    assert plain._affinity_hits == 0 and plain._affinity_misses == 0
    # fencing the home purges its affinity: the group re-homes on the
    # survivor instead of chasing a dead replica
    home = next(iter(homes[7]))
    sup._fence(home, "replica-killed")
    sup._route(side.req(100, prefix_seed=7, prefix_len=4))
    assert sup._assign[100] != home
    assert sup._affinity[(7, 4)] == sup._assign[100]
    return dict(sup._assign), dict(sup._affinity), _counters(sup)


@pytest.mark.fleet_smoke
def test_prefix_affinity_colocates_groups():
    _both(_affinity)


def _no_replicas(side):
    j = _Journal()
    sup = side.sup(replicas=1, journal=j)
    sup._fence(0, "replica-crashed")
    sup._route(side.req(0))
    assert sup._terminal[0] == "failed[no-replica]"
    assert j.of("request-failed")[0]["reason"] == "no-replica"
    return j.lines()


def test_route_fails_closed_with_no_replicas():
    _both(_no_replicas)


# ------------------------------------------------------------ failover


def _failover(side):
    j = _Journal()
    sup = side.sup(journal=j)
    reqs = [side.req(i, deadline=2.5 + i) for i in range(4)]
    for r in reqs:
        sup._route(r)
    dead = [r for r in reqs if sup._assign[r.rid] == 0]
    survivors_before = [r.rid for r in side.queue(sup, 1)]
    sup._fence(0, "replica-killed", chain={"error": "ReplicaKilled: x"})

    assert sup._fenced[0] and sup._fence_reason[0] == "replica-killed"
    assert sup.feeds[0].closed
    assert sup.controls[0].kill_reason == "replica-killed"
    # the fenced replica sees its kill flag and its closed feed
    assert side.feed_closed(sup, 0)
    with pytest.raises(side.fleet.ReplicaKilled, match="replica-killed"):
        side.replica(sup, 0).check()
    # residents moved to the survivor's feed HEAD, ahead of its own queue
    # (they already served their wait on the dead replica): the SAME
    # Request objects, so arrival_s/deadline_s accounting is untouched
    queue = side.queue(sup, 1)
    moved = queue[:len(dead)]
    assert {r.rid for r in moved} == {r.rid for r in dead}
    assert all(any(side.same(m, r) for r in dead) for m in moved)
    assert [r.rid for r in queue][len(dead):] == survivors_before
    assert all(sup._assign[r.rid] == 1 for r in dead)
    assert sup._failover_rids == {r.rid for r in dead}
    assert int(sup._failover_counter["replica-killed"]) == len(dead)
    # block estimates migrated, none leaked on the fenced side
    assert sup._blocks[0] == 0
    assert sup._blocks[1] == sum(sup._blocks_for(r) for r in reqs)
    # journal: fence + one failover line per moved request, with the fence
    # reason AND the original error chain on every line
    assert j.of("replica-fenced")[0]["reason"] == "replica-killed"
    fo = j.of("request-failover")
    assert {e["config"] for e in fo} == {f"request-{r.rid}" for r in dead}
    assert all(e["from_replica"] == 0 and e["to_replica"] == 1
               and e["reason"] == "replica-killed"
               and "error" in e for e in fo)
    # fencing is idempotent: a second fence must not re-route
    sup._fence(0, "replica-killed")
    assert len(sup._failover_log) == len(dead)
    return j.lines(), [r.rid for r in side.queue(sup, 1)], _counters(sup), list(sup._blocks)


@pytest.mark.fleet_smoke
def test_failover_preserves_request_and_deadline():
    _both(_failover)


def _torn(side):
    j = _Journal()
    sup = side.sup(journal=j)
    reqs = [side.req(i) for i in range(4)]
    for r in reqs:
        sup._route(r)
    with side.inject.plan_scope("serve-failover-torn:1"):
        sup._fence(0, "replica-killed")
    torn = j.of("failover-torn")
    assert len(torn) == 1 and torn[0]["attempt"] == 1
    # the retry committed exactly once: no double-routed request, no leaked
    # block estimate from the rolled-back attempt
    rids = [r.rid for r in side.queue(sup, 1)]
    assert sorted(rids) == [0, 1, 2, 3] and len(set(rids)) == 4
    assert sup._blocks[1] == sum(sup._blocks_for(r) for r in reqs)
    assert len(sup._failover_log) == 2
    assert len({e["rid"] for e in sup._failover_log}) == 2
    return j.lines(), rids, sup._failover_log


def test_failover_torn_rolls_back_and_retries():
    _both(_torn)


def _orphans(side):
    # nowhere to fail over to: residents fail terminally, never hang
    j = _Journal()
    sup = side.sup(replicas=1, journal=j)
    sup._route(side.req(0, deadline=1.0))
    sup._fence(0, "replica-hung")
    assert sup._terminal[0] == "failed[replica-lost]"
    assert j.of("request-failed")[0]["reason"] == "replica-lost"
    assert len(sup._failover_log) == 0
    return j.lines(), dict(sup._terminal)


def test_failover_orphans_fail_closed():
    _both(_orphans)


# -------------------------------------------------------------- hedging


def _hedge(side):
    sup = side.sup()
    sup._route(side.req(0, out=4))
    assert sup._assign[0] == 0
    sup._hedged[0] = 1
    # hedge copy (replica 1) completes first -> hedge WON, primary copy
    # cancelled
    sup._handle_event(1, 0, "request-completed",
                      {"latency_s": 0.2, "tokens": [5, 6, 7, 8]})
    assert sup._terminal[0] == "completed"
    assert sup._completed_by[0] == 1
    assert sup._tokens[0] == [5, 6, 7, 8]
    assert int(sup._hedge_counter["won"]) == 1
    assert side.replica(sup, 0).take_cancels() == [(0, "hedge-lost")]
    # the loser's cancel arriving later must NOT overwrite the win
    sup._handle_event(0, 0, "request-canceled", {"reason": "hedge-lost"})
    assert sup._terminal[0] == "completed"
    # primary-wins mirror: loser is the hedge replica
    sup2 = side.sup()
    sup2._route(side.req(1))
    sup2._hedged[1] = 1
    sup2._handle_event(0, 1, "request-completed",
                       {"latency_s": 0.1, "tokens": [1]})
    assert int(sup2._hedge_counter["lost"]) == 1
    assert side.replica(sup2, 1).take_cancels() == [(1, "hedge-lost")]
    return _counters(sup), _counters(sup2), dict(sup._terminal), sup._e2e


def test_hedge_resolution_first_completion_wins():
    _both(_hedge)


# ------------------------------------------------------------- ladder


def _ladder(side):
    j = _Journal()
    sup = side.sup(journal=j)
    assert sup._level == 0 and side.fleet.DEGRADE_LEVELS[0] == "full"
    sup.degrade_to(2, "test overload")
    assert sup._level == 2
    # every level ENTERED is applied, journaled and counted: a jump from 0
    # to 2 walks through 1
    assert [e["name"] for e in j.of("degrade-transition")] == [
        "no-speculation", "short-horizon"]
    assert [rec["level"] for rec in sup._degrade_log] == [1, 2]
    replicas = [side.replica(sup, i) for i in range(2)]
    assert all(not c.spec_enabled for c in replicas)
    assert all(c.horizon_cap == 1 for c in replicas)
    assert int(sup._degrade_counter["no-speculation"]) == 1
    assert int(sup._degrade_counter["short-horizon"]) == 1
    # monotonic: the fleet never silently recovers a service class
    sup.degrade_to(1, "ignored")
    sup.degrade_to(2, "ignored")
    assert sup._level == 2 and len(sup._degrade_log) == 2
    with pytest.raises(ValueError, match="out of range"):
        sup.degrade_to(len(side.fleet.DEGRADE_LEVELS), "past the ladder")
    # level 3 sheds best-effort arrivals at the door, keeps SLO traffic
    sup.degrade_to(3, "capacity lost")
    sup._route(side.req(50))                       # no deadline -> shed
    sup._route(side.req(51, deadline=2.0))         # SLO class -> served
    assert sup._terminal[50] == "rejected[degraded-shed]"
    assert sup._shed == 1
    assert 51 in sup._assign and 51 not in sup._terminal
    shed = [e for e in j.of("request-rejected")
            if e["reason"] == "degraded-shed"]
    assert shed and shed[0]["config"] == "request-50"
    return j.lines(), _counters(sup), [(r["level"], r["name"]) for r in sup._degrade_log]


@pytest.mark.fleet_smoke
def test_degrade_ladder_monotonic_and_journaled():
    _both(_ladder)


# ------------------------------------------------- zero-injection pin


@pytest.mark.fleet_smoke
def test_fleet_is_host_side_only():
    """The zero-injection pin one level up, the port's: ``serve/fleet.py``
    imports neither ``jax`` nor the JAX package, reaches torch only through
    ``torch.distributed`` (its mailbox and its replicas' groups), and names
    no device-program API (no ``torch.cuda``, ``torch.compile``, CUDA
    graph or extension build), so every ``inject.fire`` site it adds (the
    replica kill and hang at the control plane's boundary, failover-torn in
    ``_fence``) is host-side by construction and the serving programs are
    the same with or without a fleet."""
    src = (REPO / "dlbb_tpu_torch" / "serve" / "fleet.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert not (alias.name == "jax" or alias.name.startswith("jax.")
                            or alias.name == "dlbb_tpu" or alias.name.startswith("dlbb_tpu.")), \
                    f"fleet.py imports {alias.name}"
                assert alias.name in ("torch.distributed",) or not alias.name.startswith("torch"), \
                    f"fleet.py imports {alias.name}"
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            assert not (mod == "jax" or mod.startswith("jax.") or mod == "dlbb_tpu"
                        or mod.startswith("dlbb_tpu.")), f"fleet.py: from {mod} import ..."
            assert not (mod == "torch" or mod.startswith("torch.")), \
                f"fleet.py: from {mod} import ..."
        name = (node.id if isinstance(node, ast.Name)
                else node.attr if isinstance(node, ast.Attribute) else None)
        assert name not in ("jit", "pjit", "shard_map", "pallas_call", "cuda", "compile",
                            "CUDAGraph", "graph", "cpp_extension", "load_inline", "triton"), \
            f"device-program API {name!r} found in fleet.py"


# ------------------------------------------------- engine integration


def _trace(side_generate):
    spec = dict(SMOKE_TRACE)
    return side_generate(spec.pop("kind"), spec.pop("n"), **spec)


@pytest.fixture(scope="module")
def kill_runs(tmp_path_factory, devices):
    """ONE oracle and ONE killed fleet on each side, shared by the smokes
    below: JAX's ``SMOKE_CONFIG`` on its simulated devices; the port's 2
    replicas x dp=2 on 4 gloo ranks with JAX's weights, every collective
    watched (``tests/torch_serve_worker.py::fleet_rank_watched``)."""
    single = {k: v for k, v in SMOKE_CONFIG.items() if k != "fleet"}
    jtrace = _trace(jax_generate_trace)
    joracle = jax_run_serving(single, jtrace, verbose=False, devices=devices[:4],
                              journal=False, capture_tokens=True)
    jrep = jax_fleet.run_fleet(SMOKE_CONFIG, jtrace,
                               output_dir=str(tmp_path_factory.mktemp("jax_fleet")),
                               verbose=False, journal=True, fault_plan=KILL_PLAN,
                               capture_tokens=True)
    # the port's replicas and oracle on the weights JAX's engines drew from
    # seed 0, carried across
    weights = _jax_weights(MODEL, 0)
    trace = _trace(generate_trace)
    port_single = {k: v for k, v in PORT_SMOKE_CONFIG.items() if k != "fleet"}
    oracle = launch(torch_serve_worker.serve_oracle, 2, "cpu",
                    args=(port_single, trace, weights), timeout=300)[0]
    out = tmp_path_factory.mktemp("fleet")
    ranks = fleet.launch_fleet(torch_serve_worker.fleet_rank_watched, PORT_SMOKE_CONFIG,
                               trace, output_dir=str(out), verbose=False, journal=True,
                               fault_plan=KILL_PLAN, capture_tokens=True, device="cpu",
                               timeout=300, weights=weights)
    return SimpleNamespace(joracle=joracle, jrep=jrep, oracle=oracle, rep=ranks[0]["report"],
                           ranks=ranks, out=out)


@pytest.mark.fleet_smoke
def test_fleet_smoke_kill_failover_token_identity(kill_runs):
    """The headline contract: kill a replica mid-trace; every request still
    completes, failed-over requests re-prefill on the survivor, and the
    completed tokens are the single-engine oracle's (greedy decode depends
    only on (params seed, request), and every replica initialises from the
    same seed), and JAX's."""
    oracle, rep = kill_runs.oracle, kill_runs.rep

    fenced = [r for r in rep["replicas"]
              if r["fence_reason"] == "replica-killed"]
    assert len(fenced) == 1, rep["replicas"]
    outcomes = rep["requests"]["outcomes"]
    assert all(v == "completed" for v in outcomes.values()), outcomes
    assert rep["failovers"]["total"] >= 1
    assert all(r["reason"] == "replica-killed"
               for r in rep["failovers"]["requests"])
    assert rep["failover_ttft_penalty_s"] is not None
    assert rep["completed_tokens"] == oracle["completed_tokens"]
    # the survivor drained clean: nothing the failovers attached leaked
    ok = [r for r in rep["replicas"] if r["status"] == "ok"]
    assert ok and ok[0]["report"]["cache"]["blocks_reserved"] == 0
    # JAX's side, on the same trace: the same tokens, the same report keys
    jrep = kill_runs.jrep
    assert jrep["completed_tokens"] == kill_runs.joracle["completed_tokens"]
    assert rep["completed_tokens"] == jrep["completed_tokens"]
    assert set(rep) == set(jrep)
    assert set(rep["fleet"]) == set(jrep["fleet"])


@pytest.mark.fleet_smoke
def test_fleet_smoke_artifact_family(kill_runs):
    """The fleet run writes the full serving artifact family with the fleet
    markers the reports key on: fleet_<name>.json (schema
    dlbb_fleet_report_v1), a manifest with kind=fleet + fault_domains (each
    replica's ranks), the shared journal with per-replica tracks + the
    failover record, and metrics.prom with the failover/hedge/degrade
    counter families."""
    rep, out = kill_runs.rep, kill_runs.out
    assert rep["schema"] == "dlbb_fleet_report_v1"
    assert rep["fleet"]["fault_domains"] == {"0": [0, 1], "1": [2, 3]}
    assert rep["topology"]["fault_domains"] == rep["fleet"]["fault_domains"]

    art = json.loads((out / "fleet_fleet_smoke.json").read_text())
    assert art["schema"] == "dlbb_fleet_report_v1"
    manifest = json.loads((out / "serving_manifest.json").read_text())
    assert manifest["kind"] == "fleet"
    assert manifest["fault_domains"] == rep["fleet"]["fault_domains"]
    assert manifest["failovers"] == rep["failovers"]["total"] >= 1
    assert manifest["degrade_level"] == rep["degrade"]["level"]

    prom = (out / "metrics.prom").read_text()
    for family in ("serve_failovers_total", "serve_hedges_total",
                   "serve_degrade_transitions_total",
                   "serve_replica_resident_requests",
                   "serve_fleet_live_replicas"):
        assert family in prom, f"{family} missing from metrics.prom"
    assert 'serve_failovers_total{reason="replica-killed"}' in prom

    lines = [json.loads(ln) for ln in
             (out / "sweep_journal.jsonl").read_text().splitlines()]
    ups = [e for e in lines if e.get("event") == "replica-up"]
    assert {e["replica"] for e in ups} == {0, 1}
    fenced = [e for e in lines if e.get("event") == "replica-fenced"]
    assert fenced and fenced[0]["reason"] == "replica-killed"
    fo = [e for e in lines if e.get("event") == "request-failover"]
    assert len(fo) == rep["failovers"]["total"]
    # every replica's lifecycle lines reach the one journal on its track
    done = [e for e in lines if e.get("event") == "request-completed"]
    assert {e["replica"] for e in done} <= {0, 1} and len(done) >= len(kill_runs.oracle[
        "completed_tokens"])


@pytest.mark.fleet_smoke
def test_killed_replica_ranks_die_together_off_the_world_group(kill_runs):
    """At 2 replicas x dp=2: both ranks of the killed replica raise
    ``ReplicaKilled`` at the same loop boundary (its leader's verdict,
    broadcast over the replica's group), the survivor's ranks complete,
    and every collective of the run went over a replica's own group, never
    the world's."""
    records = [r["replica"] for r in kill_runs.ranks]
    killed = [r for r in records if r["outcome"] == "replica-killed"]
    fenced = [r["replica"] for r in kill_runs.rep["replicas"] if r["status"] == "fenced"]
    assert len(killed) == 2 and {r["replica"] for r in killed} == set(fenced)
    assert killed[0]["boundary"] == killed[1]["boundary"] >= 1
    assert all(r["outcome"] == "completed" for r in records if r["replica"] not in fenced)
    assert sorted(r["rank"] for r in records) == [0, 1, 2, 3]
    for r in kill_runs.ranks:
        assert r["collectives"] > 0 and r["world_collectives"] == [], r


@pytest.mark.parametrize("replicas,dp,world", [(1, 1, 2), (2, 2, 6)])
def test_launch_with_a_rank_outside_every_mesh_is_refused(tmp_path, replicas, dp, world):
    """Every rank of a fleet is in its replica's mesh: a launch of more than
    replicas x dp x tp ranks (one more, or one more per replica) is refused
    on every rank before any engine starts, since a rank outside the mesh
    would lead a second engine on the replica's mailbox and serve every
    request again."""
    config = {"model": dict(MODEL), "serving": dict(SERVING),
              "parallelism": {"data_parallel": dp, "world_size": 1},
              "fleet": {"replicas": replicas}}
    fleet.validate_fleet(config, PORT.model, PORT.serving, fleet.FleetConfig(replicas),
                         replicas * dp)
    with pytest.raises(Exception, match="every rank must be in its replica's mesh"):
        launch(fleet.fleet_rank, world, "cpu", shared=True, timeout=120,
               args=(config, _trace(generate_trace), str(tmp_path), False, False, None, True,
                     "cpu", str(tmp_path / "mailbox")))
    assert not list(tmp_path.glob("fleet_*.json"))


def test_hung_replica_is_fenced_and_never_double_serves(tmp_path):
    """``serve-replica-hang`` (counted fleet-wide) parks one replica's loop
    past its heartbeat deadline: the supervisor fences it as
    ``replica-hung`` and fails its residents over, and when it wakes its
    next boundary reads the kill flag and raises ``ReplicaKilled``, so it
    serves nothing after the fence.  Every request completes once, with the
    single engine's tokens (two one-rank replicas, weights from the same
    seed)."""
    config = {"experiment": {"name": "fleet_hang"}, "model": dict(MODEL),
              "parallelism": {"data_parallel": 1, "world_size": 1},
              "serving": dict(SERVING),
              "fleet": {"replicas": 2, "heartbeat_min_s": 0.5, "heartbeat_factor": 4.0}}
    trace = _trace(generate_trace)
    engine = ServingEngine(ModelConfig(**MODEL), ServingConfig(**SERVING), verbose=False,
                           capture_tokens=True, device="cpu")
    oracle = engine.run_trace(trace)
    ranks = fleet.launch_fleet(fleet.fleet_rank, config, trace, output_dir=str(tmp_path),
                               verbose=False, fault_plan="serve-replica-hang:@6,hang_seconds=3",
                               capture_tokens=True, device="cpu", timeout=300)
    rep = ranks[0]["report"]
    fenced = [r for r in rep["replicas"] if r["status"] == "fenced"]
    assert [r["fence_reason"] for r in fenced] == ["replica-hung"]
    assert set(rep["requests"]["outcomes"].values()) == {"completed"}
    assert rep["completed_tokens"] == oracle["completed_tokens"]
    assert rep["failovers"]["by_reason"]["replica-hung"] == rep["failovers"]["total"] >= 1
    hung = fenced[0]["replica"]
    assert ranks[hung]["replica"]["outcome"] == "replica-killed"
    lines = [json.loads(ln) for ln in (tmp_path / "sweep_journal.jsonl").read_text().splitlines()]
    done = [e for e in lines if e.get("event") == "request-completed"]
    # once each: nothing the hung replica held completed there after the fence
    assert sorted(e["config"] for e in done) == sorted(f"request-{r.rid}" for r in trace)


# ------------------------------------------------- the engine's hooks


def test_run_trace_takes_a_feed_and_a_control():
    """The replica hooks, once refused: the engine drains a supervisor's
    feed (a closed feed ends the run), beats and checks the control at
    every loop boundary, and a kill flag raises ``ReplicaKilled`` there."""
    cfg = ModelConfig(**MODEL)
    sv = ServingConfig(**SERVING)
    trace = generate_trace("poisson", 4, seed=3, rate=1000.0, prompt_range=(4, 8),
                           output_range=(2, 4))
    engine = ServingEngine(cfg, sv, verbose=False, capture_tokens=True, device="cpu")
    oracle = engine.run_trace(trace)
    sup = PORT.sup(replicas=1)
    ctl = PORT.leader(sup, 0)
    events = []
    ctl.on_event = lambda rid, event, extra: events.append((rid, event))
    for r in trace:
        sup.feeds[0].push(r)
    sup.feeds[0].close()
    sup._mailbox.set_float(fleet._T0_KEY, time.perf_counter())  # the clock gate
    report = engine.run_trace(trace, feed=ctl.feed, control=ctl)
    assert report["completed_tokens"] == oracle["completed_tokens"]
    assert ctl.beats >= 1 and not ctl.feed
    assert {e for _r, e in events} >= {"request-arrived", "request-prefill",
                                       "request-completed"}
    sup = PORT.sup(replicas=1)
    killed = PORT.leader(sup, 0)
    sup.controls[0].request_kill("replica-hung")
    sup._mailbox.set_float(fleet._T0_KEY, time.perf_counter())
    with pytest.raises(fleet.ReplicaKilled, match="replica-hung"):
        engine.run_trace(trace, feed=killed.feed, control=killed)


# ------------------------------------------------- metrics, report, cli


FLEET_REPORT = {
    "goodput_tokens_per_s": 812.5, "wall_seconds": 3.25,
    "fleet": {"replicas": 2},
    "failovers": {"total": 3, "by_reason": {"replica-killed": 3, "replica-hung": 0,
                                            "replica-crashed": 0}},
    "hedges": {"issued": 2, "won": 1, "lost": 1},
    "degrade": {"level": 2, "transitions": [{"level": 1, "name": "no-speculation"},
                                            {"level": 2, "name": "short-horizon"}]},
    "routing": {"prefix_affinity_hits": 6, "prefix_affinity_misses": 2},
    "requests": {"completed": 14, "failed": 1, "rejected": 1, "canceled": 0, "shed": 1},
    "ttft": {"median": 0.125, "p95": 0.5, "p99": 0.75, "p999": 0.875},
    "failover_ttft_penalty_s": 0.0625,
}


def test_fleet_metrics_byte_equal_to_jax(tmp_path):
    """``fleet_metrics`` folds a fleet report into ``metrics.prom`` as
    JAX's does, byte for byte, into a fresh registry and into one that
    already carries live counters."""
    assert fleet_metrics(FLEET_REPORT).to_prometheus() \
        == jax_fleet_metrics(FLEET_REPORT).to_prometheus()
    live, jlive = PORT.sup(), JAX.sup()
    for sup in (live, jlive):
        sup._failover_counter["replica-killed"] += 3
        sup._export_gauges()
    got = fleet_metrics(FLEET_REPORT, registry=live.registry)
    want = jax_fleet_metrics(FLEET_REPORT, registry=jlive.registry)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.write_textfile(tmp_path / "metrics.prom").read_text() == want.to_prometheus()


BENCH_FLEET = {
    "harness": "scripts/torch_bench_fleet.py", "schema": "dlbb_bench_fleet_v1",
    "fleet": {"replicas": 2}, "trace": {"kind": "poisson", "requests": 48, "seed": 7},
    "settings": {
        "single": {"goodput_tokens_per_s": {"median": 900.0, "min": 880.5, "max": 910.25},
                   "ttft_p50_ms": 120.5, "ttft_p99_ms": 410.25, "token_identical": True},
        "fleet_clean": {"goodput_tokens_per_s": {"median": 1500.0, "min": 1450.0,
                                                 "max": 1530.0},
                        "ttft_p50_ms": 90.0, "ttft_p99_ms": 300.0, "token_identical": True},
        "fleet_kill": {"goodput_tokens_per_s": {"median": 1100.0, "min": 1000.0,
                                                "max": 1200.0},
                       "ttft_p50_ms": 150.0, "ttft_p99_ms": 900.0,
                       "failovers": {"median": 6}, "token_identical": True},
    },
    "failover": {"ttft_penalty_ms": {"median": 250.5, "min": 200.0, "max": 300.0},
                 "failovers_per_run": {"median": 6},
                 "goodput_retained_vs_clean_fleet": 0.733},
}


def test_write_fleet_report_equal_to_jax(tmp_path):
    """``FLEET.md`` from a fixture ``BENCH_fleet.json``: JAX's but for the
    script its prose names; the same rows; a missing artifact writes
    nothing."""
    bench = tmp_path / "BENCH_fleet.json"
    bench.write_text(json.dumps(BENCH_FLEET))
    rows = write_fleet_report(bench, tmp_path / "port")
    want = jax_write_fleet_report(bench, tmp_path / "jax")
    assert rows == want and len(rows) == 3
    got = (tmp_path / "port" / "FLEET.md").read_text()
    assert "scripts/torch_bench_fleet.py" in got
    assert got.replace("scripts/torch_bench_fleet.py", "scripts/bench_fleet.py") \
        == (tmp_path / "jax" / "FLEET.md").read_text()
    assert write_fleet_report(tmp_path / "missing.json", tmp_path / "none") == []
    assert not (tmp_path / "none").exists()


def test_cli_reports_with_a_fleet_result(tmp_path, capsys, kill_runs):
    """``cli reports`` over a results tree holding a fleet result and the
    port's ``BENCH_fleet.json``: the fleet row in ``SERVING.md`` and
    ``FLEET.md`` beside it, nothing refused."""
    from dlbb_tpu_torch import cli

    results = tmp_path / "results"
    (results / "serving").mkdir(parents=True)
    (results / "serving" / "fleet_smoke.json").write_text(
        (kill_runs.out / "fleet_fleet_smoke.json").read_text())
    (results / "BENCH_fleet.json").write_text(json.dumps(BENCH_FLEET))
    assert cli.main(["reports", "--stats", str(tmp_path / "stats"),
                     "--results", str(results)]) == 0
    printed = capsys.readouterr().out
    assert "serving: 1 run(s)" in printed and "fleet: 3 setting(s)" in printed
    serving_md = (tmp_path / "stats" / "serving" / "SERVING.md").read_text()
    # the row of fleet_smoke.json, with its replicas and failovers
    row = next(ln for ln in serving_md.splitlines() if ln.startswith("| smoke |"))
    assert f"| 2 | {kill_runs.rep['failovers']['total']} (" in row
    assert (tmp_path / "stats" / "serving" / "FLEET.md").is_file()


def test_cli_serve_replicas_on_cpu_ranks(tmp_path, capsys):
    """``cli serve --replicas 2 --device cpu``: two one-rank replicas on two
    gloo ranks, every request served, the fleet's artifact set written."""
    from dlbb_tpu_torch import cli

    out = tmp_path / "f"
    assert cli.main(["serve", "--device", "cpu", "--replicas", "2", "--requests", "6",
                     "--rate", "200", "--max-seq", "64", "--output", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "fleet: 2/2 replica(s) healthy, 0 failover(s)" in printed
    result = json.loads((out / "fleet_fleet2_poisson_6req_seed42.json").read_text())
    assert result["requests"]["completed"] == 6
    assert result["fleet"]["fault_domains"] == {"0": [0], "1": [1]}
    assert result["mesh"]["dp"] == result["mesh"]["tp"] == 1
    assert result["backend"] == "torch_cpu"
    manifest = json.loads((out / "serving_manifest.json").read_text())
    assert manifest["kind"] == "fleet"
    for name in ("metrics.prom", "sweep_journal.jsonl", "trace_fleet2_poisson_6req_seed42.json"):
        assert (out / name).is_file(), name
