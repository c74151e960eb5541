"""The port's checkpoint/resume, integrity manifests and graceful preemption
(``train/checkpoint.py``, ``resilience/{inject,preempt}.py``, their wiring in
``train/loop.py::run_train``) against the JAX package's contract.

- save, restore and continue through ``run_train`` at world 4 (dp=2 x tp=2,
  ZeRO-1, 4 gloo ranks): the resumed run's losses and its last checkpoint
  are equal, bit for bit, to those of an uninterrupted run;
- ``ckpt-corrupt`` on one rank: every rank's ``restore`` of the step raises
  ``CheckpointCorruption`` and every rank's ``restore_or`` falls back to the
  step before;
- ``preempt:@3``: ``run_train`` stops before its third timed step, returns
  JAX's keys, and the next run resumes from the saved step; on 4 ranks a
  SIGTERM to one rank stops them all at the same step;
- the plan parser against JAX's on the grammar's examples.
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch_train_worker

from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu.resilience import inject as jax_inject
from dlbb_tpu.train import loop as jax_loop
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.models import ModelConfig, init_params
from dlbb_tpu_torch.resilience import CheckpointCorruption
from dlbb_tpu_torch.resilience import inject
from dlbb_tpu_torch.train import loop as pt_loop
from dlbb_tpu_torch.train import optim as pt_optim
from dlbb_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

torch.set_num_threads(1)

MODEL = {"hidden_size": 32, "num_layers": 2, "num_heads": 4, "ffn_intermediate": 64,
         "attention": "full", "dtype": "float32"}


def _config(dp=1, tp=1, warmup=1, iters=3, **training):
    return {"experiment": {"name": "ckpt_smoke"}, "model": dict(MODEL),
            "parallelism": {"world_size": tp, "data_parallel": dp},
            "input": {"batch_size": 2 * dp, "sequence_length": 16, "seed": 42},
            "execution": {"warmup_iterations": warmup, "benchmark_iterations": iters},
            "training": {"learning_rate": 1e-3, "zero_stage": 1, **training}}


def test_resume_at_world_4_continues_bit_for_bit(tmp_path):
    """2 timed steps, then 2 more resumed from the checkpoint, against 5 in
    one run (each run's first step is its warmup): the resumed run starts
    from step 3 on every rank, and its losses and its checkpoint at step 6
    equal the uninterrupted run's, bit for bit."""
    runs = launch(torch_train_worker.run_train_resume, 4, "cpu",
                  args=(_config(dp=2, tp=2), str(tmp_path / "resume"),
                        str(tmp_path / "straight"), (2, 2)),
                  timeout=300, group_timeout=60)
    for first, second, straight, files in runs:
        assert first["resumed_from_step"] is None and first["final_step"] == 3
        assert second["resumed_from_step"] == 3 and second["final_step"] == 6
        assert straight["final_step"] == 6 and straight["mesh"]["dp"] == 2
        assert second["losses"] == straight["losses"][-2:]
        assert second["losses"] == runs[0][1]["losses"]
        a, b = files.values()
        assert len(a) == len(b) > 28
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y)
            else:
                assert x == y
    # max_to_keep=2: steps 5 and 6 are left, with their manifests
    assert sorted(p.name for p in (tmp_path / "resume").iterdir()) == [".integrity", "5", "6"]
    assert sorted(p.name for p in (tmp_path / "resume" / ".integrity").iterdir()) == ["5", "6"]
    layout = json.loads((tmp_path / "resume" / "6" / "layout.json").read_text())
    assert layout == {"mesh": {"dp": 2, "sp": 1, "pp": 1, "ep": 1, "tp": 2},
                      "zero_stage": 1, "world_size": 4, "step": 6}


def test_corrupt_step_is_refused_on_every_rank(tmp_path):
    w = jax.tree.map(np.asarray, jax_tf.init_params(
        jax_configs.ModelConfig(**MODEL), jax.random.key(0)))
    results = launch(torch_train_worker.run_corrupt_restore, 4, "cpu",
                     args=(MODEL, w, str(tmp_path)), timeout=300, group_timeout=60)
    for rank, (error, restored, intact, verdict) in enumerate(results):
        assert error == "CheckpointCorruption"
        assert restored == 2 and intact == 2
        # rank 0's file was rotted; the others' verify alone, and are
        # refused by the agreement
        assert verdict[0] == (rank != 0)
        if rank == 0:
            assert "mismatch" in verdict[1]


def test_checkpointer_alone_saves_at_its_interval_and_refuses_another_layout(tmp_path):
    cfg = ModelConfig(**MODEL)
    step, state = pt_loop.make_train_step(cfg, pt_optim.build_optimizer({}),
                                          init_params(cfg, 0, "cpu"))
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path), save_interval_steps=2,
                                         max_to_keep=2), layout={"zero_stage": 0})
    saved = []
    for s in range(1, 6):
        saved.append(ckpt.maybe_save(state._replace(step=s)))
    assert saved == [False, True, False, True, False]
    assert ckpt.maybe_save(state._replace(step=5), force=True)
    assert not ckpt.maybe_save(state._replace(step=5), force=True)  # on disk already
    assert ckpt.all_steps() == [4, 5] and ckpt.latest_step() == 5
    assert ckpt.verify_step(5) == (True, "ok")
    restored = ckpt.restore(state)
    assert restored.step == 5
    for a, b in zip(pt_optim.tree_leaves(restored.params), pt_optim.tree_leaves(state.params)):
        assert torch.equal(a, b) and a.requires_grad
    other = Checkpointer(CheckpointConfig(str(tmp_path)), layout={"zero_stage": 1})
    with pytest.raises(ValueError, match="restores only onto the mesh and ZeRO stage"):
        other.restore(state)
    with pytest.raises(ValueError, match="restores only onto"):
        other.restore_or(state)
    with inject.plan_scope("ckpt-corrupt:@1"):
        assert ckpt.maybe_save(state._replace(step=6))
    with pytest.raises(CheckpointCorruption, match="step 6 .* checksum mismatch|size mismatch"):
        ckpt.restore(state)
    assert ckpt.restore_or(state._replace(step=0)).step == 5


def _jax_preempted(tmp_path, plan, devices):
    config = _config(iters=4)
    config["training"]["checkpoint"] = {"directory": str(tmp_path / "jax")}
    with jax_inject.plan_scope(plan):
        return jax_loop.run_train(config, verbose=False)


@pytest.mark.parametrize("plan", ["preempt:@3", "preempt:@1"])
def test_preemption_returns_the_jax_result_and_resumes(tmp_path, monkeypatch, devices, plan):
    """``DLBB_FAULT_PLAN`` drives the ``preempt`` site: @3 stops after two
    timed steps (a result with ``preempted`` set), @1 before any (the
    resume point only, no benchmark).  The keys are JAX's (the port's
    result adds its device, launch counts and the per-rank means); the next
    run resumes from the forced final save."""
    ref = _jax_preempted(tmp_path, plan, devices)
    config = _config(iters=4)
    config["training"]["checkpoint"] = {"directory": str(tmp_path / "port")}
    monkeypatch.setenv(inject.ENV_VAR, plan)
    got = pt_loop.run_train(config, device="cpu", verbose=False)
    assert inject.active() is None
    extra = {"device", "kernel_launches_per_step", "per_host_means_s",
             "cross_host_variance", "cross_host_cv"}
    assert set(got) - extra == set(ref)
    for key in ("preempted", "preempted_at_step", "final_step", "resumed_from_step", "mode"):
        assert got[key] == ref[key], key
    timed = int(plan[-1]) - 1
    assert got["preempted"] and got["preempted_at_step"] == 1 + timed
    assert len(got["losses"]) == timed
    monkeypatch.delenv(inject.ENV_VAR)
    resumed = pt_loop.run_train(config, device="cpu", verbose=False)
    assert resumed["resumed_from_step"] == 1 + timed and not resumed["preempted"]
    assert resumed["final_step"] == 1 + timed + 1 + 4


def test_sigterm_to_one_rank_stops_every_rank_at_the_same_step(tmp_path):
    results = launch(torch_train_worker.run_preempted, 4, "cpu",
                     args=(_config(dp=2, tp=2, iters=5), str(tmp_path), 3),
                     timeout=300, group_timeout=60)
    assert [r["preempted_at_step"] for r in results] == [3] * 4
    assert all(r["preempted"] and len(r["losses"]) == 2 for r in results)
    assert sorted(p.name for p in tmp_path.iterdir()) == [".integrity", "2", "3"]


GRAMMAR = ["exec-transient", "exec-transient:2", "stats-nan:@2",
           "exec-transient:p0.5,seed=7", "exec-hang:@1,hang_seconds=5",
           "preempt:*", "ckpt-corrupt:@3,preempt:1", "serve-decode-fail:p0.25,seed=3",
           " torn-write:@2 , torn_fraction=0.5 "]


@pytest.mark.parametrize("spec", GRAMMAR)
def test_plan_parser_matches_jax(spec):
    mine, ref = inject.FaultPlan.parse(spec), jax_inject.FaultPlan.parse(spec)
    assert mine.params == ref.params and mine.spec == ref.spec
    assert {k: vars(v) for k, v in mine.sites.items()} == \
        {k: vars(v) for k, v in ref.sites.items()}
    for site in inject.SITES:
        assert [mine.fire(site) for _ in range(24)] == [ref.fire(site) for _ in range(24)]
        assert mine.param("hang_seconds") == ref.param("hang_seconds")
    assert mine.fired == ref.fired


@pytest.mark.parametrize("spec", ["no-such-site", "exec-transient:p1.5", "flavour=3",
                                  "exec-transient:x"])
def test_plan_parser_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jax_inject.FaultPlan.parse(spec)
    with pytest.raises(ValueError):
        inject.FaultPlan.parse(spec)


def test_sites_and_defaults_are_jax_s():
    assert inject.SITES == jax_inject.SITES
    assert inject.ENV_VAR == jax_inject.ENV_VAR == "DLBB_FAULT_PLAN"
    assert inject.fire("preempt") is False and inject.active() is None
