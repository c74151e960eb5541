"""Parallelism-plan resolution for the E2E and train harnesses
(counterpart of ``dlbb_tpu/parallel/plan.py``).

One place that parses the YAML ``parallelism:`` section, runs every
validation of the JAX plan with its messages (the device preflight, the
reference's ``run_mpi.py:73-77``; attention/sp, MoE/ep, ``tp_overlap``;
the pipeline's divisibility through ``pipeline.validate_pipeline``, which
also resolves ``num_microbatches``, and ``num_microbatches`` without a
pipeline), then the parameter dimensions that tp does not divide, which
JAX's pjit refuses (``configs.validate_tp_shards``), and builds the
process-group mesh in JAX's axis order ``(dp[, sp][, pp][, ep], tp)``.  The devices are
the ranks of the default process group, one device per rank; without a
process group there is one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

from dlbb_tpu_torch.comm.mesh import Mesh, build_parallelism_mesh
from dlbb_tpu_torch.models.configs import (
    ModelConfig,
    validate_attention_parallelism,
    validate_expert_parallelism,
    validate_tp_overlap,
    validate_tp_shards,
)
from dlbb_tpu_torch.parallel.pipeline import validate_pipeline

def degrees(config: dict[str, Any]) -> tuple[int, int, int, int, int]:
    """``(dp, sp, pp, ep, tp)`` from the YAML ``parallelism:`` section
    (``world_size`` is the tp degree, the reference's)."""
    par = config.get("parallelism", {}) or {}
    return (par.get("data_parallel", 1), par.get("sequence_parallel", 1),
            par.get("pipeline_parallel", 1), par.get("expert_parallel", 1),
            par.get("world_size", 1))


def microbatches(config: dict[str, Any], model_cfg: ModelConfig) -> Optional[int]:
    """The plan's ``num_microbatches``: resolved by ``validate_pipeline``
    (its checks and messages; default one per stage) where pp is above 1,
    else the raw field (None unless a config sets it without a pipeline,
    which ``check_plan`` refuses)."""
    num_microbatches = (config.get("parallelism", {}) or {}).get("num_microbatches")
    pp = degrees(config)[2]
    if pp > 1:
        return validate_pipeline(model_cfg, pp, config["input"]["batch_size"],
                                 num_microbatches)
    return num_microbatches


def check_plan(config: dict[str, Any], model_cfg: ModelConfig,
               n_avail: int) -> tuple[int, int, int, int, int]:
    """Every check of the JAX plan, with its messages, on ``n_avail``
    devices, then the port's own refusals; returns ``(dp, sp, pp, ep, tp)``."""
    dp, sp, pp, ep, tp = degrees(config)
    needed = tp * dp * sp * pp * ep
    if needed > n_avail:
        raise ValueError(
            f"config needs {needed} devices (tp={tp} x dp={dp} x "
            f"sp={sp} x pp={pp} x ep={ep}), only {n_avail} available"
        )

    validate_attention_parallelism(model_cfg, sp)
    validate_expert_parallelism(model_cfg, ep)
    validate_tp_overlap(
        model_cfg, tp, pp=pp, sp=sp,
        seq_len=config.get("input", {}).get("sequence_length", 0),
    )
    m = microbatches(config, model_cfg)
    if pp <= 1 and m is not None:
        raise ValueError(
            "parallelism.num_microbatches requires "
            "pipeline_parallel > 1 (microbatching is the pipeline's "
            "schedule; without pp it would silently be ignored)"
        )
    validate_tp_shards(model_cfg, tp)
    if n_avail > needed:
        raise ValueError(
            f"{n_avail} ranks in the process group, the config's mesh has "
            f"{needed}: the port runs one rank per mesh position")
    return dp, sp, pp, ep, tp


@dataclass(frozen=True)
class ParallelismPlan:
    dp: int
    sp: int
    pp: int
    ep: int
    tp: int
    # the pipeline's microbatch count where pp is above 1, else None
    num_microbatches: Optional[int]
    # None without a process group (world 1, no torch.distributed at all)
    mesh: Optional[Mesh]

    @classmethod
    def from_config(cls, config: dict[str, Any],
                    model_cfg: ModelConfig) -> "ParallelismPlan":
        """Check ``config`` against the world (``check_plan``) and build
        its mesh; without a process group, on one device, the mesh is
        None."""
        n_avail = dist.get_world_size() if dist.is_initialized() else 1
        dp, sp, pp, ep, tp = check_plan(config, model_cfg, n_avail)
        mesh = (build_parallelism_mesh(dp, sp, pp, tp, ep)
                if dist.is_initialized() else None)
        return cls(dp, sp, pp, ep, tp, microbatches(config, model_cfg), mesh)

    def mesh_dict(self) -> dict[str, int]:
        """The result-JSON ``mesh`` field."""
        return {"dp": self.dp, "sp": self.sp, "pp": self.pp,
                "ep": self.ep, "tp": self.tp}

    def coords(self) -> dict[str, int]:
        """This rank's ``init_params`` arguments: its tp, pp and ep ranks
        and the degrees (rank 0 of each without a process group)."""
        c = {} if self.mesh is None else self.mesh.coords
        return {"tp_rank": c.get("tp", 0), "tp": self.tp, "pp_rank": c.get("pp", 0),
                "pp": self.pp, "ep_rank": c.get("ep", 0), "ep": self.ep}
