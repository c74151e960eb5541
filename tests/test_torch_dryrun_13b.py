"""Dryrun phase 9 of ``__graft_entry__.py::dryrun_multichip(8)``,
``13b-geometry/zero3+remat``, against JAX's ``make_train_step`` on the same
mesh of the CPU-simulated devices: the 13B layer geometry (hidden 5120, 40
heads, FFN 20480, the reference's ``models.py:265-270``) at 2 layers, fp32,
remat, ZeRO-3 on dp=2 x tp=4, Adam at lr 1e-3, 2 rows per dp rank, S=16,
one step, as the dryrun runs it.

Memory, reckoned before adding it: 2 layers of 314.6 M parameters and
``ln_f``, 629.2 M in all, 2.52 GB in fp32.  JAX holds the sharded
parameters, Adam's two moments, one step's gradients and the new state,
about 5x that; the port's 8 ranks the same in parts, plus each process's
own footprint (they read the weights through memory maps, each copying
only its tp shard).  The port runs first and its parts are joined and
dropped before JAX runs, so that the two peaks do not meet; this process
reads the weights through memory maps too.  Measured on 8 CPU cores: about
2 minutes, and at most 22 GB used on the machine (``free``) at the peak.

Bounds: the loss to ``LOSS_RTOL``, every full leaf to ``ADAM_ATOL`` where
its step is determined (``torch_mesh_parity.check_adam_case``, argued in
``tests/test_torch_zero.py``).
"""

import jax
import numpy as np
import torch
import torch_pipe_worker
from torch_mesh_parity import (
    ADAM,
    by_path,
    full_params,
    hold_adam,
    jax_adam_reference,
    losses,
)

from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu_torch.bench.launch import launch

torch.set_num_threads(1)

FIELDS = dict(hidden_size=5120, num_layers=2, num_heads=40, ffn_intermediate=20480,
              dtype="float32", remat=True)
SPEC = {"mesh": (2, 1, 1, 1, 4), "fields": FIELDS, "weights": "13b", "train": ADAM,
        "stage": 3, "grad_accum": 1, "steps": 1, "batch": "b4"}


def test_dryrun_13b_geometry_zero3_remat_matches_jax(tmp_path):
    cfg = jax_configs.ModelConfig(**FIELDS)
    assert (cfg.hidden_size, cfg.num_heads, cfg.ffn_intermediate) == tuple(
        getattr(jax_configs.MODEL_CONFIGS["13B"], k)
        for k in ("hidden_size", "num_heads", "ffn_intermediate"))
    weights = {}
    for name, a in by_path(jax_tf.init_params(cfg, jax.random.key(0))).items():
        path = tmp_path / f"{name.replace('/', '.')}.npy"
        np.save(path, np.asarray(a))
        group, leaf = name.rsplit("/", 1)
        node = weights
        for key in group.split("/"):
            node = node.setdefault(key, {})
        # read back through a memory map: the file's pages, not a copy
        node[leaf] = np.load(path, mmap_mode="r")
    assert sum(a.size for a in by_path(weights).values()) == jax_tf.num_parameters(cfg)
    rng = np.random.default_rng(17)
    batches = {"b4": tuple(rng.standard_normal((4, 16, 5120), dtype=np.float32)
                           for _ in range(2))}
    ranks = launch(torch_pipe_worker.run_memmap_train_case, 8, "cpu",
                   args=(SPEC, str(tmp_path), batches["b4"]), timeout=900, group_timeout=600)
    assert all(r is not None for r in ranks)
    ranks = [{"13b": r} for r in ranks]
    got_losses = losses(ranks, "13b")
    got = by_path(full_params(ranks, "13b", SPEC, {"13b": weights}))
    del ranks  # the port's parts, before JAX runs
    hold_adam(got_losses, got, jax_adam_reference(SPEC, {"13b": weights}, batches), SPEC)
