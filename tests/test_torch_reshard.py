"""The port's train step on global micro-batches laid over dp
(``data.batch_slice`` with ``chunks``, ``train/loop.py``'s shares of the
rows, ``sharding.token_mean`` over unequal shares) against the JAX
package's ``make_train_step`` on the same mesh of the CPU-simulated devices
of ``conftest.py``, where JAX splits the global batch and GSPMD reshards
each micro-batch over dp.

The port runs on 4 spawned gloo ranks (``tests/torch_train_worker.py``),
each case on the first ranks of its mesh; the held quantities and bounds
are ``tests/torch_mesh_parity.py``'s, argued in ``tests/test_torch_zero.py``:
one SGD step without momentum at lr 1024 gives the reduced gradient on both
sides, held to ``GRAD_RTOL`` = 1e-5 of each leaf's largest, the losses to
``LOSS_RTOL`` = 1e-5; two Adam steps to ``ADAM_ATOL``.  The cases:

- batch 6, ``grad_accum`` 2 at dp=2: each micro-batch's 3 rows split 2 and
  1, at ZeRO 0 and 2 (stage 2 reduces every micro-step), two Adam steps at
  ZeRO 2, and at dp=2 x tp=2;
- batch 8, ``grad_accum`` 2 at dp=2 and ZeRO 2 (dryrun phase 8's
  accumulation): the divisible case takes the same layout, each rank half
  of each global micro-batch;
- batch 8, ``grad_accum`` 4 at dp=4: each micro-batch's 2 rows go to ranks
  0 and 1, and ranks 2 and 3 hold none; they run the step on an empty
  batch and join every collective (ZeRO-3's gathers included);
- dp=2 x sp=2 under ring attention, batch 8, ``grad_accum`` 2: the shares
  of the rows and the sp chunks' shares multiply;
- the MoE load-balancing loss at dp=2: under ``grad_accum`` 2 on batch 6,
  and on a pp=2 pipeline of 2 microbatches of 3 rows (GPipe and 1F1B): its
  routing statistics are the global micro-batch's.
"""

import jax
import numpy as np
import pytest
import torch
import torch_train_worker
from torch_mesh_parity import ADAM, SGD, check_adam_case, check_sgd_case

from dlbb_tpu.models import configs as jax_configs
from dlbb_tpu.models import transformer as jax_tf
from dlbb_tpu_torch.bench.launch import launch
from dlbb_tpu_torch.data import batch_slice

torch.set_num_threads(1)

DENSE = dict(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128,
             dtype="float32", attention="full")
MOE = dict(DENSE, num_experts=4, moe_top_k=2)
AUX = 0.01
FIELDS = {"dense": DENSE, "moe": MOE, "ring": dict(DENSE, attention="ring")}


def _case(mesh, stage, batch, grad_accum=1, weights="dense", train=SGD, steps=1, **kw):
    return {"mesh": mesh, "fields": FIELDS[weights], "weights": weights, "train": train,
            "stage": stage, "grad_accum": grad_accum, "steps": steps, "batch": batch, **kw}


DP2, DP4 = (2, 1, 1, 1, 1), (4, 1, 1, 1, 1)
SGD_CASES = {
    "b6ga2/dp2/zero0": _case(DP2, 0, "b6", 2),
    "b6ga2/dp2/zero2": _case(DP2, 2, "b6", 2),
    "b6ga2/dp2tp2/zero1": _case((2, 1, 1, 1, 2), 1, "b6", 2),
    "b8ga2/dp2/zero2": _case(DP2, 2, "b8", 2),
    "b8ga4/dp4/zero0": _case(DP4, 0, "b8", 4),
    "b8ga4/dp4/zero3": _case(DP4, 3, "b8", 4),
    "b8ga2/dp2sp2/ring/zero1": _case((2, 2, 1, 1, 1), 1, "b8", 2, "ring"),
    "moe/b6ga2/dp2/zero1": _case(DP2, 1, "b6", 2, "moe", aux=AUX),
    "moe/b6/dp2pp2/gpipe": _case((2, 1, 2, 1, 1), 1, "b6", 1, "moe", aux=AUX,
                                 microbatches=2),
    "moe/b6/dp2pp2/1f1b": _case((2, 1, 2, 1, 1), 1, "b6", 1, "moe", aux=AUX,
                                microbatches=2, schedule="1f1b"),
}
ADAM_CASES = {"b6ga2/dp2/zero2/adam": _case(DP2, 2, "b6", 2, train=ADAM, steps=2)}
CASES = {**SGD_CASES, **ADAM_CASES}


@pytest.fixture(scope="module")
def weights():
    return {key: jax.tree.map(np.asarray, jax_tf.init_params(
        jax_configs.ModelConfig(**fields), jax.random.key(0)))
        for key, fields in FIELDS.items()}


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(17)
    return {key: tuple(rng.standard_normal((rows, 16, DENSE["hidden_size"]),
                                           dtype=np.float32) for _ in range(2))
            for key, rows in (("b6", 6), ("b8", 8))}


@pytest.fixture(scope="module")
def ranks(weights, batches):
    return launch(torch_train_worker.run_train_cases, 4, "cpu",
                  args=(list(CASES.items()), weights, batches), timeout=600,
                  group_timeout=120)


@pytest.mark.parametrize("case_id", sorted(SGD_CASES))
def test_one_sgd_step_on_resharded_micro_batches_gives_the_jax_gradient(
        ranks, weights, batches, case_id):
    check_sgd_case(ranks, weights, batches, case_id, CASES[case_id])


@pytest.mark.parametrize("case_id", sorted(ADAM_CASES))
def test_adam_steps_on_resharded_micro_batches_match_jax(ranks, weights, batches, case_id):
    check_adam_case(ranks, weights, batches, case_id, CASES[case_id])


@pytest.mark.parametrize("rows,chunks,dp,want", [
    (6, 2, 2, [[0, 1, 3, 4], [2, 5]]),
    (8, 4, 4, [[0, 2, 4, 6], [1, 3, 5, 7], [], []]),
    (8, 2, 2, [[0, 1, 4, 5], [2, 3, 6, 7]]),
    (8, 1, 2, [[0, 1, 2, 3], [4, 5, 6, 7]]),
])
def test_batch_slice_lays_each_micro_batch_over_dp(rows, chunks, dp, want):
    """Each rank's rows of each global micro-batch, in micro-batch order:
    near-equal contiguous parts, the first ``rows % dp`` ranks one row more
    (a rank may hold none); one chunk is the plain dp slice."""
    a = np.arange(rows)[:, None] * np.ones((1, 4), dtype=np.int64)
    for r in range(dp):
        got = batch_slice(a, r, dp, chunks=chunks)
        assert got[:, 0].tolist() == want[r]
        t = batch_slice(torch.from_numpy(a), r, dp, chunks=chunks)
        assert t[:, 0].tolist() == want[r]
    with pytest.raises(ValueError, match="not divisible into 4 micro-batches"):
        batch_slice(a[:6], 0, 2, chunks=4)
