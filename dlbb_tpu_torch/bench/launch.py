"""Launch N ranks on one host (counterpart of the JAX package's
``--simulate N`` and ``dlbb_tpu/launch/launch_cpu_sim.sh``; the reference's
``mpirun -np N``, ``collectives/launch_openmpi.sh``).

``launch(fn, world_size, device)`` spawns ``world_size`` processes with
``torch.multiprocessing``: on ``cpu`` they join a gloo group, on ``cuda`` an
NCCL group with one GPU per rank (rank r on ``cuda:r``; NCCL does not put
two ranks of one communicator on the same GPU, so the world is at most the
GPU count).  They meet through a ``FileStore`` in a fresh temporary
directory, so concurrent launches never collide.  Each worker runs
``fn(*args)`` single-threaded, and ``launch`` returns what each rank's ``fn``
returned, by rank.  A rank that fails stops the others, and ``launch``
raises its error.

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set), ``launch`` runs in
place instead: this process joins the group through ``env://`` as its
rank, and the list holds only its own result.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.multiprocessing as mp

from dlbb_tpu_torch.comm.mesh import (
    BACKENDS,
    destroy_distributed,
    initialize_distributed,
)
from dlbb_tpu_torch.utils.sysinfo import resolve_device


def _run_rank(rank: int, local_rank: int, world_size: int, device_type: str,
              init_file: Optional[str], timeout: Optional[float],
              fn: Callable, args: tuple) -> Any:
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    initialize_distributed(BACKENDS[device_type], rank, world_size, init_file,
                           timeout=timeout)
    try:
        return fn(*args)
    finally:
        destroy_distributed()


def _spawned(rank: int, world_size: int, device_type: str, tmp: str,
             timeout: Optional[float], fn: Callable, args: tuple) -> None:
    result = _run_rank(rank, rank, world_size, device_type,
                       os.path.join(tmp, "store"), timeout, fn, args)
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(fn: Callable, world_size: int, device=None, args: tuple = (),
           timeout: Optional[float] = None,
           group_timeout: Optional[float] = None) -> list[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks of one process group; see
    the module docstring.  ``fn`` must be importable by name (it is pickled
    into the workers).  ``device`` is ``cuda`` unless the caller names
    ``cpu``; it raises without CUDA.  ``timeout`` (seconds) bounds, when
    spawning, the whole run, and each collective's wait unless
    ``group_timeout`` (seconds) bounds that."""
    dev = resolve_device(device)
    if group_timeout is None:
        group_timeout = timeout
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world_size:
            raise ValueError(f"torchrun set WORLD_SIZE={os.environ['WORLD_SIZE']}, "
                             f"the launch asks for {world_size}")
        return [_run_rank(int(os.environ["RANK"]),
                          int(os.environ.get("LOCAL_RANK", 0)), world_size,
                          dev.type, None, group_timeout, fn, args)]
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(
            f"world size {world_size} needs one GPU per rank; "
            f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory(prefix="dlbb_launch_") as tmp:
        ctx = mp.start_processes(
            _spawned, args=(world_size, dev.type, tmp, group_timeout, fn, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):  # raises when a rank failed
            if deadline is not None and time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"launch of {world_size} ranks did not end "
                                   f"within {timeout} s")
        results = []
        for rank in range(world_size):
            with open(Path(tmp) / f"result_{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
