"""Device resolution and system info for result provenance (counterpart of
``dlbb_tpu/utils/sysinfo.py``)."""

from __future__ import annotations

import platform
import shutil
import subprocess
from typing import Any, Optional

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or implied) and absent: a
    measurement never carries on quietly on the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU on purpose")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"dlbb_tpu_torch runs on cuda or cpu, not {dev}")
    return dev


def gpu_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, as
    it prints it, or None where there is no ``nvidia-smi``."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    if out.returncode != 0:
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def gpu_cards() -> tuple[int, Optional[int]]:
    """``(visible GPUs, bytes of the first one's memory)``; ``(0, None)``
    without CUDA."""
    if not torch.cuda.is_available():
        return 0, None
    return torch.cuda.device_count(), torch.cuda.get_device_properties(0).total_memory


def topology_record(device: torch.device) -> dict[str, Any]:
    """The topology record of a sweep's or a serving run's manifest and
    journal (JAX's ``utils/simulate.py::topology_record`` keys): the device
    type behind the mesh, its ranks, and whether the run is on the CPU.
    The port runs on the CPU only when asked to (``resolve_device``), so no
    run is degraded."""
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_available() and torch.distributed.is_initialized()
             else 1)
    return {
        "platform": device.type,
        "num_devices": world,
        "process_count": world,
        "simulated": device.type == "cpu",
        "simulation_forced": device.type == "cpu",
        "degraded": False,
    }


def collect_system_info(device=None) -> dict[str, Any]:
    """Where a result was measured: host, torch and CUDA versions, the
    device, and, inside a process group, its backend (``nccl`` with its
    version, or ``gloo``) and world size."""
    info: dict[str, Any] = {
        "platform": platform.platform(),
        "python_version": platform.python_version(),
        "processor": platform.processor(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        info.update(
            backend="cuda",
            num_devices=torch.cuda.device_count(),
            device_kind=torch.cuda.get_device_name(dev),
            nvidia_smi_name_power_limit=gpu_name_and_power_limit(),
        )
    else:
        info.update(backend="cpu", num_devices=1, device_kind="cpu")
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        info.update(comm_backend=torch.distributed.get_backend(),
                    world_size=torch.distributed.get_world_size())
        if info["comm_backend"] == "nccl":
            v = torch.cuda.nccl.version()  # (major, minor, patch)
            info["nccl_version"] = ".".join(map(str, v)) if isinstance(v, tuple) else str(v)
    return info
