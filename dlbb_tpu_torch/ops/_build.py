"""Build the package's CUDA sources with ``nvcc`` and load them by ``ctypes``.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
libraries land in ``ops/_build/<hash>/``, keyed by a hash of the sources
and the flags, so a changed source rebuilds and an unchanged one loads.
All sources build in parallel, one ``nvcc`` each, at the first launch of
any kernel: importing the package never needs ``nvcc``.  Each library's
``ptxas`` report (registers, shared memory, spills) is kept beside it in
``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_libraries: dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(NVCC_FALLBACK):
        nvcc = NVCC_FALLBACK
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found (neither on PATH nor at {NVCC_FALLBACK}): the "
            "CUDA kernels of dlbb_tpu_torch are built at their first launch"
        )
    return nvcc


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """``_build/<hash>``: the hash covers every source, header and flag."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source not yet built (all ``nvcc`` runs at once), then
    load every library.  Raises with the compiler's output on failure."""
    global build_seconds
    if _libraries:
        return _libraries
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    todo = [src for src in sources() if not (out_dir / f"lib{src.stem}.so").exists()]
    nvcc = find_nvcc() if todo else None
    pending = []
    for src in todo:
        lib = out_dir / f"lib{src.stem}.so"
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        log = open(out_dir / f"{src.stem}.log", "w")
        proc = subprocess.Popen(nvcc_command(nvcc, src, tmp),
                                stdout=log, stderr=subprocess.STDOUT)
        pending.append((src, tmp, lib, proc, log))
    failed = []
    for src, tmp, lib, proc, log in pending:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{src.name} (rc {rc}):\n"
                          + (out_dir / f"{src.stem}.log").read_text())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    for src in sources():
        _libraries[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
    return _libraries


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return build_all()[name]


def ptxas_report(name: str) -> str:
    """The compiler's ``-Xptxas=-v`` lines for ``csrc/<name>.cu`` (empty
    when the library was built by an earlier process and its log is gone)."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""
