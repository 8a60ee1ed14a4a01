"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by nvcc, for sm_90a, into
`build/neurecon_tpu_torch/lib<name>.so` at the root of the checkout, and bound
with ctypes. The sources have a plain C interface (no PyTorch headers), so a
build takes seconds. `build_all` starts one nvcc per source, all at once.

Nothing here runs at import time: the CPU tests import every module on a host
without nvcc.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "neurecon_tpu_torch"
SOURCES = ("nablas_forward", "neus_upsample", "nablas_backward")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest_src = max(p.stat().st_mtime for p in CSRC.iterdir()
                     if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest_src


def _start(name: str):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
    log = open(BUILD_DIR / f"{name}.log", "w")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, log


def _finish(name: str, proc, tmp: Path, log) -> None:
    rc = proc.wait()
    log.close()
    text = (BUILD_DIR / f"{name}.log").read_text()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc={rc}):\n{text}")
    os.replace(tmp, _lib_path(name))  # atomic against a concurrent build


def build_all(force: bool = False) -> float:
    """Compile every stale source (all nvcc processes at once); returns the
    wall seconds spent."""
    t0 = time.perf_counter()
    with _LOCK:
        names = [n for n in SOURCES if force or _stale(n)]
        jobs = [(n, *_start(n)) for n in names]
        errors = []
        for job in jobs:
            try:
                _finish(*job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output of the last build (register and spill counts)."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
