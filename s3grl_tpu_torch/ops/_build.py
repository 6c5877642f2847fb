"""Build the package's CUDA kernels at first use and load them with ctypes;
check the tensors a wrapper hands to a kernel's C entry.

Every ``csrc/*.cu`` is compiled by ``nvcc`` into its own shared library with
a plain C interface, under ``build/kernels/`` at the repository root. The
file name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. All missing libraries are built in
parallel, one ``nvcc`` process per source.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600


@dataclass(frozen=True)
class BuiltKernel:
    name: str  # source stem, e.g. "pos_power_rows"
    path: str  # the shared library
    log: str  # nvcc's output, with -Xptxas -v's registers, shared memory, spills
    seconds: float  # build wall time, 0.0 when the library was reused


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(src: str) -> str:
    with open(src, "rb") as f:
        blob = f.read() + repr(NVCC_FLAGS).encode()
    tag = hashlib.sha256(blob).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{stem}_{tag}.so")


def sources() -> list[str]:
    return sorted(
        os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR) if f.endswith(".cu")
    )


def build_all() -> dict[str, BuiltKernel]:
    """Build every kernel that is not built yet; return all of them by name.

    Raises RuntimeError naming the source and nvcc's output if one fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    built = {}
    for src in sources():
        name = os.path.splitext(os.path.basename(src))[0]
        so = _target(src)
        if os.path.exists(so):
            log = ""
            if os.path.exists(so + ".log"):
                with open(so + ".log") as f:
                    log = f.read()
            built[name] = BuiltKernel(name, so, log, 0.0)
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, src, so, tmp, time.perf_counter())
    failures = []
    for name, (proc, src, so, tmp, t0) in running.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{src}: nvcc timed out after {NVCC_TIMEOUT_S} s\n{log}")
            continue
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            continue
        with open(so + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, so)
        built[name] = BuiltKernel(name, so, log, seconds)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return built


def check_arg(t, name: str, dtype, shape, device) -> None:
    """Raise unless tensor ``t`` has the device, dtype and shape a kernel's
    C entry takes and is contiguous (TypeError for the dtype, ValueError
    otherwise)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first
    if needed."""
    return ctypes.CDLL(build_all()[name].path)
