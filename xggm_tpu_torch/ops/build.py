"""Build and load the port's CUDA kernels.

Each kernel source `xggm_tpu_torch/csrc/<name>.cu` has a plain C interface
and may include the shared headers `csrc/*.cuh`. It is compiled with `nvcc`
for `sm_90a` into `build/xggm_tpu_torch/lib<name>.so` at the checkout's
root, on first use, and loaded with ctypes. A missing `nvcc`
or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "xggm_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class BuildResult:
    path: str
    seconds: float
    log: str  # nvcc's output, with ptxas' registers, shared memory, spills


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _newest_input(name: str) -> float:
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
               if f.endswith(".cuh")]
    return max(os.path.getmtime(p) for p in [source_path(name), *headers])


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built from source on first use")


def build(name: str) -> BuildResult:
    """Compile csrc/<name>.cu into build/; the library appears atomically."""
    src = source_path(name)
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, proc.stdout + proc.stderr)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if it is missing
    or older than its source or a shared header."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out = library_path(name)
            if (not os.path.exists(out)
                    or os.path.getmtime(out) < _newest_input(name)):
                build(name)
            lib = _LIBS[name] = ctypes.CDLL(out)
        return lib
