"""Build, load and launch the port's hand-written CUDA kernels.

The sources in csrc/ have a plain C interface.  At first use they are
compiled by nvcc for Hopper into one shared library under
esvio_tpu_torch/build/ and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/libesvio_kernels.so csrc/*.cu

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises if that is not 0.  Every kernel has a
`Kernel` record whose `launches` counter its wrapper bumps once per launch,
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libesvio_kernels.so")
SOURCES = ("corner_mask.cu", "chol_solve.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


class Kernel:
    """A kernel of the port: its C symbol, its source and its launch count."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.launches = 0


CORNER_MASK = Kernel(
    "corner_mask", "esv_corner_mask", "esvio_tpu_torch/csrc/corner_mask.cu",
    "esvio_tpu/events/corners_pallas.py:139")
CHOL_SOLVE = Kernel(
    "chol_solve", "esv_chol_solve", "esvio_tpu_torch/csrc/chol_solve.cu",
    "esvio_tpu/solver/chol_pallas.py:145")
KERNELS = (CORNER_MASK, CHOL_SOLVE)

_lib = None


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(CSRC, s)) > built
               for s in SOURCES)


def build(force: bool = False) -> float:
    """Compile csrc/ into build/libesvio_kernels.so unless it is up to date
    (or `force`).  Returns the seconds spent compiling (0.0 when nothing was
    built)."""
    if not (force or _stale()):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIB_PATH + f".{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        build()
        handle = ctypes.CDLL(LIB_PATH)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        handle.esv_corner_mask.argtypes = [vp, vp, ci, ci, ci, vp]
        handle.esv_corner_mask.restype = ci
        handle.esv_chol_solve.argtypes = [vp, vp, vp, ci, vp]
        handle.esv_chol_solve.restype = ci
        _lib = handle
    return _lib


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, kernel: Kernel):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel.name} failed to launch: "
                           f"cudaError {err}")
