"""Build, load and launch the port's hand-written CUDA kernels, and build
its host library (the event packetizer, native/packetizer.cc).

Each source in csrc/ has a plain C interface.  At first use it is compiled
by nvcc for Hopper into its own shared library under esvio_tpu_torch/build/
(one nvcc per source, all started together) and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
         -shared -Xcompiler -fPIC -o build/libchol_solve.so csrc/chol_solve.cu

The host library is built the same way by the host compiler (g++, which
nvcc needs anyway), beside the kernels when `build` builds everything:

    g++ -O3 -std=c++17 -ffp-contract=off -shared -fPIC \
        -o build/libpacketizer.so native/packetizer.cc

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises if that is not 0.  SIGNATURES is the
one record of every entry point's parameters, from which the ctypes
argtypes are set (tests/test_torch_kernels.py holds it against the
sources).  Every kernel has a `Kernel` record whose `launches` counter its
wrapper bumps once per launch, so a run can show that its main path went
through the kernel.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# no FMA contraction: the packetizer's IMU interpolation matches numpy's
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

# parameter kinds of each extern "C" entry point: "ptr" (device pointer,
# stream, or a host array the entry point reads before it returns) or
# "int"; all return an int cudaError_t
SIGNATURES = {
    "esv_corner_mask": ("ptr", "ptr", "int", "int", "int", "ptr"),
    "esv_chol_solve": ("ptr", "ptr", "ptr", "ptr", "int", "ptr"),
    "esv_lk_track": ("ptr", "ptr", "int", "ptr", "ptr", "ptr", "ptr", "ptr",
                     "ptr", "int", "int", "ptr", "ptr"),
    "esv_normal_assembly": ("ptr", "ptr", "int", "int", "int", "ptr"),
}
_CTYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int}


class Kernel:
    """A kernel of the port: its C symbol, its source, its library and its
    launch count."""

    compiler = "nvcc"

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source                  # path in the repository
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    @property
    def src_path(self) -> str:
        return os.path.join(os.path.dirname(_PKG), self.source)

    @property
    def lib_path(self) -> str:
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}.so")

    def fn(self):
        """The C entry point (its library built first if needed)."""
        if self._fn is None:
            build()
            self._fn = entry_point(self.lib_path, self.symbol)
        return self._fn


CORNER_MASK = Kernel(
    "corner_mask", "esv_corner_mask", "esvio_tpu_torch/csrc/corner_mask.cu",
    "esvio_tpu/events/corners_pallas.py:139")
CHOL_SOLVE = Kernel(
    "chol_solve", "esv_chol_solve", "esvio_tpu_torch/csrc/chol_solve.cu",
    "esvio_tpu/solver/chol_pallas.py:145")
LK_TRACK = Kernel(
    "lk_track", "esv_lk_track", "esvio_tpu_torch/csrc/lk_track.cu",
    "no Pallas kernel: JAX's LK is a jitted lax.while_loop "
    "(esvio_tpu/frontend/lk.py:145)")
NORMAL_ASSEMBLY = Kernel(
    "normal_assembly", "esv_normal_assembly",
    "esvio_tpu_torch/csrc/normal_assembly.cu",
    "no Pallas kernel: JAX's assembly is XLA "
    "(esvio_tpu/solver/gauss_newton.py:671 assemble_normal_reduced)")
KERNELS = (CORNER_MASK, CHOL_SOLVE, LK_TRACK, NORMAL_ASSEMBLY)


class HostLib(Kernel):
    """A host library of the port: built by the host compiler, launches no
    kernel."""

    compiler = "host"

    def fn(self):
        if self._fn is None:
            build(libs=(self,))
            self._fn = ctypes.CDLL(self.lib_path)
        return self._fn


PACKETIZER = HostLib("packetizer", None, "esvio_tpu_torch/native/packetizer.cc",
                     "esvio_tpu/native/packetizer.cc")
HOST_LIBS = (PACKETIZER,)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def entry_point(lib_path: str, symbol: str):
    """`symbol` of the library at lib_path, with argtypes from SIGNATURES
    and an int return."""
    f = getattr(ctypes.CDLL(lib_path), symbol)
    f.argtypes = [_CTYPES[k] for k in SIGNATURES[symbol]]
    f.restype = ctypes.c_int
    return f


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _cxx() -> str:
    path = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if not path:
        raise RuntimeError("no host C++ compiler (g++): the packetizer "
                           "cannot be built")
    return path


def _command(k, out: str):
    if k.compiler == "host":
        return [_cxx(), *CXX_FLAGS, "-o", out, k.src_path]
    return [_nvcc(), *NVCC_FLAGS, "-o", out, k.src_path]


def build(force: bool = False, libs=None) -> tuple[float, str]:
    """Compile every library of `libs` (the kernels and the host library
    by default) that is missing or older than its source (all of them when
    `force`), one compiler process per source, all started together.
    Returns the wall seconds and the compilers' output (ptxas's lines:
    registers, spills, shared memory); raises if one fails."""
    libs = KERNELS + HOST_LIBS if libs is None else libs
    stale = [k for k in libs if force or not os.path.exists(k.lib_path)
             or os.path.getmtime(k.src_path) > os.path.getmtime(k.lib_path)]
    if not stale:
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for k in stale:
        tmp = k.lib_path + f".{os.getpid()}.tmp"
        procs.append((k, tmp, subprocess.Popen(
            _command(k, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for k, tmp, proc in procs:
        log = proc.communicate()[0]
        logs.append(f"== {os.path.basename(k.src_path)}\n{log}")
        if proc.returncode != 0:
            failed.append(f"{k.compiler} compiler failed on {k.src_path} "
                          f"({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, k.lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0, "".join(logs)


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, kernel: Kernel):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel.name} failed to launch: "
                           f"cudaError {err}")
