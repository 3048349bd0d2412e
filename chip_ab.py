#!/usr/bin/env python3
"""Time other versions of the port's CUDA kernel sources against the
package's own, in turns, on one NVIDIA GPU.

    python3 chip_ab.py DIR [DIR ...]

Each DIR holds a corner_mask.cu, a chol_solve.cu or both: an earlier
design (`git show REV:esvio_tpu_torch/csrc/chol_solve.cu > DIR/chol_solve.cu`)
or a copy with other design constants.  Each source is built with the
package's nvcc flags into DIR/build/ (one nvcc per source, all started
together), checked against the plain version (K1 equal at every pixel, K2
within 5e-5 of float64) and timed against the package's kernel by CUDA
graphs of back-to-back launches of the C entry points alone, in turns
(package, DIRs, DIRs reversed, package) on the same inputs: K1 at
chip_smoke's five shapes, K2 at B = 1, 4 and 8.  A K2 source whose entry
point takes no λ, (A, b, x, B, stream), is given A damped and A, b padded
to 192 once, before the timing.  Prints one line per shape; needs a CUDA
device.  Keep the DIRs in a gitignored directory such as chip_checkout/.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def _kinds(src: str, symbol: str) -> list[str]:
    """Parameter kinds ("ptr" or "int") of `symbol`'s extern "C" entry point."""
    m = re.search(r'extern\s+"C"\s+int\s+' + symbol + r'\s*\(([^)]*)\)', open(src).read())
    if m is None:
        raise RuntimeError(f"{src}: no extern \"C\" {symbol}")
    return ["ptr" if "*" in p else "int" for p in m.group(1).split(",")]


def _build(sources: list[str]) -> dict:
    """{source: library}, one nvcc per source, all started together."""
    from esvio_tpu_torch import _kernels
    nvcc = _kernels._nvcc()
    procs = {}
    for src in sources:
        stem = os.path.splitext(os.path.basename(src))[0]
        lib = os.path.join(os.path.dirname(src), "build", f"lib{stem}.so")
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        procs[src] = (lib, subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        print(f"  {src}: " + "; ".join(
            line.split(":", 1)[-1].strip() for line in out.splitlines()
            if "Used" in line or "spill" in line), flush=True)
        libs[src] = lib
    return libs


def _load(lib: str, symbol: str, kinds: list[str]):
    f = getattr(ctypes.CDLL(lib), symbol)
    f.argtypes = [ctypes.c_void_p if k == "ptr" else ctypes.c_int for k in kinds]
    f.restype = ctypes.c_int
    return f


def in_turns(launches: dict, reps: int) -> dict:
    """graph_ms of each named launch, in order and again in reverse,
    averaged."""
    from esvio_tpu_torch.utils.metrics import graph_ms
    times = {n: [] for n in launches}
    for n in list(launches) + list(launches)[::-1]:
        times[n].append(graph_ms(launches[n], reps))
    return {n: sum(v) / len(v) for n, v in times.items()}


def _report(label: str, t: dict):
    ref = t["package"]
    print(f"{label} us: " + ", ".join(
        f"{n} {v * 1e3:.2f}" + ("" if n == "package" else f" ({v / ref:.2f}x)")
        for n, v in t.items()), flush=True)


def main(dirs: list[str]) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import chip_smoke
    import esvio_tpu_torch
    from esvio_tpu_torch import _kernels
    from esvio_tpu_torch.events import corners
    from esvio_tpu_torch.solver import chol_solve as cs
    esvio_tpu_torch.disable_tf32()
    dev = torch.device("cuda", 0)
    stream = lambda: _kernels.stream_ptr(dev)   # the capture stream inside a graph
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    versions = {}                      # kernel -> {name: (fn, kinds)}
    for k in _kernels.KERNELS:
        versions[k] = {"package": (k.fn(), list(_kernels.SIGNATURES[k.symbol]))}
    srcs = {(k, d): os.path.join(d, os.path.basename(k.source))
            for k in _kernels.KERNELS for d in dirs}
    srcs = {kd: s for kd, s in srcs.items() if os.path.exists(s)}
    libs = _build(list(srcs.values()))
    for (k, d), src in srcs.items():
        kinds = _kinds(src, k.symbol)
        versions[k][os.path.basename(os.path.normpath(d))] = (
            _load(libs[src], k.symbol, kinds), kinds)

    for H, W in chip_smoke.K1_SHAPES:
        sae = chip_smoke._sae_from_events(H, W, dev, seed=H * W).sae
        want = corners.corner_mask_plain(sae)
        launches = {}
        for name, (fn, _) in versions[_kernels.CORNER_MASK].items():
            out = torch.zeros((2, H, W), dtype=torch.bool, device=dev)
            launches[name] = (lambda fn=fn, out=out: fn(
                sae.data_ptr(), out.data_ptr(), 2, H, W, stream()))
            launches[name]()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"K1 {name} differs from the plain version at {H}x{W}")
        _report(f"K1 (2, {H}, {W})", in_turns(launches, reps=200))

    n, NP = cs.N, 192
    for B in (1, 4, 8):
        A, b, lam = chip_smoke._spd_problem(seed=B, n_sys=B)
        x_ref = chip_smoke._x64(A, b, lam)
        At, bt, lt = (torch.tensor(a, device=dev) for a in (A, b, lam))
        Ap = torch.zeros((B, NP, NP), device=dev)
        Ap[:, :n, :n] = At + lt[:, None, None] * torch.eye(n, device=dev)
        Ap[:, n:, n:] = torch.eye(NP - n, device=dev)
        bp = torch.zeros((B, NP), device=dev)
        bp[:, :n] = bt
        launches = {}
        for name, (fn, kinds) in versions[_kernels.CHOL_SOLVE].items():
            if len(kinds) == 6:        # (A, b, lam, x, B, stream)
                x = torch.zeros((B, n), device=dev)
                launch = (lambda fn=fn, x=x: fn(At.data_ptr(), bt.data_ptr(),
                                                lt.data_ptr(), x.data_ptr(), B, stream()))
            else:                      # (A, b, x, B, stream), padded, damped
                x = torch.zeros((B, NP), device=dev)
                launch = (lambda fn=fn, x=x: fn(Ap.data_ptr(), bp.data_ptr(),
                                                x.data_ptr(), B, stream()))
            launch()
            torch.cuda.synchronize()
            err = np.abs(x[:, :n].cpu().numpy() - x_ref).max() / np.abs(x_ref).max()
            if not err < 5e-5:
                raise AssertionError(f"K2 {name}: relative error {err:.2e} at B={B}")
            launches[name] = launch
        _report(f"K2 B={B}", in_turns(launches, reps=100))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
