"""Peaks of the card and the work of each hand-written kernel: the
yardstick of the `*_roofline` metrics.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over their peak rate; its share of the roofline is that bound
over its measured device time.  The counts are those of the repository's
chip_smoke.py (K1: `_bound(P*H*W*(4+1), P*H*W*K1_OPS_PER_PX, peak_cmp)`,
K2: `_bound(4*B*(n*n+2*n+1), B*(2*n**3/3+2*n**2), PEAK_F32)`), copied here
so that the program cannot change them.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet, dense, at the 700 W limit: float32 FMA
# outside the tensor cores (two FLOP each) and HBM3.  Float compares and
# minimums issue at 64 per clock per SM on sm_90, half the FMA rate (CUDA
# C++ Programming Guide, arithmetic instruction throughput): 132 SMs at the
# 1,980 MHz boost clock.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f32_flops=67e12, bytes=3.35e12,
                                  compares=64 * 132 * 1980e6),
}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peaks for {kind!r}: add its data sheet to PEAKS")
    return PEAKS[kind]


def bound_s(n_bytes: float, n_ops: float, bytes_per_s: float,
            ops_per_s: float) -> float:
    return max(n_bytes / bytes_per_s, n_ops / ops_per_s)


# K1 (csrc/corner_mask.cu): per pixel and polarity, the FAST-style test on
# the 16- and 20-sample circles (n samples, arc length lo): n - 1 compares
# for the circle's minimum, 3 per sample of the first arc, 4 per sample of
# the rest (chip_smoke.K1_OPS_PER_PX).
K1_OPS_PER_PX = sum((n - 1) + 3 * (lo - 1) + 4 * (n - lo)
                    for n, lo in ((16, 4), (20, 5)))
K1_KERNEL = "corner_mask_kernel"


def k1_bound_s(P: int, H: int, W: int, pk: dict) -> float:
    """(P, H, W) float32 SAE read once, a bool mask written once."""
    return bound_s(P * H * W * (4 + 1), P * H * W * K1_OPS_PER_PX,
                   pk["bytes"], pk["compares"])


# K2 (csrc/chol_solve.cu): B systems (A + lam I) x = b of n = 190 in
# float32; A, b, lam read once, x written once; a Cholesky factorization
# and two triangular solves.
K2_N = 190
K2_KERNEL = "chol_solve_kernel"


def k2_bound_s(B: int, pk: dict, n: int = K2_N) -> float:
    return bound_s(4 * B * (n * n + 2 * n + 1), B * (2 * n ** 3 / 3 + 2 * n ** 2),
                   pk["bytes"], pk["f32_flops"])
