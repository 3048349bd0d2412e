"""Damped Cholesky solve of the reduced camera system — wrapper of kernel K2
(csrc/chol_solve.cu, which replaces the Pallas kernel
esvio_tpu/solver/chol_pallas.py:145).

x with (A + λI) x = b for B systems of size N = 190.  On a CUDA tensor the
wrapper launches the kernel, one CTA per system, which damps each system
and pads it to 192 with a unit diagonal (as chol_solve_batched does)
while it loads it; on a CPU tensor it runs the plain version,
`torch.linalg.cholesky_ex` plus two triangular solves (the XLA branch of
gauss_newton.reduced_solve).  Both return NaN rows for systems that are not
positive definite.
"""
from __future__ import annotations

import torch

from esvio_tpu_torch import _kernels

N = 190            # live system size (solver/window.DIM_ALL)


def chol_solve_plain(A, b, lam):
    """A (B, N, N), b (B, N), lam (B,) → x (B, N); NaN where not SPD."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A + lam[:, None, None] * eye)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
    return torch.where((info == 0)[:, None], x, torch.full_like(x, float("nan")))


def chol_solve_cuda(A, b, lam):
    """Launch kernel K2 on contiguous float32 CUDA tensors A (B, 190, 190),
    b (B, 190), lam (B,) → x (B, 190).  The kernel adds λ on the diagonal
    and pads to 192 itself, so the wrapper only allocates x."""
    if not (A.dtype == b.dtype == lam.dtype == torch.float32):
        raise ValueError("chol_solve_cuda takes float32")
    B = A.shape[0]
    if A.shape != (B, N, N) or b.shape != (B, N) or lam.shape != (B,):
        raise ValueError(f"chol_solve_cuda shapes: A {tuple(A.shape)}, "
                         f"b {tuple(b.shape)}, lam {tuple(lam.shape)}")
    if not (A.is_contiguous() and b.is_contiguous() and lam.is_contiguous()):
        raise ValueError("chol_solve_cuda takes contiguous tensors")
    if not (A.is_cuda and b.is_cuda and lam.is_cuda):
        raise ValueError("chol_solve_cuda needs CUDA tensors")
    if A.data_ptr() % 8:
        raise ValueError("chol_solve_cuda needs A 8-byte aligned (the kernel "
                         "copies its rows in 8-byte pieces)")
    x = torch.empty((B, N), dtype=A.dtype, device=A.device)
    err = _kernels.CHOL_SOLVE.fn()(A.data_ptr(), b.data_ptr(), lam.data_ptr(),
                                   x.data_ptr(), B,
                                   _kernels.stream_ptr(A.device))
    _kernels.check(err, _kernels.CHOL_SOLVE)
    _kernels.CHOL_SOLVE.launches += 1
    return x


def chol_solve_batched(A, b, lam):
    """x with (A + lam·I) x = b per system: kernel K2 on the card, the plain
    version on the CPU."""
    if A.is_cuda:
        return chol_solve_cuda(A, b, lam)
    return chol_solve_plain(A, b, lam)


def chol_solve(A, b, lam):
    """Single system: A (N, N), b (N,), lam () → x (N,)."""
    return chol_solve_batched(A[None], b[None], lam.reshape(1))[0]
