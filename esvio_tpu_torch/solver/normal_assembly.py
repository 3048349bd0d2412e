"""Normal-equation assembly of the LM window solve — wrapper of kernel K4
(csrc/normal_assembly.cu, which replaces no Pallas kernel: the JAX package
leaves the assembly to XLA).

`assemble_cuda` computes what gauss_newton.assemble_normal_reduced_plain
computes, (Hpp, Hpl, hll, bp, bl, cost), in one call of the kernel's entry
point (two launches), with the factor Jacobians in closed form.  It takes
float32 CUDA tensors with any leading batch axes (B windows per call, as
K2 takes them) and raises on anything else; gauss_newton dispatches to it
and keeps the plain version for the CPU and for float64.

`work` counts the bytes and FLOP of one call, for chip_smoke.py's bound.
"""
from __future__ import annotations

import ctypes
import math

import torch

from esvio_tpu_torch import _kernels
from esvio_tpu_torch.solver import factors
from esvio_tpu_torch.solver.window import DIM_ALL, N_EX, N_STATES, WINDOW

# the entry point's pointer array, in the order of the source's `enum Arg`
# (tests/test_torch_kernels.py holds the two equal)
_STATE = ("P", "Q", "V", "BA", "BG", "EX_P", "EX_Q", "TD")
_BOOK = ("UN", "VEL", "UN_R", "VEL_R", "OBS", "STEREO", "TD_OBS", "INV_DEPTH",
         "DEPTH_VALID", "ACTIVE")
ARGS = (_STATE + tuple("LIN_" + n for n in _STATE)
        + ("J0", "R0", "PRIOR_VALID", "PRIOR_H", "DELTA_P", "DELTA_Q",
           "DELTA_V", "PRE_JAC", "SUM_DT", "LIN_BA_PRE", "LIN_BG_PRE",
           "IMU_SQRT", "IMU_VALID", "G")
        + tuple("IMG_" + n for n in _BOOK) + tuple("EVT_" + n for n in _BOOK)
        + ("HPP", "HPL", "HLL", "BP", "BL", "COST", "SCRATCH"))

_BOOLS = {"PRIOR_VALID", "IMU_VALID"} | {
    p + n for p in ("IMG_", "EVT_")
    for n in ("OBS", "STEREO", "DEPTH_VALID", "ACTIVE")}

LANES = 8                          # lanes a block of the first launch
NC = 91                            # projection columns: poses | ex | td
PART = NC * NC + NC + 1            # a lane group's partial
IMU_PART = 30 * 30 + 30 + 1        # an IMU factor's partial
ROWS = 2 * N_STATES + 1            # projection rows a lane


def scratch_floats(n_lanes: int) -> int:
    """Scratch floats of one window: the lane groups' partials, the IMU
    factors' and the prior's residual."""
    return -(-n_lanes // LANES) * PART + WINDOW * IMU_PART + DIM_ALL


def work(n_lanes: int, batch: int = 1) -> tuple[int, int]:
    """(bytes, FLOP) of one call for B = batch windows of n_lanes lanes in
    all, every lane taken: each input byte read once and each output byte
    written once (the scratch partials stay in L2 and are not counted), and
    the products of the sums: every row's 2 × 26 Jacobian into its lane's
    share of H (2 residuals × 26 × 27 / 2) and of the gradient, its 26
    closed-form columns (~40 FLOP each), the IMU factors' weighting
    (15 × 15 × 31) and products (30 × 30 × 15 + 30 × 15), the prior's two
    matrix-vector products, and the sums of Hpp over the lane groups."""
    F, L = N_STATES, n_lanes
    book = L * (4 * F * 2 * 4 + 2 * F + F * 4 + 4 + 2)
    state = 2 * (F * (3 + 4 + 3 + 3 + 3) + N_EX * 7 + 1) * 4
    prior = (2 * DIM_ALL * DIM_ALL + DIM_ALL) * 4 + 1
    imu = WINDOW * (3 + 4 + 3 + 225 + 1 + 6 + 225) * 4 + WINDOW + 12
    outs = (DIM_ALL * DIM_ALL + DIM_ALL * L + 2 * L + DIM_ALL + 1) * 4
    n_bytes = batch * (book + state + prior + imu + outs)
    rows = L * ROWS
    flop = rows * (2 * 26 * 27 + 2 * 2 * 26 + 26 * 40)
    flop += WINDOW * 2 * (15 * 15 * 31 + 30 * 30 * 15 + 30 * 15)
    flop += 2 * 2 * DIM_ALL * DIM_ALL
    flop += NC * NC * -(-L // LANES)
    return n_bytes, batch * flop


def _flat(x, lead, shape, B):
    """x broadcast to lead + shape and laid out as B contiguous windows."""
    full = tuple(lead) + tuple(shape)
    if tuple(x.shape) == full and x.is_contiguous():
        return x
    if tuple(x.shape) != full:
        x = x.expand(full)
    return x.reshape((B,) + tuple(shape)).contiguous()


def kernel_tensors(state, book_img, book_evt, preints, imu_valid, prior, g,
                   prior_H=None, imu_sqrt=None):
    """The tensors of one call, on the inputs' device: ({name: input laid
    out as B contiguous windows}, {name: output or scratch}, (B, L_img,
    L_evt)), keyed by ARGS' names.  Raises ValueError on a dtype or shape
    the kernel does not take."""
    lead = tuple(state.td.shape)
    B = math.prod(lead)
    L_img, L_evt = book_img.un.shape[-3], book_evt.un.shape[-3]
    L = L_img + L_evt
    if imu_sqrt is None:
        imu_sqrt = factors.imu_sqrt_info(preints.covariance)
    if prior_H is None:
        J0w = prior.J0 * prior.valid.to(prior.J0.dtype)[..., None, None]
        prior_H = J0w.mT @ J0w
    F = N_STATES
    shapes = dict(P=(F, 3), Q=(F, 4), V=(F, 3), BA=(F, 3), BG=(F, 3),
                  EX_P=(N_EX, 3), EX_Q=(N_EX, 4), TD=())
    t = {}
    for name, field in zip(_STATE, ("P", "Q", "V", "Ba", "Bg", "ex_p", "ex_q",
                                    "td")):
        t[name] = getattr(state, field), shapes[name]
        t["LIN_" + name] = getattr(prior.lin, field), shapes[name]
    t.update(
        J0=(prior.J0, (DIM_ALL, DIM_ALL)), R0=(prior.r0, (DIM_ALL,)),
        PRIOR_VALID=(prior.valid, ()), PRIOR_H=(prior_H, (DIM_ALL, DIM_ALL)),
        DELTA_P=(preints.delta_p, (WINDOW, 3)),
        DELTA_Q=(preints.delta_q, (WINDOW, 4)),
        DELTA_V=(preints.delta_v, (WINDOW, 3)),
        PRE_JAC=(preints.jacobian, (WINDOW, 15, 15)),
        SUM_DT=(preints.sum_dt, (WINDOW,)),
        LIN_BA_PRE=(preints.linearized_ba, (WINDOW, 3)),
        LIN_BG_PRE=(preints.linearized_bg, (WINDOW, 3)),
        IMU_SQRT=(imu_sqrt, (WINDOW, 15, 15)), IMU_VALID=(imu_valid, (WINDOW,)),
        G=(g, (3,)))
    for pre, book, n in (("IMG_", book_img, L_img), ("EVT_", book_evt, L_evt)):
        for name, s in zip(_BOOK, ((n, F, 2),) * 4 + ((n, F),) * 3
                           + ((n,),) * 3):
            t[pre + name] = getattr(book, name.lower()), s
    ins = {}
    for name, (x, s) in t.items():
        want = torch.bool if name in _BOOLS else torch.float32
        if x.dtype != want:
            raise ValueError(f"assemble_cuda: {name} is {x.dtype}, takes {want}")
        try:
            ins[name] = _flat(x, lead, s, B)
        except RuntimeError as e:
            raise ValueError(f"assemble_cuda shapes: {name} "
                             f"{tuple(x.shape)} against {lead + s}") from e
    f32 = dict(dtype=torch.float32, device=state.P.device)
    outs = dict(HPP=torch.empty(lead + (DIM_ALL, DIM_ALL), **f32),
                HPL=torch.empty(lead + (DIM_ALL, L), **f32),
                HLL=torch.empty(lead + (L,), **f32),
                BP=torch.empty(lead + (DIM_ALL,), **f32),
                BL=torch.empty(lead + (L,), **f32),
                COST=torch.empty(lead, **f32),
                SCRATCH=torch.empty((B * scratch_floats(L),), **f32))
    return ins, outs, (B, L_img, L_evt)


def assemble_cuda(state, book_img, book_evt, preints, imu_valid, prior, g,
                  cauchy_c: float = 1.0, prior_H=None, imu_sqrt=None):
    """Kernel K4: gauss_newton.assemble_normal_reduced_plain's outputs, all
    float32 on the card, with the leading batch axes of state.td."""
    ins, outs, (B, L_img, L_evt) = kernel_tensors(
        state, book_img, book_evt, preints, imu_valid, prior, g,
        prior_H=prior_H, imu_sqrt=imu_sqrt)
    if not all(x.is_cuda for x in ins.values()):
        raise ValueError("assemble_cuda needs CUDA tensors")
    dev = outs["HPP"].device
    ptrs = (ctypes.c_uint64 * len(ARGS))(
        *[(ins[n] if n in ins else outs[n]).data_ptr() for n in ARGS])
    c = ctypes.c_float(cauchy_c)
    err = _kernels.NORMAL_ASSEMBLY.fn()(
        ctypes.addressof(ptrs), ctypes.addressof(c), B, L_img, L_evt,
        _kernels.stream_ptr(dev))
    _kernels.check(err, _kernels.NORMAL_ASSEMBLY)
    _kernels.NORMAL_ASSEMBLY.launches += 1
    return (outs["HPP"], outs["HPL"], outs["HLL"], outs["BP"], outs["BL"],
            outs["COST"])
