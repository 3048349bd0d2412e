"""The port's four CUDA kernels from the CPU side: their C interface
against the ctypes declarations, their wrappers' refusals (a wrapper given a
tensor it cannot launch on raises; it never falls back), the CPU dispatch to
the plain versions, and those plain versions at the shapes the card runs.

The kernels themselves build and run only on the card (chip_smoke.py,
phases 2, 3, 3b and 3c; tests/test_torch_lk_card.py,
tests/test_torch_assemble_card.py); nothing here needs nvcc or a GPU.

Tolerances: corner masks exact; Cholesky solves relative error < 5e-5
against float64 numpy and against the JAX solver (the gate of
tests/test_chol_pallas.py:39).
"""
import glob
import os
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from torch_parity import rel_err, to_torch
from esvio_tpu.events import corners as jcor
from esvio_tpu.events import sae as jsae
from esvio_tpu.solver import gauss_newton as jgn
from esvio_tpu_torch import _kernels
from esvio_tpu_torch.events import corners as tcor
from esvio_tpu_torch.events import sae as tsae
from esvio_tpu_torch.frontend import lk as tlk
from esvio_tpu_torch.frontend import pyramid as tpyr
from esvio_tpu_torch.dist import dryrun
from esvio_tpu_torch.solver import chol_solve as tchol
from esvio_tpu_torch.solver import gauss_newton as tgn
from esvio_tpu_torch.solver import normal_assembly as tna

N = tchol.N


def _entry_points():
    """{symbol: (kinds, source)} of every extern "C" function in csrc/."""
    found = {}
    for path in sorted(glob.glob(os.path.join(_kernels.CSRC, "*.cu"))):
        text = open(path).read()
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            kinds = tuple("ptr" if "*" in p else "int"
                          for p in (q.strip() for q in m.group(2).split(",")))
            assert all("*" in p or p.split()[0] == "int"
                       for p in (q.strip() for q in m.group(2).split(","))), m.group(0)
            found[m.group(1)] = (kinds, os.path.basename(path))
    return found


def test_c_entry_points_match_ctypes_declarations():
    found = _entry_points()
    assert set(found) == set(_kernels.SIGNATURES)
    for symbol, (kinds, _) in found.items():
        assert kinds == _kernels.SIGNATURES[symbol], symbol
    for k in _kernels.KERNELS:
        assert found[k.symbol][1] == os.path.basename(k.source)
        assert os.path.exists(k.src_path)
    # the damped solve takes λ on the device: A, b, lam, x, B, stream
    assert _kernels.SIGNATURES["esv_chol_solve"] == (
        "ptr", "ptr", "ptr", "ptr", "int", "ptr")


def _spd(seed, n_sys, jitter=50.0):
    rng = np.random.default_rng(seed)
    G = rng.normal(0, 1, (n_sys, N, N)).astype(np.float32)
    A = np.einsum("bij,bkj->bik", G, G) + jitter * np.eye(N, dtype=np.float32)
    b = rng.normal(0, 1, (n_sys, N)).astype(np.float32)
    lam = np.geomspace(1e-4, 10.0, n_sys).astype(np.float32)
    return A, b, lam


def _x64(A, b, lam):
    return np.stack([np.linalg.solve(A[i].astype(np.float64) + float(lam[i]) * np.eye(N),
                                     b[i].astype(np.float64)) for i in range(len(A))])


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("float64", "float32"), ("shape", "shapes"),
    ("strided", "contiguous")])
def test_chol_solve_cuda_refuses(case, match):
    A, b, lam = (torch.tensor(a) for a in _spd(0, 2))
    if case == "float64":
        A = A.double()
    elif case == "shape":
        A = torch.zeros((2, 192, 192))
    elif case == "strided":
        A = A.transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        tchol.chol_solve_cuda(A, b, lam)
    assert _kernels.CHOL_SOLVE.launches == 0


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("float64", "float32"), ("shape", "float32"),
    ("strided", "contiguous")])
def test_corner_mask_cuda_refuses(case, match):
    sae = torch.rand((2, 20, 30))
    if case == "float64":
        sae = sae.double()
    elif case == "shape":
        sae = sae[0]
    elif case == "strided":
        sae = sae.transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        tcor.corner_mask_cuda(sae)
    assert _kernels.CORNER_MASK.launches == 0


def _lk_pair_args(n=8, H=30, W=40):
    """Two 3-level pyramids and n points for the K3 pair."""
    g = torch.Generator().manual_seed(0)
    pyr = lambda: tpyr.build_lk_pyramid(torch.rand((H, W), generator=g) * 255.0, 3)
    pts = torch.rand((n, 2), generator=g) * torch.tensor([W - 1.0, H - 1.0])
    return pyr(), pyr(), pts, torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("float64", "float32"), ("shape", "shapes"),
    ("strided", "contiguous")])
def test_lk_track_cuda_refuses(case, match):
    pyr_p, pyr_c, pts, valid = _lk_pair_args()
    if case == "float64":
        pyr_c = [(lvl[0].double(),) for lvl in pyr_c]
    elif case == "shape":
        pyr_c = pyr_c[:2]
    elif case == "strided":
        pts = torch.cat([pts, pts], 1)[:, ::2]
    with pytest.raises(ValueError, match=match):
        tlk.launch_k3(pyr_p, pyr_c, pts, valid)
    assert _kernels.LK_TRACK.launches == 0


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the dispatchers run the plain versions and launch
    nothing: no nvcc, no library, no launch counted."""
    _kernels.reset_launch_counts()
    A, b, lam = (torch.tensor(a) for a in _spd(1, 2))
    assert torch.equal(tchol.chol_solve_batched(A, b, lam),
                       tchol.chol_solve_plain(A, b, lam))
    sae = torch.rand((2, 24, 40))
    state = tsae.SAEState(sae=sae, sae_latest=sae)
    assert torch.equal(tcor.corner_mask(state), tcor.corner_mask_plain(sae))
    pyr_p, pyr_c, pts, valid = _lk_pair_args()
    pair = tlk.lk_track_fb(pyr_p, pyr_c, pts, valid, iters=5)
    assert len(pair) == 4 and pair[0].shape == pts.shape
    args = dryrun.make_problem(torch.float32, L_img=8, L_evt=16, device="cpu")
    for a, b in zip(tgn.assemble_normal_reduced(*args),
                    tgn.assemble_normal_reduced_plain(*args)):
        assert torch.equal(a, b)
    assert [k.launches for k in _kernels.KERNELS] == [0, 0, 0, 0]
    assert all(k._fn is None for k in _kernels.KERNELS)


def test_normal_assembly_args_follow_the_source():
    """K4's pointer array: the wrapper's ARGS are the source's `enum Arg`
    in its order, and its lane group and partial sizes are the source's."""
    text = open(_kernels.NORMAL_ASSEMBLY.src_path).read()
    enum = re.search(r"enum Arg \{([^}]*)\}", text).group(1)
    names = [n.strip() for n in enum.replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "N_ARGS"
    assert tuple(n[2:] for n in names[:-1]) == tna.ARGS
    for name, value in (("LANES", tna.LANES), ("NC", tna.NC),
                        ("ROWS", tna.ROWS)):
        m = re.search(rf"constexpr int {name} = ([^;]*);", text)
        assert eval(m.group(1), {"NS": 11}) == value, name


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("float64", "float32"), ("shape", "shapes")])
def test_normal_assembly_cuda_refuses(case, match):
    import dataclasses
    st, bi, be, pre, iv, prior, g = dryrun.make_problem(
        torch.float64 if case == "float64" else torch.float32, L_img=8,
        L_evt=16, device="cpu")
    if case == "shape":
        be = dataclasses.replace(be, un=be.un[:, :10])
    with pytest.raises(ValueError, match=match):
        tna.assemble_cuda(st, bi, be, pre, iv, prior, g)
    assert _kernels.NORMAL_ASSEMBLY.launches == 0


@pytest.mark.parametrize("batch", [None, 3])
def test_normal_assembly_work_counts_the_tensors_it_moves(batch):
    """`work`'s bytes are those of every input and output the kernel takes
    (scratch aside), at one window and at a batch; its FLOP grow with the
    lanes and the batch."""
    args = dryrun.make_problem(torch.float32, L_img=8, L_evt=24, batch=batch,
                               device="cpu")
    ins, outs, (B, L_img, L_evt) = tna.kernel_tensors(*args)
    assert set(ins) | set(outs) == set(tna.ARGS)
    moved = sum(t.numel() * t.element_size() for t in ins.values()) + sum(
        t.numel() * t.element_size() for n, t in outs.items() if n != "SCRATCH")
    n_bytes, flop = tna.work(L_img + L_evt, B)
    assert n_bytes == moved
    assert outs["SCRATCH"].numel() == B * tna.scratch_floats(L_img + L_evt)
    assert tna.work(64, B)[1] > flop > 0
    assert tna.work(32, 2 * B)[1] == 2 * flop


@pytest.mark.parametrize("B", [1, 4, 8])
def test_chol_solve_plain_at_chip_batches(B):
    """The B of chip_smoke phase 3: the pipeline's 1, ROADMAP 2.2's 4, the
    dp solve's 8."""
    A, b, lam = _spd(B, B)
    x = tchol.chol_solve_batched(*(torch.tensor(a) for a in (A, b, lam))).numpy()
    assert x.shape == (B, N)
    assert rel_err(x, _x64(A, b, lam)) < 5e-5


def test_chol_solve_plain_on_a_jacobi_scaled_system():
    """chip_smoke's ill-conditioned case: raw condition ~1e12, Jacobi-scaled
    to a unit diagonal as solve_window scales it, damped by λ₀ = 1e-4;
    against float64 and against the JAX solver."""
    rng = np.random.default_rng(3)
    J = rng.normal(0, 1, (400, N))
    D = np.geomspace(1e-3, 1e3, N)
    H = (D[:, None] * (J.T @ J) * D[None, :]).astype(np.float32)
    assert np.linalg.cond(H.astype(np.float64)) > 1e10
    g = rng.normal(0, 1, N).astype(np.float32)
    d_inv = (1.0 / np.sqrt(np.diag(H))).astype(np.float32)
    Hs = (H * d_inv[None, :] * d_inv[:, None]).astype(np.float32)
    bs = (g * d_inv).astype(np.float32)
    lam = np.full(1, 1e-4, np.float32)
    x = tchol.chol_solve_batched(torch.tensor(Hs[None]), torch.tensor(bs[None]),
                                 torch.tensor(lam)).numpy()
    assert rel_err(x, _x64(Hs[None], bs[None], lam)) < 5e-5
    jdx, jfin = jgn.reduced_solve(jnp.asarray(Hs), jnp.asarray(bs), 1e-4)
    assert bool(jfin)
    assert rel_err(-x[0], np.asarray(jdx)) < 5e-5


def _corner_sae(rng, H, W):
    """A slanted time surface with dropouts and outliers on one plane,
    uniform noise with dropouts on the other: both corner-rich."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    s0 = np.maximum(1.0 + 0.002 * xx + 0.001 * yy,
                    1.0 + 0.003 * (W - xx) + 0.0005 * yy)
    s0 = s0 + rng.normal(0, 1e-4, (H, W))
    s0[rng.random((H, W)) < 0.05] = 0.0
    s0[rng.random((H, W)) < 0.01] = 2.0
    s1 = rng.uniform(0, 1, (H, W))
    s1[rng.random((H, W)) < 0.3] = 0.0
    return np.stack([s0, s1]).astype(np.float32)


@pytest.mark.parametrize("H,W", [(37, 45), (120, 160), (240, 320), (480, 640)])
def test_corner_mask_plain_matches_jax_at_chip_shapes(rng, H, W):
    """The chip_smoke phase-2 shapes the older parity test does not cover
    (golden, bench and DSEC sizes), and one that is no multiple of the CUDA
    kernel's 32 x 8 tile: K1's plain version equals the JAX package's XLA
    formulation at every pixel, border included."""
    s = _corner_sae(rng, H, W)
    jst = jsae.SAEState(sae=jnp.asarray(s), sae_latest=jnp.asarray(s))
    jm = np.asarray(jcor.corner_mask(jst, impl="xla"))
    tm = tcor.corner_mask(to_torch(jst, tsae.SAEState)).numpy()
    assert jm.sum() > 100
    assert np.array_equal(jm, tm)

