"""Kernel K4 on the card: against the plain assembly in every case of
tests/assemble_cases.py (which holds the inputs, the tolerance and its
reason), bit for bit against itself, and the LM window solve through it
against the same LM loop through the plain assembly, within
tests/test_torch_solver.py's test_solve_window_matches tolerances (one step
5e-5, four 1e-2 on the states; costs 1e-4 / 1e-3).  Skips without a card.
It imports no JAX; on the card run it without the suite's conftest.py,
which does:

    python -m pytest --noconftest tests/test_torch_assemble_card.py
"""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (the suite's torch thread cap)
import assemble_cases


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 is a CUDA kernel with no CPU mode")
    import esvio_tpu_torch
    esvio_tpu_torch.disable_tf32()
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", assemble_cases.CASES)
def test_k4_matches_the_plain_assembly_on_the_card(card, case):
    errs, _ = assemble_cases.compare(case, card)
    assert max(errs.values()) < assemble_cases.TOL


@pytest.mark.card
@pytest.mark.parametrize("iters,atol", [(1, 5e-5), (4, 1e-2)])
def test_solve_window_through_k4_matches_the_plain_loop(card, iters, atol):
    from esvio_tpu_torch import _kernels
    before = _kernels.NORMAL_ASSEMBLY.launches
    k4, plain = assemble_cases.solve_pair(card, iters)
    assert _kernels.NORMAL_ASSEMBLY.launches == before + 1 + iters
    np.testing.assert_allclose(k4[3].cpu().numpy(), plain[3].cpu().numpy(),
                               rtol=1e-4 if iters == 1 else 1e-3)
    for f in ("P", "Q", "V", "Ba", "Bg"):
        np.testing.assert_allclose(getattr(k4[0], f).cpu().numpy(),
                                   getattr(plain[0], f).cpu().numpy(),
                                   atol=atol, err_msg=f)
    if iters == 1:
        np.testing.assert_allclose(k4[2].inv_depth.cpu().numpy(),
                                   plain[2].inv_depth.cpu().numpy(), atol=2e-4)
    else:
        assert k4[3][-1] < k4[3][0]
