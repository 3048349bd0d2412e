"""Kernel K3 on the card against the plain LK pair at the benchmark cells'
shapes: 346x260 time surfaces and frames, 640x480 time surfaces, 256 lanes
(tests/lk_cases.py holds the inputs, the tolerances and their reason: the
kernel's sums run in another order).  Skips without a card.  It imports no
JAX; on the card run it without the suite's conftest.py, which does:

    python -m pytest --noconftest tests/test_torch_lk_card.py
"""
import pytest
import torch

import torch_parity  # noqa: F401  (the suite's torch thread cap)
import lk_cases


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 is a CUDA kernel with no CPU mode")
    import esvio_tpu_torch
    esvio_tpu_torch.disable_tf32()
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("kind,H,W", lk_cases.CASES)
def test_k3_matches_the_plain_pair_on_the_card(card, kind, H, W):
    from esvio_tpu_torch import _kernels
    before = _kernels.LK_TRACK.launches
    out = lk_cases.compare(kind, H, W, seed=H * W, device=card)
    assert _kernels.LK_TRACK.launches == before + 1
    assert out["unsettled"] < lk_cases.LANES // 10
