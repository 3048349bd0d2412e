"""The extrinsic drive of test_torch_init_ex_rotation.py with
ex_calib_require_stable: the scale-invariant gate waits for 3 consecutive
solves within 1° (tolerances there)."""
import pytest

from test_torch_init_ex_rotation import ex_rotation_drive_matches_jax


@pytest.mark.parametrize("require_stable", [True])
def test_ex_rotation_drive_matches_jax(require_stable):
    ex_rotation_drive_matches_jax(require_stable)
