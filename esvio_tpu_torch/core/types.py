"""Shared state dataclasses (port of esvio_tpu/core/types.py).

The port keeps the reference's fixed-capacity + validity-mask layout for
every variable-size structure, so its arrays have the JAX package's shapes.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Pose:
    """SE(3) pose: translation + unit quaternion (w, x, y, z)."""

    p: torch.Tensor  # (..., 3)
    q: torch.Tensor  # (..., 4)


def identity_pose(dtype=torch.float32, device="cuda") -> Pose:
    return Pose(p=torch.zeros(3, dtype=dtype, device=device),
                q=torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device))
