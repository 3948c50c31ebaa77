# Frozen copy of carla_ppo_tpu_torch/envs/geometry.py (commit cbdb1fb), the benchmark's
# reference: imports made local.
# It imports nothing of the program and is not edited when the program changes.
"""Vectorised 2D geometry helpers (port of carla_ppo_tpu/envs/geometry.py).

All functions broadcast over leading dims; 2D vectors live on the last axis.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor


def wrap_angle(angle: Tensor) -> Tensor:
    """Wrap an angle to (-pi, pi]."""
    wrapped = torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi
    return torch.where(wrapped == -math.pi, torch.full_like(wrapped, math.pi), wrapped)


def angle_diff(v0: Tensor, v1: Tensor) -> Tensor:
    """Signed angle (-pi, pi] from 2D vector v0 to v1."""
    angle = torch.atan2(v1[..., 1], v1[..., 0]) - torch.atan2(v0[..., 1], v0[..., 0])
    return wrap_angle(angle)


def distance_to_line(a: Tensor, b: Tensor, p: Tensor) -> Tensor:
    """Distance from p to the infinite line through a and b."""
    ab = b - a
    ap = p - a
    cross = ab[..., 0] * ap[..., 1] - ab[..., 1] * ap[..., 0]
    denom = torch.linalg.vector_norm(ab, dim=-1)
    degenerate = denom < 1e-8
    safe = torch.where(degenerate, torch.ones_like(denom), denom)
    return torch.where(
        degenerate, torch.linalg.vector_norm(ap, dim=-1), cross.abs() / safe
    )


def signed_distance_to_line(a: Tensor, b: Tensor, p: Tensor) -> Tensor:
    """Signed version: positive when p is left of a->b."""
    ab = b - a
    ap = p - a
    cross = ab[..., 0] * ap[..., 1] - ab[..., 1] * ap[..., 0]
    denom = torch.linalg.vector_norm(ab, dim=-1)
    safe = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
    return cross / safe
