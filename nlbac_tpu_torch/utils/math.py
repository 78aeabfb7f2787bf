"""Small math utilities on tensors (port of ``nlbac_tpu/utils/math.py``):
action scaling between [-1, 1] and env bounds, 2-D rotation helpers and
angle wrapping."""

from __future__ import annotations

import torch


def _bounds(low, high, like):
    return (torch.as_tensor(low, dtype=torch.float32, device=like.device),
            torch.as_tensor(high, dtype=torch.float32, device=like.device))


def scale_action(action, low, high):
    """[-1, 1] -> [low, high]."""
    low, high = _bounds(low, high, action)
    return low + 0.5 * (action + 1.0) * (high - low)


def unscale_action(action, low, high):
    """[low, high] -> [-1, 1]."""
    low, high = _bounds(low, high, action)
    return 2.0 * (action - low) / (high - low) - 1.0


def rot_2d(theta):
    """World->body 2-D rotation matrices for a batch of angles:
    (...,) -> (..., 2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    row0 = torch.stack([c, s], dim=-1)
    row1 = torch.stack([-s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def rotate(vec, theta):
    """Rotate (..., 2) vectors into the body frame of angle theta."""
    return torch.einsum("...ij,...j->...i", rot_2d(theta), vec)


def wrap_angle(theta):
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))
