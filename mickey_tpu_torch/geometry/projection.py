"""Camera projection primitives (``mickey_tpu/geometry/projection.py``)."""

from __future__ import annotations

import torch


def inv_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of zero-skew pinhole intrinsics, (..., 3, 3)."""
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    row0 = torch.stack([1.0 / fx, zeros, -cx / fx], dim=-1)
    row1 = torch.stack([zeros, 1.0 / fy, -cy / fy], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def backproject_3d(uv: torch.Tensor, depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """uv (..., N, 2) pixels, depth (..., N, 1), K (..., 3, 3) -> xyz (..., N, 3)."""
    uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    xyz = torch.einsum("...ij,...nj->...ni", inv_intrinsics(K), uv1)
    return depth * xyz


def project_2d(xyz: torch.Tensor, K: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """xyz (..., N, 3) camera-frame points -> pixels (..., N, 2), with the
    reference's +1e-16 depth guard (no abs)."""
    cam = torch.einsum("...ij,...nj->...ni", K, xyz)
    return cam[..., :2] / (cam[..., 2:3] + eps)


def transform_points(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3) @ X (..., N, 3) + t (..., 1, 3), as broadcast multiply-adds."""
    return (X[..., None, :] * R[..., None, :, :]).sum(dim=-1) + t
