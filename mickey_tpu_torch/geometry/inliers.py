"""Inlier counting for 3D-3D hypotheses and 2D reprojections
(``mickey_tpu/geometry/inliers.py``)."""

from __future__ import annotations

import torch

from .projection import project_2d, transform_points


def pairwise_distance(X0, X1, R, t) -> torch.Tensor:
    """||R X0 + t - X1|| per correspondence, with the reference's +1e-6: (..., N)."""
    d2 = ((transform_points(R, t, X0) - X1) ** 2).sum(dim=-1)
    return torch.sqrt(d2 + 1e-6)


def soft_inlier_counting_3d(X0, X1, R, t, th: float = 0.5) -> torch.Tensor:
    """sum sigmoid((5/th)(th - dist)): (..., 1)."""
    scores = torch.sigmoid((5.0 / th) * (th - pairwise_distance(X0, X1, R, t)))
    return scores.sum(dim=-1, keepdim=True)


def inlier_counting_3d(X0, X1, R, t, th: float = 0.5) -> torch.Tensor:
    """Hard inlier mask (..., N) in {0, 1}."""
    return ((th - pairwise_distance(X0, X1, R, t)) >= 0).to(X0.dtype)


def soft_inlier_counting_2d(X0, xy1, R, t, K1, th: float = 10.0) -> torch.Tensor:
    """2D reprojection soft inlier count (training_utils.py:45-52): X0 moved
    by (R, t), projected with K1, sigmoid((5/th)(th - pixel distance to xy1))
    summed: (..., 1)."""
    d2 = ((project_2d(transform_points(R, t, X0), K1) - xy1) ** 2).sum(dim=-1)
    scores = torch.sigmoid((5.0 / th) * (th - torch.sqrt(d2 + 1e-6)))
    return scores.sum(dim=-1, keepdim=True)
