"""RANSAC hypothesis scoring: soft inlier count of every candidate pose.

Counterpart of ``mickey_tpu/ops/hypothesis_scoring.py::fused_hypothesis_scores``.
On a CUDA tensor the wrapper launches ``csrc/hypothesis_scoring.cu``; on a
CPU tensor it takes the plain version, ``geometry.soft_inlier_counting_3d``
in broadcast form, which writes the (B, R, S) residuals the kernel never
materializes. The batch axis is any stack of point sets: the solver passes
its it_matches outer draws times B pairs at once.
"""

from __future__ import annotations

import torch

from ..geometry.inliers import soft_inlier_counting_3d
from . import _cuda


def hypothesis_scores_plain(X, Y, R, t, th: float) -> torch.Tensor:
    B, nR = R.shape[:2]
    return soft_inlier_counting_3d(X[:, None], Y[:, None], R, t.reshape(B, nR, 1, 3), th=th)[..., 0]


def hypothesis_scores(X: torch.Tensor, Y: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                      th: float) -> torch.Tensor:
    """X, Y: (B, S, 3); R: (B, nR, 3, 3); t: (B, nR, 1, 3) or (B, nR, 3).
    Returns (B, nR) fp32 soft inlier counts at threshold ``th``."""
    if X.device.type == "cpu":
        return hypothesis_scores_plain(X, Y, R, t, th)
    B, S, _ = X.shape
    nR = R.shape[1]
    R9 = R.reshape(B, nR, 9).contiguous()
    t3 = t.reshape(B, nR, 3).contiguous()
    for a, name, shape in ((X, "X", (B, S, 3)), (Y, "Y", (B, S, 3)), (R9, "R", (B, nR, 9)),
                           (t3, "t", (B, nR, 3))):
        _cuda.require(a, name, torch.float32, shape, X.device)
    out = torch.empty((B, nR), dtype=torch.float32, device=X.device)
    rc = _cuda.lib().mk_hypothesis_scores_f32(
        X.data_ptr(), Y.data_ptr(), R9.data_ptr(), t3.data_ptr(), out.data_ptr(),
        B, S, nR, float(th), _cuda.stream_ptr(X),
    )
    _cuda.check(rc, "hypothesis_scores")
    _cuda.LAUNCHES["hypothesis_scores"] += 1
    return out
