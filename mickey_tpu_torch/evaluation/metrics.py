"""Vectorized per-frame metrics for the offline Map-free evaluator, numpy only
(``mickey_tpu/evaluation/metrics.py``).

The reference scores one frame at a time through a registry of per-frame
metric callables (``benchmark/metrics.py:32-67``); here a whole scene is
scored in one batched numpy pass over aligned pose tables. The metric set and
definitions are the official protocol: translation error (meters), rotation
error (degrees, sin variant), VCRE reprojection error (pixels), confidence.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .pose_io import PoseTable, quat_angle_error
from .reprojection import reprojection_errors

METRIC_NAMES = ("trans_err", "rot_err", "reproj_err", "confidence")


def score_frames(
    gt: PoseTable, est: PoseTable, K: np.ndarray, W: float, H: float
) -> Dict[str, np.ndarray]:
    """All per-frame metrics for N aligned frames at once.

    ``gt`` and ``est`` must be row-aligned (same frame in the same row);
    ``K`` is (N, 3, 3). Returns {metric: (N,) float64}.
    """
    assert len(gt) == len(est), "pose tables must be frame-aligned"
    if len(gt) == 0:
        return {name: np.zeros((0,)) for name in METRIC_NAMES}
    return {
        "trans_err": np.linalg.norm(est.t - gt.t, axis=1),
        "rot_err": quat_angle_error(est.q, gt.q)[:, 0],
        "reproj_err": reprojection_errors(est.q, est.t, gt.q, gt.t, K, W, H),
        "confidence": est.conf.astype(np.float64),
    }
