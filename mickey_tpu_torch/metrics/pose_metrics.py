"""Pose and VCRE metrics of training and validation
(``mickey_tpu/metrics/pose_metrics.py``).

``pose_error`` and ``vcre`` are batched torch functions on the tensors'
device; ``error_auc``, ``a_metrics``, ``MetricsAccumulator``, ``ecdf``,
``precision`` and ``print_auc_table`` are numpy on the host, bitwise the JAX
package's.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from ..evaluation.reprojection import get_grid_multipleheight
from ..geometry.projection import project_2d

_EYE_COORDS = get_grid_multipleheight()  # (196, 4) float64
# np.trapz was renamed in numpy 2.0; the card's machine may have either
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def pose_error(R: torch.Tensor, t: torch.Tensor, Tgt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Angular, scale and euclidean translation errors and the angular
    rotation error, each (B,). R: (B, 3, 3); t: (B, 1, 3); Tgt: (B, 4, 4)."""
    Rgt = Tgt[:, :3, :3]
    tgt = Tgt[:, :3, 3:].transpose(1, 2)  # (B, 1, 3)

    scale_t = torch.linalg.norm(t, dim=-1)
    scale_tgt = torch.linalg.norm(tgt, dim=-1)

    cosine = torch.einsum("bij,bkj->bik", t, tgt)[:, :, 0] / (scale_t * scale_tgt + 1e-9)
    cosine = torch.clamp(cosine, -1.0, 1.0)
    t_ang_err = torch.rad2deg(torch.acos(cosine))
    t_ang_err = torch.minimum(t_ang_err, 180.0 - t_ang_err)

    t_scale_err = scale_t / scale_tgt
    t_scale_err_sym = torch.maximum(scale_t / scale_tgt, scale_tgt / scale_t)
    t_euclidean_err = torch.linalg.norm(t - tgt, dim=-1)

    residual = torch.einsum("bji,bjk->bik", R, Rgt)
    trace = residual.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_r = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    R_err = torch.rad2deg(torch.acos(cos_r))

    return {
        "t_err_ang": t_ang_err[:, 0],
        "t_err_scale": t_scale_err[:, 0],
        "t_err_scale_sym": t_scale_err_sym[:, 0],
        "t_err_euc": t_euclidean_err[:, 0],
        "R_err": R_err,
    }


def vcre(R: torch.Tensor, t: torch.Tensor, Tgt: torch.Tensor, K0: torch.Tensor, H: int = 720,
         W: int = 540) -> torch.Tensor:
    """Virtual Correspondences Reprojection Error, (B,): the 7x4x7 eye grid
    through the residual transform inv(cam2w_gt) @ cam2w_est, both
    projections clipped to the W x H image, the mean point distance."""
    B = R.shape[0]
    eye = torch.as_tensor(_EYE_COORDS, dtype=torch.float32, device=R.device)[None, :, :3]
    eye = eye.expand(B, -1, -1)

    uv_gt = project_2d(eye, K0)

    Rgt = Tgt[:, :3, :3]
    tgt = Tgt[:, :3, 3]
    # residual rotation Rgt^T R and translation Rgt^T (t - tgt)
    Rres = torch.einsum("bji,bjk->bik", Rgt, R)
    tres = torch.einsum("bji,bj->bi", Rgt, t[:, 0] - tgt)
    eyes_residual = torch.einsum("bij,bnj->bni", Rres, eye) + tres[:, None, :]
    uv_pred = project_2d(eyes_residual, K0)

    def clip(uv):
        return torch.stack([torch.clamp(uv[..., 0], 0, W), torch.clamp(uv[..., 1], 0, H)], dim=-1)

    uv_gt, uv_pred = clip(uv_gt), clip(uv_pred)
    err = torch.sqrt(torch.sum((uv_gt - uv_pred) ** 2, dim=-1) + 1e-6)
    return err.mean(dim=-1)


def error_auc(errors: np.ndarray, thresholds) -> Dict[str, float]:
    """Recall-AUC under error thresholds."""
    errors = np.nan_to_num(np.asarray(errors, np.float64), nan=float("inf"))
    errors = np.array([0] + sorted(errors.tolist()))
    recall = np.linspace(0, 1, len(errors))
    aucs = {}
    for thr in thresholds:
        last = np.searchsorted(errors, thr)
        y = np.r_[recall[:last], recall[max(last - 1, 0)]]
        x = np.r_[errors[:last], thr]
        aucs[f"auc@{thr}"] = float(_trapezoid(y, x) / thr)
    return aucs


def a_metrics(t_scale_err_sym: np.ndarray):
    """A1 / A2 / A3 scale accuracies: shares under 1.25, 1.25^2, 1.25^3."""
    thresh = np.asarray(t_scale_err_sym)
    return tuple(float((thresh < 1.25**k).mean()) for k in (1, 2, 3))


class MetricsAccumulator:
    """Accumulate per-batch metric dicts; aggregate to flat numpy arrays."""

    def __init__(self):
        self.data = defaultdict(list)

    def accumulate(self, d: Dict[str, np.ndarray]):
        for k, v in d.items():
            v = v.detach().cpu().numpy() if torch.is_tensor(v) else v
            self.data[k].append(np.asarray(v).reshape(-1))

    def aggregate(self) -> Dict[str, np.ndarray]:
        return {k: np.concatenate(v) for k, v in self.data.items()}


def ecdf(x: np.ndarray):
    """Empirical CDF: (sorted values, cdf)."""
    cd = np.linspace(0, 1, np.asarray(x).shape[0])
    v = np.sort(np.asarray(x))
    return v, cd


def precision(agg_metrics: Dict[str, np.ndarray], rot_threshold: float, trans_threshold: float) -> float:
    """Share of samples within both thresholds."""
    mask_rot = np.asarray(agg_metrics["R_err"]) <= rot_threshold
    mask_trans = np.asarray(agg_metrics["t_err_euc"]) <= trans_threshold
    return float((mask_rot * mask_trans).mean())


def print_auc_table(agg_metrics: Dict[str, np.ndarray]) -> None:
    """Console AUC summary."""
    pose_err = np.maximum(np.asarray(agg_metrics["R_err"]), np.asarray(agg_metrics["t_err_ang"]))
    a = error_auc(pose_err, (5, 10, 20))
    print("Pose error AUC @ 5/10/20deg: {0:.3f}/{1:.3f}/{2:.3f}".format(*a.values()))
    a = error_auc(agg_metrics["R_err"], (5, 10, 20))
    print("Rotation error AUC @ 5/10/20deg: {0:.3f}/{1:.3f}/{2:.3f}".format(*a.values()))
    a = error_auc(agg_metrics["t_err_ang"], (5, 10, 20))
    print("Translation angular error AUC @ 5/10/20deg: {0:.3f}/{1:.3f}/{2:.3f}".format(*a.values()))
    a = error_auc(agg_metrics["t_err_euc"], (0.1, 0.5, 1))
    print("Translation Euclidean error AUC @ 0.1/0.5/1m: {0:.3f}/{1:.3f}/{2:.3f}".format(*a.values()))
