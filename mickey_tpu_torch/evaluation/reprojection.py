"""VCRE reprojection error, numpy only (``mickey_tpu/evaluation/reprojection.py``):
the virtual eye grid 7x4x7 at 0.3 m step with 1.8 m z-offset, projected
through the residual transform between estimated and ground-truth cam2world
poses. The training loss projects the grid too (``training/loss_utils.py``).
"""

from __future__ import annotations

import numpy as np

from ..geometry.rotations import quats_to_mats


def project(pts: np.ndarray, K: np.ndarray, img_size=None) -> np.ndarray:
    """Project (N, 3|4) camera-frame points with K (3, 3); optional clamping."""
    assert pts.ndim == 2 and pts.shape[1] in (3, 4)
    uv_h = (K @ pts[:, :3].T).T
    uv = uv_h[:, :2] / uv_h[:, -1:]
    if img_size is not None:
        uv[:, 0] = np.clip(uv[:, 0], 0, img_size[0])
        uv[:, 1] = np.clip(uv[:, 1], 0, img_size[1])
    return uv


def get_grid_multipleheight() -> np.ndarray:
    """7x4x7 homogeneous eye-coordinate grid (reference reprojection.py:32-56)."""
    step, nx, ny, nz, z_off, y_off = 0.3, 7, 4, 7, 1.8, 0.0
    xs = (np.arange(nx) - (nx - 1) / 2) * step
    ys = (np.arange(ny) - (ny - 1) / 2) * step + y_off
    zs = np.arange(nz).astype(float) * step + z_off
    xx, yy, zz = np.meshgrid(xs, ys, zs)
    ones = np.ones(xx.size)
    return np.concatenate([c.reshape(-1, 1) for c in (xx, yy, zz, ones)], axis=-1)


eye_coords_glob = get_grid_multipleheight()


def reprojection_errors(q_est, t_est, q_gt, t_gt, K, W, H) -> np.ndarray:
    """Batched mean VCRE over N frames; all poses cam2world.

    The residual transform inv(T_est) @ T_gt is built analytically
    ([R|t]^-1 = [R^T|-R^T t]) and the 196-point eye grid is projected for all
    frames in one einsum pass (behavior spec: reference
    ``benchmark/reprojection.py:63-87``, one frame at a time there).
    """
    q_est = np.atleast_2d(np.asarray(q_est, np.float64))
    q_gt = np.atleast_2d(np.asarray(q_gt, np.float64))
    t_est = np.atleast_2d(np.asarray(t_est, np.float64))
    t_gt = np.atleast_2d(np.asarray(t_gt, np.float64))
    K = np.asarray(K, np.float64).reshape(-1, 3, 3)

    R_est, R_gt = quats_to_mats(q_est), quats_to_mats(q_gt)
    # residual rotation/translation of inv(T_est) @ T_gt
    R_res = np.einsum("nji,njk->nik", R_est, R_gt)
    t_res = np.einsum("nji,nj->ni", R_est, t_gt - t_est)

    grid = eye_coords_glob[:, :3]  # (G, 3)
    pts = np.einsum("nij,gj->ngi", R_res, grid) + t_res[:, None, :]

    def _proj(p):  # (N, G, 3) -> clipped (N, G, 2)
        uv = np.einsum("nij,ngj->ngi", K, p)
        uv = uv[..., :2] / uv[..., 2:3]
        return np.clip(uv, 0.0, np.array([W, H], np.float64))

    uv_gt = _proj(np.broadcast_to(grid, pts.shape))
    uv_pred = _proj(pts)
    return np.linalg.norm(uv_gt - uv_pred, axis=-1).mean(axis=-1)


def reprojection_error(q_est, t_est, q_gt, t_gt, K, W, H) -> float:
    """Mean VCRE for one frame; q/t are cam2world (reference :63-87)."""
    return float(reprojection_errors(q_est, t_est, q_gt, t_gt, K, W, H)[0])
