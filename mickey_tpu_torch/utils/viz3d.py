"""3D visualization: camera frusta + inlier point cloud
(``mickey_tpu/utils/viz3d.py``).

Counterpart of reference ``lib/utils/visualization.py::get_render`` /
``create_point_cloud_from_inliers`` (pyrender/trimesh offscreen rendering).
Without pyrender, ``get_render`` is a matplotlib 3D projection (matplotlib
imported when it runs) producing the same content: the two camera frusta
(reference=orange, destination=blue, reference convention colors
demo_inference.py:49), the 3D inlier point cloud color-coded by position,
and a confidence annotation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..geometry.projection import backproject_3d


def create_point_cloud_from_inliers(inliers: np.ndarray, K0: np.ndarray, use_3d_color_coded: bool = True):
    """Inlier rows [x0 y0 x1 y1 score d0 d1] -> (points (N,3), colors (N,3)).

    Counterpart of reference visualization.py:53-78: backproject image-0
    inlier keypoints with their depths, color-code by 3D position.
    """
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    X = backproject_3d(t(inliers[None, :, :2]), t(inliers[None, :, 5:6]), t(K0[None]))[0].numpy()

    if use_3d_color_coded and len(X) > 0:
        def norm(v):
            v = v - v.min()
            return v / (v.max() + 1e-16)

        colors = np.stack([norm(X[:, 1]), norm(X[:, 2]), norm(X[:, 0])], axis=1)
    else:
        colors = np.full((len(X), 3), 0.3)
    return X, colors


def _frustum_lines(P: np.ndarray, K: np.ndarray, w: float, h: float, scale: float = 0.35):
    """Camera frustum edge segments in world coords for cam2world pose P (4,4)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    corners_px = np.array([[0, 0], [w, 0], [w, h], [0, h]], dtype=np.float64)
    rays = np.stack(
        [(corners_px[:, 0] - cx) / fx, (corners_px[:, 1] - cy) / fy, np.ones(4)], axis=1
    )
    corners = rays * scale
    pts = np.concatenate([np.zeros((1, 3)), corners], axis=0)  # origin + 4 corners
    pts_w = (P[:3, :3] @ pts.T).T + P[:3, 3]
    segs = []
    for i in range(1, 5):
        segs.append((pts_w[0], pts_w[i]))
    for i in range(1, 5):
        segs.append((pts_w[i], pts_w[1 + (i % 4)]))
    return segs


def get_render(
    P: np.ndarray,
    K0: np.ndarray,
    K1: np.ndarray,
    image_wh,
    points: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    confidence: Optional[float] = None,
    max_confidence: float = 2048.0,
    color_src_frame=(223, 71, 28),
    color_dst_frame=(83, 154, 218),
    elev: float = -25.0,
    azim: float = 0.0,
) -> np.ndarray:
    """Render cameras + point cloud to an RGB uint8 image.

    P: (4, 4) cam2world pose of the destination camera relative to the
    reference camera (which sits at the origin). Counterpart of reference
    ``get_render`` (visualization.py) with matplotlib instead of pyrender.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8), dpi=100)
    ax = fig.add_subplot(111, projection="3d")

    w, h = image_wh
    src = np.array(color_src_frame) / 255.0
    dst = np.array(color_dst_frame) / 255.0
    for seg in _frustum_lines(np.eye(4), K0, w, h):
        ax.plot(*np.stack(seg).T, color=src, linewidth=1.5)
    for seg in _frustum_lines(P, K1, w, h):
        ax.plot(*np.stack(seg).T, color=dst, linewidth=1.5)

    if points is not None and len(points):
        c = colors if colors is not None else "gray"
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=c, s=4, depthshade=False)

    if confidence is not None:
        frac = min(confidence / max_confidence, 1.0)
        ax.set_title(f"confidence: {confidence:.0f} ({100 * frac:.0f}%)")

    # consistent scale
    all_pts = [np.zeros((1, 3)), P[:3, 3][None]]
    if points is not None and len(points):
        all_pts.append(points)
    all_pts = np.concatenate(all_pts)
    center = all_pts.mean(0)
    radius = max(np.abs(all_pts - center).max(), 1.0)
    ax.set_xlim(center[0] - radius, center[0] + radius)
    ax.set_ylim(center[1] - radius, center[1] + radius)
    ax.set_zlim(center[2] - radius, center[2] + radius)
    ax.view_init(elev=elev, azim=azim)
    ax.invert_yaxis()
    ax.set_axis_off()

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return buf
