"""Visualization utilities, numpy and ``cv2`` on the host
(``mickey_tpu/utils/viz.py``): score heatmaps, depth colorization, match and
REINFORCE-reward panels for the trainer's image logging. ``cv2`` is
imported when a function runs, as in the JAX package; colours come from the
port's own tables (``utils.colormaps``), not from matplotlib.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .colormaps import lookup


def colorize(
    value: np.ndarray,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    cmap: str = "magma_r",
    invalid_val: float = -99,
    invalid_mask: Optional[np.ndarray] = None,
    background_color=(0, 0, 0, 255),
) -> np.ndarray:
    """Depth map -> RGBA uint8 (H, W, 4) via percentile normalization;
    ``cmap`` names a table of ``utils.colormaps``."""
    value = np.asarray(value, dtype=np.float32).squeeze()
    if invalid_mask is None:
        invalid_mask = value == invalid_val
    else:
        invalid_mask = np.asarray(invalid_mask).squeeze()
        if (~invalid_mask).sum() == 0:
            invalid_mask = value == invalid_val
    mask = ~invalid_mask

    if mask.sum() == 0:
        return np.zeros(value.shape + (4,), np.uint8)
    vmin = np.percentile(value[mask], 2) if vmin is None else vmin
    vmax = np.percentile(value[mask], 85) if vmax is None else vmax
    value = (value - vmin) / (vmax - vmin) if vmin != vmax else value * 0.0
    value = value.astype(np.float64)
    value[invalid_mask] = np.nan
    img = lookup(cmap, value)
    img[invalid_mask] = background_color
    return img


def colorize_depth(depth_map: np.ndarray, invalid_mask=None, down_factor: int = 14) -> np.ndarray:
    """Colorized depth resized to input resolution.

    depth_map: (H, W) or (H, W, 1) patch-grid depth. Returns RGBA uint8 at
    (H*down_factor, W*down_factor).
    """
    import cv2

    img = colorize(depth_map, invalid_mask=invalid_mask)
    img = cv2.cvtColor(np.asarray(img, np.uint8), cv2.COLOR_BGR2RGBA)
    h, w = img.shape[:2]
    return cv2.resize(img, (w * down_factor, h * down_factor), interpolation=cv2.INTER_LINEAR)


def prepare_score_map(scores: np.ndarray, image: np.ndarray, temperature: float = 0.5) -> np.ndarray:
    """Green score heatmap over a grayscale image.

    scores: (N,) or (1, N) patch scores; image: (H, W, 3) float [0, 1].
    Returns uint8 BGR (H, W, 3) ready for cv2.imwrite.
    """
    import cv2

    sc = np.asarray(scores).reshape(-1)
    mx, mn = sc.max(), sc.min()

    base = np.ascontiguousarray((255 * np.asarray(image)).astype(np.uint8))
    gray = cv2.cvtColor(base, cv2.COLOR_BGR2GRAY)
    sc_map = np.tile(gray[:, :, None], [1, 1, 3])

    grid_h, grid_w = base.shape[0] // 14, base.shape[1] // 14
    heat = sc.reshape(grid_h, grid_w)
    heat = 255 * np.tanh(((heat - mn) / (mx - mn + 1e-16)) / temperature)
    heat = cv2.resize(heat, (base.shape[1], base.shape[0]))[:, :, None]
    heat = np.concatenate([np.zeros_like(heat), heat, np.zeros_like(heat)], axis=-1)
    return cv2.addWeighted(sc_map, 1.0, heat.astype(np.uint8), 0.6, 0)


def draw_matches(
    image0: np.ndarray,
    image1: np.ndarray,
    pts0: np.ndarray,
    pts1: np.ndarray,
    scores: Optional[np.ndarray] = None,
    max_matches: int = 60,
    gap: int = 50,
) -> np.ndarray:
    """Side-by-side match visualization. Returns float (H, W, 3) in [0, 1]."""
    import cv2

    im0 = (255 * np.asarray(image0)).astype(np.float64)
    im1 = (255 * np.asarray(image1)).astype(np.float64)
    h, w = im0.shape[:2]
    canvas = 255 * np.ones((h, w * 2 + gap, 3))
    canvas[:, :w] = im0
    canvas[:, w + gap :] = im1

    n = min(max_matches, len(pts0))
    sc = np.asarray(scores) if scores is not None else np.ones(len(pts0))
    sc_norm = sc / (sc.max() + 1e-16)
    for i in range(n):
        p0 = tuple(int(v) for v in pts0[i])
        p1 = (int(pts1[i][0]) + w + gap, int(pts1[i][1]))
        color = [0, int(255 * np.tanh(sc_norm[i] / 0.3)), 0]
        canvas = cv2.line(canvas, p0, p1, color, 2)
        canvas = cv2.circle(canvas, p0, 3, color, 2)
        canvas = cv2.circle(canvas, p1, 3, color, 2)
    return canvas / 255.0


def draw_reward_matches(
    image0: np.ndarray,
    image1: np.ndarray,
    pts0: np.ndarray,
    pts1: np.ndarray,
    coeffs: np.ndarray,
    max_points: int = 30,
    gap: int = 50,
) -> np.ndarray:
    """REINFORCE reward visualization: sampled correspondences colored green
    (reward: a negative coefficient pushes the match probability up) or red
    (penalty). Returns float (H, W', 3)."""
    import cv2

    im0 = (255 * np.asarray(image0)).astype(np.float64)
    im1 = (255 * np.asarray(image1)).astype(np.float64)
    h, w = im0.shape[:2]
    canvas = 255 * np.ones((h, w * 2 + gap, 3))
    canvas[:, :w] = im0
    canvas[:, w + gap :] = im1

    c = np.asarray(coeffs, np.float64)
    rel = c - c.min()
    rel = 1.0 - rel / (rel.max() + 1e-16)  # 1 = best (lowest loss), 0 = worst

    order = np.argsort(rel)
    pick = np.concatenate([order[: max_points // 2], order[-max_points // 2 :]])
    for i in pick:
        p0 = tuple(int(v) for v in pts0[i])
        p1 = (int(pts1[i][0]) + w + gap, int(pts1[i][1]))
        if rel[i] < 0.5:
            color = [int((1 - rel[i]) * 255), 0, 0]
        else:
            color = [0, int(rel[i] * 255), 0]
        canvas = cv2.line(canvas, p0, p1, color, 1)
        canvas = cv2.circle(canvas, p0, 6, color, 2)
        canvas = cv2.circle(canvas, p1, 6, color, 2)
    return canvas / 255.0
