"""The VCRE virtual eye grid (``mickey_tpu/evaluation/reprojection.py``),
numpy only; the training loss projects it (``training/loss_utils.py``)."""

from __future__ import annotations

import numpy as np


def get_grid_multipleheight() -> np.ndarray:
    """7x4x7 homogeneous eye-coordinate grid, 0.3 m step, 1.8 m z-offset:
    (196, 4)."""
    step, nx, ny, nz, z_off, y_off = 0.3, 7, 4, 7, 1.8, 0.0
    xs = (np.arange(nx) - (nx - 1) / 2) * step
    ys = (np.arange(ny) - (ny - 1) / 2) * step + y_off
    zs = np.arange(nz).astype(float) * step + z_off
    xx, yy, zz = np.meshgrid(xs, ys, zs)
    ones = np.ones(xx.size)
    return np.concatenate([c.reshape(-1, 1) for c in (xx, yy, zz, ones)], axis=-1)
