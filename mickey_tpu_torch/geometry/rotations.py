"""Quaternion / rotation-matrix utilities in numpy
(``mickey_tpu/geometry/rotations.py``, its numpy functions).

The reference relies on ``transforms3d`` (qinverse/qmult/rotate_vector/
quat2mat/mat2quat) for dataset pose composition and submission writing; these
are the same operations. Quaternion convention: (w, x, y, z), matching
transforms3d and the Map-free pose file format ``qw qx qy qz``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "qinverse",
    "qmult",
    "rotate_vector",
    "quat2mat",
    "mat2quat",
    "qnorm",
    "quats_to_mats",
    "qmult_batch",
]


def qnorm(q):
    return np.asarray(q) / np.linalg.norm(q)


def qinverse(q):
    """Inverse of a (possibly non-unit) quaternion."""
    q = np.asarray(q, dtype=np.float64)
    n2 = (q * q).sum()
    conj = np.array([q[0], -q[1], -q[2], -q[3]])
    return conj / n2


def qmult(q1, q2):
    """Hamilton product q1*q2, (w,x,y,z) convention."""
    w1, x1, y1, z1 = np.asarray(q1, dtype=np.float64)
    w2, x2, y2, z2 = np.asarray(q2, dtype=np.float64)
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def rotate_vector(v, q):
    """Rotate vector v by unit quaternion q (w,x,y,z)."""
    v = np.asarray(v, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    return quat2mat(q) @ v


def quat2mat(q):
    """Unit quaternion (w,x,y,z) -> 3x3 rotation matrix (numpy, float64)."""
    q = np.asarray(q, dtype=np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def mat2quat(R):
    """3x3 rotation matrix -> unit quaternion (w,x,y,z), numpy.

    Shepperd's method (branch on the largest diagonal term) for numerical
    stability across the full rotation range.
    """
    R = np.asarray(R, dtype=np.float64).reshape(3, 3)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def quats_to_mats(q: np.ndarray) -> np.ndarray:
    """Batched (N, 4) unit-normalized quaternions (w,x,y,z) -> (N, 3, 3)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def qmult_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Batched Hamilton product (..., 4) x (..., 4) -> (..., 4), (w,x,y,z)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )
