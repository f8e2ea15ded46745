"""Pose tables and ranking metrics for the offline Map-free evaluator, numpy
only (``mickey_tpu/evaluation/pose_io.py``).

Design: pose/intrinsics files are parsed into flat parallel numpy arrays (a
``PoseTable``) and all geometry — the world2cam -> cam2world inversion and
quaternion angle errors — runs batched over whole scenes, rather than one
frame at a time through dicts of tuples. Behavior spec (file format, frame
numbering, skip-and-warn policy, sin/cos angle variants, ranked average
precision): reference ``benchmark/utils.py:12-186``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..geometry.rotations import qmult_batch, quats_to_mats

VARIANTS_ANGLE_SIN = "sin"
VARIANTS_ANGLE_COS = "cos"

LOG = logging.getLogger(__name__)


@dataclass
class PoseTable:
    """Per-frame cam2world poses of one scene as parallel arrays."""

    frame: np.ndarray  # (N,)   int64 frame numbers
    q: np.ndarray  # (N, 4) cam2world quaternions (w,x,y,z)
    t: np.ndarray  # (N, 3) cam2world translations (camera centers)
    conf: np.ndarray  # (N,)   confidences (nan when the file carries none)

    def __len__(self) -> int:
        return self.frame.shape[0]

    def take(self, idx: np.ndarray) -> "PoseTable":
        return PoseTable(self.frame[idx], self.q[idx], self.t[idx], self.conf[idx])

    def positions_of(self, frames: np.ndarray) -> np.ndarray:
        """Row index of each requested frame number, or -1 if absent."""
        frames = np.asarray(frames)
        if len(self) == 0:
            return np.full(frames.shape, -1, dtype=np.int64)
        order = np.argsort(self.frame)
        pos = np.searchsorted(self.frame, frames, sorter=order)
        pos = np.clip(pos, 0, len(self) - 1)
        rows = order[pos]
        rows = np.where(self.frame[rows] == frames, rows, -1)
        return rows


def _frame_number(name: str) -> Optional[int]:
    """Frame index from an image path like seq1/frame_00042.jpg."""
    try:
        return int(name[-9:-4])
    except ValueError:
        return None


def parse_pose_table(file, with_confidence: bool = False) -> PoseTable:
    """Parse ``imgpath qw qx qy qz tx ty tz [confidence]`` lines.

    Input poses are world2cam (the Map-free file convention); the returned
    table is cam2world. Malformed lines are skipped with a warning, matching
    the reference evaluator's tolerance (``benchmark/utils.py:18-78``).
    """
    n_fields = 9 if with_confidence else 8
    frames, rows = [], []
    for ln, line in enumerate(file.readlines()):
        parts = line.strip().split(" ")
        if len(parts) != n_fields:
            LOG.warning(
                "line %d: expected %d fields, got %d — skipped", ln, n_fields, len(parts)
            )
            continue
        if "#" in parts[0]:
            continue
        frame = _frame_number(parts[0])
        if frame is None:
            LOG.warning("line %d: unparseable frame number — skipped", ln)
            continue
        try:
            vals = np.array(parts[1:], dtype=np.float64)
        except ValueError:
            LOG.warning("line %d: unparseable pose values — skipped", ln)
            continue
        if not np.isfinite(vals).all():
            LOG.warning("line %d: non-finite pose values — skipped", ln)
            continue
        if np.isclose(np.linalg.norm(vals[:4]), 0.0):
            LOG.warning("line %d: zero-norm quaternion — skipped", ln)
            continue
        frames.append(frame)
        rows.append(vals)

    if not rows:
        empty = np.zeros((0,))
        return PoseTable(
            np.zeros((0,), np.int64), np.zeros((0, 4)), np.zeros((0, 3)), empty
        )

    frames = np.asarray(frames, dtype=np.int64)
    table = np.stack(rows)
    q_w2c, t_w2c = table[:, :4], table[:, 4:7]
    conf = table[:, 7] if with_confidence else np.full(len(frames), np.nan)

    # batched world2cam -> cam2world: q_c2w = q*/|q|^2, t_c2w = -R(q)^T t
    norm2 = (q_w2c * q_w2c).sum(axis=1, keepdims=True)
    q_c2w = q_w2c * np.array([1.0, -1.0, -1.0, -1.0]) / norm2
    R_w2c = quats_to_mats(q_w2c)
    t_c2w = -np.einsum("nji,nj->ni", R_w2c, t_w2c)

    # duplicate frame numbers: keep the last occurrence (dict-assignment
    # semantics of the reference parser)
    _, last = np.unique(frames[::-1], return_index=True)
    keep = np.sort(len(frames) - 1 - last)
    return PoseTable(frames[keep], q_c2w[keep], t_c2w[keep], conf[keep])


def read_intrinsics_table(path: Path) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """intrinsics.txt -> (SORTED UNIQUE frame numbers (N,), K (N,3,3), W, H).

    Scene files list both seq0 and seq1 frames, which share frame numbering;
    the reference keys a dict on the frame number (``benchmark/utils.py:85-98``)
    so the LAST occurrence — the seq1 query frame — wins. Reproduced here by
    a keep-last dedup; W/H likewise come from the last line.
    """
    frames, params = [], []
    with Path(path).open("r", encoding="utf-8") as f:
        for line in f.readlines():
            if "#" in line:
                continue
            parts = line.strip().split(" ")
            frames.append(_frame_number(parts[0]))
            params.append(np.array(parts[1:], dtype=np.float64))
    params = np.stack(params)  # fx fy cx cy W H
    n = len(frames)
    K = np.zeros((n, 3, 3), dtype=np.float64)
    K[:, 0, 0], K[:, 1, 1] = params[:, 0], params[:, 1]
    K[:, 0, 2], K[:, 1, 2] = params[:, 2], params[:, 3]
    K[:, 2, 2] = 1.0
    W, H = params[-1, 4], params[-1, 5]
    frames = np.asarray(frames, dtype=np.int64)
    # keep-last dedup: unique() on the reversed array marks each frame's
    # final occurrence; output is sorted by frame number
    uniq, rev_idx = np.unique(frames[::-1], return_index=True)
    return uniq, K[n - 1 - rev_idx], W, H


def lookup_intrinsics(
    frames_K: np.ndarray, K_all: np.ndarray, query_frames: np.ndarray
) -> np.ndarray:
    """Exact-match K lookup by frame number (frames_K sorted unique).

    Raises KeyError for frames absent from intrinsics.txt — the reference's
    dict access does the same (``benchmark/mapfree.py``); silently clipping
    would score with a wrong camera."""
    rows = np.searchsorted(frames_K, query_frames)
    bad = (rows >= len(frames_K)) | (frames_K[np.minimum(rows, len(frames_K) - 1)] != query_frames)
    if bad.any():
        raise KeyError(f"no intrinsics for frames {np.asarray(query_frames)[bad][:5]}")
    return K_all[rows]


def quat_angle_error(label, pred, variant: str = VARIANTS_ANGLE_SIN) -> np.ndarray:
    """Angle between quaternions in degrees, batched; returns (N, 1).

    The sin variant (2*arcsin of the relative quaternion's vector norm)
    resolves small angles far below the cos variant's arccos precision floor
    (behavior spec: ``benchmark/utils.py:99-133``).
    """
    label = np.atleast_2d(np.asarray(label, dtype=np.float64))
    pred = np.atleast_2d(np.asarray(pred, dtype=np.float64))
    q1 = pred / np.linalg.norm(pred, axis=1, keepdims=True)
    q2 = label / np.linalg.norm(label, axis=1, keepdims=True)
    if variant == VARIANTS_ANGLE_COS:
        d = np.clip(np.abs((q1 * q2).sum(axis=1)), -1.0, 1.0)
        angle = 2.0 * np.degrees(np.arccos(d))
    elif variant == VARIANTS_ANGLE_SIN:
        rel = qmult_batch(q1, q2 * np.array([1.0, -1.0, -1.0, -1.0]))
        sin_half = np.linalg.norm(rel[:, 1:], axis=1)
        angle = np.degrees(2.0 * np.arcsin(np.clip(sin_half, 0.0, 1.0)))
    else:
        raise ValueError(f"unknown angle variant {variant!r}")
    return angle.reshape(-1, 1).astype(np.float64)


def precision_recall(inliers, tp, failures: int = 0):
    """Precision/recall curve + average precision of a confidence ranking.

    Frames are ranked by descending confidence; precision/recall are
    evaluated once per distinct confidence value (at the last member of each
    tie group), and AP is the rectangle-rule integral of precision over
    recall increments. Returned curves run from max recall down to zero with
    a (recall=0, precision=1) sentinel appended — the exact output contract
    of the reference's reversed-slice construction
    (``benchmark/utils.py:136-186``).

    ``failures`` counts frames without estimates; they deflate recall.
    """
    conf = np.asarray(inliers, dtype=np.float64).ravel()
    hit = np.asarray(tp, dtype=np.float64).ravel()
    assert conf.shape == hit.shape, "unequal shapes"

    order = np.argsort(-conf, kind="stable")
    conf, hit = conf[order], hit[order]

    group_end = np.ones(conf.size, dtype=bool)
    group_end[:-1] = conf[:-1] != conf[1:]
    ranks = np.flatnonzero(group_end)  # 0-based index of each group's last row

    prec_curve = np.cumsum(hit)[ranks] / (ranks + 1.0)
    rec_curve = (ranks + 1.0) / (conf.size + float(failures))
    average_precision = float(np.sum(prec_curve * np.diff(rec_curve, prepend=0.0)))

    prec = np.r_[prec_curve[::-1], 1.0]
    rec = np.r_[rec_curve[::-1], 0.0]
    return prec, rec, average_precision
