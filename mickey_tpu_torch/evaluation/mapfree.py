"""Offline Map-free benchmark evaluator, vectorized numpy
(``mickey_tpu/evaluation/mapfree.py``).

Scores a submission.zip of per-scene pose files against ground truth and
reports the official protocol numbers: Average Median Translation/Rotation/
Reprojection Error, Precision & AUC at pose error < (25cm, 5deg) and at
VCRE < 90px, and estimate coverage. Protocol spec (output keys, thresholds,
x5 query subsampling, confidence-ranked AP): reference
``benchmark/mapfree.py`` + ``benchmark/config.py``. The implementation here
scores whole scenes as aligned arrays (see ``metrics.score_frames``) instead
of the reference's per-frame loop.

Run: ``python -m mickey_tpu_torch.evaluation.mapfree --submission_path ... \
       --dataset_path ... --split val``
"""

from __future__ import annotations

import argparse
import json
import logging
from dataclasses import dataclass
from io import TextIOWrapper
from pathlib import Path
from typing import Dict, List
from zipfile import ZipFile

import numpy as np

from .metrics import METRIC_NAMES, score_frames
from .pose_io import (
    lookup_intrinsics,
    parse_pose_table,
    precision_recall,
    read_intrinsics_table,
)

# acceptance thresholds (reference benchmark/config.py)
t_threshold = 0.25  # meters
R_threshold = 5  # degrees
vcre_threshold = 90  # pixels

QUERY_SUBSAMPLE = 5  # val/test queries are scored every 5th frame


@dataclass
class SceneScore:
    """Per-frame metric arrays for one scene + count of missing estimates."""

    metrics: Dict[str, np.ndarray]  # {metric: (N,)}; empty arrays if no file
    n_missing: int

    @property
    def n_scored(self) -> int:
        return len(self.metrics["trans_err"]) if self.metrics else 0


def score_scene(dataset_path: Path, submission_zip: ZipFile, scene: str) -> SceneScore:
    """Align a scene's estimates with ground truth and score all frames."""
    frames_K, K_all, W, H = read_intrinsics_table(dataset_path / scene / "intrinsics.txt")
    with (dataset_path / scene / "poses.txt").open("r", encoding="utf-8") as f:
        gt = parse_pose_table(f, with_confidence=False)

    try:
        with submission_zip.open(f"pose_{scene}.txt") as f:
            est = parse_pose_table(TextIOWrapper(f, encoding="utf-8"), with_confidence=True)
    except KeyError:
        logging.warning("submission has no estimates for scene %s", scene)
        # a fully missing scene counts every GT frame as a failure
        # (pre-subsampling, matching the reference's early return)
        return SceneScore({}, len(gt))

    gt = gt.take(np.arange(0, len(gt), QUERY_SUBSAMPLE))

    rows = est.positions_of(gt.frame)
    present = rows >= 0
    est_aligned = est.take(rows[present])
    gt_aligned = gt.take(np.flatnonzero(present))

    K = lookup_intrinsics(frames_K, K_all, gt_aligned.frame)

    metrics = score_frames(gt_aligned, est_aligned, K, W, H)
    return SceneScore(metrics, int((~present).sum()))


def summarize(scores: Dict[str, SceneScore]):
    """Aggregate per-scene scores into the official protocol numbers."""
    scored = {name: s for name, s in scores.items() if s.n_scored > 0}
    if not scored:
        raise RuntimeError("Submission does not have any valid pose estimates")

    flat = {
        m: np.concatenate([s.metrics[m] for s in scored.values()]) for m in METRIC_NAMES
    }
    scene_medians = {
        m: np.array([np.median(s.metrics[m]) for s in scored.values()])
        for m in METRIC_NAMES
    }
    n_failures = sum(s.n_missing for s in scores.values())
    n_total = flat["trans_err"].size + n_failures

    good_pose = (flat["trans_err"] < t_threshold) & (flat["rot_err"] < R_threshold)
    good_vcre = flat["reproj_err"] < vcre_threshold

    pose_prec, pose_rec, auc_pose = precision_recall(
        inliers=flat["confidence"], tp=good_pose, failures=n_failures
    )
    vcre_prec, vcre_rec, auc_vcre = precision_recall(
        inliers=flat["confidence"], tp=good_vcre, failures=n_failures
    )

    curves = {
        "vcre_prec_values": vcre_prec,
        "vcre_recall_values": vcre_rec,
        "pose_prec_values": pose_prec,
        "pose_recall_values": pose_rec,
    }
    out = {
        "Average Median Translation Error": scene_medians["trans_err"].mean(),
        "Average Median Rotation Error": scene_medians["rot_err"].mean(),
        "Average Median Reprojection Error": scene_medians["reproj_err"].mean(),
        f"Precision @ Pose Error < ({t_threshold*100}cm, {R_threshold}deg)": good_pose.sum() / n_total,
        f"AUC @ Pose Error < ({t_threshold*100}cm, {R_threshold}deg)": auc_pose,
        f"Precision @ VCRE < {vcre_threshold}px": good_vcre.sum() / n_total,
        f"AUC @ VCRE < {vcre_threshold}px": auc_vcre,
        "Estimates for % of frames": flat["trans_err"].size / n_total,
    }
    return out, curves


def evaluate(submission_path: Path, dataset_path: Path):
    """Evaluate one submission.zip against a split directory of scenes."""
    scenes: List[str] = [f.name for f in Path(dataset_path).iterdir() if f.is_dir()]
    with ZipFile(submission_path, "r") as submission_zip:
        scores = {
            scene: score_scene(Path(dataset_path), submission_zip, scene)
            for scene in scenes
        }
    return summarize(scores)


def main():
    parser = argparse.ArgumentParser("eval", description="Evaluate Map-free submissions")
    parser.add_argument("--submission_path", type=Path, required=True)
    parser.add_argument("--split", choices=("val", "test"), default="test")
    parser.add_argument("--dataset_path", type=Path, required=True, help="dataset root (without split)")
    parser.add_argument("--log", choices=("warning", "info", "error"), default="warning")
    args = parser.parse_args()

    logging.basicConfig(level=args.log.upper())
    output_metrics, _ = evaluate(args.submission_path, args.dataset_path / args.split)
    print(json.dumps(output_metrics, indent=2, default=float))


if __name__ == "__main__":
    main()
