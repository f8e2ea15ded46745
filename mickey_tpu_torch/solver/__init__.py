from .procrustes_ransac import (
    Draws,
    PoseEstimate,
    draw_samples,
    estimate_pose,
    estimate_pose_from_cfg,
    estimate_pose_topk,
    estimate_pose_topk_from_cfg,
    extract_inliers,
)

__all__ = ["Draws", "PoseEstimate", "draw_samples", "estimate_pose", "estimate_pose_from_cfg", "estimate_pose_topk",
           "estimate_pose_topk_from_cfg", "extract_inliers"]
