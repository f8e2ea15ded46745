from .inliers import inlier_counting_3d, pairwise_distance, soft_inlier_counting_3d
from .kabsch import ProcrustesResult, svd3x3, weighted_procrustes
from .projection import backproject_3d, inv_intrinsics, project_2d, transform_points

__all__ = [
    "backproject_3d",
    "inv_intrinsics",
    "project_2d",
    "transform_points",
    "svd3x3",
    "weighted_procrustes",
    "ProcrustesResult",
    "soft_inlier_counting_3d",
    "inlier_counting_3d",
    "pairwise_distance",
]
