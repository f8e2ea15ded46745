from .inliers import inlier_counting_3d, pairwise_distance, soft_inlier_counting_3d
from .kabsch import ProcrustesResult, svd3x3, weighted_procrustes
from .projection import backproject_3d, inv_intrinsics, project_2d, transform_points
from .rotations import mat2quat, qinverse, qmult, quat2mat, rotate_vector

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
    "qinverse",
    "qmult",
    "rotate_vector",
    "quat2mat",
    "mat2quat",
]
