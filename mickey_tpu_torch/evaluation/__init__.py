from .mapfree import SceneScore, evaluate, score_scene, summarize
from .metrics import METRIC_NAMES, score_frames
from .pose_io import (
    VARIANTS_ANGLE_COS,
    VARIANTS_ANGLE_SIN,
    PoseTable,
    parse_pose_table,
    precision_recall,
    quat_angle_error,
    read_intrinsics_table,
)
from .reprojection import (
    get_grid_multipleheight,
    project,
    reprojection_error,
    reprojection_errors,
)

__all__ = [
    "SceneScore",
    "evaluate",
    "score_scene",
    "summarize",
    "METRIC_NAMES",
    "score_frames",
    "VARIANTS_ANGLE_COS",
    "VARIANTS_ANGLE_SIN",
    "PoseTable",
    "parse_pose_table",
    "precision_recall",
    "quat_angle_error",
    "read_intrinsics_table",
    "get_grid_multipleheight",
    "project",
    "reprojection_error",
    "reprojection_errors",
]
