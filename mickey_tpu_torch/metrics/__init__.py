from .pose_metrics import MetricsAccumulator, a_metrics, error_auc, pose_error, vcre

__all__ = ["MetricsAccumulator", "a_metrics", "error_auc", "pose_error", "vcre"]
