from .loss import LossConfig, metric_pose_loss
from .train_step import Optimizer, StagedTrainStep, TrainState, init_train_state

__all__ = ["LossConfig", "metric_pose_loss", "Optimizer", "StagedTrainStep", "TrainState", "init_train_state"]
