from .builder import build_model
from .relative_pose import MickeyRelativePose, RelativePoseOutput
from .training_model import MicKeyTrainer

__all__ = ["build_model", "MickeyRelativePose", "RelativePoseOutput", "MicKeyTrainer"]
