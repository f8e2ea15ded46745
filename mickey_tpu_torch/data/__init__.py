from .io import correct_intrinsic_scale, read_color_image, read_depth_image, read_intrinsics
from .loader import DataLoader, DataModule, DataModuleTraining, collate
from .mapfree import ConcatDataset, MapFreeDataset, MapFreeScene
from .sampler import RandomConcatSampler

__all__ = [
    "correct_intrinsic_scale",
    "read_color_image",
    "read_depth_image",
    "read_intrinsics",
    "DataLoader",
    "DataModule",
    "DataModuleTraining",
    "collate",
    "ConcatDataset",
    "MapFreeDataset",
    "MapFreeScene",
    "RandomConcatSampler",
]
