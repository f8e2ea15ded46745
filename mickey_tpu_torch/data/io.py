"""Image and intrinsics IO on the host (``mickey_tpu/data/io.py``).

Images are NHWC: (H, W, 3) float32 in [0, 1]. Decoding and resizing go
through ``cv2`` (``imread``, then ``resize`` with its INTER_LINEAR default),
as in the JAX package, imported when a frame is read. Where ``cv2`` does not
import, reading a frame raises: a scene's raw-frame cache
(``data/raw_cache.py``) holds its frames already decoded and serves without
a decoder.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "no image decoder: reading a frame needs cv2, which does not import here. A scene's raw-frame "
            "cache (mickey_tpu_torch/data/raw_cache.py, rawcache_{W}x{H}.u8 beside its intrinsics.txt) serves "
            "its frames without a decoder; build it with build_scene_cache where cv2 exists."
        ) from e
    return cv2


def decode_rgb(path):
    """(H, W, 3) uint8 RGB frame as stored."""
    cv2 = _cv2()
    image = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if image is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


def resize_rgb(image: np.ndarray, resize: Tuple[int, int]) -> np.ndarray:
    """INTER_LINEAR resize to ``resize`` = (W, H)."""
    return _cv2().resize(image, resize)


def read_color_image(path, resize: Optional[Tuple[int, int]] = None, augment_fn=None) -> np.ndarray:
    """Read an RGB image as (H, W, 3) float32 in [0, 1]; resize is (W, H)."""
    image = decode_rgb(path)
    if resize is not None:
        image = resize_rgb(image, resize)
    image = image.astype(np.float32) / 255.0
    if augment_fn is not None:
        image = augment_fn(image)
    return image


def read_depth_image(path) -> np.ndarray:
    """A 16-bit depth PNG in millimetres as (H, W) float32 metres."""
    cv2 = _cv2()
    depth = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    return depth.astype(np.float32) / 1000.0


def correct_intrinsic_scale(K: np.ndarray, scale_x: float, scale_y: float) -> np.ndarray:
    """Rescale intrinsics for resized images, with the -0.5 principal point
    correction (reference datasets/utils.py:86-99)."""
    transform = np.eye(3, dtype=np.float32)
    transform[0, 0] = scale_x
    transform[0, 2] = scale_x / 2 - 0.5
    transform[1, 1] = scale_y
    transform[1, 2] = scale_y / 2 - 0.5
    return transform @ K.astype(np.float32)


def read_intrinsics(path, resize: Optional[Tuple[int, int]] = None):
    """Parse an intrinsics.txt (img_name fx fy cx cy W H per line).

    Returns ({img_name: K (3,3) float32}, {img_name: K_original}).
    """
    Ks: Dict[str, np.ndarray] = {}
    K_ori: Dict[str, np.ndarray] = {}
    with Path(path).open("r") as f:
        for line in f.readlines():
            if "#" in line:
                continue
            parts = line.strip().split(" ")
            img_name = parts[0]
            fx, fy, cx, cy, W, H = map(float, parts[1:])
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
            K_ori[img_name] = K
            if resize is not None:
                K = correct_intrinsic_scale(K, resize[0] / W, resize[1] / H)
            Ks[img_name] = K
    return Ks, K_ori


def pad_to_multiple(image: np.ndarray, df: int = 14) -> np.ndarray:
    """Crop H, W down to multiples of df: the first two axes of an (H, W, ...)
    image, the middle two of a (B, H, W, 3) batch (a view). The reference
    crops, not pads (mickey_extractor.py:46); taking pixels from the bottom
    and the right leaves K unchanged."""
    if image.ndim == 4:
        _, h, w, _ = image.shape
        return image[:, : df * (h // df), : df * (w // df)]
    h, w = image.shape[:2]
    return image[: df * (h // df), : df * (w // df)]


def crop_to_patches(images, cfg):
    """The one crop every image takes before the backbone: ``pad_to_multiple``
    at the patch size, MICKEY.DINOV2.DOWN_FACTOR. The submission path, the
    trainer's batches and the feature cache's frames all call it, so a cached
    row is the feature map of the frame the train step sees."""
    return pad_to_multiple(images, int(cfg.MICKEY.DINOV2.DOWN_FACTOR))
