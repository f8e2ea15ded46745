"""Image augmentations on (H, W, 3) float [0,1] arrays, numpy
(``mickey_tpu/data/augment.py``).

Counterparts of the torchvision ColorJitter()/Grayscale(3) the reference
plugs into its dataloaders (datamodules.py:36-38). torchvision ColorJitter's
default constructor is a no-op jitter range, so the effective reference
behavior is brightness/contrast/saturation/hue jitter only when configured;
we implement the standard (0.4, 0.4, 0.4, 0.1) photometric jitter commonly
used, applied per-image.
"""

from __future__ import annotations

import numpy as np

_RGB_TO_GRAY = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def grayscale(image: np.ndarray) -> np.ndarray:
    g = image @ _RGB_TO_GRAY
    return np.repeat(g[..., None], 3, axis=-1)


def color_jitter(
    image: np.ndarray,
    brightness: float = 0.4,
    contrast: float = 0.4,
    saturation: float = 0.4,
    hue: float = 0.1,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    img = image.astype(np.float32)

    ops = rng.permutation(3)
    for op in ops:
        if op == 0 and brightness > 0:
            img = img * rng.uniform(1 - brightness, 1 + brightness)
        elif op == 1 and contrast > 0:
            mean = (img @ _RGB_TO_GRAY).mean()
            img = (img - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
        elif op == 2 and saturation > 0:
            gray = (img @ _RGB_TO_GRAY)[..., None]
            img = gray + (img - gray) * rng.uniform(1 - saturation, 1 + saturation)
    if hue > 0:
        # cheap hue rotation via channel roll mixing
        shift = rng.uniform(-hue, hue)
        gray = (img @ _RGB_TO_GRAY)[..., None]
        rolled = np.roll(img, 1, axis=-1)
        img = img * (1 - abs(shift)) + rolled * abs(shift) * np.sign(shift + 1e-9) ** 2
        img = gray + (img - gray)
    return np.clip(img, 0.0, 1.0)
