"""Decode-once raw uint8 frame cache (``mickey_tpu/data/raw_cache.py``; the
same files, byte for byte, so a cache built by either package serves both).

Each scene's frames are decoded ONCE at the working resolution into a packed
uint8 ``(N, H, W, 3)`` memmap; ingest is then a memcpy, and images travel
host->device as uint8 (4x less transfer) where the ``/255`` normalization
runs on the device (``nn/extractor.normalize_images``). The read side needs
numpy only, so a cache feeds a machine that has no image decoder.

Layout per scene:  <scene>/rawcache_{W}x{H}.u8   packed C-order uint8 frames
                                                  (numpy ``.npy`` format)
                   <scene>/rawcache_{W}x{H}.json {"frames": {relpath: row}}

Numerics: cached pixels are exactly the uint8 output of the decode +
INTER_LINEAR resize of ``data/io.read_color_image`` before its /255, so
cache-fed and JPEG-fed batches are bit-identical after normalization.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .io import decode_rgb, resize_rgb


def cache_paths(scene_root, resize: Tuple[int, int]) -> Tuple[Path, Path]:
    w, h = resize
    base = Path(scene_root) / f"rawcache_{w}x{h}"
    return base.with_suffix(".u8"), base.with_suffix(".json")


def list_scene_frames(scene_root) -> list:
    """All frame relpaths of a scene, from intrinsics.txt (authoritative)."""
    frames = []
    with (Path(scene_root) / "intrinsics.txt").open() as f:
        for line in f:
            line = line.strip()
            if line and "#" not in line:
                frames.append(line.split(" ")[0])
    return frames


def build_scene_cache(scene_root, resize: Tuple[int, int], overwrite: bool = False) -> Path:
    """One-time decode of every frame into the packed uint8 memmap (needs
    ``cv2``, through ``data/io.py``)."""
    data_path, index_path = cache_paths(scene_root, resize)
    if data_path.exists() and index_path.exists() and not overwrite:
        return data_path
    frames = list_scene_frames(scene_root)
    w, h = resize
    mm = np.lib.format.open_memmap(
        str(data_path) + ".tmp", mode="w+", dtype=np.uint8, shape=(len(frames), h, w, 3)
    )
    for i, rel in enumerate(frames):
        img = decode_rgb(Path(scene_root) / rel)
        if (img.shape[1], img.shape[0]) != (w, h):
            img = resize_rgb(img, (w, h))  # INTER_LINEAR = read_color_image
        mm[i] = img
    mm.flush()
    del mm
    Path(str(data_path) + ".tmp").rename(data_path)
    index_path.write_text(json.dumps({"frames": {n: i for i, n in enumerate(frames)}}))
    return data_path


class SceneRawCache:
    """Read side: memmap + name->row index (None-able via ``open_if_exists``)."""

    def __init__(self, scene_root, resize: Tuple[int, int]):
        data_path, index_path = cache_paths(scene_root, resize)
        self.rows: Dict[str, int] = json.loads(index_path.read_text())["frames"]
        self.data = np.lib.format.open_memmap(data_path, mode="r")
        w, h = resize
        if self.data.shape[1:] != (h, w, 3):
            raise ValueError(f"cache shape {self.data.shape} != resize {(h, w, 3)}")

    @classmethod
    def open_if_exists(cls, scene_root, resize) -> Optional["SceneRawCache"]:
        data_path, index_path = cache_paths(scene_root, resize)
        if not (data_path.exists() and index_path.exists()):
            return None
        try:
            return cls(scene_root, resize)
        except (OSError, ValueError, KeyError):  # unreadable or of another size: decode instead
            return None

    def image(self, relpath: str) -> np.ndarray:
        """(H, W, 3) uint8 view (zero-copy until written)."""
        return self.data[self.rows[relpath]]
