"""Map-free relocalization dataset, host-side numpy (``mickey_tpu/data/mapfree.py``).

Design: all per-pair metadata — relative poses, camera centers, rescaled
intrinsics — is precomputed in one batched numpy pass when a scene is opened
(matrix algebra over whole frame tables); ``__getitem__`` only decodes the
two images and slices precomputed arrays. This keeps the per-sample work in
the prefetching loader down to JPEG IO. Behavior spec (pair construction,
overlap filtering, x5 query subsampling, zeroed test poses, sample dict
keys): reference ``lib/datasets/mapfree.py``.

Scene layout:
    poses.txt        imgpath qw qx qy qz tx ty tz   (world->cam)
    intrinsics.txt   imgpath fx fy cx cy W H
    overlaps.npz     idxs (N, 4) uint16, overlaps (N,)   [train scenes]
    seq0/ seq1/      frame_%05d.jpg
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry.rotations import quats_to_mats
from .io import correct_intrinsic_scale, read_color_image


def _parse_table(path: Path) -> Tuple[List[str], np.ndarray]:
    """Whitespace table file -> (image names, float value matrix)."""
    names, rows = [], []
    with Path(path).open("r") as f:
        for line in f:
            line = line.strip()
            if not line or "#" in line:
                continue
            parts = line.split(" ")
            names.append(parts[0])
            rows.append(np.array(parts[1:], dtype=np.float64))
    return names, (np.stack(rows) if rows else np.zeros((0, 0)))


def _pairs_from_overlaps(path: Path, limits: Optional[Tuple[float, float]]) -> np.ndarray:
    """Train pairs: (seqA, imA, seqB, imB) rows filtered by overlap range."""
    with np.load(path, allow_pickle=True) as f:
        idxs, overlaps = f["idxs"], f["overlaps"]
    if limits is None:
        return idxs.copy()
    lo, hi = limits
    return idxs[(overlaps > lo) & (overlaps < hi)].copy()


def _query_pairs(names: List[str], sample_factor: int) -> np.ndarray:
    """Val/test pairs: the seq0 keyframe vs every sample_factor-th query."""
    query_frames = [int(n[-9:-4]) for n in names if "seq0" not in n]
    pairs = np.zeros((len(query_frames), 4), dtype=np.uint16)
    pairs[:, 2] = 1
    pairs[:, 3] = np.asarray(query_frames, dtype=np.uint16)
    return pairs[::sample_factor]


class MapFreeScene:
    """One scene directory, fully indexed at construction time."""

    def __init__(
        self,
        scene_root,
        resize: Tuple[int, int],
        sample_factor: int = 1,
        overlap_limits: Optional[Tuple[float, float]] = None,
        transforms=None,
        test_scene: bool = False,
    ):
        self.scene_root = Path(scene_root)
        self.resize = resize
        self.sample_factor = sample_factor
        self.transforms = transforms
        self.test_scene = test_scene

        overlaps_path = self.scene_root / "overlaps.npz"
        pose_names, pose_vals = _parse_table(self.scene_root / "poses.txt")
        if overlaps_path.exists():
            pairs = _pairs_from_overlaps(overlaps_path, overlap_limits)
        else:
            pairs = _query_pairs(pose_names, sample_factor)
        self._n_pairs = len(pairs)
        self._index_pairs(pairs, pose_names, pose_vals)

    # -- batched metadata precompute ------------------------------------------

    def _image_path(self, seq: int, frame: int) -> str:
        return f"seq{seq}/frame_{frame:05}.jpg"

    def _index_pairs(self, pairs: np.ndarray, pose_names, pose_vals) -> None:
        """Resolve every pair's paths, intrinsics, and relative pose at once."""
        intr_names, intr_vals = _parse_table(self.scene_root / "intrinsics.txt")
        intr_row = {n: i for i, n in enumerate(intr_names)}
        pose_row = {n: i for i, n in enumerate(pose_names)}

        self.paths0 = [self._image_path(s, f) for s, f in pairs[:, 0:2]]
        self.paths1 = [self._image_path(s, f) for s, f in pairs[:, 2:4]]

        # intrinsics: original + rescaled to the working resolution
        fxfycxcy = intr_vals[:, :4]
        WH = intr_vals[:, 4:6]
        n_frames = len(intr_names)
        K_ori = np.zeros((n_frames, 3, 3), dtype=np.float32)
        K_ori[:, 0, 0], K_ori[:, 1, 1] = fxfycxcy[:, 0], fxfycxcy[:, 1]
        K_ori[:, 0, 2], K_ori[:, 1, 2] = fxfycxcy[:, 2], fxfycxcy[:, 3]
        K_ori[:, 2, 2] = 1.0
        K = np.stack(
            [
                correct_intrinsic_scale(k, self.resize[0] / w, self.resize[1] / h)
                for k, (w, h) in zip(K_ori, WH)
            ]
        ).astype(np.float32)

        rows0 = np.array([intr_row[p] for p in self.paths0], dtype=np.int64)
        rows1 = np.array([intr_row[p] for p in self.paths1], dtype=np.int64)
        self.K0, self.K1 = K[rows0], K[rows1]
        self.K0_ori, self.K1_ori = K_ori[rows0], K_ori[rows1]

        P = len(pairs)
        if self.test_scene:
            # test scenes ship no GT: zero poses, zero (non-identity) transform
            self.q0 = self.q1 = np.zeros((P, 4))
            self.c0 = self.c1 = np.zeros((P, 3))
            self.T_0to1 = np.zeros((P, 4, 4), dtype=np.float32)
            return

        # world->cam quaternions/translations for both frames of every pair
        q_all, t_all = pose_vals[:, :4], pose_vals[:, 4:7]
        p0 = np.array([pose_row[p] for p in self.paths0], dtype=np.int64)
        p1 = np.array([pose_row[p] for p in self.paths1], dtype=np.int64)
        R_all = quats_to_mats(q_all)
        centers = -np.einsum("nji,nj->ni", R_all, t_all)  # cam centers, world

        self.q0, self.q1 = q_all[p0], q_all[p1]
        self.c0, self.c1 = centers[p0], centers[p1]

        # relative pose T_0to1 = T1_w2c @ inv(T0_w2c), batched matrix algebra
        R0, R1 = R_all[p0], R_all[p1]
        R01 = np.einsum("nij,nkj->nik", R1, R0)  # R1 @ R0^T
        t01 = t_all[p1] - np.einsum("nij,nj->ni", R01, t_all[p0])
        T = np.broadcast_to(np.eye(4), (P, 4, 4)).copy()
        T[:, :3, :3] = R01
        T[:, :3, 3] = t01
        self.T_0to1 = T.astype(np.float32)

    # -- sample access ---------------------------------------------------------

    def __len__(self) -> int:
        return self._n_pairs

    def raw_images(self, index: int):
        """(img0, img1) uint8 views from the scene's raw cache, or None when
        no cache was built (data/raw_cache.py; decode-once ingest)."""
        if not hasattr(self, "_raw_cache"):
            from .raw_cache import SceneRawCache

            self._raw_cache = SceneRawCache.open_if_exists(self.scene_root, self.resize)
        if self._raw_cache is None:
            return None
        return (
            self._raw_cache.image(self.paths0[index]),
            self._raw_cache.image(self.paths1[index]),
        )

    def sample_meta(self, index: int) -> Dict:
        """The sample dict WITHOUT images; the loader fills them from a raw cache."""
        path0, path1 = self.paths0[index], self.paths1[index]
        return {
            "T_0to1": self.T_0to1[index],
            "abs_q_0": self.q0[index],
            "abs_c_0": self.c0[index],
            "abs_q_1": self.q1[index],
            "abs_c_1": self.c1[index],
            "K_color0": self.K0[index],
            "Kori_color0": self.K0_ori[index],
            "K_color1": self.K1[index],
            "Kori_color1": self.K1_ori[index],
            "dataset_name": "Mapfree",
            "scene_id": self.scene_root.stem,
            "scene_root": str(self.scene_root),
            "pair_id": index * self.sample_factor,
            "pair_names": (path0, path1),
        }

    def __getitem__(self, index: int) -> Dict:
        sample = self.sample_meta(index)
        path0, path1 = self.paths0[index], self.paths1[index]
        sample["image0"] = read_color_image(
            self.scene_root / path0, self.resize, augment_fn=self.transforms
        )  # (H, W, 3) float32
        sample["image1"] = read_color_image(
            self.scene_root / path1, self.resize, augment_fn=self.transforms
        )
        return sample


class ConcatDataset:
    """Minimal torch-free ConcatDataset."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self.cumulative_sizes = np.cumsum([len(d) for d in datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def locate(self, idx) -> Tuple[object, int]:
        """(owning dataset, local index) of a global index."""
        ds = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        lo = 0 if ds == 0 else self.cumulative_sizes[ds - 1]
        return self.datasets[ds], idx - lo

    def __getitem__(self, idx):
        ds, local = self.locate(idx)
        return ds[local]


class MapFreeDataset(ConcatDataset):
    def __init__(self, cfg, mode: str, transforms=None):
        assert mode in ("train", "val", "test"), "Invalid dataset mode"
        data_root = Path(cfg.DATASET.DATA_ROOT) / mode
        resize = (cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT)
        test_scene = mode == "test"
        overlap_limits = (cfg.DATASET.MIN_OVERLAP_SCORE, cfg.DATASET.MAX_OVERLAP_SCORE)
        sample_factor = {"train": 1, "val": 5, "test": 5}[mode]

        scenes = cfg.DATASET.SCENES
        if scenes is None:
            scenes = sorted(s.name for s in data_root.iterdir() if s.is_dir())
        if cfg.DEBUG:
            scenes = scenes[:30] if mode == "train" else scenes[:10] if mode == "val" else scenes

        super().__init__(
            [
                MapFreeScene(data_root / s, resize, sample_factor, overlap_limits, transforms, test_scene)
                for s in scenes
            ]
        )
