"""Threaded prefetching batch loader (``mickey_tpu/data/loader.py``).

Batches are read while the card computes, behind a bounded prefetch queue of
ready numpy batches. A batch is read by the first of three backends that
applies, in ``mickey_tpu``'s order:

1. the raw-frame cache (``data/raw_cache.py``): when every pair of the batch
   has a scene cache and no augmentation is configured, a memcpy of uint8
   frames;
2. the native ingest (``data/native.py``, ``csrc/mickey_io.cpp``): when
   ``TRAINING.NATIVE_LOADER`` is on (the default), the dataset locates its
   samples and no augmentation is configured, one call decodes, resizes
   and scales the batch's 2B JPEGs on a pool of threads (float32 in
   [0, 1], bitwise ``mickey_tpu``'s native batches). Where the library
   cannot be built it warns once and the loader falls back for good;
3. sample by sample (``MapFreeScene.__getitem__``, ``cv2``).

Batches are dicts of stacked numpy arrays for array fields and lists for
string fields, the collation contract of the reference's torch collate.

Feature-cache training reads no frames: ``meta_only`` batches carry the
pairs' metadata alone, and once the trainer hands the loader its
``feature_cache`` (``training/feature_cache.py``) they carry the pairs'
feature rows as ``batch["fmap"]`` ((2B, Hp, Wp, C), image0 rows then image1
rows, a CPU tensor in the cache's dtype), gathered in the prefetch threads
while the card computes.

Under data parallelism the trainer sets ``shard = (rank, world)``: each
batch of indices is padded to a multiple of ``world`` by repeating its last
index (``parallel.pad_batch`` on the loaded arrays gives the same rows) and
only this rank's contiguous rows are read.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

from .mapfree import MapFreeDataset
from .sampler import RandomConcatSampler

_ARRAY_KEYS = (
    "image0",
    "image1",
    "T_0to1",
    "abs_q_0",
    "abs_c_0",
    "abs_q_1",
    "abs_c_1",
    "K_color0",
    "Kori_color0",
    "K_color1",
    "Kori_color1",
)


def collate(samples: List[Dict]) -> Dict:
    batch: Dict = {}
    for k in samples[0]:
        if k in _ARRAY_KEYS:
            stacked = np.stack([np.asarray(s[k]) for s in samples])
            # uint8 images stay uint8: they travel to the device 4x smaller
            # and are normalized there (nn/extractor.normalize_images)
            if not (k in ("image0", "image1") and stacked.dtype == np.uint8):
                stacked = stacked.astype(np.float32)
            batch[k] = stacked
        else:
            batch[k] = [s[k] for s in samples]
    return batch


class DataLoader:
    """Iterate dataset[indices] in batches with threaded prefetch. An error
    in a worker is raised to the consumer."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler=None,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        prefetch: int = 4,
        seed: int = 0,
        native_io: bool = True,
        meta_only: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.meta_only = meta_only
        self.feature_cache = None  # set by the trainer: meta-only batches then carry batch["fmap"]
        self.sampler = sampler
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.native_io = native_io
        self._native_batch = None  # the native backend's use, resolved at the first batch
        self.shard = None  # (rank, world) under data parallelism, set by the trainer
        self._epoch = 0

    def _native_usable(self) -> bool:
        """The native ingest applies when it is asked for, the dataset
        exposes per-sample paths and metadata, no augmentation is configured
        and the library builds."""
        if not self.native_io or not hasattr(self.dataset, "locate"):
            return False
        if any(getattr(d, "transforms", None) is not None for d in self.dataset.datasets):
            return False
        from .native import ensure_built

        return ensure_built() is not None

    def _indices(self) -> List[int]:
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self._epoch).permutation(idx)
        return idx.tolist()

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        indices = self._indices()
        self._epoch += 1
        batches = [
            indices[i : i + self.batch_size] for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                # pipeline: submit batch loads ahead, hand them over in order
                futures = [pool.submit(self._load_batch, b) for b in batches[: self.prefetch + 2]]
                next_submit = len(futures)
                try:
                    while futures:
                        if not put(futures.pop(0).result()):
                            return
                        if next_submit < len(batches):
                            futures.append(pool.submit(self._load_batch, batches[next_submit]))
                            next_submit += 1
                    put(None)
                except Exception as e:  # handed to the consumer, which raises it
                    put(e)
                finally:
                    for f in futures:
                        f.cancel()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def _load_batch(self, idxs: List[int]) -> Dict:
        """The batch of ``idxs``; under ``shard`` this rank's rows of it,
        with the global batch's real size as ``batch["global_batch"]``."""
        if self.shard is None:
            return self._read_batch(idxs)
        from ..parallel import shard_indices

        batch = self._read_batch(shard_indices(idxs, *self.shard))
        batch["global_batch"] = len(idxs)
        return batch

    def _read_batch(self, idxs: List[int]) -> Dict:
        if self.meta_only:
            batch = collate([self._meta(i) for i in idxs])
            if self.feature_cache is not None:
                from ..training.feature_cache import frame_key

                keys = [frame_key(sr, p[half]) for half in (0, 1)
                        for sr, p in zip(batch["scene_root"], batch["pair_names"])]
                batch["fmap"] = self.feature_cache.gather(keys)
            return batch
        batch = self._load_batch_rawcache(idxs)
        if batch is not None:
            return batch
        if self._native_batch is None:
            self._native_batch = self._native_usable()
        if self._native_batch:
            batch = self._load_batch_native(idxs)
            if batch is not None:
                return batch
            self._native_batch = False  # the backend failed: fall back for good
        return collate([self.dataset[i] for i in idxs])

    def _meta(self, i: int) -> Dict:
        ds, local = self.dataset.locate(i)
        return ds.sample_meta(local)

    def _load_batch_rawcache(self, idxs: List[int]) -> Dict:
        """Decode-free ingest from per-scene uint8 raw caches (memcpy-bound;
        data/raw_cache.py). Applies only when EVERY pair in the batch has a
        cache and no augmentation transforms are configured."""
        if not hasattr(self.dataset, "locate"):
            return None
        samples = []
        for i in idxs:
            ds, local = self.dataset.locate(i)
            if getattr(ds, "transforms", None) is not None or not hasattr(ds, "raw_images"):
                return None
            imgs = ds.raw_images(local)
            if imgs is None:
                return None
            s = ds.sample_meta(local)
            s["image0"], s["image1"] = imgs
            samples.append(s)
        return collate(samples)

    def _load_batch_native(self, idxs: List[int]) -> Dict:
        """One native call decodes the whole batch (2B JPEGs)."""
        from .native import read_batch

        samples, paths, resize = [], [], None
        for i in idxs:
            ds, local = self.dataset.locate(i)
            samples.append(ds.sample_meta(local))
            paths.extend(ds.image_paths(local))
            resize = ds.resize
        images = read_batch(paths, width=resize[0], height=resize[1], num_threads=self.num_workers)
        if images is None:
            return None
        for j, s in enumerate(samples):
            s["image0"], s["image1"] = images[2 * j], images[2 * j + 1]
        return collate(samples)


class DataModule:
    """Eval-oriented loaders (reference DataModule, datamodules.py:12-67)."""

    def __init__(self, cfg, drop_last_val: bool = True):
        self.cfg = cfg
        self.drop_last_val = drop_last_val
        assert cfg.DATASET.DATA_SOURCE == "MapFree", "unsupported DATA_SOURCE"

    def _sampler(self, dataset, reset_epoch=False, seed=66):
        if self.cfg.TRAINING.SAMPLER == "scene_balance":
            return RandomConcatSampler(
                dataset,
                self.cfg.TRAINING.N_SAMPLES_SCENE,
                self.cfg.TRAINING.SAMPLE_WITH_REPLACEMENT,
                shuffle=True,
                reset_on_iter=reset_epoch,
                seed=seed,
            )
        return None

    def _transforms(self):
        if self.cfg.DATASET.AUGMENTATION_TYPE == "colorjitter":
            from .augment import color_jitter

            return color_jitter
        if self.cfg.DATASET.BLACK_WHITE:
            from .augment import grayscale

            return grayscale
        return None

    def train_dataloader(self) -> DataLoader:
        dataset = MapFreeDataset(self.cfg, "train", transforms=self._transforms())
        return DataLoader(
            dataset,
            self.cfg.TRAINING.BATCH_SIZE,
            sampler=self._sampler(dataset),
            num_workers=self.cfg.TRAINING.NUM_WORKERS,
            native_io=self.cfg.TRAINING.get("NATIVE_LOADER", True),
            meta_only=bool(self.cfg.TPU.get("FEATURE_CACHE", "")),
        )

    def val_dataloader(self) -> DataLoader:
        dataset = MapFreeDataset(self.cfg, "val")
        return DataLoader(
            dataset,
            self.cfg.TRAINING.BATCH_SIZE,
            drop_last=self.drop_last_val,
            num_workers=self.cfg.TRAINING.NUM_WORKERS,
            native_io=self.cfg.TRAINING.get("NATIVE_LOADER", True),
        )

    def test_dataloader(self) -> DataLoader:
        dataset = MapFreeDataset(self.cfg, "test")
        return DataLoader(
            dataset,
            self.cfg.TRAINING.BATCH_SIZE,
            drop_last=self.drop_last_val,
            num_workers=self.cfg.TRAINING.NUM_WORKERS,
            native_io=self.cfg.TRAINING.get("NATIVE_LOADER", True),
        )


class DataModuleTraining(DataModule):
    """Training loaders with seeded samplers (reference DataModuleTraining)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.seed = cfg.DATASET.SEED

    def train_dataloader(self) -> DataLoader:
        dataset = MapFreeDataset(self.cfg, "train", transforms=self._transforms())
        return DataLoader(
            dataset,
            self.cfg.TRAINING.BATCH_SIZE,
            sampler=self._sampler(dataset, seed=self.seed),
            num_workers=self.cfg.TRAINING.NUM_WORKERS,
            native_io=self.cfg.TRAINING.get("NATIVE_LOADER", True),
            meta_only=bool(self.cfg.TPU.get("FEATURE_CACHE", "")),
        )

    def val_dataloader(self) -> DataLoader:
        dataset = MapFreeDataset(self.cfg, "val")
        return DataLoader(
            dataset,
            self.cfg.TRAINING.BATCH_SIZE,
            sampler=self._sampler(dataset, reset_epoch=True),
            drop_last=True,
            num_workers=self.cfg.TRAINING.NUM_WORKERS,
            native_io=self.cfg.TRAINING.get("NATIVE_LOADER", True),
        )
