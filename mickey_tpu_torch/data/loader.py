"""Threaded prefetching batch loader (``mickey_tpu/data/loader.py``).

Batches are read while the card computes, behind a bounded prefetch queue of
ready numpy batches. A batch whose every pair has a scene raw-frame cache
(``data/raw_cache.py``) is a memcpy of uint8 frames; any other is decoded
sample by sample (``MapFreeScene.__getitem__``, ``cv2``). Batches are dicts
of stacked numpy arrays for array fields and lists for string fields, the
collation contract of the reference's torch collate.

The JAX package's native C++ ingest (``data/native.py``,
``native/mickey_io.cpp``: libjpeg and the Python C API) is not ported, so
``TRAINING.NATIVE_LOADER`` selects nothing here. Feature-cache training
(``meta_only`` batches with gathered feature rows) is not ported either and
raises.
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
        meta_only: bool = False,
    ):
        if meta_only:
            raise NotImplementedError("meta_only batches (feature-cache training) are not ported yet")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0

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
        batch = self._load_batch_rawcache(idxs)
        if batch is not None:
            return batch
        return collate([self.dataset[i] for i in idxs])

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
            meta_only=bool(self.cfg.TPU.get("FEATURE_CACHE", "")),
        )

    def val_dataloader(self) -> DataLoader:
        dataset = MapFreeDataset(self.cfg, "val")
        return DataLoader(
            dataset,
            self.cfg.TRAINING.BATCH_SIZE,
            drop_last=self.drop_last_val,
            num_workers=self.cfg.TRAINING.NUM_WORKERS,
        )

    def test_dataloader(self) -> DataLoader:
        dataset = MapFreeDataset(self.cfg, "test")
        return DataLoader(
            dataset,
            self.cfg.TRAINING.BATCH_SIZE,
            drop_last=self.drop_last_val,
            num_workers=self.cfg.TRAINING.NUM_WORKERS,
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
        )
