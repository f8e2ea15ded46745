"""Scene-balanced index sampler for ConcatDataset-style datasets
(``mickey_tpu/data/sampler.py``; the same numpy stream for a seed).

Each epoch draws ``n_samples_per_subset`` indices from every scene (with or
without replacement), shuffles globally, and optionally repeats the epoch
stream. A persistent numpy Generator makes successive epochs differ unless
``reset_on_iter`` (deterministic validation). Behavior spec: reference
``lib/datasets/sampler.py:6-86`` (itself adapted from LoFTR).

For multi-host data parallelism, pass (shard_id, num_shards) to slice the
per-epoch index stream contiguously per host: "the dataset is splitted
across ranks" (reference sampler.py:17-18).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


class RandomConcatSampler:
    def __init__(
        self,
        data_source,
        n_samples_per_subset: int,
        subset_replacement: bool = True,
        shuffle: bool = True,
        repeat: int = 1,
        seed: int = 66,
        reset_on_iter: bool = False,
        shard: Optional[Tuple[int, int]] = None,
    ):
        assert repeat >= 1
        self.data_source = data_source
        self.n_samples_per_subset = n_samples_per_subset
        self.n_samples = len(data_source.datasets) * n_samples_per_subset * repeat
        self.subset_replacement = subset_replacement
        self.repeat = repeat
        self.shuffle = shuffle
        self.seed = seed
        self.reset_on_iter = reset_on_iter
        self.shard = shard
        self.generator = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.n_samples // self.shard[1] if self.shard else self.n_samples

    def _subset_windows(self):
        """(lo, hi) global-index window of each scene in the concat dataset."""
        bounds = [0, *self.data_source.cumulative_sizes]
        return zip(bounds[:-1], bounds[1:])

    def _draw_subset(self, g: np.random.Generator, lo: int, hi: int) -> np.ndarray:
        """n_samples_per_subset indices from [lo, hi)."""
        n = self.n_samples_per_subset
        if self.subset_replacement:
            return g.integers(lo, hi, size=n)
        drawn = g.permutation(hi - lo)[:n] + lo
        if drawn.size < n:  # small scene: top up with replacement
            drawn = np.concatenate([drawn, g.integers(lo, hi, size=n - drawn.size)])
        return drawn

    def __iter__(self) -> Iterator[int]:
        if self.reset_on_iter:
            self.generator = np.random.default_rng(self.seed)
        g = self.generator

        epoch = np.concatenate(
            [self._draw_subset(g, lo, hi) for lo, hi in self._subset_windows()]
        )
        if self.shuffle:
            epoch = epoch[g.permutation(epoch.size)]

        streams = [epoch]
        for _ in range(self.repeat - 1):
            rep = epoch.copy()
            if self.shuffle:
                rep = rep[g.permutation(rep.size)]
            streams.append(rep)
        indices = np.concatenate(streams)
        assert indices.shape[0] == self.n_samples

        if self.shard:
            shard_id, num_shards = self.shard
            per_shard = self.n_samples // num_shards
            indices = indices[shard_id * per_shard : (shard_id + 1) * per_shard]
        return iter(indices.tolist())
