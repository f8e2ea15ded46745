"""Disk cache of frozen-backbone features: train without the DINOv2 forward
(``mickey_tpu/training/feature_cache.py``).

MicKey trains its heads and matcher on a frozen DINOv2, and the Map-free
recipes apply no image augmentation, so every frame's backbone feature map
is constant over a training run. The cache holds each unique frame's map
once; a cached train step is the heads, matcher, loss and optimizer alone.

Layout (one directory), the JAX package's, so that a cache built by either
package opens in the other:

  meta.json     {"dtype", "fmap_shape": [Hp, Wp, C], "keys": {frame_key: row},
                 "fingerprint": {"param_sig", "shape_sig", "n_leaves"}}
  features.dat  (n_frames, Hp, Wp, C) memmap in the stored dtype

bf16 is stored as its raw 16-bit pattern: the port memmaps it as ``uint16``
and views the rows as ``torch.bfloat16`` (no ``ml_dtypes``); fp32 -> bf16
rounds to nearest even (torch's conversion), as ``ml_dtypes`` does. With
``float32`` storage a row is the exact map the train step's backbone pass
gives the same frame; ``gather`` returns CPU tensors.

The fingerprint identifies the backbone the cache was built from. The JAX
package sums |leaf| weighted by (i % 7 + 1) over the leaves of *its* layout
(``jax.tree_util.tree_leaves``: dict keys sorted, the ViT blocks stacked on a
leading depth axis) and hashes that layout's shapes and dtype names. The
port keeps 24 unstacked blocks with its linears transposed, so it computes
the fingerprint over ``mickey_tpu``'s layout, not its own: the same leaf
order, stacked shapes, (in, out) linear shapes and dtype names, each leaf's
sum taken over its blocks. The sums agree within the JAX package's relative
tolerance of 1e-4 (summation order).

Frames are cropped to the patch grid (``data/io.crop_to_patches``, from the
bottom and the right) before the backbone, as the port's trainer crops its
batches, so a row is the features of the frame the train step sees.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_META = "meta.json"
_DATA = "features.dat"


def check_cfg_cacheable(cfg) -> None:
    """Raise unless the configured input pipeline is deterministic per frame
    (a per-epoch or per-sample transform would make cached features stale)."""
    if cfg.DATASET.get("AUGMENTATION_TYPE") not in (None, "None", "none"):
        raise ValueError(
            "feature cache requires AUGMENTATION_TYPE=None: augmented images change per epoch, cached "
            "frozen-backbone features would be stale"
        )
    if cfg.DATASET.get("BLACK_WHITE"):
        raise ValueError(
            "feature cache does not support DATASET.BLACK_WHITE: build_feature_cache reads frames without the "
            "grayscale transform, so cached features would not match the configured input pipeline"
        )


def _stack_blocks(blocks: List[dict]) -> dict:
    """[{k: tensor}] -> {k: [tensor per block]}, nested."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack_blocks([b[k] for b in blocks]) for k in first}
    return list(blocks)


def _jax_layout_leaves(backbone) -> List[Tuple[tuple, str, List[torch.Tensor]]]:
    """(shape, dtype name, tensors) of each leaf of ``mickey_tpu``'s backbone
    tree, in its leaf order: a stacked block leaf is the list of its blocks'
    tensors, with the depth axis in front and a linear's (out, in) weight
    read as (in, out)."""
    tree = dict(backbone, blocks=_stack_blocks(backbone["blocks"]))
    out = []

    def walk(node, name, in_blocks):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], k, in_blocks or k == "blocks")
            return
        ts = node if isinstance(node, list) else [node]
        shape = tuple(int(d) for d in ts[0].shape)
        if in_blocks and name == "w" and len(shape) == 2:
            shape = shape[::-1]  # the port's (out, in) linear is (in, out) there
        if isinstance(node, list):
            shape = (len(ts),) + shape
        out.append((shape, str(ts[0].dtype).replace("torch.", ""), ts))

    walk(tree, "", False)
    return out


def backbone_fingerprint(backbone) -> dict:
    """Identity of a backbone (the port's tensors on any device): one scalar
    over all parameters, summed on their device and read once, and a hash of
    the shape and dtype skeleton, both over ``mickey_tpu``'s layout (module
    docstring)."""
    leaves = _jax_layout_leaves(backbone)
    with torch.no_grad():
        sig = None
        for i, (_, _, ts) in enumerate(leaves):
            s = sum(t.abs().float().sum() for t in ts) * float(i % 7 + 1)
            sig = s if sig is None else sig + s
    skel = "|".join(f"{shape}{dtype}" for shape, dtype, _ in leaves)
    return {
        "param_sig": float(sig),
        "shape_sig": hashlib.sha1(skel.encode()).hexdigest()[:16],
        "n_leaves": len(leaves),
    }


def _check_fingerprint(meta: dict, got: dict) -> None:
    want = meta.get("fingerprint")
    if not want:  # a cache directory from before fingerprints
        raise ValueError("feature cache has no backbone fingerprint (built by an older version) — rebuild it "
                         "(delete the directory)")
    sig_rel = abs(got["param_sig"] - want["param_sig"]) / max(1.0, abs(want["param_sig"]))
    if got["shape_sig"] != want["shape_sig"] or got["n_leaves"] != want["n_leaves"] or sig_rel > 1e-4:
        raise ValueError(
            f"feature cache was built from a DIFFERENT backbone (stored {want}, current {got}) — training on "
            f"it would silently use stale features; rebuild the cache or fix the weights"
        )


def _storage_dtype(name: str) -> np.dtype:
    """The memmap's numpy dtype: bf16 as its raw 16-bit pattern."""
    if name == "float32":
        return np.dtype(np.float32)
    if name == "bfloat16":
        return np.dtype(np.uint16)
    raise ValueError(f"unsupported feature-cache dtype {name!r}")


def to_storage(fmap: torch.Tensor, name: str) -> np.ndarray:
    """A feature map (any device) -> host rows in the stored dtype's bits."""
    if name == "bfloat16":
        return fmap.to(torch.bfloat16).view(torch.int16).cpu().numpy().view(np.uint16)
    return fmap.float().cpu().numpy()


def frame_key(scene_root, rel_path: str) -> str:
    return str(Path(scene_root) / rel_path)


def unique_frames(dataset) -> List[Tuple[str, Tuple[int, int]]]:
    """(key, resize) for every unique frame of a ConcatDataset of scenes,
    in a fixed order; the key is also the absolute image path."""
    out: List[Tuple[str, Tuple[int, int]]] = []
    seen = set()
    for scene in dataset.datasets:
        resize = tuple(scene.resize)
        for rel in list(scene.paths0) + list(scene.paths1):
            k = frame_key(scene.scene_root, rel)
            if k not in seen:
                seen.add(k)
                out.append((k, resize))
    return out


class FeatureCache:
    """Read side: open a built cache directory and gather rows by frame key.

    ``backbone``: the live backbone (the port's tensors), to validate the
    stored fingerprint; a cache built from other weights would silently be
    wrong training data. ``fingerprint``: the backbone's
    ``backbone_fingerprint``, in place of ``backbone`` (a tensor-parallel
    rank holds only its shard, and the fingerprint is the whole backbone's).
    ``expect_dtype``: raise if the stored dtype differs."""

    def __init__(self, root, backbone=None, expect_dtype: str = "", fingerprint: Optional[dict] = None):
        self.root = Path(root)
        meta = json.loads((self.root / _META).read_text())
        if fingerprint is None and backbone is not None:
            fingerprint = backbone_fingerprint(backbone)
        if fingerprint is not None:
            _check_fingerprint(meta, fingerprint)
        if expect_dtype and meta["dtype"] != expect_dtype:
            raise ValueError(
                f"feature cache at {root} stores {meta['dtype']} but {expect_dtype} was requested "
                f"(FEATURE_CACHE_DTYPE) — rebuild the cache or change the setting"
            )
        self.dtype_name = meta["dtype"]
        self.fmap_shape = tuple(meta["fmap_shape"])
        self.index: Dict[str, int] = meta["keys"]
        self._mm = np.memmap(self.root / _DATA, dtype=_storage_dtype(self.dtype_name), mode="r",
                             shape=(len(self.index), *self.fmap_shape))

    @classmethod
    def exists(cls, root) -> bool:
        return (Path(root) / _META).is_file()

    def __contains__(self, key: str) -> bool:
        return key in self.index

    def __len__(self) -> int:
        return len(self.index)

    def gather(self, keys: Sequence[str]) -> torch.Tensor:
        """(len(keys), Hp, Wp, C) CPU tensor in the stored dtype (a copy):
        bf16 rows travel to the card as bf16, half the bytes, and the heads
        upcast them there."""
        try:
            rows = np.fromiter((self.index[k] for k in keys), np.int64, len(keys))
        except KeyError as e:
            raise KeyError(
                f"frame {e.args[0]!r} not in the feature cache at {self.root} ({len(self.index)} frames) — the "
                f"dataset changed since the cache was built; rebuild it (delete the directory)"
            ) from None
        out = torch.from_numpy(np.asarray(self._mm[rows]))
        return out.view(torch.bfloat16) if self.dtype_name == "bfloat16" else out


def _frame_images(scenes: Dict[str, object], chunk, cfg) -> np.ndarray:
    """The chunk's frames cropped to the patch grid, as the loader would give
    them: uint8 from the scenes' raw-frame caches when every frame of the
    chunk has one, else decoded (``data/io.read_color_image``)."""
    from ..data.io import crop_to_patches, read_color_image

    raw = []
    for key, _ in chunk:
        scene, rel = scenes[key]
        imgs = scene.raw_frame(rel)
        if imgs is None:
            break
        raw.append(imgs)
    if len(raw) < len(chunk):
        raw = [read_color_image(key, resize) for key, resize in chunk]
    return np.stack([np.ascontiguousarray(crop_to_patches(im, cfg)) for im in raw])


def build_feature_cache(cfg, backbone, dataset, root, batch_size: int = 8, dtype: str = "bfloat16",
                        log=None, tp=None, fingerprint: Optional[dict] = None,
                        write: bool = True) -> Optional[FeatureCache]:
    """Run the frozen backbone over every unique frame of ``dataset`` and
    write the cache directory. ``backbone``: the port's backbone tensors, on
    the device the pass runs on. Every pass takes ``batch_size`` frames (the
    last padded by repeating its last frame): with the train step's 2B, a
    row is bitwise the train step's map of that frame.

    Tensor parallelism (``mickey_tpu``'s ``mesh=``): ``tp`` is the model
    group whose rank's shard ``backbone`` is; every rank of the group runs
    every pass, and only the one with ``write`` writes the directory (the
    others return None). ``fingerprint``: the whole backbone's
    ``backbone_fingerprint``, which a shard cannot give; by default
    ``backbone``'s."""
    from ..nn.extractor import backbone_features

    check_cfg_cacheable(cfg)
    frames = unique_frames(dataset)
    if not frames:
        raise ValueError("dataset has no frames to cache")
    store = _storage_dtype(dtype)
    scenes = {frame_key(s.scene_root, rel): (s, rel) for s in dataset.datasets
              for rel in list(s.paths0) + list(s.paths1)}
    device = next(t for t in backbone.values() if torch.is_tensor(t)).device

    root = Path(root)
    if write:
        root.mkdir(parents=True, exist_ok=True)
    mm = None
    index: Dict[str, int] = {}
    n = len(frames)
    for start in range(0, n, batch_size):
        chunk = frames[start : start + batch_size]
        imgs = _frame_images(scenes, chunk, cfg)
        if len(imgs) < batch_size:  # pad the tail to the pass's batch
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], batch_size - len(imgs), axis=0)])
        with torch.no_grad():
            fmap = backbone_features({"dinov2": backbone}, torch.from_numpy(imgs).to(device), cfg, tp)
        if not write:
            continue
        rows = to_storage(fmap[: len(chunk)], dtype)
        if mm is None:
            mm = np.memmap(root / _DATA, dtype=store, mode="w+", shape=(n, *rows.shape[1:]))
        for j, (k, _) in enumerate(chunk):
            index[k] = start + j
        mm[start : start + len(chunk)] = rows
        if log:
            log(f"feature cache: {min(start + batch_size, n)}/{n} frames")
    if not write:
        return None
    mm.flush()
    (root / _META).write_text(json.dumps({
        "dtype": dtype,
        "fmap_shape": list(mm.shape[1:]),
        "keys": index,
        "fingerprint": backbone_fingerprint(backbone) if fingerprint is None else fingerprint,
    }))
    del mm
    return FeatureCache(root)
