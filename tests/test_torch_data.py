"""The port's presets and data package against mickey_tpu on the CPU.

A fake Map-free dataset is written by cv2 (two val scenes, one train scene
with an overlaps file, one test scene; frames of 116 x 130, read at 112 x
126, a multiple of the patch size 14). Everything here is numpy on both
sides, so every comparison is bitwise: the same values, dtypes and shapes.
The JAX loader runs with its native ingest off (``TRAINING.NATIVE_LOADER``),
the per-sample cv2 path that the port keeps.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from mickey_tpu import config as jconfig
from mickey_tpu.data import augment as jaugment
from mickey_tpu.data import io as jio
from mickey_tpu.data import raw_cache as jraw
from mickey_tpu.data.loader import DataModule as JaxDataModule
from mickey_tpu.data.loader import DataModuleTraining as JaxDataModuleTraining
from mickey_tpu.data.loader import collate as jax_collate
from mickey_tpu.data.mapfree import MapFreeDataset as JaxMapFreeDataset
from mickey_tpu.data.sampler import RandomConcatSampler as JaxSampler
from mickey_tpu_torch import config as pconfig
from mickey_tpu_torch.data import augment, io, raw_cache
from mickey_tpu_torch.data.loader import DataLoader, DataModule, DataModuleTraining, collate
from mickey_tpu_torch.data.mapfree import MapFreeDataset
from mickey_tpu_torch.data.sampler import RandomConcatSampler

FRAME_HW = (130, 116)  # frames as written
SIZE_WH = (112, 126)  # as read: 8 x 9 patches
N_QUERIES = 10
PRESETS = ("MicKey/curriculum_learning", "MicKey/curriculum_learning_warm_up", "MicKey/overlap_score",
           "MicKey/overlap_score_warm_up", "datasets/mapfree")


def _rand_quat(rng):
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def write_split(root, splits=(("val", ("s00000", "s00001")), ("train", ("s00100",)), ("test", ("s00200",))),
                n_queries=N_QUERIES, seed=0):
    """Scenes in the Map-free layout under ``root/<split>/<scene>``: a seq0
    keyframe and ``n_queries`` seq1 frames (cv2 JPEGs of FRAME_HW), poses,
    intrinsics, and for train scenes an overlaps file of consecutive pairs."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = FRAME_HW
    for split, scenes in splits:
        for scene in scenes:
            sdir = Path(root) / split / scene
            (sdir / "seq0").mkdir(parents=True)
            (sdir / "seq1").mkdir(parents=True)
            poses, intr = [], []
            names = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05}.jpg" for i in range(n_queries)]
            for name in names:
                cv2.imwrite(str(sdir / name), rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
                q, t = _rand_quat(rng), rng.normal(size=3) * 0.3
                poses.append(f"{name} " + " ".join(f"{v:.6f}" for v in [*q, *t]))
                intr.append(f"{name} 110.0 110.0 58.0 65.0 {w} {h}")
            (sdir / "poses.txt").write_text("\n".join(poses) + "\n")
            (sdir / "intrinsics.txt").write_text("\n".join(intr) + "\n")
            if split == "train":
                idxs = np.array([[1, i, 1, i + 1] for i in range(n_queries - 1)], dtype=np.uint16)
                np.savez(sdir / "overlaps.npz", idxs=idxs, overlaps=rng.uniform(0.1, 0.8, len(idxs)))
    return Path(root)


def data_cfgs(root, size_wh=SIZE_WH, batch=3):
    """The same dataset config in both packages."""
    cfgs = []
    for mod in (pconfig, jconfig):
        cfg = mod.default_config()
        cfg.DATASET.DATA_ROOT = str(root)
        cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT = size_wh
        cfg.TRAINING.BATCH_SIZE = batch
        cfg.TRAINING.NUM_WORKERS = 2
        cfg.TRAINING.N_SAMPLES_SCENE = 4
        cfg.TRAINING.NATIVE_LOADER = False
        cfgs.append(cfg)
    return cfgs


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("mapfree"))


def assert_same(a, b, what=""):
    """Bitwise equality of a nested sample / batch: same keys, types, dtypes, values."""
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for x, y in zip(a, b):
            assert_same(x, y, what)
    else:
        assert type(a) is type(b) and a == b, what


# -- presets -------------------------------------------------------------------


@pytest.mark.parametrize("name", PRESETS)
def test_preset_merges_as_the_jax_packages(name):
    ours = pconfig.default_config()
    ours.merge_from_file(str(pconfig.preset_path(name)))
    theirs = jconfig.default_config()
    theirs.merge_from_file(str(Path(jconfig.__file__).parent / "configs" / f"{name}.yaml"))
    assert ours.to_dict() == theirs.to_dict()
    assert pconfig.preset_path(name).read_bytes() == (Path(jconfig.__file__).parent / "configs" / f"{name}.yaml").read_bytes()


def test_preset_path_names_the_presets_on_a_miss():
    with pytest.raises(FileNotFoundError, match="datasets/mapfree"):
        pconfig.preset_path("MicKey/no_such_recipe")


# -- io ------------------------------------------------------------------------


def test_io_matches_jax(dataset, tmp_path):
    import cv2

    scene = dataset / "val" / "s00000"
    frame = scene / "seq1" / "frame_00003.jpg"
    for resize in (None, SIZE_WH, (56, 70)):
        assert_same(io.read_color_image(frame, resize), jio.read_color_image(frame, resize), f"resize {resize}")
    gray = lambda im: jaugment.grayscale(im)  # noqa: E731
    assert_same(io.read_color_image(frame, SIZE_WH, augment_fn=gray), jio.read_color_image(frame, SIZE_WH, gray))
    for resize in (None, SIZE_WH):
        assert_same(io.read_intrinsics(scene / "intrinsics.txt", resize), jio.read_intrinsics(scene / "intrinsics.txt", resize))
    K = np.array([[110.0, 0, 58.0], [0, 110.0, 65.0], [0, 0, 1]], np.float64)
    assert_same(io.correct_intrinsic_scale(K, 0.7, 1.3), jio.correct_intrinsic_scale(K, 0.7, 1.3))
    depth = np.random.default_rng(1).integers(0, 60000, (30, 20), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    assert_same(io.read_depth_image(tmp_path / "d.png"), jio.read_depth_image(tmp_path / "d.png"))
    with pytest.raises(FileNotFoundError):
        io.read_color_image(tmp_path / "missing.jpg")


@pytest.mark.parametrize("hw", [(130, 116), (126, 112), (27, 43), (720, 540)])
def test_pad_to_multiple_matches_jax_on_images_and_batches(hw):
    rng = np.random.default_rng(2)
    batch = rng.integers(0, 255, (3, *hw, 3), dtype=np.uint8)
    for im in batch:
        assert_same(io.pad_to_multiple(im), jio.pad_to_multiple(im))
    assert_same(io.pad_to_multiple(batch[0, ..., 0], 4), jio.pad_to_multiple(batch[0, ..., 0], 4))  # (H, W)
    cropped = io.pad_to_multiple(batch, 14)
    assert_same(cropped, np.stack([jio.pad_to_multiple(im, 14) for im in batch]))
    assert np.shares_memory(cropped, batch)  # a view: the crop copies nothing
    if hw == (720, 540):
        assert cropped.shape == (3, 714, 532, 3)


def test_crop_to_patches_takes_the_configured_patch_size():
    """The one crop before the backbone: ``pad_to_multiple`` at
    MICKEY.DINOV2.DOWN_FACTOR, on a numpy batch and on a tensor alike."""
    import torch
    from types import SimpleNamespace

    batch = np.random.default_rng(3).integers(0, 255, (2, 130, 116, 3), dtype=np.uint8)
    for df in (14, 8):
        cfg = SimpleNamespace(MICKEY=SimpleNamespace(DINOV2=SimpleNamespace(DOWN_FACTOR=df)))
        assert_same(io.crop_to_patches(batch, cfg), io.pad_to_multiple(batch, df))
        assert torch.equal(io.crop_to_patches(torch.from_numpy(batch), cfg),
                           torch.from_numpy(np.ascontiguousarray(io.pad_to_multiple(batch, df))))


def test_reader_without_a_decoder_names_the_raw_cache(dataset, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    with pytest.raises(ImportError, match="raw-frame cache"):
        io.read_color_image(dataset / "val" / "s00000" / "seq1" / "frame_00000.jpg")


# -- dataset, sampler, augmentations --------------------------------------------


@pytest.mark.parametrize("mode", ["val", "train", "test"])
def test_every_sample_matches_jax(dataset, mode):
    cfg, jcfg = data_cfgs(dataset)
    if mode == "train":  # a range that keeps some pairs and drops others
        for c in (cfg, jcfg):
            c.DATASET.MIN_OVERLAP_SCORE, c.DATASET.MAX_OVERLAP_SCORE = 0.3, 0.7
    ours, theirs = MapFreeDataset(cfg, mode), JaxMapFreeDataset(jcfg, mode)
    assert len(ours) == len(theirs) > 0
    assert ours.cumulative_sizes == theirs.cumulative_sizes
    for i in range(len(ours)):
        assert_same(ours[i], theirs[i], f"{mode}[{i}]")
    if mode == "test":
        assert not ours[0]["T_0to1"].any()  # test scenes ship no ground truth


@pytest.mark.parametrize("replacement,shuffle,repeat,reset,shard",
                         [(True, True, 1, False, None), (False, True, 2, False, None), (False, False, 1, True, None),
                          (True, True, 3, False, (1, 2))])
def test_sampler_stream_matches_jax(dataset, replacement, shuffle, repeat, reset, shard):
    cfg, jcfg = data_cfgs(dataset)
    ds, jds = MapFreeDataset(cfg, "val"), JaxMapFreeDataset(jcfg, "val")
    for seed in (0, 66):
        kw = dict(subset_replacement=replacement, shuffle=shuffle, repeat=repeat, seed=seed, reset_on_iter=reset,
                  shard=shard)
        ours, theirs = RandomConcatSampler(ds, 5, **kw), JaxSampler(jds, 5, **kw)
        assert len(ours) == len(theirs)
        for _ in range(2):  # two epochs: the generator carries over unless reset
            assert list(iter(ours)) == list(iter(theirs))


def test_augmentations_match_jax():
    im = np.random.default_rng(3).uniform(0, 1, (20, 24, 3)).astype(np.float32)
    assert_same(augment.grayscale(im), jaugment.grayscale(im))
    for seed in range(4):
        assert_same(augment.color_jitter(im, rng=np.random.default_rng(seed)),
                    jaugment.color_jitter(im, rng=np.random.default_rng(seed)))


def test_collate_matches_jax(dataset):
    cfg, jcfg = data_cfgs(dataset)
    ds, jds = MapFreeDataset(cfg, "val"), JaxMapFreeDataset(jcfg, "val")
    assert_same(collate([ds[i] for i in (0, 3, 1)]), jax_collate([jds[i] for i in (0, 3, 1)]))
    raw = [dict(ds[0], image0=np.zeros((4, 4, 3), np.uint8))] * 2
    assert collate(raw)["image0"].dtype == np.uint8  # uint8 images stay uint8


# -- loader ----------------------------------------------------------------------


@pytest.mark.parametrize("which", ["val", "test", "train", "train_seeded", "val_seeded"])
def test_loader_batches_match_jax(dataset, which):
    cfg, jcfg = data_cfgs(dataset)
    module, jmodule = ((DataModuleTraining, JaxDataModuleTraining) if which.endswith("seeded")
                       else (DataModule, JaxDataModule))
    make = f"{which.split('_')[0]}_dataloader"
    kw = {} if which.endswith("seeded") else {"drop_last_val": False}
    ours, theirs = getattr(module(cfg, **kw), make)(), getattr(jmodule(jcfg, **kw), make)()
    assert len(ours) == len(theirs)
    for _ in range(2):  # a second epoch: the train sampler draws anew
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert a["image0"].dtype == np.float32  # decoded by cv2
            assert_same(a, b)


def test_raw_cache_is_shared_by_both_packages(dataset, tmp_path):
    """A cache built by either package reads the same in the other, the files
    are byte-identical, and the loaders' uint8 batches from it agree."""
    root = tmp_path / "ds"
    shutil.copytree(dataset, root)
    scenes = sorted((root / "val").iterdir())
    copy = tmp_path / "other"
    shutil.copytree(scenes[0], copy)
    raw_cache.build_scene_cache(scenes[0], SIZE_WH)  # the port's, read by JAX below
    jraw.build_scene_cache(scenes[1], SIZE_WH)  # JAX's, read by the port
    jraw.build_scene_cache(copy, SIZE_WH)
    for suffix in (0, 1):
        a, b = raw_cache.cache_paths(scenes[0], SIZE_WH)[suffix], jraw.cache_paths(copy, SIZE_WH)[suffix]
        assert a.name == b.name and a.read_bytes() == b.read_bytes()
    assert raw_cache.list_scene_frames(scenes[0]) == jraw.list_scene_frames(scenes[0])
    for scene in scenes:
        ours, theirs = raw_cache.SceneRawCache(scene, SIZE_WH), jraw.SceneRawCache(scene, SIZE_WH)
        assert ours.rows == theirs.rows
        for name in ours.rows:
            assert_same(np.asarray(ours.image(name)), np.asarray(theirs.image(name)))
            np.testing.assert_array_equal(ours.image(name).astype(np.float32) / 255.0,
                                          io.read_color_image(scene / name, SIZE_WH))
    assert raw_cache.SceneRawCache.open_if_exists(scenes[0], (56, 70)) is None

    cfg, jcfg = data_cfgs(root)
    got, want = list(DataModule(cfg, drop_last_val=False).val_dataloader()), list(
        JaxDataModule(jcfg, drop_last_val=False).val_dataloader())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["image0"].dtype == np.uint8  # the raw-cache path
        assert_same(a, b)


def test_loader_without_a_decoder(dataset, tmp_path, monkeypatch):
    """Without cv2, a split with raw caches loads and one without raises the
    reader's error to the consumer (the prefetch thread does not swallow it)."""
    root = tmp_path / "ds"
    shutil.copytree(dataset, root)
    cfg, _ = data_cfgs(root)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="raw-frame cache"):
        list(DataModule(cfg, drop_last_val=False).val_dataloader())
    monkeypatch.undo()
    for scene in (root / "val").iterdir():
        raw_cache.build_scene_cache(scene, SIZE_WH)
    monkeypatch.setitem(sys.modules, "cv2", None)
    batches = list(DataModule(cfg, drop_last_val=False).val_dataloader())
    assert sum(len(b["scene_id"]) for b in batches) == 4
    index = json.loads(raw_cache.cache_paths(root / "val" / "s00000", SIZE_WH)[1].read_text())
    assert list(index["frames"]) == raw_cache.list_scene_frames(root / "val" / "s00000")


def test_loader_stops_early_and_refuses_feature_cache_batches(dataset, tmp_path):
    """A consumer may leave early. Feature-cache batches (``meta_only``)
    refuse to read frames: they carry the pairs' metadata alone, bitwise the
    JAX loader's, and with a feature cache handed to the loader its rows of
    the batch's frames as ``fmap`` (image0 frames, then image1 frames). A
    batch whose frames the cache lacks is refused: the gather's KeyError
    reaches the consumer."""
    from mickey_tpu.data.loader import DataLoader as JaxDataLoader
    from mickey_tpu_torch.training.feature_cache import FeatureCache, frame_key

    cfg, jcfg = data_cfgs(dataset, batch=1)
    loader = DataModule(cfg, drop_last_val=False).val_dataloader()
    for _ in zip(range(1), loader):  # a consumer that leaves after one batch
        pass
    assert len(list(loader)) == 4
    ours = list(DataLoader(MapFreeDataset(cfg, "val"), 2, meta_only=True))
    ref = list(JaxDataLoader(JaxMapFreeDataset(jcfg, "val"), 2, meta_only=True, native_io=False))
    assert len(ours) == len(ref) == 2 and "image0" not in ours[0]
    for a, b in zip(ours, ref):
        assert_same(a, b)
    cfg.TPU.FEATURE_CACHE = "features/"
    train = DataModule(cfg).train_dataloader()
    assert train.meta_only and train.feature_cache is None

    class KeyCache:  # gathers the keys it is asked for
        def gather(self, keys):
            return list(keys)

    train.feature_cache = KeyCache()
    batch = next(iter(train))
    pairs = list(zip(batch["scene_root"], batch["pair_names"]))
    assert batch["fmap"] == [frame_key(sr, p[0]) for sr, p in pairs] + [frame_key(sr, p[1]) for sr, p in pairs]

    # a cache of one frame that is not in the split
    (tmp_path / "meta.json").write_text(json.dumps({"dtype": "float32", "fmap_shape": [1, 1, 2],
                                                    "keys": {"elsewhere.jpg": 0}, "fingerprint": {}}))
    np.zeros((1, 1, 1, 2), np.float32).tofile(tmp_path / "features.dat")
    train.feature_cache = FeatureCache(tmp_path)
    with pytest.raises(KeyError, match="not in the feature cache"):
        next(iter(train))
