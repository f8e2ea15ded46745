"""The port's frozen-backbone feature cache against mickey_tpu on the CPU.

One train scene and one val scene in the Map-free layout
(``test_torch_data.write_split``: cv2 JPEGs of 116 x 130, read at 112 x
126), the model at ``tests/test_torch_validation.py``'s size. Checked:

- fp32 rows are bitwise the staged train step's backbone maps of the same
  frames, and a cached step equals the staged step bitwise (loss, grad norm,
  every parameter), as the JAX package locks it (there at 1e-6);
- bf16 rows are bitwise ``ml_dtypes``' round-to-nearest-even of the fp32
  rows (the JAX package's storage), kept as raw 16-bit patterns;
- a cache written by either package opens, with its backbone fingerprint
  validated, in the other, and gathers the same rows; a different backbone
  and another dtype are refused; the fingerprints agree (shape hash and leaf
  count equal, the parameter sum within 1e-6 relative here, where the
  check allows the JAX package's 1e-4);
- the guards of ``tests/test_feature_cache.py`` (augmentation, grayscale,
  the staged step);
- ``fit`` builds the cache, trains from it image-free, and a second trainer
  reopens it.
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from mickey_tpu.data import MapFreeDataset as JaxMapFreeDataset
from mickey_tpu.training import feature_cache as jfc
from mickey_tpu_torch.data import DataModuleTraining, MapFreeDataset
from mickey_tpu_torch.data.loader import collate
from mickey_tpu_torch.models import MicKeyTrainer
from mickey_tpu_torch.training import feature_cache as fc
from mickey_tpu_torch.weights import init_params_numpy, tree_leaves
from test_torch_data import write_split
from test_torch_validation import one_intra_op_thread, train_cfg  # noqa: F401 (the fixture applies here too)
from test_training import train_cfg as jax_train_cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("fcache"), splits=(("train", ("s0",)), ("val", ("v0",))),
                       n_queries=6, seed=3)


def _cfgs(root):
    out = []
    for cfg in (train_cfg(), jax_train_cfg()):
        cfg.DATASET.DATA_ROOT = str(root)
        cfg.DATASET.MIN_OVERLAP_SCORE, cfg.DATASET.MAX_OVERLAP_SCORE = 0.0, 1.0
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def setup(root):
    cfg, cfg_j = _cfgs(root)
    params = init_params_numpy(cfg, 0)
    tr = MicKeyTrainer(cfg, params=params, device="cpu", out_dir="unused")
    return cfg, cfg_j, params, tr


def test_fp32_rows_bitwise_and_cached_step_equals_staged(setup, tmp_path):
    cfg, _, params, tr = setup
    ds = MapFreeDataset(cfg, "train")
    batch = collate([ds[i] for i in range(2)])  # two pairs: a pass of 4 frames
    cache = fc.build_feature_cache(cfg, tr.backbone, ds, tmp_path / "c32", batch_size=4, dtype="float32")
    assert len(cache) == len(fc.unique_frames(ds)) == 6  # 5 consecutive pairs share frames
    keys = [fc.frame_key(sr, p[half]) for half in (0, 1) for sr, p in zip(batch["scene_root"], batch["pair_names"])]
    rows = cache.gather(keys)
    db = tr.device_batch(batch)
    fmap = tr.train_step.backbone_fwd(tr.backbone, db["image0"], db["image1"])
    assert rows.dtype == torch.float32 and torch.equal(rows, fmap)

    staged = MicKeyTrainer(cfg, params=params, device="cpu", out_dir="unused")
    cached = MicKeyTrainer(cfg, params=params, device="cpu", out_dir="unused")
    cached.feature_cache = cache
    meta = {k: v for k, v in batch.items() if not k.startswith("image")}
    m_s, m_c = staged.training_step(batch), cached.training_step(meta)
    assert m_s["grads_finite"] == 1.0 and m_s == m_c
    for (_, a), (_, b) in zip(tree_leaves(staged.state.params), tree_leaves(cached.state.params)):
        assert torch.equal(a.detach(), b.detach())


def test_bf16_rows_are_the_ml_dtypes_rounding(setup, tmp_path):
    cfg, _, _, tr = setup
    ds = MapFreeDataset(cfg, "train")
    c32 = fc.build_feature_cache(cfg, tr.backbone, ds, tmp_path / "c32", batch_size=4, dtype="float32")
    c16 = fc.build_feature_cache(cfg, tr.backbone, ds, tmp_path / "c16", batch_size=4, dtype="bfloat16")
    keys = list(c32.index)
    want = c32.gather(keys).numpy().astype(ml_dtypes.bfloat16).view(np.uint16)
    got = c16.gather(keys)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    rounding = np.float32(1 + 2**-8 + 2**-9)  # above the tie: rounds up; ties go to even
    bits = fc.to_storage(torch.tensor([rounding, 1 + 2**-8, 1 + 3 * 2**-8, -np.inf]), "bfloat16")
    np.testing.assert_array_equal(bits, np.array([rounding, 1 + 2**-8, 1 + 3 * 2**-8, -np.inf], np.float32)
                                  .astype(ml_dtypes.bfloat16).view(np.uint16))


def test_fingerprint_matches_jax(setup):
    _, _, params, tr = setup
    ours, ref = fc.backbone_fingerprint(tr.backbone), jfc.backbone_fingerprint(params["dinov2"])
    assert ours["shape_sig"] == ref["shape_sig"] and ours["n_leaves"] == ref["n_leaves"] == 20
    assert abs(ours["param_sig"] - ref["param_sig"]) <= 1e-6 * abs(ref["param_sig"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_cache_opens_in_either_package(setup, tmp_path, dtype):
    cfg, cfg_j, params, tr = setup
    jcache = jfc.build_feature_cache(cfg_j, params["dinov2"], JaxMapFreeDataset(cfg_j, "train"), tmp_path / "jax",
                                     batch_size=4, dtype=dtype)
    ours = fc.build_feature_cache(cfg, tr.backbone, MapFreeDataset(cfg, "train"), tmp_path / "port",
                                  batch_size=4, dtype=dtype)
    opened = fc.FeatureCache(tmp_path / "jax", backbone=tr.backbone, expect_dtype=dtype)
    jopened = jfc.FeatureCache(tmp_path / "port", backbone=jax.tree.map(np.asarray, params["dinov2"]),
                               expect_dtype=dtype)
    assert opened.index == jcache.index == ours.index == jopened.index
    keys = list(ours.index)

    def bits(x):
        x = x.numpy() if torch.is_tensor(x) else x
        return x.view(np.uint16) if dtype == "bfloat16" else x

    def as_numpy(t):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    np.testing.assert_array_equal(bits(as_numpy(opened.gather(keys))), bits(jcache.gather(keys)))
    np.testing.assert_array_equal(bits(jopened.gather(keys)), bits(as_numpy(ours.gather(keys))))
    # the two frameworks' backbones agree to fp32 rounding, not bitwise
    np.testing.assert_allclose(np.asarray(jcache.gather(keys), np.float32),
                               ours.gather(keys).float().numpy(), rtol=2e-2 if dtype == "bfloat16" else 1e-3,
                               atol=2e-2 if dtype == "bfloat16" else 1e-3)
    other = MicKeyTrainer(cfg, params=init_params_numpy(cfg, 1), device="cpu", out_dir="unused").backbone
    with pytest.raises(ValueError, match="DIFFERENT backbone"):
        fc.FeatureCache(tmp_path / "jax", backbone=other)
    with pytest.raises(ValueError, match="FEATURE_CACHE_DTYPE"):
        fc.FeatureCache(tmp_path / "jax", expect_dtype="float32" if dtype == "bfloat16" else "bfloat16")
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    del meta["fingerprint"]
    (tmp_path / "port" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="no backbone fingerprint"):
        fc.FeatureCache(tmp_path / "port", backbone=tr.backbone)
    with pytest.raises(KeyError, match="rebuild"):
        opened.gather(["/no/such/frame.jpg"])


def test_guards(setup, root, tmp_path):
    """As ``tests/test_feature_cache.py``: augmentation and grayscale make
    cached features stale, and the cache needs the staged step."""
    cfg, _, params, tr = setup
    aug = cfg.clone()
    aug.DATASET.AUGMENTATION_TYPE = "colorjitter"
    with pytest.raises(ValueError, match="AUGMENTATION_TYPE"):
        fc.build_feature_cache(aug, tr.backbone, MapFreeDataset(aug, "train"), tmp_path / "cbad")
    for key, value, match in (("AUGMENTATION_TYPE", "colorjitter", "AUGMENTATION_TYPE"),
                              ("BLACK_WHITE", True, "BLACK_WHITE"), ("STAGED_TRAIN", False, "STAGED_TRAIN")):
        bad = cfg.clone()
        bad.TPU.FEATURE_CACHE = str(tmp_path / "x")
        (bad.TPU if key == "STAGED_TRAIN" else bad.DATASET)[key] = value
        with pytest.raises(ValueError, match=match):
            MicKeyTrainer(bad, params=params, device="cpu", out_dir="unused")


def test_fit_builds_and_trains_from_the_cache(setup, tmp_path):
    cfg, _, params, _ = setup
    cfg = cfg.clone()
    cfg.TRAINING.BATCH_SIZE = cfg.TRAINING.N_SAMPLES_SCENE = 8
    cfg.TPU.FEATURE_CACHE = str(tmp_path / "cache")
    cfg.TPU.FEATURE_CACHE_DTYPE = "bfloat16"
    tr = MicKeyTrainer(cfg, params=params, device="cpu", out_dir=str(tmp_path / "run"))
    seen = []
    step = tr.training_step
    tr.training_step = lambda batch: (seen.append(sorted(batch)), step(batch))[1]
    tr.fit(DataModuleTraining(cfg), max_epochs=1, val_batches=1, log_interval=10)
    assert tr.global_step == 1 and fc.FeatureCache.exists(cfg.TPU.FEATURE_CACHE)
    assert "image0" not in seen[0] and "fmap" in seen[0]
    assert (tmp_path / "run" / "last").is_dir()  # validation ran on images, checkpoints were written
    built = (tmp_path / "cache" / "features.dat").stat().st_mtime_ns
    tr2 = MicKeyTrainer(cfg, params=params, device="cpu", out_dir=str(tmp_path / "run2"))
    tr2.fit(DataModuleTraining(cfg), max_epochs=1, val_batches=1, log_interval=10)
    assert tr2.global_step == 1 and (tmp_path / "cache" / "features.dat").stat().st_mtime_ns == built
    tr3 = MicKeyTrainer(cfg, params=dict(params, dinov2=init_params_numpy(cfg, 1)["dinov2"]), device="cpu",
                        out_dir=str(tmp_path / "run3"))
    with pytest.raises(ValueError, match="DIFFERENT backbone"):
        tr3.fit(DataModuleTraining(cfg), max_epochs=1, val_batches=1, log_interval=10)
