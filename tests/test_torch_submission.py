"""The port's Map-free submission CLI (``mickey_tpu_torch/cli/submission.py``)
against mickey_tpu's on the CPU.

The machinery of ``predict`` (loader order, the host crop, the keyframe
cache, the double buffer, the drain's skip rules, ``Pose`` text and the zip)
is held bitwise with a deterministic stand-in model, written once in numpy
for the JAX package and once in torch for the port: it takes its pose from
a few pixels of the images and plants a NaN pose and an all-zero rotation in
every batch. The real model's parity with the JAX package is held by
``tests/test_torch_slice.py``; here the real tiny model (the tiny config of
``tests/test_data_pipeline.py``, random weights) checks the port's own
paths against each other. No JAX model is compiled.
"""

import argparse
import shutil
import sys
from typing import NamedTuple
from zipfile import ZipFile

import numpy as np
import pytest
import torch

from mickey_tpu.cli import submission as jsubmission
from mickey_tpu.data.loader import DataModule as JaxDataModule
from mickey_tpu_torch.cli import submission
from mickey_tpu_torch.cli.submission import Pose, eval_split, predict, save_submission
from mickey_tpu_torch.data import raw_cache
from mickey_tpu_torch.data.loader import DataModule
from mickey_tpu_torch.evaluation import METRIC_NAMES, evaluate, score_scene
from mickey_tpu_torch.models import MickeyRelativePose, build_model
from test_torch_data import FRAME_HW, SIZE_WH, data_cfgs, write_split

# signed permutations: one for each branch of mat2quat
PERMS = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1]),
                  np.array([[0.0, 0, 1], [1, 0, 0], [0, 1, 0]])]).astype(np.float32)


class Out(NamedTuple):
    R: object
    t: object
    inliers: object


def _standin_pose(f0, f1, xp):
    """Pose from keyframe and query features (each four (B, 1, 1, 3) pixel
    reads): float32 arithmetic that numpy and torch round alike."""
    b = f1[0].shape[0]
    t = (f1[0] - f0[0]).reshape(b, 1, 3)
    k = (f1[1][:, 0, 0, 0] * 255 + f0[1][:, 0, 0, 1] * 255).round()
    R = PERMS[np.asarray(k).astype(np.int64) % len(PERMS)].copy()
    inliers = f1[2][:, 0, 0, 0] * 255 + f0[3][:, 0, 0, 1]
    if xp is torch:
        R = torch.from_numpy(R)
    t[0, 0, 0] = float("nan")  # planted: no finite estimate
    if b > 1:
        R[1] = 0  # planted: the solver's all-zero fallback
    return Out(R, t, inliers)


def _standin_feats(x):
    return x[:, :1, :1], x[:, -1:, -1:], x[:, 2:3, 3:4], x[:, :1, 1:2]


class JaxStandIn:
    """The stand-in for ``mickey_tpu``'s predict: numpy on its jax arrays."""

    def __init__(self):
        self.extracts = []

    def extract_feats(self, images):
        self.extracts.append(images.shape[0])
        return _standin_feats(np.asarray(images, np.float32))

    def call_with_ref_feats(self, ref_feats, image1, K0, K1, key=None):
        return _standin_pose(tuple(np.asarray(f) for f in ref_feats),
                             _standin_feats(np.asarray(image1, np.float32)), np)

    def __call__(self, image0, image1, K0, K1, key=None, lite=False):
        return _standin_pose(_standin_feats(np.asarray(image0, np.float32)),
                             _standin_feats(np.asarray(image1, np.float32)), np)


class TorchStandIn:
    """The same stand-in for the port's predict, in torch."""

    def __init__(self, cfg):
        self.cfg, self.device, self.extracts, self.sizes = cfg, torch.device("cpu"), [], set()

    def extract_feats(self, images):
        self.extracts.append(images.shape[0])
        return _standin_feats(images.float())

    def call_with_ref_feats(self, ref_feats, image1, K0, K1, generator=None):
        self.sizes.add(tuple(image1.shape[1:3]))
        return _standin_pose(ref_feats, _standin_feats(image1.float()), torch)

    def __call__(self, image0, image1, K0, K1, generator=None, lite=False):
        assert lite
        self.sizes.add(tuple(image0.shape[1:3]))
        return _standin_pose(_standin_feats(image0.float()), _standin_feats(image1.float()), torch)


def zip_members(path):
    with ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def tiny_cfg(root, size_wh=SIZE_WH):
    """``tests/test_data_pipeline.py``'s tiny config on the port's tree."""
    cfg, _ = data_cfgs(root, size_wh)
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.DINOV2.FLOAT16 = False
    cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 128, 8]
    cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
    cfg.PROCRUSTES.IT_MATCHES = 2
    cfg.PROCRUSTES.IT_RANSAC = 8
    cfg.PROCRUSTES.NUM_SAMPLED_MATCHES = 12
    cfg.PROCRUSTES.NUM_CORR_3D_3D = 3
    cfg.PROCRUSTES.NUM_REFINEMENTS = 1
    return cfg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run keeps several test workers on the machine's cores, and
    torch's OpenMP threads in each spin against the others': a predict of
    the tiny model took ~100 times as long as alone. One intra-op thread
    a worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two val scenes of 30 queries: 6 pairs each after the x5 subsampling."""
    return write_split(tmp_path_factory.mktemp("mapfree_sub"), splits=(("val", ("s00000", "s00001")),),
                       n_queries=30)


@pytest.fixture(scope="module")
def model(dataset):
    return build_model(tiny_cfg(dataset), device="cpu")


def test_pose_text_matches_jax():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        for conf in (0.0, 123.0, 17.123456789, float(np.float32(3.3))):
            q, t = rng.normal(size=4), rng.normal(size=3).astype(dtype) * dtype(10.0) ** rng.integers(-3, 3)
            assert str(Pose("seq1/frame_00005.jpg", q, t, conf)) == str(jsubmission.Pose("seq1/frame_00005.jpg", q, t, conf))


@pytest.mark.parametrize("shared_ref", [True, False])
def test_predict_machinery_matches_jax(dataset, tmp_path, shared_ref):
    """Batches of 5 over 12 pairs: 5, 5 (spanning both scenes) and 2. The
    same zip contents, byte for byte, and the same keyframe extracts."""
    cfg, jcfg = data_cfgs(dataset, batch=5)
    ours, theirs = TorchStandIn(cfg), JaxStandIn()
    r_ours = predict(DataModule(cfg, drop_last_val=False).val_dataloader(), ours, progress=False,
                     shared_ref=shared_ref)
    r_theirs = jsubmission.predict(JaxDataModule(jcfg, drop_last_val=False).val_dataloader(), theirs, mesh=None,
                                   progress=False, shared_ref=shared_ref)
    save_submission(r_ours, tmp_path / "ours.zip")
    jsubmission.save_submission(r_theirs, tmp_path / "theirs.zip")
    members = zip_members(tmp_path / "ours.zip")
    assert members == zip_members(tmp_path / "theirs.zip")
    assert sorted(members) == ["pose_s00000.txt", "pose_s00001.txt"]
    assert sum(len(v.splitlines()) for v in members.values()) == 12 - 3 * 2  # two planted skips a batch
    assert len(ours.extracts) == len(theirs.extracts) == (2 if shared_ref else 0)
    assert ours.extracts == [1] * len(ours.extracts)  # only the missing keyframe, unpadded
    assert ours.sizes == {(SIZE_WH[1], SIZE_WH[0])}
    save_submission(predict(DataModule(cfg, drop_last_val=False).val_dataloader(), TorchStandIn(cfg), progress=False,
                            shared_ref=shared_ref), tmp_path / "again.zip")
    assert (tmp_path / "again.zip").read_bytes() == (tmp_path / "ours.zip").read_bytes()


def test_keyframe_cache_evicts_only_keyframes_not_in_the_batch(dataset, monkeypatch):
    """With room for one keyframe, a batch spanning two scenes keeps both,
    and the next drops the first; nothing is extracted twice."""
    cfg, _ = data_cfgs(dataset, batch=5)
    monkeypatch.setattr(submission, "MAX_REF_CACHE", 1)
    model = TorchStandIn(cfg)
    r = predict(DataModule(cfg, drop_last_val=False).val_dataloader(), model, progress=False)
    assert model.extracts == [1, 1] and sum(len(v) for v in r.values()) == 6


class PadSmallExtracts(MickeyRelativePose):
    """The real model, with each extract of fewer than 3 images padded to 3
    by repeating the last and cut back. On the CPU, torch's convolutions and
    matmuls take another path below a batch of 3 images, and a keyframe
    extracted alone then differs from the same image in a larger batch in
    the last bits (measured: head outputs 1.8e-7 to 9e-7 apart, poses 1.7e-5
    apart at this size). The JAX package pads its keyframe extract to the
    batch; the port extracts the keyframe alone. This keeps that rounding
    out of the comparison of the two serving paths."""

    def extract_feats(self, images):
        n = images.shape[0]
        padded = torch.cat([images, images[-1:].expand(max(0, 3 - n), *images.shape[1:])])
        return tuple(f[:n] for f in super().extract_feats(padded))


def assert_shared_matches_plain(m, cfg, atol):
    """``predict`` with the keyframe cache against without: the same names in
    the same order, q and t within ``atol``, inlier counts within 1e-4
    relative."""
    loader = DataModule(cfg, drop_last_val=False).val_dataloader()
    plain = predict(loader, m, progress=False, shared_ref=False)
    shared = predict(loader, m, progress=False, shared_ref=True)
    assert list(plain) == list(shared) == ["s00000", "s00001"]
    for scene in plain:
        assert [p.image_name for p in plain[scene]] == [p.image_name for p in shared[scene]]
        assert len(plain[scene]) == 6
        for a, b in zip(plain[scene], shared[scene]):
            np.testing.assert_allclose(b.q, a.q, atol=atol)
            np.testing.assert_allclose(b.t, a.t, atol=atol)
            np.testing.assert_allclose(b.inliers, a.inliers, rtol=1e-4)


@pytest.mark.parametrize("fused_topk", [False, True])
def test_predict_shared_ref_matches_plain(dataset, model, fused_topk):
    """The keyframe cache against extracting the keyframe for every pair,
    with the JAX package's locks (``test_predict_shared_ref_matches_plain``):
    1e-6 on the dense route; 1e-5 on the fused one, whose descending sort
    makes the sampled set sensitive to the last bits near ties (a flipped
    draw moves a pose by far more than 1e-3)."""
    cfg = tiny_cfg(dataset)
    cfg.TPU.FUSED_TOPK = fused_topk
    assert_shared_matches_plain(PadSmallExtracts(cfg, model.params, device="cpu"), cfg,
                                atol=1e-5 if fused_topk else 1e-6)


@pytest.mark.parametrize("fused_topk", [False, True])
def test_predict_shared_ref_unpadded_matches_plain(dataset, model, fused_topk):
    """The path users run: the keyframe extracted alone (a batch of 1)
    against the plain path, which stacks it with the batch. Same names and
    order; q and t within 1e-4, the measured batch effect (at most 2.1e-5 on
    q and 9.6e-6 on t at this size, on either route) with a margin of about
    5; inlier counts within 1e-4 relative (measured 1.6e-7)."""
    cfg = tiny_cfg(dataset)
    cfg.TPU.FUSED_TOPK = fused_topk
    assert_shared_matches_plain(MickeyRelativePose(cfg, model.params, device="cpu"), cfg, atol=1e-4)


def test_predict_crops_to_the_patch_grid(dataset, model, tmp_path):
    """Frames of 116 x 130 read at that size: the batch is cropped to 112 x
    126 before the model, and the poses equal those of the same split
    cropped beforehand (raw caches of the cropped pixels; the same K)."""
    full, cropped = tmp_path / "full", tmp_path / "cropped"
    shutil.copytree(dataset, full)
    h, w = FRAME_HW
    for scene in sorted((full / "val").iterdir()):
        raw_cache.build_scene_cache(scene, (w, h))
        dst = cropped / "val" / scene.name
        dst.mkdir(parents=True)
        shutil.copy(scene / "poses.txt", dst / "poses.txt")
        (dst / "intrinsics.txt").write_text((scene / "intrinsics.txt").read_text().replace(
            f" {w} {h}\n", f" {SIZE_WH[0]} {SIZE_WH[1]}\n"))
        src = raw_cache.SceneRawCache(scene, (w, h))
        data_path, index_path = raw_cache.cache_paths(dst, SIZE_WH)
        with open(data_path, "wb") as f:  # the cache's layout: a .npy file
            np.save(f, src.data[:, : SIZE_WH[1], : SIZE_WH[0]])
        shutil.copy(raw_cache.cache_paths(scene, (w, h))[1], index_path)
    got, want = [], []
    for root, size, out in ((full, (w, h), got), (cropped, SIZE_WH, want)):
        cfg = tiny_cfg(root, size)
        probe = TorchStandIn(cfg)
        loader = DataModule(cfg, drop_last_val=False).val_dataloader()
        assert next(iter(loader))["image0"].shape[1:3] == (size[1], size[0])
        predict(loader, probe, progress=False)
        assert probe.sizes == {(SIZE_WH[1], SIZE_WH[0])}
        out.append(predict(loader, MickeyRelativePose(cfg, model.params, device="cpu"), progress=False))
    assert {s: [str(p) for p in v] for s, v in got[0].items()} == {s: [str(p) for p in v] for s, v in want[0].items()}


def test_eval_split_writes_a_zip_the_evaluator_scores(dataset, model, tmp_path):
    args = argparse.Namespace(config="", dataset_config="", checkpoint="", dinov2=None, output_root=tmp_path / "out",
                              split="val", batch_size=None, no_shared_ref=False)
    cfg = tiny_cfg(dataset)
    eval_split(args, cfg=cfg, model=model)
    assert cfg.TRAINING.BATCH_SIZE == 12 and cfg.TRAINING.NUM_WORKERS == 8
    zip_path = tmp_path / "out" / "submission.zip"
    assert sorted(zip_members(zip_path)) == ["pose_s00000.txt", "pose_s00001.txt"]
    metrics, _ = evaluate(zip_path, dataset / "val")
    assert len(metrics) == 8 and 0 < metrics["Estimates for % of frames"] <= 1
    with ZipFile(zip_path) as zf:
        assert list(score_scene(dataset / "val", zf, "s00000").metrics) == list(METRIC_NAMES)


def test_cli_refuses_to_run_on_the_cpu_in_silence(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(config="", dataset_config="", checkpoint="", dinov2=None, output_root=tmp_path,
                              split="val", batch_size=None, no_shared_ref=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_split(args, cfg=tiny_cfg(dataset))
    monkeypatch.setattr(sys, "argv", ["submission", "--split", "val", "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        submission.main()
    assert not (tmp_path / "submission.zip").exists()
