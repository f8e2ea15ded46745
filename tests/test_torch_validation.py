"""The port's validation against mickey_tpu on the CPU.

The size is the JAX package's own training-test size (``train_cfg`` of
``tests/test_training.py``): ViT-S width, heads 32-16-128-8, 126 x 112
images (9 x 8 keypoints), the loss at it/R_it/S = 2/3/16 with 5-point sets,
the solver at 2 x 4 hypotheses over 12 samples. Weights come from
``init_params_numpy`` and go to both packages.

The two PRNG streams differ, so the draws are injected: the loss's as
``sample_override`` (minimal sets of distinct keypoints, inside the score
head's border), the solver's replayed from JAX's key schedule over the
whole flat matrix (prefilter 0) with JAX's own samplers.

Tolerances: ``_val_metrics_from_corr`` on the same correspondences, fp32
in both with another summation order: the loss metrics at 1e-5 relative,
poses after RANSAC and refinement at 1e-4 (relative, and absolute near
zero), the two angles plus the arccos slack of ``test_torch_metrics``.
Within the port, staged, plain and cached validation are bitwise equal, and
the aggregation is bitwise JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mickey_tpu.models.training_model import MicKeyTrainer as JaxTrainer
from mickey_tpu.nn.extractor import compute_correspondences as jax_corr
from mickey_tpu.training import train_step as jts
from mickey_tpu.training.loss import LossConfig as JaxLossConfig
from mickey_tpu_torch.config import default_config
from mickey_tpu_torch.models import MicKeyTrainer, training_model
from mickey_tpu_torch.nn.extractor import Correspondences
from mickey_tpu_torch.training.train_step import ValStep, val_metrics_from_corr
from mickey_tpu_torch.weights import init_params_numpy, tree_leaves
from test_torch_metrics import _arccos_slack
from test_torch_slice import _replay_jax_draws
from test_training import synthetic_batch
from test_training import train_cfg as jax_train_cfg

B, H, W = 4, 126, 112
ROWS, COLS = H // 14, W // 14


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread while a module runs: under the tier-1 run's
    test workers torch's OpenMP threads spin against each other's (the
    model-running tests of this file took twice as long even alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def train_cfg():
    """``tests/test_training.py::train_cfg`` in the port's config."""
    cfg = default_config()
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.DINOV2.FLOAT16 = False
    cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 128, 8]
    cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
    cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT = W, H
    cfg.TRAINING.BATCH_SIZE = 8
    cfg.TRAINING.NUM_WORKERS = 2
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    gh.IT_MATCHES, gh.IT_RANSAC, gh.NUM_CORR_3d3d, gh.NUM_REF_STEPS = 2, 3, 5, 1
    cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES = 16
    pc = cfg.PROCRUSTES
    pc.IT_MATCHES, pc.IT_RANSAC, pc.NUM_SAMPLED_MATCHES, pc.NUM_CORR_3D_3D, pc.NUM_REFINEMENTS = 2, 4, 12, 3, 1
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg_t, cfg_j = train_cfg(), jax_train_cfg()
    params = init_params_numpy(cfg_t, 0)
    batch = synthetic_batch(np.random.default_rng(4), B=B)
    return cfg_t, cfg_j, params, batch


def _loss_draws(cfg, seed=9):
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    return chip_smoke.inject_draws(np.random.default_rng(seed), B, ROWS, COLS, gh.IT_MATCHES,
                                   cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES, gh.IT_RANSAC, gh.NUM_CORR_3d3d)


def _close(ours, ref, key, rtol):
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    slack = _arccos_slack(b) if key in ("R_err", "t_err_ang") else 0.0
    assert a.shape == b.shape, key
    assert np.all(np.abs(a - b) <= rtol * (1 + np.abs(b)) + slack), (key, a, b)


def test_val_metrics_from_corr_matches_jax(setup, monkeypatch):
    """The validation body on JAX's own correspondences, with JAX's loss
    draws injected into both and its solver draws replayed."""
    cfg_t, cfg_j, params, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    corr = jax.jit(lambda p, a, b: jax_corr(p, a, b, cfg_j, train=False)[0])(params, jb["image0"], jb["image1"])
    idx, ridx = _loss_draws(cfg_t)
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(jts, "metric_pose_loss", functools.partial(
        jts.metric_pose_loss, sample_override=(jnp.asarray(idx.numpy()), jnp.asarray(ridx.numpy()))))
    ref = jts._val_metrics_from_corr(corr, jb, key, cfg_j, JaxLossConfig.from_cfg(cfg_j), cfg_j.PROCRUSTES)
    flat = np.asarray(corr.final_scores).reshape(B, -1)
    draws = _replay_jax_draws(key, jnp.asarray(flat), cfg_j)

    tcorr = Correspondences(*(torch.from_numpy(np.array(f)) for f in corr))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ours = val_metrics_from_corr(tcorr, tb, cfg_t, ValStep(cfg_t).lc, sample_override=(idx, ridx), draws=draws)
    assert list(ours) == list(ref)
    assert np.isfinite(np.asarray(ref["vcre"])).all() and (np.asarray(ref["inliers"]) > 0).any()
    for k in ("loss", "avg_loss_rot", "avg_loss_trans"):
        _close(ours[k].numpy(), ref[k], k, 1e-5)
    for k in ("t_err_ang", "t_err_euc", "R_err", "vcre", "inliers"):
        _close(ours[k].numpy(), ref[k], k, 1e-4)


def test_staged_and_plain_validation_are_one_computation(setup):
    """``ValStep``: the plain step equals its staged pieces bitwise, and the
    heads run in eval mode (no BatchNorm stat moves)."""
    cfg_t, _, params, batch = setup
    tr = MicKeyTrainer(cfg_t, params=params, device="cpu", out_dir="unused")
    step, db = tr.val_step, tr.device_batch(batch)
    stats = [t.clone() for p, t in tree_leaves(tr.state.params) if p[-1] in ("mean", "var")]
    gen = torch.Generator().manual_seed(5)
    plain = step(tr.state.params, tr.backbone, db, gen)
    fmap = torch.cat([step.backbone_fwd(tr.backbone, db["image0"]), step.backbone_fwd(tr.backbone, db["image1"])])
    assert fmap.dtype == torch.float32 and fmap.shape == (2 * B, ROWS, COLS, 384)
    staged = step.tail(tr.state.params, fmap, db, gen.manual_seed(5))
    for k in plain:
        assert torch.equal(plain[k], staged[k]), k
    after = [t for p, t in tree_leaves(tr.state.params) if p[-1] in ("mean", "var")]
    assert all(torch.equal(a, b) for a, b in zip(stats, after))
    cfg_bf16 = cfg_t.clone()
    cfg_bf16.MICKEY.DINOV2.FLOAT16 = True
    assert ValStep(cfg_bf16).backbone_fwd(tr.backbone, db["image0"][:1]).dtype == torch.bfloat16


def _keyframe_batch(batch, scene="/data/val/s00000", first=0):
    """The Map-free val layout: every pair shares its scene's keyframe."""
    b = dict(batch)
    b["image0"] = np.repeat(batch["image0"][:1], B, axis=0)
    b["scene_root"] = [scene] * B
    b["pair_names"] = [("seq0/frame_00000.jpg", f"seq1/frame_{first + i:05d}.jpg") for i in range(B)]
    return b


def test_val_cached_matches_plain(setup):
    """As ``tests/test_training.py::test_val_cached_matches_plain``, bitwise:
    the shared keyframe is extracted once, then served from the memory
    cache; the plain step re-extracts both sides. BN stats do not move."""
    cfg_t, _, params, batch = setup
    b = _keyframe_batch(batch)
    tr = MicKeyTrainer(cfg_t, params=params, device="cpu", out_dir="unused")
    assert tr._cached_val
    stats = [t.clone() for p, t in tree_leaves(tr.state.params) if p[-1] in ("mean", "var")]
    tr.generator.manual_seed(7)
    cached = tr.validation_step(b)
    assert list(tr._val_kf_cache) == ["/data/val/s00000/seq0/frame_00000.jpg"]
    tr.generator.manual_seed(7)
    cached2 = tr.validation_step(b)  # the memory-cache hit
    tr._cached_val = False
    tr.generator.manual_seed(7)
    plain = tr.validation_step(b)
    assert plain["R_err"].shape == (B,)
    for k in plain:
        np.testing.assert_array_equal(cached[k], plain[k], err_msg=k)
        np.testing.assert_array_equal(cached2[k], plain[k], err_msg=k)
    after = [t for p, t in tree_leaves(tr.state.params) if p[-1] in ("mean", "var")]
    assert all(torch.equal(a, b) for a, b in zip(stats, after))


class _DiskRows:
    """A feature cache holding given rows, counting its gathers."""

    def __init__(self, rows):
        self.rows, self.gathered = rows, []

    def __contains__(self, key):
        return key in self.rows

    def gather(self, keys):
        self.gathered.append(list(keys))
        return torch.stack([self.rows[k] for k in keys])


def test_val_cache_eviction_and_disk_rows(setup, monkeypatch):
    """Past its bound the keyframe cache keeps only the batch in flight's
    keys; the query side comes from the feature cache only when it holds all
    of the batch's queries; rows of any source give the plain step's metrics."""
    cfg_t, _, params, batch = setup
    monkeypatch.setattr(training_model, "VAL_KEYFRAME_BOUND", 1)
    tr = MicKeyTrainer(cfg_t, params=params, device="cpu", out_dir="unused")
    b0, b1 = _keyframe_batch(batch, "/s0"), _keyframe_batch(batch, "/s1")
    tr.validation_step(b0)
    tr.validation_step(b1)
    assert list(tr._val_kf_cache) == ["/s1/seq0/frame_00000.jpg"]

    tr._cached_val = False
    tr.generator.manual_seed(3)
    plain = tr.validation_step(b0)
    q = tr.val_step.backbone_fwd(tr.backbone, tr.images(b0["image1"]))
    rows = {f"/s0/{p[1]}": q[i] for i, p in enumerate(b0["pair_names"])}
    tr.feature_cache = _DiskRows(dict(rows))
    tr._cached_val, tr._val_kf_cache = True, {}
    tr.generator.manual_seed(3)
    from_disk = tr.validation_step(b0)
    assert tr.feature_cache.gathered == [[f"/s0/{p[1]}" for p in b0["pair_names"]]]
    for k in plain:
        np.testing.assert_array_equal(from_disk[k], plain[k], err_msg=k)
    del rows["/s0/seq1/frame_00003.jpg"]  # one query missing: all of them run the backbone
    tr.feature_cache = _DiskRows(rows)
    tr.generator.manual_seed(3)
    partial = tr.validation_step(b0)
    assert tr.feature_cache.gathered == []
    for k in plain:
        np.testing.assert_array_equal(partial[k], plain[k], err_msg=k)


def test_aggregate_validation_is_bitwise_jax(setup):
    """The epoch's precision and AUC aggregation on the same outputs, with a
    tie among the confidences."""
    rng = np.random.default_rng(2)
    outputs = []
    for _ in range(3):
        o = {k: rng.uniform(0, 1, B).astype(np.float32) for k in ("t_err_ang", "t_err_euc", "inliers")}
        o["R_err"] = rng.uniform(0, 15, B).astype(np.float32)
        o["vcre"] = rng.uniform(20, 150, B).astype(np.float32)
        o.update({k: np.float32(rng.uniform()) for k in ("loss", "avg_loss_rot", "avg_loss_trans")})
        outputs.append(o)
    outputs[1]["inliers"][2] = outputs[0]["inliers"][1]
    cfg_t, _, params, _ = setup
    ours = MicKeyTrainer(cfg_t, params=params, device="cpu", out_dir="unused").aggregate_validation(outputs)
    ref = JaxTrainer.aggregate_validation(None, outputs)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k] == ref[k] and type(ours[k]) is float, k
