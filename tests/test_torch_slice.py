"""The pose-serving slice end to end against mickey_tpu on the CPU.

Weights are made in JAX (``model_init``) and bridged with
``params_to_torch``; inputs come from numpy with a fixed seed. The size is
cut to a ViT-S backbone of 2 blocks, narrow heads and a 12x14 patch grid
(168 keypoints), and the solver to 4 x 16 hypotheses over 64 samples. On the
CPU every kernel wrapper takes its plain version, and the JAX package takes
its own plain references (the CPU route of ``backbone_features`` and
``topk_correspondences_from_heads``).

Tolerances: fp32 throughout unless stated; the two frameworks sum in
different orders, so agreement is to a few fp32 ulps scaled by the depth of
the computation (1e-5 relative per stage, 1e-4 on poses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.config import default_config
from mickey_tpu.models.relative_pose import MickeyRelativePose as JaxPose
from mickey_tpu.nn import extractor as jext
from mickey_tpu.nn.extractor import model_init
from mickey_tpu.ops.sampling import gumbel_topk_sample, gumbel_topk_sample_draws
from mickey_tpu.solver.procrustes_ransac import _log_weights
from mickey_tpu_torch.models import build_model
from mickey_tpu_torch.solver import Draws

B, H, W = 2, 168, 196  # 12 x 14 patches; 6 x 8 of them inside the score head's 3-cell border


def small_cfg(bf16=False):
    cfg = default_config()
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.DINOV2.FLOAT16 = bf16
    cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 16, 8]
    cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
    cfg.PROCRUSTES.IT_MATCHES = 4
    cfg.PROCRUSTES.IT_RANSAC = 16
    cfg.PROCRUSTES.NUM_SAMPLED_MATCHES = 64
    cfg.TPU.SAMPLING_PREFILTER = 256
    return cfg


@pytest.fixture(scope="module")
def jax_params():
    p = model_init(jax.random.PRNGKey(0), small_cfg())
    p["dinov2"]["blocks"] = jax.tree.map(lambda a: a[:2], p["dinov2"]["blocks"])
    return p


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    im0, im1 = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    K = np.tile(np.array([[[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    return im0, im1, K, K.copy()


def _jax_table(jax_params, cfg, im0, im1):
    return jax.jit(lambda p, a, b: _jax_table_body(p, cfg, a, b))(jax_params, im0, im1)


def _jax_table_body(jax_params, cfg, im0, im1):
    stacked = jnp.concatenate([jnp.asarray(im0), jnp.asarray(im1)])
    fmap = jext.backbone_features(jax_params, stacked, cfg)
    (kpts, depths, scores, descs), _ = jext.heads_apply(jax_params, fmap, cfg, train=False)
    kpts = jext.absolute_kpt_coordinates(kpts, cfg.MICKEY.DINOV2.DOWN_FACTOR)
    return jext.topk_correspondences_from_heads(jax_params, kpts, depths, scores, descs, cfg)


def _replay_jax_draws(key, top_scores, cfg) -> Draws:
    """The draws ``_solve_sampled`` makes from ``key`` (its key schedule at
    procrustes_ransac.py:253-264 and :287-288), made with JAX's own public
    samplers, as index tensors for the port's solver."""
    pc = cfg.PROCRUSTES
    it, S, R, C = pc.IT_MATCHES, pc.NUM_SAMPLED_MATCHES, pc.IT_RANSAC, pc.NUM_CORR_3D_3D
    w_table = top_scores.astype(jnp.float32)
    k_outer, k_inner_base = jax.random.split(key)
    inner_keys = jax.random.split(k_inner_base, it)
    outer = gumbel_topk_sample_draws(k_outer, _log_weights(w_table), S, it)
    ridx = []
    for s in range(it):
        w = jnp.take_along_axis(w_table, outer[s], axis=1)
        logw_in = jnp.broadcast_to(_log_weights(w)[:, None, :], (w.shape[0], R, S))
        ridx.append(gumbel_topk_sample(inner_keys[s], logw_in, C))
    return Draws(torch.from_numpy(np.array(outer)), torch.from_numpy(np.array(jnp.stack(ridx))))


def _remap(draws: Draws, jax_idx, our_idx, missing_ok=False) -> Draws:
    """Carry draws over by match, not by table position: near-tied scores
    may sit in another order in the port's table. Each drawn JAX position
    is replaced by the position of the same flat match index in ours (or,
    with ``missing_ok``, kept where our table lacks that match)."""
    jax_idx, our_idx = np.asarray(jax_idx), our_idx.numpy()
    outer = draws.outer_local.numpy()
    out = np.empty_like(outer)
    for b in range(outer.shape[1]):
        where = {int(m): p for p, m in enumerate(our_idx[b])}
        out[:, b] = [[where[int(m)] if (int(m) in where or not missing_ok) else p for m, p in zip(jax_idx[b][row], row)]
                     for row in outer[:, b]]
    return Draws(torch.from_numpy(out), draws.ridx)


def test_slice_fp32_matches_jax_with_injected_draws(jax_params):
    """Both serving layouts end to end: the top-P table exactly (indices) and
    to 1e-5 (values), then R, t and confidence to 1e-4 given JAX's draws."""
    cfg = small_cfg()
    im0, im1, K0, K1 = _inputs()
    key = jax.random.PRNGKey(7)
    tcorr = _jax_table(jax_params, cfg, im0, im1)
    draws = _replay_jax_draws(key, tcorr.top_scores, cfg)

    jmodel = JaxPose(cfg, params=jax_params)
    model = build_model(cfg, _np_tree(jax_params), device="cpu")
    t = torch.from_numpy
    feats = model.extract_feats(torch.cat([t(im0), t(im1)]))
    ours = model.match_feats(tuple(f[:B] for f in feats), tuple(f[B:] for f in feats))
    for b in range(B):  # the same matches, positions may differ only among near-ties
        assert set(ours.top_idx[b].tolist()) == set(np.asarray(tcorr.top_idx[b]).tolist())
    np.testing.assert_allclose(ours.top_scores.numpy(), np.asarray(tcorr.top_scores), rtol=1e-5)
    np.testing.assert_array_equal(ours.row_ok.numpy(), np.asarray(tcorr.row_ok))
    draws = _remap(draws, tcorr.top_idx, ours.top_idx)

    ref_feats_j = jmodel.extract_feats(jnp.asarray(im0))
    ref_feats = model.extract_feats(t(im0))
    for ref, out in (
        (jmodel(jnp.asarray(im0), jnp.asarray(im1), K0, K1, key=key, lite=True),
         model(t(im0), t(im1), t(K0), t(K1), draws=draws, lite=True)),
        (jmodel.call_with_ref_feats(ref_feats_j, jnp.asarray(im1), K0, K1, key=key),
         model.call_with_ref_feats(ref_feats, t(im1), t(K0), t(K1), draws=draws)),
    ):
        assert np.asarray(ref.valid).all()
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-4)
        np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-4)
        np.testing.assert_allclose(out.inliers.numpy(), np.asarray(ref.inliers), rtol=1e-4)


def test_slice_bf16_against_jax(jax_params):
    """bf16 backbone, both sides: bf16 rounds at other places in the two
    frameworks, so the top-P tables agree as sets to 95% and in value to
    5e-2 (relative), and the draws carry over by match where the match is
    in both tables. Random weights on random images give RANSAC no true
    consensus, so a few changed samples can move the best rotation by
    degrees; the gate is on validity, translation (5 cm) and confidence
    (15%), not on the rotation."""
    cfg = small_cfg(bf16=True)
    im0, im1, K0, K1 = _inputs()
    key = jax.random.PRNGKey(7)
    tcorr = _jax_table(jax_params, cfg, im0, im1)
    draws = _replay_jax_draws(key, tcorr.top_scores, cfg)
    ref = JaxPose(cfg, params=jax_params)(jnp.asarray(im0), jnp.asarray(im1), K0, K1, key=key, lite=True)
    model = build_model(cfg, _np_tree(jax_params), device="cpu")
    t = torch.from_numpy
    feats = model.extract_feats(torch.cat([t(im0), t(im1)]))
    ours = model.match_feats(tuple(f[:B] for f in feats), tuple(f[B:] for f in feats))
    P = cfg.TPU.SAMPLING_PREFILTER
    for b in range(B):
        assert len(set(ours.top_idx[b].tolist()) & set(np.asarray(tcorr.top_idx[b]).tolist())) >= 0.95 * P
    np.testing.assert_allclose(ours.top_scores.numpy(), np.asarray(tcorr.top_scores), rtol=5e-2)
    out = model(t(im0), t(im1), t(K0), t(K1), draws=_remap(draws, tcorr.top_idx, ours.top_idx, True), lite=True)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert np.abs(out.t.numpy() - np.asarray(ref.t)).max() < 0.05
    np.testing.assert_allclose(out.inliers.numpy(), np.asarray(ref.inliers), rtol=0.15)
