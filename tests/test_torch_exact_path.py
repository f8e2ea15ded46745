"""The exact inference path (``MICKEY.DINOV2.FLOAT16=False``, ``lite=False``)
against mickey_tpu on the CPU.

Weights are made in ``model_init``'s layout from numpy
(``init_params_numpy``), handed to JAX as they are and to the port through
``params_to_torch``; inputs come from numpy with a fixed seed, at the small
size of ``test_torch_slice`` (ViT-S of 2 blocks, narrow heads, a 12x14 patch
grid, 4 x 16 hypotheses over 64 samples, a top-256 prefilter). On the CPU
every kernel wrapper takes its plain version; the JAX backbone runs its
Pallas attention kernel in interpret mode where a test says so, and its CPU
reference otherwise.

The JAX PRNG stream cannot be reproduced in torch, so the draws JAX makes
from its key are replayed with its own samplers and injected, carried over by
match index (the two tables may order near-ties differently). The JAX dense
route takes ``approx_max_k`` for its prefilter where the port takes an exact
``torch.topk``; on the CPU both return the exact top entries.

Tolerances: fp32 throughout; the two frameworks sum in different orders, so
agreement is to a few fp32 ulps scaled by the depth of the computation:
1e-4 on O(1) backbone features, 1e-5 relative on match scores, 1e-4 on poses;
indices and gathered correspondences exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.models.relative_pose import MickeyRelativePose as JaxPose
from mickey_tpu.nn import dinov2 as jdinov2
from mickey_tpu.nn import matcher as jmatcher
from mickey_tpu.solver import procrustes_ransac as jsolver
from mickey_tpu_torch.models import MickeyRelativePose, build_model
from mickey_tpu_torch.nn import extractor, matcher
from mickey_tpu_torch.solver import estimate_pose, extract_inliers
from mickey_tpu_torch.weights import init_params_numpy, params_to_torch
from test_torch_slice import B, _inputs, _np_tree, _remap, _replay_jax_draws, small_cfg

T = torch.from_numpy
FIELDS = ("R", "t", "confidence", "valid", "cor0", "cor1", "d0", "d1", "weights", "inlier_mask")


@pytest.fixture(scope="module")
def jax_params():
    """``model_init``'s layout (``test_torch_model`` holds the two equal),
    from numpy: quicker than JAX's own init here."""
    p = init_params_numpy(small_cfg(), 0)
    p["dinov2"]["blocks"] = jax.tree.map(lambda a: a[:2], p["dinov2"]["blocks"])
    return p


def test_fp32_backbone_matches_jax_kernel(jax_params):
    """The fp32 backbone (packed attention) against the JAX backbone with its
    Pallas kernel in interpret mode on fp32 (sequence padded to 512 there)."""
    cfg = small_cfg()
    im0 = _inputs(4)[0]
    ref = np.asarray(jdinov2.vit_features_chw(jax_params["dinov2"], jnp.asarray(im0), cfg_dtype="float32",
                                              use_pallas=True, num_heads=6, interpret=True))
    out = extractor.backbone_features(params_to_torch(_np_tree(jax_params), cfg), T(im0), cfg).numpy()
    assert out.shape == ref.shape == (B, 12, 14, 384)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)  # LayerNorm output, O(1)


def _descs(rng, b, n, c):
    d = rng.standard_normal((b, n, c)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_sinkhorn_matches_jax():
    cfg = small_cfg()
    cfg.FEATURE_MATCHER.TYPE = "Sinkhorn"
    rng = np.random.default_rng(5)
    d0, d1 = _descs(rng, 2, 30, 16), _descs(rng, 2, 25, 16)
    ref = np.asarray(jmatcher.match_scores({"dustbin_score": jnp.float32(0.7)}, jnp.asarray(d0), jnp.asarray(d1), cfg))
    out = matcher.match_scores({"dustbin_score": 0.7}, T(d0), T(d1), cfg).numpy()
    assert out.shape == (2, 30, 25)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7 * np.abs(ref).max())


def test_sinkhorn_init_matches_jax():
    """The Sinkhorn matcher's parameters: its dustbin at
    ``SINKHORN.DUSTBIN_SCORE_INIT``, as ``matcher_init`` gives it."""
    cfg = small_cfg()
    cfg.FEATURE_MATCHER.TYPE = "Sinkhorn"
    cfg.FEATURE_MATCHER.SINKHORN.DUSTBIN_SCORE_INIT = 0.25
    ours = init_params_numpy(cfg, 0)["matcher"]
    ref = jmatcher.matcher_init(cfg)
    assert set(ours) == set(ref) == {"dustbin_score"}
    assert np.asarray(ours["dustbin_score"]) == np.asarray(ref["dustbin_score"]) == np.float32(0.25)


def test_mutual_matches_match_jax():
    """Host and device mutual-NN lists, indices exactly; the device list
    padded where fewer than k mutual matches exist."""
    rng = np.random.default_rng(6)
    s = rng.uniform(0, 1, (41, 37)).astype(np.float32)
    s[np.arange(20), rng.permutation(36)[:20]] += 2.0  # 20 clear mutual matches
    np.testing.assert_array_equal(matcher.get_matches_list(T(s)), jmatcher.get_matches_list(s))
    np.testing.assert_array_equal(matcher.get_matches_list(T(s), min_conf=8.0), jmatcher.get_matches_list(s, 8.0))
    for k in (10, 36):
        ours = matcher.mutual_matches_device(T(s), k)
        ref = jmatcher.mutual_matches_device(jnp.asarray(s), k)
        for a, b in zip(ours[:2], ref[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), rtol=1e-6)
    assert (ours[0].numpy() == -1).any()


def _dense_scene(seed, b=2, n=60):
    """Keypoints, depths and intrinsics of two views of one rigid scene, and
    dense (B, n, n) final scores: true matches i <-> i strong, the rest weak."""
    rng = np.random.default_rng(seed)
    K = np.tile(np.float32([[[300, 0, 160], [0, 300, 120], [0, 0, 1]]]), (b, 1, 1))
    kps0 = rng.uniform(0, 320, (b, n, 2)).astype(np.float32)
    depth0 = rng.uniform(2, 6, (b, n, 1)).astype(np.float32)
    X = np.concatenate([kps0, np.ones((b, n, 1), np.float32)], -1) @ np.linalg.inv(K[0]).T * depth0
    ang = 0.1
    R = np.float32([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    Y = X @ R.T + np.float32([0.3, 0.0, 0.1]) + rng.normal(0, 0.02, X.shape)
    kps1 = (Y @ K[0].T)[..., :2] / Y[..., 2:]
    scores = rng.uniform(0, 1e-3, (b, n, n)).astype(np.float32)
    scores[:, np.arange(n), np.arange(n)] += rng.uniform(0.5, 1, (b, n)).astype(np.float32)
    return [scores, kps0, depth0, kps1.astype(np.float32), Y[..., 2:].astype(np.float32), K, K]


def _jax_table(final_scores, prefilter):
    """The sampling table JAX's ``estimate_pose`` draws from: (scores, flat
    match indices)."""
    b = final_scores.shape[0]
    flat = jnp.asarray(final_scores).reshape(b, -1).astype(jnp.float32)
    if prefilter and prefilter < flat.shape[1]:
        return jax.lax.approx_max_k(flat, prefilter, recall_target=0.95)
    return flat, jnp.broadcast_to(jnp.arange(flat.shape[1], dtype=jnp.int32), flat.shape)


def _assert_estimates_close(out, ref, exact_gather=True):
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    for f in ("R", "t"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), atol=1e-4, err_msg=f)
    np.testing.assert_allclose(out.confidence.numpy(), np.asarray(ref.confidence), rtol=1e-4, atol=1e-4)
    if exact_gather:  # the best draw's correspondence set: the same gathers of the same inputs
        for f in ("cor0", "cor1", "d0", "d1", "weights", "inlier_mask"):
            np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("prefilter", [0, 512])
def test_dense_estimate_pose_matches_jax(prefilter):
    """All ten fields of the dense solver with JAX's draws injected: on the
    whole flat matrix (prefilter 0) and on a top-512 table."""
    args = _dense_scene(7)
    kw = dict(it_matches=5, it_ransac=32, num_samples=128, num_corr=3, num_refinements=4, th_inlier=0.15,
              th_soft_inlier=0.3)
    key = jax.random.PRNGKey(11)
    ref = jsolver.estimate_pose(key, *(jnp.asarray(a) for a in args), prefilter=prefilter, **kw)
    jtab, jidx = _jax_table(args[0], prefilter)
    pc = small_cfg().PROCRUSTES
    pc.IT_MATCHES, pc.NUM_SAMPLED_MATCHES, pc.IT_RANSAC = 5, 128, 32
    draws = _replay_jax_draws(key, jtab, type("C", (), {"PROCRUSTES": pc})())
    flat = T(args[0]).reshape(2, -1)
    ours_idx = torch.topk(flat, prefilter, dim=-1).indices if prefilter else torch.arange(flat.shape[1]).expand(2, -1)
    draws = _remap(draws, jidx, ours_idx)
    out = estimate_pose(*(T(a) for a in args), prefilter=prefilter, draws=draws, **kw)
    assert tuple(out._fields) == FIELDS
    assert out.valid.all() and out.inlier_mask.sum() > 100
    _assert_estimates_close(out, ref)
    np.testing.assert_allclose(extract_inliers(out, 1), jsolver.extract_inliers(ref, 1), rtol=1e-6)


def test_dense_estimate_pose_draws_from_a_generator():
    """Without injected draws: one draw at a time over the whole flat matrix
    when the batched noise would exceed the element budget, reproducible
    from the generator's seed."""
    args = [T(a) for a in _dense_scene(8)]
    kw = dict(it_matches=4, it_ransac=16, num_samples=64)
    a = estimate_pose(*args, generator=torch.Generator().manual_seed(0), **kw)
    b = estimate_pose(*args, generator=torch.Generator().manual_seed(0), **kw)
    assert torch.equal(a.R, b.R) and torch.equal(a.cor0, b.cor0) and a.valid.all()
    from mickey_tpu_torch.ops.sampling import gumbel_topk_sample_draws

    logw = torch.log(torch.rand(2, 500, generator=torch.Generator().manual_seed(1)))
    one_by_one = gumbel_topk_sample_draws(torch.Generator().manual_seed(2), logw, 20, 3, max_elems=100)
    assert one_by_one.shape == (3, 2, 20) and all(len(set(r.tolist())) == 20 for r in one_by_one.reshape(6, 20))


def test_full_model_matches_jax(jax_params):
    """``MickeyRelativePose(lite=False)`` with ``FLOAT16=False`` end to end
    against JAX's full output: the dense match matrices and maps, then every
    solver field given JAX's draws carried over by match index. Then the
    dense route's lite outputs (``TPU.FUSED_TOPK=False``), the general
    layout and ``call_with_ref_feats``, on the same draws against JAX's
    pose, which its lite output and shared-keyframe call repeat on the CPU."""
    cfg = small_cfg()
    im0, im1, K0, K1 = _inputs(9)
    key = jax.random.PRNGKey(13)
    ref = JaxPose(cfg, params=jax_params)(jnp.asarray(im0), jnp.asarray(im1), K0, K1, key=key)
    model = build_model(cfg, _np_tree(jax_params), device="cpu")
    probe = model(T(im0), T(im1), T(K0), T(K1))  # the port's own table, for the carry-over
    P = cfg.TPU.SAMPLING_PREFILTER
    jtab, jidx = _jax_table(np.asarray(ref.corr.final_scores), P)
    our_idx = torch.topk(probe.corr.final_scores.reshape(B, -1), P, dim=-1).indices
    draws = _remap(_replay_jax_draws(key, jtab, cfg), jidx, our_idx)

    out = model(T(im0), T(im1), T(K0), T(K1), draws=draws)
    for f in ("final_scores", "scores", "kp_scores"):
        a, b = getattr(out.corr, f).numpy(), np.asarray(getattr(ref.corr, f))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max(), err_msg=f)
    for f in ("kps0", "depth0", "scr1", "dsc1", "depth_map0"):
        b = np.asarray(getattr(ref.corr, f))
        np.testing.assert_allclose(getattr(out.corr, f).numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=f)
    assert np.asarray(ref.valid).all()
    _assert_estimates_close(out.estimate, ref.estimate, exact_gather=False)
    for f in ("cor0", "cor1", "d0", "d1", "weights"):  # gathers of inputs that agree to fp32 rounding
        b = np.asarray(getattr(ref.estimate, f))
        np.testing.assert_allclose(getattr(out.estimate, f).numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=f)
    np.testing.assert_array_equal(out.estimate.inlier_mask.numpy(), np.asarray(ref.estimate.inlier_mask))
    for a, b in ((out.R, ref.R), (out.t, ref.t), (out.inliers, ref.inliers)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)

    cfg_d = small_cfg()
    cfg_d.TPU.FUSED_TOPK = False
    dense = MickeyRelativePose(cfg_d, model.params, device="cpu")
    lite = dense(T(im0), T(im1), T(K0), T(K1), draws=draws, lite=True)
    shared = dense.call_with_ref_feats(dense.extract_feats(T(im0)), T(im1), T(K0), T(K1), draws=draws)
    for o in (lite, shared):
        assert o.estimate is None and o.corr is None
        np.testing.assert_array_equal(o.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_allclose(o.R.numpy(), np.asarray(ref.R), atol=1e-4)
        np.testing.assert_allclose(o.t.numpy(), np.asarray(ref.t), atol=1e-4)
        np.testing.assert_allclose(o.inliers.numpy(), np.asarray(ref.inliers), rtol=1e-4)
