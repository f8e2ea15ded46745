"""The bf16-descriptor matcher (``TPU.MATCHER_BF16``) against mickey_tpu on
the CPU.

Under the knob both packages round the descriptors to bf16 (to nearest
even) and multiply them in one pass with fp32 sums: the JAX kernels
(``_corr_block``'s bf16 branch, run here in interpret mode, never its CPU
fallback, whose XLA einsum of two bf16 arrays returns a bf16 correlation),
the port's bf16 kernels on the card and their plain versions here, which
upcast before an fp32 product. Every product of two bf16 values is exact in
fp32, so only the order of the sums differs.

Tolerances: values, lse_row and lse_col at 1e-5 relative (plus 1e-6 of the
largest, as the fp32 route's tests); indices exactly where the values are
apart (or tie exactly); NaN where JAX has it. The slice at
``test_torch_slice``'s size with JAX's draws injected: the matcher stage on
JAX's head outputs (the table, the dense match scores) at 1e-5, R and t of
the port's whole calls at 1e-4. The whole calls' own tables are held as
sets only: the two packages' head outputs differ in their last fp32 bits,
and a descriptor value on a rounding boundary rounds to a neighbouring bf16
value in one of them (a step of 2^-8), which moves its scores by up to
~1e-3 relative. The planted-scene gate (``tests/test_fused_matcher.py``'s
``test_bf16_descriptor_gate``, ported): the same argmax structure, both
routes recover the pose, confidences within 5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.nn import extractor as jext
from mickey_tpu.nn import matcher as jmatcher
from mickey_tpu.ops import fused_matcher as jfm
from mickey_tpu.solver import procrustes_ransac as jsolver
from mickey_tpu_torch import default_config
from mickey_tpu_torch.models import build_model
from mickey_tpu_torch.nn import extractor, matcher
from mickey_tpu_torch.ops import fused_matcher as fm
from mickey_tpu_torch.solver import estimate_pose
from test_torch_exact_path import _jax_table as _dense_jax_table
from test_torch_exact_path import jax_params  # noqa: F401  (a module fixture)
from test_torch_fused_matcher import _jax_forward, _ratio, _rounds_exact_where_apart, _topk_inputs
from test_torch_slice import B, _inputs, _np_tree, _remap, _replay_jax_draws, small_cfg

T = torch.from_numpy


def _bf16(*arrays):
    """numpy fp32 arrays -> (JAX bf16 arrays, torch bf16 tensors), each
    rounded to nearest even by its own package."""
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays], [T(a).to(torch.bfloat16) for a in arrays]


def _finite_ratio(out, ref, rtol=1e-5) -> float:
    """``_ratio`` over the finite entries, NaN where the reference has it."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    fin = np.isfinite(ref)
    return _ratio(out[fin], ref[fin], rtol) if fin.any() else 0.0


def test_rounding_is_jax_astype():
    """torch's and JAX's fp32 -> bf16 roundings agree bit for bit, ties,
    subnormals, infinities and NaN included."""
    x = np.concatenate([np.random.default_rng(0).standard_normal(10000).astype(np.float32),
                        np.float32([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 1e-40, -np.inf, np.inf, 0.0, -0.0])])
    (j,), (t,) = _bf16(x)
    np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)).view(np.int32), t.float().numpy().view(np.int32))
    assert bool(torch.isnan(T(np.float32([np.nan])).to(torch.bfloat16)).all())


@pytest.mark.parametrize("case", ["plain", "ties", "nan", "nan_last"])
@pytest.mark.parametrize("shape", [(2, 100, 90, 32), (1, 129, 65, 128)])
def test_k2a_k2b_match_jax_interpret_on_bf16(shape, case):
    """K2a's lse_col and K2b's candidate table (values, rounds, the validity
    bit) on bf16 descriptors against the JAX kernels in interpret mode; K2b
    on JAX's lse_col, so each is held alone."""
    b, m, n, c = shape
    d0, d1, s0, s1 = _topk_inputs(shape, case, seed=60 + m)
    (j0, j1), (t0, t1) = _bf16(d0, d1)
    L = 16
    cv, ci, ok, _, lse_col = jfm._topk_candidates(j0, j1, jnp.asarray(s0), jnp.asarray(s1), jnp.float32(0.7),
                                                  0.1, True, L, 128, True)
    lse_col = np.asarray(lse_col)[:, 0, :n]
    assert _finite_ratio(fm.col_lse(t0, t1, 10.0, 0.7), lse_col) <= 1.0
    v, i, stats, _ = fm.pair_topk(t0, t1, T(s0), T(s1), T(lse_col), 10.0, 0.7, L)
    ref_v = np.asarray(cv).reshape(b, L, -1)[:, :, :m]
    assert _finite_ratio(v, ref_v) <= 1.0
    _rounds_exact_where_apart(i.numpy(), np.asarray(ci).reshape(b, L, -1)[:, :, :m], ref_v)
    row_ok = (stats[..., 1].sum(-1) == 0) & (stats[..., 2].amin(-1) >= 0) & (stats[..., 0].sum(-1) > 0)
    np.testing.assert_array_equal(row_ok.numpy(), np.asarray(ok))


@pytest.mark.parametrize("use_dustbin", [True, False])
@pytest.mark.parametrize("shape", [(2, 37, 45, 16), (1, 129, 65, 128)])
def test_k4_matches_jax_interpret_on_bf16(shape, use_dustbin):
    """K4 (P and lse_row, on JAX's lse_col) and the whole fused forward on
    bf16 descriptors against JAX's ``_forward_padded`` in interpret mode;
    P stays fp32."""
    b, m, n, c = shape
    d0, d1, _, _ = _topk_inputs(shape, "plain", seed=70 + m)
    (j0, j1), (t0, t1) = _bf16(d0, d1)
    lse_col, out, lse_row = _jax_forward(j0, j1, use_dustbin)
    alpha = fm._alpha(0.7, use_dustbin)
    p, lr = fm.pair_softmax(t0, t1, T(lse_col), 10.0, alpha)
    assert p.dtype == torch.float32
    assert _ratio(p, out, 1e-5) <= 1.0 and _ratio(lr, lse_row, 1e-5) <= 1.0
    whole = fm.fused_dual_softmax(t0, t1, 0.7, temperature=0.1, use_dustbin=use_dustbin)
    assert whole.dtype == torch.float32 and _ratio(whole, out, 1e-5) <= 1.0


def _head_maps(seed, b=2, h=8, w=10, c=16):
    """Stacked (2b) head outputs: absolute keypoints, depths, positive
    scores, unit descriptors."""
    rng = np.random.default_rng(seed)
    kpts = rng.uniform(0, 140, (2 * b, h, w, 2)).astype(np.float32)
    depths = rng.uniform(1, 5, (2 * b, h, w, 1)).astype(np.float32)
    scores = rng.uniform(0.1, 1, (2 * b, h, w, 1)).astype(np.float32)
    descs = rng.standard_normal((2 * b, h, w, c)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    return kpts, depths, scores, descs


def _cfgs(bf16=True):
    cfg = default_config()
    cfg.TPU.MATCHER_BF16 = bf16
    cfg.TPU.SAMPLING_PREFILTER = 64
    cfg_j = cfg.clone()
    cfg_j.TPU.PALLAS_INTERPRET = True
    return cfg, cfg_j


def test_topk_route_matches_jax_interpret_under_the_knob():
    """``topk_correspondences_from_heads`` under MATCHER_BF16 against JAX's
    with ``PALLAS_INTERPRET=True``: the same entries, values at 1e-5, row_ok
    equal; and the knob is read: the table is not the fp32 route's."""
    maps = _head_maps(1)
    cfg, cfg_j = _cfgs()
    ref = jext.topk_correspondences_from_heads({"matcher": {"dustbin_score": jnp.float32(1.0)}},
                                               *(jnp.asarray(a) for a in maps), cfg_j)
    params = {"matcher": {"dustbin_score": torch.tensor(1.0)}}
    ours = extractor.topk_correspondences_from_heads(params, *(T(a) for a in maps), cfg)
    assert _ratio(ours.top_scores, ref.top_scores, 1e-5) <= 1.0
    for b in range(2):
        assert set(ours.top_idx[b].tolist()) == set(np.asarray(ref.top_idx[b]).tolist())
    np.testing.assert_array_equal(ours.row_ok.numpy(), np.asarray(ref.row_ok))
    fp32 = extractor.topk_correspondences_from_heads(params, *(T(a) for a in maps), _cfgs(bf16=False)[0])
    assert not torch.equal(ours.top_scores, fp32.top_scores)


def test_dense_inference_matches_jax_interpret_under_the_knob():
    """``match_scores(train=False)`` under MATCHER_BF16 (the dense route's
    forward) against JAX's fused forward in interpret mode at 1e-5; it no
    longer refuses the knob; training ignores it, as in the JAX package."""
    d0, d1 = (np.ascontiguousarray(a.reshape(2, 80, 16)) for a in np.split(_head_maps(2)[3], 2))
    cfg, cfg_j = _cfgs()
    ref = jmatcher.match_scores({"dustbin_score": jnp.float32(1.0)}, jnp.asarray(d0), jnp.asarray(d1), cfg_j,
                                allow_fused=True)
    params = {"dustbin_score": torch.tensor(1.0)}
    out = matcher.match_scores(params, T(d0), T(d1), cfg, train=False)
    assert out.dtype == torch.float32 and _ratio(out, ref, 1e-5) <= 1.0
    fp32 = matcher.match_scores(params, T(d0), T(d1), _cfgs(bf16=False)[0], train=False)
    assert not torch.equal(out, fp32)
    assert torch.equal(matcher.match_scores(params, T(d0), T(d1), cfg, train=True), fp32)


def _jax_heads(jax_params, cfg, im0, im1):
    stacked = jnp.concatenate([jnp.asarray(im0), jnp.asarray(im1)])
    fmap = jext.backbone_features(jax_params, stacked, cfg)
    return fmap, jext.heads_apply(jax_params, fmap, cfg, train=False)[0]


def test_slice_matches_jax_under_the_knob(jax_params):  # noqa: F811
    """The slice at ``test_torch_slice``'s size under MATCHER_BF16, JAX's
    matcher stage in interpret mode and its draws injected (carried over by
    match): the port's matcher stage on JAX's head outputs (the top-P table,
    the dense match scores) at 1e-5; both serving layouts and the full
    output on the dense route (``lite=False``) end to end, R and t at 1e-4."""
    cfg = small_cfg()
    cfg.TPU.MATCHER_BF16 = True
    cfg_i = cfg.clone()
    cfg_i.TPU.PALLAS_INTERPRET = True
    im0, im1, K0, K1 = _inputs(3)
    key = jax.random.PRNGKey(5)
    fmap, (kpts, depths, scores, descs) = jax.jit(lambda p, a, b: _jax_heads(p, cfg, a, b))(jax_params, im0, im1)
    kpts = jext.absolute_kpt_coordinates(kpts, cfg.MICKEY.DINOV2.DOWN_FACTOR)
    tcorr = jext.topk_correspondences_from_heads(jax_params, kpts, depths, scores, descs, cfg_i)
    model = build_model(cfg, _np_tree(jax_params), device="cpu")
    heads = [T(np.asarray(a)) for a in (kpts, depths, scores, descs)]
    stage = extractor.topk_correspondences_from_heads(model.params, *heads, cfg)
    assert _ratio(stage.top_scores, tcorr.top_scores, 1e-5) <= 1.0
    feats = model.extract_feats(torch.cat([T(im0), T(im1)]))
    ours = model.match_feats(tuple(f[:B] for f in feats), tuple(f[B:] for f in feats))
    for b in range(B):
        assert set(stage.top_idx[b].tolist()) == set(np.asarray(tcorr.top_idx[b]).tolist())
        assert set(ours.top_idx[b].tolist()) == set(np.asarray(tcorr.top_idx[b]).tolist())
    np.testing.assert_array_equal(ours.row_ok.numpy(), np.asarray(tcorr.row_ok))
    draws = _remap(_replay_jax_draws(key, tcorr.top_scores, cfg), tcorr.top_idx, ours.top_idx)
    ref = jsolver.estimate_pose_topk_from_cfg(key, tcorr, jnp.asarray(K0), jnp.asarray(K1), cfg)
    assert np.asarray(ref.valid).all()
    for out in (model(T(im0), T(im1), T(K0), T(K1), draws=draws, lite=True),
                model.call_with_ref_feats(model.extract_feats(T(im0)), T(im1), T(K0), T(K1), draws=draws)):
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-4)
        np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-4)
        np.testing.assert_allclose(out.inliers.numpy(), np.asarray(ref.confidence), rtol=1e-4)

    # the full output: the dense route's bf16 forward (K2a + K4)
    jcorr, _ = jext.compute_correspondences(jax_params, None, None, cfg_i, fmap=fmap)
    dref = jsolver.estimate_pose_from_cfg(key, jcorr, jnp.asarray(K0), jnp.asarray(K1), cfg)
    dense = matcher.match_scores(model.params["matcher"], T(np.asarray(jcorr.dsc0)), T(np.asarray(jcorr.dsc1)), cfg)
    assert _ratio(dense, jcorr.scores, 1e-5) <= 1.0
    probe = model(T(im0), T(im1), T(K0), T(K1))
    P = cfg.TPU.SAMPLING_PREFILTER
    jtab, jidx = _dense_jax_table(np.asarray(jcorr.final_scores), P)
    our_idx = torch.topk(probe.corr.final_scores.reshape(B, -1), P, dim=-1).indices
    full = model(T(im0), T(im1), T(K0), T(K1), draws=_remap(_replay_jax_draws(key, jtab, cfg), jidx, our_idx))
    assert np.asarray(dref.valid).all()
    np.testing.assert_array_equal(full.valid.numpy(), np.asarray(dref.valid))
    np.testing.assert_allclose(full.R.numpy(), np.asarray(dref.R), atol=1e-4)
    np.testing.assert_allclose(full.t.numpy(), np.asarray(dref.t), atol=1e-4)


def test_bf16_descriptor_gate():
    """``tests/test_fused_matcher.py::test_bf16_descriptor_gate`` on the
    port: on a planted scene (dsc1 a noisy copy of dsc0) the fp32 and bf16
    fused forwards have the same row and column argmaxes, both recover the
    pose (rotation within 1.5 degrees, translation within 5 cm) and their
    confidences agree within 5%."""
    from test_ransac import SOLVER_KW, make_scene

    rng = np.random.default_rng(0)
    Bn, N, C = 2, 128, 128
    inputs, (R_gt, t_gt) = make_scene(rng, B=Bn, N=N, outlier_frac=0.25)
    d0 = rng.normal(size=(Bn, N, C)).astype(np.float32)
    d1 = (d0 + 0.35 * rng.normal(size=(Bn, N, C))).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    s32 = fm.fused_dual_softmax(T(d0), T(d1), 1.0, temperature=0.1)
    s16 = fm.fused_dual_softmax(T(d0).to(torch.bfloat16), T(d1).to(torch.bfloat16), 1.0, temperature=0.1)
    assert torch.equal(s16.argmax(2), s32.argmax(2)) and torch.equal(s16.argmax(1), s32.argmax(1))
    geom = {k: T(np.asarray(v)) for k, v in inputs.items() if k != "final_scores"}
    conf = []
    for s in (s32, s16):
        est = estimate_pose(s, **geom, generator=torch.Generator().manual_seed(0), **SOLVER_KW)
        assert bool(est.valid.all())
        for b in range(Bn):
            cosang = (np.trace(est.R[b].numpy().T @ R_gt[b]) - 1) / 2
            assert np.degrees(np.arccos(np.clip(cosang, -1, 1))) < 1.5
            assert np.linalg.norm(est.t[b].numpy() - t_gt[b]) < 0.05
        conf.append(est.confidence.numpy())
    np.testing.assert_allclose(conf[1], conf[0], rtol=0.05)
