"""Geometry, sampling and the Procrustes RANSAC solver: the port against
mickey_tpu on the CPU.

fp32 throughout. Kabsch: R and t at 1e-5 and the rank-validity bits
exactly, including degenerate (rank-1, coincident) point sets, since both
use the same closed-form Jacobi SVD. The solver: the JAX PRNG stream cannot
be reproduced in torch, so the draws JAX makes from its key are replayed
with its own samplers and injected; R, t and confidence then agree at 1e-4.
The port's own sampler is checked by distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.geometry import backproject_3d as j_backproject
from mickey_tpu.geometry import inlier_counting_3d as j_inliers
from mickey_tpu.geometry import soft_inlier_counting_3d as j_soft
from mickey_tpu.geometry import weighted_procrustes as j_procrustes
from mickey_tpu.ops.sampling import gumbel_topk_sample as j_sample
from mickey_tpu.ops.sampling import gumbel_topk_sample_draws as j_sample_draws
from mickey_tpu.solver.procrustes_ransac import _log_weights as j_log_weights
from mickey_tpu.solver.procrustes_ransac import estimate_pose_topk as j_estimate_pose_topk
from mickey_tpu_torch.geometry import backproject_3d, inlier_counting_3d, soft_inlier_counting_3d, weighted_procrustes
from mickey_tpu_torch.ops.sampling import gumbel_topk_sample
from mickey_tpu_torch.solver import Draws, estimate_pose_topk

T = torch.from_numpy


def _point_sets(rng, n=5):
    A = rng.uniform(-1, 1, (4, n, 3)).astype(np.float32)
    B = A @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T.astype(np.float32) + 0.3
    A[1] = A[1, :1] + np.linspace(0, 1, n, dtype=np.float32)[:, None] * np.float32([1, 2, 3])  # collinear
    A[2] = 0.5  # coincident
    B[3, :, 2] = 0.0  # planar target
    return A, B.astype(np.float32)


@pytest.mark.parametrize("n", [3, 40])
def test_weighted_procrustes_matches_jax(n):
    rng = np.random.default_rng(n)
    A, B = _point_sets(rng, n)
    w = (rng.uniform(0, 1, (4, n)) > 0.3).astype(np.float32)
    for kw in (dict(use_weights=False), dict(w=w, use_weights=True, use_mask=True), dict(w=w, use_weights=True)):
        ref = j_procrustes(jnp.asarray(A), jnp.asarray(B), **{k: jnp.asarray(v) if k == "w" else v for k, v in kw.items()})
        out = weighted_procrustes(T(A), T(B), **{k: T(v) if k == "w" else v for k, v in kw.items()})
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
        ok = np.asarray(ref.valid)
        np.testing.assert_allclose(out.R.numpy()[ok], np.asarray(ref.R)[ok], atol=1e-5)
        np.testing.assert_allclose(out.t.numpy()[ok], np.asarray(ref.t)[ok], atol=1e-5)
    assert not np.asarray(ref.valid)[1:3].any()  # rank-1 and coincident sets are rejected


def test_projection_and_inliers_match_jax():
    rng = np.random.default_rng(1)
    uv = rng.uniform(0, 500, (2, 30, 2)).astype(np.float32)
    d = rng.uniform(1, 10, (2, 30, 1)).astype(np.float32)
    K = np.tile(np.float32([[[500, 0, 250], [0, 480, 260], [0, 0, 1]]]), (2, 1, 1))
    X = np.asarray(j_backproject(jnp.asarray(uv), jnp.asarray(d), jnp.asarray(K)))
    np.testing.assert_allclose(backproject_3d(T(uv), T(d), T(K)).numpy(), X, rtol=1e-6)
    Y = (X + rng.normal(0, 0.2, X.shape)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    t = rng.normal(0, 0.05, (2, 1, 3)).astype(np.float32)
    args_j, args_t = [jnp.asarray(a) for a in (X, Y, R, t)], [T(a) for a in (X, Y, R, t)]
    np.testing.assert_allclose(soft_inlier_counting_3d(*args_t, th=0.3).numpy(), np.asarray(j_soft(*args_j, th=0.3)), rtol=1e-5)
    np.testing.assert_array_equal(inlier_counting_3d(*args_t, th=0.15).numpy(), np.asarray(j_inliers(*args_j, th=0.15)))


@pytest.mark.parametrize("k,n", [(3, 50), (20, 50), (5, 100)])
def test_gumbel_topk_sample_draws_without_replacement(k, n):
    g = torch.Generator().manual_seed(0)
    logw = torch.where(torch.arange(n) % 5 == 0, -1e30, 0.0).expand(64, n)  # a fifth has no mass
    idx = gumbel_topk_sample(g, logw, k)
    assert idx.shape == (64, k) and idx.dtype == torch.int32
    assert all(len(set(row.tolist())) == k for row in idx)
    assert not (idx % 5 == 0).any()


def test_gumbel_topk_sample_distribution():
    """First draw frequencies follow the weights (4-sigma binomial bound)."""
    p = np.array([0.5, 0.25, 0.15, 0.1])
    g = torch.Generator().manual_seed(1)
    n = 20000
    idx = gumbel_topk_sample(g, torch.log(torch.tensor(p, dtype=torch.float32)).expand(n, 4), 1)
    freq = np.bincount(idx[:, 0].numpy(), minlength=4) / n
    assert np.all(np.abs(freq - p) < 4 * np.sqrt(p * (1 - p) / n)), freq


def _scene(seed, b=2, n=60, P=300):
    rng = np.random.default_rng(seed)
    K = np.tile(np.float32([[[300, 0, 160], [0, 300, 120], [0, 0, 1]]]), (b, 1, 1))
    kps0 = rng.uniform(0, 320, (b, n, 2)).astype(np.float32)
    depth0 = rng.uniform(2, 6, (b, n, 1)).astype(np.float32)
    X = np.asarray(j_backproject(jnp.asarray(kps0), jnp.asarray(depth0), jnp.asarray(K)))
    ang = 0.1
    R = np.float32([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    Y = X @ R.T + np.float32([0.3, 0.0, 0.1]) + rng.normal(0, 0.02, X.shape).astype(np.float32)
    kps1 = (Y @ K[0].T)[..., :2] / Y[..., 2:]
    depth1 = Y[..., 2:]
    # sampling table: true matches i <-> i strong, the rest weak, descending
    scores = rng.uniform(0, 1e-3, (b, n * n)).astype(np.float32)
    scores[:, np.arange(n) * n + np.arange(n)] += rng.uniform(0.5, 1, (b, n)).astype(np.float32)
    top_idx = np.argsort(-scores, axis=1)[:, :P].astype(np.int32)
    top_scores = np.take_along_axis(scores, top_idx, 1)
    top_scores[1, 100:] = 0.0  # zero tail: never sampled by the inner draws
    row_ok = np.array([True, True])
    return [top_scores, top_idx, row_ok, kps0, depth0, kps1.astype(np.float32), depth1.astype(np.float32), K, K]


def _replay(key, top_scores, it, S, R, C) -> Draws:
    w = jnp.asarray(top_scores)
    k_outer, k_inner = jax.random.split(key)
    inner = jax.random.split(k_inner, it)
    outer = j_sample_draws(k_outer, j_log_weights(w), S, it)
    ridx = [j_sample(inner[s], jnp.broadcast_to(j_log_weights(jnp.take_along_axis(w, outer[s], 1))[:, None],
                                                (w.shape[0], R, S)), C) for s in range(it)]
    return Draws(T(np.array(outer)), T(np.array(jnp.stack(ridx))))


@pytest.mark.parametrize("poison", [False, True])
def test_solver_matches_jax_with_injected_draws(poison):
    args = _scene(5)
    if poison:
        args[2] = np.array([False, True])  # invalid sampling distribution -> zero pose
    kw = dict(n1=60, it_matches=5, it_ransac=32, num_samples=128, num_corr=3, num_refinements=4,
              th_inlier=0.15, th_soft_inlier=0.3)
    key = jax.random.PRNGKey(3)
    ref = j_estimate_pose_topk(key, *(jnp.asarray(a) for a in args), **kw)
    draws = _replay(key, args[0], 5, 128, 32, 3)
    out = estimate_pose_topk(*(T(np.asarray(a)) for a in args), draws=draws, **kw)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(out.confidence.numpy(), np.asarray(ref.confidence), rtol=1e-4, atol=1e-4)
    if poison:
        assert not out.valid[0] and float(out.R[0].abs().sum()) == 0.0
    else:  # the planted pose is found
        assert np.degrees(np.arccos((np.trace(out.R.numpy(), axis1=1, axis2=2) - 1) / 2)).round(0).tolist() == [6.0, 6.0]


def test_solver_draws_from_a_generator():
    args = [T(np.asarray(a)) for a in _scene(6)]
    kw = dict(n1=60, it_matches=4, it_ransac=16, num_samples=64)
    a = estimate_pose_topk(*args, generator=torch.Generator().manual_seed(0), **kw)
    b = estimate_pose_topk(*args, generator=torch.Generator().manual_seed(0), **kw)
    assert torch.equal(a.R, b.R) and a.valid.all()


def test_solver_scores_a_solve_in_one_launch(monkeypatch):
    """The scoring kernel takes all it_matches x B point sets of a solve in
    one call (its launch count rises by one a solve), and the pose, scores
    and every output are bitwise those of scoring draw by draw."""
    from mickey_tpu_torch.ops.hypothesis_scoring import hypothesis_scores
    from mickey_tpu_torch.solver import procrustes_ransac as pr

    args = [T(np.asarray(a)) for a in _scene(7)]
    kw = dict(n1=60, it_matches=5, it_ransac=32, num_samples=128)
    draws = pr.draw_samples(torch.Generator().manual_seed(0), args[0], 5, 32, 128, 3)
    calls = []

    def counted(X, Y, R, t, th):
        calls.append(X.shape[0])
        return hypothesis_scores(X, Y, R, t, th)

    monkeypatch.setattr(pr, "hypothesis_scores", counted)
    one = estimate_pose_topk(*args, draws=draws, **kw)
    assert calls == [5 * 2]  # one call for the 5 draws x 2 pairs

    def a_draw(X, Y, R, t, th, b=2):
        return torch.cat([hypothesis_scores(X[d:d + b], Y[d:d + b], R[d:d + b], t[d:d + b], th)
                          for d in range(0, X.shape[0], b)])

    monkeypatch.setattr(pr, "hypothesis_scores", a_draw)
    per_draw = estimate_pose_topk(*args, draws=draws, **kw)
    for name, x, y in zip(one._fields, one, per_draw):
        assert torch.equal(x, y), name
