"""The port's pose metrics against mickey_tpu on the CPU.

``pose_error`` and ``vcre`` run in torch against the JAX package's jnp
versions on the same seeded poses: fp32 in both, another order of the
same operations (einsum, norms, arccos), so they agree to 1e-5 relative
(1e-5 absolute near zero). The two angles (R_err, t_err_ang) are arccos of
a cosine that each side rounds to fp32 in its own order (XLA's CPU einsum
chains FMAs, torch's does not): near a zero angle arccos amplifies that
rounding without bound, so each angle is held at 1e-5 plus the arccos of a
cosine error of 4 fp32 ulps below 1 (``_arccos_slack``: 0.0078 degrees at
a 0.1 degree angle, 7.9e-5 at 10 degrees). The numpy metrics are the same code
on the same inputs: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.metrics import pose_metrics as jpm
from mickey_tpu_torch.metrics import pose_metrics as pm

B = 16


def _rot(rng, n, scale):
    """Rotations about random axes by angles up to ``scale`` radians."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(-scale, scale, n)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K = K - K.transpose(0, 2, 1)
    s, c = np.sin(ang)[:, None, None], np.cos(ang)[:, None, None]
    return (np.eye(3) + s * K + (1 - c) * K @ K).astype(np.float32)


def _poses(seed):
    """Ground truth, estimates near it (small and large errors, one
    estimate equal to the ground truth) and intrinsics."""
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = _rot(rng, B, 1.0)
    T[:, :3, 3] = rng.normal(size=(B, 3)) * 0.5
    R = (_rot(rng, B, 0.3) @ T[:, :3, :3]).astype(np.float32)
    t = (T[:, None, :3, 3] + rng.normal(size=(B, 1, 3)) * np.linspace(0.01, 2.0, B)[:, None, None]).astype(np.float32)
    R[0], t[0] = T[0, :3, :3], T[0, None, :3, 3]
    K = np.tile(np.array([[590.0, 0, 269.5], [0, 590.0, 359.5], [0, 0, 1]], np.float32), (B, 1, 1))
    return R, t, T, K


def _arccos_slack(deg: np.ndarray) -> np.ndarray:
    """Degrees that arccos turns a cosine error of 4 fp32 ulps below 1 into,
    at the angle ``deg``: eps / sin(theta), capped by sqrt(2 eps) near 0."""
    eps = 4 * 2.0**-24
    theta = np.radians(np.asarray(deg, np.float64))
    return np.degrees(np.minimum(eps / np.maximum(np.sin(theta), 1e-30), np.sqrt(2 * eps)))


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_error_and_vcre_match_jax(seed):
    R, t, T, K = _poses(seed)
    ref = jpm.pose_error(jnp.asarray(R), jnp.asarray(t), jnp.asarray(T))
    ours = pm.pose_error(*map(torch.from_numpy, (R, t, T)))
    assert list(ours) == list(ref)
    for k in ref:
        a, b = ours[k].numpy(), np.asarray(ref[k])
        slack = _arccos_slack(b) if k in ("R_err", "t_err_ang") else 0.0
        assert np.all(np.abs(a - b) <= 1e-5 + 1e-5 * np.abs(b) + slack), (k, a, b)
    for H, W in ((720, 540), (126, 112)):
        ref_v = jpm.vcre(jnp.asarray(R), jnp.asarray(t), jnp.asarray(T), jnp.asarray(K), H=H, W=W)
        ours_v = pm.vcre(*map(torch.from_numpy, (R, t, T, K)), H=H, W=W)
        assert ours_v.shape == (B,) and ours_v.dtype == torch.float32
        np.testing.assert_allclose(ours_v.numpy(), np.asarray(ref_v), rtol=1e-5, atol=1e-5)


def test_numpy_metrics_are_bitwise_jax(capsys):
    rng = np.random.default_rng(3)
    errs = rng.exponential(8.0, 200)
    errs[[3, 50]] = np.nan
    for thr in ((5, 10, 20), (0.1, 0.5, 1)):
        assert pm.error_auc(errs, thr) == jpm.error_auc(errs, thr)
    scale = rng.uniform(0.5, 2.5, 100)
    assert pm.a_metrics(scale) == jpm.a_metrics(scale)
    v, cd = pm.ecdf(errs[:50])
    jv, jcd = jpm.ecdf(errs[:50])
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(cd, jcd)

    acc, jacc = pm.MetricsAccumulator(), jpm.MetricsAccumulator()
    for i in range(3):
        batch = {"R_err": rng.uniform(0, 30, 8).astype(np.float32), "t_err_euc": rng.uniform(0, 2, (8, 1)),
                 "t_err_ang": rng.uniform(0, 40, 8)}
        acc.accumulate({k: torch.from_numpy(v) if i == 1 else v for k, v in batch.items()})  # tensors too
        jacc.accumulate(batch)
    agg, jagg = acc.aggregate(), jacc.aggregate()
    assert list(agg) == list(jagg)
    for k in agg:
        assert agg[k].dtype == jagg[k].dtype
        np.testing.assert_array_equal(agg[k], jagg[k])
    for rot, trans in ((5, 0.25), (10, 0.5), (30, 2.0)):
        assert pm.precision(agg, rot, trans) == jpm.precision(jagg, rot, trans)

    pm.print_auc_table(agg)
    ours = capsys.readouterr().out
    jpm.print_auc_table(jagg)
    assert ours == capsys.readouterr().out and ours.count("AUC") == 4
