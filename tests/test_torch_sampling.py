"""The public sampler and ``TPU.SAMPLING`` against mickey_tpu on the CPU.

``weighted_sample_without_replacement`` is the JAX package's public sampler
(``mickey_tpu/ops/sampling.py:100``, torch.multinomial without replacement)
driven by a ``torch.Generator``: the two PRNG streams differ, so its draws
are held to their distribution, and its log-weights to JAX's. Those agree
in the formula and where it gives -1e30, and within 2 ulp elsewhere: the two
libraries' fp32 ``log`` differ in the last bit on some inputs.

``TPU.SAMPLING = "approx"`` is the JAX package's ``approx_max_k`` in its
Gumbel top-k draws; off a TPU that is exact, so JAX gives the same pose for
either mode on the CPU, and the port takes "approx" as "exact" everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from mickey_tpu.solver import procrustes_ransac as jsolver
from mickey_tpu_torch import default_config
from mickey_tpu_torch.nn.extractor import TopKCorrespondences
from mickey_tpu_torch.ops.sampling import sample_log_weights, weighted_sample_without_replacement
from mickey_tpu_torch.solver import estimate_pose, estimate_pose_topk_from_cfg
from mickey_tpu_torch.solver.procrustes_ransac import solver_kw



def _weights(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, (3, 500)).astype(np.float32)
    w[:, ::7] = 0.0
    w[0, 3:6] = np.float32([1e-35, 1e-45, 3e-30])  # below, at and above the eps floor
    return w


def test_log_weights_are_jax_formula():
    """-1e30 exactly where JAX puts it (w <= 0, and a subnormal w, which XLA
    flushes to 0), the eps floor where JAX applies it, within 2 ulp of JAX's
    fp32 log elsewhere."""
    w = _weights()
    ref = np.asarray(jnp.where(jnp.asarray(w) > 0, jnp.log(jnp.maximum(jnp.asarray(w), 1e-30)), -1e30))
    out = sample_log_weights(torch.from_numpy(w)).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out == np.float32(-1e30), ref == np.float32(-1e30))
    np.testing.assert_array_max_ulp(out, ref, maxulp=2)
    assert out[0, 3] == np.float32(np.log(np.float32(1e-30))) and out[0, 4] == np.float32(-1e30)


@pytest.mark.parametrize("k", [1, 5, 40])
def test_zero_weights_never_drawn(k):
    w = torch.from_numpy(_weights(1))
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        idx = weighted_sample_without_replacement(g, w, k)
        assert idx.shape == (3, k) and idx.dtype == torch.int32
        assert bool((torch.gather(w, 1, idx.long()) > 0).all())
        assert all(len(set(r.tolist())) == k for r in idx)


def test_frequencies_follow_the_weights():
    """k = 1: the counts over 40000 draws against weights / sum by a
    chi-square test at p = 1e-3; k = 2: each draw's first pick the same."""
    w = np.float32([0.0, 1.0, 2.0, 3.0, 4.0, 10.0, 0.5, 0.0])
    n = 40000
    g = torch.Generator().manual_seed(3)
    for k in (1, 2):
        idx = weighted_sample_without_replacement(g, torch.from_numpy(np.tile(w, (n, 1))), k)[:, 0].numpy()
        counts = np.bincount(idx, minlength=w.size)
        assert counts[w == 0].sum() == 0
        p = w[w > 0] / w.sum()
        chi2 = ((counts[w > 0] - n * p) ** 2 / (n * p)).sum()
        assert chi2 < stats.chi2.ppf(1 - 1e-3, df=p.size - 1), chi2


def _scene(seed=4, b=2, n=40):
    rng = np.random.default_rng(seed)
    K = np.tile(np.float32([[[300, 0, 160], [0, 300, 120], [0, 0, 1]]]), (b, 1, 1))
    kps0 = rng.uniform(0, 320, (b, n, 2)).astype(np.float32)
    depth0 = rng.uniform(2, 6, (b, n, 1)).astype(np.float32)
    kps1 = kps0 + rng.normal(0, 2, kps0.shape).astype(np.float32)
    depth1 = depth0 + rng.normal(0, 0.02, depth0.shape).astype(np.float32)
    scores = rng.uniform(0, 1e-3, (b, n, n)).astype(np.float32)
    scores[:, np.arange(n), np.arange(n)] += rng.uniform(0.5, 1, (b, n)).astype(np.float32)
    return [scores, kps0, depth0, kps1, depth1, K, K]


def test_approx_sampling_is_exact_off_the_tpu():
    """JAX: ``approx_sampling`` True and False give the same pose on the CPU
    from one key. The port: ``TPU.SAMPLING = "approx"`` gives the pose
    "exact" gives from one generator, on the fused route's table and on the
    dense matrix; any other value is refused."""
    args = _scene()
    kw = dict(it_matches=4, it_ransac=16, num_samples=32, num_corr=3, num_refinements=2, prefilter=400)
    key = jax.random.PRNGKey(1)
    ja, je = (jsolver.estimate_pose(key, *(jnp.asarray(a) for a in args), approx_sampling=ap, **kw)
              for ap in (True, False))
    for f in ("R", "t", "confidence"):
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)), np.asarray(getattr(je, f)))

    cfg = default_config()
    cfg.PROCRUSTES.IT_MATCHES, cfg.PROCRUSTES.IT_RANSAC, cfg.PROCRUSTES.NUM_SAMPLED_MATCHES = 4, 16, 32
    t = [torch.from_numpy(a) for a in args]
    flat = t[0].reshape(2, -1)
    top, idx = torch.topk(flat, 400, dim=-1)
    tcorr = TopKCorrespondences(t[1], t[2], t[3], t[4], top, idx.to(torch.int32), torch.ones(2, dtype=torch.bool))
    poses = {}
    for mode in ("exact", "approx"):
        cfg.TPU.SAMPLING = mode
        poses[mode] = (estimate_pose_topk_from_cfg(tcorr, t[5], t[6], cfg, generator=torch.Generator().manual_seed(2)),
                       estimate_pose(*t, prefilter=400, generator=torch.Generator().manual_seed(2), **solver_kw(cfg)))
    for a, b in zip(poses["exact"], poses["approx"]):
        assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t) and a.valid.all()
    cfg.TPU.SAMPLING = "approximate"
    with pytest.raises(ValueError, match="TPU.SAMPLING"):
        solver_kw(cfg)
