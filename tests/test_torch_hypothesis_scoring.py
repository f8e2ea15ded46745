"""K3, RANSAC hypothesis scoring: the port against mickey_tpu.

The plain version (the CPU path) is held against the JAX Pallas kernel in
interpret mode at 1e-5 relative: fp32 throughout, only the summation order
over the samples differs. The CUDA kernel is held against the plain version
on the card at the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.ops.hypothesis_scoring import fused_hypothesis_scores
from mickey_tpu_torch.ops.hypothesis_scoring import hypothesis_scores, hypothesis_scores_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(b=2, s=300, r=13, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (b, s, 3)).astype(np.float32)
    Y = (X + rng.normal(0, 0.2, X.shape)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((b * r, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[:, None, None]).reshape(b, r, 3, 3).astype(np.float32)
    t = rng.normal(0, 0.1, (b, r, 1, 3)).astype(np.float32)
    return X, Y, R, t


def test_plain_matches_jax_interpret():
    X, Y, R, t = _inputs()
    ref = np.asarray(fused_hypothesis_scores(*(jnp.asarray(a) for a in (X, Y, R, t)), th=0.3, interpret=True))
    out = hypothesis_scores(*(torch.from_numpy(a) for a in (X, Y, R, t)), 0.3)
    assert out.shape == (2, 13)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_matches_plain(cuda):
    X, Y, R, t = (torch.from_numpy(a).to(cuda) for a in _inputs(b=2, s=2048, r=100))
    out = hypothesis_scores(X, Y, R, t, 0.3)
    ref = hypothesis_scores_plain(X, Y, R, t, 0.3)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def _solve_inputs(it=20, b=2, s=2048, r=100, seed=3):
    """A solve's point sets as the solver stacks them: (it, B, S, 3) and
    (it, B, R, 3, 3) poses, (it, B, R, 1, 3) translations."""
    X, Y, R, t = _inputs(b=it * b, s=s, r=r, seed=seed)
    return (X.reshape(it, b, s, 3), Y.reshape(it, b, s, 3), R.reshape(it, b, r, 3, 3), t.reshape(it, b, r, 1, 3))


def test_stacked_draws_equal_the_calls_a_draw():
    """The solver scores its it x B point sets in one call: on the plain path
    every (draw, pair, hypothesis) sum is bitwise the one that a call a draw
    gives (each sum is independent of the others)."""
    X, Y, R, t = (torch.from_numpy(a) for a in _solve_inputs())
    it, b, s, _ = X.shape
    r = R.shape[2]
    one = hypothesis_scores(X.reshape(it * b, s, 3), Y.reshape(it * b, s, 3), R.reshape(it * b, r, 3, 3),
                            t.reshape(it * b, r, 1, 3), 0.3).reshape(it, b, r)
    per_draw = torch.stack([hypothesis_scores(X[d], Y[d], R[d], t[d], 0.3) for d in range(it)])
    assert torch.equal(one, per_draw)


def test_plain_at_the_solver_shape_matches_jax_interpret():
    """At a solve's shape (20 draws x 2 pairs stacked, 2048 samples, 100
    hypotheses) the plain version matches the JAX kernel in interpret mode
    at 1e-5 relative."""
    X, Y, R, t = (a.reshape(-1, *a.shape[2:]) for a in _solve_inputs())
    ref = np.asarray(fused_hypothesis_scores(*(jnp.asarray(a) for a in (X, Y, R, t)), th=0.3, interpret=True))
    out = hypothesis_scores(*(torch.from_numpy(a) for a in (X, Y, R, t)), 0.3)
    assert out.shape == (40, 100)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_at_the_solver_shape(cuda):
    """On the card, one launch on a solve's 40 stacked point sets against
    the plain version at rtol 1e-5, atol 1e-4; two launches bitwise equal."""
    X, Y, R, t = (torch.from_numpy(a.reshape(-1, *a.shape[2:])).to(cuda) for a in _solve_inputs())
    out = hypothesis_scores(X, Y, R, t, 0.3)
    again = hypothesis_scores(X, Y, R, t, 0.3)
    ref = hypothesis_scores_plain(X, Y, R, t, 0.3)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
    assert torch.equal(out, again)
