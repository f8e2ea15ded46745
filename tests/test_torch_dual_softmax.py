"""The training matcher (K4 forward, K5 backward) against mickey_tpu on the CPU.

``ops.fused_matcher.fused_dual_softmax_vjp`` runs its kernels' plain
versions on CPU tensors; the reference is the JAX package's
``fused_dual_softmax_vjp`` with its Pallas kernels in interpret mode. Inputs
are L2-normalized descriptors and a cotangent G made with numpy from a seed.

Tolerances are those of the JAX package's own test of the same function
(``tests/test_fused_matcher.py::test_fused_vjp_matches_xla_grads``):
values rtol 1e-5, gradients atol 2e-5 and rtol 1e-4 (fp32, another
summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.ops.fused_matcher import fused_dual_softmax_vjp as jax_vjp
from mickey_tpu_torch.nn.matcher import dual_softmax, match_scores
from mickey_tpu_torch.ops import fused_matcher as fm
from mickey_tpu_torch.config import default_config

SHAPES = [(2, 20, 20, 16), (1, 300, 260, 128)]  # tiny unaligned; multi-tile, production C


def _inputs(shape, seed=0):
    b, m, n, c = shape
    rng = np.random.default_rng(seed)
    d0 = rng.standard_normal((b, m, c)).astype(np.float32)
    d1 = rng.standard_normal((b, n, c)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return d0, d1, rng.standard_normal((b, m, n)).astype(np.float32)


def _port(d0, d1, G, dustbin, use_dustbin, fn):
    t0, t1 = (torch.from_numpy(x).requires_grad_(True) for x in (d0, d1))
    a = torch.tensor(dustbin, requires_grad=True)
    out = fn(t0, t1, a, use_dustbin)
    loss = (out * torch.from_numpy(G)).sum()
    loss.backward()
    ga = 0.0 if a.grad is None else float(a.grad)  # the dense path without a dustbin never reads it
    return out.detach().numpy(), loss.item(), t0.grad.numpy(), t1.grad.numpy(), ga


def _fused(t0, t1, a, use_dustbin):
    return fm.fused_dual_softmax_vjp(t0, t1, a, temperature=0.1, use_dustbin=use_dustbin)


def _dense(t0, t1, a, use_dustbin):
    return dual_softmax(t0, t1, a, temperature=0.1, use_dustbin=use_dustbin)


@pytest.mark.parametrize("use_dustbin", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_vjp_matches_jax(shape, use_dustbin):
    d0, d1, G = _inputs(shape)
    out, v, g0, g1, ga = _port(d0, d1, G, 0.7, use_dustbin, _fused)

    def loss(x0, x1, a):
        o = jax_vjp(x0, x1, a, temperature=0.1, use_dustbin=use_dustbin, block_m=128, interpret=True)
        return jnp.sum(o * G), o

    (v_ref, out_ref), g_ref = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(d0), jnp.asarray(d1), jnp.float32(0.7))
    np.testing.assert_allclose(out, np.asarray(out_ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    for a, b in zip((g0, g1, ga), g_ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-4)
    if not use_dustbin:
        assert ga == 0.0


@pytest.mark.parametrize("use_dustbin", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_vjp_matches_autograd_of_dense(shape, use_dustbin):
    """The analytic backward against torch.autograd of the port's dense path."""
    d0, d1, G = _inputs(shape, seed=1)
    ours = _port(d0, d1, G, 0.7, use_dustbin, _fused)
    ref = _port(d0, d1, G, 0.7, use_dustbin, _dense)
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours[1], ref[1], rtol=1e-5)
    for a, b in zip(ours[2:], ref[2:]):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)


def test_pieces_are_the_dense_quantities():
    """lse_row / lse_col are the dustbin-augmented logsumexps, and r, c the
    row and column sums of G * P, on the dense couplings (fp32, torch's
    default fp32 tolerance)."""
    d0, d1, G = (torch.from_numpy(x) for x in _inputs(SHAPES[0], seed=2))
    alpha, inv_t = 0.7, 10.0
    lse_c = fm.col_lse(d0, d1, inv_t, alpha)
    out, lse_r = fm.pair_softmax(d0, d1, lse_c, inv_t, alpha)
    s = d0 @ d1.transpose(1, 2) * inv_t
    b, m, n = s.shape
    cp = torch.full((b, m + 1, n + 1), alpha, dtype=s.dtype)
    cp[:, :m, :n] = s
    torch.testing.assert_close(lse_r, torch.logsumexp(cp, dim=2)[:, :m])
    torch.testing.assert_close(lse_c, torch.logsumexp(cp, dim=1)[:, :n])
    r, c = fm.dual_softmax_bwd_sums(d0, d1, G, lse_r, lse_c, inv_t)
    torch.testing.assert_close(r, (G * out).sum(2))
    torch.testing.assert_close(c, (G * out).sum(1))


def test_match_scores_routes_cpu_tensors_to_the_dense_path():
    cfg = default_config()
    d0, d1, _ = _inputs(SHAPES[0])
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    params = {"dustbin_score": torch.tensor(1.0)}
    for train in (False, True):
        torch.testing.assert_close(match_scores(params, t0, t1, cfg, train=train), dual_softmax(t0, t1, 1.0))
    cfg.FEATURE_MATCHER.TYPE = "Sinkhorn"
    with pytest.raises(NotImplementedError):
        match_scores(params, t0, t1, cfg)


def test_kernel_wrappers_refuse_deep_descriptors():
    """The kernels stage at most 128 channels; a deeper descriptor raises
    before any launch (checked without a card: the depth check comes first)."""
    d = torch.zeros((1, 4, fm.DUAL_SOFTMAX_MAX_C + 1))
    with pytest.raises(ValueError):
        fm._require_descs(d, d, "pair_softmax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 45, 16), (3, 131, 200, 128)])
def test_kernels_match_plain(cuda, shape):
    """K4 and K5 against their plain versions on the card, at ragged shapes
    (tolerances of chip_smoke.py: summation order, amplified by exp)."""
    import chip_smoke

    b, m, n, c = shape
    tin = chip_smoke.train_kernel_inputs(cuda, pairs=b, kpts=max(m, n), desc=c)
    tin["dsc0"] = tin["dsc0"][:, :m].contiguous()  # M != N
    tin["dsc1"] = tin["dsc1"][:, :n].contiguous()
    tin["G"] = tin["G"][:, :m, :n].contiguous()
    tin["lse_col"] = fm.col_lse_plain(tin["dsc0"], tin["dsc1"], 10.0, 1.0)
    _, tin["lse_row"] = fm.pair_softmax_plain(tin["dsc0"], tin["dsc1"], tin["lse_col"], 10.0, 1.0)
    tin["r"], tin["c"] = fm.dual_softmax_bwd_sums_plain(tin["dsc0"], tin["dsc1"], tin["G"], tin["lse_row"],
                                                        tin["lse_col"], 10.0)
    errs = chip_smoke.check_train_kernels(tin)
    assert set(errs) == {"pair_softmax", "dual_softmax_bwd_sums", "dual_softmax_bwd_grads"}
