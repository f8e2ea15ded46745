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
from mickey_tpu_torch.nn.matcher import dual_softmax, match_scores, sinkhorn
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
    cfg.FEATURE_MATCHER.TYPE = "Sinkhorn"  # every other matcher type takes Sinkhorn, as in the JAX package
    torch.testing.assert_close(match_scores(params, t0, t1, cfg),
                               sinkhorn(t0, t1, params["dustbin_score"], cfg.FEATURE_MATCHER.SINKHORN.NUM_IT))


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


# -- K4's arithmetic: 3xTF32 on the correlation engine ---------------------------------


@pytest.mark.parametrize("use_dustbin", [True, False])
@pytest.mark.parametrize("shape", [(2, 37, 45, 16), (1, 129, 65, 128), (2, 70, 1, 128)])
def test_pair_softmax_3xtf32_plain_matches_jax_interpret(shape, use_dustbin):
    """K4's arithmetic (descriptors split once, lo*hi + hi*lo, then hi*hi)
    against the JAX kernels' P and lse_row at DS_RTOL (1e-4 |ref| + 1e-6
    max|ref|), on the JAX lse_col; one TF32 pass (hi*hi alone) is the
    negative control whose P misses it."""
    from mickey_tpu.ops import fused_matcher as jfm

    b, m, n, c = shape
    d0, d1, _ = _inputs(shape, seed=30 + m)
    p0, p1, alpha = jfm._pad_inputs(jnp.asarray(d0), jnp.asarray(d1), jnp.float32(0.7), use_dustbin, 128)
    out, lse_row, lse_col = (np.asarray(x) for x in jfm._forward_padded(p0, p1, alpha, 10.0, m, n, 128, True))
    out, lse_row, lse_col = out[:, :m, :n], lse_row.reshape(b, -1)[:, :m], lse_col[:, 0, :n]

    def ratio(x, ref):
        x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
        return (np.abs(x - ref) / (1e-4 * np.abs(ref) + 1e-6 * np.abs(ref).max())).max()

    t0, t1, lc = torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(lse_col)
    a = fm._alpha(0.7, use_dustbin)
    p, lr = fm.pair_softmax_3xtf32_plain(t0, t1, lc, 10.0, a)
    assert ratio(p, out) <= 1.0 and ratio(lr, lse_row) <= 1.0
    if n > 1:  # a single column: P is 1 whatever the score
        assert ratio(fm.pair_softmax_3xtf32_plain(t0, t1, lc, 10.0, a, passes=1)[0], out) > 1.0


# -- K5's arithmetic: 3xTF32 on the correlation engine, dS split in registers ------------


def _jax_pieces(d0, d1, use_dustbin, m, n):
    """The JAX kernels' lse_row, lse_col (interpret mode, cropped)."""
    from mickey_tpu.ops import fused_matcher as jfm

    b = d0.shape[0]
    p0, p1, alpha = jfm._pad_inputs(jnp.asarray(d0), jnp.asarray(d1), jnp.float32(0.7), use_dustbin, 128)
    _, lse_row, lse_col = (np.asarray(x) for x in jfm._forward_padded(p0, p1, alpha, 10.0, m, n, 128, True))
    return torch.from_numpy(lse_row.reshape(b, -1)[:, :m].copy()), torch.from_numpy(lse_col[:, 0, :n].copy())


@pytest.mark.parametrize("use_dustbin", [True, False])
@pytest.mark.parametrize("shape", [(2, 37, 45, 16), (1, 129, 65, 128), (2, 70, 1, 128)])
def test_bwd_3xtf32_plain_matches_jax_interpret(shape, use_dustbin):
    """K5's two bodies' arithmetic (the correlation on the engine, dS in
    fp32, dS X_oth with dS and X_oth split as the descriptors are, lo*hi +
    hi*lo then hi*hi) on the JAX kernels' logsumexps: dd0, dd1 against
    jax.grad of the JAX route in interpret mode at the JAX package's own
    gradient tolerance (atol 2e-5, rtol 1e-4); one TF32 pass of both
    products is the negative control that misses it."""
    b, m, n, c = shape
    d0, d1, G = _inputs(shape, seed=40 + m)

    def loss(x0, x1):
        return jnp.sum(jax_vjp(x0, x1, jnp.float32(0.7), temperature=0.1, use_dustbin=use_dustbin, block_m=128,
                               interpret=True) * G)

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(d0), jnp.asarray(d1))
    lse_row, lse_col = _jax_pieces(d0, d1, use_dustbin, m, n)
    t0, t1, tg = torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(G)
    r, cc = fm.dual_softmax_bwd_sums_3xtf32_plain(t0, t1, tg, lse_row, lse_col, 10.0)
    for g, want in zip(fm.dual_softmax_bwd_grads_3xtf32_plain(t0, t1, tg, lse_row, lse_col, r, cc, 10.0), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    one = fm.dual_softmax_bwd_grads_3xtf32_plain(t0, t1, tg, lse_row, lse_col, r, cc, 10.0, passes=1)
    assert not all(np.allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4) for g, w in zip(one, ref))


@pytest.mark.parametrize("shape", SHAPES + [(2, 70, 1, 128)])
def test_bwd_3xtf32_plain_matches_plain(shape):
    """The 3xTF32 mimics of K5's two bodies against the fp32 plain versions
    at chip_smoke.py's tolerances (r, c at DS_RTOL, dd0 and dd1 at DS_RTOL
    max|ref|), with the dustbin on and off."""
    import chip_smoke

    b, m, n, c = shape
    d0, d1, G = (torch.from_numpy(x) for x in _inputs(shape, seed=50))
    for alpha in (0.7, fm.NEG_INF):
        lse_col = fm.col_lse_plain(d0, d1, 10.0, alpha)
        _, lse_row = fm.pair_softmax_plain(d0, d1, lse_col, 10.0, alpha)
        sums = fm.dual_softmax_bwd_sums_3xtf32_plain(d0, d1, G, lse_row, lse_col, 10.0)
        for x, ref in zip(sums, fm.dual_softmax_bwd_sums_plain(d0, d1, G, lse_row, lse_col, 10.0)):
            chip_smoke._close(x, ref, "bwd_sums", chip_smoke.DS_RTOL)
        r, cc = sums
        grads = fm.dual_softmax_bwd_grads_3xtf32_plain(d0, d1, G, lse_row, lse_col, r, cc, 10.0)
        for x, ref in zip(grads, fm.dual_softmax_bwd_grads_plain(d0, d1, G, lse_row, lse_col, r, cc, 10.0)):
            chip_smoke._close_to_max(x, ref, "bwd_grads", chip_smoke.DS_RTOL)


def test_ds_split_keeps_the_fp32_product_nonfinite_pattern():
    """dS takes the descriptors' split (``desc_split``: hi truncated, lo of
    x's sign, 2^-126 for a nonzero exact TF32 value, 0 where hi is not
    finite): against an infinite descriptor value the three passes lo*hi +
    hi*lo + hi*hi give the fp32 product's +-inf or NaN, for every finite dS,
    and an infinite dS gives the fp32 product against a finite value. Two
    infinities meet as 0 * inf in a lo pass, NaN where fp32 gives +-inf, as
    in the correlation. Rounding hi to nearest (``tf32_split``) gives NaN
    where a lo of the other sign meets the infinity."""
    from mickey_tpu_torch.ops.tf32 import desc_split, tf32_split

    ds = torch.tensor([0.0, -0.0, 1.0, -3.0, 1e-3, 1.0 + 3 * 2.0 ** -12, -(1.0 + 3 * 2.0 ** -12), 7.5e-30,
                       float("inf"), float("-inf"), float("nan")])
    x = torch.tensor([float("inf"), float("-inf"), 1.5, -0.25, 0.0])
    xh, xl = desc_split(x)

    def passes(split):
        h, lo = split(ds)
        return (lo[:, None] * xh[None] + h[:, None] * xl[None]) + h[:, None] * xh[None]

    want = ds[:, None] * x[None]
    got = passes(desc_split)
    both_inf = torch.isinf(ds)[:, None] & torch.isinf(x)[None]
    assert torch.isnan(got[both_inf]).all()
    got, want = got[~both_inf], want[~both_inf]
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-6, atol=0)
    assert not torch.equal(torch.isnan(passes(tf32_split)[~both_inf]), torch.isnan(want))


def test_bwd_3xtf32_plain_nonfinite_where_plain_is():
    """An infinite descriptor value and a NaN row: the mimics of K5 and K6
    give NaN and infinities exactly where the fp32 plain versions do."""
    d0, d1, G = (torch.from_numpy(x) for x in _inputs((3, 40, 33, 16), seed=60))
    d1[1, 3, 7] = float("inf")
    d0[2, 5] = float("nan")
    lse_col = fm.col_lse_plain(d0, d1, 10.0, 0.7)
    _, lse_row = fm.pair_softmax_plain(d0, d1, lse_col, 10.0, 0.7)
    r, c = fm.dual_softmax_bwd_sums_plain(d0, d1, G, lse_row, lse_col, 10.0)
    gr, gc = torch.randn(3, 40, generator=torch.Generator().manual_seed(0)), torch.ones(3, 33)
    pairs = [(fm.dual_softmax_bwd_sums_3xtf32_plain(d0, d1, G, lse_row, lse_col, 10.0), (r, c)),
             (fm.dual_softmax_bwd_grads_3xtf32_plain(d0, d1, G, lse_row, lse_col, r, c, 10.0),
              fm.dual_softmax_bwd_grads_plain(d0, d1, G, lse_row, lse_col, r, c, 10.0)),
             (fm.lse_bwd_3xtf32_plain(d0, d1, gr, gc, lse_row, lse_col, 10.0),
              fm.lse_bwd_plain(d0, d1, gr, gc, lse_row, lse_col, 10.0))]
    for got, want in pairs:
        for x, ref in zip(got, want):
            assert torch.equal(torch.isnan(x), torch.isnan(ref)) and torch.isnan(ref).any()
            assert torch.equal(x[torch.isinf(ref)], ref[torch.isinf(ref)])
            assert torch.isfinite(ref).any()
