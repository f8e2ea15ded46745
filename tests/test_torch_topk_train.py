"""The fused top-K training route (K2a + K2b forward, K6 backward) against
mickey_tpu on the CPU.

``ops.fused_matcher.fused_topk_scores_train`` runs its kernels' plain
versions on CPU tensors; the references are the JAX package's
``fused_topk_scores_train`` with its Pallas kernels in interpret mode and
its dense oracle ``dense_topk_scores_train``. Inputs come from numpy with a
fixed seed; the loss takes injected draws, since the PRNG streams differ.

Tolerances are those of the JAX package's own tests of the same functions
(``tests/test_fused_matcher.py::TestFusedTopKTrain``), fp32 with another
summation order: table values atol 1e-6 / rtol 1e-5, logsumexps 1e-5, the
index sets equal where values are not near-tied (``chip_smoke._sets_agree``);
logsumexp gradients atol 2e-5 / rtol 1e-4; loss values rtol 1e-5 and loss
gradients atol 3e-5 / rtol 2e-4. One whole staged step: the tolerances of
``tests/test_torch_training.py`` (loss 1e-5, gradients 1e-2 of each leaf's
largest entry), the loss held against the JAX package's forward program:
its gradient program's loss differs from its forward's by up to 1.5e-5
relative (XLA fuses the two differently, and the REINFORCE surrogate
multiplies the rounding of each hypothesis loss by the sum of the draw's
~16 log scores).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mickey_tpu.config import default_config as jax_default_config
from mickey_tpu.nn import extractor as jext
from mickey_tpu.ops import fused_matcher as jfm
from mickey_tpu.training import loss as jloss
from mickey_tpu_torch.config import default_config
from mickey_tpu_torch.nn.matcher import dual_softmax
from mickey_tpu_torch.ops import _cuda
from mickey_tpu_torch.ops import fused_matcher as fm
from mickey_tpu_torch.training import loss as tloss
from mickey_tpu_torch.training.train_step import StagedTrainStep, init_train_state, loss_and_grads
from mickey_tpu_torch.weights import init_params_numpy, params_to_numpy, params_to_torch
from test_torch_training import B, HW, _loss_inputs, _tree_close, inject_draws, small_cfg, synthetic_batch

SHAPES = [(2, 20, 24, 16), (1, 300, 260, 64)]  # tiny unaligned; several tiles


def _inputs(shape, seed=0):
    b, m, n, c = shape
    rng = np.random.default_rng(seed)
    d0 = rng.standard_normal((b, m, c)).astype(np.float32)
    d1 = rng.standard_normal((b, n, c)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    s0 = rng.uniform(0.1, 1, (b, m)).astype(np.float32)
    s1 = rng.uniform(0.1, 1, (b, n)).astype(np.float32)
    return d0, d1, s0, s1, rng


@pytest.mark.parametrize("use_dustbin", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(shape, use_dustbin):
    d0, d1, s0, s1, _ = _inputs(shape)
    P, L = 48, 8
    kw = dict(temperature=0.1, use_dustbin=use_dustbin, row_topl=L)
    ja = [jnp.asarray(x) for x in (d0, d1, s0, s1)]
    ref = jfm.fused_topk_scores_train(*ja, jnp.float32(0.7), P, block_m=128, interpret=True, **kw)
    oracle = jfm.dense_topk_scores_train(*ja, jnp.float32(0.7), P, **kw)
    ours = fm.fused_topk_scores_train(*(torch.from_numpy(x) for x in (d0, d1, s0, s1)), 0.7, P, **kw)
    assert [tuple(t.shape) for t in ours] == [tuple(r.shape) for r in ref]
    for r in (ref, oracle):
        v, i, ok, lr, lcol = (np.asarray(x) for x in r)
        np.testing.assert_allclose(ours[0].numpy(), v, atol=1e-6, rtol=1e-5)
        chip_smoke._sets_agree(ours[0], ours[1], torch.from_numpy(v), torch.from_numpy(i), "top-P table")
        np.testing.assert_array_equal(ours[2].numpy(), ok)
        np.testing.assert_allclose(ours[3].numpy(), lr, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ours[4].numpy(), lcol, atol=1e-5, rtol=1e-5)
    assert ours[1].dtype == torch.int32 and not ours[0].requires_grad


def _lse_grads(fn, d0, d1, wr, wc, dustbin):
    t0, t1 = (torch.from_numpy(x).requires_grad_(True) for x in (d0, d1))
    a = torch.tensor(dustbin, requires_grad=True)
    lr, lcol = fn(t0, t1, a)
    ((torch.from_numpy(wr) * lr).sum() + (torch.from_numpy(wc) * lcol).sum()).backward()
    return t0.grad.numpy(), t1.grad.numpy(), 0.0 if a.grad is None else float(a.grad)


@pytest.mark.parametrize("use_dustbin", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_gradients_match_jax(shape, use_dustbin):
    """The analytic backward (K6's plain version and the closed-form dustbin
    gradient) against jax.grad of the JAX route, K6 in interpret mode."""
    d0, d1, s0, s1, rng = _inputs(shape, seed=1)
    b, m, n, _ = shape
    wr = rng.normal(size=(b, m)).astype(np.float32)
    wc = rng.normal(size=(b, n)).astype(np.float32)

    def jax_loss(x0, x1, a):
        _, _, _, lr, lcol = jfm.fused_topk_scores_train(
            x0, x1, jnp.asarray(s0), jnp.asarray(s1), a, 16, temperature=0.1, use_dustbin=use_dustbin,
            row_topl=4, block_m=128, interpret=True)
        return jnp.sum(wr * lr) + jnp.sum(wc * lcol)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(d0), jnp.asarray(d1), jnp.float32(0.7))
    s0t, s1t = torch.from_numpy(s0), torch.from_numpy(s1)
    ours = _lse_grads(lambda t0, t1, a: fm.fused_topk_scores_train(
        t0, t1, s0t, s1t, a, 16, temperature=0.1, use_dustbin=use_dustbin, row_topl=4)[3:],
        d0, d1, wr, wc, 0.7)
    for g, r, name in zip(ours, ref, ("dsc0", "dsc1", "dustbin")):
        np.testing.assert_allclose(g, np.asarray(r), atol=2e-5, rtol=1e-4, err_msg=name)
    if not use_dustbin:
        assert ours[2] == 0.0


@pytest.mark.parametrize("use_dustbin", [True, False])
def test_lse_bwd_plain_matches_autograd_of_dense_lse(use_dustbin):
    """K6's plain version, and the whole route's backward, against
    torch.autograd of the port's own ``dense_lse``."""
    shape = SHAPES[1]
    d0, d1, s0, s1, rng = _inputs(shape, seed=2)
    b, m, n, _ = shape
    wr = rng.normal(size=(b, m)).astype(np.float32)
    wc = rng.normal(size=(b, n)).astype(np.float32)
    ref = _lse_grads(lambda t0, t1, a: fm.dense_lse(t0, t1, a, 0.1, use_dustbin), d0, d1, wr, wc, 0.7)
    alpha = 0.7 if use_dustbin else fm.NEG_INF
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    lse_col = fm.col_lse(t0, t1, 10.0, alpha)
    lse_row = fm.pair_topk(t0, t1, torch.from_numpy(s0), torch.from_numpy(s1), lse_col, 10.0, alpha, 4)[3]
    dd0, dd1 = fm.lse_bwd_plain(t0, t1, torch.from_numpy(wr), torch.from_numpy(wc), lse_row, lse_col, 10.0)
    route = _lse_grads(lambda x0, x1, a: fm.fused_topk_scores_train(
        x0, x1, torch.from_numpy(s0), torch.from_numpy(s1), a, 16, temperature=0.1,
        use_dustbin=use_dustbin, row_topl=4)[3:], d0, d1, wr, wc, 0.7)
    for g, r in zip((dd0.numpy(), dd1.numpy()), ref[:2]):
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=1e-4)
    for g, r in zip(route, ref):
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("use_dustbin", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(2, 70, 1, 128)])
def test_lse_bwd_3xtf32_plain_matches_jax(shape, use_dustbin):
    """K6's arithmetic (the correlation on the engine, dS in fp32, dS X_oth
    with dS and X_oth split as the descriptors are) on the JAX route's
    logsumexps: dd0, dd1 against jax.grad of the JAX route, K6 in interpret
    mode, at the JAX package's gradient tolerance (atol 2e-5, rtol 1e-4); one
    TF32 pass of both products is the negative control that misses it."""
    d0, d1, s0, s1, rng = _inputs(shape, seed=5)
    b, m, n, _ = shape
    wr = rng.normal(size=(b, m)).astype(np.float32)
    wc = rng.normal(size=(b, n)).astype(np.float32)
    kw = dict(temperature=0.1, use_dustbin=use_dustbin, row_topl=1, block_m=128, interpret=True)
    ja = [jnp.asarray(x) for x in (d0, d1, s0, s1)]

    def jax_loss(x0, x1):
        _, _, _, lr, lcol = jfm.fused_topk_scores_train(x0, x1, ja[2], ja[3], jnp.float32(0.7), 4, **kw)
        return jnp.sum(wr * lr) + jnp.sum(wc * lcol)

    ref = jax.grad(jax_loss, argnums=(0, 1))(ja[0], ja[1])
    lse_row, lse_col = (torch.from_numpy(np.asarray(x)) for x in jfm.fused_topk_scores_train(
        *ja, jnp.float32(0.7), 4, **kw)[3:])
    args = (torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(wr), torch.from_numpy(wc), lse_row, lse_col,
            10.0)
    for g, want in zip(fm.lse_bwd_3xtf32_plain(*args), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    one = fm.lse_bwd_3xtf32_plain(*args, passes=1)
    assert not all(np.allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4) for g, w in zip(one, ref))


def test_lse_bwd_3xtf32_plain_matches_plain():
    """K6's 3xTF32 mimic against its fp32 plain version at chip_smoke.py's
    tolerance (dd0, dd1 at DS_RTOL max|ref|), with the dustbin on and off."""
    d0, d1, _, _, rng = _inputs(SHAPES[1], seed=6)
    b, m, n, _ = SHAPES[1]
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    gr, gc = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)) for sh in ((b, m), (b, n)))
    for alpha in (0.7, fm.NEG_INF):
        lse_col = fm.col_lse_plain(t0, t1, 10.0, alpha)
        _, lse_row = fm.pair_softmax_plain(t0, t1, lse_col, 10.0, alpha)
        got = fm.lse_bwd_3xtf32_plain(t0, t1, gr, gc, lse_row, lse_col, 10.0)
        for x, ref in zip(got, fm.lse_bwd_plain(t0, t1, gr, gc, lse_row, lse_col, 10.0)):
            chip_smoke._close_to_max(x, ref, "lse_bwd", chip_smoke.DS_RTOL)


def test_cpu_route_launches_nothing():
    d0, d1, s0, s1, _ = _inputs(SHAPES[0])
    t0 = torch.from_numpy(d0).requires_grad_(True)
    before = dict(_cuda.LAUNCHES)
    out = fm.fused_topk_scores_train(t0, torch.from_numpy(d1), torch.from_numpy(s0), torch.from_numpy(s1),
                                     0.7, 16, row_topl=4)
    out[3].sum().backward()  # lse_col's cotangent is None: taken as zeros
    assert _cuda.LAUNCHES == before and torch.isfinite(t0.grad).all()


# -- the loss ----------------------------------------------------------------------------

SIDE = 6


def _topk_loss_inputs(seed=8, b=3, c=16):
    """``_loss_inputs``' keypoints, depths and pose on a 6 x 6 grid, with
    descriptors and detection scores for it, the loss config, and injected
    draws of distinct keypoints."""
    _, kps0, dep0, kps1, dep1, batch, Rgt, tgt, rng = _loss_inputs(seed=seed, b=b, side=SIDE)
    n = SIDE * SIDE
    d0, d1, s0, s1, _ = _inputs((b, n, n, c), seed=seed + 1)
    lc_j = jloss.LossConfig.from_cfg(small_cfg(jax_default_config()))
    lc_t = tloss.LossConfig.from_cfg(small_cfg(default_config()))
    idx, ridx = inject_draws(rng, b, SIDE, lc_j.it_matches, lc_j.num_samples_matches, lc_j.it_ransac,
                             lc_j.num_corr, border=0)
    Ks = [batch[k] for k in ("K_color0", "K_color1", "Kori_color0", "Kori_color1")]
    args = (d0, d1, np.float32(0.7), s0[..., None], s1[..., None], kps0, dep0, kps1, dep1)
    return args, Ks, Rgt, tgt, lc_j, lc_t, idx, ridx


def _port_topk_loss(args, Ks, Rgt, tgt, lc, draws, **kw):
    ts = [torch.tensor(x).requires_grad_(True) for x in args]
    d0, d1, a, s0, s1 = ts[:5]
    tk = fm.fused_topk_scores_train(d0, d1, s0[..., 0], s1[..., 0], a, 64, row_topl=8)
    total, aux = tloss.metric_pose_loss_topk(tk, d0, d1, s0, s1, *ts[5:], *map(torch.from_numpy, Ks),
                                             torch.from_numpy(Rgt), torch.from_numpy(tgt), lc, 60.0,
                                             temperature=0.1, sample_override=draws, **kw)
    total.backward()
    return total, aux, [t.grad.numpy() for t in ts]


def test_metric_pose_loss_topk_matches_jax():
    """Loss, aux and gradients w.r.t. every input, injected draws; the JAX
    side on its dense oracle ``dense_topk_scores_train``."""
    args, Ks, Rgt, tgt, lc_j, lc_t, idx, ridx = _topk_loss_inputs()
    assert tuple(lc_t) == tuple(lc_j)

    def jf(d0, d1, a, s0, s1, k0, dd0, k1, dd1):
        tk = jfm.dense_topk_scores_train(d0, d1, s0[..., 0], s1[..., 0], a, 64, temperature=0.1, row_topl=8)
        return jloss.metric_pose_loss_topk(tk, d0, d1, s0, s1, k0, dd0, k1, dd1, *map(jnp.asarray, Ks),
                                           jnp.asarray(Rgt), jnp.asarray(tgt), jax.random.PRNGKey(0), lc_j,
                                           jnp.float32(60.0), temperature=0.1,
                                           sample_override=(jnp.asarray(idx), jnp.asarray(ridx)))

    (ref, ref_aux), ref_g = jax.value_and_grad(jf, argnums=tuple(range(9)), has_aux=True)(*map(jnp.asarray, args))
    total, aux, grads = _port_topk_loss(args, Ks, Rgt, tgt, lc_t, tuple(map(torch.from_numpy, (idx, ridx))))
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    for k in ("avg_loss", "avg_loss_rot", "avg_loss_trans", "baseline", "mask_topk", "num_valid", "loss_value"):
        np.testing.assert_allclose(np.asarray(aux[k]), np.asarray(ref_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert bool(aux["hyp_finite"]) and bool(ref_aux["hyp_finite"])
    names = ("dsc0", "dsc1", "dustbin", "scr0", "scr1", "kps0", "depth0", "kps1", "depth1")
    for name, g, r in zip(names, grads, ref_g):
        np.testing.assert_allclose(g, np.asarray(r), atol=3e-5, rtol=2e-4, err_msg=name)


def test_partial_override_raises():
    args, Ks, Rgt, tgt, _, lc_t, idx, _ = _topk_loss_inputs()
    with pytest.raises(ValueError):
        _port_topk_loss(args, Ks, Rgt, tgt, lc_t, (torch.from_numpy(idx), None))


def test_topk_loss_samples_from_the_table():
    """Without an override the outer draws are table entries: the same seed
    gives the same draws, and every draw is in the top-P table."""
    args, Ks, Rgt, tgt, _, lc_t, _, _ = _topk_loss_inputs(seed=9)
    runs = [_port_topk_loss(args, Ks, Rgt, tgt, lc_t, None, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    idx = runs[0][1]["sampled_idx"]
    assert torch.equal(idx, runs[1][1]["sampled_idx"]) and torch.isfinite(runs[0][0])
    d0, d1, a, s0, s1 = (torch.tensor(x) for x in args[:5])
    table = fm.fused_topk_scores_train(d0, d1, s0[..., 0], s1[..., 0], a, 64, row_topl=8)[1]
    for b in range(idx.shape[0]):
        assert set(idx[b].reshape(-1).tolist()) <= set(table[b].tolist())


def test_topk_loss_gradients_match_the_dense_route():
    """The fused route's gradients equal the port's dense route's
    (``metric_pose_loss`` on dual_softmax x score product) on the same
    samples, w.r.t. every trainable input."""
    args, Ks, Rgt, tgt, _, lc_t, idx, ridx = _topk_loss_inputs(seed=10)
    draws = tuple(map(torch.from_numpy, (idx, ridx)))
    v_topk, _, g_topk = _port_topk_loss(args, Ks, Rgt, tgt, lc_t, draws)
    ts = [torch.tensor(x).requires_grad_(True) for x in args]
    d0, d1, a, s0, s1 = ts[:5]
    fs = dual_softmax(d0, d1, a, temperature=0.1) * s0 * s1.transpose(1, 2)
    total, _ = tloss.metric_pose_loss(fs, *ts[5:], *map(torch.from_numpy, Ks), torch.from_numpy(Rgt),
                                      torch.from_numpy(tgt), lc_t, 60.0, sample_override=draws)
    total.backward()
    np.testing.assert_allclose(v_topk.item(), total.item(), rtol=1e-5)
    names = ("dsc0", "dsc1", "dustbin", "scr0", "scr1", "kps0", "depth0", "kps1", "depth1")
    for name, g, t in zip(names, g_topk, ts):
        np.testing.assert_allclose(g, t.grad.numpy(), atol=3e-5, rtol=2e-4, err_msg=name)


# -- one whole staged step -------------------------------------------------------------


def test_fused_staged_step_matches_jax():
    """Loss and every gradient leaf of one staged step on the fused route,
    the JAX package's route in interpret mode (K2 and K6 as Pallas kernels)."""
    cfg_t = small_cfg(default_config())
    cfg_j = small_cfg(jax_default_config())
    for cfg in (cfg_t, cfg_j):
        cfg.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT = 50
        cfg.TPU.TRAIN_FUSED_TOPK = True
    cfg_j.TPU.PALLAS_INTERPRET = True
    params = init_params_numpy(cfg_t, 0)
    rng = np.random.default_rng(13)
    side = HW // 14
    fmap = rng.standard_normal((2 * B, side, side, 384)).astype(np.float32)
    batch = synthetic_batch(rng)
    gh = cfg_t.LOSS_CLASS.GENERATE_HYPOTHESES
    draws = inject_draws(rng, B, side, gh.IT_MATCHES, cfg_t.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES,
                         gh.IT_RANSAC, gh.NUM_CORR_3d3d)
    topk = 50.0

    trainable = jax.tree.map(jnp.asarray, {k: v for k, v in params.items() if k != "dinov2"})
    lc_j = jloss.LossConfig.from_cfg(cfg_j)
    T = jnp.asarray(batch["T_0to1"])

    def jax_loss(tr):
        corr, _ = jext.compute_correspondences_topk_train(tr, None, None, cfg_j, fmap=jnp.asarray(fmap))
        return jloss.metric_pose_loss_topk(
            (corr.top_scores, corr.top_idx, corr.row_ok, corr.lse_row, corr.lse_col),
            corr.dsc0, corr.dsc1, corr.scr0, corr.scr1, corr.kps0, corr.depth0, corr.kps1, corr.depth1,
            *(jnp.asarray(batch[k]) for k in ("K_color0", "K_color1", "Kori_color0", "Kori_color1")),
            T[:, :3, :3], T[:, :3, 3][:, None, :], jax.random.PRNGKey(0), lc_j, jnp.float32(topk),
            temperature=0.1, sample_override=tuple(map(jnp.asarray, draws)))

    ref_total, ref_aux = jax_loss(trainable)
    ref_grads = jax.grad(lambda tr: jax_loss(tr)[0])(trainable)

    state, _ = init_train_state(cfg_t, params_to_torch(params, cfg_t, "cpu"))
    step = StagedTrainStep(cfg_t)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    override = tuple(map(torch.from_numpy, draws))
    total, aux, _, grads = loss_and_grads(state.params, torch.from_numpy(fmap), tb, cfg_t, step.lc, topk,
                                          sample_override=override)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5)
    np.testing.assert_allclose(aux["avg_loss"].item(), float(ref_aux["avg_loss"]), rtol=1e-5)
    _tree_close(params_to_numpy(grads), jax.tree.map(np.asarray, ref_grads), "grads", 1e-2)
    _, metrics = step.grad_step(state, torch.from_numpy(fmap), tb, topk_pct=topk, sample_override=override)
    assert bool(metrics["grads_finite"]) and int(metrics["num_valid"]) == B


# -- K6 on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 45, 16), (3, 131, 200, 128)])
def test_lse_bwd_kernel_matches_plain(cuda, shape):
    """K6 against its plain version at ragged shapes, and the whole route's
    forward and backward against autograd of ``dense_lse`` (chip_smoke.py's
    checks and tolerances)."""
    b, m, n, c = shape
    tin = chip_smoke.train_kernel_inputs(cuda, pairs=b, kpts=max(m, n), desc=c)
    for k, rows in (("dsc0", m), ("dsc1", n), ("gr", m), ("gc", n), ("scr0", m), ("scr1", n)):
        tin[k] = tin[k][:, :rows].contiguous()
    tin["lse_col"] = fm.col_lse_plain(tin["dsc0"], tin["dsc1"], 10.0, 1.0)
    _, tin["lse_row"] = fm.pair_softmax_plain(tin["dsc0"], tin["dsc1"], tin["lse_col"], 10.0, 1.0)
    errs = chip_smoke.check_topk_train_kernels(tin, prefilter=64, topl=4)
    assert set(errs) == {"lse_bwd"}
