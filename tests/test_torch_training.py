"""The port's training step against mickey_tpu on the CPU.

Inputs and weights come from numpy with a fixed seed and go to both
packages; the draws of the loss are injected into both
(``sample_override``), since the two PRNG streams differ. The size is the
JAX package's own training-test size (``tests/test_training.py``): a
ViT-S-width feature map, heads 32-16-128-8, 126x126 images (9 x 9
keypoints, 3 x 3 inside the score head's border), it/R_it/S = 2/3/16, 5
points per minimal set, one refinement.

On the CPU the JAX package's ``match_scores`` takes its dense dual-softmax,
and so does the port's.

Tolerances, fp32 throughout with another summation order: values at 1e-5
relative. Gradients of the loss alone at 1e-4 of each leaf's largest entry.
Gradients of the whole step at 1e-2 of each leaf's largest entry: the step
is ill-conditioned at that level (train-mode BatchNorm over 8 maps, the
REINFORCE surrogate's cancelling terms): the JAX step's own gradients move
by 5e-4 of a leaf's largest entry when the feature map is scaled by
1 + 1e-6. Updated parameters: the port's optimizer applied to the port's
gradients equals optax's to 1e-6 relative, and every entry lies within 2 lr
of the JAX step's (Adam's first step moves an entry by at most lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mickey_tpu.config import default_config as jax_default_config
from mickey_tpu.geometry import kabsch as jkabsch
from mickey_tpu.geometry import projection as jproj
from mickey_tpu.nn import common as jcommon
from mickey_tpu.nn.extractor import compute_correspondences as jax_corr
from mickey_tpu.training import loss as jloss
from mickey_tpu.training import loss_utils as jlu
from mickey_tpu.training.train_step import _copy_bn_stats, make_optimizer
from mickey_tpu.training.train_step import make_lr_fn as jax_make_lr_fn
from mickey_tpu_torch.config import default_config
from mickey_tpu_torch.geometry import kabsch, projection
from mickey_tpu_torch.models import MicKeyTrainer
from mickey_tpu_torch.models import training_model
from mickey_tpu_torch.nn import common
from mickey_tpu_torch.training import loss as tloss
from mickey_tpu_torch.training import loss_utils as tlu
from mickey_tpu_torch.training.train_step import (
    Optimizer,
    StagedTrainStep,
    init_train_state,
    loss_and_grads,
)
from mickey_tpu_torch.weights import init_params_numpy, params_to_numpy, params_to_torch, tree_leaves

B, HW = 4, 126


def small_cfg(cfg):
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.DINOV2.FLOAT16 = False
    cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 128, 8]
    cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    gh.IT_MATCHES, gh.IT_RANSAC, gh.NUM_CORR_3d3d, gh.NUM_REF_STEPS = 2, 3, 5, 1
    cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES = 16
    return cfg


def _tree_close(ours, ref, what, tol):
    """Leaf by leaf: |a - b| <= tol * max|b| (+ 1e-12 for all-zero leaves)."""
    assert jax.tree.structure(ours) == jax.tree.structure(ref), what
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree.leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        err = np.abs(a - b).max() if a.size else 0.0
        assert err <= tol * np.abs(b).max() + 1e-12, (what, jax.tree_util.keystr(path), err, np.abs(b).max())


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)


def synthetic_batch(rng, b=B, hw=HW):
    T = np.zeros((b, 4, 4), np.float32)
    T[:, :3, :3] = _rotations(rng, b)
    T[:, :3, 3] = rng.normal(size=(b, 3)) * 0.3
    T[:, 3, 3] = 1
    K = np.zeros((b, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 100
    K[:, 0, 2] = K[:, 1, 2] = hw / 2
    K[:, 2, 2] = 1
    return {"T_0to1": T, "K_color0": K, "K_color1": K.copy(), "Kori_color0": K.copy(), "Kori_color1": K.copy()}


def inject_draws(rng, b, side, it, S, R_it, C, border=3):
    """Outer draws among interior keypoint pairs (nonzero final scores), and
    inner minimal sets of samples with distinct keypoints on both sides: a
    set that repeats a keypoint can have a rank-deficient covariance, whose
    rotation is arbitrary in either package."""
    inner = np.arange(border, side - border)
    cells = (inner[:, None] * side + inner[None, :]).reshape(-1)
    n = side * side
    pairs = (cells[:, None] * n + cells[None, :]).reshape(-1)
    idx = np.stack([[rng.choice(pairs, S, replace=False) for _ in range(it)] for _ in range(b)]).astype(np.int32)

    def minimal_set(draw):
        while True:
            chosen, rows, cols = [], set(), set()
            for s in rng.permutation(S):
                i, j = divmod(int(draw[s]), n)
                if i not in rows and j not in cols:
                    chosen.append(s)
                    rows.add(i)
                    cols.add(j)
                if len(chosen) == C:
                    return chosen

    ridx = np.array([[[minimal_set(idx[bb, i]) for _ in range(R_it)] for i in range(it)] for bb in range(b)],
                    np.int32)
    return idx, ridx


# -- geometry ------------------------------------------------------------------------


def _svd_cases():
    rng = np.random.default_rng(3)
    u = rng.standard_normal(3).astype(np.float32)
    return {
        "random": rng.standard_normal((6, 3, 3)).astype(np.float32),
        "zero": np.zeros((2, 3, 3), np.float32),
        "rank1": np.stack([np.outer(u, rng.standard_normal(3)) for _ in range(2)]).astype(np.float32),
        "near_equal": np.stack([np.diag([1.0, 1.0 + 1e-6, 0.5]) @ _rotations(rng, 1)[0]] * 2).astype(np.float32),
    }


@pytest.mark.parametrize("case", ["random", "zero", "rank1", "near_equal"])
def test_svd3x3_backward_matches_jax(case):
    """The regularized closed-form VJP against the JAX package's, including
    H = 0 (finite, not NaN) and rank-deficient H. End to end (jax.vjp of
    svd3x3 against autograd of the port's) where the SVD is unique; where it
    is not (rank 1, a repeated singular value) each package's Jacobi picks
    its own basis of the degenerate subspace, so both VJPs are applied to
    the JAX forward's (U, S, V)."""
    H = _svd_cases()[case]
    rng = np.random.default_rng(4)
    cot = [rng.standard_normal(s).astype(np.float32) for s in (H.shape, H.shape[:-1], H.shape)]
    res, vjp = jax.vjp(jkabsch.svd3x3, jnp.asarray(H))
    (ref,) = vjp(tuple(jnp.asarray(c) for c in cot))
    if case in ("random", "zero"):
        Ht = torch.from_numpy(H).requires_grad_(True)
        out = kabsch.svd3x3(Ht)
        for a, b in zip(out, res):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
        (g,) = torch.autograd.grad(out, Ht, [torch.from_numpy(c) for c in cot])
    else:
        g = kabsch.svd3x3_vjp(*(torch.from_numpy(np.array(x)) for x in res), *map(torch.from_numpy, cot))
    ref = np.asarray(ref)
    assert np.isfinite(g.numpy()).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-4 * max(np.abs(ref).max(), 1.0))


def test_weighted_procrustes_gradient_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 12, 3)).astype(np.float32)
    Bp = (A @ _rotations(rng, 1)[0].T + 0.1 + 0.05 * rng.standard_normal(A.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1, (3, 12)).astype(np.float32)

    def jf(a, b):
        sol = jkabsch.weighted_procrustes(a, b, w=jnp.asarray(w), use_weights=True, use_mask=True)
        return jnp.sum(sol.R * jnp.arange(9.0).reshape(3, 3)) + jnp.sum(sol.t)

    ref = jax.grad(jf, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(Bp))
    a, b = (torch.from_numpy(x).requires_grad_(True) for x in (A, Bp))
    sol = kabsch.weighted_procrustes(a, b, w=torch.from_numpy(w), use_weights=True, use_mask=True)
    (sol.R * torch.arange(9.0).reshape(3, 3)).sum().add(sol.t.sum()).backward()
    for g, r in zip((a.grad, b.grad), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5 * np.abs(np.asarray(r)).max())


def test_project_2d_and_pose_losses_match_jax():
    rng = np.random.default_rng(6)
    xyz = rng.uniform(-1, 1, (2, 7, 3)).astype(np.float32) + np.array([0, 0, 3], np.float32)
    K = synthetic_batch(rng, b=2)["K_color0"]
    np.testing.assert_allclose(projection.project_2d(torch.from_numpy(xyz), torch.from_numpy(K)).numpy(),
                               np.asarray(jproj.project_2d(jnp.asarray(xyz), jnp.asarray(K))), rtol=1e-6)
    R, Rgt = _rotations(rng, 5), _rotations(rng, 5)
    t, tgt = (rng.normal(size=(5, 1, 3)).astype(np.float32) for _ in range(2))
    Kb = np.tile(K[:1], (5, 1, 1))
    for name in ("compute_pose_loss", "compute_vcre_loss"):
        ours = getattr(tlu, name)(*(torch.from_numpy(x) for x in (R, t, Rgt, tgt, Kb, Kb)))
        ref = getattr(jlu, name)(*(jnp.asarray(x) for x in (R, t, Rgt, tgt, Kb, Kb)))
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)


# -- train-mode BatchNorm ------------------------------------------------------------


def test_train_batchnorm_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 5, 6, 8)).astype(np.float32) * 3 + 1
    p = {"scale": rng.uniform(0.5, 2, 8), "bias": rng.normal(size=8), "mean": rng.normal(size=8),
         "var": rng.uniform(0.5, 2, 8)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ref_out, ref_p = jcommon.batchnorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), train=True)
    out, new_p = common.batchnorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_p[k].numpy(), np.asarray(ref_p[k]), rtol=1e-5, err_msg=k)
    eval_out, same = common.batchnorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    assert same["mean"] is not None and torch.equal(same["var"], torch.from_numpy(p["var"]))
    ref_eval, _ = jcommon.batchnorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(eval_out.numpy(), np.asarray(ref_eval), rtol=1e-5, atol=1e-5)


# -- the loss --------------------------------------------------------------------------


def _loss_inputs(seed=8, b=3, side=6):
    rng = np.random.default_rng(seed)
    n = side * side
    fs = rng.uniform(0, 1, (b, n, n)).astype(np.float32) ** 4
    fs /= fs.sum(axis=(1, 2), keepdims=True)
    grid = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="xy"), -1).reshape(n, 2) * 14.0 + 7
    kps0 = np.tile(grid, (b, 1, 1)).astype(np.float32) + rng.normal(0, 1, (b, n, 2)).astype(np.float32)
    kps1 = kps0 + rng.normal(0, 2, (b, n, 2)).astype(np.float32)
    d0, d1 = (rng.uniform(2, 4, (b, n, 1)).astype(np.float32) for _ in range(2))
    batch = synthetic_batch(rng, b=b, hw=side * 14)
    T = batch["T_0to1"]
    return fs, kps0, d0, kps1, d1, batch, T[:, :3, :3], T[:, :3, 3][:, None, :], rng


def test_metric_pose_loss_matches_jax():
    """Loss, aux and gradients w.r.t. final scores, keypoints and depths with
    the same injected outer and inner draws."""
    cfg = small_cfg(jax_default_config())
    cfg.LOSS_CLASS.GENERATE_HYPOTHESES.NUM_REF_STEPS = 3
    lc_j = jloss.LossConfig.from_cfg(cfg)
    lc_t = tloss.LossConfig.from_cfg(small_cfg(default_config()))._replace(num_ref_steps=3)
    assert tuple(lc_t) == tuple(lc_j)
    fs, kps0, d0, kps1, d1, batch, Rgt, tgt, rng = _loss_inputs()
    idx, ridx = inject_draws(rng, 3, 6, lc_j.it_matches, lc_j.num_samples_matches, lc_j.it_ransac,
                             lc_j.num_corr, border=0)
    Ks = [batch[k] for k in ("K_color0", "K_color1", "Kori_color0", "Kori_color1")]

    def jf(fs_, k0, dd0, k1, dd1):
        return jloss.metric_pose_loss(fs_, k0, dd0, k1, dd1, *map(jnp.asarray, Ks), jnp.asarray(Rgt),
                                      jnp.asarray(tgt), jax.random.PRNGKey(0), lc_j, jnp.float32(50.0),
                                      sample_override=(jnp.asarray(idx), jnp.asarray(ridx)))

    (ref, ref_aux), ref_g = jax.value_and_grad(jf, argnums=tuple(range(5)), has_aux=True)(
        *map(jnp.asarray, (fs, kps0, d0, kps1, d1)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (fs, kps0, d0, kps1, d1)]
    total, aux = tloss.metric_pose_loss(*ts, *map(torch.from_numpy, Ks), torch.from_numpy(Rgt),
                                        torch.from_numpy(tgt), lc_t, 50.0,
                                        sample_override=(torch.from_numpy(idx), torch.from_numpy(ridx)))
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    for k in ("avg_loss", "avg_loss_rot", "avg_loss_trans", "baseline", "mask_topk", "num_valid", "loss_value"):
        np.testing.assert_allclose(np.asarray(aux[k]), np.asarray(ref_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert bool(aux["hyp_finite"]) and bool(ref_aux["hyp_finite"])
    for name, t, r in zip(("final_scores", "kps0", "depth0", "kps1", "depth1"), ts, ref_g):
        r = np.asarray(r)
        assert np.abs(t.grad.numpy() - r).max() <= 1e-4 * np.abs(r).max(), name


def test_metric_pose_loss_samples_with_a_generator():
    """Without an override the draws come from the generator: the same seed
    gives the same draws, the sampled matches have nonzero scores."""
    lc = tloss.LossConfig.from_cfg(small_cfg(default_config()))._replace(prefilter=64)
    fs, kps0, d0, kps1, d1, batch, Rgt, tgt, _ = _loss_inputs(seed=9)
    fs[:, :, :10] = 0.0
    args = [torch.from_numpy(x) for x in (fs, kps0, d0, kps1, d1)] + \
        [torch.from_numpy(batch[k]) for k in ("K_color0", "K_color1", "Kori_color0", "Kori_color1")] + \
        [torch.from_numpy(Rgt), torch.from_numpy(tgt), lc, 30.0]
    runs = [tloss.metric_pose_loss(*args, generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    assert torch.equal(runs[0][1]["sampled_idx"], runs[1][1]["sampled_idx"])
    idx = runs[0][1]["sampled_idx"]
    assert (idx % fs.shape[2] >= 10).all() and torch.isfinite(runs[0][0])


# -- the optimizer -----------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 1e3])  # below and above the clip norm of 5
def test_optimizer_matches_optax(scale):
    cfg = default_config()
    rng = np.random.default_rng(10)
    params = [np.asarray(rng.standard_normal(s), np.float32) for s in ((3, 4), (5,), ())]
    opt_j = make_optimizer(jax_default_config())
    pj = [jnp.asarray(p) for p in params]
    st = opt_j.init(pj)
    pt = [torch.from_numpy(p.copy()) for p in params]
    opt_t = Optimizer(cfg)
    st_t = opt_t.init(pt)
    for step in range(3):
        grads = [np.asarray(rng.standard_normal(p.shape) * scale, np.float32) for p in params]
        upd, st = opt_j.update([jnp.asarray(g) for g in grads], st, pj)
        pj = optax.apply_updates(pj, upd)
        gnorm = opt_t.update(pt, [torch.from_numpy(g) for g in grads], st_t)
        np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_non_finite_gradient_skips_the_whole_step():
    cfg = default_config()
    pt = [torch.ones(3), torch.zeros(2)]
    opt = Optimizer(cfg)
    st = opt.init(pt)
    opt.update(pt, [torch.ones(3), torch.ones(2)], st)
    before = [p.clone() for p in pt], [m.clone() for m in st.mu], [v.clone() for v in st.nu], st.count.clone()
    gnorm = opt.update(pt, [torch.tensor([1.0, float("nan"), 1.0]), torch.ones(2)], st)
    assert not torch.isfinite(gnorm)
    for a, b in zip(before[0] + before[1] + before[2], pt + st.mu + st.nu):
        assert torch.equal(a, b)
    assert int(st.count) == int(before[3]) == 1


def _schedule_count(opt_state) -> int:
    """The step optax's learning-rate schedule reads: the count of the
    ``ScaleByScheduleState`` inside ``apply_if_finite``'s inner chain."""
    found = [x for x in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
             if isinstance(x, optax.ScaleByScheduleState)]
    assert len(found) == 1
    return int(found[0].count)


def test_lr_staircase_skips_non_finite_steps():
    """A StepLR staircase (interval 2, gamma 0.5) over six steps, the second
    with a non-finite gradient: the port's learning rate and parameters step
    by step against optax's ``make_optimizer`` on the same gradients. The
    skipped step advances neither schedule: lr index 0, 0, 0, 1, 1, 2."""
    cfg, cfg_j = default_config(), jax_default_config()
    for c in (cfg, cfg_j):
        c.TRAINING.LR_STEP_INTERVAL, c.TRAINING.LR_STEP_GAMMA = 2, 0.5
    rng = np.random.default_rng(13)
    params = [np.asarray(rng.standard_normal(s), np.float32) for s in ((3, 4), (5,))]
    opt_j, lr_j = make_optimizer(cfg_j), jax_make_lr_fn(cfg_j)
    pj = [jnp.asarray(p) for p in params]
    st = opt_j.init(pj)
    pt = [torch.from_numpy(p.copy()) for p in params]
    opt_t = Optimizer(cfg)
    st_t = opt_t.init(pt)
    lrs = []
    for step in range(6):
        grads = [np.asarray(rng.standard_normal(p.shape) * 1e-3, np.float32) for p in params]
        if step == 1:
            grads[0][1, 2] = np.nan
        lr = float(opt_t.lr_fn(st_t.count))
        np.testing.assert_allclose(lr, float(lr_j(_schedule_count(st))), rtol=1e-6)
        lrs.append(lr)
        upd, st = opt_j.update([jnp.asarray(g) for g in grads], st, pj)
        pj = optax.apply_updates(pj, upd)
        opt_t.update(pt, [torch.from_numpy(g) for g in grads], st_t)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    base = cfg.TRAINING.LR
    np.testing.assert_allclose(lrs, [base, base, base, base / 2, base / 2, base / 4], rtol=1e-6)


def test_trainer_bootstraps_the_dinov2_backbone(monkeypatch, tmp_path):
    """``MicKeyTrainer(params=None)`` with the ViT-L variant converts the
    DINOv2 file that ``resolve_dinov2_weights`` finds (given the
    ``dinov2_path`` argument) into its frozen backbone, bitwise; without a
    file it keeps the random one, and another variant never looks. At a
    small size: the random init is the small config's ViT-S tree, and the
    file a synthetic ViT-S state dict (``chip_smoke.upstream_state_dicts``)
    of other weights."""
    import chip_smoke

    cfg = small_cfg(default_config())
    small = init_params_numpy(cfg, 0)
    other = init_params_numpy(cfg, 1)
    _, dino = chip_smoke.upstream_state_dicts(other)
    pth = tmp_path / "dinov2_vitl14_pretrain.pth"
    torch.save(dino, pth)
    asked = []

    def resolve(path=None):
        asked.append(path)
        return str(pth) if path == "given" else None

    monkeypatch.setattr(training_model, "init_params_numpy", lambda c, seed: dict(small))
    monkeypatch.setattr(training_model, "resolve_dinov2_weights", resolve)

    def backbone_leaves(params):
        return [t for _, t in tree_leaves(init_train_state(cfg, params_to_torch(params, cfg, "cpu"))[1])]

    cfg.MICKEY.DINOV2.VARIANT = "vit_large"  # the variant the trainer bootstraps
    loaded = MicKeyTrainer(cfg, device="cpu", dinov2_path="given")
    want = backbone_leaves(dict(small, dinov2=other["dinov2"]))
    got = [t for _, t in tree_leaves(loaded.backbone)]
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    fallback = MicKeyTrainer(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip((t for _, t in tree_leaves(fallback.backbone)), backbone_leaves(small)))
    assert asked == ["given", None]
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    MicKeyTrainer(cfg, device="cpu", dinov2_path="given")
    assert asked == ["given", None]


# -- one whole staged step -------------------------------------------------------------


@pytest.fixture(scope="module")
def step_setup():
    cfg_t = small_cfg(default_config())
    cfg_t.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT = 50
    cfg_j = small_cfg(jax_default_config())
    params = init_params_numpy(cfg_t, 0)
    rng = np.random.default_rng(11)
    side = HW // 14
    fmap = rng.standard_normal((2 * B, side, side, 384)).astype(np.float32)
    batch = synthetic_batch(rng)
    gh = cfg_t.LOSS_CLASS.GENERATE_HYPOTHESES
    draws = inject_draws(rng, B, side, gh.IT_MATCHES, cfg_t.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES,
                         gh.IT_RANSAC, gh.NUM_CORR_3d3d)
    return cfg_t, cfg_j, params, fmap, batch, draws


def _jax_step(cfg_j, params, fmap, batch, draws, topk):
    trainable = jax.tree.map(jnp.asarray, {k: v for k, v in params.items() if k != "dinov2"})
    lc = jloss.LossConfig.from_cfg(cfg_j)
    T = jnp.asarray(batch["T_0to1"])

    def loss_fn(tr):
        corr, new_tr = jax_corr(tr, None, None, cfg_j, train=True, fmap=jnp.asarray(fmap))
        total, aux = jloss.metric_pose_loss(
            corr.final_scores, corr.kps0, corr.depth0, corr.kps1, corr.depth1,
            *(jnp.asarray(batch[k]) for k in ("K_color0", "K_color1", "Kori_color0", "Kori_color1")),
            T[:, :3, :3], T[:, :3, 3][:, None, :], jax.random.PRNGKey(0), lc, jnp.float32(topk),
            sample_override=tuple(map(jnp.asarray, draws)))
        return total, (aux, new_tr)

    (total, (aux, fwd)), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
    opt = make_optimizer(cfg_j)
    upd, _ = opt.update(grads, opt.init(trainable), trainable)
    new = _copy_bn_stats(optax.apply_updates(trainable, upd), fwd)
    return float(total), aux, jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new)


def test_staged_step_matches_jax(step_setup):
    """Loss, every gradient leaf, the updated parameters and BN stats of one
    staged step on the same feature map and draws."""
    cfg_t, cfg_j, params, fmap, batch, draws = step_setup
    topk = float(cfg_t.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT)
    ref_total, ref_aux, ref_grads, ref_new = _jax_step(cfg_j, params, fmap, batch, draws, topk)

    state, _ = init_train_state(cfg_t, params_to_torch(params, cfg_t, "cpu"))
    step = StagedTrainStep(cfg_t)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    override = tuple(map(torch.from_numpy, draws))
    total, aux, _, grads = loss_and_grads(state.params, torch.from_numpy(fmap), tb, cfg_t, step.lc, topk,
                                          sample_override=override)
    np.testing.assert_allclose(total.item(), ref_total, rtol=1e-5)
    np.testing.assert_allclose(aux["avg_loss"].item(), float(ref_aux["avg_loss"]), rtol=1e-5)
    _tree_close(params_to_numpy(grads), ref_grads, "grads", 1e-2)

    _, metrics = step.grad_step(state, torch.from_numpy(fmap), tb, topk_pct=topk, sample_override=override)
    assert bool(metrics["grads_finite"]) and int(metrics["num_valid"]) == B
    new = params_to_numpy(state.params)
    assert jax.tree.structure(new) == jax.tree.structure(ref_new)
    # optax's update applied to the port's own gradients: the port's optimizer, exactly
    ours_g = params_to_numpy(grads)
    opt = make_optimizer(cfg_j)
    start = jax.tree.map(jnp.asarray, {k: v for k, v in params.items() if k != "dinov2"})
    upd, _ = opt.update(jax.tree.map(jnp.asarray, ours_g), opt.init(start), start)
    expect = optax.apply_updates(start, upd)
    lr = cfg_t.TRAINING.LR
    for (path, a), e, b in zip(jax.tree_util.tree_leaves_with_path(new), jax.tree.leaves(expect),
                               jax.tree.leaves(ref_new)):
        key = jax.tree_util.keystr(path)
        if key.endswith("['mean']") or key.endswith("['var']"):  # advanced by the forward, not the optimizer
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=key)
            continue
        np.testing.assert_allclose(a, np.asarray(e), rtol=1e-6, atol=1e-9, err_msg=key)
        # and against the JAX step: Adam's first step moves an entry by at most lr
        assert np.abs(a - b).max() <= 2 * lr, key


def test_trainer_curriculum_and_steps(step_setup):
    """The trainer on the CPU: topk starts at TOPK_INIT, grows by 5 per epoch
    up to TOPK, and a step updates the trainables but not the backbone."""
    cfg_t, _, params, _, batch, _ = step_setup
    p = dict(params)
    p["dinov2"] = dict(params["dinov2"], blocks={k: (v[:1] if not isinstance(v, dict) else
                                                     jax.tree.map(lambda a: a[:1], v))
                                                 for k, v in params["dinov2"]["blocks"].items()})
    tr = MicKeyTrainer(cfg_t, params=p, device="cpu")
    assert tr.topk == 50.0 and tr.topk_max == 80.0
    for _ in range(10):
        tr.on_train_epoch_end()
    assert tr.topk == 80.0
    rng = np.random.default_rng(12)
    b = dict(batch, image0=rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32),
             image1=rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32))
    w0 = tr.state.params["det_head"]["out"]["w"].detach().clone()
    bb0 = tr.backbone["blocks"][0]["mlp"]["fc1"]["w"].clone()
    m = tr.training_step(b)
    assert np.isfinite(m["loss"]) and m["grads_finite"] == 1.0 and m["num_valid"] == B
    assert not torch.equal(w0, tr.state.params["det_head"]["out"]["w"])
    assert torch.equal(bb0, tr.backbone["blocks"][0]["mlp"]["fc1"]["w"])
