"""bf16 conv compute in the keypoint heads (``TPU.HEADS_BF16``) against
mickey_tpu on the CPU.

Under the mode the heads' block convs round their operands, x and the
weights, to bf16 (to nearest even, as JAX's ``astype``) and keep fp32 sums
and outputs; on a CPU device only with ``TPU.HEADS_BF16_ON_CPU`` as well.
Weights come from numpy (``init_params_numpy``) and go to both packages; the
size is ``test_torch_model``'s (ViT-S-width feature maps, heads 32-16-16-8,
a 12 x 14 grid), the training step ``test_torch_training``'s.

Tolerances. One conv under the mode at 1e-5 relative (entrywise, plus
1e-6 of the largest): both packages multiply the same bf16 values exactly
and sum in fp32 in another order. A block and the heads: each conv rounds
its input to bf16 again, and its input differs between the packages in the
last fp32 bits, so where a value lies on a rounding boundary the two round
it to neighbouring bf16 values (a step of 2^-8 relative) and its
neighbours move with it. A block (one such rounding) is held at 1e-5
normwise (||a - b|| / ||b||). A head (seven) is held to JAX's own spread:
within twice the normwise distance by which JAX's output moves when its
input feature map is scaled by 1 +- 2^-22 (an fp32 rounding of it), which
at this size is several times smaller than the mode's own move of the
outputs off the fp32 heads; the training loss likewise.

The JAX package cannot differentiate its heads under the mode here: the
transpose of its mixed-dtype conv raises (bf16 operand, fp32 cotangent). So
the small training step's loss is held against JAX's forward under the mode
(within twice JAX's spread), the backward rule conv by conv exactly, and the
heads' gradients in train mode, for fixed cotangents of their four outputs,
against the same mode computed in fp64 (the same roundings). Those are
ill-conditioned: a rounding flip moves a train-mode BatchNorm's cancelling
sums, so at this size single leaves of the fp32 and fp64 runs part by up to
0.16 normwise and the whole gradient by 0.082 (0.17 from the fp32 heads');
the per-leaf 5e-2 rule of the fp32 path cannot hold, and the whole gradient
is held within 0.2 of fp64, nearer it than to the fp32 heads' gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.config import default_config as jax_default_config
from mickey_tpu.nn import extractor as jext
from mickey_tpu.nn import heads as jheads
from mickey_tpu.nn.extractor import compute_correspondences as jax_corr
from mickey_tpu.training import loss as jloss
from mickey_tpu_torch.config import default_config
from mickey_tpu_torch.nn import common, extractor, heads
from mickey_tpu_torch.training.train_step import StagedTrainStep, init_train_state, loss_and_grads
from mickey_tpu_torch.weights import init_params_numpy, params_to_numpy, params_to_torch
from test_torch_training import B as STEP_B
from test_torch_training import HW, inject_draws, synthetic_batch
from test_torch_training import small_cfg as step_cfg


def _cfgs(on: bool = True, on_cpu: bool = True):
    out = []
    for cfg in (default_config(), jax_default_config()):
        cfg.MICKEY.DINOV2.VARIANT = "vit_small"
        cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
        cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 16, 8]
        cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
        cfg.TPU.HEADS_BF16 = on
        cfg.TPU.HEADS_BF16_ON_CPU = on_cpu
        out.append(cfg)
    return out


HEADS = {"det_head": (heads.det_head_apply, jheads.det_head_apply),
         "det_offset": (heads.offset_head_apply, jheads.offset_head_apply),
         "depth_head": (heads.depth_head_apply, jheads.depth_head_apply),
         "dsc_head": (heads.desc_head_apply, jheads.desc_head_apply)}


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _spread(fn, fmap, ref) -> float:
    """How far ``fn``'s output moves, normwise from ``ref``, when the feature
    map is scaled by 1 + 2^-22 or 1 - 2^-22: the reach of an fp32 rounding
    through the mode's bf16 roundings."""
    return max(_spreads(fn, fmap, (ref,)))


def _spreads(fn, fmap, refs) -> list:
    """``_spread`` of each output of a tuple-valued ``fn``."""
    moved = [fn(fmap * np.float32(1 + e)) for e in (2.0 ** -22, -(2.0 ** -22))]
    moved = [m if isinstance(m, tuple) else (m,) for m in moved]
    return [max(_norm_rel(np.asarray(m[i]), r) for m in moved) for i, r in enumerate(refs)]


@pytest.fixture(scope="module")
def params():
    return init_params_numpy(_cfgs()[0], 0)


@pytest.fixture(scope="module")
def fmap():
    return np.random.default_rng(5).standard_normal((2, 12, 14, 384)).astype(np.float32)


@pytest.mark.parametrize("on,on_cpu", [(False, False), (False, True), (True, False), (True, True)])
def test_dtype_gate_follows_jax(on, on_cpu):
    """bf16 only under HEADS_BF16; on a CPU device only with HEADS_BF16_ON_CPU
    too (JAX: on its CPU backend); on the card under HEADS_BF16 alone."""
    cfg, cfg_j = _cfgs(on, on_cpu)
    ref = jheads.heads_conv_dtype(cfg_j)
    got = heads.heads_conv_dtype(cfg, torch.device("cpu"))
    assert (got is None) == (ref is None) and (got is None or got == torch.bfloat16)
    assert heads.heads_conv_dtype(cfg, torch.device("cuda")) == (torch.bfloat16 if on else None)


@pytest.mark.parametrize("cin,cout,k", [(384, 32, 3), (32, 32, 3), (384, 32, 1), (16, 8, 3)])
def test_rounded_conv_matches_jax(cin, cout, k):
    """One conv under the mode against JAX's ``conv2d(compute_dtype=bf16)``:
    fp32 out, 1e-5 relative; the fp32 conv of the rounded operands, exactly;
    and ``rounded_convs_plain`` (a card-only switch) changes nothing here."""
    rng = np.random.default_rng(cin + cout + k)
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(cin * k * k)).astype(np.float32)
    from mickey_tpu.nn.common import conv2d as jconv2d
    ref = np.asarray(jconv2d({"w": jnp.asarray(w)}, jnp.asarray(x), compute_dtype=jnp.bfloat16))
    p = {"w": torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()}
    out = common.conv2d(p, torch.from_numpy(x), torch.bfloat16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    want = common.conv2d({"w": p["w"].to(torch.bfloat16).float()}, torch.from_numpy(x).to(torch.bfloat16).float())
    assert torch.equal(out, want)
    with common.rounded_convs_plain():
        assert torch.equal(common.conv2d(p, torch.from_numpy(x), torch.bfloat16), out)
    assert _norm_rel(out.numpy(), np.asarray(jconv2d({"w": jnp.asarray(w)}, jnp.asarray(x)))) > 1e-4


def test_basic_block_matches_jax_under_the_mode(params, fmap):
    """A pre-activation block with a shortcut under the mode, eval mode:
    1e-5 normwise of JAX's."""
    cfg = _cfgs()[0]
    tp = params_to_torch(params, cfg)
    out, _ = heads.basic_block_apply(tp["det_head"]["resblock1"], torch.from_numpy(fmap), compute_dtype=torch.bfloat16)
    ref, _ = jheads.basic_block_apply(jax.tree.map(jnp.asarray, params["det_head"]["resblock1"]), jnp.asarray(fmap),
                                      compute_dtype=jnp.bfloat16)
    assert _norm_rel(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("name", sorted(HEADS))
def test_four_heads_match_jax_under_the_mode(params, fmap, name):
    """Each head in eval mode against JAX's under HEADS_BF16_ON_CPU: fp32
    outputs within twice JAX's own spread (module docstring), the BN stats
    handed back untouched; and the mode moves them off the fp32 head."""
    cfg, cfg_j = _cfgs()
    tp = params_to_torch(params, cfg)
    apply, japply = HEADS[name]
    jp = jax.tree.map(jnp.asarray, params[name])
    jfn = lambda x: japply(jp, jnp.asarray(x), cfg_j)[0]  # noqa: E731
    out, new_p = apply(tp[name], torch.from_numpy(fmap), cfg)
    ref = np.asarray(jfn(fmap))
    assert out.dtype == torch.float32
    assert _norm_rel(out.numpy(), ref) <= 2 * _spread(jfn, fmap, ref)
    for blk in ("resblock1", "resblock2", "resblock3", "resblock4"):
        for bn in ("bn1", "bn2"):
            for k in ("mean", "var"):
                assert new_p[blk][bn][k] is tp[name][blk][bn][k]
    f32, _ = apply(tp[name], torch.from_numpy(fmap), _cfgs(on=False)[0])
    assert _norm_rel(out.numpy(), f32.numpy()) > 0


def test_heads_apply_under_the_mode(params, fmap):
    """``heads_apply`` (the serving stage) under the mode against JAX's,
    each output within twice JAX's own spread; off the CPU switch it is the
    fp32 stage."""
    cfg, cfg_j = _cfgs()
    tp = params_to_torch(params, cfg)
    jp = jax.tree.map(jnp.asarray, params)
    out, _ = extractor.heads_apply(tp, torch.from_numpy(fmap), cfg)
    jfn = jax.jit(lambda x: tuple(jext.heads_apply(jp, x, cfg_j, train=False)[0]))
    refs = [np.asarray(r) for r in jfn(fmap)]
    for name, a, r, spread in zip(("kpts", "depths", "scores", "descs"), out, refs, _spreads(jfn, fmap, refs)):
        assert _norm_rel(a.numpy(), r) <= 2 * spread, name
    off, _ = extractor.heads_apply(tp, torch.from_numpy(fmap), _cfgs(on=True, on_cpu=False)[0])
    plain, _ = extractor.heads_apply(tp, torch.from_numpy(fmap), _cfgs(on=False)[0])
    assert all(torch.equal(a, b) for a, b in zip(off, plain))


def test_gradients_flow_through_the_rounding():
    """As through JAX's cast: the conv's input and weight gradients are the
    fp32 conv's at the rounded operands, rounded to bf16 on their way back."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, 8)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((4, 8, 3, 3)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((2, 5, 6, 4)).astype(np.float32))
    (common.conv2d({"w": w}, x, torch.bfloat16) * g).sum().backward()
    xr, wr = (t.detach().to(torch.bfloat16).float().requires_grad_(True) for t in (x, w))
    (common.conv2d({"w": wr}, xr) * g).sum().backward()
    assert torch.equal(x.grad, xr.grad.to(torch.bfloat16).float())
    assert torch.equal(w.grad, wr.grad.to(torch.bfloat16).float())


def _jax_forward_loss(cfg_j, params, fmap, batch, draws, topk) -> float:
    """The JAX training step's loss alone (``test_torch_training._jax_step``
    without its gradient), traceable."""
    trainable = jax.tree.map(jnp.asarray, {k: v for k, v in params.items() if k != "dinov2"})
    corr, _ = jax_corr(trainable, None, None, cfg_j, train=True, fmap=jnp.asarray(fmap))
    T = jnp.asarray(batch["T_0to1"])
    total, _ = jloss.metric_pose_loss(
        corr.final_scores, corr.kps0, corr.depth0, corr.kps1, corr.depth1,
        *(jnp.asarray(batch[k]) for k in ("K_color0", "K_color1", "Kori_color0", "Kori_color1")),
        T[:, :3, :3], T[:, :3, 3][:, None, :], jax.random.PRNGKey(0), jloss.LossConfig.from_cfg(cfg_j),
        jnp.float32(topk), sample_override=tuple(map(jnp.asarray, draws)))
    return total


def test_staged_step_under_the_mode():
    """One small staged training step under HEADS_BF16_ON_CPU at
    ``test_torch_training``'s size with its injected draws: the loss within
    twice JAX's own spread of JAX's forward under the mode (and within
    1e-2); its gradient finite and not the fp32 step's (JAX's under the mode
    raises, ``test_heads_gradients_under_the_mode``, which holds the heads'
    gradients)."""
    cfg_t, cfg_j = step_cfg(default_config()), step_cfg(jax_default_config())
    cfg_t32 = step_cfg(default_config())
    for c in (cfg_t, cfg_j):
        c.TPU.HEADS_BF16 = c.TPU.HEADS_BF16_ON_CPU = True
    params = init_params_numpy(cfg_t, 0)
    rng = np.random.default_rng(11)
    side = HW // 14
    fmap = rng.standard_normal((2 * STEP_B, side, side, 384)).astype(np.float32)
    batch = synthetic_batch(rng)
    gh = cfg_t.LOSS_CLASS.GENERATE_HYPOTHESES
    draws = inject_draws(rng, STEP_B, side, gh.IT_MATCHES, cfg_t.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES,
                         gh.IT_RANSAC, gh.NUM_CORR_3d3d)
    topk = 50.0
    jitted = jax.jit(lambda x: _jax_forward_loss(cfg_j, params, x, batch, draws, topk))
    jloss_fn = lambda x: float(jitted(x))  # noqa: E731
    ref_total = jloss_fn(fmap)
    spread = _spread(jloss_fn, fmap, ref_total)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for name, cfg in (("mode", cfg_t), ("fp32", cfg_t32)):
        state, _ = init_train_state(cfg, params_to_torch(params, cfg, "cpu"))
        runs[name] = loss_and_grads(state.params, torch.from_numpy(fmap), tb, cfg, StagedTrainStep(cfg).lc, topk,
                                    sample_override=tuple(map(torch.from_numpy, draws)))
    assert _norm_rel(runs["mode"][0].item(), ref_total) <= min(2 * spread, 1e-2)
    ours, fp32 = (jax.tree.leaves(params_to_numpy(runs[k][3])) for k in ("mode", "fp32"))
    assert all(np.isfinite(a).all() for a in ours)
    assert any(not np.array_equal(a, b) for a, b in zip(ours, fp32))


def test_heads_gradients_under_the_mode(params, fmap):
    """The four heads in train mode under the mode, for fixed seeded
    cotangents of their outputs: the whole gradient finite, within 0.2
    normwise of the same mode computed in fp64 (the same roundings to bf16;
    JAX's under the mode raises; module docstring) and nearer it than to the
    fp32 heads' gradient."""
    cfg, cfg_j = _cfgs()
    rng = np.random.default_rng(9)
    cots = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((2, 12, 14, 2), (2, 12, 14, 1), (2, 12, 14, 1), (2, 12, 14, 16))]
    with pytest.raises(TypeError):
        jax.grad(lambda tr: sum(jnp.sum(o * jnp.asarray(g)) for o, g in zip(
            jext.heads_apply(tr, jnp.asarray(fmap), cfg_j, train=True)[0], cots)))(jax.tree.map(jnp.asarray, params))

    def port_grads(c, dtype):
        tp = params_to_torch(params, c)
        flat = [(path, t) for path, t in _torch_leaves({k: tp[k] for k in HEADS})]
        for path, t in flat:
            _set(tp, path, t.to(dtype).requires_grad_(True))
        outs, _ = extractor.heads_apply(tp, torch.from_numpy(fmap).to(dtype), c, train=True)
        sum((o * torch.from_numpy(g).to(dtype)).sum() for o, g in zip(outs, cots)).backward()
        return {path: _get(tp, path).grad for path, _ in flat}

    ours, exact = port_grads(cfg, torch.float32), port_grads(cfg, torch.float64)
    fp32 = port_grads(_cfgs(on=False)[0], torch.float32)
    worst = [path for path, g in ours.items() if g is not None and float(exact[path].norm()) > 0]
    cat = lambda d: np.concatenate([d[p].double().numpy().ravel() for p in worst])  # noqa: E731
    assert len(worst) > 200 and np.isfinite(cat(ours)).all()
    to_exact = _norm_rel(cat(ours), cat(exact))
    assert to_exact < 0.2 and to_exact < _norm_rel(cat(ours), cat(fp32))


def _torch_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _torch_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _torch_leaves(v, path + (i,))
    elif torch.is_tensor(tree):
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value

