"""The backbone and head variants the serving path did not use before,
against mickey_tpu on the CPU: the SwiGLU ViT (DINOv2 ViT-g/14's FFN), the
head transformer's cross and softmax attention (``self_cross_transformer``,
``full_attention``), ``soft_inlier_counting_2d`` and ``quat2mat_torch``.

Weights and inputs come from numpy with a fixed seed and go to both
packages. The ViT is ViT-S width cut to 2 blocks at 28 to 126 pixels.

Tolerances: fp32 throughout; the two frameworks sum and fuse in different
orders, so agreement is to a few fp32 ulps scaled by the depth of the
computation: 1e-4 on the ViT's O(1) LayerNorm outputs (as
``test_torch_model``), 1e-5 relative and 1e-6 of the largest entry on the
head transformers' outputs and the soft inlier counts, 1e-6 on rotation
matrices (entries of magnitude <= 1). Converted weights bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mickey_tpu.geometry import inliers as jinliers
from mickey_tpu.geometry.rotations import quat2mat_jax
from mickey_tpu.nn import dinov2 as jdinov2
from mickey_tpu.nn import linear_attention as jla
from mickey_tpu.training.checkpoint import convert_dinov2_state_dict as jax_convert_dinov2
from mickey_tpu_torch import geometry
from mickey_tpu_torch.nn import dinov2, linear_attention
from mickey_tpu_torch.training.checkpoint import convert_dinov2_state_dict
from mickey_tpu_torch.weights import _vit_init, init_params_numpy, params_to_torch, self_cross_transformer_init
from test_torch_slice import small_cfg

T = torch.from_numpy


def _close(out, ref, rtol=1e-5):
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=1e-6 * np.abs(ref).max())


@pytest.fixture(scope="module")
def swiglu_vit():
    vit = _vit_init(np.random.default_rng(0), "vit_small", ffn_layer="swiglufused")
    vit["blocks"] = jax.tree.map(lambda a: a[:2], vit["blocks"])
    return vit


def _port_vit(vit):
    cfg = small_cfg()
    heads = {k: v for k, v in init_params_numpy(cfg, 0).items() if k != "dinov2"}
    return params_to_torch({**heads, "dinov2": vit}, cfg)["dinov2"]


def test_swiglu_hidden_dim_and_init_layout():
    assert dinov2.swiglu_hidden_dim(1536) == jdinov2.swiglu_hidden_dim(1536) == 4096
    assert dinov2.swiglu_hidden_dim(384) == jdinov2.swiglu_hidden_dim(384) == 1024
    for ffn in ("mlp", "swiglu", "swiglufused"):
        ours = _vit_init(np.random.default_rng(0), "vit_small", ffn_layer=ffn)
        ref = jax.eval_shape(lambda k: jdinov2.vit_init(k, "vit_small", ffn_layer=ffn), jax.random.PRNGKey(0))
        assert jax.tree.structure(ours) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            assert np.shape(a) == b.shape and np.asarray(a).dtype == b.dtype
    with pytest.raises(NotImplementedError):
        _vit_init(np.random.default_rng(0), "vit_small", ffn_layer="moe")


@pytest.mark.parametrize("hw", [(28, 28), (42, 126), (126, 56)])
def test_swiglu_vit_matches_jax(swiglu_vit, hw):
    img = np.random.default_rng(hw[0]).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jdinov2.vit_forward_features(jax.tree.map(jnp.asarray, swiglu_vit), jnp.asarray(img),
                                                  patch_size=14, num_heads=6, dtype=jnp.float32, use_pallas=False))
    tv = _port_vit(swiglu_vit)
    assert set(tv["blocks"][0]["mlp"]) == {"w12", "w3"} and tv["blocks"][0]["mlp"]["w12"]["w"].shape == (2048, 384)
    out = dinov2.vit_forward_features(tv, T(img), 6, dtype=torch.float32).numpy()
    assert out.shape == ref.shape == (2, (hw[0] // 14) * (hw[1] // 14), 384)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_swiglu_state_dict_converts_as_jax(swiglu_vit):
    """A DINOv2 state dict with ``mlp.w12`` / ``mlp.w3`` (as ViT-g/14's):
    the port's converter gives JAX's tree bitwise, and it round-trips."""
    sd = chip_smoke.dinov2_state_dict(swiglu_vit)
    assert "blocks.1.mlp.w12.weight" in sd and "blocks.0.mlp.fc1.weight" not in sd
    ours = convert_dinov2_state_dict(sd)
    ref = jax_convert_dinov2(sd, depth=2)
    assert jax.tree.structure(ours) == jax.tree.structure(ref) == jax.tree.structure(swiglu_vit)
    for a, b, c in zip(jax.tree.leaves(ours), jax.tree.leaves(ref), jax.tree.leaves(swiglu_vit)):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)


def _layers(seed, d=32, n=3):
    rng = np.random.default_rng(seed)
    tree = self_cross_transformer_init(rng, d, n)
    # LayerNorms off identity, so that a misplaced scale or bias shows
    for k in ("norm1", "norm2"):
        tree["layers"][k]["scale"] = rng.uniform(0.5, 1.5, tree["layers"][k]["scale"].shape).astype(np.float32)
        tree["layers"][k]["bias"] = rng.normal(0, 0.1, tree["layers"][k]["bias"].shape).astype(np.float32)
    return tree


def _port_layers(tree):
    cfg = small_cfg()
    params = init_params_numpy(cfg, 0)
    params["det_head"]["att"] = tree
    return params_to_torch(params, cfg)["det_head"]["att"]


def test_self_cross_transformer_init_layout():
    ours = self_cross_transformer_init(np.random.default_rng(0), 128, 3)
    ref = jax.eval_shape(lambda k: jla.self_cross_transformer_init(k, 128, 3), jax.random.PRNGKey(0))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert np.shape(a) == b.shape and np.asarray(a).dtype == b.dtype
    assert np.asarray(ours["layers"]["q_proj"]["w"]).shape == (6, 128, 128)


@pytest.mark.parametrize("pos_enc", [False, True])
def test_self_cross_transformer_matches_jax(pos_enc):
    tree = _layers(1)
    rng = np.random.default_rng(2)
    f0, f1 = (rng.standard_normal((2, 5, 6, 32)).astype(np.float32) for _ in range(2))
    r0, r1 = jla.self_cross_transformer(jax.tree.map(jnp.asarray, tree), jnp.asarray(f0), jnp.asarray(f1), pos_enc)
    o0, o1 = linear_attention.self_cross_transformer(_port_layers(tree), T(f0), T(f1), pos_enc)
    assert o0.shape == o1.shape == (2, 5, 6, 32)
    _close(o0.numpy(), np.asarray(r0))
    _close(o1.numpy(), np.asarray(r1))
    # the cross layers mix the maps: changing f1 moves x0
    m0, _ = linear_attention.self_cross_transformer(_port_layers(tree), T(f0), T(f1 + 1.0), pos_enc)
    assert not torch.allclose(m0, o0)


def test_full_attention_and_its_encoder_layer_match_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 7, 4, 8)).astype(np.float32) for _ in range(3))
    k9, v9 = (rng.standard_normal((2, 9, 4, 8)).astype(np.float32) for _ in range(2))
    for kk, vv in ((k, v), (k9, v9)):  # keys and values of another length than the queries
        _close(linear_attention.full_attention(T(q), T(kk), T(vv)).numpy(),
               np.asarray(jla.full_attention(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv))))
    tree = _layers(4)
    lp_j = jax.tree.map(lambda a: jnp.asarray(a[1]), tree["layers"])
    lp_t = _port_layers(tree)["layers"][1]
    x, src = rng.standard_normal((2, 11, 32)).astype(np.float32), rng.standard_normal((2, 13, 32)).astype(np.float32)
    for ours, ref in ((linear_attention._encoder_layer_apply_full, jla._encoder_layer_apply_full),
                      (linear_attention._encoder_layer_apply, jla._encoder_layer_apply)):
        _close(ours(lp_t, T(x), T(src)).numpy(), np.asarray(ref(lp_j, jnp.asarray(x), jnp.asarray(src))))


def test_soft_inlier_counting_2d_matches_jax():
    rng = np.random.default_rng(5)
    X0 = np.concatenate([rng.uniform(-2, 2, (3, 50, 2)), rng.uniform(2, 8, (3, 50, 1))], -1).astype(np.float32)
    q = rng.standard_normal((3, 4)).astype(np.float32)
    R = np.array(quat2mat_jax(jnp.asarray(q)))
    t = rng.normal(0, 0.3, (3, 1, 3)).astype(np.float32)
    K1 = np.tile(np.float32([[[300, 0, 160], [0, 300, 120], [0, 0, 1]]]), (3, 1, 1))
    Xc = X0 @ np.swapaxes(R, 1, 2) + t
    xy1 = ((Xc @ np.swapaxes(K1, 1, 2))[..., :2] / (Xc @ np.swapaxes(K1, 1, 2))[..., 2:]
           + rng.normal(0, 6, (3, 50, 2))).astype(np.float32)
    for th in (10.0, 3.0):
        ref = np.asarray(jinliers.soft_inlier_counting_2d(*(jnp.asarray(a) for a in (X0, xy1, R, t, K1)), th=th))
        out = geometry.soft_inlier_counting_2d(*(T(a) for a in (X0, xy1, R, t, K1)), th=th).numpy()
        assert out.shape == ref.shape == (3, 1) and 5 < ref.min() and ref.max() < 50
        _close(out, ref)


def test_quat2mat_torch_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((4, 5, 4)).astype(np.float32) * rng.uniform(0.1, 10, (4, 5, 1)).astype(np.float32)
    q[0, 0] = [1, 0, 0, 0]
    ref = np.asarray(quat2mat_jax(jnp.asarray(q)))
    out = geometry.quat2mat_torch(T(q))
    assert out.shape == (4, 5, 3, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    np.testing.assert_array_equal(out[0, 0].numpy(), np.eye(3, dtype=np.float32))
    eye = (out @ out.transpose(-1, -2)).numpy()  # rotations
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
