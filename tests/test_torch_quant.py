"""The port's int8 backbone (``nn/quant.py``, ``MICKEY.DINOV2.INT8``) against
mickey_tpu on the CPU.

Weights and inputs come from numpy with a fixed seed and go to both
packages (the port's (out, in) linears are the transposes of JAX's). On the
CPU the int8 product is the port's plain version, an fp64 product, exact for
int8 operands (every partial sum is an integer below 2^53).

Tolerances:
- the quantized weights (``w_q``, ``w_s``) and ``linear_int8`` bitwise, in
  fp32 and in bf16;
- the int8 ViT: every ``linear_int8`` call of the port's forward bitwise
  JAX's on the same input. The whole forward is held at the fp32 ViT's
  envelope (``test_torch_model``: 1e-4 on O(1) LayerNorm outputs) where no
  activation lands within an fp32 rounding of a half step of its int8 grid,
  and at 2e-3 in the worst case: the two frameworks' LayerNorms and
  attentions differ by ~1e-6, so now and then one activation rounds to the
  neighbouring int8 level in one package and not in the other, which moves
  a block's output by one quantization step of one product term;
- the serving model under ``INT8`` with JAX's draws injected: the rounding
  flips above reach the heads (the top-P values move by up to 8e-3
  relative, one of 256 matches changes), and random weights on random
  images give RANSAC no true consensus, so a changed sample moves the best
  rotation; the gate, as for the bf16 path (``test_torch_slice``): the
  tables as sets to 95% and in value to 1e-2 relative, validity equal, R
  within 0.05 and t within 0.02 (measured 0.031 and 0.009), the confidence
  at 1e-2 relative (measured 2.5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.models.relative_pose import MickeyRelativePose as JaxPose
from mickey_tpu.nn import dinov2 as jdinov2
from mickey_tpu.nn import quant as jquant
from mickey_tpu_torch.models import MicKeyTrainer, MickeyRelativePose, build_model
from mickey_tpu_torch.nn import dinov2, quant
from mickey_tpu_torch.weights import init_params_numpy, params_to_torch
from test_torch_slice import B, _inputs, _jax_table, _remap, _replay_jax_draws, small_cfg

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: six xdist workers' OpenMP pools otherwise spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _linear(rng, cin, cout, zero_col=None, outlier_col=None):
    w = (0.02 * rng.standard_normal((cin, cout))).astype(np.float32)
    if zero_col is not None:
        w[:, zero_col] = 0.0  # the 1e-12 scale floor
    if outlier_col is not None:
        w[:, outlier_col] *= 1000.0
    return {"w": w, "b": rng.standard_normal(cout).astype(np.float32)}


def _port_linear(p):
    return {"w": T(np.ascontiguousarray(p["w"].T)), "b": T(p["b"])}


@pytest.mark.parametrize("shape", [(64, 48), (384, 1152)])
def test_quantize_linear_int8_is_bitwise_jax(shape):
    p = _linear(np.random.default_rng(shape[0]), *shape, zero_col=5, outlier_col=7)
    ref = jquant.quantize_linear_int8(jax.tree.map(jnp.asarray, p))
    out = quant.quantize_linear_int8(_port_linear(p))
    assert out["w_q"].dtype == torch.int8 and out["w_q"].is_contiguous() and out["w_q"].shape == shape[::-1]
    assert out["w_s"].dtype == torch.float32 and out["w_s"].shape == (shape[1],)
    np.testing.assert_array_equal(out["w_q"].numpy(), np.asarray(ref["w_q"]).T)
    np.testing.assert_array_equal(out["w_s"].numpy(), np.asarray(ref["w_s"])[0])
    assert out["b"] is not None and np.array_equal(out["b"].numpy(), p["b"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_int8_is_bitwise_jax(dtype):
    rng = np.random.default_rng(3)
    p = _linear(rng, 96, 40, zero_col=1, outlier_col=2)
    x = rng.standard_normal((2, 13, 96)).astype(np.float32)
    x[0, 3] = 0.0  # an all-zero token: the activation scale floor
    x[1, 4, 7] = 50.0  # an outlier token
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = np.asarray(jquant.linear_int8(jquant.quantize_linear_int8(jax.tree.map(jnp.asarray, p)), jx))
    tx = T(x).to(getattr(torch, dtype))
    out = quant.linear_int8(quant.quantize_linear_int8(_port_linear(p)), tx)
    assert out.dtype == tx.dtype and out.shape == (2, 13, 40)
    np.testing.assert_array_equal(out.float().numpy(), ref.astype(np.float32))
    no_bias = {k: v for k, v in quant.quantize_linear_int8(_port_linear(p)).items() if k != "b"}
    ref_nb = jquant.linear_int8({k: v for k, v in jquant.quantize_linear_int8(jax.tree.map(jnp.asarray, p)).items()
                                 if k != "b"}, jx)
    np.testing.assert_array_equal(quant.linear_int8(no_bias, tx).float().numpy(), np.asarray(ref_nb).astype(np.float32))


def test_int_mm_plain_is_exact_at_the_largest_sums():
    """The plain product at |sum| = 127^2 * K (K = 4096, 6.6e7 > 2^24, where
    an fp32 product would round): equal to an int64 product."""
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (20, 4096)).astype(np.int8)
    w = rng.integers(-127, 128, (24, 4096)).astype(np.int8)
    x[0], w[0] = 127, 127
    x[1], w[1] = -127, 127
    out = quant.int_mm(T(x), T(w))
    ref = x.astype(np.int64) @ w.astype(np.int64).T
    assert out.dtype == torch.int32 and out[0, 0].item() == 127 * 127 * 4096 and out[1, 1].item() == -(127 * 127 * 4096)
    np.testing.assert_array_equal(out.numpy(), ref)


def _vit(ffn="mlp", depth=2, seed=0):
    from mickey_tpu_torch.weights import _vit_init

    vit = _vit_init(np.random.default_rng(seed), "vit_small", ffn_layer=ffn)
    vit["blocks"] = jax.tree.map(lambda a: a[:depth], vit["blocks"])
    return vit


def _port_vit(vit):
    """A ViT tree through ``params_to_torch`` (with dummy heads)."""
    cfg = small_cfg()
    heads = {k: v for k, v in init_params_numpy(cfg, 0).items() if k != "dinov2"}
    return params_to_torch({**heads, "dinov2": vit}, cfg)["dinov2"]


def test_vit_quantize_int8_is_idempotent_and_shares_leaves():
    tv = _port_vit(_vit())
    q = quant.vit_quantize_int8(tv)
    for bp in q["blocks"]:
        for sub, key in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            assert set(bp[sub][key]) == {"w_q", "w_s", "b"} and bp[sub][key]["w_q"].dtype == torch.int8
        assert bp["norm1"] is tv["blocks"][0]["norm1"] or bp["norm1"] is tv["blocks"][1]["norm1"]
    assert q["patch_embed"] is tv["patch_embed"] and q["pos_embed"] is tv["pos_embed"]
    assert quant.vit_quantize_int8(q) is q
    assert "w" in tv["blocks"][0]["attn"]["qkv"]  # the fp32 tree is left as it was


@pytest.mark.parametrize("ffn,hw", [("mlp", (56, 70)), ("swiglufused", (28, 126))])
def test_int8_vit_matches_jax(ffn, hw, monkeypatch):
    """The int8 ViT forward in fp32: each ``linear_int8`` call bitwise JAX's
    on the same input, the features within the envelope stated above."""
    vit = _vit(ffn)
    img = np.random.default_rng(1).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    jq = jquant.vit_quantize_int8(jax.tree.map(jnp.asarray, vit))
    ref = np.asarray(jdinov2.vit_forward_features(jq, jnp.asarray(img), patch_size=14, num_heads=6,
                                                  dtype=jnp.float32, use_pallas=False))
    tq = quant.vit_quantize_int8(_port_vit(vit))
    calls = []
    linear_int8 = quant.linear_int8

    def recorded(p, x):
        y = linear_int8(p, x)
        calls.append((p, x, y))
        return y

    monkeypatch.setattr(quant, "linear_int8", recorded)
    out = dinov2.vit_forward_features(tq, T(img), 6, dtype=torch.float32).numpy()
    assert len(calls) == 2 * 4 and out.shape == ref.shape
    # the same calls in JAX: block by block, the same four linears in order
    names = ("qkv", "proj") + (("fc1", "fc2") if ffn == "mlp" else ("w12", "w3"))
    for i, (p, x, y) in enumerate(calls):
        jp = jax.tree.map(lambda a: a[i // 4], jq["blocks"][("attn" if i % 4 < 2 else "mlp")][names[i % 4]])
        np.testing.assert_array_equal(y.numpy(), np.asarray(jquant.linear_int8(jp, jnp.asarray(x.numpy()))))
    err = np.abs(out - ref).max()
    assert err < 2e-3, err
    assert np.median(np.abs(out - ref)) < 1e-5


def test_int8_serving_model_matches_jax():
    """``MickeyRelativePose`` under ``INT8`` (fp32 compute around the int8
    products): int8 leaves in every block linear, built twice without
    quantizing twice, and the lite pose of both layouts against JAX's int8
    model with JAX's draws injected."""
    cfg = small_cfg()
    cfg.MICKEY.DINOV2.INT8 = True
    params = init_params_numpy(cfg, 0)
    params["dinov2"]["blocks"] = jax.tree.map(lambda a: a[:2], params["dinov2"]["blocks"])
    model = build_model(cfg, params, device="cpu")
    for bp in model.params["dinov2"]["blocks"]:
        assert all(bp[s][k]["w_q"].dtype == torch.int8 for s, k in
                   (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")))
    again = MickeyRelativePose(cfg, model.params, device="cpu")
    assert again.params["dinov2"] is model.params["dinov2"]

    im0, im1, K0, K1 = _inputs()
    key = jax.random.PRNGKey(7)
    jmodel = JaxPose(cfg, params=params)
    assert np.asarray(jmodel.params["dinov2"]["blocks"]["attn"]["qkv"]["w_q"]).dtype == np.int8
    tcorr = _jax_table(jmodel.params, cfg, im0, im1)
    feats = model.extract_feats(torch.cat([T(im0), T(im1)]))
    ours = model.match_feats(tuple(f[:B] for f in feats), tuple(f[B:] for f in feats))
    P = cfg.TPU.SAMPLING_PREFILTER
    for b in range(B):
        assert len(set(ours.top_idx[b].tolist()) & set(np.asarray(tcorr.top_idx[b]).tolist())) >= 0.95 * P
    np.testing.assert_allclose(ours.top_scores.numpy(), np.asarray(tcorr.top_scores), rtol=1e-2)
    draws = _remap(_replay_jax_draws(key, tcorr.top_scores, cfg), tcorr.top_idx, ours.top_idx, missing_ok=True)
    ref = jmodel(jnp.asarray(im0), jnp.asarray(im1), K0, K1, key=key, lite=True)
    ref_feats = model.extract_feats(T(im0))
    for out in (model(T(im0), T(im1), T(K0), T(K1), draws=draws, lite=True),
                model.call_with_ref_feats(ref_feats, T(im1), T(K0), T(K1), draws=draws)):
        np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=0.05)
        np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=0.02)
        np.testing.assert_allclose(out.inliers.numpy(), np.asarray(ref.inliers), rtol=1e-2)


def test_trainer_under_int8_takes_the_unquantized_step():
    """``MICKEY.DINOV2.INT8`` selects nothing in training, as in
    ``mickey_tpu``'s trainer: the backbone stays fp32 and one step equals
    the step without the key, bitwise."""
    from test_torch_training import B as TB, HW, small_cfg as train_cfg, synthetic_batch
    from mickey_tpu_torch.config import default_config
    from mickey_tpu_torch.weights import tree_leaves

    cfg = train_cfg(default_config())
    cfg.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT = 50
    params = init_params_numpy(cfg, 0)
    params["dinov2"]["blocks"] = jax.tree.map(lambda a: a[:1], params["dinov2"]["blocks"])
    rng = np.random.default_rng(12)
    batch = dict(synthetic_batch(rng), image0=rng.uniform(0, 1, (TB, HW, HW, 3)).astype(np.float32),
                 image1=rng.uniform(0, 1, (TB, HW, HW, 3)).astype(np.float32))
    cfg_q = cfg.clone()
    cfg_q.MICKEY.DINOV2.INT8 = True
    runs = []
    for c in (cfg, cfg_q):
        tr = MicKeyTrainer(c, params=params, device="cpu")
        assert "w" in tr.backbone["blocks"][0]["attn"]["qkv"] and "w_q" not in tr.backbone["blocks"][0]["attn"]["qkv"]
        runs.append((tr.training_step(batch), tree_leaves(tr.state.params)))
    (m0, p0), (m1, p1) = runs
    assert np.isfinite(m0["loss"]) and m0 == m1
    assert len(p0) == len(p1) and all(a == b and torch.equal(x, y) for (a, x), (b, y) in zip(p0, p1))
