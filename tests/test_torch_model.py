"""The port's model modules against mickey_tpu on the CPU, on the same weights.

Weights are made in JAX (``model_init``) and bridged with
``params_to_torch``; inputs come from numpy with a fixed seed. The size is
cut to a ViT-S backbone of 2 blocks, narrow heads and a 12x14 patch grid
(168 keypoints), and the solver to 4 x 16 hypotheses over 64 samples. On the
CPU every kernel wrapper takes its plain version, and the JAX package takes
its own plain references (the CPU route of ``backbone_features`` and
``topk_correspondences_from_heads``).

Tolerances: fp32 throughout unless stated; the two frameworks sum in
different orders, so agreement is to a few fp32 ulps scaled by the depth of
the computation (1e-5 relative per stage, 1e-4 on poses).
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.config import default_config
from mickey_tpu.nn import dinov2 as jdinov2
from mickey_tpu.nn import extractor as jext
from mickey_tpu.nn.extractor import model_init
from mickey_tpu_torch.nn import dinov2, extractor
from mickey_tpu_torch.weights import init_params_numpy, params_to_torch

B, H, W = 2, 168, 196  # 12 x 14 patches; 6 x 8 of them inside the score head's 3-cell border


def small_cfg(bf16=False):
    cfg = default_config()
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.DINOV2.FLOAT16 = bf16
    cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 16, 8]
    cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
    cfg.PROCRUSTES.IT_MATCHES = 4
    cfg.PROCRUSTES.IT_RANSAC = 16
    cfg.PROCRUSTES.NUM_SAMPLED_MATCHES = 64
    cfg.TPU.SAMPLING_PREFILTER = 256
    return cfg


@pytest.fixture(scope="module")
def jax_params():
    p = model_init(jax.random.PRNGKey(0), small_cfg())
    p["dinov2"]["blocks"] = jax.tree.map(lambda a: a[:2], p["dinov2"]["blocks"])
    return p


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    im0, im1 = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    K = np.tile(np.array([[[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    return im0, im1, K, K.copy()


def test_init_params_numpy_matches_model_init_layout():
    cfg = small_cfg()
    ours = init_params_numpy(cfg, 0)
    ref = jax.eval_shape(lambda k: model_init(k, cfg), jax.random.PRNGKey(0))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert np.shape(a) == b.shape and np.asarray(a).dtype == b.dtype


def test_pos_embed_interpolation_matches_jax():
    rng = np.random.default_rng(1)
    pe = rng.standard_normal((1, 37 * 37 + 1, 32)).astype(np.float32)
    ref = np.asarray(jdinov2.interpolate_pos_encoding(jnp.asarray(pe), 12, 14))
    out = dinov2.interpolate_pos_encoding(torch.from_numpy(pe), 12, 14).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_backbone_matches_jax(jax_params):
    cfg = small_cfg()
    tp = params_to_torch(_np_tree(jax_params), cfg)
    im0, _, _, _ = _inputs()
    ref = np.asarray(jext.backbone_features(jax_params, jnp.asarray(im0), cfg))
    out = extractor.backbone_features(tp, torch.from_numpy(im0), cfg).numpy()
    assert out.shape == ref.shape == (B, 12, 14, 384)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)  # LayerNorm output, O(1)


def test_backbone_bf16_within_envelope(jax_params):
    """bf16 rounds at other places in the two frameworks: the feature maps
    agree to the bf16 envelope (cosine > 0.999, max error 0.1 on O(1)
    LayerNorm outputs), not bitwise."""
    cfg = small_cfg(bf16=True)
    tp = params_to_torch(_np_tree(jax_params), cfg)
    im0, _, _, _ = _inputs()
    ref = np.asarray(jext.backbone_features(jax_params, jnp.asarray(im0), cfg)).reshape(B, -1)
    out = extractor.backbone_features(tp, torch.from_numpy(im0), cfg).numpy().reshape(B, -1)
    cos = (out * ref).sum(-1) / np.linalg.norm(out, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert cos.min() > 0.999, cos
    assert np.abs(out - ref).max() < 0.1


def test_heads_match_jax(jax_params):
    cfg = small_cfg()
    tp = params_to_torch(_np_tree(jax_params), cfg)
    fmap = np.random.default_rng(2).standard_normal((B, 12, 14, 384)).astype(np.float32)
    ref, _ = jext.heads_apply(jax_params, jnp.asarray(fmap), cfg, train=False)
    out, _ = extractor.heads_apply(tp, torch.from_numpy(fmap), cfg)
    for name, a, b in zip(("kpts", "depths", "scores", "descs"), out, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=name)


PORT = pathlib.Path(__file__).resolve().parent.parent / "mickey_tpu_torch"


def _port_modules():
    root = PORT.parent
    return sorted(".".join(p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_import_leaves_jax_out():
    """Importing every module of the port and chip_smoke loads neither jax
    nor any module of the JAX package."""
    code = ("import sys, importlib\n"
            f"for m in {_port_modules()!r} + ['chip_smoke']: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'mickey_tpu' or m.startswith('mickey_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=str(PORT.parent))
    assert out.stdout.strip() == "[]"


def test_no_source_imports_the_jax_package():
    """An AST scan: no ``import mickey_tpu...`` / ``from mickey_tpu...`` (nor
    jax) in the port or in chip_smoke.py."""
    bad = []
    for path in list(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in ("mickey_tpu", "jax")]
    assert not bad, bad


def test_default_config_equals_the_jax_packages():
    from mickey_tpu.config import default_config as jax_default_config
    from mickey_tpu_torch.config import default_config as port_default_config

    assert port_default_config().to_dict() == jax_default_config().to_dict()
