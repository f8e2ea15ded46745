"""The port's tensor-parallel backbone (``parallel.init_grid``,
``vit_tp_split``, ``shard_backbone``, ``nn/dinov2.block_apply`` with ``tp``)
on the CPU: gloo ranks (``parallel.launch(..., tp=...)``; the rank bodies in
``parallel`` and ``tests/test_torch_tensor_parallel_ranks.py``, which import
no jax) against ``mickey_tpu``'s TP forward on the 8-device CPU mesh
(``tests/conftest.py``), against the port's one process, and the dp x tp
training step against the dp step.

Sizes: ``mickey_tpu``'s own TP test's (``tests/test_tensor_parallel.py``):
ViT-S (6 heads, 3 a rank at tp = 2), 4 images of 126 x 112, tp = 2; the
training step ``tests/test_torch_parallel.py``'s (``small_cfg``, B = 4 pairs
of 126 x 126 with their images, the loss draws injected), dp 2 x tp 2 on 4
ranks.

Tolerances. The forward, fp32: rtol = atol = 2e-5, ``mickey_tpu``'s lock on
its TP forward (the sums of the row-parallel linears split over the ranks;
the port's one process and JAX sum in other orders). The step: only the
order of sums differs from the dp step and from one process, so
``tests/test_torch_parallel.py``'s tolerances: the loss metrics at 1e-5
relative, BN running stats at 1e-5, Adam's first moments after the step
(0.1 of the applied gradient) at 1e-2 of each leaf's largest entry, every
updated parameter within 2 lr; the ranks of the grid bitwise equal. The grad
norm, a norm of the gradients, is held at the gradients' 1e-2: the two
ranks of ``tests/test_torch_parallel.py`` share one feature map, where here
the backbone's split sums move it by ~1e-6, and the step's gradients move by
5e-4 of a leaf's largest entry for a 1e-6 change of the map
(``tests/test_torch_training.py``); the grad norm moved by 1.09e-5 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_tensor_parallel_ranks as tp_ranks
from mickey_tpu.nn.dinov2 import vit_features_chw as jax_vit_features_chw
from mickey_tpu.parallel import DATA_AXIS, get_mesh_2d
from mickey_tpu.parallel import shard_backbone as jax_shard_backbone
from mickey_tpu_torch import parallel
from mickey_tpu_torch.config import default_config
from mickey_tpu_torch.nn import dinov2
from mickey_tpu_torch.nn.quant import vit_quantize_int8
from mickey_tpu_torch.weights import init_params_numpy, params_to_torch, tree_leaves
from test_torch_parallel import _fit_setup, _params_close, _within
from test_torch_training import HW, inject_draws, small_cfg, synthetic_batch

TOL = 2e-5
IMAGES = (4, 126, 112, 3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as the ranks have (``tests/test_torch_parallel.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vit_cfg(packed: bool = True, bf16: bool = False):
    cfg = default_config()
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.DINOV2.FLOAT16 = bf16
    cfg.TPU.PACKED_ATTENTION = packed
    return cfg


def _backbone():
    cfg = _vit_cfg()
    return params_to_torch(init_params_numpy(cfg, 0), cfg, "cpu")["dinov2"]


@pytest.fixture(scope="module")
def forward():
    """The port's ViT-S forward, packed and unpacked attention, on two ranks
    at tp = 2 and in one process; and the inputs."""
    cfg = _vit_cfg()
    params = init_params_numpy(cfg, 0)
    images = np.random.default_rng(1).uniform(0, 1, IMAGES).astype(np.float32)
    cfgs = {"packed": cfg, "unpacked": _vit_cfg(packed=False)}
    one = chip_smoke.tensor_parallel_features(cfgs, images, device="cpu")  # params: init_params_numpy(cfg, 0)
    two = parallel.launch(chip_smoke.tensor_parallel_features, 2, "gloo", args=(cfgs, images, None, 0, "cpu"),
                          timeout_s=300, tp=2)
    return params, images, one, two


@pytest.mark.parametrize("route", ["xla", "pallas_packed", "pallas_unpacked"])
def test_tp_forward_matches_jax_tp_forward(forward, route):
    """Two ranks at tp = 2 (3 heads each) against ``mickey_tpu``'s
    ``vit_features_chw(..., mesh=get_mesh_2d(tp=2))`` with the shard_mapped
    attention in XLA or as its Pallas kernels in interpret mode (packed:
    the odd 3-head shard; unpacked), and against the port's one process:
    within 2e-5; the ranks' maps bitwise equal, the passes bitwise."""
    params, images, one, two = forward
    layout = "unpacked" if route == "pallas_unpacked" else "packed"
    mesh = get_mesh_2d(tp=2)
    sharded = jax_shard_backbone(mesh, jax.tree.map(jnp.asarray, params["dinov2"]))
    ref = jax.jit(lambda p, im: jax_vit_features_chw(
        p, im, cfg_dtype="float32", use_pallas=route != "xla", interpret=True, num_heads=6, mesh=mesh,
        packed=layout == "packed"))(sharded, jax.device_put(
            jnp.asarray(images), jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(DATA_AXIS))))
    ref = np.asarray(jax.device_get(ref))
    ours = two[0]["maps"][layout]["fmap"]
    assert ours.shape == ref.shape == (4, 9, 8, 384)
    np.testing.assert_array_equal(two[1]["maps"][layout]["fmap"], ours)
    assert all(r["maps"][layout]["repeats"] for r in two)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours, one["maps"][layout]["fmap"], rtol=TOL, atol=TOL)
    assert [r["tp"] for r in two] == [(0, 2), (1, 2)]


def test_each_rank_holds_its_shard(forward):
    """A rank's tree: qkv and fc1 (weights and biases) its contiguous row
    slice, proj and fc2 weights its column slice, each in storage of 1/tp of
    the whole; the proj and fc2 biases and every other leaf whole. The
    slices of the ranks put together are the whole, and the launched ranks
    report 1/tp of one process's split bytes."""
    whole = _backbone()
    dims = dict(tree_leaves(parallel.vit_tp_split(whole)))
    shards = [dict(tree_leaves(parallel.shard_backbone(parallel.TensorParallel(r, 2), whole, 6))) for r in range(2)]
    split_names = set()
    for path, t in tree_leaves(whole):
        parts = [s[path] for s in shards]
        if dims.get(path) is None:
            assert all(p is t for p in parts), path
            continue
        split_names.add(path[-2:])
        for p in parts:
            assert p.is_contiguous() and p.untyped_storage().nbytes() * 2 == t.untyped_storage().nbytes(), path
        assert torch.equal(torch.cat(parts, dim=dims[path]), t), path
    assert split_names == {("qkv", "w"), ("qkv", "b"), ("proj", "w"), ("fc1", "w"), ("fc1", "b"), ("fc2", "w")}
    assert {tuple(p[-2:]) for p in dims} == split_names
    _, _, one, two = forward
    assert [r["split_bytes"] * 2 for r in two] == [one["split_bytes"]] * 2
    assert all(r["backbone_bytes"] < one["backbone_bytes"] for r in two)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return None


def test_vit_tp_split_covers_the_tree():
    """The split's tree has the backbone's structure, MLP and SwiGLU alike;
    SwiGLU's w12 / w3 stay whole (``vit_tp_shardings``)."""
    from mickey_tpu_torch.weights import _vit_init

    swiglu = {**init_params_numpy(_vit_cfg(), 0), "dinov2": _vit_init(np.random.default_rng(0), "vit_small",
                                                                        ffn_layer="swiglufused")}
    for tree in (_backbone(), params_to_torch(swiglu, _vit_cfg(), "cpu")["dinov2"]):
        split = parallel.vit_tp_split(tree)
        assert _structure(split) == _structure(tree)
        assert len(split["blocks"]) == 12
        for bp, sp in zip(tree["blocks"], split["blocks"]):
            assert sp["attn"] == {"qkv": {"w": 0, "b": 0}, "proj": {"w": 1, "b": None}}
            if "w12" in bp["mlp"]:
                assert sp["mlp"] == {"w12": {"w": None, "b": None}, "w3": {"w": None, "b": None}}
            else:
                assert sp["mlp"] == {"fc1": {"w": 0, "b": 0}, "fc2": {"w": 1, "b": None}}
            assert all(v is None for k in ("norm1", "norm2", "ls1", "ls2") for v in sp[k].values())
        assert split["pos_embed"] is None and split["cls_token"] is None and split["patch_embed"]["w"] is None


def test_tp_must_divide_heads():
    """tp = 4 does not divide ViT-S's 6 heads: ``shard_backbone`` and the
    block raise with ``mickey_tpu``'s words, before any collective."""
    whole = _backbone()
    four = parallel.TensorParallel(0, 4)
    with pytest.raises(ValueError, match="must divide num_heads"):
        parallel.shard_backbone(four, whole, 6)
    x = torch.zeros((1, 5, 384))
    with pytest.raises(ValueError, match="must divide num_heads"):
        dinov2.block_apply(x, whole["blocks"][0], 6, tp=four)
    # a tree that is not the rank's shard
    with pytest.raises(ValueError, match="not this rank's shard"):
        dinov2.block_apply(x, whole["blocks"][0], 6, tp=parallel.TensorParallel(0, 2))


def test_int8_backbone_is_refused():
    """``mickey_tpu``'s shardings do not cover the quantized leaves: an int8
    tree is refused, the unquantized one shards."""
    whole = _backbone()
    two = parallel.TensorParallel(1, 2)
    with pytest.raises(ValueError, match="int8"):
        parallel.shard_backbone(two, vit_quantize_int8(whole), 6)
    assert parallel.shard_backbone(two, whole, 6) is not whole
    assert parallel.shard_backbone(parallel.TensorParallel(), whole, 6) is whole


def _step_inputs():
    cfg = small_cfg(default_config())
    cfg.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT = 50
    rng = np.random.default_rng(12)
    b = 4
    batch = synthetic_batch(rng, b)
    batch["image0"] = rng.uniform(0, 1, (b, HW, HW, 3)).astype(np.float32)
    batch["image1"] = rng.uniform(0, 1, (b, HW, HW, 3)).astype(np.float32)
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    draws = inject_draws(rng, b, HW // 14, gh.IT_MATCHES, cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES,
                         gh.IT_RANSAC, gh.NUM_CORR_3d3d)
    return cfg, batch, tuple(np.asarray(d) for d in draws)


def test_dp_tp_step_matches_dp_step_and_one_process():
    """A dp 2 x tp 2 staged step on 4 ranks (``data_parallel_steps`` on the
    grid: each data group's 2 pairs through the rank's half of the backbone)
    against the dp 4 step on 4 ranks and against one process, on the same
    batch and injected draws: the four ranks bitwise equal, the metrics, BN
    stats, first moments and parameters at the module's tolerances."""
    cfg, batch, draws = _step_inputs()
    args = (cfg, batch, 1, 0, draws)  # the trainer's weights: init_params_numpy(cfg, 0) on every rank
    one = parallel.data_parallel_steps(*args, device="cpu")
    dp_tp = parallel.launch(parallel.data_parallel_steps, 4, "gloo", args=args, timeout_s=300, tp=2)
    dp = parallel.launch(parallel.data_parallel_steps, 4, "gloo", args=args, timeout_s=300)
    for r in dp_tp[1:]:
        for a, b in zip(jax.tree.leaves((r["first"], r["params"])), jax.tree.leaves((dp_tp[0]["first"],
                                                                                    dp_tp[0]["params"]))):
            np.testing.assert_array_equal(a, b)
    got = dp_tp[0]
    assert got["metrics"][0]["num_valid"] == 4
    for ref, what in ((dp[0], "dp 4"), (one, "one process")):
        for k, v in ref["metrics"][0].items():
            np.testing.assert_allclose(got["metrics"][0][k], v, rtol=1e-2 if k == "grad_norm" else 1e-5,
                                       err_msg=f"{what} {k}")
        _params_close(got["first"]["params"], ref["first"]["params"], cfg.TRAINING.LR, what)
        _within(got["first"]["mu"], ref["first"]["mu"], f"{what} first moments", 1e-2)


def test_grid_groups_follow_the_jax_mesh():
    """``init_grid``'s indices are ``get_mesh_2d``'s: global rank r sits at
    (r // tp, r % tp) of the (data, model) mesh, whose model groups are tp
    consecutive ranks."""
    mesh = get_mesh_2d(tp=2)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r in range(8):
        d, m = divmod(r, 2)
        assert ids[d, m] == jax.devices()[r].id
    out = parallel.launch(tp_ranks.rank_grid, 4, "gloo", timeout_s=120, tp=2)
    assert out == [(r, (r // 2, 2), (r % 2, 2)) for r in range(4)]


def test_fingerprint_and_writes_unchanged_by_tp(tmp_path):
    """``fit`` with a feature cache at dp 1 x tp 2 against one process: the
    model group builds the cache together and global rank 0 alone writes it,
    the checkpoints and the logs; the cache's fingerprint is the whole
    backbone's, equal to the one-process cache's, whose rows it holds within
    2e-5. A cache built at tp = 1 opens at tp = 2 and the other way round,
    and the two ranks' cached step on the one-process cache ends in one
    state, within the step tolerances of one process's on it. (The step on
    the TP cache is not held to one process's: at this size a 1e-6 change
    of the maps moves a first moment by up to 1.25e-2 of its leaf's largest
    entry, the step's own conditioning.)"""
    from mickey_tpu_torch.training.feature_cache import FeatureCache

    cfg, draws = _fit_setup(tmp_path)
    cfg.TPU.FEATURE_CACHE_DTYPE = "float32"
    params = init_params_numpy(cfg, 0)
    one_cfg, two_cfg = cfg.clone(), cfg.clone()
    one_cfg.TPU.FEATURE_CACHE = str(tmp_path / "cache1")
    two_cfg.TPU.FEATURE_CACHE = str(tmp_path / "cache2")
    one = tp_ranks.rank_fit_writes(one_cfg, params, str(tmp_path / "run1"), draws)
    # on the ranks: build and train from their own cache, then train from the one-process cache
    runs = ((two_cfg, str(tmp_path / "run2")), (one_cfg, str(tmp_path / "run3")))
    two, cross = zip(*parallel.launch(tp_ranks.rank_fits, 2, "gloo", args=(runs, params, draws), timeout_s=300, tp=2))
    assert [(t["dp"], t["tp"], t["main"]) for t in two] == [((0, 1), (0, 2), True), ((0, 1), (1, 2), False)]
    assert [2 * t["split_bytes"] for t in two] == [one["split_bytes"]] * 2
    assert sorted(two[0]["saved"]) == sorted(one["saved"]) and "last" in one["saved"] and two[1]["saved"] == []
    assert two[0]["writer"] and not two[1]["writer"]
    meta1, meta2 = (json.loads((tmp_path / c / "meta.json").read_text()) for c in ("cache1", "cache2"))
    assert meta2["fingerprint"] == meta1["fingerprint"] == two[0]["fingerprint"] and one["fingerprint"] is None
    assert meta2["keys"] == meta1["keys"]
    rows1, rows2 = (FeatureCache(tmp_path / c).gather(list(meta1["keys"])).numpy() for c in ("cache1", "cache2"))
    np.testing.assert_allclose(rows2, rows1, rtol=TOL, atol=TOL)
    for a, b in zip(jax.tree.leaves(two[0]["params"]), jax.tree.leaves(two[1]["params"])):
        np.testing.assert_array_equal(a, b)
    # either tp opens the other's cache; on the same rows the ranks' step is one process's
    FeatureCache(tmp_path / "cache2", backbone=params_to_torch(params, cfg, "cpu")["dinov2"])
    assert cross[0]["fingerprint"] == meta1["fingerprint"]
    for a, b in zip(jax.tree.leaves(cross[0]["params"]), jax.tree.leaves(cross[1]["params"])):
        np.testing.assert_array_equal(a, b)
    _params_close(cross[0]["params"], one["params"], cfg.TRAINING.LR, "state")
    _within(cross[0]["mu"], one["mu"], "first moments", 1e-2)
