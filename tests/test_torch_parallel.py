"""The port's data-parallel layer (``mickey_tpu_torch/parallel.py``) on the
CPU: two gloo ranks (``parallel.launch``, the rank functions in
``tests/test_torch_parallel_ranks.py``, which imports no jax) against the
port's one process and against ``mickey_tpu``'s step on a 2-device mesh.

Sizes are ``tests/test_torch_training.py``'s (``small_cfg``: a ViT-S-width
feature map, 126 x 126 images, B = 4 pairs, it/R_it/S = 2/3/16).

Tolerances. Two ranks against one process: only the order of the sums
differs (BatchNorm's statistics from all-reduced sums, the gradient a sum of
the ranks'); values and metrics at 1e-5 relative, BN running stats at 1e-5
relative, gradients at 1e-2 of each leaf's largest entry, and every updated
parameter within 2 lr (Adam's first step moves an entry by lr times a sign,
which a rounding can flip for an entry whose gradient is near 0). The
gradients' bound is the whole step's conditioning, not the layer's error:
``tests/test_torch_training.py`` measured the JAX step's own gradients move
by 5e-4 of a leaf's largest entry when the feature map is scaled by
1 + 1e-6, and two ranks' roundings moved them by up to 1.2e-3 here. Against
the JAX mesh step: the single-device step test's (``test_staged_step_matches_jax``):
loss at 1e-5 relative, gradients at 1e-2 of each leaf's largest entry,
parameters within 2 lr, BN stats at 1e-5. Where a check has only the state
after ``fit`` (the training entry point, the feature cache), Adam's first
moments after its one step (0.1 times the applied gradient) stand for the
gradients, at the same 1e-2 of each leaf's largest entry: the 2 lr bound on
the parameters alone would pass any two gradients.
"""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from mickey_tpu import parallel as jparallel
from mickey_tpu.config import default_config as jax_default_config
from mickey_tpu.nn import extractor as jext
from mickey_tpu.nn.extractor import compute_correspondences as jax_corr
from mickey_tpu.training import loss as jloss
from mickey_tpu.training.train_step import _copy_bn_stats, make_optimizer
from mickey_tpu_torch import parallel
from mickey_tpu_torch.config import default_config
from mickey_tpu_torch.models import MickeyRelativePose
from mickey_tpu_torch.weights import init_params_numpy, params_to_torch
from test_torch_data import data_cfgs, write_split
from test_torch_training import B, HW, _tree_close, inject_draws, small_cfg, synthetic_batch

import optax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread in this process, as the ranks have: under the
    tier-1 run's test workers torch's OpenMP threads spin against each
    other's (``tests/test_torch_submission.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def launch(fn, *args, world=2):
    return parallel.launch(fn, world, backend="gloo", args=args, timeout_s=300)


def _within(ours, ref, what, tol):
    _tree_close(ours, ref, what, tol)


def _params_close(ours, ref, lr, what):
    """BN stats at 1e-5 relative, every other entry within 2 lr."""
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree.leaves(ref)):
        key = jax.tree_util.keystr(path)
        if key.endswith("['mean']") or key.endswith("['var']"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=f"{what} {key}")
        else:
            assert np.abs(a - b).max() <= 2 * lr, (what, key, np.abs(a - b).max())


def _metrics_close(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, err_msg=k)


# -- helpers ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,multiple", [(5, 2), (6, 2), (7, 4), (1, 3)])
def test_pad_batch_and_shard_indices_match_jax(b, multiple):
    """``pad_batch`` is the JAX package's bit for bit, and the loader's
    ``shard_indices`` reads the rows it gives each rank."""
    rng = np.random.default_rng(b)
    tree = {"x": rng.standard_normal((b, 3)).astype(np.float32), "i": np.arange(b)}
    ours, real = parallel.pad_batch(tree, multiple)
    ref, jreal = jparallel.pad_batch(tree, multiple)
    assert real == jreal == b
    for k in tree:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    idxs = list(range(10, 10 + b))
    padded = ours["i"] + 10
    for r in range(multiple):
        dp = parallel.DataParallel(r, multiple)
        assert parallel.shard_indices(idxs, r, multiple) == padded[dp.rows(len(padded))].tolist()


def test_single_process_is_the_identity():
    """No process group: world 1, every collective returns its input, and
    ``global_batch`` leaves no step in flight."""
    dp = parallel.world()
    assert (dp.rank, dp.size) == (0, 1) and dp.device == torch.device("cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert dp.all_gather_rows(x) is x and dp.sum(x) is x and dp.broadcast_object(3) == 3
    assert parallel.all_reduce_sum(x, dp) is x and torch.equal(dp.shard_rows(x), x)
    dp.all_reduce_([x])
    dp.broadcast_([x])
    assert torch.equal(x, torch.arange(6.0).reshape(3, 2))
    with parallel.global_batch(dp, 3):
        assert parallel.active() is None
    with pytest.raises(ValueError, match="pad it first"):
        parallel.DataParallel(0, 2).rows(3)


def test_collectives_on_two_ranks():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    out = launch(ranks.rank_collectives, x)
    for r, o in enumerate(out):
        assert o["rank"] == r
        np.testing.assert_array_equal(o["mine"], x[3 * r:3 * r + 3])
        np.testing.assert_array_equal(o["gathered"], x)
        np.testing.assert_array_equal(o["grads"][0], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(o["grads"][1], np.arange(4) * 3.0)
        assert o["grads"][1].dtype == np.float64
        np.testing.assert_array_equal(o["state"][0], np.zeros(3))
        np.testing.assert_array_equal(o["state"][1], [0])
        assert o["seed"] == 100  # rank 0's


def test_launch_raises_a_failing_ranks_error():
    """A failing rank fails the launch with its traceback; its peer, left in
    a barrier, is stopped, not waited for."""
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*on purpose"):
        parallel.launch(ranks.rank_fails, 2, timeout_s=120)


def test_launch_stops_a_hung_rank():
    """A rank that never returns fails the launch at its timeout, and is
    killed: the test does not wait for it."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed:\nno result within 10 s"):
        parallel.launch(ranks.rank_hangs, 2, timeout_s=10)
    assert time.monotonic() - t0 < 60


def test_init_refuses_a_missing_backend():
    with pytest.raises(RuntimeError, match="not available|CUDA"):
        parallel.init_data_parallel("nccl", rank=0, world_size=1, init_method="file:///nonexistent")


def test_default_backend_is_nccl_where_there_are_cards(monkeypatch):
    """Where CUDA is available, or the device asked for is a card, the
    default backend is NCCL (which this CPU build lacks, so it raises),
    never gloo on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for device in (None, "cuda:0"):
        with pytest.raises(RuntimeError, match="nccl backend is not available"):
            parallel.init_data_parallel(device=device, rank=0, world_size=1, init_method="file:///nonexistent")


def test_entry_points_refuse_a_cpu_group_beside_a_card(tmp_path):
    """In a gloo group on the CPU of a process that sees a CUDA device, the
    training and submission entry points raise rather than run on the CPU;
    a caller that asks for the CPU passes."""
    from test_torch_fit import fit_cfg

    root = write_split(tmp_path / "data", splits=(("train", ("s0",)), ("val", ("v0",))), n_queries=6, seed=5)
    errors = launch(ranks.rank_entry_points_on_a_cpu_group, fit_cfg(root),
                    ["--experiment", "x", "--path_weights", str(tmp_path / "w")])
    for rank_errors in errors:
        assert len(rank_errors) == 2
        for e in rank_errors:
            assert e is not None and "joined its group on the CPU" in e, e
    assert not (tmp_path / "w").exists()


# -- the batch-global reductions ---------------------------------------------------------


def test_batchnorm_statistics_are_the_global_batchs():
    """Two ranks' train-mode BatchNorm: outputs, running stats and the
    gradient of the ranks' summed objective equal the one-process layer's."""
    from mickey_tpu_torch.nn.common import batchnorm

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 3, 3, 5)) * np.arange(1, 6) + np.arange(5)).astype(np.float32)
    p = {"mean": np.zeros(5, np.float32), "var": np.ones(5, np.float32),
         "scale": rng.standard_normal(5).astype(np.float32), "bias": rng.standard_normal(5).astype(np.float32)}
    out = launch(ranks.rank_batchnorm, x, p)
    xt = torch.from_numpy(x).requires_grad_()
    ref, new_p = batchnorm({k: torch.from_numpy(v) for k, v in p.items()}, xt, train=True)
    w = torch.cat([torch.linspace(-1, 1, x[:2].size).reshape(2, 3, 3, 5) * (1 + r) for r in range(2)])
    (ref * w).sum().backward()
    np.testing.assert_allclose(np.concatenate([o[0] for o in out]), ref.detach().numpy(), rtol=1e-5, atol=1e-6)
    for o in out:
        np.testing.assert_allclose(o[1], new_p["mean"].numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(o[2], new_p["var"].numpy(), rtol=1e-5)  # the unbiased count is global
    np.testing.assert_allclose(np.concatenate([o[3] for o in out]), xt.grad.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,axis", [((3, 4, 5), 1), ((4, 2, 3, 5), 0)])
def test_draws_are_the_global_batchs(shape, axis):
    """Inside a step each rank's Gumbel noise is its rows of the noise one
    process draws for the global batch, bit for bit."""
    from mickey_tpu_torch.ops.sampling import gumbel_noise

    ref = gumbel_noise(shape, torch.Generator().manual_seed(3), "cpu").numpy()
    np.testing.assert_array_equal(np.concatenate(launch(ranks.rank_draws, shape, axis, 3), axis=axis), ref)


def test_curriculum_threshold_and_denominator_are_global():
    """Rank 0 holds the four best pairs and rank 1 the four worst: a rank's
    own top-50% threshold would keep two pairs on each, the global one keeps
    rank 0's four (less its invalid pair) and none of rank 1's. The
    denominator is the global mask's sum, and the gradients of the ranks'
    shares are the one-process total's."""
    baseline = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8], np.float32)
    row_ok = np.array([True, True, False, True, True, True, True, True])
    out = launch(ranks.rank_loss_mask, baseline, row_ok, 50.0)
    mask = np.concatenate([o["mask"] for o in out])
    np.testing.assert_array_equal(mask, [1, 1, 0, 1, 0, 0, 0, 0])
    for o in out:
        assert o["avg_loss"] == pytest.approx((0.1 + 0.2 + 0.4) / 3, rel=1e-6)
        assert o["num_valid"] == 7
    np.testing.assert_allclose(np.concatenate([o["grad"] for o in out]), mask / 3, rtol=1e-6)
    # one process on the same baselines: the same mask
    b = torch.from_numpy(baseline)
    sb = int(8 * 50.0 // 100)
    np.testing.assert_array_equal(((b < torch.sort(b).values[sb]).float() * torch.from_numpy(row_ok)).numpy(), mask)


# -- one staged step ------------------------------------------------------------------------


def _step_setup(fused: bool, prefilter=None):
    cfg = small_cfg(default_config())
    cfg.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT = 50
    cfg.TPU.TRAIN_FUSED_TOPK = fused
    if prefilter is not None:
        cfg.TPU.SAMPLING_PREFILTER = prefilter
    params = init_params_numpy(cfg, 0)
    rng = np.random.default_rng(11)
    side = HW // 14
    fmap = rng.standard_normal((2 * B, side, side, 384)).astype(np.float32)
    batch = synthetic_batch(rng)
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    draws = inject_draws(rng, B, side, gh.IT_MATCHES, cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES,
                         gh.IT_RANSAC, gh.NUM_CORR_3d3d)
    return cfg, params, fmap, batch, draws


@pytest.mark.parametrize("route", ["dense", "fused", "dense_drawn"])
def test_two_rank_step_matches_one_process(route):
    """A 2-rank gloo step against the port's 1-process step on the same
    global batch: injected draws on both routes; on the dense route without
    a prefilter also the generator's own draws (the global noise, sliced).
    Both ranks hold the same state after the step."""
    cfg, params, fmap, batch, draws = _step_setup(route == "fused", prefilter=0 if route == "dense_drawn" else None)
    if route == "dense_drawn":
        draws = None
    one_p, one_g, one_m = ranks.rank_grad_step(cfg, params, fmap, batch, draws, 50.0)
    (p0, g0, m0), (p1, g1, m1) = launch(ranks.rank_grad_step, cfg, params, fmap, batch, draws, 50.0)
    for a, b in zip(jax.tree.leaves((p0, g0, m0)), jax.tree.leaves((p1, g1, m1))):
        np.testing.assert_array_equal(a, b)
    _metrics_close(m0, one_m)
    assert m0["num_valid"] == B
    _within(g0, one_g, "grads", 1e-2)
    _params_close(p0, one_p, cfg.TRAINING.LR, "params")


def test_world_one_group_is_bitwise_no_group():
    """A gloo group of one rank computes exactly the ungrouped step (both at
    one intra-op thread: the CPU's sums depend on the thread count)."""
    cfg, params, fmap, batch, draws = _step_setup(False)
    ref = ranks.rank_grad_step(cfg, params, fmap, batch, None, 50.0)
    (got,) = launch(ranks.rank_grad_step, cfg, params, fmap, batch, None, 50.0, world=1)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


def _jax_mesh_step(cfg_j, params, fmap, batch, draws, topk, fused: bool):
    """``mickey_tpu``'s step with the batch, feature map and draws sharded on
    the data axis of a 2-device mesh, the trainables replicated: the
    partitioner makes its reductions global. The fused route runs its Pallas
    kernels in interpret mode, as its single-device test does."""
    mesh = jparallel.get_mesh(num_devices=2)
    assert mesh.devices.size == 2
    trainable = {k: v for k, v in params.items() if k != "dinov2"}
    lc = jloss.LossConfig.from_cfg(cfg_j)

    def loss_fn(tr, fm, b, d):
        T = b["T_0to1"]
        Ks = (b["K_color0"], b["K_color1"], b["Kori_color0"], b["Kori_color1"])
        pose = (T[:, :3, :3], T[:, :3, 3][:, None, :], jax.random.PRNGKey(0), lc, jnp.float32(topk))
        if fused:
            corr, new_tr = jext.compute_correspondences_topk_train(tr, None, None, cfg_j, fmap=fm)
            total, aux = jloss.metric_pose_loss_topk(
                (corr.top_scores, corr.top_idx, corr.row_ok, corr.lse_row, corr.lse_col),
                corr.dsc0, corr.dsc1, corr.scr0, corr.scr1, corr.kps0, corr.depth0, corr.kps1, corr.depth1,
                *Ks, *pose, temperature=0.1, sample_override=d)
        else:
            corr, new_tr = jax_corr(tr, None, None, cfg_j, train=True, fmap=fm)
            total, aux = jloss.metric_pose_loss(corr.final_scores, corr.kps0, corr.depth0, corr.kps1, corr.depth1,
                                                *Ks, *pose, sample_override=d)
        return total, (aux, new_tr)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tr = jparallel.replicate(mesh, jax.tree.map(jnp.asarray, trainable))
    (total, (aux, fwd)), grads = step(tr, jparallel.shard_batch(mesh, fmap), jparallel.shard_batch(mesh, batch),
                                      jparallel.shard_batch(mesh, tuple(draws)))
    opt = make_optimizer(cfg_j)
    upd, _ = opt.update(grads, opt.init(tr), tr)
    new = _copy_bn_stats(optax.apply_updates(tr, upd), fwd)
    return float(total), aux, jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new)


@pytest.mark.parametrize("route", ["dense", "fused"])
def test_two_rank_step_matches_jax_mesh_step(route):
    """The 2-rank gloo step against ``mickey_tpu``'s step on
    ``get_mesh(num_devices=2)`` with the same injected draws, on both
    matcher routes, at the single-device step tests' tolerances."""
    fused = route == "fused"
    cfg, params, fmap, batch, draws = _step_setup(fused)
    cfg_j = small_cfg(jax_default_config())
    cfg_j.TPU.TRAIN_FUSED_TOPK = fused
    cfg_j.TPU.PALLAS_INTERPRET = fused
    ref_total, ref_aux, ref_grads, ref_new = _jax_mesh_step(cfg_j, params, fmap, batch, draws, 50.0, fused)
    (p0, g0, m0), _ = launch(ranks.rank_grad_step, cfg, params, fmap, batch, draws, 50.0)
    np.testing.assert_allclose(m0["loss"], float(ref_aux["avg_loss"]), rtol=1e-5)
    assert m0["num_valid"] == int(ref_aux["num_valid"]) == B
    _within(g0, ref_grads, "grads", 1e-2)
    _params_close(p0, ref_new, cfg.TRAINING.LR, "params")


# -- serving --------------------------------------------------------------------------------


def _serving_inputs():
    from test_torch_submission import tiny_cfg

    cfg = tiny_cfg("unused")
    params = init_params_numpy(cfg, 0)
    params["dinov2"]["blocks"] = {k: (v[:2] if not isinstance(v, dict) else jax.tree.map(lambda a: a[:2], v))
                                  for k, v in params["dinov2"]["blocks"].items()}
    rng = np.random.default_rng(4)
    im0 = rng.uniform(0, 1, (1, 112, 126, 3)).astype(np.float32)
    im1 = rng.uniform(0, 1, (1, 112, 126, 3)).astype(np.float32)
    K = np.array([[[100.0, 0, 63], [0, 100.0, 56], [0, 0, 1]]], np.float32)
    # one pair served twice: row 0 on rank 0, row 1 on rank 1
    return cfg, params, *(np.repeat(a, 2, axis=0) for a in (im0, im1, K, K))


def test_sharded_serving_decorrelates_the_ranks_draws():
    """``sharded_call`` and ``sharded_call_with_ref_feats``: the same pair on
    two ranks draws independently (its two poses differ), and each rank's
    row is the plain call on that row with the generator folded with its
    rank; ``sharded_extract_feats`` gathers the plain extraction."""
    cfg, params, im0, im1, K0, K1 = _serving_inputs()
    out, feats, shared = launch(ranks.rank_sharded_serving, cfg, params, im0, im1, K0, K1, 5)[0]
    assert not np.array_equal(out["R"][0], out["R"][1]) and not np.array_equal(shared["t"][0], shared["t"][1])
    model = MickeyRelativePose(cfg, params_to_torch(params, cfg, "cpu"), device="cpu")
    ims = [torch.from_numpy(x) for x in (im0, im1, K0, K1)]
    ref_feats = model.extract_feats(ims[0])
    for f, r in zip(feats, ref_feats):
        np.testing.assert_allclose(f, r.numpy(), rtol=1e-5, atol=1e-6)
    for r in range(2):
        gen = parallel.DataParallel(r, 2).fold(torch.Generator().manual_seed(5))
        ref = model(*(x[r:r + 1] for x in ims), generator=gen, lite=True)
        np.testing.assert_allclose(out["R"][r], ref.R[0].numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["inliers"][r], ref.inliers[0].numpy(), rtol=1e-4)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("mapfree_dp"))


@pytest.mark.parametrize("shared_ref", [True, False])
def test_predict_on_two_ranks_writes_the_one_rank_zip(split, tmp_path, shared_ref):
    """``predict`` at world 2 (batches of 3, so every batch is padded) with a
    stand-in model whose poses depend only on their own pair: rank 0's zip
    is the one-process zip byte for byte, and every rank returns every pose."""
    from mickey_tpu_torch.cli.submission import predict, save_submission
    from mickey_tpu_torch.data.loader import DataModule

    cfg, _ = data_cfgs(split)
    results = predict(DataModule(cfg, drop_last_val=False).val_dataloader(), ranks.StandIn(cfg), progress=False,
                      shared_ref=shared_ref)
    save_submission(results, tmp_path / "one.zip")
    counts = launch(ranks.rank_predict, cfg, shared_ref, str(tmp_path / "two.zip"))
    assert counts[0] == counts[1] == sum(len(v) for v in results.values()) > 0
    assert (tmp_path / "two.zip").read_bytes() == (tmp_path / "one.zip").read_bytes()
    with zipfile.ZipFile(tmp_path / "one.zip") as zf:
        assert len(zf.namelist()) == 2


# -- the training entry point ---------------------------------------------------------------


def _fit_setup(tmp_path):
    """``tests/test_torch_fit.py``'s configuration on a one-scene split, at
    130 x 130 (cropped to 9 x 9 patches), with the prefilter off, and
    global loss draws for its one step (``ranks.injected_draws``)."""
    from test_torch_fit import fit_cfg

    root = write_split(tmp_path / "data", splits=(("train", ("s0",)), ("val", ("v0",))), n_queries=6, seed=5)
    cfg = fit_cfg(root)
    cfg.TPU.SAMPLING_PREFILTER = 0
    cfg.DATASET.WIDTH = cfg.DATASET.HEIGHT = 130
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    draws = inject_draws(np.random.default_rng(7), int(cfg.TRAINING.BATCH_SIZE), 130 // 14, gh.IT_MATCHES,
                         cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES, gh.IT_RANSAC, gh.NUM_CORR_3d3d)
    return cfg, tuple(np.asarray(d) for d in draws)


def test_fit_on_two_ranks_matches_one(tmp_path, monkeypatch):
    """The training CLI's ``train_model`` for one epoch at world 2 (a batch of
    8, 4 a rank) against world 1: the same dataset seed (rank 0's), the same
    steps and checkpoint decisions on both ranks, rank 0 alone writes
    checkpoints and logs, and the state and checkpoint within the step
    tolerances (Adam's first moments for the gradients), the loss draws
    injected (``_fit_setup``); then ``--resume`` at world 2 from that
    checkpoint, both ranks ending in the same state. (The best AUCs are the
    validation of two states 2 lr apart over 8 pairs, so they are not
    compared across worlds; validation itself is, in
    ``test_validation_on_two_ranks_matches_one``.)"""
    from mickey_tpu_torch.cli import train as cli
    from mickey_tpu_torch.training.checkpoint import restore_checkpoint

    cfg, draws = _fit_setup(tmp_path)
    monkeypatch.chdir(tmp_path)
    one = ranks.rank_train_model(cfg, ["--experiment", "one", "--path_weights", str(tmp_path / "w1")], draws=draws)
    two = launch(ranks.rank_train_model, cfg, ["--experiment", "two", "--path_weights", str(tmp_path / "w2")],
                 0, draws)
    assert one["seed"] == two[0]["seed"] == two[1]["seed"]
    assert two[0]["best"] == two[1]["best"]
    for t in two:
        assert t["step"] == one["step"] == 1 and t["topk"] == one["topk"]
    assert sorted(two[0]["saved"]) == sorted(one["saved"]) and two[1]["saved"] == [] and not two[1]["writer"]
    for a, b in zip(jax.tree.leaves(two[0]["params"]), jax.tree.leaves(two[1]["params"])):
        np.testing.assert_array_equal(a, b)
    _params_close(two[0]["params"], one["params"], cfg.TRAINING.LR, "state")
    _within(two[0]["mu"], one["mu"], "first moments", 1e-2)
    run = tmp_path / "w2" / cli.create_exp_name("two", cfg)
    assert sorted(p.name for p in run.iterdir()) == sorted(p.name for p in (tmp_path / "w1" / run.name.replace(
        "two", "one", 1)).iterdir())
    last = restore_checkpoint(str(run / "last"))
    _params_close(last["params"], one["params"], cfg.TRAINING.LR, "checkpoint")
    _within(last["opt_state"]["mu"], one["mu"], "checkpoint's first moments", 1e-2)

    # resume at world 2: every rank restores rank 0's last/ and trains epoch 1 alike
    cfg.TRAINING.EPOCHS = 2
    again = launch(ranks.rank_train_model, cfg, ["--experiment", "two", "--path_weights", str(tmp_path / "w2"),
                                                 "--resume", str(run / "last")], 0, draws)
    assert [t["step"] for t in again] == [2, 2] and again[0]["topk"] == again[1]["topk"] == one["topk"] + 5
    for a, b in zip(jax.tree.leaves(again[0]["params"]), jax.tree.leaves(again[1]["params"])):
        np.testing.assert_array_equal(a, b)
    assert again[1]["saved"] == [] and "last" in again[0]["saved"]


def test_validation_on_two_ranks_matches_one(tmp_path):
    """One validation batch of 8 keyframe-shared pairs at world 2 on the same
    state as world 1: the gathered per-pair outputs (the solver's draws the
    global batch's) at 1e-4 relative and the aggregation's AUCs equal; the
    loss metrics, global means of a REINFORCE loss whose refinement's hard
    0.15 m inlier threshold flips under a rounding (as the port's notes on
    loss parity say), at 2e-2. The prefilter is off, as in the fit test."""
    from test_torch_fit import fit_cfg

    root = write_split(tmp_path / "data", splits=(("train", ("s0",)), ("val", ("v0",))), n_queries=6, seed=5)
    cfg = fit_cfg(root)
    cfg.TPU.SAMPLING_PREFILTER = 0
    params = init_params_numpy(cfg, 0)
    one = ranks.rank_validation(cfg, params)
    two = launch(ranks.rank_validation, cfg, params)
    for k in one[0]:
        np.testing.assert_array_equal(two[0][0][k], two[1][0][k])
        per_pair = one[0][k].ndim > 0
        assert two[0][0][k].shape == one[0][k].shape == ((8,) if per_pair else ())
        np.testing.assert_allclose(two[0][0][k], one[0][k], rtol=1e-4 if per_pair else 2e-2, atol=1e-5, err_msg=k)
    assert two[0][1] == two[1][1]
    for k in one[1]:
        if "AUC" in k or "auc" in k or "prec" in k:
            assert two[0][1][k] == one[1][k], k


def test_feature_cache_is_built_once_on_two_ranks(tmp_path):
    """``fit`` with a feature cache at world 2: rank 0 builds it while rank 1
    waits, its files byte for byte a one-process build's, and both ranks
    train from it to one state, within the step tolerances of world 1's
    (the loss draws injected, as in the fit test)."""
    cfg, draws = _fit_setup(tmp_path)
    cfg.TPU.FEATURE_CACHE_DTYPE = "float32"
    params = init_params_numpy(cfg, 0)
    one_cfg, two_cfg = cfg.clone(), cfg.clone()
    one_cfg.TPU.FEATURE_CACHE, two_cfg.TPU.FEATURE_CACHE = str(tmp_path / "cache1"), str(tmp_path / "cache2")
    one = ranks.rank_fit(one_cfg, params, str(tmp_path / "run1"), draws)
    two = launch(ranks.rank_fit, two_cfg, params, str(tmp_path / "run2"), draws)
    for name in ("features.dat", "meta.json"):
        assert (tmp_path / "cache2" / name).read_bytes() == (tmp_path / "cache1" / name).read_bytes(), name
    assert one[1] == two[0][1] == two[1][1] == 1
    for a, b in zip(jax.tree.leaves(two[0][0]), jax.tree.leaves(two[1][0])):
        np.testing.assert_array_equal(a, b)
    _params_close(two[0][0], one[0], cfg.TRAINING.LR, "state")
    _within(two[0][2], one[2], "first moments", 1e-2)
