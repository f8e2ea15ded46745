"""The checkpoint bridge (``tools/checkpoint_bridge_torch.py``) between
``mickey_tpu``'s orbax directories and the port's native ones, on the CPU at
``tests/test_torch_resume.py``'s small config.

- ``to-native`` on a ``last/`` that ``mickey_tpu``'s ``save_checkpoint``
  wrote (``TRAINING.GRAD_CLIP`` set and unset; with and without ``--config``,
  i.e. a target-built and a target-free restore), holding seeded non-zero
  Adam moments, count 7, step 7 and ``extra``: the port's
  ``restore_checkpoint`` and ``MicKeyTrainer.resume`` give that state
  bitwise, and the port's learning rate at the resumed count is
  ``mickey_tpu``'s schedule's, past a staircase step.
- ``to-native`` on a ``best_vcre/`` (no optimizer state): the port's
  ``build_model(checkpoint=...)`` serves the JAX trees bitwise.
- A port-written ``last/`` through ``from-native`` and back through
  ``to-native`` gives the same payload leaf for leaf; ``mickey_tpu``'s
  ``restore_checkpoint`` against the target its ``MicKeyTrainer.resume``
  builds gives the port's trees bitwise (the trainer itself is not built:
  ~28 s on this config), and its ``build_model`` serves a converted
  ``best_vcre/``.
- Refusals name the leaf or the field: other head widths, two Adam states,
  a schedule count that is not Adam's.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import tools.checkpoint_bridge_torch as bridge
from mickey_tpu.models.builder import build_model as jax_build_model
from mickey_tpu.nn.extractor import model_init
from mickey_tpu.training.checkpoint import restore_checkpoint as jax_restore
from mickey_tpu.training.checkpoint import save_checkpoint as jax_save
from mickey_tpu.training.train_step import make_lr_fn, make_optimizer
from mickey_tpu_torch.models import MicKeyTrainer, build_model
from mickey_tpu_torch.training.checkpoint import CHECKPOINT_FILE, restore_checkpoint
from mickey_tpu_torch.training.checkpoint import save_checkpoint as native_save
from mickey_tpu_torch.training.train_step import Optimizer
from mickey_tpu_torch.weights import init_params_numpy, is_bn_stat, params_to_numpy, trainable_to_torch, tree_leaves
from test_torch_validation import one_intra_op_thread, train_cfg  # noqa: F401 (the fixture applies here too)
from test_training import train_cfg as jax_train_cfg

STEP, EXTRA = 7, {"topk": 45.0, "epoch": 3}


def cfgs(clip=5.0):
    """The small config in both packages, with a staircase that count 7 has
    passed (7 // 5 = 1 step of 0.5)."""
    out = []
    for cfg in (train_cfg(), jax_train_cfg()):
        cfg.TRAINING.GRAD_CLIP = clip
        cfg.TRAINING.LR_STEP_INTERVAL, cfg.TRAINING.LR_STEP_GAMMA = 5, 0.5
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def params():
    """Full params (seed 0) and the trainables of seed 3 in ``mickey_tpu``'s
    layout, numpy arrays as its trainer saves them (``jax.device_get``)."""
    full = init_params_numpy(train_cfg(), 0)
    trainables = {k: jax.tree.map(np.asarray, v) for k, v in init_params_numpy(train_cfg(), 3).items()
                  if k != "dinov2"}
    return full, trainables


def test_the_layout_is_model_inits_trainables():
    """The bridge's layout is ``mickey_tpu``'s ``model_init`` without the
    backbone, as zeros of its shapes and dtypes, and the port's init without
    ``dinov2`` has that layout."""
    cfg = train_cfg()
    layout = bridge.trainable_layout(cfg)
    ref = jax.eval_shape(lambda k: model_init(k, cfg, include_backbone=False), jax.random.PRNGKey(0))
    assert jax.tree.structure(layout) == jax.tree.structure(ref)
    for got, want in zip(jax.tree.leaves(layout), jax.tree.leaves(ref)):
        assert isinstance(got, np.ndarray) and got.shape == want.shape and got.dtype == want.dtype
        assert not got.any()
    ours = {k: v for k, v in init_params_numpy(cfg, 5).items() if k != "dinov2"}
    bridge.check_layout(ours, layout, "params")


def _moment(trainables, rng, positive=False):
    """A seeded non-zero moment tree, zeros at the BatchNorm stats (which the
    optimizer never moves)."""
    def leaf(path, x):
        keys = tuple(k.key for k in path)
        if is_bn_stat(keys):
            return np.zeros_like(x)
        v = rng.standard_normal(np.shape(x)).astype(np.float32)
        return np.abs(v) if positive else v

    return jax.tree_util.tree_map_with_path(leaf, trainables)


def jax_opt_state(cfg, trainables, count=STEP, sched_count=STEP, seed=0):
    """``make_optimizer(cfg).init`` with seeded moments and the given counts;
    ``apply_if_finite``'s counters made non-initial, to be dropped."""
    rng = np.random.default_rng(seed)
    mu, nu = _moment(trainables, rng), _moment(trainables, rng, positive=True)

    def put(x):
        if isinstance(x, optax.ScaleByAdamState):
            return x._replace(count=np.int32(count), mu=mu, nu=nu)
        if isinstance(x, optax.ScaleByScheduleState):
            return x._replace(count=np.int32(sched_count))
        return x

    state = jax.tree.map(put, make_optimizer(cfg).init(trainables),
                         is_leaf=lambda x: isinstance(x, (optax.ScaleByAdamState, optax.ScaleByScheduleState)))
    return state._replace(notfinite_count=np.int32(2), total_notfinite=np.int32(5)), mu, nu


def assert_tree_equal(got, want, what=""):
    """Same nesting and None places, leaves bitwise with their dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), what
        for k in want:
            assert_tree_equal(got[k], want[k], f"{what}/{k}")
    elif want is None:
        assert got is None, what
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("clip", [5.0, 0.0])
def test_to_native_last_restores_and_resumes_bitwise(params, tmp_path, clip):
    """Converted with the config (a target-built restore) and without it
    (orbax's target-free restore): the same payload, which the port restores
    and resumes bitwise."""
    cfg, jcfg = cfgs(clip)
    full, trainables = params
    state, mu, nu = jax_opt_state(jcfg, trainables)
    jax_save(str(tmp_path / "last"), trainables, step=STEP, opt_state=state, extra=EXTRA)
    for c, out in ((jcfg, "native"), (None, "native_free")):
        summary = bridge.to_native(str(tmp_path / "last"), str(tmp_path / out), c)
        assert summary["dropped"] == {"notfinite_count": 2, "last_finite": True, "total_notfinite": 5}
    assert_payload_equal(torch.load(tmp_path / "native_free" / CHECKPOINT_FILE, weights_only=True),
                         torch.load(tmp_path / "native" / CHECKPOINT_FILE, weights_only=True))

    ck = restore_checkpoint(str(tmp_path / "native"))
    assert ck["step"] == STEP and ck["extra"] == EXTRA and type(ck["extra"]["epoch"]) is int
    assert_tree_equal(ck["params"], trainables, "params")
    assert ck["opt_state"]["count"] == STEP
    assert_tree_equal(ck["opt_state"]["mu"], mu, "mu")
    assert_tree_equal(ck["opt_state"]["nu"], nu, "nu")

    tr = MicKeyTrainer(cfg, params=full, device="cpu", out_dir=str(tmp_path / "run"))
    assert tr.resume(str(tmp_path / "native")) == EXTRA["epoch"]
    assert tr.global_step == tr.state.step == STEP and tr.topk == EXTRA["topk"]
    assert int(tr.state.opt_state.count) == STEP
    assert_tree_equal(params_to_numpy(tr.state.params), trainables, "resumed params")
    assert_tree_equal(tr._moments(tr.state.opt_state.mu), mu, "resumed mu")
    assert_tree_equal(tr._moments(tr.state.opt_state.nu), nu, "resumed nu")
    lr = Optimizer(cfg).lr_fn(tr.state.opt_state.count)
    want = np.asarray(make_lr_fn(jcfg)(STEP))
    assert np.float32(lr) == want and want < np.float32(jcfg.TRAINING.LR)


def test_to_native_best_vcre_serves_the_jax_trees(params, tmp_path, monkeypatch, capsys):
    """Through the command line, ``--config`` the run's ``config.yaml`` as
    ``mickey_tpu``'s trainer writes it (``cfg.dump()``)."""
    cfg, jcfg = cfgs()
    full, trainables = params
    jax_save(str(tmp_path / "best_vcre"), trainables, step=STEP, extra=EXTRA)
    (tmp_path / "config.yaml").write_text(jcfg.dump())
    assert bridge.main(["to-native", str(tmp_path / "best_vcre"), str(tmp_path / "native"),
                        "--config", str(tmp_path / "config.yaml")]) == 0
    assert "step=7  count=None  extra={'epoch': 3, 'topk': 45.0}" in capsys.readouterr().out
    ck = restore_checkpoint(str(tmp_path / "native"))
    assert "opt_state" not in ck and ck["extra"] == EXTRA
    monkeypatch.setenv("MICKEY_ALLOW_RANDOM_BACKBONE", "1")
    monkeypatch.delenv("MICKEY_DINOV2_PATH", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    model = build_model(cfg, full, checkpoint=str(tmp_path / "native"), device="cpu")
    served = params_to_numpy({k: v for k, v in model.params.items() if k != "dinov2"})
    assert_tree_equal(served, trainables, "served")


def test_from_native_round_trips_and_opens_in_mickey_tpu(params, tmp_path, monkeypatch):
    """A port-written last/ and best_vcre/ (the trainer's own writer, with
    seeded moments and count 7) through from-native: mickey_tpu restores the
    port's trees bitwise and serves the best_vcre/ copy; back
    through to-native, the payload is the port's leaf for leaf."""
    cfg, jcfg = cfgs()
    full, trainables = params
    tr = MicKeyTrainer(cfg, params=dict(trainables, dinov2=full["dinov2"]), device="cpu",
                       out_dir=str(tmp_path / "port"))
    _, mu, nu = jax_opt_state(jcfg, trainables, seed=1)
    trainable_paths = [p for p, _ in tree_leaves(tr.state.params) if not is_bn_stat(p)]
    with torch.no_grad():
        for name, tree in (("mu", mu), ("nu", nu)):
            ported = dict(tree_leaves(trainable_to_torch(tree)))  # the port's tensor layout
            for path, t in zip(trainable_paths, getattr(tr.state.opt_state, name)):
                t.copy_(ported[path])
        tr.state.opt_state.count.fill_(STEP)
    tr.global_step = tr.state.step = STEP
    tr.topk = EXTRA["topk"]
    tr.maybe_checkpoint({"val_vcre/auc_vcre": 0.5, "val_AUC_pose/auc_pose": 0.5}, epoch=EXTRA["epoch"])
    port = restore_checkpoint(str(tmp_path / "port" / "last"))
    assert_tree_equal(port["opt_state"]["mu"], mu, "port mu")

    orbax = tmp_path / "orbax"
    assert bridge.from_native(str(tmp_path / "port" / "last"), str(orbax / "last"), jcfg)["count"] == STEP
    # the target mickey_tpu's MicKeyTrainer.resume restores against
    like = {"params": trainables, "opt_state": make_optimizer(jcfg).init(trainables), "step": 0,
            "extra": {"topk": 0.0, "epoch": 0}}
    back = jax_restore(str(orbax / "last"), like=like)
    assert back["step"] == STEP and back["extra"] == EXTRA
    assert_tree_equal(back["params"], port["params"], "orbax params")
    adam = back["opt_state"].inner_state[-1][0]
    assert isinstance(adam, optax.ScaleByAdamState) and int(adam.count) == STEP
    assert int(back["opt_state"].inner_state[-1][1].count) == STEP
    assert (int(back["opt_state"].notfinite_count), bool(back["opt_state"].last_finite)) == (0, True)
    assert_tree_equal(adam.mu, port["opt_state"]["mu"], "orbax mu")
    assert_tree_equal(adam.nu, port["opt_state"]["nu"], "orbax nu")

    bridge.to_native(str(orbax / "last"), str(tmp_path / "again"), jcfg)
    assert_payload_equal(torch.load(tmp_path / "again" / CHECKPOINT_FILE, weights_only=True),
                         torch.load(tmp_path / "port" / "last" / CHECKPOINT_FILE, weights_only=True))

    assert bridge.from_native(str(tmp_path / "port" / "best_vcre"), str(orbax / "best_vcre"),
                              jcfg)["items"] == ["params", "step"]
    monkeypatch.setenv("MICKEY_ALLOW_RANDOM_BACKBONE", "1")
    monkeypatch.setenv("MICKEY_NO_DOWNLOAD", "1")
    monkeypatch.delenv("MICKEY_DINOV2_PATH", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    # build_model's random init compiles ~100 XLA programs (~28 s at this config); its layout stands in for it
    monkeypatch.setattr("mickey_tpu.models.builder.model_init", lambda key, c: dict(trainables, dinov2=full["dinov2"]))
    served = jax_build_model(jcfg, checkpoint=str(orbax / "best_vcre")).params
    assert_tree_equal(jax.device_get({k: v for k, v in served.items() if k != "dinov2"}), port["params"], "served")


def assert_payload_equal(a, b, what=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            assert_payload_equal(a[k], b[k], f"{what}/{k}")
    elif torch.is_tensor(b):
        assert torch.is_tensor(a) and a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert type(a) is type(b) and a == b, what


def test_refusals_name_the_leaf_or_the_field(params, tmp_path):
    _, jcfg = cfgs()
    _, trainables = params
    jax_save(str(tmp_path / "last"), trainables, step=STEP, extra=EXTRA)
    wide = jax_train_cfg()
    wide.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 128, 16]
    with pytest.raises(ValueError, match=r"params/depth_head/out/w: shape \(1, 1, 8, 1\) in the checkpoint, "
                                         r"\(1, 1, 16, 1\) expected"):
        bridge.to_native(str(tmp_path / "last"), str(tmp_path / "wide"), wide)
    native_save(str(tmp_path / "native"), trainables, step=STEP)
    with pytest.raises(ValueError, match=r"params/depth_head/out/w: shape \(1, 1, 8, 1\) in the checkpoint"):
        bridge.from_native(str(tmp_path / "native"), str(tmp_path / "wide_orbax"), wide)

    # moments of one leaf: the Adam states are counted before any layout is read
    two = optax.chain(optax.adam(1e-3), optax.adam(1e-3)).init(trainables["det_head"]["out"])
    jax_save(str(tmp_path / "two"), trainables, step=STEP, opt_state=two, extra=EXTRA)
    with pytest.raises(ValueError, match=r"opt_state: 2 Adam states \(fields count, mu, nu\) at \['/0/0', '/1/0'\]"):
        bridge.to_native(str(tmp_path / "two"), str(tmp_path / "two_native"))

    state, _, _ = jax_opt_state(jcfg, trainables, sched_count=STEP - 1)
    jax_save(str(tmp_path / "skew"), trainables, step=STEP, opt_state=state, extra=EXTRA)
    with pytest.raises(ValueError, match=r"opt_state/inner_state/1/1/count: the schedule's count 6 != "
                                         r"Adam's count 7 \(opt_state/inner_state/1/0/count\)"):
        bridge.to_native(str(tmp_path / "skew"), str(tmp_path / "skew_native"), jcfg)
