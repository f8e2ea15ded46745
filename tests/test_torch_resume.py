"""Native checkpoints, resume and ``build_model(checkpoint=<dir>)`` on the CPU.

The port writes its own checkpoint format (``training/checkpoint.py``):
one ``torch.load(weights_only=True)`` file in ``mickey_tpu``'s layout. The
tests hold the file against ``params_to_numpy`` and against the JAX
package's trees (the trainables and optax's Adam moments) leaf for leaf,
the restore bitwise, and a resumed trainer's next step bitwise equal to
the first trainer's from the same generator seed. Sizes as
``tests/test_torch_validation.py``.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from mickey_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from mickey_tpu.training.train_step import init_train_state as jax_init_train_state
from mickey_tpu_torch.models import MicKeyTrainer, build_model
from mickey_tpu_torch.training.checkpoint import CHECKPOINT_FILE, restore_checkpoint
from mickey_tpu_torch.weights import init_params_numpy, is_bn_stat, params_to_numpy, trainable_to_torch, tree_leaves
from test_torch_validation import B, one_intra_op_thread, train_cfg  # noqa: F401 (the fixture applies here too)
from test_training import synthetic_batch
from test_training import train_cfg as jax_train_cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A trainer after one step and topk 45, checkpointed at epoch 3."""
    cfg = train_cfg()
    out = tmp_path_factory.mktemp("run")
    params = init_params_numpy(cfg, 0)
    tr = MicKeyTrainer(cfg, params=params, device="cpu", out_dir=str(out))
    batch = synthetic_batch(np.random.default_rng(1), B=B)
    tr.training_step(batch)
    tr.topk = 45.0
    tr.maybe_checkpoint({"val_vcre/auc_vcre": 0.5, "val_AUC_pose/auc_pose": 0.5}, epoch=3)
    return cfg, params, tr, batch, out


def _adam(state):
    """optax's ScaleByAdamState inside the JAX package's optimizer state."""
    if isinstance(state, optax.ScaleByAdamState):
        return state
    if isinstance(state, tuple):
        return next((s for s in map(_adam, state) if s is not None), None)
    return None


def test_checkpoint_files_map_onto_the_jax_trees(run):
    cfg, params, tr, _, out = run
    assert sorted(os.listdir(out)) == ["best_pose", "best_vcre", "last"]
    for d in ("best_pose", "best_vcre", "last"):
        assert os.listdir(out / d) == [CHECKPOINT_FILE]
        payload = torch.load(out / d / CHECKPOINT_FILE, weights_only=True)
        assert payload["step"] == 1 and payload["extra"] == {"topk": 45.0, "epoch": 3}
        assert ("opt_state" in payload) == (d == "last")
    ck = restore_checkpoint(str(out / "last"))
    jstate, _ = jax_init_train_state(jax_train_cfg(), jax.tree.map(np.asarray, params))
    ours = params_to_numpy(tr.state.params)
    assert jax.tree.structure(ck["params"]) == jax.tree.structure(ours) == jax.tree.structure(jstate.params)
    for a, b, j in zip(jax.tree.leaves(ck["params"]), jax.tree.leaves(ours), jax.tree.leaves(jstate.params)):
        assert a.dtype == b.dtype == np.float32 and a.shape == np.shape(j)
        np.testing.assert_array_equal(a, b)
    adam = _adam(jstate.opt_state)
    assert ck["opt_state"]["count"] == 1 == int(tr.state.opt_state.count)
    for name in ("mu", "nu"):
        tree = ck["opt_state"][name]
        assert jax.tree.structure(tree) == jax.tree.structure(getattr(adam, name))
        assert [a.shape for a in jax.tree.leaves(tree)] == [np.shape(j) for j in jax.tree.leaves(getattr(adam, name))]
        back = dict(tree_leaves(trainable_to_torch(tree)))  # the port's layout again, by path
        moments = iter(getattr(tr.state.opt_state, name))
        for path, _ in tree_leaves(tr.state.params):
            want = torch.zeros_like(back[path]) if is_bn_stat(path) else next(moments)
            assert torch.equal(back[path], want), (name, path)


def test_resume_is_bitwise(run):
    """Parameters, moments, count, step, topk and epoch restored bitwise;
    then one more step of each trainer, from the same generator seed, gives
    the same parameters bitwise."""
    cfg, params, tr, batch, out = run
    # other trainables, the same frozen backbone (a checkpoint leaves DINOv2 out)
    other = dict(init_params_numpy(cfg, 99), dinov2=params["dinov2"])
    tr2 = MicKeyTrainer(cfg, params=other, device="cpu", out_dir=str(out))
    assert tr2.resume(str(out / "last")) == 3
    assert tr2.topk == 45.0 and tr2.global_step == 1 and tr2.state.step == 1
    assert torch.equal(tr2.state.opt_state.count, tr.state.opt_state.count)

    def flat(t):
        return [x.detach() for _, x in tree_leaves(t.state.params)] + list(t.state.opt_state.mu) + list(
            t.state.opt_state.nu)

    assert all(torch.equal(a, b) for a, b in zip(flat(tr2), flat(tr)))
    for t in (tr, tr2):
        t.generator.manual_seed(11)
        t.training_step(batch)
    assert all(torch.equal(a, b) for a, b in zip(flat(tr2), flat(tr)))
    with pytest.raises(ValueError, match="optimizer state"):
        tr2.resume(str(out / "best_vcre"))


def test_build_model_loads_native_checkpoints_and_refuses_orbax(run, tmp_path, monkeypatch):
    cfg, params, _, _, out = run
    monkeypatch.setenv("MICKEY_ALLOW_RANDOM_BACKBONE", "1")
    monkeypatch.delenv("MICKEY_DINOV2_PATH", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    saved = restore_checkpoint(str(out / "best_pose"))["params"]
    model = build_model(cfg, params, checkpoint=str(out / "best_pose"), device="cpu")
    expect = build_model(cfg, {**params, **saved}, device="cpu")
    got, want = tree_leaves(model.params), tree_leaves(expect.params)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(torch.equal(torch.as_tensor(a), torch.as_tensor(b)) for (_, a), (_, b) in zip(got, want))
    assert not torch.equal(model.params["det_head"]["out"]["w"],
                           build_model(cfg, params, device="cpu").params["det_head"]["out"]["w"])

    orbax_dir = tmp_path / "orbax_ckpt"
    jax_save_checkpoint(str(orbax_dir), {k: v for k, v in params.items() if k != "dinov2"}, step=1)
    with pytest.raises(NotImplementedError, match="orbax"):
        build_model(cfg, params, checkpoint=str(orbax_dir), device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(NotImplementedError, match="not a native checkpoint"):
        build_model(cfg, params, checkpoint=str(tmp_path / "empty"), device="cpu")


def test_deterministic_backward_sets_and_restores_the_mode():
    """The train step's backward runs in PyTorch's deterministic mode, warnings
    only, without the mode's NaN fill of new memory; the caller's settings
    come back on exit, also when the span raises."""
    from mickey_tpu_torch.training.train_step import deterministic_backward

    det = torch.utils.deterministic

    def settings():
        return (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
                det.fill_uninitialized_memory)

    before = settings()
    with pytest.raises(RuntimeError, match="inside"):
        with deterministic_backward():
            assert settings() == (True, True, False)
            raise RuntimeError("inside")
    assert settings() == before
