"""The port's overfit proxy (``tools/train_curve_torch.py``) against the JAX
tool it ports (``tools/train_curve.py``), on the CPU.

The proxy's parts are held against JAX's: the configuration, and the two
numpy batches bit for bit. Its loop runs 10 steps here, in fp32 and under
``TPU.HEADS_BF16`` (with ``HEADS_BF16_ON_CPU``), each step's loss and
gradients finite; ``tests/test_convergence.py``'s 150-step gates run on the
card (``chip_smoke.py --curve``), where the JAX test's 150 steps on the CPU
(~3 minutes on several cores) would be twice the tier-1 run's share.
"""

import numpy as np
import pytest
import torch

import tools.train_curve as jax_tool
import tools.train_curve_torch as tool

CURVE_KEYS = ("steps", "loss", "grad_norm", "grads_finite", "eval", "initial_loss", "final_loss", "loss_ratio",
              "initial_eval_loss", "final_eval_loss", "eval_loss_ratio", "initial_train_loss_window",
              "train_fused_topk", "initial_R_err", "final_R_err", "initial_vcre", "final_vcre", "steps_run", "mode",
              "lr", "seed", "batch_size", "wall_s", "heads_bf16", "device")


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: under the tier-1 run's test workers torch's
    OpenMP threads spin against each other's (``tests/test_torch_submission.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("lr", [4e-4, 1e-3])
def test_overfit_cfg_is_the_jax_tools(lr):
    ours, ref = tool.overfit_cfg(lr), jax_tool.overfit_cfg(lr)
    assert ours.to_dict() == ref.to_dict()
    assert ours.dump() == ref.dump()


@pytest.mark.parametrize("seed", [0, 3])
def test_batches_are_the_jax_tools_bit_for_bit(seed):
    ours, ref = tool.fixed_batch(seed), jax_tool.fixed_batch(seed)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k
    (batch, fmap), (jbatch, jfmap) = (f.geometric_fmap_batch(seed, 8, 126, 112, 384) for f in (tool, jax_tool))
    assert fmap.dtype == jfmap.dtype == np.float32 and np.array_equal(fmap, jfmap)
    assert batch.keys() == jbatch.keys() and all(np.array_equal(batch[k], jbatch[k]) for k in jbatch)


@pytest.mark.parametrize("mode", ["fp32", "heads_bf16"])
def test_short_curve_runs_finite(mode, one_torch_thread):
    """10 steps on the CPU: every step's loss, grad norm and gradients
    finite, the eval points at steps 0, 5 and 10 finite, every key of the
    JAX tool's curve (and ``heads_bf16``, ``device``) present; under the
    mode the heads' convs ran in bf16."""
    update = {"TPU.HEADS_BF16": True, "TPU.HEADS_BF16_ON_CPU": True} if mode == "heads_bf16" else None
    seen = []

    def hook(step, m):
        seen.append(step)
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"]) and bool(m["grads_finite"]), step

    curve = tool.run_curve(10, 5, 0, 4e-4, update, device="cpu", step_hook=hook)
    assert seen == list(range(1, 11))
    assert set(CURVE_KEYS) <= set(curve)
    assert curve["steps"] == seen and all(curve["grads_finite"]) and np.isfinite(curve["loss"]).all()
    assert curve["eval"]["step"] == [0, 5, 10]
    assert all(np.isfinite(v).all() for v in curve["eval"].values())
    assert curve["heads_bf16"] is (mode == "heads_bf16") and curve["device"] == "cpu" and curve["mode"] == "fmap"
    assert isinstance(tool.gate_failures(curve), list)
