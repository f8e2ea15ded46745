"""Rehearsal of chip_smoke.py's phase functions on the CPU at a tiny size.

On CPU tensors every kernel wrapper takes its plain version, so this checks
the script's plumbing (inputs, comparisons, both serving layouts, the
training steps, the stage-by-stage checks against the plain path, the
bounds), not the kernels. The script itself refuses to run without a GPU,
which is checked too.
"""

import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from mickey_tpu_torch import default_config
from mickey_tpu_torch.models import MicKeyTrainer, build_model
from mickey_tpu_torch.weights import init_params_numpy


def _tiny_cfg():
    cfg = default_config()
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 16, 8]
    cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
    cfg.PROCRUSTES.IT_MATCHES = 3
    cfg.PROCRUSTES.IT_RANSAC = 8
    cfg.PROCRUSTES.NUM_SAMPLED_MATCHES = 32
    cfg.TPU.SAMPLING_PREFILTER = 128
    return cfg


def _tiny_params(cfg, depth=2):
    p = init_params_numpy(cfg, 0)
    blocks = p["dinov2"]["blocks"]

    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:depth]

    p["dinov2"]["blocks"] = cut(blocks)
    return p


def test_kernel_phase_rehearsal():
    inp = chip_smoke.kernel_inputs("cpu", images=2, seq=37, heads=2, kpts=40, desc=16, topl=4,
                                   prefilter=64, samples=50, hyps=7)
    errs = chip_smoke.check_kernels(inp)
    assert set(errs) == set(chip_smoke.SERVING_KERNELS)
    # plain against plain: exact, except K1 where the bf16 output is held against fp32
    assert errs.pop("flash_attention_packed") < chip_smoke.ATTN_TOL
    assert all(e == 0.0 for e in errs.values())


def test_slice_phase_rehearsal():
    cfg = _tiny_cfg()
    params = _tiny_params(cfg)
    for bf16 in (True, False):
        cfg.MICKEY.DINOV2.FLOAT16 = bf16
        model = build_model(cfg, params, device="cpu")
        outs = chip_smoke.run_slice(model, *chip_smoke.slice_inputs("cpu", pairs=2, height=112, width=140))
        assert outs["general"].R.shape == (2, 3, 3) and outs["shared"].t.shape == (2, 1, 3)
    small = chip_smoke.check_against_plain(model, build_model(cfg, params, device="cpu"),
                                           *chip_smoke.slice_inputs("cpu", pairs=2, height=56, width=70))
    assert small["backbone_cos"] > 0.999999 and small["pose_rel"] == 0.0


def test_sets_agree_rejects_a_real_difference():
    v = torch.tensor([[0.9, 0.5, 0.1]])
    chip_smoke._sets_agree(v, torch.tensor([[3, 1, 2]]), v, torch.tensor([[3, 1, 7]]), "near-tie at the boundary")
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke._sets_agree(v, torch.tensor([[3, 1, 2]]), v, torch.tensor([[4, 1, 2]]), "x")


def test_refuses_without_gpu(tmp_path):
    # alone in a directory, and in the repo on a machine without CUDA: no result, non-zero
    script = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(script, "rb").read())
    for path, cwd in ((str(lone), str(tmp_path)), (script, os.path.dirname(script))):
        proc = subprocess.run([sys.executable, path], cwd=cwd, capture_output=True, text=True,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_train_kernel_phase_rehearsal():
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    errs = chip_smoke.check_train_kernels(tin)
    assert set(errs) | set(chip_smoke.SERVING_KERNELS) == {name for name, _, _ in chip_smoke.KERNELS}
    assert all(e == 0.0 for e in errs.values())  # plain against plain


def _tiny_train_cfg():
    cfg = _tiny_cfg()
    cfg.MICKEY.DINOV2.FLOAT16 = False
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    gh.IT_MATCHES, gh.IT_RANSAC, gh.NUM_CORR_3d3d, gh.NUM_REF_STEPS = 2, 3, 5, 1
    cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES = 16
    return cfg


def test_train_phase_rehearsal():
    cfg = _tiny_train_cfg()
    params = _tiny_params(cfg)
    trainer = MicKeyTrainer(cfg, params=params, device="cpu")
    steps = chip_smoke.run_train(trainer, chip_smoke.train_batch("cpu", pairs=2, height=126, width=140), steps=2)
    assert len(steps) == 2 and all(m["grads_finite"] == 1.0 for m in steps)
    small = chip_smoke.check_train_against_plain(cfg, params, torch.device("cpu"), pairs=2, height=126, width=140)
    # plain against plain, except the distances to fp64, the same on both sides
    assert small.pop("card_worst_leaf") == small.pop("cpu_worst_leaf")
    card, cpu = small.pop("card_worst_leaf_vs_fp64"), small.pop("cpu_worst_leaf_vs_fp64")
    assert card == cpu and 0.0 < card < chip_smoke.GRAD_TOL
    assert all(v == 0.0 for v in small.values())


def test_run_train_rejects_unchanged_parameters():
    cfg = _tiny_train_cfg()
    trainer = MicKeyTrainer(cfg, params=_tiny_params(cfg), device="cpu")
    trainer.train_step.optimizer.lr_fn = lambda step: 0.0  # BN stats move, parameters do not
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.run_train(trainer, chip_smoke.train_batch("cpu", pairs=2, height=126, width=140), steps=1)


def test_bounds_and_library_call():
    """The bounds follow from the shapes; the library call beside K1 computes
    the function of K1's plain version."""
    inp = chip_smoke.kernel_inputs("cpu", images=2, seq=37, heads=2, kpts=40, desc=16, topl=4,
                                   prefilter=64, samples=50, hyps=7)
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    bounds = chip_smoke.kernel_bounds(inp, tin)
    assert set(bounds) == {name for name, _, _ in chip_smoke.KERNELS}
    assert all(ms > 0 and by in ("bytes", "operations") for ms, by in bounds.values())
    from mickey_tpu_torch.ops.flash_attention import attention_packed_plain

    out = chip_smoke.library_calls(inp)["flash_attention_packed"]()
    ref = attention_packed_plain(inp["qkv"].float(), inp["heads"])
    b, h, s_, d = out.shape
    torch.testing.assert_close(out.float().permute(0, 2, 1, 3).reshape(b, s_, h * d), ref, atol=2e-2, rtol=0)
