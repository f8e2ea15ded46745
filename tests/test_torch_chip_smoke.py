"""Rehearsal of chip_smoke.py's phase functions on the CPU at a tiny size.

On CPU tensors every kernel wrapper takes its plain version, so this checks
the script's plumbing (inputs, comparisons, both serving layouts and the
unpacked-attention backbone, the training steps on both matcher routes, the
stage-by-stage checks against the plain path, the launch checks, the bounds),
not the kernels. The script itself refuses to run without a GPU, which is
checked too.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

import chip_smoke
from mickey_tpu_torch import default_config
from mickey_tpu_torch.models import MicKeyTrainer, MickeyRelativePose, build_model
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


def _tiny_kernel_inputs():
    return chip_smoke.kernel_inputs("cpu", images=2, seq=37, heads=2, kpts=40, desc=16, topl=4, prefilter=64,
                                    samples=50, hyps=7, old_images=2, old_seq=48, old_len=37)


def test_kernel_phase_rehearsal():
    inp = _tiny_kernel_inputs()
    errs = chip_smoke.check_kernels(inp)
    assert set(errs) == set(chip_smoke.SERVING_KERNELS) | {"flash_attention", "flash_attention_packed_f32",
                                                             "flash_attention_f32", "flash_attention_packed_upcast"}
    # plain against plain: exact, except K1 / K1b where the bf16 output is held against fp32
    assert errs.pop("flash_attention_packed") < chip_smoke.ATTN_TOL
    assert errs.pop("flash_attention") < chip_smoke.ATTN_TOL
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
    cfg_u = cfg.clone()
    cfg_u.TPU.PACKED_ATTENTION = False
    model_u = MickeyRelativePose(cfg_u, model.params, device="cpu")
    ims = chip_smoke.slice_inputs("cpu", pairs=2, height=112, width=140)
    outs = chip_smoke.run_slice(model_u, *ims, layouts=("general",))
    assert set(outs) == {"general"}
    unpacked = chip_smoke.compare_backbones(model, model_u, *ims[:2], "unpacked backbone")
    assert unpacked["backbone_cos"] > 0.999999 and unpacked["backbone_max_abs"] < 1e-5


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
    errs.update(chip_smoke.check_topk_train_kernels(tin, prefilter=64, topl=4))
    serving = (set(chip_smoke.SERVING_KERNELS) | set(chip_smoke.UNPACKED_SERVING_KERNELS)
               | set(chip_smoke.EXACT_KERNELS) | set(chip_smoke.ABLATION_KERNELS) | {"flash_attention_f32"})
    assert set(errs) | serving == {name for name, _, _ in chip_smoke.KERNELS}
    assert all(e == 0.0 for e in errs.values())  # plain against plain


def test_launch_check():
    counts = {name: 1 for name, _, _ in chip_smoke.KERNELS}
    chip_smoke._launched(counts, "x", chip_smoke.FUSED_TRAIN_KERNELS)
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke._launched(dict(counts, lse_bwd=0), "x", chip_smoke.FUSED_TRAIN_KERNELS)
    with pytest.raises(chip_smoke.SmokeError):  # a dense-route kernel on the fused route
        chip_smoke._launched(counts, "x", chip_smoke.FUSED_TRAIN_KERNELS, chip_smoke.DENSE_MATCHER_KERNELS)


def _tiny_train_cfg():
    cfg = _tiny_cfg()
    cfg.MICKEY.DINOV2.FLOAT16 = False
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    gh.IT_MATCHES, gh.IT_RANSAC, gh.NUM_CORR_3d3d, gh.NUM_REF_STEPS = 2, 3, 5, 1
    cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES = 16
    return cfg


def _wall_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


@pytest.mark.parametrize("fused", [False, True])
def test_train_phase_rehearsal(fused, monkeypatch):
    cfg = _tiny_train_cfg()
    cfg.TPU.TRAIN_FUSED_TOPK = fused
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
    monkeypatch.setattr(chip_smoke, "_elapsed_ms", _wall_ms)  # CUDA events need the card
    stages = chip_smoke._train_stage_times(trainer, chip_smoke.train_batch("cpu", pairs=2, height=126, width=140),
                                           iters=1)
    assert set(stages) == {"backbone_fwd", "heads_fwd", "matcher_fwd", "loss_fwd", "backward", "optimizer", "step"}


def test_run_train_rejects_unchanged_parameters():
    cfg = _tiny_train_cfg()
    trainer = MicKeyTrainer(cfg, params=_tiny_params(cfg), device="cpu")
    trainer.train_step.optimizer.lr_fn = lambda step: 0.0  # BN stats move, parameters do not
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.run_train(trainer, chip_smoke.train_batch("cpu", pairs=2, height=126, width=140), steps=1)


def test_bounds_and_library_call():
    """The bounds follow from the shapes; the library call beside K1 computes
    the function of K1's plain version."""
    inp = _tiny_kernel_inputs()
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    bounds = chip_smoke.kernel_bounds(inp, tin)
    assert set(bounds) == {name for name, _, _ in chip_smoke.KERNELS}
    assert all(ms > 0 and by in ("bytes", "operations") for ms, by in bounds.values())
    from mickey_tpu_torch.ops.flash_attention import attention_packed_plain

    out = chip_smoke.library_calls(inp)["flash_attention_packed"]()
    ref = attention_packed_plain(inp["qkv"].float(), inp["heads"])
    b, h, s_, d = out.shape
    torch.testing.assert_close(out.float().permute(0, 2, 1, 3).reshape(b, s_, h * d), ref, atol=2e-2, rtol=0)


def test_exact_phase_rehearsal(monkeypatch):
    """Phase 3's exact path and its checks at a tiny size, plain against
    plain: the full output's shapes, the dense route's lite outputs, the
    backbone agreements, the dense/fused table cross-check, the checkpoint
    round trip, the small-input stages; and the exact stage timing and the
    K1-old A/B's plumbing."""
    cfg = _tiny_cfg()
    params = _tiny_params(cfg)
    model = build_model(cfg, params, device="cpu")
    cfg_x = cfg.clone()
    cfg_x.MICKEY.DINOV2.FLOAT16 = False
    cfg_xd = cfg_x.clone()
    cfg_xd.TPU.FUSED_TOPK = False
    model_x = MickeyRelativePose(cfg_x, model.params, device="cpu")
    ims = chip_smoke.slice_inputs("cpu", pairs=2, height=112, width=140)
    full = chip_smoke.run_full(model_x, *ims)
    assert full.corr.final_scores.shape == (2, 80, 80) and full.estimate.inlier_mask.shape == (2, 32)
    outs = chip_smoke.run_slice(MickeyRelativePose(cfg_xd, model.params, device="cpu"), *ims)
    assert outs["general"].estimate is None and outs["shared"].R.shape == (2, 3, 3)
    cfg_xu = cfg_x.clone()
    cfg_xu.TPU.PACKED_ATTENTION = False
    agree = chip_smoke.compare_backbones(model_x, MickeyRelativePose(cfg_xu, model.params, device="cpu"), *ims[:2],
                                         "unpacked", max_rel=1e-5)
    assert agree["backbone_rel"] < 1e-6
    assert chip_smoke.compare_backbones(model_x, model, *ims[:2], "bf16")["backbone_cos"] > 0.999
    table = chip_smoke.check_dense_table(model, *ims)
    # two formulas of the same scores (softmax products; the fused route's closed form)
    assert table["table_max_abs"] < 1e-6 and all(0.0 < r <= 1.0 for r in table["global_topP_recall"])
    assert chip_smoke.check_checkpoint(cfg, params, torch.device("cpu"), *ims)["bitwise"]
    small = chip_smoke.check_exact_against_plain(model_x, MickeyRelativePose(cfg_x, model.params, device="cpu"),
                                                 *chip_smoke.slice_inputs("cpu", pairs=2, height=56, width=70))
    assert all(v == 0.0 for v in small.values())
    monkeypatch.setattr(chip_smoke, "_elapsed_ms", _wall_ms)  # CUDA events need the card
    stages = chip_smoke._stage_times(model_x, *ims, fused=False)
    assert set(stages) == {"backbone", "heads", "matcher", "solver"}
    assert set(chip_smoke.ablation_times(_tiny_kernel_inputs(), iters=1)) == {"k1_bf16", "k1_old_f32"}


def test_within_bf16_ulp():
    ref = torch.tensor([1.0, 0.99609375, -3.0, 1e-3]).to(torch.bfloat16)
    up = torch.nextafter(ref.float(), torch.full((4,), 1e9)).to(torch.bfloat16)  # one bf16 step away
    chip_smoke._within_bf16_ulp(ref, ref, "same")
    chip_smoke._within_bf16_ulp(up, ref, "one ulp")
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke._within_bf16_ulp((ref.float() * 1.02).to(torch.bfloat16), ref, "two percent")


def test_attention_checks_rehearsal(monkeypatch):
    """The bf16 attention checks at a tiny size, plain against plain: the
    serving-shape check with its bitwise comparisons and the ``seq_len`` < S
    case, the ragged lengths, and the back-to-back timer's plumbing."""
    inp = _tiny_kernel_inputs()
    errs = chip_smoke.check_attention_kernels(inp)
    assert set(errs) == {"flash_attention_packed", "flash_attention"}
    assert all(e < chip_smoke.ATTN_TOL for e in errs.values())
    assert chip_smoke.check_attention_shapes("cpu", seqs=(37, 65, 64, 1), heads=2) < chip_smoke.ATTN_TOL
    monkeypatch.setattr(chip_smoke, "_elapsed_ms", _wall_ms)  # CUDA events need the card
    calls = []
    assert chip_smoke.time_many_ms(lambda: calls.append(0), reps=3, iters=2) >= 0.0
    assert len(calls) == 9  # one warm-up run and two timed ones, three calls each


def test_attention_checks_catch_a_wrong_kernel(monkeypatch):
    """A kernel that ignores ``seq_len`` passes at seq_len = S and fails the
    masked case; one that differs between its two entries fails the bitwise
    comparison."""
    from mickey_tpu_torch.ops import flash_attention as fa

    inp = _tiny_kernel_inputs()
    unmasked = lambda q, k, v, seq_len: fa.attention_plain(q, k, v, q.shape[2])  # noqa: E731
    monkeypatch.setattr(fa, "flash_attention", unmasked)
    with pytest.raises(chip_smoke.SmokeError, match="seq_len"):
        chip_smoke.check_attention_kernels(inp)
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v, seq_len: fa.attention_plain(q, k, v, seq_len) + 0.01)
    with pytest.raises(chip_smoke.SmokeError, match="differs"):
        chip_smoke.check_attention_kernels(inp)


def test_f32_attention_checks_rehearsal():
    """K1f's checks at a tiny size, plain against plain: the serving-shape
    check with its bitwise comparisons (strided against packed, launch
    against launch) and the ragged lengths with ``seq_len`` < S."""
    errs = chip_smoke.check_f32_attention_kernels(_tiny_kernel_inputs())
    assert set(errs) == {"flash_attention_packed_f32", "flash_attention_f32"}
    assert chip_smoke.check_attention_shapes("cpu", torch.float32, seqs=(37, 65, 64, 1), heads=2) < chip_smoke.F32_ATTN_TOL


def test_f32_attention_checks_catch_a_wrong_kernel(monkeypatch):
    """A K1f that ignores ``seq_len`` fails the masked case; one a TF32
    rounding off (1e-4 relative) fails the 1e-5 tolerance."""
    from mickey_tpu_torch.ops import flash_attention as fa

    unmasked = lambda q, k, v, seq_len: fa.attention_plain(q, k, v, q.shape[2])  # noqa: E731
    monkeypatch.setattr(fa, "flash_attention_f32", unmasked)
    with pytest.raises(chip_smoke.SmokeError, match="seq_len"):
        chip_smoke.check_attention_shapes("cpu", torch.float32, seqs=(37,), heads=2)
    monkeypatch.setattr(fa, "flash_attention_packed_f32", lambda qkv, h: fa.attention_packed_plain(qkv, h) * (1 + 1e-4))
    with pytest.raises(chip_smoke.SmokeError, match="exceeds"):
        chip_smoke.check_f32_attention_kernels(_tiny_kernel_inputs())


def test_f32_attention_bounds_count_tf32_passes():
    """K1f's bound is three TF32 passes of its two products at 495 TFLOP/s.
    K1-old's operands are bf16: its Q K^T is one bf16 pass at 989 TFLOP/s
    and its P V three (P in three bf16 parts, cheaper than two TF32 passes),
    over the keys before ``old_len``."""
    inp = _tiny_kernel_inputs()
    bounds = chip_smoke.kernel_bounds(inp, chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16))
    imgs, seq, c3 = inp["qkv32"].shape
    flops = 4.0 * imgs * inp["heads"] * seq * seq * 64
    want = max(3 * flops / chip_smoke.PEAK_TF32, (imgs * seq * c3 * 4 / 3 * 4) / chip_smoke.PEAK_BYTES) * 1e3
    assert bounds["flash_attention_packed_f32"][0] == pytest.approx(want)
    o_imgs, o_seq, o_c3 = inp["qkv_old"].shape
    half = 2.0 * o_imgs * inp["heads"] * o_seq * inp["old_len"] * 64  # the flops of one product
    old_ops = (half / chip_smoke.PEAK_BF16 + 3 * half / chip_smoke.PEAK_BF16) * 1e3
    old_bytes = o_imgs * o_seq * o_c3 * 4 / 3 * 2 / chip_smoke.PEAK_BYTES * 1e3
    assert bounds["flash_attention_packed_upcast"][0] == pytest.approx(max(old_ops, old_bytes))
    assert chip_smoke.k1_old_bound(inp) == bounds["flash_attention_packed_upcast"]
    assert 3 / chip_smoke.PEAK_BF16 < 2 / chip_smoke.PEAK_TF32  # three bf16 passes are the cheaper split
