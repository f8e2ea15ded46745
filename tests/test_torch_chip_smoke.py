"""Rehearsal of chip_smoke.py's phase functions on the CPU at a tiny size.

On CPU tensors every kernel wrapper takes its plain version, so this checks
the script's plumbing (inputs, comparisons, both serving layouts and the
unpacked-attention backbone, the training steps on both matcher routes, the
stage-by-stage checks against the plain path, the launch checks, the bounds),
not the kernels. The script itself refuses to run without a GPU, which is
checked too.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
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
                                    draws=3, samples=50, hyps=7, old_images=2, old_seq=48, old_len=37)


def test_kernel_phase_rehearsal():
    inp = _tiny_kernel_inputs()
    errs = chip_smoke.check_kernels(inp, topk_sizes=(70, 65, 64, 1))
    assert set(errs) == set(chip_smoke.SERVING_KERNELS) | {"flash_attention", "flash_attention_packed_f32",
                                                             "flash_attention_f32", "flash_attention_packed_upcast"}
    # plain against plain: exact, except K1 / K1b where the bf16 output is held against fp32
    assert errs.pop("flash_attention_packed") < chip_smoke.ATTN_TOL
    assert errs.pop("flash_attention") < chip_smoke.ATTN_TOL
    assert all(e == 0.0 for e in errs.values())


def test_svd_phase_rehearsal():
    """``--svd``'s checks and solver input at a tiny size: plain against plain."""
    res = chip_smoke.check_svd_kernel("cpu", shapes=((2, 3), (4,)))
    assert len(res) == 2 * len(chip_smoke.SVD_CASES) and set(res.values()) == {0.0}
    cfg = _tiny_cfg()
    corr, K0, K1 = chip_smoke.solver_inputs("cpu", pairs=2, kpts=40, table=int(cfg.TPU.SAMPLING_PREFILTER))
    est = MickeyRelativePose(cfg, {}, device="cpu").estimate(corr, K0, K1)
    assert est.R.shape == (2, 3, 3) and bool(torch.isfinite(est.R).all())


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
    assert table["fused_share_of_rtol"] < 1.0 and table["dense_share_of_rtol"] < 1.0
    assert chip_smoke.check_checkpoint(cfg, params, torch.device("cpu"), *ims)["bitwise"]
    small = chip_smoke.check_exact_against_plain(model_x, MickeyRelativePose(cfg_x, model.params, device="cpu"),
                                                 *chip_smoke.slice_inputs("cpu", pairs=2, height=56, width=70))
    assert all(v == 0.0 for v in small.values())
    monkeypatch.setattr(chip_smoke, "_elapsed_ms", _wall_ms)  # CUDA events need the card
    stages = chip_smoke._stage_times(model_x, *ims, fused=False)
    assert set(stages) == {"backbone", "heads", "matcher", "solver"}
    assert set(chip_smoke.ablation_times(_tiny_kernel_inputs(), iters=1)) == {"k1_bf16", "k1_old_f32"}


@pytest.mark.parametrize("side", ["dense", "fused"])
def test_dense_table_check_catches_a_wrong_route(side, monkeypatch):
    """The table cross-check holds each route's values at RTOL against the
    fp64 recomputation: a table 3e-5 too large on either side fails it,
    though the other side is right."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    cfg = _tiny_cfg()
    model = build_model(cfg, _tiny_params(cfg), device="cpu")
    ims = chip_smoke.slice_inputs("cpu", pairs=2, height=112, width=140)
    if side == "dense":
        dense = fm.dense_topk_scores
        monkeypatch.setattr(fm, "dense_topk_scores", lambda *a, **k: (lambda v, i, ok: (v * (1 + 3e-5), i, ok))(
            *dense(*a, **k)))
    else:
        match = model.match_feats
        def wrong(*a, **k):
            out = match(*a, **k)
            return out._replace(top_scores=out.top_scores * (1 + 3e-5)) if hasattr(out, "top_scores") else out
        monkeypatch.setattr(model, "match_feats", wrong)
    with pytest.raises(chip_smoke.SmokeError, match=f"{side} table values vs fp64"):
        chip_smoke.check_dense_table(model, *ims)


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


def test_matcher_checks_rehearsal():
    """``--matcher``'s checks at a tiny size, plain against plain: K2a at both
    shapes and K4 with their launch-to-launch comparisons, and the ragged
    sizes with the dustbin on and off, an infinite descriptor and a NaN row
    (NaN and infinities where the plain version has them)."""
    inp = _tiny_kernel_inputs()
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    errs = chip_smoke.check_matcher_kernels(inp, tin)
    assert set(errs) == {"col_lse serving", "col_lse training", "pair_softmax training", "pair_topk serving",
                         "pair_topk training"}
    assert all(e == 0.0 for e in errs.values())
    assert chip_smoke.check_matcher_shapes("cpu", sizes=(70, 65, 64, 1), desc=16) == 0.0


def _unmasked_pad(x: torch.Tensor) -> torch.Tensor:
    """x (B, R, C) with zero rows up to a multiple of 64: what a TMA box past
    the end holds."""
    pad = -x.shape[1] % 64
    return torch.cat([x, x.new_zeros(x.shape[0], pad, x.shape[2])], dim=1)


def test_matcher_checks_catch_a_wrong_kernel(monkeypatch):
    """A K2a that counts the zero-filled rows past M (score 0) fails the
    ragged check; so does a K4 that counts the columns past N in lse_row; a
    K2a that sums its chunks in another order from call to call fails the
    bitwise launch check."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    plain_col, plain_pair = fm.col_lse, fm.pair_softmax
    monkeypatch.setattr(fm, "col_lse", lambda d0, d1, it, a: plain_col(_unmasked_pad(d0), d1, it, a))
    with pytest.raises(chip_smoke.SmokeError, match="col_lse"):
        chip_smoke.check_matcher_shapes("cpu", sizes=(70, 65), desc=16)
    monkeypatch.setattr(fm, "col_lse", plain_col)

    def unmasked_pair(d0, d1, lse_col, it, a):
        out, lse_row = plain_pair(d0, d1, lse_col, it, a)
        padded = fm._row_lse(fm._correlation(d0, _unmasked_pad(d1), it), a)
        return out, padded

    monkeypatch.setattr(fm, "pair_softmax", unmasked_pair)
    with pytest.raises(chip_smoke.SmokeError, match="lse_row"):
        chip_smoke.check_matcher_shapes("cpu", sizes=(70, 65), desc=16)
    monkeypatch.setattr(fm, "pair_softmax", plain_pair)

    calls = []

    def drifting(d0, d1, it, a):
        calls.append(0)
        return plain_col(d0, d1, it, a) * (1 + 1e-7 * (len(calls) % 2))

    monkeypatch.setattr(fm, "col_lse", drifting)
    with pytest.raises(chip_smoke.SmokeError, match="two launches"):
        chip_smoke.check_matcher_kernels(_tiny_kernel_inputs(),
                                         chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16))


def test_matcher_bounds_count_tf32_passes():
    """K2a's and K4's bounds are three TF32 passes of one correlation at 495
    TFLOP/s (K4's second sweep is not counted), the fp32 FMA bound of the
    bodies they replaced one pass at 67 TFLOP/s; against the bytes read and
    written once."""
    inp = _tiny_kernel_inputs()
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    bounds = chip_smoke.kernel_bounds(inp, tin)
    b, m, c = inp["dsc0"].shape
    n = inp["dsc1"].shape[1]
    flops = 2.0 * b * m * n * c
    col_bytes = (b * m * c + b * n * c + b * n) * 4
    assert bounds["col_lse"][0] == pytest.approx(
        max(3 * flops / chip_smoke.PEAK_TF32, col_bytes / chip_smoke.PEAK_BYTES) * 1e3)
    assert chip_smoke.col_lse_bound(inp["dsc0"], inp["dsc1"], chip_smoke.PEAK_FP32, 1.0)[0] == pytest.approx(
        max(flops / chip_smoke.PEAK_FP32, col_bytes / chip_smoke.PEAK_BYTES) * 1e3)
    bt, mt, ct = tin["dsc0"].shape
    nt = tin["dsc1"].shape[1]
    pair_bytes = (bt * mt * ct + bt * nt * ct + bt * nt + bt * mt * nt + bt * mt) * 4
    assert bounds["pair_softmax"][0] == pytest.approx(
        max(3 * 2.0 * bt * mt * nt * ct / chip_smoke.PEAK_TF32, pair_bytes / chip_smoke.PEAK_BYTES) * 1e3)
    # at the training shape the products bind, not P's 120 MB
    big = torch.empty((8, 1938, 128), device="meta")
    ms, by = chip_smoke.pair_softmax_bound(big, big)
    assert by == "operations" and ms == pytest.approx(3 * 2.0 * 8 * 1938 ** 2 * 128 / chip_smoke.PEAK_TF32 * 1e3)



def test_matcher_fp64_errors_rehearsal():
    """``--matcher``'s distance to fp64 at a tiny size: the plain versions
    on the CPU come within fp32 rounding of it."""
    errs = chip_smoke.matcher_fp64_errors(chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16))
    assert set(errs) == {"kernel", "plain"}
    assert all(e["p_max"] < 1e-5 and e["lse_col_max_abs"] < 1e-5 for e in errs.values())


def test_matcher_bwd_checks_rehearsal():
    """``--matcher-bwd``'s checks at a tiny size, plain against plain: K5's
    two bodies and K6 with the dustbin on and off and their launch-to-launch
    comparisons, and the ragged sizes (C = 16 and an odd C) with an infinite
    descriptor and a NaN row (NaN and infinities where the plain version has
    them)."""
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    errs = chip_smoke.check_matcher_bwd_kernels(tin)
    assert set(errs) == {"dustbin on", "dustbin off"} and all(e == 0.0 for e in errs.values())
    assert chip_smoke.check_matcher_bwd_shapes("cpu", sizes=(70, 65, 64, 1), desc=16) == 0.0
    assert chip_smoke.check_matcher_bwd_shapes("cpu", sizes=(130, 67), desc=45) == 0.0


def test_matcher_bwd_checks_catch_a_wrong_kernel(monkeypatch):
    """A bwd_grads of one TF32 pass fails the training-shape check; an
    lse_bwd that zeroes NaN fails the ragged sizes' non-finite check; a
    bwd_sums whose column sums drift from call to call fails the bitwise
    launch check."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    monkeypatch.setattr(fm, "dual_softmax_bwd_grads", lambda *a: fm.dual_softmax_bwd_grads_3xtf32_plain(*a, passes=1))
    with pytest.raises(chip_smoke.SmokeError, match="dual_softmax_bwd_grads dd"):
        chip_smoke.check_matcher_bwd_kernels(tin)
    monkeypatch.undo()
    monkeypatch.setattr(fm, "lse_bwd", lambda *a: tuple(torch.nan_to_num(x) for x in fm.lse_bwd_plain(*a)))
    with pytest.raises(chip_smoke.SmokeError, match="NaN or infinite"):
        chip_smoke.check_matcher_bwd_shapes("cpu", sizes=(70, 65), desc=16)
    monkeypatch.undo()
    calls = []

    def drifting(*a):
        calls.append(0)
        r, c = fm.dual_softmax_bwd_sums_plain(*a)
        return r, c * (1 + 1e-7 * (len(calls) % 2))

    monkeypatch.setattr(fm, "dual_softmax_bwd_sums", drifting)
    with pytest.raises(chip_smoke.SmokeError, match="two launches"):
        chip_smoke.check_matcher_bwd_kernels(tin)


def test_matcher_bwd_bounds_count_tf32_passes():
    """K5's and K6's bounds: bwd_sums one correlation, bwd_grads and lse_bwd
    the function's three products (not the two launches' recomputed s), each
    three TF32 passes at 495 TFLOP/s, the fp32 FMA bound of the bodies they
    replaced one pass at 67 TFLOP/s; against the bytes read and written
    once."""
    inp = _tiny_kernel_inputs()
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    bounds = chip_smoke.kernel_bounds(inp, tin)
    b, m, c = tin["dsc0"].shape
    n = tin["dsc1"].shape[1]
    corr = 2.0 * b * m * n * c
    descs = (b * m * c + b * n * c) * 4
    vecs = (2 * b * m + 2 * b * n) * 4
    want = {"dual_softmax_bwd_sums": (3 * corr, descs + b * m * n * 4 + vecs),
            "dual_softmax_bwd_grads": (9 * corr, 2 * descs + b * m * n * 4 + vecs),
            "lse_bwd": (9 * corr, 2 * descs + vecs)}
    for name, (flops, nbytes) in want.items():
        assert bounds[name][0] == pytest.approx(
            max(flops / chip_smoke.PEAK_TF32, nbytes / chip_smoke.PEAK_BYTES) * 1e3), name
    fn = chip_smoke.bwd_grads_bound
    assert fn(tin["dsc0"], tin["dsc1"], chip_smoke.PEAK_FP32, 1.0)[0] == pytest.approx(
        max(3 * corr / chip_smoke.PEAK_FP32, want["dual_softmax_bwd_grads"][1] / chip_smoke.PEAK_BYTES) * 1e3)
    # at the training shape the products bind, not G's 120 MB
    big = torch.empty((8, 1938, 128), device="meta")
    for fn, products in ((chip_smoke.bwd_sums_bound, 1), (chip_smoke.bwd_grads_bound, 3), (chip_smoke.lse_bwd_bound, 3)):
        ms, by = fn(big, big)
        assert by == "operations" and ms == pytest.approx(3 * products * 2.0 * 8 * 1938 ** 2 * 128 / chip_smoke.PEAK_TF32 * 1e3)


def test_matcher_bwd_fp64_errors_rehearsal():
    """``--matcher-bwd``'s distances from fp64 at a tiny size: the plain
    versions on the CPU (both sides of the comparison) come within fp32
    rounding of it, and the distance of a value 1e-4 too large reads 1e-4."""
    errs = chip_smoke.matcher_bwd_fp64_errors(chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16))
    assert set(errs) == {"kernel", "plain"}
    keys = {"r", "c", "bwd_grads dd0", "bwd_grads dd1", "lse_bwd dd0", "lse_bwd dd1"}
    assert all(set(e) == keys and all(v["max_over_max"] < 1e-5 for v in e.values()) for e in errs.values())
    ref = torch.tensor([1.0, -2.0, 4.0, 1e-9], dtype=torch.float64)
    d = chip_smoke._fp64_distance(ref * (1 + 1e-4), ref)
    assert d["rel_mean"] == pytest.approx(1e-4) and d["max_over_max"] == pytest.approx(1e-4)


def test_topk_checks_catch_a_wrong_kernel(monkeypatch):
    """K2b's checks on ragged sizes: a selection that breaks exact ties by
    the higher column fails the rounds' order; one that takes a NaN in the
    last column for one before it (every round NaN) fails the NaN pattern;
    a K2b whose values drift from launch to launch fails the bitwise
    check."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    plain = fm.pair_topk_plain

    def high_ties(f, topl):  # the rounds on reversed columns, mapped back
        n = f.shape[-1]
        v, i = fm._topk_rounds(f.flip(-1), topl)
        row = i // n
        return v, (row * n + (n - 1 - i % n)).to(torch.int32)

    monkeypatch.setattr(fm, "pair_topk", lambda d0, d1, s0, s1, lc, it, a, topl, split=None: fm._pair_topk_from(
        fm._correlation(d0, d1, it), s0, s1, lc, a, topl, high_ties))
    with pytest.raises(chip_smoke.SmokeError, match="order|another index"):
        chip_smoke.check_topk_shapes("cpu", sizes=(70, 65), desc=16)

    def nan_anywhere(f, topl):
        nan = torch.isnan(f).any(-1, keepdim=True)
        return fm._topk_rounds(torch.where(nan, torch.full_like(f, float("nan")), f), topl)

    monkeypatch.setattr(fm, "pair_topk", lambda d0, d1, s0, s1, lc, it, a, topl, split=None: fm._pair_topk_from(
        fm._correlation(d0, d1, it), s0, s1, lc, a, topl, nan_anywhere))
    with pytest.raises(chip_smoke.SmokeError, match="NaN or infinite"):
        chip_smoke.check_topk_shapes("cpu", sizes=(70, 65), desc=16)
    calls = []

    def drifting(*a, **k):
        calls.append(0)
        v, i, st, lr = plain(*a[:8])
        return v * (1 + 1e-7 * (len(calls) % 2)), i, st, lr

    monkeypatch.setattr(fm, "pair_topk", drifting)
    with pytest.raises(chip_smoke.SmokeError, match="two launches"):
        chip_smoke.check_topk_shapes("cpu", sizes=(70, 65), desc=16)


def test_scoring_checks_rehearsal():
    """``--scoring``'s checks at a tiny solver shape and on the ragged
    shapes (4-byte staging, two staged chunks, partial hypothesis groups, a
    single sample), plain against plain."""
    errs = chip_smoke.check_scoring_kernel(_tiny_kernel_inputs())
    assert set(errs) == {"solver", "3x1001x13", "2x3001x17", "1x1x1"} and all(e == 0.0 for e in errs.values())


def test_scoring_checks_catch_a_wrong_kernel(monkeypatch):
    """A K3 that stops at 2048 samples (one staged chunk) fails the ragged
    shapes' check."""
    from mickey_tpu_torch.ops import hypothesis_scoring as hs

    plain = hs.hypothesis_scores_plain
    monkeypatch.setattr(hs, "hypothesis_scores", lambda X, Y, R, t, th: plain(X[:, :2048], Y[:, :2048], R, t, th))
    with pytest.raises(chip_smoke.SmokeError, match="3001 samples"):
        chip_smoke.check_scoring_kernel(_tiny_kernel_inputs())


def test_once_per_solve():
    """The serving paths' launch check: K3 once a solve, not once a draw."""
    counts = {name: 1 for name, _, _ in chip_smoke.KERNELS}
    chip_smoke._once_per_solve(dict(counts, hypothesis_scores=2), "x", 2)
    with pytest.raises(chip_smoke.SmokeError, match="40 times for 2 solves"):
        chip_smoke._once_per_solve(dict(counts, hypothesis_scores=40), "x", 2)


def test_topk_and_scoring_bounds():
    """K2b's bound is three TF32 passes of one correlation at 495 TFLOP/s
    (its FFMA bound one pass at 67 TFLOP/s) against the bytes read and
    written once; K3's adds to the fp32 operations (30 a term at 67 TFLOP/s)
    three special-function operations a term at 16 a clock on each of 132
    SMs at the card's peak clock of 1980 MHz, which binds at a solve's
    shape: 0.005877 ms."""
    inp = _tiny_kernel_inputs()
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    b, m, c = inp["dsc0"].shape
    n, L = inp["dsc1"].shape[1], inp["topl"]
    nbytes = (b * m * c + b * n * c + b * m + 2 * b * n + 2 * b * L * m + 4 * b * m) * 4
    flops = 2.0 * b * m * n * c
    bounds = chip_smoke.kernel_bounds(inp, tin)
    assert bounds["pair_topk"][0] == pytest.approx(
        max(3 * flops / chip_smoke.PEAK_TF32, nbytes / chip_smoke.PEAK_BYTES) * 1e3)
    assert chip_smoke.pair_topk_bound(inp["dsc0"], inp["dsc1"], L, chip_smoke.PEAK_FP32, 1.0)[0] == pytest.approx(
        max(flops / chip_smoke.PEAK_FP32, nbytes / chip_smoke.PEAK_BYTES) * 1e3)
    e, s = inp["X"].shape[:2]
    r = inp["R"].shape[1]
    terms = e * r * s
    sfu = 3 * terms / (16 * 132 * 1.98e9) * 1e3
    fp32 = max(30 * terms / chip_smoke.PEAK_FP32, (2 * e * s * 3 + e * r * 13) * 4 / chip_smoke.PEAK_BYTES) * 1e3
    assert bounds["hypothesis_scores"][0] == pytest.approx(max(sfu, fp32))
    X, R = torch.empty((40, 2048, 3), device="meta"), torch.empty((40, 100, 3, 3), device="meta")
    ms, by = chip_smoke.hypothesis_bound(X, R)
    assert by == "operations" and ms == pytest.approx(3 * 40 * 100 * 2048 / (16 * 132 * 1.98e9) * 1e3)
    assert ms == pytest.approx(0.005877, abs=5e-7)
    big = torch.empty((2, 1938, 128), device="meta")
    ms, by = chip_smoke.pair_topk_bound(big, big, 16)
    assert by == "operations" and ms == pytest.approx(3 * 2.0 * 2 * 1938 ** 2 * 128 / chip_smoke.PEAK_TF32 * 1e3)


def test_topk_fp64_shares_rehearsal():
    """``--matcher``'s K2b distance from fp64 at a tiny size: the plain
    version on both sides, within fp32 rounding of it."""
    shares = chip_smoke.topk_fp64_shares(_tiny_kernel_inputs(), 4)
    assert shares["kernel"] == shares["plain"] and 0.0 < shares["plain"] < 1.0


@pytest.fixture
def one_torch_thread():
    """The tier-1 run keeps several test workers on the machine's cores, and
    torch's OpenMP threads in each spin against the others': the submission
    phase's predicts took ~100 times as long as alone. One intra-op thread
    a worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_submission_phase_rehearsal(tmp_path, monkeypatch, one_torch_thread):
    """Phase 3d at a tiny size on the CPU: the synthetic split (2 scenes of
    11 queries at 130 x 116, raw caches only), the CLI's entry, the zip and
    evaluator checks; batches of 2 (3 pairs a scene: 2, 2 spanning both
    scenes, 2). The launch counts are the card's: here each kernel's plain
    version runs, so the checks get the counts as the card would give them."""
    cfg = _tiny_cfg()
    cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT = 116, 130
    model = build_model(cfg, _tiny_params(cfg), device="cpu")
    chip_smoke.write_val_split(str(tmp_path), queries=11, height=130, width=116)
    assert sorted(p.name for p in (tmp_path / "val" / "s00000").iterdir()) == [
        "intrinsics.txt", "poses.txt", "rawcache_116x130.json", "rawcache_116x130.u8"]
    checked = []
    monkeypatch.setattr(chip_smoke, "_launched", lambda launches, path, needed, absent=(): checked.append(
        (path, needed, absent)))
    monkeypatch.setattr(chip_smoke, "_once_per_solve", lambda launches, path, solves: checked.append((path, solves)))
    sub = chip_smoke.run_submission(model, cfg, str(tmp_path), batch=2)
    assert sub["pairs"] == 6 and sub["solves"] == 3 and sub["keyframes"] == 2 and sub["crop"] == (126, 112)
    assert 0 < sub["poses"] <= 6 and set(sub["metrics"]) >= {"Estimates for % of frames"}
    assert ("submission", 3) in checked
    assert ("submission", chip_smoke.SERVING_KERNELS, ("flash_attention", "pair_softmax")) in checked
    assert "submission: ok" in chip_smoke.submission_line(sub)
    assert "cv2 yes" in chip_smoke.decoders_line()
    with pytest.raises(chip_smoke.SmokeError, match="keyframes"):  # a probe that sees an extra extract
        monkeypatch.setattr(chip_smoke.ServingProbe, "extract_feats", lambda self, images: (
            setattr(self, "keyframes", self.keyframes + 9), self.model.extract_feats(images))[1])
        chip_smoke.run_submission(model, cfg, str(tmp_path), batch=2)


def test_submission_timing_rehearsal(monkeypatch, one_torch_thread):
    """The timing of the submission path on its own split, cut here to 3
    scenes of 11 queries at 130 x 116: 9 pairs in one batch."""
    cfg = _tiny_cfg()
    cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT = 116, 130
    model = build_model(cfg, _tiny_params(cfg), device="cpu")
    monkeypatch.setattr(chip_smoke, "TIMING_SCENES", 3)
    monkeypatch.setattr(chip_smoke, "TIMING_QUERIES", 11)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, iters=10, warmup=2: _wall_ms(fn))  # CUDA events need the card
    times = chip_smoke.submission_times(model, cfg, runs=1)
    assert times["scenes"] == 3 and times["pairs"] == 9 and times["batches"] == 1 and times["batch"] == 9
    assert len(times["predict_s"]) == 1 and times["pairs_per_s"] == 9 / times["predict_s"][0]
    assert all(0 <= w < 1 for w in times["loader_wait_share"])
    assert set(times["general_stages_ms"]) == {"backbone", "heads", "matcher", "solver"}


def test_busy_time_is_the_union_of_device_intervals():
    from types import SimpleNamespace

    def ev(a, b, dev=torch.autograd.DeviceType.CUDA):
        return SimpleNamespace(time_range=SimpleNamespace(start=a, end=b), device_type=dev)

    prof = SimpleNamespace(events=lambda: [ev(20, 30), ev(0, 10), ev(5, 12), ev(21, 22),
                                           ev(0, 100, torch.autograd.DeviceType.CPU)])
    assert chip_smoke._busy_s(prof) == 22e-6


def test_fit_phase_rehearsal(tmp_path, monkeypatch, one_torch_thread):
    """Phase 3e and its timing at a tiny size on the CPU: 2 train scenes of
    5 queries and 2 val scenes of 10 at 130 x 116 (cropped to 126 x 112),
    batches of 2 pairs, 2 steps an epoch, 2 validation batches; a ViT-S
    backbone in bf16, as the default config's. Each kernel's plain version
    runs, so the launch checks get the counts as the card would give them."""
    cfg = _tiny_train_cfg()
    cfg.MICKEY.DINOV2.FLOAT16 = True
    cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT = 116, 130
    checked = []
    monkeypatch.setattr(chip_smoke, "_launched", lambda launches, path, needed, absent=(): checked.append(
        (path, needed, absent)))
    monkeypatch.setattr(chip_smoke, "_once_per_solve", lambda launches, path, solves: checked.append((path, solves)))
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, iters=10, warmup=2: _wall_ms(fn))  # CUDA events need the card
    errs = chip_smoke.check_fit_kernels(_tiny_kernel_inputs())
    assert errs["flash_attention_packed"] < chip_smoke.ATTN_TOL and errs["hypothesis_scores"] == 0.0
    (res, ctx), launches = chip_smoke._counted(lambda: chip_smoke.run_fit(
        cfg, str(tmp_path), torch.device("cpu"), batch=2, samples=2, train_queries=5, val_queries=10))
    assert ("fit", chip_smoke.FIT_KERNELS, chip_smoke.FIT_ABSENT) in checked and ("fit", 2) in checked
    assert ("fit from the feature cache, train steps", chip_smoke.DENSE_MATCHER_KERNELS,
            chip_smoke.ATTENTION_KERNELS) in checked
    assert res["timing"]["steps"] == res["cached_timing"]["steps"] == 2 and res["keyframes"] == 2
    assert res["cache_frames"] == 10 and res["cache_bytes_fp32"] == 2 * res["cache_bytes_bf16"] == 10 * 9 * 8 * 384 * 4
    assert res["val_cached_vs_plain"] == 0.0 and res["image_panels"] == "ran: 6 panels"
    # no launch on the CPU
    assert set(launches) == {name for name, _, _ in chip_smoke.KERNELS + chip_smoke.BF16_KERNELS}
    times = chip_smoke.fit_times(ctx, runs=1, iters=1)
    assert len(times["staged_step_ms_turns"]) == len(times["staged_default_bwd_ms_turns"]) == 1
    assert times["grad_leaves"] > 0 and times["grad_leaves_apart_deterministic"] == 0
    del ctx
    # the timing's own split, cut here to 2 train scenes of 5 queries and 2 val
    # scenes of 20, 4 pairs drawn a scene: 4 steps of 2, 4 validation batches
    # in the sampler's seeded order, of which 2 find their keyframes held
    monkeypatch.setattr(chip_smoke, "FIT_TIMING_TRAIN_QUERIES", 5)
    monkeypatch.setattr(chip_smoke, "FIT_TIMING_SAMPLES", 4)
    monkeypatch.setattr(chip_smoke, "FIT_TIMING_VAL_QUERIES", 20)
    window = chip_smoke.fit_window_times(cfg, torch.device("cpu"), runs=1, batch=2)
    assert window["fit"]["steps"] == window["fit_from_cache"]["steps"] == 4
    assert window["val_pairs"] == 8 and window["val_batches"] == 4 and window["val_keyframe_hit_share"] == [0.5]
    assert len(window["val_plain_s"]) == len(window["val_cached_s"]) == 1
    c32, c16 = window["cache_float32"], window["cache_bfloat16"]
    assert c32["frames"] == c16["frames"] == 10 and c32["bytes"] == 2 * c16["bytes"] == 10 * 9 * 8 * 384 * 4
    assert "fit: ok" in chip_smoke.fit_line(res, errs)
    line = chip_smoke.fit_timing_line(res, times, window, "card")
    assert line.startswith("timing (fit): ok | card | ") and json.loads(line.split(" | ", 2)[2])["save_s"] > 0
    assert "matplotlib yes" in chip_smoke.optional_line()


def test_fit_checks_catch_a_difference():
    """Resume and the cached step are held bitwise: one changed tensor fails."""
    cfg = _tiny_train_cfg()
    params = _tiny_params(cfg)
    a, b = (MicKeyTrainer(cfg, params=params, device="cpu") for _ in range(2))
    chip_smoke._same_state(a, b, "x")
    with torch.no_grad():
        b.state.opt_state.nu[3].add_(1e-30)
    with pytest.raises(chip_smoke.SmokeError, match="1 parameter, moment or count"):
        chip_smoke._same_state(a, b, "x")


def _recorded_checks(monkeypatch):
    checked = []
    monkeypatch.setattr(chip_smoke, "_launched", lambda launches, path, needed, absent=(): checked.append(
        (path, needed, absent)))
    monkeypatch.setattr(chip_smoke, "_once_per_solve", lambda launches, path, solves: checked.append((path, solves)))
    return checked


def test_demo_phase_rehearsal(tmp_path, monkeypatch, one_torch_thread):
    """Phase 3f's demo at a tiny size on the CPU: two 172 x 200 JPEGs (cut to
    168 x 196), the demo CLI's entry on parsed arguments with a tiny model
    injected, twice. Each kernel's plain version runs, so the launch checks
    get the counts as the card would give them."""
    cfg = _tiny_cfg()
    model = build_model(cfg, _tiny_params(cfg), device="cpu")
    chip_smoke.write_demo_inputs(tmp_path, height=172, width=200)
    assert (tmp_path / "intrinsics.txt").read_text().splitlines()[1] == "im1.jpg 590.0 590.0 100.0 86.0 200 172"
    checked = _recorded_checks(monkeypatch)
    res = chip_smoke.run_demo(tmp_path, model=model)
    assert res["model_saw"] == (168, 196) and len(res["seconds"]) == len(res["model_ms"]) == 2
    assert ("demo", chip_smoke.DEMO_KERNELS, chip_smoke.DEMO_ABSENT) in checked and ("demo", 1) in checked
    assert sorted(p.name for p in (tmp_path / "demo").iterdir()) == sorted(chip_smoke.DEMO_FILES)
    assert "demo: ok | model saw 168 x 196" in chip_smoke.demo_line(res)
    assert chip_smoke.demo_image_sizes(714, 532)["im0.3d_vis.jpg"] == (720, 1324)
    monkeypatch.setattr(chip_smoke, "demo_image_sizes", lambda h, w: {n: (h + 1, w) for n in chip_smoke.DEMO_FILES})
    with pytest.raises(chip_smoke.SmokeError, match="is not an image of"):
        chip_smoke.run_demo(tmp_path, model=model)


def test_int8_and_giant_phase_rehearsal(monkeypatch, one_torch_thread):
    """Phase 3f's int8 and SwiGLU runs at a tiny size on the CPU: the int8
    model on the tiny bf16 model's weights (both layouts, the full output,
    the products, the per-token cosine, the small input against itself),
    then the SwiGLU variant at ViT-S width and 2 blocks (the ViT-g/14 run's
    code at its rehearsal size), and the timing with the host's clock."""
    cfg = _tiny_cfg()
    params = _tiny_params(cfg)
    model, cpu_model = build_model(cfg, params, device="cpu"), build_model(cfg, params, device="cpu")
    ims = chip_smoke.slice_inputs("cpu", pairs=2, height=112, width=140)
    small = chip_smoke.slice_inputs("cpu", pairs=2, height=56, width=70)
    checked = _recorded_checks(monkeypatch)
    res, launches, model_q = chip_smoke.run_int8(model, cpu_model, *ims, small)
    assert ("int8", chip_smoke.VARIANT_KERNELS, ("flash_attention",)) in checked and ("int8", 3) in checked
    assert res["heads"] == [(6, 64)] and res["products"]["fc1"] == (4 * 81, 384, 1536)
    assert res["token_cos_min"] > chip_smoke.INT8_MIN_COS and res["small"]["pose_rel"] == 0.0
    assert model_q.params["dinov2"]["blocks"][0]["attn"]["qkv"]["w_q"].dtype == torch.int8

    cfg_v = cfg.clone()
    cfg_v.MICKEY.DINOV2.FLOAT16 = True
    params_v = chip_smoke.swiglu_params(cfg_v, depth=2)
    assert set(params_v["dinov2"]["blocks"]["mlp"]) == {"w12", "w3"}
    g, g_launches, giant = chip_smoke.run_giant(cfg_v, params_v, "cpu", *ims, small, depth=2)
    assert g["bf16"]["heads"] == g["int8"]["heads"] == [(6, 64)] and len(g_launches) == 2
    assert g["int8"]["small"]["pose_rel"] == 0.0 and ("vit_giant2 int8", 2) in checked
    with pytest.raises(chip_smoke.SmokeError, match="not the 12-block SwiGLU ViT"):
        chip_smoke.run_giant(cfg_v, params_v, "cpu", *ims, small)

    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, iters=10, warmup=2: _wall_ms(fn))  # CUDA events need the card
    monkeypatch.setattr(chip_smoke, "time_many_ms", lambda fn, reps=20, iters=5: _wall_ms(fn))
    times = chip_smoke.variant_times(model, model_q, giant, "cpu", batches=(2,), height=56, width=70, iters=1)
    assert set(times["linears"]) == {"qkv", "proj", "fc1", "fc2"} and times["linears"]["fc2"]["shape"] == [84, 1536, 384]
    assert {"B2_int8_backbone", "B2_bf16_general", "vit_giant2_B2_int8_backbone"} <= set(times)


def test_int8_checks_catch_a_wrong_product(monkeypatch):
    cfg = _tiny_cfg()
    model_q = chip_smoke.int8_model(build_model(cfg, _tiny_params(cfg), device="cpu"))
    from mickey_tpu_torch.nn import quant

    monkeypatch.setattr(quant, "int_mm", lambda x_q, w_q: quant.int_mm_plain(x_q, w_q) + (x_q[:, :1] == 127).int())
    with pytest.raises(chip_smoke.SmokeError, match="differs from the plain one"):
        chip_smoke.check_int8_products(model_q, 20)


def test_ddp_phase_rehearsal(tmp_path, monkeypatch, one_torch_thread):
    """Phase 3g at a tiny size on the CPU, gloo standing in for NCCL: the
    ingest's rates (native built here) on 48 JPEGs of 540 x 720; a world-1
    group's 2 steps bitwise no group's; 2 ranks against one process at B = 2
    of 126 x 140 (one pair a rank); the submission CLI on 2 ranks over 2
    scenes of 11 queries at 130 x 116 in batches of 3 (one padded a batch),
    its zip byte for byte the ranks' rows served here in turn. The launch
    counts are the card's; here each kernel's plain version runs."""
    checked = []
    monkeypatch.setattr(chip_smoke, "_launched", lambda launches, path, needed, absent=(): checked.append(path))
    ingest = chip_smoke.ingest_rates(str(tmp_path))
    assert ingest["native"] == "built" and ingest["jpegs"] == chip_smoke.INGEST_JPEGS
    assert ingest["native_8_threads_fps"] > 0 and ingest["cv2_fps"] > 0 and ingest["native_vs_cv2_mean_abs"] < 5e-3
    cfg = _tiny_train_cfg()
    train, launches = chip_smoke.run_ddp_train(cfg, torch.device("cpu"), pairs=2, height=126, width=140, steps=2,
                                               launch_timeout=300)
    assert train["backend"] == "gloo on cpu" and len(train["world1_step_ms"]["nccl world 1"]) == 2
    assert train["bn_rel"] <= chip_smoke.DDP_RTOL and train["moments_rel"] <= chip_smoke.GRAD_TOL
    assert {"ddp, one process", "ddp, rank 0", "ddp, rank 1"} <= set(checked)
    assert set(launches) == {name for name, _, _ in chip_smoke.KERNELS + chip_smoke.BF16_KERNELS}
    cfg = _tiny_cfg()
    cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT = 116, 130
    chip_smoke.write_val_split(str(tmp_path / "split"), queries=11, height=130, width=116)
    sub = chip_smoke.run_ddp_submission(build_model(cfg, device="cpu"), cfg, str(tmp_path / "split"), batch=3,
                                        launch_timeout=300)
    assert sub["poses"] > 0 and sub["max_dt_vs_one_process"] >= 0.0
    assert "ddp: ok" in chip_smoke.ddp_line(ingest, train, sub, "card")
    # a rank whose rows another process served otherwise fails the byte check
    monkeypatch.setattr(chip_smoke._OneRankOfTwo, "fold", lambda self, g: g)
    with pytest.raises(chip_smoke.SmokeError, match="differs from the ranks' rows"):
        chip_smoke.run_ddp_submission(build_model(cfg, device="cpu"), cfg, str(tmp_path / "split"), batch=3,
                                      launch_timeout=300)


def test_bf16_phase_rehearsal(monkeypatch, one_torch_thread):
    """Phase 3h at a tiny size, plain against plain: the bf16 kernels'
    checks on rounded descriptors (ragged sizes too), the MATCHER_BF16 paths
    (both layouts, the full output, the table cross-check, a table that is
    not the fp32 route's), the rounded convs against fp64, the HEADS_BF16
    stage and its timing in turns, the kernels' times and the rows of the
    ``kernels`` line with every key of the contract."""
    monkeypatch.setattr(chip_smoke, "_elapsed_ms", _wall_ms)  # CUDA events need the card
    inp = _tiny_kernel_inputs()
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    inp_b, tin_b = chip_smoke.bf16_kernel_inputs(inp, tin)
    assert inp_b["dsc0"].dtype == tin_b["dsc1"].dtype == torch.bfloat16
    errs = chip_smoke.check_bf16_kernels(inp_b, tin_b, sizes=(70, 65, 64, 1))
    assert errs == {name: 0.0 for name, _, _ in chip_smoke.BF16_KERNELS}
    cfg = _tiny_cfg()
    model = build_model(cfg, _tiny_params(cfg), device="cpu")
    paths = chip_smoke.run_bf16_paths(model, *chip_smoke.slice_inputs("cpu", pairs=2, height=112, width=140))
    assert set(paths["conf"]) == {"general", "shared"} and len(paths["full_conf"]) == 2
    assert paths["table"]["fused_share_of_rtol"] < 1.0 and paths["table"]["vs_fp32_table_rel"] > 0
    assert all(v == 0 for v in paths["launches"].values())  # the CPU launches nothing
    convs = chip_smoke.check_rounded_convs(model, "cpu", maps=1, rows=5, cols=6)
    assert len(convs) == 9 and all(c["mode"] <= c["bound"] for c in convs.values())
    heads = chip_smoke.check_heads_bf16(model, "cpu", batches=(2,), height=112, width=140, iters=1)
    assert heads["B=2"]["norm_rel_vs_plain"] == 0.0 and heads["B=2"]["norm_rel_vs_fp32"] > 0
    assert set(heads["B=2"]["ms"]) == {"fp32", "bf16", "bf16_plain"}
    kt = chip_smoke.bf16_kernel_times(inp_b, tin_b, reps=1)
    res = {"errs": errs, "kt": kt, "bounds": chip_smoke.bf16_bounds(inp_b, tin_b), "paths": paths,
           "heads": {"convs": convs, "stage": heads}}
    rows = chip_smoke.bf16_kernel_rows(res, {name: 1 for name, _, _ in chip_smoke.BF16_KERNELS})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"}
    assert [r["name"] for r in rows] == [n for n, _, _ in chip_smoke.BF16_KERNELS] and all(keys <= set(r) for r in rows)
    assert "timing (bf16): ok" in chip_smoke.bf16_lines(res, "card")


def test_bf16_bounds_and_launch_check():
    """The bf16 kernels' bounds: one bf16 pass at 989 TFLOP/s and the
    descriptors at 2 bytes a value (K2a, K2b by operations at the serving
    shape, K4 by P's bytes at the training shape); the MATCHER_BF16 paths'
    launch check refuses a path that launched an fp32 engine kernel."""
    big, train = torch.empty((2, 1938, 128), device="meta"), torch.empty((8, 1938, 128), device="meta")
    big_b, train_b = big.to(torch.bfloat16), train.to(torch.bfloat16)
    ms, by = chip_smoke.col_lse_bound(big_b, big_b, chip_smoke.PEAK_BF16, 1.0)
    assert by == "operations" and ms == pytest.approx(2.0 * 2 * 1938 ** 2 * 128 / chip_smoke.PEAK_BF16 * 1e3)
    assert ms == pytest.approx(chip_smoke.col_lse_bound(big, big)[0] * chip_smoke.PEAK_TF32 / chip_smoke.PEAK_BF16 / 3)
    ms, by = chip_smoke.pair_softmax_bound(train_b, train_b, chip_smoke.PEAK_BF16, 1.0)
    assert by == "bytes" and ms == pytest.approx((2 * 8 * 1938 * 128 * 2 + (2 * 8 * 1938 + 8 * 1938 ** 2) * 4)
                                                 / chip_smoke.PEAK_BYTES * 1e3)
    assert chip_smoke.pair_topk_bound(big_b, big_b, 16, chip_smoke.PEAK_BF16, 1.0)[1] == "operations"
    counts = {name: 0 for name, _, _ in chip_smoke.KERNELS + chip_smoke.BF16_KERNELS}
    counts.update({n: 1 for n in chip_smoke.BF16_PATH_KERNELS})
    chip_smoke._launched(counts, "x", chip_smoke.BF16_PATH_KERNELS, chip_smoke.BF16_PATH_ABSENT)
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke._launched(dict(counts, col_lse=1), "x", chip_smoke.BF16_PATH_KERNELS, chip_smoke.BF16_PATH_ABSENT)
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke._launched(dict(counts, pair_topk_bf16=0), "x", chip_smoke.BF16_PATH_KERNELS)


def test_bf16_checks_catch_a_wrong_kernel(monkeypatch):
    """A bf16 K2a that rounds its result to bf16 (a bf16-output product)
    fails the RTOL check, though its plain version is right."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    inp = _tiny_kernel_inputs()
    tin = chip_smoke.train_kernel_inputs("cpu", pairs=2, kpts=37, desc=16)
    inp_b, tin_b = chip_smoke.bf16_kernel_inputs(inp, tin)
    col_lse = fm.col_lse

    def rounded(d0, d1, *a, **k):
        out = col_lse(d0, d1, *a, **k)
        return out.to(torch.bfloat16).float() if d0.dtype == torch.bfloat16 else out
    monkeypatch.setattr(fm, "col_lse", rounded)
    with pytest.raises(chip_smoke.SmokeError, match="col_lse_bf16"):
        chip_smoke.check_bf16_kernels(inp_b, tin_b, sizes=(70, 65))


def test_tp_phase_rehearsal(monkeypatch, one_torch_thread):
    """Phase 3i at a tiny size on the CPU: the ViT-S forward (12 blocks) on
    two gloo ranks at tp = 2 in bf16 packed and unpacked and in fp32 against
    one process (4 images of 126 x 140), each rank's half of the split
    bytes; the dp 1 x tp 2 steps (B = 2, 2 steps, injected draws): with the
    exact backbone against one process at phase 3g's tolerances, with the
    bf16 backbone against one process fed the ranks' map, bit for bit; the
    seeded weights made once and sent to the ranks, as the whole script
    does. The launch counts are the card's: here each kernel's plain version
    runs."""
    checked = []
    monkeypatch.setattr(chip_smoke, "_launched", lambda launches, path, needed, absent=(): checked.append(path))
    monkeypatch.setattr(chip_smoke, "_attention_each_block", lambda launches, path, kernel, blocks:
                        checked.append((path, kernel, blocks)))
    cfg = _tiny_train_cfg()
    res, launches, rank_launches = chip_smoke.run_tp_phase(cfg, torch.device("cpu"), pairs=2, height=126, width=140,
                                                           runs=2, train_pairs=2, steps=2, launch_timeout=300,
                                                           params=init_params_numpy(cfg, chip_smoke.SEED))
    fwd = res["forward"]
    assert fwd["fp32"]["max_rel"] <= chip_smoke.TP_F32_RTOL
    for mode in ("bf16 packed", "bf16 unpacked"):
        assert 0 < fwd[mode]["max_rel"] <= chip_smoke.TP_BF16_ENVELOPES * fwd[mode]["one_process_vs_fp32_max_rel"]
    assert [2 * r["split"] for r in fwd["bytes"]["ranks"]] == [fwd["bytes"]["one_process"]["split"]] * 2
    assert ("tp fp32, rank 1", "flash_attention_packed_f32", 12 * 2) in checked
    assert ("tp bf16 unpacked, rank 0", "flash_attention", 12 * 2) in checked
    assert {"tp step, one process", "tp step (dp 1 x tp 2), rank 0", "tp step (dp 1 x tp 2), rank 1",
            "tp bf16 step (dp 1 x tp 2), rank 1", "tp bf16 step (dp 1 x tp 2), one process on the ranks' map"
            } <= set(checked)
    assert res["train"]["bn_rel"] <= chip_smoke.DDP_RTOL and res["train"]["moments_rel"] <= chip_smoke.GRAD_TOL
    assert len(res["train_step_ms"]["ranks"]) == 2 and len(res["train_step_ms"]["one_process"]) == 2
    bf16 = res["train_bf16"]
    assert bf16["bitwise_one_process_on_the_ranks_map"] and 0 < bf16["map_max_rel_vs_own"] < 0.1
    assert len(bf16["grad_norm_rel_vs_own"]) == 2 and all(0 <= g < float("inf") for g in bf16["grad_norm_rel_vs_own"])
    assert set(launches) == {name for name, _, _ in chip_smoke.KERNELS + chip_smoke.BF16_KERNELS}
    assert len(rank_launches) == 2 * len(chip_smoke.TP_MODES) + 2 + 2
    assert "tp: ok" in chip_smoke.tp_line(res, "card")


def test_tp_phase_catches_a_wrong_shard(monkeypatch, one_torch_thread):
    """Ranks whose row-parallel linears add the whole bias on every rank
    (the group's sum then holds it twice) fail the forward's check; so does
    a rank that launched its attention kernel in fewer blocks than it ran."""
    import test_torch_tensor_parallel_ranks as tp_ranks

    monkeypatch.setattr(chip_smoke, "_attention_each_block", lambda *a: None)
    with pytest.raises(chip_smoke.SmokeError, match="tp bf16 packed: map .* beyond"):
        chip_smoke.run_tp_phase(_tiny_train_cfg(), torch.device("cpu"), pairs=2, height=126, width=140, runs=1,
                                steps=0, launch_timeout=300, entry=tp_ranks.rank_features_with_bias_on_every_rank)
    counts = {name: 0 for name, _, _ in chip_smoke.KERNELS + chip_smoke.BF16_KERNELS}
    monkeypatch.undo()
    chip_smoke._attention_each_block(dict(counts, flash_attention=48), "x", "flash_attention", 48)
    for wrong in (dict(counts, flash_attention=47), dict(counts, flash_attention=48, flash_attention_packed=1)):
        with pytest.raises(chip_smoke.SmokeError):
            chip_smoke._attention_each_block(wrong, "x", "flash_attention", 48)


def test_curve_phase_rehearsal(one_torch_thread):
    """The overfit proxy's phase at 4 steps on the CPU: each mode at two
    seeds in processes of their own (fp32; HEADS_BF16 with its CPU gate),
    every step finite, the mode's convs in bf16. ``hold_curves`` holds each
    mode's seed set to the seed-set gate, failing on a median that misses
    it and on a mode whose convs did not run in bf16."""
    from tools.train_curve_torch import SEED_GATE, run_curves

    results = run_curves(chip_smoke.CURVE_MODES, 4, 2, (0, 1), chip_smoke.CURVE_LR, "cpu")
    assert sorted(results) == sorted((n, s) for n in chip_smoke.CURVE_MODES for s in (0, 1))
    curves = {name: [results[(name, s)][0] for s in (0, 1)] for name in chip_smoke.CURVE_MODES}
    assert [c["heads_bf16"] for n in ("fp32", "HEADS_BF16") for c in curves[n]] == [False, False, True, True]
    assert [c["seed"] for c in curves["fp32"]] == [0, 1]
    assert all(c["steps_run"] == 4 and c["eval"]["step"] == [0, 2, 4] for cs in curves.values() for c in cs)
    assert all(set(counts) == {name for name, _, _ in chip_smoke.KERNELS + chip_smoke.BF16_KERNELS}
               for _, counts in results.values())
    good = {name: [dict(c, eval_loss_ratio=0.75, initial_vcre=30.0, final_vcre=20.0, final_R_err=60.0) for c in cs]
            for name, cs in curves.items()}
    held = chip_smoke.hold_curves(good)
    assert set(held) == {"fp32", "HEADS_BF16"} and held["fp32"]["missed"] == []
    assert held["fp32"]["thresholds"] == SEED_GATE and set(held["fp32"]["per_seed"]) == {0, 1}
    assert held["fp32"]["curve_gates_met"] == {"eval_loss_ratio < 0.70": 0, "final_vcre < 0.6 x initial": 0,
                                               "final_R_err < 45 deg": 0}
    assert "seed-set gate" in chip_smoke.curve_line(held, "card")
    for wrong, gate in ((dict(eval_loss_ratio=0.9), "median eval_loss_ratio 0.9000"),
                        (dict(final_vcre=29.0), "median vcre_ratio 0.9667"),
                        (dict(final_R_err=120.0), "median final_R_err 120.0000")):
        with pytest.raises(chip_smoke.SmokeError, match=gate):
            chip_smoke.hold_curves(dict(good, fp32=[dict(c, **wrong) for c in good["fp32"]]))
    # a median: one seed of three past a threshold does not fail the set
    three = [dict(good["fp32"][0], seed=s) for s in range(3)]
    assert chip_smoke.hold_curves({"fp32": [dict(three[0], final_R_err=150.0)] + three[1:]})["fp32"]["missed"] == []
    with pytest.raises(chip_smoke.SmokeError, match="did not run in bf16"):
        chip_smoke.hold_curves(dict(good, HEADS_BF16=[dict(c, heads_bf16=False) for c in good["HEADS_BF16"]]))


def test_gates_phase_rehearsal(tmp_path, monkeypatch, one_torch_thread):
    """Phase 3j at the JAX tool's tiny shape on the CPU: the route gate on 8
    pairs in batches of 4 (K2b and K3 against their plain versions first,
    each route alone, the JAX tool's gates), then the quality tool's dry run
    with its demo leg. The launch checks get the counts as the card would
    give them."""
    checked = _recorded_checks(monkeypatch)
    monkeypatch.setattr(chip_smoke, "_elapsed_ms", _wall_ms)  # CUDA events need the card
    res = chip_smoke.run_route_gate(default_config(), "cpu", pairs=8, batch=4, n=96, tiny=True)
    assert res["errs"] == {"pair_topk": 0.0, "hypothesis_scores": 0.0}  # plain against plain
    assert list(res["stats"]) == ["shape", "dense", "fused", "paired"] and res["stats"]["paired"]["pairs"] == 8
    assert res["stats"]["shape"]["N"] == 96 and set(res["ms"]) == {"dense", "fused"}
    for route in ("dense", "fused"):
        assert (f"route gate, {route} route", chip_smoke.ROUTE_KERNELS[route],
                chip_smoke.ROUTE_ABSENT[route] + ("flash_attention_packed", "flash_attention",
                                                  "flash_attention_packed_f32")) in checked
        assert (f"route gate, {route} route", 2) in checked
    assert "route gate: ok" in chip_smoke.route_line(res, "card")
    q = chip_smoke.run_quality("cpu", tmp_path)
    assert tuple(q["metrics"]) == chip_smoke.QUALITY_METRICS and (tmp_path / "q" / "submission.zip").is_file()
    assert ("quality dry run", chip_smoke.QUALITY_KERNELS, chip_smoke.QUALITY_ABSENT) in checked
    assert ("quality dry run", 2) in checked
    assert "MICKEY_TOY_EXAMPLE" not in os.environ and "quality: ok" in chip_smoke.quality_line(q, "card")
    from tools.fused_route_gate_torch import gate_shape, make_pair_batch

    shape = gate_shape(default_config())  # the production shape: only the inputs are made here
    d = {k: torch.from_numpy(v) for k, v in make_pair_batch(np.random.default_rng(0), 8, 1938, 128)[0].items()}
    ins = chip_smoke.route_kernel_inputs("cpu", shape, d)
    assert ins["dsc0"].shape == (8, 1938, 128) and ins["scr0"].shape == (8, 1938) and ins["topl"] == 16
    assert ins["X"].shape == (160, 2048, 3) and ins["R"].shape == (160, 100, 3, 3) and ins["prefilter"] == 4096


def test_route_gate_catches_a_wrong_route(monkeypatch, one_torch_thread):
    """A fused route whose confidences are 20% off fails the JAX tool's
    confidence gate, and the phase fails with it."""
    import tools.fused_route_gate_torch as gate

    _recorded_checks(monkeypatch)
    monkeypatch.setattr(chip_smoke, "_elapsed_ms", _wall_ms)
    make = gate.make_routes

    def wrong(cfg, shape):
        routes = make(cfg, shape)
        fused = routes["fused"]
        return dict(routes, fused=lambda d, g, draws=None: (lambda o: (o[0], o[1], 1.2 * o[2], o[3]))(fused(d, g, draws)))

    monkeypatch.setattr(gate, "make_routes", wrong)
    with pytest.raises(chip_smoke.SmokeError, match="rel_conf_delta_med"):
        chip_smoke.run_route_gate(default_config(), "cpu", pairs=8, batch=4, n=96, tiny=True)
