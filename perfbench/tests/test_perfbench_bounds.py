"""The copied bound arithmetic against ``chip_smoke.py``'s own figures at
PERF.md's kernel-table shapes (its ``kernel_bounds``: three TF32 passes at
495 TFLOP/s, which are one fp32-accurate pass at 165)."""

import pytest

from perfbench.harness import bounds

# PERF.md's kernel table, "Bound ms" (chip_smoke.kernel_bounds at those shapes)
TABLE = {"K1 bf16": 0.0623, "K2b": 0.0117, "K5": 0.0466 + 0.1399}


def test_k1_bound():
    assert 1e3 * bounds.attention_s((4, 1939, 3072), 16, 2) == pytest.approx(TABLE["K1 bf16"], abs=5e-5)


def test_k2b_bound():
    assert 1e3 * bounds.pair_topk_s((2, 1938, 128), (2, 1938, 128), 16) == pytest.approx(TABLE["K2b"], abs=5e-5)


def test_k5_bound_is_both_launches():
    assert 1e3 * bounds.dual_softmax_bwd_s((8, 1938, 128), (8, 1938, 128)) == pytest.approx(TABLE["K5"], abs=5e-5)


def test_three_tf32_passes_are_one_fp32_accurate_pass():
    assert 3 / 495e12 == pytest.approx(1 / bounds.PEAK_FP32_ACCURATE)


def test_whole_step_bounds_stay_under_measured_times():
    """The least times of a served batch and a training step at the cells'
    shapes, against PERF.md's fastest measured stages (ViT-L/14 backbone
    24.4 ms for 4 images; the training step 395 ms): every mfu stays under
    100%."""
    from mickey_tpu_torch.config import default_config

    cfg = default_config()
    hw = 51 * 38
    vit = (1024, 24, 4096, False)
    assert bounds.vit_flops(hw + 1, *vit) * 4 / bounds.PEAK_BF16 < 24.4e-3
    assert bounds.train_least_s(cfg, 8, hw, vit) < 0.395
