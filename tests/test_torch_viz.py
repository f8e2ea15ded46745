"""The port's visualization utilities against mickey_tpu on the CPU: the
same numpy / cv2 / matplotlib code on the same seeded inputs, so every
panel is bitwise equal (values, dtype and shape)."""

import numpy as np
import pytest

from mickey_tpu.utils import viz as jviz
from mickey_tpu_torch.utils import viz

H, W = 126, 112


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(6)
    n = (H // 14) * (W // 14)
    return {
        "im0": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        "im1": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        "depth": rng.uniform(0.5, 8, (H // 14, W // 14)).astype(np.float32),
        "scores": rng.uniform(0, 1, (1, n)).astype(np.float32),
        "pts0": rng.uniform(0, W - 1, (80, 2)).astype(np.float32),
        "pts1": rng.uniform(0, W - 1, (80, 2)).astype(np.float32),
        "msc": rng.uniform(0, 1, 80).astype(np.float32),
        "coeff": rng.normal(size=80).astype(np.float32),
    }


def test_colorize_and_depth_panels(inputs):
    d = inputs["depth"]
    for kw in ({}, {"vmin": 1.0, "vmax": 4.0}, {"cmap": "viridis"}):
        _same(viz.colorize(d, **kw), jviz.colorize(d, **kw))
    masked = d.copy()
    masked[0] = -99  # invalid values keep the background colour
    _same(viz.colorize(masked), jviz.colorize(masked))
    mask = np.zeros_like(d, bool)
    mask[:, :2] = True
    _same(viz.colorize(d, invalid_mask=mask), jviz.colorize(d, invalid_mask=mask))
    _same(viz.colorize(np.full_like(d, -99)), jviz.colorize(np.full_like(d, -99)))  # nothing valid
    _same(viz.colorize_depth(d[..., None]), jviz.colorize_depth(d[..., None]))
    assert viz.colorize_depth(d).shape == (H, W, 4)


def test_score_and_match_panels(inputs):
    x = inputs
    for t in (0.5, 0.2):
        _same(viz.prepare_score_map(x["scores"], x["im0"], t), jviz.prepare_score_map(x["scores"], x["im0"], t))
    for n, sc in ((80, x["msc"]), (10, None)):
        _same(viz.draw_matches(x["im0"], x["im1"], x["pts0"][:n], x["pts1"][:n], None if sc is None else sc[:n]),
              jviz.draw_matches(x["im0"], x["im1"], x["pts0"][:n], x["pts1"][:n], None if sc is None else sc[:n]))
    out = viz.draw_reward_matches(x["im0"], x["im1"], x["pts0"], x["pts1"], x["coeff"])
    _same(out, jviz.draw_reward_matches(x["im0"], x["im1"], x["pts0"], x["pts1"], x["coeff"]))
    assert out.shape == (H, 2 * W + 50, 3)
