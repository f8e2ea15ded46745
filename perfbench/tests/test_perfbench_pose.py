"""The served solver's comparison (``reference/serve_check``): the pose gap's
arithmetic and the replay of the refinement on the served masks."""

import math

import pytest
import torch

from perfbench.reference import mickey, serve_check


def _rot(axis, angle):
    k = torch.tensor(axis, dtype=torch.float64)
    k = k / torch.linalg.norm(k)
    K = torch.tensor([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=torch.float64)
    return torch.eye(3, dtype=torch.float64) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


@pytest.mark.parametrize("angle", [1e-7, 1e-3, 0.5, 3.0])
def test_the_pose_gap_is_how_far_the_pose_moves_its_points(angle):
    dR, eye = _rot([0.0, 0.0, 1.0], angle), torch.eye(3, dtype=torch.float64)
    ring = torch.tensor([[2.0, 0.0, 1.0], [0.0, 2.0, 1.0], [-2.0, 0.0, 1.0], [0.0, -2.0, 1.0]], dtype=torch.float64)
    gap = serve_check.pose_gap(dR, torch.zeros(3), eye, torch.zeros(1, 3, dtype=torch.float64), ring,
                               torch.ones(4, dtype=torch.float64), 4.0)
    assert gap == pytest.approx(2.0 * math.sin(angle / 2) * 2.0 / 4.0, rel=1e-9)  # each point 2 from the axis
    # points on the axis fix no turn about it: such a pose moves them not at all
    axis = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 3.0]], dtype=torch.float64)
    on_axis = serve_check.pose_gap(dR, torch.zeros(3), torch.eye(3, dtype=torch.float64),
                                   torch.zeros(1, 3, dtype=torch.float64), axis, torch.ones(2, dtype=torch.float64), 1.0)
    assert on_axis == pytest.approx(0.0, abs=1e-12)


def test_the_translations_gap_is_its_distance_over_the_scale_and_weights_pick_points():
    R = torch.eye(3, dtype=torch.float64)
    X = torch.tensor([[1.0, 0.0, 0.0], [0.0, 5.0, 0.0]], dtype=torch.float64)
    t_ref = torch.tensor([[2.0, 0.0, 0.0]], dtype=torch.float64)
    w = torch.tensor([1.0, 0.0], dtype=torch.float64)
    assert serve_check.pose_gap(R, [2.0, 0.0, 0.02], R, t_ref, X, w, 0.5) == pytest.approx(0.04)
    assert serve_check.pose_gap(_rot([1.0, 0.0, 0.0], 0.1), [2.0, 0.0, 0.0], R, t_ref, X, w, 1.0) == pytest.approx(0.0,
                                                                                                            abs=1e-12)


def test_a_mask_off_only_at_the_threshold_reads_its_distance_from_it():
    X = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 2.0], [0.0, 0.0, 3.0]], dtype=torch.float64)
    Y = X + torch.tensor([[0.1, 0.0, 0.0], [0.15, 0.0, 0.0], [0.3, 0.0, 0.0]], dtype=torch.float64)
    R, t = torch.eye(3, dtype=torch.float64), torch.zeros(1, 3, dtype=torch.float64)
    exact = mickey.hard_inliers(X, Y, R, t, 0.15, mickey.REF).bool()
    assert serve_check.mask_gap(X, Y, R, t, exact, 0.15) == 0.0
    at_threshold = exact.clone()
    at_threshold[1] = ~at_threshold[1]  # 0.15 m, within rounding of the threshold
    assert serve_check.mask_gap(X, Y, R, t, at_threshold, 0.15) < 1e-4
    far = exact.clone()
    far[2] = True  # 0.3 m counted as an inlier
    assert serve_check.mask_gap(X, Y, R, t, far, 0.15) == pytest.approx(1.0, rel=1e-3)
