"""Whole runs of both runners at the tiny size on the CPU, past the look for
a card: a sound run is correct, the control (the plain reference in the
program's place one precision step down) is not, and neither is a run whose
timed path is broken underneath, once for each fault the cell can have."""

import time
import types

import pytest
import torch

from perfbench.harness import submit, train
from perfbench.reference import mickey

from conftest import tiny_cell


def _args(seed, **kw):
    return types.SimpleNamespace(seed=seed, seconds=None, batches=kw.get("batches", 6), trace=0)


def _serve(seed=2147483711, model_factory=submit.program_model):
    return submit.run(tiny_cell("submit"), _args(seed), time.perf_counter(), device="cpu",
                      model_factory=model_factory)[1]


def test_serving_sound_run_is_correct(one_thread):
    checks = _serve()
    assert checks.correct, checks.lines()


def test_serving_control_is_not(one_thread):
    checks = _serve(model_factory=lambda cfg, p, d: submit.ReferenceModel(cfg, p, d, mickey.CONTROL))
    assert not checks.correct and all(v > checks.limits[k] for k, v in checks.values.items()), checks.lines()


def _answer_altered(monkeypatch):
    """The solver's answer altered where it is made: t moved by 1%."""
    from mickey_tpu_torch.models import relative_pose

    real = relative_pose.estimate_pose_topk_from_cfg
    monkeypatch.setattr(relative_pose, "estimate_pose_topk_from_cfg",
                        lambda *a, **k: (lambda e: e._replace(t=e.t * 1.01))(real(*a, **k)))


def _half_batch(monkeypatch):
    """Half the batch left out: its rows come back without a pose."""
    from mickey_tpu_torch.models import relative_pose

    real = relative_pose.MickeyRelativePose.solve

    def solve(self, *a, **k):
        out = real(self, *a, **k)
        half = out.R.shape[0] // 2
        return out._replace(R=torch.cat([out.R[:half], torch.zeros_like(out.R[half:])]))

    monkeypatch.setattr(relative_pose.MickeyRelativePose, "solve", solve)


def _refinement_dropped(monkeypatch):
    """The solver's refinements computed and dropped: each keeps the pose it
    counted its inliers under, so the hypothesis is returned."""
    from mickey_tpu_torch.solver import procrustes_ransac as ransac

    count, procrustes, held = ransac.inlier_counting_3d, ransac.weighted_procrustes, {}

    def counting(X, Y, R, t, *a, **k):
        held["pose"] = (R, t)
        return count(X, Y, R, t, *a, **k)

    def refine(A, B, *a, **k):
        out = procrustes(A, B, *a, **k)
        return out._replace(R=held["pose"][0], t=held["pose"][1]) if k.get("use_mask") else out

    monkeypatch.setattr(ransac, "inlier_counting_3d", counting)
    monkeypatch.setattr(ransac, "weighted_procrustes", refine)


def _refinement_skipped(monkeypatch):
    """The solver skips its refinements: the hypothesis is returned."""
    from mickey_tpu_torch.solver import procrustes_ransac as ransac

    real = ransac.estimate_pose_topk
    monkeypatch.setattr(ransac, "estimate_pose_topk", lambda *a, **k: real(*a, **dict(k, num_refinements=0)))


def _inlier_threshold_moved(monkeypatch):
    """The solver's hard inliers counted at 0.14 m where the configuration
    states 0.15 m."""
    from mickey_tpu_torch.solver import procrustes_ransac as ransac

    count = ransac.inlier_counting_3d
    monkeypatch.setattr(ransac, "inlier_counting_3d", lambda X, Y, R, t, th=0.5: count(X, Y, R, t, th=th - 0.01))


@pytest.mark.parametrize("fault", [_answer_altered, _half_batch, _refinement_dropped, _refinement_skipped,
                                   _inlier_threshold_moved],
                         ids=["answer_altered", "half_batch", "refinement_dropped", "refinement_skipped",
                              "inlier_threshold_moved"])
def test_serving_faults_are_not_correct(fault, monkeypatch, one_thread):
    fault(monkeypatch)
    checks = _serve()
    assert not checks.correct, checks.lines()


def _train(seed=2147483713, **kw):
    return train.run(tiny_cell("train"), _args(seed, batches=1), time.perf_counter(), device="cpu", **kw)[1]


def test_training_sound_run_is_correct(one_thread):
    checks = _train()
    assert checks.correct, checks.lines()


def test_training_control_is_not(one_thread):
    checks = _train(control=mickey.CONTROL)
    assert not checks.correct, checks.lines()


def _train_half_batch(monkeypatch):
    """Half the batch left out of the loss, its mean taken over the rest."""
    from mickey_tpu_torch.training import loss

    real = loss._curriculum_loss

    def curriculum(baseline, loss_value, lr, lt, row_ok, *a, **k):
        keep = torch.arange(row_ok.shape[0], device=row_ok.device) < row_ok.shape[0] // 2
        return real(baseline, loss_value, lr, lt, row_ok & keep, *a, **k)

    monkeypatch.setattr(loss, "_curriculum_loss", curriculum)


def _loss_altered(monkeypatch):
    """The step's reported loss altered where it is made."""
    from mickey_tpu_torch.training import train_step

    real = train_step.StagedTrainStep.grad_step

    def grad_step(self, *a, **k):
        state, metrics = real(self, *a, **k)
        return state, dict(metrics, loss=metrics["loss"] * 1.01)

    monkeypatch.setattr(train_step.StagedTrainStep, "grad_step", grad_step)


def test_training_state_unchanged_is_not_correct(monkeypatch, one_thread):
    """The step returns its state unchanged: the optimizer applies nothing."""
    from mickey_tpu_torch.training.train_step import Optimizer

    monkeypatch.setattr(Optimizer, "update", lambda self, leaves, grads, state: torch.zeros(()))
    checks = _train()
    assert checks.values["delta_err"] > checks.limits["delta_err"], checks.lines()


@pytest.mark.parametrize("fault", [_train_half_batch, _loss_altered], ids=["half_batch", "loss_altered"])
def test_training_faults_are_not_correct(fault, monkeypatch, one_thread):
    fault(monkeypatch)
    checks = _train()
    assert not checks.correct, checks.lines()
