"""The readings the comparison's limits are set from, on the card: the
program's comparison numbers on many seeds and the controls' on a few, all
in one process (the kernels build once), each run a window of a fixed number
of batches at the cell's own load.

    python3 perfbench/calibrate.py --workload vitl14.submit.kf.b8 --seeds 12 --controls 3 \\
        --out calibrate.jsonl

Controls (``--control``, repeatable; all of the runner's by default):
``fp8``, the plain reference in the program's place one precision step
below the configuration's (block linears on fp8 operands, every fp32
product on TF32 operands), and, for serving,
``program_int8``, the program with its own int8 backbone
(``MICKEY.DINOV2.INT8``), and the planted ``fault_refinement_dropped``; for
training, the faults planted in the program whose readings can set a
number's upper end (``fault_half_batch``, ``fault_unchanged``,
``fault_loss_altered``), and ``eps_raised``, a reading of Adam's eps at 1e-4
on both sides.
"""

import argparse
import copy
import json
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import core, submit, train  # noqa: E402
from perfbench.reference import mickey  # noqa: E402


def _program_int8(cfg, params, device):
    cfg = copy.deepcopy(cfg)
    cfg.MICKEY.DINOV2.INT8 = True
    return submit.program_model(cfg, params, device)


def _planted(fault):
    """A training run with a fault planted in the program for its length."""

    def run(c, a, t0):
        undo = fault()
        try:
            return train.run(c, a, t0)[1]
        finally:
            undo()

    return run


def _planted_serve(fault):
    """A served run with a fault planted in the program for its length."""

    def run(c, a, t0):
        undo = fault()
        try:
            return submit.run(c, a, t0)[1]
        finally:
            undo()

    return run


def _refinement_dropped():
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

    ransac.inlier_counting_3d, ransac.weighted_procrustes = counting, refine

    def undo():
        ransac.inlier_counting_3d, ransac.weighted_procrustes = count, procrustes

    return undo


def _eps_raised():
    """Adam's eps at 1e-4 on both sides (the program's optimizer and the
    reference's): a reading of how far the change's gap follows gradients
    near eps, not a run of the configuration."""
    from mickey_tpu_torch.training import train_step
    from perfbench.reference import train_ref

    opt_init, ref_init = train_step.Optimizer.__init__, train_ref.Adam.__init__
    train_step.Optimizer.__init__ = lambda self, cfg, b1=0.9, b2=0.999, eps=1e-6: opt_init(self, cfg, b1, b2, 1e-4)
    train_ref.Adam.__init__ = lambda self, leaves_, lr, clip, b1=0.9, b2=0.999, eps=1e-6: ref_init(
        self, leaves_, lr, clip, b1, b2, 1e-4)

    def undo():
        train_step.Optimizer.__init__, train_ref.Adam.__init__ = opt_init, ref_init

    return undo


def _half_batch():
    """Half the batch left out of the loss, its mean taken over the rest."""
    import torch
    from mickey_tpu_torch.training import loss

    real = loss._curriculum_loss

    def curriculum(baseline, loss_value, lr, lt, row_ok, *a, **k):
        keep = torch.arange(row_ok.shape[0], device=row_ok.device) < row_ok.shape[0] // 2
        return real(baseline, loss_value, lr, lt, row_ok & keep, *a, **k)

    loss._curriculum_loss = curriculum
    return lambda: setattr(loss, "_curriculum_loss", real)


def _unchanged():
    """The step returns its state unchanged: the optimizer applies nothing."""
    import torch
    from mickey_tpu_torch.training.train_step import Optimizer

    real = Optimizer.update
    Optimizer.update = lambda self, leaves, grads, state: torch.zeros((), device=leaves[0].device)
    return lambda: setattr(Optimizer, "update", real)


def _loss_altered():
    """The step's reported loss altered where it is made."""
    from mickey_tpu_torch.training.train_step import StagedTrainStep

    real = StagedTrainStep.grad_step

    def grad_step(self, *a, **k):
        state, metrics = real(self, *a, **k)
        return state, dict(metrics, loss=metrics["loss"] * 1.01)

    StagedTrainStep.grad_step = grad_step
    return lambda: setattr(StagedTrainStep, "grad_step", real)


BASE_SEED = 3_000_000_017

# runner -> control or fault name -> (cell, args, t0) -> the run's checks
RUNS = {
    "submit": {
        "program": lambda c, a, t0: submit.run(c, a, t0)[1],
        "fp8": lambda c, a, t0: submit.run(
            c, a, t0, model_factory=lambda cfg, p, d: submit.ReferenceModel(cfg, p, d, mickey.CONTROL))[1],
        "program_int8": lambda c, a, t0: submit.run(c, a, t0, model_factory=_program_int8)[1],
        "fault_refinement_dropped": _planted_serve(_refinement_dropped),
    },
    "train": {
        "program": lambda c, a, t0: train.run(c, a, t0)[1],
        "fp8": lambda c, a, t0: train.run(c, a, t0, control=mickey.CONTROL)[1],
        "fault_half_batch": _planted(_half_batch),
        "fault_unchanged": _planted(_unchanged),
        "fault_loss_altered": _planted(_loss_altered),
        "eps_raised": _planted(_eps_raised),
    },
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--control", action="append",
                   help="fp8; program_int8, fault_refinement_dropped (serving); fault_half_batch, fault_unchanged, "
                        "fault_loss_altered, eps_raised (training)")
    p.add_argument("--seed", type=int, action="append", default=[], help="a further seed of the program's runs")
    p.add_argument("--out", default="calibrate.jsonl", help="JSON lines appended, one a run")
    p.add_argument("--taps", default=None, help="served cells: the backbone blocks read, as 0,1,3 (the first "
                   "alone, feat_err's, by default)")
    a = p.parse_args(argv)
    cell = core.resolve(a.workload)
    core.require_cards(cell.chips)
    cell.limits = {k: float("inf") for k in cell.limits}  # readings only
    kinds = RUNS[cell.traffic["runner"]]
    # the checked batches lie among the window's first ones; training checks its set-up steps
    batches = cell.traffic["check"]["among_first"] + 1 if "check" in cell.traffic else 0
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = [("program", BASE_SEED + 7919 * i) for i in range(a.seeds)] + [("program", s) for s in a.seed]
    for name in a.control or [k for k in kinds if k != "program"]:
        runs += [(name, BASE_SEED + 104729 * (i + 1)) for i in range(a.controls)]
    with out.open("a") as f:
        for name, seed in runs:
            t0 = time.perf_counter()
            taps = tuple(int(x) for x in a.taps.split(",")) if a.taps else None
            args = types.SimpleNamespace(seed=seed, seconds=None, batches=batches, trace=0, taps=taps)
            checks = kinds[name](cell, args, t0)
            rec = {"workload": a.workload, "side": name, "seed": seed, "numbers": checks.values,
                   "readings": checks.notes, "seconds": time.perf_counter() - t0}
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
