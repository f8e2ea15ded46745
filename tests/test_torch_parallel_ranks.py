"""What each rank runs in ``tests/test_torch_parallel.py``'s data-parallel
checks (``parallel.launch``).

``launch`` spawns fresh processes that import the function's module, so this
module imports only numpy, torch and the port: never jax nor ``mickey_tpu``
(the test file that holds the port against them does). It holds no tests.
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from mickey_tpu_torch import parallel
from mickey_tpu_torch.training.train_step import StagedTrainStep, init_train_state
from mickey_tpu_torch.weights import is_bn_stat, params_to_numpy, params_to_torch, tree_leaves, tree_unflatten


def local_fmap(fmap: np.ndarray, rows: slice) -> np.ndarray:
    """This rank's rows of a stacked (2B, ...) map: its image0 rows, then its
    image1 rows."""
    b = fmap.shape[0] // 2
    return np.concatenate([fmap[:b][rows], fmap[b:][rows]])


def rank_grad_step(cfg, params, fmap, batch, draws, topk: float, seed: int = 7):
    """One staged step on this rank's rows of the global (fmap, batch); the
    draws injected (the global ``draws`` sliced) or, for None, drawn from a
    generator seeded with ``seed``. Returns the updated trainables, the
    gradients the optimizer applied (both numpy trees in ``mickey_tpu``'s
    layout) and the step's metrics."""
    dp = parallel.world()
    b = batch["T_0to1"].shape[0]
    rows = dp.rows(b)
    state, _ = init_train_state(cfg, params_to_torch(params, cfg, "cpu"))
    step = StagedTrainStep(cfg)
    applied = []
    update = step.optimizer.update
    step.optimizer.update = lambda leaves, grads, st: (applied.extend(g.clone() for g in grads),
                                                       update(leaves, grads, st))[1]
    tb = {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}
    override = None if draws is None else tuple(torch.from_numpy(np.ascontiguousarray(d[rows])) for d in draws)
    gen = torch.Generator().manual_seed(seed)
    with parallel.global_batch(dp, rows.stop - rows.start):
        _, metrics = step.grad_step(state, torch.from_numpy(local_fmap(fmap, rows)), tb, gen, topk,
                                    sample_override=override)
    it = iter(applied)
    grads = tree_unflatten(state.params, iter([torch.zeros_like(t) if is_bn_stat(path) else next(it)
                                               for path, t in tree_leaves(state.params)]))
    return params_to_numpy(state.params), params_to_numpy(grads), {k: float(v) for k, v in metrics.items()}


def rank_loss_mask(baseline: np.ndarray, row_ok: np.ndarray, topk: float):
    """The loss's curriculum mask and metrics on this rank's rows of given
    global per-pair losses (it = 1, no hypotheses to solve)."""
    from mickey_tpu_torch.training.loss import LossConfig, _curriculum_loss

    dp = parallel.world()
    rows = dp.rows(baseline.shape[0])
    base = torch.from_numpy(baseline[rows]).requires_grad_()
    lv = base.detach()[:, None]
    lc = LossConfig(train_with_topk=True)
    zero = torch.zeros(())
    with parallel.global_batch(dp, rows.stop - rows.start):
        total, aux = _curriculum_loss(base, lv, lv[:, 0], lv[:, 0], torch.from_numpy(row_ok[rows]),
                                      torch.zeros((base.shape[0], 1, 1)), zero, zero, lc, topk)
    total.backward()
    return {"mask": aux["mask_topk"].numpy(), "avg_loss": float(aux["avg_loss"]),
            "num_valid": int(aux["num_valid"]), "grad": base.grad.numpy()}


def rank_batchnorm(x: np.ndarray, p: dict):
    """Train-mode BatchNorm on this rank's rows of x (B, H, W, C): the
    output rows, the new running stats, and the gradient of a fixed linear
    functional of the global output, summed over the ranks."""
    from mickey_tpu_torch.nn.common import batchnorm

    dp = parallel.world()
    rows = dp.rows(x.shape[0])
    xt = torch.from_numpy(x[rows]).requires_grad_()
    w = torch.linspace(-1, 1, x[rows].size, dtype=torch.float32).reshape(xt.shape) * (1 + dp.rank)
    with parallel.global_batch(dp, rows.stop - rows.start):
        out, new_p = batchnorm({k: torch.from_numpy(v) for k, v in p.items()}, xt, train=True)
    (out * w).sum().backward()
    return out.detach().numpy(), new_p["mean"].numpy(), new_p["var"].numpy(), xt.grad.numpy()


def rank_draws(shape, batch_axis: int, seed: int):
    """Gumbel noise of this rank's rows inside a step, from a shared seed."""
    from mickey_tpu_torch.ops.sampling import gumbel_noise

    dp = parallel.world()
    n = shape[batch_axis]
    local = list(shape)
    local[batch_axis] = n // dp.size
    with parallel.global_batch(dp, n // dp.size):
        return gumbel_noise(tuple(local), torch.Generator().manual_seed(seed), "cpu", batch_axis).numpy()


def rank_collectives(x: np.ndarray):
    """The helpers' results on this rank: its rows, all-gathered rows, a
    flat-buffer gradient sum, a broadcast from rank 0, an object broadcast."""
    dp = parallel.world()
    mine = dp.shard_rows(torch.from_numpy(x))
    gathered = dp.all_gather_rows(mine + 0)
    grads = [torch.full((2, 3), float(dp.rank + 1)), torch.arange(4, dtype=torch.float64) * (dp.rank + 1)]
    dp.all_reduce_(grads)
    state = [torch.full((3,), float(dp.rank)), torch.tensor([dp.rank], dtype=torch.int64)]
    dp.broadcast_(state)
    return {"rank": dp.rank, "mine": mine.numpy(), "gathered": gathered.numpy(),
            "grads": [g.numpy() for g in grads], "state": [s.numpy() for s in state],
            "seed": dp.broadcast_object(100 + dp.rank)}


def rank_hangs():
    """Rank 1 never returns (as a rank stuck in a collective would not)."""
    import time

    if parallel.world().rank == 1:
        time.sleep(3600)
    return parallel.world().rank


def rank_fails():
    if parallel.world().rank == 1:
        raise ValueError("rank 1 fails on purpose")
    parallel.world().barrier()


# -- serving ---------------------------------------------------------------------------


class Out(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    valid: torch.Tensor


class StandIn:
    """A deterministic stand-in model for ``predict``: each pose from a few
    pixels of its own pair, so it depends on nothing but the pair (not on
    the rows it is served with). A query whose first pixel is dark has no
    finite estimate; one whose second is dark the all-zero rotation."""

    def __init__(self, cfg):
        self.cfg, self.device, self.extracts = cfg, torch.device("cpu"), []

    def extract_feats(self, images):
        self.extracts.append(images.shape[0])
        x = images.float()
        return x[:, :1, :1], x[:, -1:, -1:], x[:, 2:3, 3:4], x[:, :1, 1:2]

    def _pose(self, f0, f1, image1):
        b = image1.shape[0]
        x = image1.float()
        t = (f1[0] - f0[0]).reshape(b, 1, 3).clone()
        R = torch.eye(3).repeat(b, 1, 1) * (1 + f0[1][:, 0, 0, :1, None])
        t[x[:, 0, 0, 0] < 0.1] = float("nan")
        R[x[:, 0, 1, 0] < 0.1] = 0
        inliers = f1[2][:, 0, 0, 0] * 255 + f0[3][:, 0, 0, 1]
        return Out(R, t, inliers, torch.ones(b, dtype=torch.bool))

    def call_with_ref_feats(self, ref_feats, image1, K0, K1, generator=None):
        return self._pose(ref_feats, self.extract_feats(image1), image1)

    def __call__(self, image0, image1, K0, K1, generator=None, lite=False):
        return self._pose(self.extract_feats(image0), self.extract_feats(image1), image1)


def rank_predict(cfg, shared_ref: bool, out_zip: str):
    """``predict`` with the stand-in model on this rank; rank 0 writes the zip."""
    from mickey_tpu_torch.cli.submission import predict, save_submission
    from mickey_tpu_torch.data.loader import DataModule

    dp = parallel.world()
    loader = DataModule(cfg, drop_last_val=False).val_dataloader()
    results = predict(loader, StandIn(cfg), progress=False, shared_ref=shared_ref)
    if dp.rank == 0:
        save_submission(results, Path(out_zip))
    return sum(len(v) for v in results.values())


def rank_sharded_serving(cfg, params, image0, image1, K0, K1, seed: int):
    """The three sharded entries of the tiny real model on this rank; every
    rank passes the same global batch and gets the global outputs."""
    from mickey_tpu_torch.models import MickeyRelativePose

    dp = parallel.world()
    model = MickeyRelativePose(cfg, params_to_torch(params, cfg, "cpu"), device="cpu")
    ims = [torch.from_numpy(x) for x in (image0, image1, K0, K1)]
    out = model.sharded_call(dp, *ims, generator=torch.Generator().manual_seed(seed))
    ref_feats = model.sharded_extract_feats(dp, ims[0])
    shared = model.sharded_call_with_ref_feats(dp, ref_feats, *ims[1:], generator=torch.Generator().manual_seed(seed))
    return ({k: getattr(out, k).numpy() for k in ("R", "t", "inliers", "valid")},
            [f.numpy() for f in ref_feats], {k: getattr(shared, k).numpy() for k in ("R", "t", "inliers", "valid")})


@contextmanager
def injected_draws(draws):
    """Every staged step in this process takes this rank's rows of the
    global loss draws ``draws`` (idx, ridx), or its generator's for None:
    a minimal set drawn at random can repeat a keypoint, whose rotation a
    rounding decides, so two runs of ``fit`` compare only on such draws."""
    if draws is None:
        yield
        return
    rows = parallel.world().rows(len(draws[0]))
    local = tuple(torch.from_numpy(np.ascontiguousarray(d[rows])) for d in draws)
    grad_step = StagedTrainStep.grad_step
    StagedTrainStep.grad_step = (lambda self, state, fmap, batch, generator=None, topk_pct=100.0,
                                 sample_override=None: grad_step(self, state, fmap, batch, generator, topk_pct, local))
    try:
        yield
    finally:
        StagedTrainStep.grad_step = grad_step


def rank_train_model(cfg, argv, seed: int = 0, draws=None):
    """The training CLI's ``train_model`` on this rank (the CPU), with the
    process's ``random`` seeded so every run draws the same dataset seed on
    rank 0; ``draws`` as ``injected_draws``. Returns what the trainer ends
    with and what this rank wrote."""
    import random

    from mickey_tpu_torch.cli import train as cli
    from mickey_tpu_torch.models import training_model

    random.seed(seed + parallel.world().rank)  # rank 0's draw must win the broadcast
    saved = []
    save = training_model.save_checkpoint
    training_model.save_checkpoint = lambda path, *a, **k: (saved.append(Path(path).name), save(path, *a, **k))
    try:
        with injected_draws(draws):
            tr = cli.train_model(cli.parser().parse_args(argv), cfg=cfg, device="cpu")
    finally:
        training_model.save_checkpoint = save
    return {"params": params_to_numpy(tr.state.params), "mu": tr._moments(tr.state.opt_state.mu),
            "best": dict(tr.best), "step": tr.global_step,
            "topk": tr.topk, "saved": saved, "writer": bool(tr._get_writer()), "seed": tr.cfg.DATASET.SEED}


def rank_validation(cfg, params):
    """The trainer's validation of the val loader's first batch (this rank's
    rows of it) on ``params``: the step's outputs and their aggregation."""
    from mickey_tpu_torch.data.loader import DataModuleTraining
    from mickey_tpu_torch.models import MicKeyTrainer

    dp = parallel.world()
    tr = MicKeyTrainer(cfg, params=params, device="cpu", out_dir="unused", dp=dp)
    loader = DataModuleTraining(cfg).val_dataloader()
    if dp.size > 1:
        loader.shard = (dp.rank, dp.size)
    out = tr.validation_step(next(iter(loader)))
    return out, tr.aggregate_validation([out])


def rank_fit(cfg, params, out_dir: str, draws=None):
    """One epoch of ``MicKeyTrainer.fit`` on this rank (the CPU), ``draws``
    as ``injected_draws``; returns the trainables, the step count and Adam's
    first moments."""
    from mickey_tpu_torch.data.loader import DataModuleTraining
    from mickey_tpu_torch.models import MicKeyTrainer

    tr = MicKeyTrainer(cfg, params=params, device="cpu", out_dir=out_dir, dp=parallel.world())
    with injected_draws(draws):
        tr.fit(DataModuleTraining(cfg), max_epochs=1, val_batches=1, log_interval=10)
    return params_to_numpy(tr.state.params), tr.global_step, tr._moments(tr.state.opt_state.mu)


def rank_entry_points_on_a_cpu_group(cfg, argv):
    """The training and submission entry points on this rank of a CPU group,
    in a process made to see a CUDA device: what each raises (None where it
    raised nothing)."""
    import argparse

    from mickey_tpu_torch.cli import submission
    from mickey_tpu_torch.cli import train as cli

    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 1
    errors = []
    for call in (lambda: cli.train_model(cli.parser().parse_args(argv), cfg=cfg),
                 lambda: submission.eval_split(argparse.Namespace(), cfg=cfg)):
        try:
            call()
            errors.append(None)
        except RuntimeError as e:
            errors.append(str(e))
    parallel.refuse_cpu_group(parallel.world(), asked_cpu=True)  # a caller that asks for the CPU gets it
    return errors
