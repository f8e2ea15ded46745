"""Probabilistic Procrustes RANSAC, on the dense match matrix or on the fused
top-K sampling table.

Port of ``mickey_tpu/solver/procrustes_ransac.py``: ``estimate_pose`` (dense
(B, N0, N1) final scores, the exact and visualization route),
``estimate_pose_topk`` (the fused route's table) and their shared
``_solve_sampled`` core. Drawing is split from solving: ``draw_samples``
makes the Gumbel top-k draws from a ``torch.Generator``, and
``_solve_sampled`` takes them as injected index tensors, so a test can replay
the draws JAX made and compare poses one to one.

The dense route's prefilter is an exact ``torch.topk`` of the flat scores,
sorted descending, where the JAX package takes
``approx_max_k(recall_target=0.95)``: a deliberate deviation, as in the loss.
With ``prefilter`` 0 (or at least N0 * N1) the draws sample the whole flat
matrix and index it directly. ``TPU.SAMPLING = "approx"`` (the JAX
package's ``approx_max_k`` in its Gumbel top-k draws) is taken as
``"exact"``: off a TPU ``approx_max_k`` returns the exact top-k, so this is
the JAX package's answer on every device but its own (``sampling_mode``).

All it_matches x it_RANSAC minimal Kabsch solves run as one batched call,
and so does their scoring: the fused scoring kernel
(``ops.hypothesis_scoring``) takes the it_matches x B point sets of a solve
in one launch, where the JAX package scores them draw by draw in a
``lax.scan``; each (draw, pair, hypothesis) sum is independent, so the
scores are those of the per-draw calls. Refinement is the same fixed-trip
masked loop, and the zero-pose fallback is per batch element.

Spans of ``tracing``: ``solver.draws`` (``draw_samples``),
``solver.hypotheses`` (the gathers, the minimal solves, their scoring and
the pick) and ``solver.refine`` (the refinements and the confidence).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..geometry import backproject_3d, inlier_counting_3d, soft_inlier_counting_3d, weighted_procrustes
from ..ops.hypothesis_scoring import hypothesis_scores
from ..ops.sampling import gumbel_topk_sample, gumbel_topk_sample_draws
from ..ops.sampling import sample_log_weights as log_weights

NEG_INF = -1e30


class PoseEstimate(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 1, 3)
    confidence: torch.Tensor  # (B,) soft-inlier count of the best hypothesis
    valid: torch.Tensor  # (B,) bool
    # the best draw's correspondence set (inlier export, visualization)
    cor0: torch.Tensor  # (B, S, 2)
    cor1: torch.Tensor  # (B, S, 2)
    d0: torch.Tensor  # (B, S, 1)
    d1: torch.Tensor  # (B, S, 1)
    weights: torch.Tensor  # (B, S) their final scores
    inlier_mask: torch.Tensor  # (B, S) hard inliers at th_inlier under the final pose


class Draws(NamedTuple):
    outer_local: torch.Tensor  # (it, B, S) positions in the sampling table (top-P, or the flat matrix)
    ridx: torch.Tensor  # (it, B, R, C) positions among each draw's S samples


def draw_samples(generator: Optional[torch.Generator], w_table: torch.Tensor, it_matches: int,
                 it_ransac: int, num_samples: int, num_corr: int) -> Draws:
    """The solver's two levels of draws from a (B, P) table of sampling
    weights: it_matches samples of num_samples table entries, then
    it_ransac minimal sets of num_corr within each."""
    with tracing.span("solver.draws"):
        w_table = w_table.float()
        B = w_table.shape[0]
        outer = gumbel_topk_sample_draws(generator, log_weights(w_table), num_samples, it_matches, batch_axis=0)
        w = torch.gather(w_table.expand(it_matches, -1, -1), 2, outer.long())  # (it, B, S)
        logw_in = log_weights(w)[:, :, None, :].expand(it_matches, B, it_ransac, num_samples)
        return Draws(outer, gumbel_topk_sample(generator, logw_in, num_corr, batch_axis=1))


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (..., N, c) gathered at idx (..., K) along N -> (..., K, c)."""
    return torch.gather(table, -2, idx[..., None].expand(*idx.shape, table.shape[-1]))


def _solve_sampled(w_table, remap, row_ok, kps0, depth0, kps1, depth1, K0, K1,
                   draws: Draws, *, n1: int, num_corr: int, num_refinements: int,
                   th_inlier: float, th_soft_inlier: float) -> PoseEstimate:
    """RANSAC and refinement on the draws. ``w_table`` (B, P): the sampling
    table's scores; ``remap`` (B, P): its flat match indices into the
    N0 x N1 matrix, or None when the table is the flat matrix itself."""
    w_table = w_table.float()
    B = w_table.shape[0]
    kps0, depth0, kps1, depth1 = (x.float() for x in (kps0, depth0, kps1, depth1))
    X_all = backproject_3d(kps0, depth0, K0.float())  # (B, N0, 3)
    Y_all = backproject_3d(kps1, depth1, K1.float())  # (B, N1, 3)

    with tracing.span("solver.hypotheses"):
        outer_local = draws.outer_local.long()
        it, _, S = outer_local.shape
        outer_idx = outer_local if remap is None else torch.gather(remap.long().expand(it, -1, -1), 2, outer_local)
        X = _rows(X_all.expand(it, -1, -1, -1), outer_idx // n1)  # (it, B, S, 3)
        Y = _rows(Y_all.expand(it, -1, -1, -1), outer_idx % n1)

        ridx = draws.ridx.long()  # (it, B, R, C)
        nR, C = ridx.shape[2:]
        flat = ridx.reshape(it, B, nR * C)
        Xk = _rows(X, flat).reshape(it, B, nR, C, 3)
        Yk = _rows(Y, flat).reshape(it, B, nR, C, 3)
        sol = weighted_procrustes(Xk, Yk, use_weights=False)  # R (it, B, R, 3, 3)

        score = hypothesis_scores(X.reshape(it * B, S, 3), Y.reshape(it * B, S, 3),
                                  sol.R.reshape(it * B, nR, 3, 3), sol.t.reshape(it * B, nR, 1, 3),
                                  th_soft_inlier).reshape(it, B, nR)
        hyp_ok = (
            sol.valid
            & torch.isfinite(sol.R).flatten(-2).all(-1)
            & torch.isfinite(sol.t).flatten(-2).all(-1)
        )
        score = torch.where(hyp_ok, score, NEG_INF)

        best = score.argmax(dim=-1)  # (it, B)
        step_scores = torch.gather(score, 2, best[..., None])[..., 0]
        sel = best[..., None, None, None]
        R_step = torch.gather(sol.R, 2, sel.expand(it, B, 1, 3, 3))[:, :, 0]  # (it, B, 3, 3)
        t_step = torch.gather(sol.t, 2, sel.expand(it, B, 1, 1, 3))[:, :, 0]  # (it, B, 1, 3)

        best_it = step_scores.argmax(dim=0)  # (B,)
        b_idx = torch.arange(B, device=best_it.device)
        R, t = R_step[best_it, b_idx], t_step[best_it, b_idx]
        X_best, Y_best = X[best_it, b_idx], Y[best_it, b_idx]  # (B, S, 3)
        idx_best = outer_idx[best_it, b_idx]  # (B, S) flat match indices
        idx0, idx1 = idx_best // n1, idx_best % n1

    with tracing.span("solver.refine"):
        inliers_pre = torch.full((B,), float(num_corr), device=R.device)
        inliers_ref = torch.zeros((B, S), device=R.device)
        for _ in range(num_refinements):
            inliers = inlier_counting_3d(X_best, Y_best, R, t, th=th_inlier)
            n_in = inliers.sum(dim=-1)
            do_ref = (n_in >= num_corr) & (n_in > inliers_pre)
            inliers_pre = torch.where(do_ref, n_in, inliers_pre)
            inliers_ref = torch.where(do_ref[:, None], inliers, inliers_ref)
            ref = weighted_procrustes(X_best, Y_best, w=inliers_ref, use_weights=True, use_mask=True)
            R = torch.where(do_ref[:, None, None], ref.R, R)
            t = torch.where(do_ref[:, None, None], ref.t, t)

        confidence = soft_inlier_counting_3d(X_best, Y_best, R, t, th=th_inlier)[..., 0]
        inlier_mask = inlier_counting_3d(X_best, Y_best, R, t, th=th_inlier)
    valid = (
        row_ok
        & torch.isfinite(R).flatten(1).all(-1)
        & torch.isfinite(t).flatten(1).all(-1)
        & (step_scores.amax(dim=0) > NEG_INF / 2)
    )
    R = torch.where(valid[:, None, None], R, torch.zeros_like(R))
    t = torch.where(valid[:, None, None], t, torch.zeros_like(t))
    confidence = torch.where(valid, confidence, torch.zeros_like(confidence))
    return PoseEstimate(
        R=R, t=t, confidence=confidence, valid=valid,
        cor0=_rows(kps0, idx0), cor1=_rows(kps1, idx1), d0=_rows(depth0, idx0), d1=_rows(depth1, idx1),
        weights=torch.gather(w_table, 1, outer_local[best_it, b_idx]), inlier_mask=inlier_mask,
    )


def estimate_pose(final_scores, kps0, depth0, kps1, depth1, K0, K1, *,
                  it_matches: int = 20, it_ransac: int = 100, num_samples: int = 2048,
                  num_corr: int = 3, num_refinements: int = 4, th_inlier: float = 0.15,
                  th_soft_inlier: float = 0.3, prefilter: int = 0,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Draws] = None) -> PoseEstimate:
    """Metric relative pose from dense (B, N0, N1) final scores.

    ``prefilter`` > 0 (and below N0 * N1) samples from the exact top-
    ``prefilter`` entries of each flat score matrix, sorted descending;
    otherwise the draws sample the whole flat matrix. ``draws`` injects the
    sample indices (positions in that table); otherwise they are drawn from
    ``generator``."""
    B, N0, N1 = final_scores.shape
    scores_flat = final_scores.reshape(B, N0 * N1).float()
    # validity of the sampling distribution: finite, nonnegative, positive mass
    row_ok = (torch.isfinite(scores_flat).all(-1) & (scores_flat >= 0).all(-1)
              & (scores_flat.sum(-1) > 0))
    if prefilter and prefilter < N0 * N1:
        w_table, remap = torch.topk(scores_flat, prefilter, dim=-1, sorted=True)
    else:
        w_table, remap = scores_flat, None
    if draws is None:
        draws = draw_samples(generator, w_table, it_matches, it_ransac, num_samples, num_corr)
    return _solve_sampled(
        w_table, remap, row_ok, kps0, depth0, kps1, depth1, K0, K1, draws,
        n1=N1, num_corr=num_corr, num_refinements=num_refinements,
        th_inlier=th_inlier, th_soft_inlier=th_soft_inlier,
    )


def estimate_pose_topk(top_scores, top_idx, row_ok, kps0, depth0, kps1, depth1, K0, K1, *,
                       n1: int, it_matches: int = 20, it_ransac: int = 100,
                       num_samples: int = 2048, num_corr: int = 3, num_refinements: int = 4,
                       th_inlier: float = 0.15, th_soft_inlier: float = 0.3,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Draws] = None) -> PoseEstimate:
    """Metric relative pose from the top-P (score, flat index) table.
    ``draws`` injects the sample indices; otherwise they are drawn from
    ``generator``."""
    if draws is None:
        draws = draw_samples(generator, top_scores, it_matches, it_ransac, num_samples, num_corr)
    return _solve_sampled(
        top_scores, top_idx, row_ok, kps0, depth0, kps1, depth1, K0, K1, draws,
        n1=n1, num_corr=num_corr, num_refinements=num_refinements,
        th_inlier=th_inlier, th_soft_inlier=th_soft_inlier,
    )


SAMPLING_MODES = ("exact", "approx")


def sampling_mode(cfg) -> str:
    """``TPU.SAMPLING`` of ``cfg``: "exact", or "approx", which draws the same
    samples here (module docstring). Any other value is refused, where the
    JAX package would take it as "exact"."""
    mode = str(cfg.TPU.get("SAMPLING", "exact"))
    if mode not in SAMPLING_MODES:
        raise ValueError(f"TPU.SAMPLING = {mode!r}: expected one of {SAMPLING_MODES}")
    return mode


def solver_kw(cfg) -> dict:
    """The PROCRUSTES.* solver settings of ``cfg`` as keyword arguments,
    after ``TPU.SAMPLING`` is read (``sampling_mode``: either mode draws
    exactly)."""
    sampling_mode(cfg)
    pc = cfg.PROCRUSTES
    return dict(it_matches=pc.IT_MATCHES, it_ransac=pc.IT_RANSAC, num_samples=pc.NUM_SAMPLED_MATCHES,
                num_corr=pc.NUM_CORR_3D_3D, num_refinements=pc.NUM_REFINEMENTS, th_inlier=pc.TH_INLIER,
                th_soft_inlier=pc.TH_SOFT_INLIER)


def estimate_pose_topk_from_cfg(tcorr, K0, K1, cfg, generator=None, draws=None) -> PoseEstimate:
    """``estimate_pose_topk`` with the PROCRUSTES.* settings of ``cfg``;
    ``tcorr`` is a ``nn.extractor.TopKCorrespondences``."""
    return estimate_pose_topk(
        tcorr.top_scores, tcorr.top_idx, tcorr.row_ok,
        tcorr.kps0, tcorr.depth0, tcorr.kps1, tcorr.depth1, K0, K1,
        n1=tcorr.kps1.shape[1], generator=generator, draws=draws, **solver_kw(cfg),
    )


def estimate_pose_from_cfg(corr, K0, K1, cfg, generator=None, draws=None, final_scores=None) -> PoseEstimate:
    """``estimate_pose`` with the PROCRUSTES.* settings and
    ``TPU.SAMPLING_PREFILTER`` of ``cfg``; ``corr`` is a
    ``nn.extractor.Correspondences``, and ``final_scores`` (default
    ``corr.final_scores``) the matrix sampled."""
    fs = corr.final_scores if final_scores is None else final_scores
    return estimate_pose(
        fs, corr.kps0, corr.depth0, corr.kps1, corr.depth1, K0, K1,
        prefilter=int(cfg.TPU.get("SAMPLING_PREFILTER", 0) or 0), generator=generator, draws=draws,
        **solver_kw(cfg),
    )


def extract_inliers(est: PoseEstimate, batch_index: int = 0) -> np.ndarray:
    """Host-side inlier list of one pair, sorted by score descending: rows
    [x0, y0, x1, y1, score, d0, d1]."""
    a = {f: getattr(est, f)[batch_index].detach().cpu().numpy()
         for f in ("inlier_mask", "cor0", "cor1", "d0", "d1", "weights")}
    m = a["inlier_mask"] == 1.0
    w = a["weights"][m]
    order = np.argsort(-w)
    return np.concatenate([a["cor0"][m][order], a["cor1"][m][order], w[order, None],
                           a["d0"][m][order], a["d1"][m][order]], axis=1)
