"""Metric pose loss: differentiable Procrustes RANSAC + REINFORCE surrogate
(``mickey_tpu/training/loss.py``, dense route).

One differentiable scalar whose gradient is the reference's two-phase
manual backward:

    total = avg_loss + sum_{b,i,s} stop_grad(mask_b (L_{b,i} - baseline_b) / it)
                               * log(final_scores[b, idx_{b,i,s}] + 1e-16)

``avg_loss`` carries the direct path through the grad-carrying weighted
Procrustes re-solve and the soft-inlier scores; the surrogate's gradient
with respect to final_scores is the REINFORCE coefficient per sampled index.

Sampling is Gumbel top-k driven by an explicit ``torch.Generator``, first
the outer draws of matches, then the inner minimal sets, from the same
generator. Tests inject both with ``sample_override=(idx, ridx)``.

One deviation from the JAX package: its two-stage prefilter takes the top
``prefilter`` entries with ``approx_max_k(recall_target=0.95)``; the port
takes the exact ``torch.topk``, whose recall is 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..geometry import inlier_counting_3d, soft_inlier_counting_3d, weighted_procrustes
from ..geometry.projection import backproject_3d
from ..ops.sampling import gumbel_topk_sample, gumbel_topk_sample_draws
from .loss_utils import compute_pose_loss, compute_vcre_loss

NEG_INF = -1e30


class LossConfig(NamedTuple):
    """Static loss hyperparameters (the reference's LOSS_CLASS schema)."""

    loss_function: str = "VCRE"  # 'VCRE' | 'POSE_ERR'
    soft_clipping: bool = True
    max_loss_null: float = 0.8
    score_temperature: float = 20.0
    it_matches: int = 20
    it_ransac: int = 20
    inlier_3d_th: float = 0.3
    inlier_ref_th: float = 0.15
    num_ref_steps: int = 4
    num_corr: int = 8
    num_samples_matches: int = 512
    add_null_hypothesis: bool = True
    th_outliers: float = 0.35
    train_with_topk: bool = True
    prefilter: int = 0  # top entries kept before the outer draws; 0 = all

    @classmethod
    def from_cfg(cls, cfg) -> "LossConfig":
        lc = cfg.LOSS_CLASS
        if lc.LOSS_FUNCTION == "POSE_ERR":
            max_null = lc.POSE_ERR.MAX_LOSS_SOFTVALUE if lc.SOFT_CLIPPING else lc.POSE_ERR.MAX_LOSS_VALUE
        else:
            max_null = lc.VCRE.MAX_LOSS_SOFTVALUE if lc.SOFT_CLIPPING else lc.VCRE.MAX_LOSS_VALUE
        gh = lc.GENERATE_HYPOTHESES
        return cls(
            loss_function=lc.LOSS_FUNCTION,
            soft_clipping=lc.SOFT_CLIPPING,
            max_loss_null=float(max_null),
            score_temperature=float(gh.SCORE_TEMPERATURE),
            it_matches=int(gh.IT_MATCHES),
            it_ransac=int(gh.IT_RANSAC),
            inlier_3d_th=float(gh.INLIER_3D_TH),
            inlier_ref_th=float(gh.INLIER_REF_TH),
            num_ref_steps=int(gh.NUM_REF_STEPS),
            num_corr=int(gh.NUM_CORR_3d3d),
            num_samples_matches=int(lc.SAMPLER.NUM_SAMPLES_MATCHES),
            add_null_hypothesis=bool(lc.NULL_HYPOTHESIS.ADD_NULL_HYPOTHESIS),
            th_outliers=float(lc.NULL_HYPOTHESIS.TH_OUTLIERS),
            train_with_topk=bool(lc.CURRICULUM_LEARNING.TRAIN_WITH_TOPK or lc.CURRICULUM_LEARNING.TRAIN_CURRICULUM),
            prefilter=int(cfg.get("TPU", {}).get("SAMPLING_PREFILTER", 0) or 0),
        )


def _log_weights(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w > 0, torch.log(torch.clamp(w, min=1e-30)), torch.full_like(w, NEG_INF))


def _take(idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """values (B, N, D) at indices (B, it, S) -> (B, it, S, D)."""
    B, it, S = idx.shape
    flat = idx.reshape(B, it * S, 1).expand(B, it * S, values.shape[-1])
    return torch.gather(values, 1, flat).reshape(B, it, S, values.shape[-1])


def _point_tables(kps0, depth0, K0, kps1, depth1, K1):
    """Backprojected 3D point tables of all N keypoints, head outputs made
    finite first: a non-finite row that is never sampled would otherwise leak
    NaN into the gather's backward (0 x inf)."""
    X_all = backproject_3d(torch.nan_to_num(kps0), torch.nan_to_num(depth0), K0)
    Y_all = backproject_3d(torch.nan_to_num(kps1), torch.nan_to_num(depth1), K1)
    return X_all, Y_all


def metric_pose_loss(
    final_scores: torch.Tensor,  # (B, N0, N1) grad-carrying sampling scores
    kps0: torch.Tensor,  # (B, N0, 2) grad-carrying
    depth0: torch.Tensor,  # (B, N0, 1)
    kps1: torch.Tensor,
    depth1: torch.Tensor,
    K0: torch.Tensor,
    K1: torch.Tensor,
    K0ori: torch.Tensor,
    K1ori: torch.Tensor,
    Rgt: torch.Tensor,  # (B, 3, 3)
    tgt: torch.Tensor,  # (B, 1, 3)
    lc: LossConfig,
    topk_pct: float,  # curriculum percentage
    generator: Optional[torch.Generator] = None,
    sample_override: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
):
    """Returns (total_loss, aux); autograd of total gives the reference's
    gradients. ``sample_override``: (idx (B, it, S) flat indices into the
    N0 x N1 matrix, ridx (B, it, R_it, C) or None)."""
    B, N0, N1 = final_scores.shape
    it, S = lc.it_matches, lc.num_samples_matches

    fs_flat = final_scores.reshape(B, N0 * N1)
    matches = fs_flat.detach()
    # per-element guard on the sampling distribution
    row_ok = torch.isfinite(matches).all(-1) & (matches >= 0).all(-1) & (matches.sum(-1) > 0)

    if sample_override is not None:
        idx, ridx = sample_override
    else:
        if lc.prefilter and lc.prefilter < N0 * N1:
            top_scores, remap = torch.topk(matches, lc.prefilter, dim=-1)
            logw = _log_weights(top_scores)
        else:
            logw, remap = _log_weights(matches), None
        idx = gumbel_topk_sample_draws(generator, logw, S, it).permute(1, 0, 2)  # (B, it, S)
        if remap is not None:
            idx = torch.gather(remap, 1, idx.reshape(B, it * S).long()).reshape(B, it, S)
        ridx = None
    idx = idx.long()

    X_all, Y_all = _point_tables(kps0, depth0, K0, kps1, depth1, K1)
    X = _take(idx // N1, X_all)  # (B, it, S, 3)
    Y = _take(idx % N1, Y_all)
    weights = _take(idx, matches[..., None])[..., 0]  # (B, it, S), detached
    # log of the sampled final scores only: the same values and gradient as
    # gathering log(fs + 1e-16) of the whole matrix
    log_sampled = torch.log(torch.gather(fs_flat, 1, idx.reshape(B, it * S)) + 1e-16).reshape(B, it, S)

    total, aux = _hypotheses_loss_core(X, Y, weights, log_sampled, ridx, row_ok, Rgt, tgt, K0ori, K1ori,
                                       generator, lc, topk_pct)
    aux["sampled_idx"] = idx
    return total, aux


def _hypotheses_loss_core(X, Y, weights, log_sampled, ridx, row_ok, Rgt, tgt, K0ori, K1ori,
                          generator: Optional[torch.Generator], lc: LossConfig, topk_pct: float):
    """Hypothesis generation -> REINFORCE total (everything downstream of the
    outer draws)."""
    B, it, S = weights.shape
    R_it, C = lc.it_ransac, lc.num_corr

    if ridx is None:  # inner minimal sets, proportional to the sampled weights
        logw_in = _log_weights(weights)[:, :, None, :].expand(B, it, R_it, S)
        ridx = gumbel_topk_sample(generator, logw_in, C)
    minimal = F.one_hot(ridx.long(), S).to(torch.float32).sum(dim=-2)  # (B, it, R_it, S)

    # refinement without gradient
    with torch.no_grad():
        Xd, Yd = X.detach()[:, :, None], Y.detach()[:, :, None]  # (B, it, 1, S, 3)
        inliers = inliers_final = minimal
        inliers_pre = torch.full((B, it, R_it), float(C), dtype=torch.float32, device=X.device)
        inliers_ref = torch.zeros((B, it, R_it, S), dtype=torch.float32, device=X.device)
        do_ref = torch.ones((B, it, R_it), dtype=torch.bool, device=X.device)
        for _ in range(lc.num_ref_steps):
            sol = weighted_procrustes(Xd, Yd, w=inliers, use_weights=True, use_mask=True)
            counted = inlier_counting_3d(Xd, Yd, sol.R, sol.t, th=lc.inlier_ref_th)
            inliers_ref = torch.where(do_ref[..., None], counted, inliers_ref)
            do_ref = inliers_ref.sum(-1) > inliers_pre
            inliers_pre = torch.where(do_ref, inliers_ref.sum(-1), inliers_pre)
            inliers_final = torch.where(do_ref[..., None], inliers, inliers_final)
            inliers = torch.where(do_ref[..., None], inliers_ref, inliers)

    # grad-carrying re-solve with the final inlier sets, and its scores
    sol = weighted_procrustes(X[:, :, None], Y[:, :, None], w=inliers_final, use_weights=True, use_mask=True)
    R, t = sol.R, sol.t  # (B, it, R_it, 3, 3), (B, it, R_it, 1, 3)
    score_k = soft_inlier_counting_3d(X[:, :, None], Y[:, :, None], R, t, th=lc.inlier_3d_th)[..., 0]

    compute_loss = compute_pose_loss if lc.loss_function == "POSE_ERR" else compute_vcre_loss
    n = B * it * R_it

    def flat(a):
        return a.reshape((n,) + a.shape[3:])

    def tile(a):
        return a[:, None, None].expand((B, it, R_it) + a.shape[1:]).reshape((n,) + a.shape[1:])

    loss_value_k, loss_rot_k, loss_trans_k = (
        x.reshape(B, it, R_it)
        for x in compute_loss(flat(R), flat(t), tile(Rgt), tile(tgt), tile(K0ori), tile(K1ori),
                              soft_clipping=lc.soft_clipping)
    )

    w_soft = torch.softmax(score_k / lc.score_temperature, dim=-1)
    loss_rot = (loss_rot_k * w_soft).sum(-1)  # (B, it)
    loss_trans = (loss_trans_k * w_soft).sum(-1)
    if lc.add_null_hypothesis:
        score_aug = torch.cat([score_k, torch.full_like(score_k[..., :1], lc.th_outliers * S)], dim=-1)
        loss_aug = torch.cat([loss_value_k, torch.full_like(loss_value_k[..., :1], lc.max_loss_null)], dim=-1)
    else:
        score_aug, loss_aug = score_k, loss_value_k
    loss_value = (loss_aug * torch.softmax(score_aug / lc.score_temperature, dim=-1)).sum(-1)

    baseline = loss_value.sum(-1) / it  # (B,) grad-carrying
    losses_rot = loss_rot.sum(-1) / it
    losses_trans = loss_trans.sum(-1) / it

    # curriculum: only the pairs below the top-K% baseline threshold count
    baseline_d = baseline.detach()
    if lc.train_with_topk and B > 1 and float(topk_pct) < 100.0:
        sb = min(max(int(B * float(topk_pct) // 100), 1), B - 1)
        mask_topk = (baseline_d < torch.sort(baseline_d).values[sb]).to(torch.float32)
    else:
        mask_topk = torch.ones((B,), dtype=torch.float32, device=baseline.device)
    mask_topk = mask_topk * row_ok.to(torch.float32)

    avg_loss = (mask_topk * baseline).sum() / torch.clamp(mask_topk.sum(), min=1.0)
    coeff = (mask_topk[:, None] * (loss_value - baseline[:, None]) / it).detach()
    total = avg_loss + (coeff[..., None] * log_sampled).sum()

    aux = {
        "avg_loss": avg_loss.detach(),
        "avg_loss_rot": losses_rot.mean().detach(),
        "avg_loss_trans": losses_trans.mean().detach(),
        "baseline": baseline_d,
        "mask_topk": mask_topk,
        "num_valid": row_ok.sum(),
        "hyp_finite": torch.isfinite(R).all() & torch.isfinite(t).all(),
        "loss_value": loss_value.detach(),
    }
    return total, aux
