"""The comparison that decides ``correct`` for a served cell.

For a sample of the window's batches (drawn from the seed), the served path's
own outputs, kept as it made them, are held against the plain reference
(``mickey``) in five numbers, each the worst over the sample:

- ``feat_err`` (backbone): the query frames' tokens after the first
  backbone block against the reference's from the frames, per frame
  ||served - reference|| / ||reference||. A block's arithmetic one precision
  step down shows here before the later blocks' rounding hides it.
- ``maps_err`` (backbone and heads, the keyframe cache): for every query
  frame and every keyframe the batch used, the four head maps the served
  path matched on against the reference's maps of the same frame, computed
  from the frame itself: ||served - reference|| / ||reference|| per map.
- ``table_err`` (matcher): on the served maps, the fp64 dual-softmax final
  scores at the served table's positions against the served values
  (relative), and how far the smallest of them lies under the reference's
  own P-th candidate (relative): its selection.
- ``pose_err`` (solver, the returned answer): the solver replayed in fp64
  on the served table, its draws from the batch's generator: the kept
  draw's best hypothesis, then each refinement's weighted Procrustes on the
  served hard-inlier mask (where the 0.15 m threshold flips under rounding,
  the served side of it). The pose the program held at each inlier count
  and the returned pose (rotation from the returned quaternion) against the
  replay's at the same point, on the points that pose was fitted to (the
  hypothesis's three, then the last refinement's inliers): the root mean
  square of how far the served pose moves them from where the replay's
  puts them, over the draw's points' root-mean-square distance from the
  camera. A pose that fp32 leaves undetermined along a direction its
  points do not fix (a nearly collinear set) moves them little and reads
  little; a wrong rotation or translation moves them.
- ``solve_err`` (solver's decisions): the largest of how far the kept
  draw's best fp64 score lies under the best draw's (relative), the returned
  confidence against the fp64 soft-inlier count of the replayed pose
  (relative, at least 1), and how far from the threshold any served mask
  departs from the replay's own (distance over the threshold).

A pair the served path returns and the reference finds invalid, or the
reverse, reads infinity. The matcher and solver are followed step by step
from the served state (maps, then table, then masks): a continuous quantity
is compared from its inputs, a discrete one against the reference's
judgement of the served choice, so that ties broken by rounding do not read
as faults.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import mickey

INVALID = float("inf")
TIE = 1e-5  # hypotheses whose fp64 score lies this close to the best are the best's equals


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.clamp(torch.linalg.norm(b), min=1e-30))


def maps_err(served, ref) -> float:
    """Worst over frames and the four maps; ``served`` and ``ref`` are the
    four (n, H, W, .) maps of the same n frames."""
    worst = 0.0
    for s, r in zip(served, ref):
        for i in range(r.shape[0]):
            worst = max(worst, _rel(s[i], r[i]))
    return worst if all(torch.isfinite(s).all() for s in served) else INVALID


def feat_err(served: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst over frames of a block's output tokens (n, S, C), relative."""
    worst = max(_rel(served[i], ref[i]) for i in range(ref.shape[0]))
    return worst if math.isfinite(worst) else INVALID


def table_err(corr, dustbin: float, cfg) -> float:
    """``corr``: the served TopKCorrespondences-like record (kps0, depth0,
    kps1, depth1, top_scores, top_idx, row_ok) plus the maps it came from
    (``scr0``, ``scr1``, ``dsc0``, ``dsc1`` flattened)."""
    fm, tpu = cfg["FEATURE_MATCHER"]["DUAL_SOFTMAX"], cfg["TPU"]
    final = mickey.final_scores(corr["dsc0"], corr["dsc1"], corr["scr0"], corr["scr1"], dustbin,
                                float(fm["TEMPERATURE"]), bool(fm["USE_DUSTBIN"]), mickey.REF)
    ref_v, _, ref_ok = mickey.topk_table(final, int(tpu["SAMPLING_PREFILTER"]), int(tpu.get("MATCHER_TOPL", 16)))
    if not torch.equal(ref_ok.cpu(), corr["row_ok"].cpu()):
        return INVALID
    b = final.shape[0]
    at = torch.gather(final.reshape(b, -1), 1, corr["top_idx"].long())
    served = corr["top_scores"].double()
    scale = torch.clamp(at.abs(), min=1e-12 * float(ref_v.max()))
    value_err = float(((served - at).abs() / scale).max())
    floor = ref_v[:, -1]
    miss = float(torch.clamp((floor - at.amin(dim=1)) / torch.clamp(floor, min=1e-300), min=0.0).max())
    out = max(value_err, miss)
    return out if math.isfinite(out) else INVALID


def pose_gap(R, t, R_ref, t_ref, X, w, scale: float) -> float:
    """sqrt(sum_i w_i ||(R - R_ref) X_i + t - t_ref||^2 / sum_i w_i) / scale:
    how far (R, t) moves the points X (S, 3), weighted by w (S,), from where
    (R_ref, t_ref) puts them, over ``scale``. R (3, 3), t any 3 numbers."""
    X = X.double()
    R = torch.as_tensor(R).to(X).reshape(3, 3)
    t = torch.as_tensor(t if isinstance(t, torch.Tensor) else np.asarray(t, dtype=np.float64)).to(X).reshape(1, 3)
    moved = X @ (R - R_ref.to(X).reshape(3, 3)).T + (t - t_ref.to(X).reshape(1, 3))
    w = w.to(X)
    out = math.sqrt(float((w * (moved * moved).sum(-1)).sum() / torch.clamp(w.sum(), min=1e-30))) / max(scale, 1e-30)
    return out if math.isfinite(out) else INVALID


def mask_gap(X, Y, R, t, mask, th: float) -> float:
    """How far from the threshold, over it, the farthest point lies whose
    served hard-inlier decision differs from the fp64 one under (R, t)."""
    d = torch.sqrt(((mickey.transform(R, t, X, mickey.REF) - Y) ** 2).sum(dim=-1) + 1e-6)
    differ = (d <= th) != mask.to(d.device).bool()
    return float((d[differ] - th).abs().max()) / th if bool(differ.any()) else 0.0


def pose_check(corr, got, answers, K0, K1, generator, cfg) -> tuple:
    """(``pose_err``, ``solve_err``). ``got``: the batch's capture (the kept
    draw's ``weights``, and ``masks``: (R, t, mask) at each inlier count, the
    refinements' then the returned pose's); ``answers``: per pair, the
    returned (quaternion, t, confidence) or None where the served path
    returned no pose."""
    pc = cfg["PROCRUSTES"]
    prec = mickey.REF
    th, n_corr = float(pc["TH_INLIER"]), int(pc["NUM_CORR_3D_3D"])
    d = mickey.draw(generator, corr["top_scores"], pc["IT_MATCHES"], pc["IT_RANSAC"], pc["NUM_SAMPLED_MATCHES"],
                    n_corr)
    X, Y = mickey.sampled_points(d, corr["top_idx"], corr["kps0"], corr["depth0"], corr["kps1"], corr["depth1"],
                                 K0, K1, prec)
    Rh, th_, score = mickey.hypothesis_scores(X, Y, d, pc["TH_SOFT_INLIER"], prec)
    step = score.amax(dim=-1)  # (it, B)
    w = torch.gather(corr["top_scores"].float().expand(d.outer.shape[0], -1, -1), 2, d.outer)  # (it, B, S)
    masks = got["masks"]
    pose_worst, solve_worst = 0.0, 0.0
    for b, ans in enumerate(answers):
        valid = bool(corr["row_ok"][b]) and float(step[:, b].max()) > mickey.NEG_INF / 2
        if ans is None or not valid:
            if (ans is None) != (not valid):
                return INVALID, INVALID
            continue
        kept = [i for i in range(w.shape[0]) if torch.equal(w[i, b], got["weights"][b].float())]
        if not kept:
            return INVALID, INVALID
        i = kept[0]
        best = float(step[:, b].max())
        opt = (best - float(step[i, b])) / max(abs(best), 1e-12)
        Xb, Yb = X[i, b], Y[i, b]
        scale = float(torch.sqrt((Yb * Yb).sum(-1).mean()))
        # the program's first count holds its initial hypothesis: the kept draw's best, or one of its equals
        top = float(step[i, b])
        equals = torch.nonzero(score[i, b] >= top - TIE * max(abs(top), 1.0)).flatten().tolist()
        fits = []
        for r in equals:
            w_r = torch.zeros_like(Xb[:, 0])
            w_r[d.ridx[i, b, r]] = 1.0
            fits.append((pose_gap(masks[0][0][b], masks[0][1][b], Rh[i, b, r], th_[i, b, r], Xb, w_r, scale),
                         r, w_r))
        pose, r, fit = min(fits, key=lambda f: f[0])
        R, t = Rh[i, b, r], th_[i, b, r]
        n_pre, flips = float(n_corr), 0.0
        for k, (Rk, tk, mk) in enumerate(masks):
            pose = max(pose, pose_gap(Rk[b], tk[b], R, t, Xb, fit, scale))
            flips = max(flips, mask_gap(Xb, Yb, R, t, mk[b], th))
            n = float(mk[b].sum())
            if k < len(masks) - 1 and n >= n_corr and n > n_pre:  # the last count is the returned pose's
                n_pre, fit = n, mk[b].to(Xb.device, Xb.dtype)
                R, t, _ = mickey.kabsch(Xb, Yb, prec, w=fit)
        q, t_ans, conf = ans
        pose = max(pose, pose_gap(mickey.quat_to_rot(q), t_ans, R, t, Xb, fit, scale))
        ref_conf = float(mickey.soft_inliers(Xb, Yb, R, t, th, prec))
        cons = abs(float(conf) - ref_conf) / max(ref_conf, 1.0)
        pose_worst, solve_worst = max(pose_worst, pose), max(solve_worst, opt, cons, flips)
    return tuple(v if math.isfinite(v) else INVALID for v in (pose_worst, solve_worst))
