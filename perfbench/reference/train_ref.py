"""Plain PyTorch reference of MicKey's training step on the dense matcher
route: the heads in training mode (BatchNorm on the batch), the dual
softmax, the metric pose loss (Procrustes RANSAC with refinement, the VCRE
loss, a null hypothesis, the curriculum's top-K% mask and the REINFORCE
surrogate of the sampled matches), autograd, then the optimizer
(``clip_by_global_norm`` then Adam with bias correction, ``eps`` outside the
square root, a step skipped whole on a non-finite gradient).

The heads run in fp32 with TF32 off, as the configuration states; the
matcher and the loss in fp64. It imports nothing of the program.

The loss's draws are the served path's: replayed from the step's generator
state on the final scores the program sampled from (the table is the top
``prefilter`` of them, then ``IT_MATCHES`` Gumbel top-k draws of
``NUM_SAMPLES_MATCHES`` entries, then ``IT_RANSAC`` minimal sets of
``NUM_CORR_3d3d`` within each), so both sides score the same samples; the
reference's own final scores, points and weights carry the gradient.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import mickey

NEG_INF = -1e30


def leaves(tree, path=()):
    """[(path, tensor)] of a nested dict / list, BatchNorm running stats
    (``mean``, ``var``) left out: the optimizer never moves them."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    if tree is None or path[-1] in ("mean", "var"):
        return []
    return [(path, tree)]


def _loss_log_weights(w):
    return torch.where(w > 0, torch.log(torch.clamp(w, min=1e-30)), torch.full_like(w, NEG_INF))


def _gumbel(generator, shape, device):
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def loss_draws(generator, final: torch.Tensor, lc: dict):
    """The loss's samples from the (B, N0, N1) fp32 final scores: (flat
    indices (B, it, S), minimal sets (B, it, R, C) as positions among S)."""
    b = final.shape[0]
    it, S, R, C = lc["IT_MATCHES"], lc["NUM_SAMPLES_MATCHES"], lc["IT_RANSAC"], lc["NUM_CORR_3d3d"]
    matches = final.reshape(b, -1).float()
    if lc["prefilter"] and lc["prefilter"] < matches.shape[1]:
        top, remap = torch.topk(matches, lc["prefilter"], dim=-1)
    else:
        top, remap = matches, None
    logw = _loss_log_weights(top)
    g = logw.expand((it,) + logw.shape) + _gumbel(generator, (it,) + tuple(logw.shape), final.device)
    if it * logw.numel() > 1 << 26:
        raise NotImplementedError("the drawing one at a time of very large tables")
    if 4 * S >= g.shape[-1]:
        pos = torch.sort(g, dim=-1, descending=True, stable=True).indices[..., :S]
    else:
        pos = torch.topk(g, S, dim=-1).indices
    pos = pos.permute(1, 0, 2)  # (B, it, S)
    idx = pos if remap is None else torch.gather(remap, 1, pos.reshape(b, it * S)).reshape(b, it, S)
    w = torch.gather(matches, 1, idx.reshape(b, it * S)).reshape(b, it, S)
    h = _loss_log_weights(w)[:, :, None, :].expand(b, it, R, S) + _gumbel(generator, (b, it, R, S), final.device)
    ridx = []
    for _ in range(C):
        i = h.argmax(dim=-1, keepdim=True)
        ridx.append(i)
        h = h.scatter(-1, i, float("-inf"))
    return idx, torch.cat(ridx, dim=-1)


def _eye_grid(device, dtype=torch.float64) -> torch.Tensor:
    """The VCRE's 7 x 4 x 7 grid of points in front of the camera (0.3 m
    apart, from 1.8 m; Map-free's ``reprojection.py``)."""
    step = 0.3
    xs = (np.arange(7) - 3.0) * step
    ys = (np.arange(4) - 1.5) * step
    zs = np.arange(7) * step + 1.8
    xx, yy, zz = np.meshgrid(xs, ys, zs)
    return torch.tensor(np.stack([xx.ravel(), yy.ravel(), zz.ravel()], -1), dtype=dtype, device=device)


def _project(xyz, K):
    cam = torch.einsum("...ij,...nj->...ni", K, xyz)
    return cam[..., :2] / (cam[..., 2:3] + 1e-16)


def _vcre_dir(R, t, Rgt, tgt, K, eye, H: float = 720.0):
    e = eye[None].expand(R.shape[0], -1, -1)
    uv_gt = torch.clamp(_project(e, K), 0.0, H)
    moved = torch.einsum("bij,bnj->bni", R, e) + t
    resid = torch.einsum("bji,bnj->bni", Rgt, moved) - torch.einsum("bji,bnj->bni", Rgt, tgt)
    uv = torch.clamp(_project(resid, K), 0.0, H)
    return torch.sqrt(((uv_gt - uv) ** 2).sum(-1) + 1e-6).mean(-1)


def vcre_loss(R, t, Rgt, tgt, K0, K1):
    """Symmetric virtual-correspondence reprojection loss, tanh(x / 80),
    and the rotation error and L1 translation error beside it."""
    eye = _eye_grid(R.device, R.dtype)
    Ri = R.transpose(1, 2)
    ti = -torch.einsum("bij,bkj->bki", Ri, t)
    Rgi = Rgt.transpose(1, 2)
    tgi = -torch.einsum("bij,bkj->bki", Rgi, tgt)
    loss = torch.tanh((_vcre_dir(R, t, Rgt, tgt, K0, eye) + _vcre_dir(Ri, ti, Rgi, tgi, K1, eye)) / 2.0 / 80.0)
    tr = torch.einsum("bji,bjk->bik", R, Rgt).diagonal(dim1=-2, dim2=-1).sum(-1)
    rot = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -0.99999, 0.99999)).abs()
    return loss, rot, (t - tgt).abs().sum(-1)[..., 0]


def _well_posed(A, B, w) -> torch.Tensor:
    """Hypotheses whose weighted covariance has its singular values apart
    (each squared gap above 1% of the largest's square): their rotation is
    determined, so a side's rounding cannot turn it."""
    wn = (w / (w.abs().sum(-1, keepdim=True) + 1e-16))[..., None]
    a, b = A - (wn * A).sum(-2, keepdim=True), B - (wn * B).sum(-2, keepdim=True)
    s2 = torch.linalg.svdvals(a.transpose(-1, -2) @ (w[..., None] * b)) ** 2
    return ((s2[..., 0] - s2[..., 1]) > 1e-2 * s2[..., 0]) & ((s2[..., 1] - s2[..., 2]) > 1e-2 * s2[..., 0])


def metric_pose_loss(final, kps0, depth0, kps1, depth1, K0, K1, K0ori, K1ori, Rgt, tgt, draws, lc: dict,
                     topk_pct: float, prec=mickey.REF, masks=None):
    """The dense route's loss in ``prec.exact`` on the given draws: (total
    whose gradient is the step's, the reported average loss, the
    refinement's hard inlier masks, their gap). ``masks``: the served
    path's masks of the refinement's steps, taken in place of this side's
    own decisions (a point near the threshold, or off the axis of a nearly
    collinear set, whose rotation is ill-determined, falls either way under
    rounding); the gap is then the share of the live decisions of
    well-posed hypotheses, on points more than 1e-4 of the threshold from
    it, on which they differ from this side's."""
    dt = prec.exact
    b, n0, n1 = final.shape
    idx, ridx = draws
    it, S, R_it, C = idx.shape[1], idx.shape[2], ridx.shape[2], ridx.shape[3]
    fs = final.reshape(b, n0 * n1)
    matches = fs.detach()
    row_ok = torch.isfinite(matches).all(-1) & (matches >= 0).all(-1) & (matches.sum(-1) > 0)
    X_all = mickey.backproject(torch.nan_to_num(kps0), torch.nan_to_num(depth0), K0, prec)
    Y_all = mickey.backproject(torch.nan_to_num(kps1), torch.nan_to_num(depth1), K1, prec)
    take = lambda v, i: torch.gather(v, 1, i.reshape(b, -1, 1).expand(b, it * S, 3)).reshape(b, it, S, 3)  # noqa
    X, Y = take(X_all, idx // n1), take(Y_all, idx % n1)
    log_sampled = torch.log(torch.gather(fs, 1, idx.reshape(b, it * S)) + 1e-16).reshape(b, it, S)

    minimal = F.one_hot(ridx, S).to(dt).sum(dim=-2)  # (B, it, R, S)
    with torch.no_grad():
        Xd, Yd = X.detach()[:, :, None], Y.detach()[:, :, None]
        inliers = final_set = minimal
        pre = torch.full((b, it, R_it), float(C), dtype=dt, device=X.device)
        ref = torch.zeros_like(minimal)
        do = torch.ones((b, it, R_it), dtype=torch.bool, device=X.device)
        used, differ, live = [], 0, 0
        for step in range(lc["NUM_REF_STEPS"]):
            Rr, tr_, _ = mickey.kabsch(Xd, Yd, prec, w=inliers)
            counted = mickey.hard_inliers(Xd, Yd, Rr, tr_, lc["INLIER_REF_TH"], prec)
            if masks is not None:
                served = masks[step].to(counted)
                th = lc["INLIER_REF_TH"]
                d = torch.sqrt(((mickey.transform(Rr, tr_, Xd, prec) - Yd) ** 2).sum(-1) + 1e-6)
                on = (do & _well_posed(Xd, Yd, inliers))[..., None] & ((d - th).abs() > 1e-4 * th)
                differ += int(((served != counted) & on).sum())
                live += int(on.sum())
                counted = served
            used.append(counted)
            ref = torch.where(do[..., None], counted, ref)
            do = ref.sum(-1) > pre
            pre = torch.where(do, ref.sum(-1), pre)
            final_set = torch.where(do[..., None], inliers, final_set)
            inliers = torch.where(do[..., None], ref, inliers)
    Rh, th, _ = mickey.kabsch(X[:, :, None], Y[:, :, None], prec, w=final_set)
    score = mickey.soft_inliers(X[:, :, None], Y[:, :, None], Rh, th, lc["INLIER_3D_TH"], prec)  # (B, it, R)

    n = b * it * R_it
    tile = lambda a: a[:, None, None].expand((b, it, R_it) + a.shape[1:]).reshape((n,) + a.shape[1:])  # noqa
    loss_k, rot_k, trans_k = (x.reshape(b, it, R_it) for x in vcre_loss(
        Rh.reshape(n, 3, 3), th.reshape(n, 1, 3), tile(Rgt.to(dt)), tile(tgt.to(dt)), tile(K0ori.to(dt)),
        tile(K1ori.to(dt))))
    w_soft = torch.softmax(score / lc["SCORE_TEMPERATURE"], dim=-1)
    rot = (rot_k * w_soft).sum(-1)
    trans = (trans_k * w_soft).sum(-1)
    if lc["ADD_NULL_HYPOTHESIS"]:
        score = torch.cat([score, torch.full_like(score[..., :1], lc["TH_OUTLIERS"] * S)], dim=-1)
        loss_k = torch.cat([loss_k, torch.full_like(loss_k[..., :1], lc["max_loss_null"])], dim=-1)
    loss_value = (loss_k * torch.softmax(score / lc["SCORE_TEMPERATURE"], dim=-1)).sum(-1)  # (B, it)
    baseline = loss_value.sum(-1) / it

    base = baseline.detach()
    if lc["train_with_topk"] and b > 1 and float(topk_pct) < 100.0:
        sb = min(max(int(b * float(topk_pct) // 100), 1), b - 1)
        mask = (base < torch.sort(base).values[sb]).to(dt)
    else:
        mask = torch.ones_like(base)
    mask = mask * row_ok.to(dt)
    share = (mask * baseline).sum()
    denom = torch.clamp(mask.sum(), min=1.0)
    coeff = (mask[:, None] * (loss_value - baseline[:, None]) / it).detach()
    total = share / denom + (coeff[..., None] * log_sampled).sum()
    return total, float(share.detach() / denom), used, differ / max(live, 1)


def loss_config(cfg) -> dict:
    lc = cfg["LOSS_CLASS"]
    gh = lc["GENERATE_HYPOTHESES"]
    clip = lc["VCRE"] if lc["LOSS_FUNCTION"] != "POSE_ERR" else lc["POSE_ERR"]
    if lc["LOSS_FUNCTION"] != "VCRE":
        raise NotImplementedError("the reference's training loss is the VCRE one")
    cl = lc["CURRICULUM_LEARNING"]
    return dict(gh, NUM_SAMPLES_MATCHES=lc["SAMPLER"]["NUM_SAMPLES_MATCHES"],
                ADD_NULL_HYPOTHESIS=lc["NULL_HYPOTHESIS"]["ADD_NULL_HYPOTHESIS"],
                TH_OUTLIERS=lc["NULL_HYPOTHESIS"]["TH_OUTLIERS"],
                max_loss_null=clip["MAX_LOSS_SOFTVALUE"] if lc["SOFT_CLIPPING"] else clip["MAX_LOSS_VALUE"],
                train_with_topk=bool(cl["TRAIN_WITH_TOPK"] or cl["TRAIN_CURRICULUM"]),
                prefilter=int(cfg["TPU"].get("SAMPLING_PREFILTER", 0) or 0))


def step_loss(params, fmap, batch, final_served, generator, cfg, topk_pct: float, prec=mickey.REF, masks=None):
    """One step's forward: (total, reported loss, the final scores drawn
    from, the refinement's masks, their gap to the served ones).
    ``final_served``: the (B, N0, N1) final scores the program drew its
    samples from, or None to draw from this forward's own; ``generator`` at
    the step's state; ``masks`` as ``metric_pose_loss``'s."""
    lc = loss_config(cfg)
    fm = cfg["FEATURE_MATCHER"]["DUAL_SOFTMAX"]
    df = cfg["MICKEY"]["DINOV2"]["DOWN_FACTOR"]
    offsets, depths, scores, descs = mickey.heads(params, fmap.float(), cfg, prec, train=True)
    b = fmap.shape[0] // 2
    kps = mickey.keypoints(offsets, df)
    flat = lambda t: t.reshape(2 * b, -1, t.shape[-1])  # noqa: E731
    depths, scores, descs = flat(depths), flat(scores), flat(descs)
    final = mickey.final_scores(descs[:b], descs[b:], scores[:b], scores[b:], params["matcher"]["dustbin_score"],
                                float(fm["TEMPERATURE"]), bool(fm["USE_DUSTBIN"]), prec)
    drawn = final.detach().float() if final_served is None else final_served
    draws = loss_draws(generator, drawn, lc)
    T = batch["T_0to1"].to(prec.exact)
    total, loss, used, gap = metric_pose_loss(final, kps[:b], depths[:b], kps[b:], depths[b:], batch["K_color0"],
                                              batch["K_color1"], batch["Kori_color0"], batch["Kori_color1"],
                                              T[:, :3, :3], T[:, :3, 3][:, None, :], draws, lc, topk_pct, prec, masks)
    return total, loss, drawn, used, gap


class Adam:
    """``apply_if_finite(chain(clip_by_global_norm(clip), adam(lr, eps=1e-6)))``
    on a list of leaves, in place."""

    def __init__(self, leaves_, lr: float, clip: float, b1=0.9, b2=0.999, eps=1e-6):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in leaves_]
        self.nu = [torch.zeros_like(p) for p in leaves_]
        self.count = 0

    @torch.no_grad()
    def update(self, params, grads):
        gnorm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        if not math.isfinite(gnorm):
            return gnorm
        if self.clip and gnorm >= self.clip:
            grads = [g / gnorm * self.clip for g in grads]
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.add_(-self.lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps)))
        return gnorm
