"""Descriptor matchers (``mickey_tpu/nn/matcher.py``): the dense dual-softmax,
Sinkhorn, the routing between them and the fused kernels, and mutual
nearest-neighbour match lists for visualization.

``dual_softmax`` builds the (B, N0, N1) couplings in plain PyTorch: it is the
CPU route and the oracle of the kernels in ``ops.fused_matcher``.
``match_scores`` routes as the JAX package does: the DualSoftmax matcher on
the card takes the fused forward (K4) at inference and the fused forward
with its analytic backward (K4 + K5) in training, and on a CPU tensor the
dense ``dual_softmax``; every other matcher type takes ``sinkhorn`` on every
device. Sinkhorn has no Pallas kernel in the JAX package, so it is plain
PyTorch here. Under ``TPU.MATCHER_BF16`` the inference route rounds the
descriptors to bf16 first (the fused forward's bf16 mode on the card, the
dense ``dual_softmax`` of the rounded values in fp32 on the CPU: the JAX
kernel's arithmetic); training ignores the knob, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.fused_matcher import fused_dual_softmax, fused_dual_softmax_vjp


def _augment(scores: torch.Tensor, dustbin) -> torch.Tensor:
    """(B, M, N) -> (B, M+1, N+1) with a dustbin row and column of constant
    logit ``dustbin`` (a float, or a tensor that carries its gradient)."""
    b, m, n = scores.shape
    alpha = torch.as_tensor(dustbin, device=scores.device).to(scores.dtype)
    return torch.cat([torch.cat([scores, alpha.expand(b, m, 1)], dim=2), alpha.expand(b, 1, n + 1)], dim=1)


def dual_softmax(dsc0: torch.Tensor, dsc1: torch.Tensor, dustbin, temperature: float = 0.1,
                 use_dustbin: bool = True) -> torch.Tensor:
    """(B, N0, C), (B, N1, C) -> (B, N0, N1): softmax over rows times softmax
    over columns of the correlation / T, with an optional dustbin row and
    column of constant logit ``dustbin``, cropped."""
    scores = torch.einsum("bnc,bmc->bnm", dsc0.float(), dsc1.float()) / temperature
    if not use_dustbin:
        return torch.softmax(scores, dim=1) * torch.softmax(scores, dim=2)
    couplings = _augment(scores, dustbin)
    couplings = torch.softmax(couplings, dim=1) * torch.softmax(couplings, dim=2)
    return couplings[:, :-1, :-1]


def sinkhorn(dsc0: torch.Tensor, dsc1: torch.Tensor, dustbin, num_it: int) -> torch.Tensor:
    """SuperGlue-style log-domain optimal transport over the dustbin-augmented
    correlation / sqrt(C), ``num_it`` iterations; returns exp(Z) cropped to
    (B, N0, N1). The correlation is an fp32 product (TF32 off, as
    ``models.build_model`` pins it)."""
    d = dsc0.shape[-1]
    scores = torch.einsum("bnc,bmc->bnm", dsc0.float(), dsc1.float()) / (d**0.5)
    b, m, n = scores.shape
    couplings = _augment(scores, dustbin)
    norm = -math.log(m + n)
    log_mu = torch.cat([torch.full((m,), norm), torch.tensor([math.log(n) + norm])]).to(scores)
    log_nu = torch.cat([torch.full((n,), norm), torch.tensor([math.log(m) + norm])]).to(scores)
    log_mu, log_nu = log_mu.expand(b, m + 1), log_nu.expand(b, n + 1)
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(num_it):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    Z = couplings + u[:, :, None] + v[:, None, :] - norm
    return torch.exp(Z)[:, :-1, :-1]


def match_scores(params, dsc0: torch.Tensor, dsc1: torch.Tensor, cfg, train: bool = False) -> torch.Tensor:
    """Match scores (B, N0, N1) for ``params`` = the matcher's parameters."""
    if cfg.FEATURE_MATCHER.TYPE != "DualSoftmax":
        return sinkhorn(dsc0, dsc1, params["dustbin_score"], int(cfg.FEATURE_MATCHER.SINKHORN.NUM_IT))
    fm = cfg.FEATURE_MATCHER.DUAL_SOFTMAX
    dustbin = params.get("dustbin_score", 0.0)
    kw = dict(temperature=float(fm.TEMPERATURE), use_dustbin=bool(fm.USE_DUSTBIN))
    if cfg.TPU.get("USE_PALLAS_MATCHER", True):
        if not train:
            if cfg.TPU.get("MATCHER_BF16", False):
                dsc0, dsc1 = dsc0.to(torch.bfloat16), dsc1.to(torch.bfloat16)
            if dsc0.device.type != "cpu":
                return fused_dual_softmax(dsc0, dsc1, dustbin, **kw)
        elif cfg.TPU.get("USE_PALLAS_MATCHER_GRAD", True) and dsc0.device.type != "cpu":
            return fused_dual_softmax_vjp(dsc0, dsc1, dustbin, **kw)
    return dual_softmax(dsc0, dsc1, dustbin, **kw)


def get_matches_list(scores, min_conf: float = 0.0) -> np.ndarray:
    """Mutual-nearest-neighbour matches of one (N0, N1) score matrix, on the
    host: (M, 2) int rows (i, j) sorted by descending score. As the JAX
    package (and upstream), mutual NN is taken on ``scores[:-1, :-1]`` and
    thresholded on exp(score)."""
    s = scores.detach().cpu().numpy() if torch.is_tensor(scores) else np.asarray(scores)
    core = s[:-1, :-1]
    idx0 = core.argmax(axis=1)
    idx1 = core.argmax(axis=0)
    mutual = np.arange(core.shape[0]) == idx1[idx0]
    mscores = np.where(mutual, np.exp(core.max(axis=1)), 0.0)
    rows = np.nonzero(mutual & (mscores > min_conf))[0]
    matches = np.stack([rows, idx0[rows]], axis=1)
    return matches[np.argsort(-s[rows, idx0[rows]])]


def mutual_matches_device(final_scores: torch.Tensor, k: int = 60):
    """Mutual-nearest-neighbour matches of one (N0, N1) score matrix on its
    device, the top ``k`` by score: (rows, cols, scores) each (k,), rows and
    cols -1 and scores 0 where fewer than k mutual matches exist. The last
    row and column are cropped, as in ``get_matches_list``."""
    core = final_scores[:-1, :-1]
    idx0 = core.argmax(dim=1)
    idx1 = core.argmax(dim=0)
    mutual = torch.arange(core.shape[0], device=core.device) == idx1[idx0]
    score = torch.where(mutual, core.amax(dim=1), torch.full_like(core[:, 0], -math.inf))
    top_s, top_r = torch.topk(score, k)
    valid = torch.isfinite(top_s)
    rows = torch.where(valid, top_r, -1)
    cols = torch.where(valid, idx0[top_r], -1)
    return rows, cols, torch.where(valid, top_s, torch.zeros_like(top_s))
