"""Descriptor matcher (``mickey_tpu/nn/matcher.py``): the dense dual-softmax
and the routing between it and the fused kernels.

``dual_softmax`` builds the (B, N0, N1) couplings in plain PyTorch: it is the
CPU route and the oracle of the kernels in ``ops.fused_matcher``.
``match_scores`` routes as the JAX package does: on the card the fused
forward (K4) at inference and the fused forward with its analytic backward
(K4 + K5) in training; on a CPU tensor the dense ``dual_softmax``.
"""

from __future__ import annotations

import torch

from ..ops.fused_matcher import fused_dual_softmax, fused_dual_softmax_vjp


def dual_softmax(dsc0: torch.Tensor, dsc1: torch.Tensor, dustbin, temperature: float = 0.1,
                 use_dustbin: bool = True) -> torch.Tensor:
    """(B, N0, C), (B, N1, C) -> (B, N0, N1): softmax over rows times softmax
    over columns of the correlation / T, with an optional dustbin row and
    column of constant logit ``dustbin`` (a float, or a tensor that carries
    its gradient), cropped."""
    scores = torch.einsum("bnc,bmc->bnm", dsc0.float(), dsc1.float()) / temperature
    if not use_dustbin:
        return torch.softmax(scores, dim=1) * torch.softmax(scores, dim=2)
    b, m, n = scores.shape
    alpha = torch.as_tensor(dustbin, device=scores.device).to(scores.dtype)
    couplings = torch.cat([torch.cat([scores, alpha.expand(b, m, 1)], dim=2), alpha.expand(b, 1, n + 1)], dim=1)
    couplings = torch.softmax(couplings, dim=1) * torch.softmax(couplings, dim=2)
    return couplings[:, :-1, :-1]


def match_scores(params, dsc0: torch.Tensor, dsc1: torch.Tensor, cfg, train: bool = False) -> torch.Tensor:
    """Match scores (B, N0, N1) for ``params`` = the matcher's parameters."""
    if cfg.FEATURE_MATCHER.TYPE != "DualSoftmax":
        raise NotImplementedError("the Sinkhorn matcher is not ported yet")
    fm = cfg.FEATURE_MATCHER.DUAL_SOFTMAX
    dustbin = params.get("dustbin_score", 0.0)
    kw = dict(temperature=float(fm.TEMPERATURE), use_dustbin=bool(fm.USE_DUSTBIN))
    if cfg.TPU.get("USE_PALLAS_MATCHER", True) and dsc0.device.type != "cpu":
        if not train:
            if cfg.TPU.get("MATCHER_BF16", False):
                raise NotImplementedError("the bf16-descriptor matcher is not ported yet")
            return fused_dual_softmax(dsc0, dsc1, dustbin, **kw)
        if cfg.TPU.get("USE_PALLAS_MATCHER_GRAD", True):
            return fused_dual_softmax_vjp(dsc0, dsc1, dustbin, **kw)
    return dual_softmax(dsc0, dsc1, dustbin, **kw)
