"""Batched weighted Procrustes (Kabsch) with a closed-form 3x3 SVD.

Port of ``mickey_tpu/geometry/kabsch.py``. The SVD is the same fixed
6-sweep one-sided Jacobi, sorting network, cross-product completion of U and
determinant fix, so the rank-validity bits and the orientation of R follow
the reference function rather than ``torch.linalg.svd``'s conventions.
Matrices are carried as lists of their three columns, each (..., 3).

``svd3x3`` is a ``torch.autograd.Function`` when its input needs a gradient
(the training loss re-solves Procrustes with gradient): the forward is the
Jacobi path unchanged, the backward the regularized closed-form SVD
differential of the JAX package's custom VJP, not autograd through the
Jacobi sweeps (explosive near rank-deficient inputs).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_JACOBI_SWEEPS = 6


def _jacobi_rotate(A, V, p: int, q: int):
    """Orthogonalize columns p, q of A (in the lists A, V of columns)."""
    ap, aq = A[p], A[q]
    alpha = (ap * ap).sum(-1)
    beta = (aq * aq).sum(-1)
    gamma = (ap * aq).sum(-1)
    # one predicate both skips near-orthogonal pairs and guards the division
    skip = gamma.abs() <= 1e-7 * torch.sqrt(alpha * beta) + 1e-30
    zeta = (beta - alpha) / (2.0 * torch.where(skip, 1.0, gamma))
    t = torch.where(zeta >= 0, 1.0, -1.0) / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
    c = torch.rsqrt(1.0 + t * t)
    s = c * t
    c = torch.where(skip, 1.0, c)[..., None]
    s = torch.where(skip, 0.0, s)[..., None]
    A[p], A[q] = c * ap - s * aq, s * ap + c * aq
    vp, vq = V[p], V[q]
    V[p], V[q] = c * vp - s * vq, s * vp + c * vq


def _orthogonal_unit(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to v (..., 3): cross with the least-aligned axis."""
    ax = v.abs()
    use_x = (ax[..., 0:1] <= ax[..., 1:2]) & (ax[..., 0:1] <= ax[..., 2:3])
    use_y = (~use_x) & (ax[..., 1:2] <= ax[..., 2:3])
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    e = torch.where(use_x, eye[0], torch.where(use_y, eye[1], eye[2]))
    w = torch.linalg.cross(v, e)
    return w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True), min=1e-20)


def _svd3x3_primal(H: torch.Tensor, eps: float = 1e-12):
    A = [H[..., :, j].float() for j in range(3)]
    eye = torch.eye(3, dtype=torch.float32, device=H.device)
    V = [eye[:, j].expand_as(A[0]) for j in range(3)]
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            _jacobi_rotate(A, V, p, q)
    S = [torch.sqrt((a * a).sum(-1)) for a in A]
    for i, j in ((0, 1), (0, 2), (1, 2)):  # sorting network, descending
        swap = S[i] < S[j]
        S[i], S[j] = torch.where(swap, S[j], S[i]), torch.where(swap, S[i], S[j])
        sw = swap[..., None]
        A[i], A[j] = torch.where(sw, A[j], A[i]), torch.where(sw, A[i], A[j])
        V[i], V[j] = torch.where(sw, V[j], V[i]), torch.where(sw, V[i], V[j])
    u0 = A[0] / torch.clamp(S[0][..., None], min=eps)
    u1 = A[1] / torch.clamp(S[1][..., None], min=eps)
    rank1 = S[1][..., None] <= eps * torch.clamp(S[0][..., None], min=1.0)
    u1 = torch.where(rank1, _orthogonal_unit(u0), u1)
    u2 = torch.linalg.cross(u0, u1)
    u2 = u2 / torch.clamp(torch.linalg.norm(u2, dim=-1, keepdim=True), min=eps)
    flip = (u2 * A[2]).sum(-1, keepdim=True) < 0.0
    V[2] = torch.where(flip, -V[2], V[2])
    U = torch.stack([u0, u1, u2], dim=-1)
    return U.to(H.dtype), torch.stack(S, dim=-1).to(H.dtype), torch.stack(V, dim=-1).to(H.dtype)


def svd3x3_vjp(U, S, V, gU, gS, gV) -> torch.Tensor:
    """dH for cotangents (gU, gS, gV) of H = U diag(S) V^T: Townsend's SVD
    differential with a regularized gap inverse, exact where singular values
    are apart and bounded where they (nearly) coincide. The absolute 1e-30
    floor keeps H = 0 (all sampled points coincident) from turning 0/0 into
    NaN."""
    U, S, V = U.float(), S.float(), V.float()
    s2 = S * S
    D = s2[..., None, :] - s2[..., :, None]  # D_ij = s_j^2 - s_i^2
    reg = (1e-5 * (s2[..., 0:1, None] + 1e-30)) ** 2 + 1e-30
    F = D / (D * D + reg)
    UtgU = U.transpose(-1, -2) @ gU.float()
    term = (F * (UtgU - UtgU.transpose(-1, -2))) * S[..., None, :]
    VtgV = V.transpose(-1, -2) @ gV.float()
    term = term + S[..., :, None] * (F * (VtgV - VtgV.transpose(-1, -2)))
    term = term + torch.diag_embed(gS.float())
    return (U @ term) @ V.transpose(-1, -2)


class _SVD3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H):
        U, S, V = _svd3x3_primal(H)
        ctx.save_for_backward(U, S, V)
        return U, S, V

    @staticmethod
    def backward(ctx, gU, gS, gV):
        U, S, V = ctx.saved_tensors
        return svd3x3_vjp(U, S, V, gU, gS, gV).to(U.dtype)


def svd3x3(H: torch.Tensor):
    """H (..., 3, 3) -> (U, S, V), H ~= U diag(S) V^T, S descending."""
    if torch.is_grad_enabled() and H.requires_grad:
        return _SVD3x3.apply(H)
    return _svd3x3_primal(H)


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def _outer_sum(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """H_ij = sum_n A_ni B_nj as broadcast multiply-adds."""
    return (A[..., :, :, None] * B[..., :, None, :]).sum(dim=-3)


class ProcrustesResult(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 1, 3)
    valid: torch.Tensor  # (...,) bool — rank-sufficient covariance


def weighted_procrustes(A, B, w: Optional[torch.Tensor] = None, use_weights: bool = True,
                        use_mask: bool = False, eps: float = 1e-16,
                        rank_tol: float = 1e-7) -> ProcrustesResult:
    """R, t with B ~= A R^T + t for point sets A, B (..., N, 3), weights w (..., N)."""
    if use_weights:
        w_norm = (w / (w.abs().sum(-1, keepdim=True) + eps))[..., None]
        a_mean = (w_norm * A).sum(-2, keepdim=True)
        b_mean = (w_norm * B).sum(-2, keepdim=True)
        cov_w = w[..., None] if use_mask else w_norm
        H = _outer_sum(A - a_mean, cov_w * (B - b_mean))
    else:
        a_mean = A.mean(-2, keepdim=True)
        b_mean = B.mean(-2, keepdim=True)
        H = _outer_sum(A - a_mean, B - b_mean)
    U, S, V = svd3x3(H)
    valid = S[..., 1] > rank_tol * torch.clamp(S[..., 0], min=1e-20)
    det_uv = _det3(U @ V.transpose(-1, -2))
    Vz = torch.cat([V[..., :, :2], V[..., :, 2:] * det_uv[..., None, None]], dim=-1)
    R = Vz @ U.transpose(-1, -2)
    t = b_mean - a_mean @ R.transpose(-1, -2)
    return ProcrustesResult(R=R, t=t, valid=valid)
