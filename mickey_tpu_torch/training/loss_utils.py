"""Pose and VCRE loss primitives (``mickey_tpu/training/loss_utils.py``),
batched and differentiable, with the reference's quirks (``vcre_loss`` clips
both uv coordinates to [0, H])."""

from __future__ import annotations

import torch

from ..evaluation.reprojection import get_grid_multipleheight
from ..geometry.projection import project_2d

_EYE = get_grid_multipleheight()[:, :3]  # (196, 3)


def rot_angle_loss(R: torch.Tensor, Rgt: torch.Tensor):
    """L1 residual rotation angle in radians: (loss (B, 1), err (B,))."""
    residual = torch.einsum("bji,bjk->bik", R, Rgt)
    trace = residual.diagonal(dim1=-2, dim2=-1).sum(-1)
    err = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -0.99999, 0.99999))
    return err.abs()[:, None], err


def trans_l1_loss(t: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(B, 1): L1 over the translation vector."""
    return (t - tgt).abs().sum(dim=-1)


def compute_pose_loss(R, t, Rgt, tgt, K0=None, K1=None, soft_clipping: bool = True):
    """loss = [tanh-clipped] rot-angle + L1 trans: (loss, loss_rot, loss_trans), each (B, 1)."""
    loss_rot, _ = rot_angle_loss(R, Rgt)
    loss_trans = trans_l1_loss(t, tgt)
    if soft_clipping:
        loss = torch.tanh(loss_rot / 0.9) + torch.tanh(loss_trans / 0.9)
    else:
        loss = loss_rot + loss_trans
    return loss, loss_rot, loss_trans


def _vcre_one_direction(R, t, Rgt, tgt, K, H: float = 720.0) -> torch.Tensor:
    """Residual eye-grid reprojection error (B, 1), uv clipped to [0, H]."""
    B = R.shape[0]
    eye = torch.as_tensor(_EYE, dtype=torch.float32, device=R.device)[None].expand(B, *_EYE.shape)
    uv_gt = project_2d(eye, K)
    eye_tmp = torch.einsum("bij,bnj->bni", R, eye) + t
    eyes_residual = torch.einsum("bji,bnj->bni", Rgt, eye_tmp) - torch.einsum("bji,bnj->bni", Rgt, tgt)
    uv_pred = project_2d(eyes_residual, K)
    uv_gt = torch.clamp(uv_gt, 0.0, H)
    uv_pred = torch.clamp(uv_pred, 0.0, H)
    err = torch.sqrt(((uv_gt - uv_pred) ** 2).sum(dim=-1) + 1e-6)
    return err.mean(dim=-1, keepdim=True)


def compute_vcre_loss(R, t, Rgt, tgt, K0, K1, soft_clipping: bool = True):
    """Symmetric VCRE loss, both directions averaged, tanh(x/80) soft clip:
    (loss, loss_rot, loss_trans), each (B, 1)."""
    R_inv = R.transpose(1, 2)
    t_inv = -torch.einsum("bij,bkj->bki", R_inv, t)
    Rgt_inv = Rgt.transpose(1, 2)
    tgt_inv = -torch.einsum("bij,bkj->bki", Rgt_inv, tgt)
    loss = (_vcre_one_direction(R, t, Rgt, tgt, K0) + _vcre_one_direction(R_inv, t_inv, Rgt_inv, tgt_inv, K1)) / 2.0
    if soft_clipping:
        loss = torch.tanh(loss / 80.0)
    loss_rot, _ = rot_angle_loss(R, Rgt)
    return loss, loss_rot, trans_l1_loss(t, tgt)

