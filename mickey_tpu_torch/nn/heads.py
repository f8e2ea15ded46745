"""MicKey keypoint heads: score / offset / depth / descriptor
(``mickey_tpu/nn/heads.py``). Each head: 4 pre-activation BasicBlocks with
a linear-attention transformer before the last, then a 1x1 projection. NHWC
in and out; the convs run in fp32 (TF32 off, see ``models.builder``).

Every apply function returns (out, new_params): in train mode BatchNorm
normalizes with batch statistics and new_params holds the advanced running
stats, as the JAX package threads them; in eval mode new_params is the
input."""

from __future__ import annotations

import torch

from .common import batchnorm, conv2d, l2_normalize
from .linear_attention import self_attention_transformer


def basic_block_apply(p, x: torch.Tensor, relu: bool = True, train: bool = False):
    """out = [relu](bn2(conv2(relu(bn1(conv1(x))))) + shortcut(x))."""
    new_p = dict(p)
    shortcut = conv2d(p["shortcut"], x) if "shortcut" in p else x
    out = conv2d(p["conv1"], x)
    if "bn1" in p:
        out, new_p["bn1"] = batchnorm(p["bn1"], out, train=train)
    out = conv2d(p["conv2"], torch.relu(out))
    if "bn2" in p:
        out, new_p["bn2"] = batchnorm(p["bn2"], out, train=train)
    out = out + shortcut
    return (torch.relu(out) if relu else out), new_p


def _head_trunk(p, fmap: torch.Tensor, add_pos_enc: bool, last_relu: bool, train: bool):
    new_p = dict(p)
    x, new_p["resblock1"] = basic_block_apply(p["resblock1"], fmap, train=train)
    x, new_p["resblock2"] = basic_block_apply(p["resblock2"], x, train=train)
    x, new_p["resblock3"] = basic_block_apply(p["resblock3"], x, train=train)
    x = self_attention_transformer(p["att"], x, add_pos_enc=add_pos_enc)
    x, new_p["resblock4"] = basic_block_apply(p["resblock4"], x, relu=last_relu, train=train)
    return x, new_p


def remove_borders(score_map: torch.Tensor, borders: int) -> torch.Tensor:
    """Zero a ``borders``-cell frame of the (B, H, W, 1) map."""
    _, h, w, _ = score_map.shape
    row = torch.arange(h, device=score_map.device)
    col = torch.arange(w, device=score_map.device)
    keep = ((row >= borders) & (row < h - borders))[:, None] & ((col >= borders) & (col < w - borders))[None, :]
    return score_map * keep[None, :, :, None].to(score_map.dtype)


def det_head_apply(p, fmap, cfg, train: bool = False):
    """Score map (B, H, W, 1): image-wide tempered softmax (its mean shift
    carries no gradient, as in the JAX package), 3-cell border mask."""
    kp = cfg.MICKEY.KP_HEADS
    x, new_p = _head_trunk(p, fmap, kp.POS_ENCODING, True, train)
    scores = conv2d(p["out"], x)
    b = scores.shape[0]
    eps = 1e-16
    if kp.USE_SOFTMAX:
        mean = scores.detach().reshape(b, -1).mean(dim=-1) + eps
        exp_scores = torch.exp((scores - mean.reshape(b, 1, 1, 1)) / 100.0)
        exp_scores = remove_borders(exp_scores, 3)
        denom = exp_scores.reshape(b, -1).sum(dim=-1).reshape(b, 1, 1, 1)
        return exp_scores / (denom + eps), new_p
    return remove_borders(torch.sigmoid(scores), 3), new_p


def offset_head_apply(p, fmap, cfg, train: bool = False):
    """Sigmoid xy offset in [0, 1] patch units, (B, H, W, 2)."""
    x, new_p = _head_trunk(p, fmap, cfg.MICKEY.KP_HEADS.POS_ENCODING, True, train)
    return torch.sigmoid(conv2d(p["out"], x)), new_p


def depth_head_apply(p, fmap, cfg, train: bool = False):
    """Metric depth (B, H, W, 1)."""
    kp = cfg.MICKEY.KP_HEADS
    x, new_p = _head_trunk(p, fmap, kp.POS_ENCODING, True, train)
    depths = conv2d(p["out"], x)
    if kp.USE_DEPTHSIGMOID:
        depths = kp.MAX_DEPTH * torch.sigmoid(depths)
    return depths, new_p


def desc_head_apply(p, fmap, cfg, train: bool = False):
    """L2-normalized descriptors (B, H, W, LAST_DIM); last block without ReLU."""
    dh = cfg.MICKEY.DSC_HEAD
    x, new_p = _head_trunk(p, fmap, dh.POS_ENCODING, False, train)
    if dh.NORM_DSC:
        x = l2_normalize(x)
    return x, new_p
