"""Backbone + heads, the fused matcher -> top-K stage of serving and the
dense correspondences of training (``mickey_tpu/nn/extractor.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.fused_matcher import fused_topk_scores
from .dinov2 import VIT_CONFIGS, vit_features_chw
from .heads import depth_head_apply, desc_head_apply, det_head_apply, offset_head_apply
from .matcher import match_scores


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 batches are scaled to [0, 1] on the device; float passes through."""
    if images.dtype == torch.uint8:
        return images.float() * (1.0 / 255.0)
    return images


def backbone_features(params, images: torch.Tensor, cfg) -> torch.Tensor:
    """Frozen DINOv2 feature map (B, H/df, W/df, C), fp32."""
    images = normalize_images(images)
    df = cfg.MICKEY.DINOV2.DOWN_FACTOR
    _, h, w, _ = images.shape
    if h % df or w % df:
        raise ValueError(f"image size {(h, w)} not divisible by {df}")
    variant = cfg.MICKEY.DINOV2.get("VARIANT", "vit_large")
    return vit_features_chw(params["dinov2"], images, VIT_CONFIGS[variant]["num_heads"],
                            patch_size=df, dtype=torch.bfloat16 if cfg.MICKEY.DINOV2.FLOAT16 else torch.float32)


def heads_apply(params, fmap: torch.Tensor, cfg, train: bool = False):
    """The four heads: ((kpts, depths, scores, descs), each (B, H, W, .),
    new_params), new_params carrying the heads' advanced BN stats in train
    mode."""
    new_params = dict(params)
    scores, new_params["det_head"] = det_head_apply(params["det_head"], fmap, cfg, train)
    kpts, new_params["det_offset"] = offset_head_apply(params["det_offset"], fmap, cfg, train)
    depths, new_params["depth_head"] = depth_head_apply(params["depth_head"], fmap, cfg, train)
    descs, new_params["dsc_head"] = desc_head_apply(params["dsc_head"], fmap, cfg, train)
    return (kpts, depths, scores, descs), new_params


def absolute_kpt_coordinates(kpts: torch.Tensor, down_factor: int) -> torch.Tensor:
    """(offset + cell grid) * down_factor -> absolute pixels, (B, H, W, 2) as (x, y)."""
    _, h, w, _ = kpts.shape
    gx = torch.arange(w, dtype=kpts.dtype, device=kpts.device)[None, None, :]
    gy = torch.arange(h, dtype=kpts.dtype, device=kpts.device)[None, :, None]
    return torch.stack([(kpts[..., 0] + gx) * down_factor, (kpts[..., 1] + gy) * down_factor], dim=-1)


def _flatten_maps(kpts, depths, scores, descs):
    b, h, w, _ = kpts.shape
    n = h * w
    return kpts.reshape(b, n, 2), depths.reshape(b, n, 1), scores.reshape(b, n, 1), descs.reshape(b, n, -1)


class TopKCorrespondences(NamedTuple):
    """What the solver needs from the fused matcher route."""

    kps0: torch.Tensor  # (B, N0, 2) absolute pixels
    depth0: torch.Tensor  # (B, N0, 1)
    kps1: torch.Tensor
    depth1: torch.Tensor
    top_scores: torch.Tensor  # (B, P) final scores, descending
    top_idx: torch.Tensor  # (B, P) int32 flat indices into the N0 x N1 matrix
    row_ok: torch.Tensor  # (B,) sampling-distribution validity


def topk_correspondences_from_heads(params, kpts, depths, scores, descs, cfg) -> TopKCorrespondences:
    """Fused matcher stage on stacked (2B) head outputs, first B rows the
    image0 side; ``kpts`` already in absolute pixels."""
    fm = cfg.FEATURE_MATCHER.DUAL_SOFTMAX
    b = kpts.shape[0] // 2
    (k0, k1), (d0, d1), (s0, s1), (c0, c1) = ((t[:b], t[b:]) for t in (kpts, depths, scores, descs))
    kps0, depth0, scr0, dsc0 = _flatten_maps(k0, d0, s0, c0)
    kps1, depth1, scr1, dsc1 = _flatten_maps(k1, d1, s1, c1)
    top_scores, top_idx, row_ok = fused_topk_scores(
        dsc0.contiguous(), dsc1.contiguous(), scr0[..., 0], scr1[..., 0],
        params["matcher"].get("dustbin_score", 0.0),
        int(cfg.TPU.SAMPLING_PREFILTER),
        temperature=float(fm.TEMPERATURE), use_dustbin=bool(fm.USE_DUSTBIN),
        row_topl=int(cfg.TPU.get("MATCHER_TOPL", 16)),
    )
    return TopKCorrespondences(kps0=kps0, depth0=depth0, kps1=kps1, depth1=depth1,
                               top_scores=top_scores, top_idx=top_idx, row_ok=row_ok)


class Correspondences(NamedTuple):
    """Flattened per-image features and the dense match matrices of the
    training route (``mickey_tpu.nn.extractor.Correspondences``)."""

    kps0: torch.Tensor  # (B, N0, 2) absolute pixels
    depth0: torch.Tensor  # (B, N0, 1)
    scr0: torch.Tensor  # (B, N0, 1)
    dsc0: torch.Tensor  # (B, N0, C)
    kps1: torch.Tensor
    depth1: torch.Tensor
    scr1: torch.Tensor
    dsc1: torch.Tensor
    scores: torch.Tensor  # (B, N0, N1) descriptor match scores
    kp_scores: torch.Tensor  # (B, N0, N1) keypoint-score outer product
    depth_map0: torch.Tensor  # (B, H, W, 1)
    depth_map1: torch.Tensor

    @property
    def final_scores(self) -> torch.Tensor:
        """scores * kp_scores, the sampling distribution."""
        return self.scores * self.kp_scores


def correspondences_from_heads(params, feats, cfg, train: bool = False) -> Correspondences:
    """The dense matcher on stacked (2B) head outputs (kpts in patch units),
    image0 rows first."""
    kpts, depths, scores, descs = feats
    b = kpts.shape[0] // 2
    kpts = absolute_kpt_coordinates(kpts, cfg.MICKEY.DINOV2.DOWN_FACTOR)
    (k0, k1), (d0, d1), (s0, s1), (c0, c1) = ((t[:b], t[b:]) for t in (kpts, depths, scores, descs))
    kps0, depth0, scr0, dsc0 = _flatten_maps(k0, d0, s0, c0)
    kps1, depth1, scr1, dsc1 = _flatten_maps(k1, d1, s1, c1)
    match = match_scores(params["matcher"], dsc0, dsc1, cfg, train=train)
    kp_scores = scr0 * scr1.transpose(1, 2)  # fp32 outer product
    return Correspondences(kps0=kps0, depth0=depth0, scr0=scr0, dsc0=dsc0, kps1=kps1, depth1=depth1,
                           scr1=scr1, dsc1=dsc1, scores=match, kp_scores=kp_scores,
                           depth_map0=d0, depth_map1=d1)


def compute_correspondences(params, image0, image1, cfg, train: bool = False, fmap=None):
    """Both images through backbone and heads as one stacked 2B batch, then
    the dense matcher. Returns (Correspondences, new_params).

    ``fmap``: an optional precomputed (2B, H/df, W/df, C) backbone feature map,
    image0 rows first; the images are then unused and may be None. The
    backbone is frozen: it runs without autograd either way. In train mode
    BatchNorm takes its statistics over the stacked 2B maps, as in the JAX
    package."""
    if fmap is None:
        with torch.no_grad():
            fmap = backbone_features(params, torch.cat([image0, image1], dim=0), cfg)
    feats, new_params = heads_apply(params, fmap.float(), cfg, train)
    return correspondences_from_heads(params, feats, cfg, train), new_params
