"""Inference model: metric relative pose between two images
(``mickey_tpu/models/relative_pose.py::MickeyRelativePose``), on the fused
matcher -> top-K route.

Both serving layouts run through the same stages: extract (backbone + heads)
on the stacked images, the fused matcher on the stacked 2B head outputs,
then the solver. ``call_with_ref_feats`` takes the image0 side from a cached
``extract_feats`` result, so a scene's shared keyframe runs the backbone
once. Only ``lite=True`` exists so far: the full output (dense match
matrices for visualization) belongs to the dense route, not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..nn.extractor import (
    absolute_kpt_coordinates,
    backbone_features,
    heads_apply,
    topk_correspondences_from_heads,
)
from ..solver.procrustes_ransac import Draws, estimate_pose_topk_from_cfg


class RelativePoseOutput(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 1, 3)
    inliers: torch.Tensor  # (B,) confidence (soft inlier count)
    valid: torch.Tensor  # (B,)


class MickeyRelativePose:
    """Weights live in a nested dict of tensors on ``device``
    (``weights.params_to_torch``); build one with ``models.build_model``."""

    def __init__(self, cfg, params, device="cuda"):
        if not (cfg.TPU.get("FUSED_TOPK", False) and int(cfg.TPU.get("SAMPLING_PREFILTER", 0) or 0) > 0):
            raise NotImplementedError("only the fused matcher -> top-K route is ported")
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)

    @torch.inference_mode()
    def extract_feats(self, images: torch.Tensor):
        """(B, H, W, 3) images -> (kpts, depths, scores, descs) head maps, each
        (B, H/14, W/14, .); deterministic, so cacheable per frame."""
        return heads_apply(self.params, backbone_features(self.params, images, self.cfg), self.cfg)[0]

    @torch.inference_mode()
    def match_feats(self, feats0, feats1):
        """Fused matcher stage on two sides' ``extract_feats`` outputs."""
        kpts, depths, scores, descs = (torch.cat([a, b], dim=0) for a, b in zip(feats0, feats1))
        kpts = absolute_kpt_coordinates(kpts, self.cfg.MICKEY.DINOV2.DOWN_FACTOR)
        return topk_correspondences_from_heads(self.params, kpts, depths, scores, descs, self.cfg)

    @torch.inference_mode()
    def solve(self, tcorr, K0, K1, generator: Optional[torch.Generator] = None,
              draws: Optional[Draws] = None) -> RelativePoseOutput:
        if generator is None and draws is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        est = estimate_pose_topk_from_cfg(tcorr, K0, K1, self.cfg, generator=generator, draws=draws)
        return RelativePoseOutput(R=est.R, t=est.t, inliers=est.confidence, valid=est.valid)

    def __call__(self, image0, image1, K0, K1, generator: Optional[torch.Generator] = None,
                 lite: bool = True, draws: Optional[Draws] = None) -> RelativePoseOutput:
        """image0/1: (B, H, W, 3) NHWC, float in [0, 1] or uint8; K: (B, 3, 3).
        ``draws`` injects the solver's sample indices (tests)."""
        if not lite:
            raise NotImplementedError("the full (dense) output is not ported yet; use lite=True")
        b = image0.shape[0]
        feats = self.extract_feats(torch.cat([image0, image1], dim=0))
        tcorr = self.match_feats(tuple(f[:b] for f in feats), tuple(f[b:] for f in feats))
        return self.solve(tcorr, K0, K1, generator, draws)

    def call_with_ref_feats(self, ref_feats, image1, K0, K1, generator: Optional[torch.Generator] = None,
                            draws: Optional[Draws] = None) -> RelativePoseOutput:
        """Pose from cached image0-side ``extract_feats`` outputs (gathered
        per pair) and query images: only the queries run the backbone."""
        tcorr = self.match_feats(ref_feats, self.extract_feats(image1))
        return self.solve(tcorr, K0, K1, generator, draws)
