"""Inference model: metric relative pose between two images
(``mickey_tpu/models/relative_pose.py::MickeyRelativePose``).

Every call runs the same stages: extract (backbone + heads) on the stacked
images, the matcher on the stacked 2B head outputs, then the solver. Two
matcher routes, chosen as the JAX package chooses them:

- the fused matcher -> top-K route (``TPU.FUSED_TOPK`` with a
  ``TPU.SAMPLING_PREFILTER``), for the lite output: the dense match matrix
  never exists;
- the dense route (``compute_correspondences`` in eval mode, then
  ``estimate_pose``), for the full output (``lite=False``, the default: the
  dense match matrices, depth and score maps and the best correspondence set
  with its inlier mask, as the demo draws them) and for every call when the
  fused route is off.

Each stage is a span of ``tracing``: ``model.extract`` (its children
``model.backbone`` and ``model.heads``, timed on the device too),
``model.match`` and ``model.estimate``.

``call_with_ref_feats`` takes the image0 side from a cached
``extract_feats`` result, so a scene's shared keyframe runs the backbone
once; it returns the lite output.

The ``sharded_*`` entries are the data-parallel counterparts
(``mickey_tpu``'s mesh entries, a ``parallel.DataParallel`` in place of the
mesh): every rank passes the same global batch (a multiple of the ranks),
runs its contiguous rows on its device and gets the global batch's outputs
back, all-gathered. Each rank's solver draws come from ``generator`` folded
with its rank (``DataParallel.fold``), so pairs of the same local index on
two ranks draw independently.

Under ``MICKEY.DINOV2.INT8`` the model quantizes its backbone's block
linears when it is built (``nn.quant.vit_quantize_int8``, idempotent), so
every entry above runs on the int8 tree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from .. import tracing
from ..nn.extractor import (
    Correspondences,
    TopKCorrespondences,
    absolute_kpt_coordinates,
    backbone_features,
    correspondences_from_heads,
    heads_apply,
    topk_correspondences_from_heads,
)
from ..nn.quant import vit_quantize_int8
from ..parallel import DataParallel
from ..solver.procrustes_ransac import Draws, PoseEstimate, estimate_pose_from_cfg, estimate_pose_topk_from_cfg


class RelativePoseOutput(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 1, 3)
    inliers: torch.Tensor  # (B,) confidence (soft inlier count)
    valid: torch.Tensor  # (B,)
    estimate: Optional[PoseEstimate] = None  # the full solver output; None on the lite output
    corr: Optional[Correspondences] = None  # the dense trunk outputs; None on the lite output


def use_fused_topk(cfg) -> bool:
    """Whether the lite output takes the fused matcher -> top-K route."""
    return bool(cfg.TPU.get("FUSED_TOPK", False)) and int(cfg.TPU.get("SAMPLING_PREFILTER", 0) or 0) > 0


class MickeyRelativePose:
    """Weights live in a nested dict of tensors on ``device``
    (``weights.params_to_torch``); build one with ``models.build_model``."""

    def __init__(self, cfg, params, device="cuda"):
        self.cfg = cfg
        self.params = params
        if cfg.MICKEY.DINOV2.get("INT8", False):
            self.params = dict(params, dinov2=vit_quantize_int8(params["dinov2"]))
        self.device = torch.device(device)

    @torch.inference_mode()
    def extract_feats(self, images: torch.Tensor):
        """(B, H, W, 3) images -> (kpts, depths, scores, descs) head maps, each
        (B, H/14, W/14, .); deterministic, so cacheable per frame."""
        with tracing.span("model.extract"):
            with tracing.span("model.backbone", device=True):
                fmap = backbone_features(self.params, images, self.cfg)
            with tracing.span("model.heads", device=True):
                return heads_apply(self.params, fmap, self.cfg)[0]

    @torch.inference_mode()
    def match_feats(self, feats0, feats1, fused: Optional[bool] = None):
        """Matcher stage on two sides' ``extract_feats`` outputs: the fused
        route's ``TopKCorrespondences`` (``fused``, by default where the config
        selects it), else the dense ``Correspondences``."""
        with tracing.span("model.match"):
            stacked = tuple(torch.cat([a, b], dim=0) for a, b in zip(feats0, feats1))
            if fused is None:
                fused = use_fused_topk(self.cfg)
            if fused:
                kpts = absolute_kpt_coordinates(stacked[0], self.cfg.MICKEY.DINOV2.DOWN_FACTOR)
                return topk_correspondences_from_heads(self.params, kpts, *stacked[1:], self.cfg)
            return correspondences_from_heads(self.params, stacked, self.cfg)

    @torch.inference_mode()
    def estimate(self, corr: Union[TopKCorrespondences, Correspondences], K0, K1,
                 generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None) -> PoseEstimate:
        """The solver on either matcher route's output."""
        if generator is None and draws is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        with tracing.span("model.estimate"):
            if isinstance(corr, TopKCorrespondences):
                return estimate_pose_topk_from_cfg(corr, K0, K1, self.cfg, generator=generator, draws=draws)
            return estimate_pose_from_cfg(corr, K0, K1, self.cfg, generator=generator, draws=draws)

    def solve(self, corr, K0, K1, generator: Optional[torch.Generator] = None,
              draws: Optional[Draws] = None) -> RelativePoseOutput:
        """``estimate`` as the lite output."""
        est = self.estimate(corr, K0, K1, generator, draws)
        return RelativePoseOutput(R=est.R, t=est.t, inliers=est.confidence, valid=est.valid)

    def __call__(self, image0, image1, K0, K1, generator: Optional[torch.Generator] = None,
                 lite: bool = False, draws: Optional[Draws] = None) -> RelativePoseOutput:
        """image0/1: (B, H, W, 3) NHWC, float in [0, 1] or uint8; K: (B, 3, 3).
        ``lite=False`` (the default) returns the full output on the dense
        route; ``lite=True`` only R, t, confidence and validity, on the fused
        route where the config selects it. ``draws`` injects the solver's
        sample indices (tests)."""
        b = image0.shape[0]
        feats = self.extract_feats(torch.cat([image0, image1], dim=0))
        corr = self.match_feats(tuple(f[:b] for f in feats), tuple(f[b:] for f in feats),
                                fused=lite and use_fused_topk(self.cfg))
        est = self.estimate(corr, K0, K1, generator, draws)
        out = RelativePoseOutput(R=est.R, t=est.t, inliers=est.confidence, valid=est.valid)
        return out if lite else out._replace(estimate=est, corr=corr)

    def call_with_ref_feats(self, ref_feats, image1, K0, K1, generator: Optional[torch.Generator] = None,
                            draws: Optional[Draws] = None) -> RelativePoseOutput:
        """Pose from cached image0-side ``extract_feats`` outputs (gathered
        per pair) and query images: only the queries run the backbone. The
        lite output, on either matcher route."""
        corr = self.match_feats(ref_feats, self.extract_feats(image1))
        return self.solve(corr, K0, K1, generator, draws)

    # -- data-parallel entries (module docstring) ----------------------------------------
    def _rows(self, dp: DataParallel, x: torch.Tensor) -> torch.Tensor:
        return dp.shard_rows(x).to(self.device)

    def _folded(self, dp: DataParallel, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is None:  # the plain entries' default stream, folded too
            generator = torch.Generator(device=self.device).manual_seed(0)
        return dp.fold(generator)

    def sharded_extract_feats(self, dp: DataParallel, images: torch.Tensor):
        """``extract_feats`` of the global batch, each rank extracting its rows."""
        return tuple(dp.all_gather_rows(f) for f in self.extract_feats(self._rows(dp, images)))

    def sharded_call_with_ref_feats(self, dp: DataParallel, ref_feats, image1, K0, K1,
                                    generator: Optional[torch.Generator] = None) -> RelativePoseOutput:
        """``call_with_ref_feats`` over the global batch: each rank its rows
        of the cached keyframe outputs and of the queries."""
        out = self.call_with_ref_feats(tuple(self._rows(dp, f) for f in ref_feats), self._rows(dp, image1),
                                       self._rows(dp, K0), self._rows(dp, K1), generator=self._folded(dp, generator))
        return RelativePoseOutput(*(dp.all_gather_rows(x) for x in out[:4]))

    def sharded_call(self, dp: DataParallel, image0, image1, K0, K1,
                     generator: Optional[torch.Generator] = None) -> RelativePoseOutput:
        """The lite output of the global batch, each rank solving its rows."""
        out = self(self._rows(dp, image0), self._rows(dp, image1), self._rows(dp, K0), self._rows(dp, K1),
                   generator=self._folded(dp, generator), lite=True)
        return RelativePoseOutput(*(dp.all_gather_rows(x) for x in out[:4]))
