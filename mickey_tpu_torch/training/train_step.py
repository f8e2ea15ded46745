"""The staged training step and its optimizer
(``mickey_tpu/training/train_step.py::make_staged_train_step``).

Stage 1 runs the frozen backbone on the stacked 2B images without autograd.
Stage 2 runs the heads in train mode, the matcher and the loss, one backward
pass, then the optimizer, then copies the BatchNorm running stats of the
forward into the parameters. The matcher and loss take one of two routes:

- dense (default): the (B, M, N) match matrix (on the card K4 forward, K5
  backward) and ``metric_pose_loss``;
- fused top-K (``TPU.TRAIN_FUSED_TOPK``, see ``use_train_fused_topk``): the
  top-P table and the grad-carrying logsumexps (K2a + K2b forward, K6
  backward) and ``metric_pose_loss_topk``; no (B, M, N) tensor in either
  direction.

The optimizer has optax's semantics, not torch.optim's:
``apply_if_finite(chain(clip_by_global_norm(GRAD_CLIP), adam(lr, eps=1e-6)))``:

- clipping scales every gradient by GRAD_CLIP / ||g|| when ||g|| >= GRAD_CLIP
  (``torch.nn.utils.clip_grad_norm_`` divides by ||g|| + 1e-6 instead);
- Adam with bias correction and ``eps`` outside the square root;
- a gradient that is not finite skips the whole step: parameters, both
  moments and the step count stay as they were;
- the learning-rate schedule reads that count (applied steps), as
  ``optax.adam(schedule)`` does inside ``apply_if_finite``, so a skipped step
  does not advance the staircase.

``apply_if_finite(..., max_consecutive_errors=10000)`` has no counterpart:
optax applies an update after 10000 non-finite steps in a row, the port
never does.

The step updates the state in place (parameters and moments), where the JAX
package returns a new state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch

from ..nn.extractor import backbone_features, compute_correspondences, compute_correspondences_topk_train
from ..weights import is_bn_stat, split_trainable, tree_leaves
from .loss import LossConfig, metric_pose_loss, metric_pose_loss_topk


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar: applied steps
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclass
class TrainState:
    params: dict  # trainable tree: heads (with BN stats) + matcher
    opt_state: AdamState
    step: int = 0

    def trainable(self) -> List[torch.Tensor]:
        return [t for path, t in tree_leaves(self.params) if not is_bn_stat(path)]


def make_lr_fn(cfg):
    """step (an int, or an int tensor such as Adam's count) -> learning
    rate: constant, or StepLR-like staircase decay."""
    t = cfg.TRAINING
    if t.LR_STEP_INTERVAL:
        return lambda step: t.LR * float(t.LR_STEP_GAMMA) ** (step // int(t.LR_STEP_INTERVAL))
    return lambda step: t.LR


class Optimizer:
    """``optax.apply_if_finite(chain(clip_by_global_norm, adam))`` on a list
    of tensors (module docstring)."""

    def __init__(self, cfg, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6):
        self.lr_fn = make_lr_fn(cfg)
        self.clip = float(cfg.TRAINING.GRAD_CLIP or 0.0)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, leaves) -> AdamState:
        count = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
        return AdamState(count, [torch.zeros_like(p).detach() for p in leaves],
                         [torch.zeros_like(p).detach() for p in leaves])

    @torch.no_grad()
    def update(self, leaves, grads, state: AdamState) -> torch.Tensor:
        """Apply one step in place; returns the global grad norm. The
        learning rate is the schedule's at ``state.count`` before this step:
        the steps applied so far, skipped ones not counted."""
        gnorm = global_norm(grads)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if self.clip:
            trigger = gnorm < self.clip
            grads = [torch.where(trigger, g, (g / gnorm) * self.clip) for g in grads]
        lr = self.lr_fn(state.count)
        count = state.count + 1
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32, device=count.device) ** count.float()
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32, device=count.device) ** count.float()
        for p, g, m, v in zip(leaves, grads, state.mu, state.nu):
            m_new = (1 - self.b1) * g + self.b1 * m
            v_new = (1 - self.b2) * (g * g) + self.b2 * v
            u = -lr * ((m_new / c1) / (torch.sqrt(v_new / c2) + self.eps))
            p.copy_(torch.where(finite, p + u, p))
            m.copy_(torch.where(finite, m_new, m))
            v.copy_(torch.where(finite, v_new, v))
        state.count.copy_(torch.where(finite, count, state.count))
        return gnorm


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def init_train_state(cfg, params):
    """The port's params (``weights.params_to_torch``) -> (TrainState over the
    trainables, frozen backbone)."""
    trainable, backbone = split_trainable(params)
    leaves = [t for path, t in tree_leaves(trainable) if not is_bn_stat(path)]
    return TrainState(trainable, Optimizer(cfg).init(leaves)), backbone


def copy_bn_stats(dst, src) -> None:
    """Overwrite dst's BN running stats with src's (forward-updated), in place."""
    for (path, d), (path_s, s) in zip(tree_leaves(dst), tree_leaves(src)):
        if path != path_s:
            raise ValueError(f"tree mismatch at {path} / {path_s}")
        if is_bn_stat(path):
            d.copy_(s)


def batch_pose(batch):
    """Rgt (B, 3, 3) and tgt (B, 1, 3) from the batch's T_0to1."""
    T = batch["T_0to1"]
    return T[:, :3, :3], T[:, :3, 3][:, None, :]


def use_train_fused_topk(cfg, lc: LossConfig) -> bool:
    """The fused top-K training route's gate: ``TPU.TRAIN_FUSED_TOPK``, a
    sampling prefilter (the table's size) and the DualSoftmax matcher."""
    return (bool(cfg.TPU.get("TRAIN_FUSED_TOPK", False)) and lc.prefilter > 0
            and cfg.FEATURE_MATCHER.TYPE == "DualSoftmax")


def train_loss(params, fmap, batch, cfg, lc: LossConfig, topk_pct: float,
               generator: Optional[torch.Generator] = None, sample_override=None):
    """Stage 2's forward on a precomputed feature map, on the route the config
    selects. Returns (total, aux, new_params); ``new_params`` carries the
    forward's BN stats."""
    Rgt, tgt = batch_pose(batch)
    Ks = (batch["K_color0"], batch["K_color1"], batch["Kori_color0"], batch["Kori_color1"])
    if use_train_fused_topk(cfg, lc):
        corr, new_params = compute_correspondences_topk_train(params, None, None, cfg, fmap=fmap)
        total, aux = metric_pose_loss_topk(
            (corr.top_scores, corr.top_idx, corr.row_ok, corr.lse_row, corr.lse_col),
            corr.dsc0, corr.dsc1, corr.scr0, corr.scr1, corr.kps0, corr.depth0, corr.kps1, corr.depth1,
            *Ks, Rgt, tgt, lc, topk_pct, temperature=float(cfg.FEATURE_MATCHER.DUAL_SOFTMAX.TEMPERATURE),
            generator=generator, sample_override=sample_override,
        )
    else:
        corr, new_params = compute_correspondences(params, None, None, cfg, train=True, fmap=fmap)
        total, aux = metric_pose_loss(
            corr.final_scores, corr.kps0, corr.depth0, corr.kps1, corr.depth1, *Ks,
            Rgt, tgt, lc, topk_pct, generator=generator, sample_override=sample_override,
        )
    return total, aux, new_params


def loss_and_grads(params, fmap, batch, cfg, lc: LossConfig, topk_pct: float,
                   generator: Optional[torch.Generator] = None, sample_override=None):
    """Stage 2's forward and backward on a precomputed feature map. Returns
    (total, aux, new_params, grads): ``grads`` is a tree of params' structure
    (zeros at BN stats)."""
    total, aux, new_params = train_loss(params, fmap, batch, cfg, lc, topk_pct, generator, sample_override)
    leaves = tree_leaves(params)
    wanted = [t for path, t in leaves if not is_bn_stat(path)]
    got = iter(torch.autograd.grad(total, wanted, allow_unused=True))
    flat = []
    for path, t in leaves:
        g = None if is_bn_stat(path) else next(got)
        flat.append(torch.zeros_like(t) if g is None else g)
    return total.detach(), aux, new_params, _unflatten(params, iter(flat))


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, it) for v in tree]
    return None if tree is None else next(it)


class StagedTrainStep:
    """``step(state, backbone, batch, generator, topk_pct)`` -> (state, metrics);
    ``grad_step`` takes a precomputed feature map instead of the backbone."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.lc = LossConfig.from_cfg(cfg)
        self.optimizer = Optimizer(cfg)

    def backbone_fwd(self, backbone, image0, image1) -> torch.Tensor:
        with torch.no_grad():
            return backbone_features({"dinov2": backbone}, torch.cat([image0, image1], dim=0), self.cfg)

    def grad_step(self, state: TrainState, fmap, batch, generator=None, topk_pct: float = 100.0,
                  sample_override=None):
        _, aux, fwd_params, grads = loss_and_grads(state.params, fmap, batch, self.cfg, self.lc, topk_pct,
                                                   generator, sample_override)
        flat = [g for path, g in tree_leaves(grads) if not is_bn_stat(path)]
        gnorm = self.optimizer.update(state.trainable(), flat, state.opt_state)
        with torch.no_grad():
            copy_bn_stats(state.params, fwd_params)
        state.step += 1
        metrics = {
            "loss": aux["avg_loss"],
            "loss_rot": aux["avg_loss_rot"],
            "loss_trans": aux["avg_loss_trans"],
            "grad_norm": gnorm,
            "grads_finite": torch.isfinite(gnorm),
            "num_valid": aux["num_valid"],
        }
        return state, metrics

    def __call__(self, state: TrainState, backbone, batch, generator=None, topk_pct: float = 100.0):
        fmap = self.backbone_fwd(backbone, batch["image0"], batch["image1"])
        return self.grad_step(state, fmap, batch, generator, topk_pct)
