"""The staged training step, its optimizer and the validation step
(``mickey_tpu/training/train_step.py``: ``make_staged_train_step``,
``make_val_step``, ``make_staged_val_step``).

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

Data parallelism (``parallel.py``): a step run inside
``parallel.global_batch`` on this rank's rows of the global batch takes
global BatchNorm statistics, loss reductions and draws, and sums the
gradients over the ranks before the optimizer, so every rank applies the
same update and ``grad_norm`` is the global gradient's. Validation inside it
takes the global loss metrics and draws; its per-pair outputs are this
rank's rows.

Tensor parallelism (``parallel.init_grid``): both steps take the model
group (``tp``), the counterpart of ``make_staged_train_step(cfg,
mesh=tp_mesh)`` and ``make_staged_val_step``; their backbone passes then run
the rank's shard of the backbone (``parallel.shard_backbone``), whose
partial sums the group adds, and every rank of the group gets the same
feature map. Everything after the backbone is replicated over the group.

Spans of ``tracing``, each with the step (``TrainState.step``) as its
request: ``train.backbone``, ``train.forward`` and ``train.backward``
(``loss_and_grads``; the backward timed on the device too),
``train.all_reduce`` (only in a data-parallel step) and ``train.optimizer``.

Validation (``ValStep``) runs the heads in eval mode (BatchNorm running
stats read, never moved), the loss metrics at topk 100, the dense solver
over the whole N0 x N1 matrix (prefilter 0, as the JAX package's validation
passes none) and the pose and VCRE errors. ``ValStep.backbone_fwd`` and
``ValStep.tail`` are the staged pieces (``make_staged_val_step``);
``ValStep.__call__`` is the plain step (``make_val_step``), built from the
same pieces: each side's B images run the backbone as one batch, the shape
the cached validation's extractions take, so that plain and cached
validation agree bitwise on the card as on the CPU. The feature map reaches
the tail in one dtype, bf16 under ``MICKEY.DINOV2.FLOAT16`` and fp32
otherwise, on both paths: the JAX package rounds it so on its cached path
only.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch

from .. import parallel, tracing
from ..metrics.pose_metrics import pose_error, vcre
from ..nn.extractor import backbone_features, compute_correspondences, compute_correspondences_topk_train
from ..solver.procrustes_ransac import estimate_pose, solver_kw
from ..weights import is_bn_stat, split_trainable, tree_leaves, tree_unflatten
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
                   generator: Optional[torch.Generator] = None, sample_override=None,
                   request: Optional[int] = None):
    """Stage 2's forward and backward on a precomputed feature map. Returns
    (total, aux, new_params, grads): ``grads`` is a tree of params' structure
    (zeros at BN stats). ``request``: the step its spans serve."""
    with tracing.span("train.forward", request=request):
        total, aux, new_params = train_loss(params, fmap, batch, cfg, lc, topk_pct, generator, sample_override)
    leaves = tree_leaves(params)
    wanted = [t for path, t in leaves if not is_bn_stat(path)]
    with tracing.span("train.backward", request=request, device=True), deterministic_backward():
        got = iter(torch.autograd.grad(total, wanted, allow_unused=True))
    flat = []
    for path, t in leaves:
        g = None if is_bn_stat(path) else next(got)
        flat.append(torch.zeros_like(t) if g is None else g)
    return total.detach(), aux, new_params, tree_unflatten(params, iter(flat))


@contextmanager
def deterministic_backward():
    """PyTorch's deterministic kernels for the span (``use_deterministic_algorithms``,
    warnings only). With the default CUDA kernels two equal steps gave
    gradients apart in the last bits on the card (the backward of gathers and
    indexing accumulates with atomic adds, and cuDNN may pick a convolution
    backward that does); in this mode a step repeats bit for bit, which
    resume and the feature cache's checks rely on. cuBLAS repeats its results
    on one stream, so its alert about the workspace setting
    (``CUBLAS_WORKSPACE_CONFIG``) is silenced. The mode would also fill every
    new allocation with NaN; that is turned off, since the backward reads no
    memory it has not written. The previous settings are restored on exit."""
    mode = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CuBLAS.*")
            yield
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
        torch.utils.deterministic.fill_uninitialized_memory = mode[2]


class StagedTrainStep:
    """``step(state, backbone, batch, generator, topk_pct)`` -> (state, metrics);
    ``grad_step`` takes a precomputed feature map instead of the backbone.
    ``tp``: the model group whose rank's shard ``backbone`` is, or None."""

    def __init__(self, cfg, tp: Optional[parallel.TensorParallel] = None):
        self.cfg = cfg
        self.tp = tp
        self.lc = LossConfig.from_cfg(cfg)
        self.optimizer = Optimizer(cfg)

    def backbone_fwd(self, backbone, image0, image1) -> torch.Tensor:
        with torch.no_grad():
            return backbone_features({"dinov2": backbone}, torch.cat([image0, image1], dim=0), self.cfg, self.tp)

    def grad_step(self, state: TrainState, fmap, batch, generator=None, topk_pct: float = 100.0,
                  sample_override=None):
        _, aux, fwd_params, grads = loss_and_grads(state.params, fmap, batch, self.cfg, self.lc, topk_pct,
                                                   generator, sample_override, request=state.step)
        flat = [g for path, g in tree_leaves(grads) if not is_bn_stat(path)]
        step = parallel.active()
        if step is not None:  # each rank's loss is its share of the global one: sum
            with tracing.span("train.all_reduce", request=state.step):
                step.dp.all_reduce_(flat)
        with tracing.span("train.optimizer", request=state.step):
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

    def __call__(self, state: TrainState, backbone, batch, generator=None, topk_pct: float = 100.0,
                 sample_override=None):
        with tracing.span("train.backbone", request=state.step):
            fmap = self.backbone_fwd(backbone, batch["image0"], batch["image1"])
        return self.grad_step(state, fmap, batch, generator, topk_pct, sample_override)


def val_fmap_dtype(cfg) -> torch.dtype:
    """The one dtype of validation's feature maps: bf16 under FLOAT16."""
    return torch.bfloat16 if cfg.MICKEY.DINOV2.get("FLOAT16", False) else torch.float32


def val_metrics_from_corr(corr, batch, cfg, lc: LossConfig, generator: Optional[torch.Generator] = None,
                          sample_override=None, draws=None) -> dict:
    """Validation's body on dense ``Correspondences``
    (``_val_metrics_from_corr``): the loss metrics at topk 100, the dense
    solver with prefilter 0, the pose errors and the VCRE at the dataset's
    DATASET.WIDTH x HEIGHT. The loss draws first, then the solver's, from
    ``generator``; ``sample_override`` and ``draws`` inject them. ``inliers``
    is the solver's confidence."""
    with torch.no_grad():
        Rgt, tgt = batch_pose(batch)
        fs = corr.final_scores
        _, aux = metric_pose_loss(fs, corr.kps0, corr.depth0, corr.kps1, corr.depth1, batch["K_color0"],
                                  batch["K_color1"], batch["Kori_color0"], batch["Kori_color1"], Rgt, tgt, lc,
                                  100.0, generator=generator, sample_override=sample_override)
        est = estimate_pose(fs, corr.kps0, corr.depth0, corr.kps1, corr.depth1, batch["K_color0"],
                            batch["K_color1"], prefilter=0, generator=generator, draws=draws, **solver_kw(cfg))
        perr = pose_error(est.R, est.t, batch["T_0to1"])
        repr_err = vcre(est.R, est.t, batch["T_0to1"], batch["Kori_color0"], H=cfg.DATASET.HEIGHT,
                        W=cfg.DATASET.WIDTH)
    return {
        "loss": aux["avg_loss"],
        "avg_loss_rot": aux["avg_loss_rot"],
        "avg_loss_trans": aux["avg_loss_trans"],
        "t_err_ang": perr["t_err_ang"],
        "t_err_euc": perr["t_err_euc"],
        "R_err": perr["R_err"],
        "vcre": repr_err,
        "inliers": est.confidence,
    }


class ValStep:
    """Validation (module docstring). ``backbone_fwd(backbone, images)`` ->
    (n, Hp, Wp, C) in ``val_fmap_dtype``; ``tail(trainable, fmap, batch, ...)``
    on a stacked (2B, Hp, Wp, C) map, image0 rows first;
    ``step(trainable, backbone, batch, ...)`` the plain step on images.
    ``tp`` as ``StagedTrainStep``'s."""

    def __init__(self, cfg, tp: Optional[parallel.TensorParallel] = None):
        self.cfg = cfg
        self.tp = tp
        self.lc = LossConfig.from_cfg(cfg)
        self.dtype = val_fmap_dtype(cfg)

    def backbone_fwd(self, backbone, images) -> torch.Tensor:
        with torch.no_grad():
            return backbone_features({"dinov2": backbone}, images, self.cfg, self.tp).to(self.dtype)

    def tail(self, trainable, fmap, batch, generator=None, sample_override=None, draws=None) -> dict:
        with torch.no_grad():
            corr, _ = compute_correspondences(trainable, None, None, self.cfg, train=False, fmap=fmap)
        return val_metrics_from_corr(corr, batch, self.cfg, self.lc, generator, sample_override, draws)

    def __call__(self, trainable, backbone, batch, generator=None, sample_override=None, draws=None) -> dict:
        fmap = torch.cat([self.backbone_fwd(backbone, batch["image0"]),
                          self.backbone_fwd(backbone, batch["image1"])], dim=0)
        return self.tail(trainable, fmap, batch, generator, sample_override, draws)
