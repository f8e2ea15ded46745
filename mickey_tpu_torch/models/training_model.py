"""Training orchestration (``mickey_tpu/models/training_model.py::MicKeyTrainer``).

An explicit loop in place of Lightning: the staged train step, the
curriculum (topk +5 an epoch up to TOPK), scalar and image logging every
LOG_INTERVAL steps (tensorboardX, optional: without it nothing is written),
a validation epoch with the keyframe cache, the precision and AUC
aggregation, native checkpoints (best VCRE AUC, best pose AUC, last) and
resume, and the frozen-backbone feature cache.

Data parallelism (``parallel.py``; ``mickey_tpu``'s data mesh): with a
process group of N ranks (``dp``, by default ``parallel.world()``) each rank
holds the same state (rank 0's, broadcast at construction), its loaders
read its rows of each padded global batch (``DataLoader.shard``), and its
steps run inside ``parallel.global_batch``: global BatchNorm statistics,
loss reductions and draws, gradients summed over the ranks. Validation
gathers the per-pair outputs before the aggregation, so every rank takes the
same checkpoint decision; rank 0 alone writes checkpoints, logs, image
panels and the feature cache (the others wait for it). ``TRAINING.BATCH_SIZE``
stays the global batch. With one rank nothing of this acts.

Tensor parallelism (``tp``, by default ``parallel.tensor_parallel()``;
``mickey_tpu``'s ``MicKeyTrainer(mesh=get_mesh_2d(tp))``): ``dp`` is then the
rank's data group and ``tp`` its model group of a ``parallel.init_grid``.
The whole backbone is broadcast from global rank 0 first (over the data
group, then the model group), its fingerprint taken for the feature cache,
then each rank keeps its shard (``parallel.shard_backbone``); the staged
train and validation steps and the image panels run the sharded backbone
over the model group. The loaders shard by the data rank and size: the
ranks of a model group read the same rows and take the same branches (a
rank-dependent branch around a backbone pass would leave its peers waiting
in the all-reduce). Checkpoints, logs and the printed lines come from
global rank 0 alone (data rank 0 and model rank 0); the feature cache is
built by rank 0's model group together and written by rank 0.

Every image batch is cropped on the host to multiples of the patch size
(``data/io.crop_to_patches``, from the bottom and the right, so the
intrinsics hold) before it reaches the backbone: in the train step, both
validation paths and the log panels, as ``build_feature_cache`` crops its
frames. The Map-free 540 x 720 frames train at 532 x 714; at every size
where the JAX package runs, the crop does nothing.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import parallel
from ..data.io import crop_to_patches
from ..evaluation.pose_io import precision_recall
from ..nn.dinov2 import VIT_CONFIGS
from ..training.checkpoint import (
    convert_dinov2_state_dict,
    load_torch_state_dict,
    resolve_dinov2_weights,
    restore_checkpoint,
    save_checkpoint,
)
from ..training.train_step import StagedTrainStep, ValStep, init_train_state, make_lr_fn
from ..weights import (
    init_params_numpy,
    is_bn_stat,
    params_to_numpy,
    params_to_torch,
    trainable_to_torch,
    tree_leaves,
    tree_unflatten,
)

BATCH_KEYS = ("image0", "image1", "T_0to1", "K_color0", "K_color1", "Kori_color0", "Kori_color1")
VAL_KEYFRAME_BOUND = 2048  # keyframes held by the validation cache: ~1 a scene


class MicKeyTrainer:
    """``params``: a ``mickey_tpu`` pytree with numpy leaves, or None for
    ``init_params_numpy(cfg, seed)`` with the frozen ViT-L backbone
    bootstrapped as the JAX trainer does: the DINOv2 file that
    ``resolve_dinov2_weights(dinov2_path)`` finds (the argument,
    ``$MICKEY_DINOV2_PATH``, ``weights/``, ``~/.cache/mickey_tpu/``; never a
    download), converted; the random backbone where there is none, or for
    another variant. The draws of training and validation come from one
    generator on ``device`` seeded with ``seed + 1``. ``out_dir`` receives
    the checkpoints and the tensorboardX logs; it is made when first written.

    Turns TF32 off process-wide, as ``models.build_model`` does: the
    matcher's fp32 correlation stands in for the reference's
    Precision.HIGHEST product. ``dp``: this rank of a data-parallel group
    (module docstring); ``device`` is then the rank's. ``tp``: this rank of
    a model group that splits the backbone (module docstring)."""

    def __init__(self, cfg, params=None, seed: int = 0, device="cuda", dinov2_path: Optional[str] = None,
                 out_dir: str = "weights/mickey_tpu_torch", dp: Optional[parallel.DataParallel] = None,
                 tp: Optional[parallel.TensorParallel] = None):
        self.cfg = cfg
        self.out_dir = out_dir
        self.dp = dp if dp is not None else parallel.world()
        self.tp = tp if tp is not None else parallel.tensor_parallel()
        self.main = self.dp.rank == 0 and self.tp.rank == 0  # global rank 0 under a grid
        self.device = torch.device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if params is None:
            params = init_params_numpy(cfg, seed)
            if cfg.MICKEY.DINOV2.get("VARIANT", "vit_large") == "vit_large":
                path = resolve_dinov2_weights(dinov2_path)
                if path:
                    params["dinov2"] = convert_dinov2_state_dict(load_torch_state_dict(path))
        # frozen-backbone feature cache: opened or built in fit(), which has
        # the dataset; a configuration that cannot use one fails here
        self.feature_cache = None
        self._cache_path = str(cfg.TPU.get("FEATURE_CACHE", "") or "")
        if self._cache_path:
            if not cfg.TPU.get("STAGED_TRAIN", True):
                raise ValueError("TPU.FEATURE_CACHE requires TPU.STAGED_TRAIN")
            from ..training.feature_cache import check_cfg_cacheable

            check_cfg_cacheable(cfg)

        # the frozen backbone is never quantized here: MICKEY.DINOV2.INT8
        # selects nothing in training, as in mickey_tpu's trainer
        self.state, backbone = init_train_state(cfg, params_to_torch(params, cfg, self.device))
        # global rank 0's state everywhere: over the data group, then the model group
        tensors = [t for _, t in tree_leaves(self.state.params)] + [t for _, t in tree_leaves(backbone)]
        self.dp.broadcast_(tensors)
        self.tp.broadcast_(tensors)
        # a cache's fingerprint is the whole backbone's, whatever the rank holds
        self._fingerprint = None
        if self._cache_path and self.tp.size > 1:
            from ..training.feature_cache import backbone_fingerprint

            self._fingerprint = backbone_fingerprint(backbone)
        variant = cfg.MICKEY.DINOV2.get("VARIANT", "vit_large")
        self.backbone = parallel.shard_backbone(self.tp, backbone, VIT_CONFIGS[variant]["num_heads"])
        del backbone, tensors
        self.train_step = StagedTrainStep(cfg, self.tp)
        self.val_step = ValStep(cfg, self.tp)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._lr_fn = make_lr_fn(cfg)
        # validation reuses each scene keyframe's features (frame key -> map)
        self._cached_val = bool(cfg.TPU.get("CACHED_VAL", True))
        self._val_kf_cache: Dict[str, torch.Tensor] = {}

        cl = cfg.LOSS_CLASS.CURRICULUM_LEARNING
        self.curriculum = bool(cl.TRAIN_CURRICULUM)
        self.topk = float(cl.TOPK_INIT)
        self.topk_max = float(cl.TOPK)

        self.best = {"auc_vcre": -1.0, "auc_pose": -1.0}
        self.writer = None
        self.global_step = 0

    # -- logging ------------------------------------------------------------
    def _get_writer(self):
        if self.writer is None and not self.main:
            self.writer = False
        if self.writer is None:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(os.path.join(self.out_dir, "tb"))
            except ImportError:
                self.writer = False
        return self.writer

    def log_scalar(self, name: str, value: float, step: Optional[int] = None):
        w = self._get_writer()
        if w:
            w.add_scalar(name, float(value), step if step is not None else self.global_step)

    def log_image(self, name: str, img_hwc: np.ndarray, step: Optional[int] = None):
        w = self._get_writer()
        if w:
            w.add_image(name, np.asarray(img_hwc), step if step is not None else self.global_step,
                        dataformats="HWC")

    # -- batches -------------------------------------------------------------
    def images(self, images) -> torch.Tensor:
        """A (B, H, W, 3) image batch (numpy or tensor) cropped to the patch
        grid, on the device."""
        return torch.as_tensor(crop_to_patches(images, self.cfg)).to(self.device).contiguous()

    def device_batch(self, batch: Dict, images: bool = True) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device, images cropped (or left out)."""
        out = {k: torch.as_tensor(batch[k]).to(self.device) for k in BATCH_KEYS[2:] if k in batch}
        if images:
            out.update({k: self.images(batch[k]) for k in BATCH_KEYS[:2]})
        return out

    # -- steps ---------------------------------------------------------------
    def _global(self, batch: Dict):
        """The data-parallel step over the global batch whose rows ``batch``
        holds (nothing at one rank)."""
        return parallel.global_batch(self.dp, len(batch["T_0to1"]))

    def training_step(self, batch: Dict) -> Dict[str, float]:
        """One step; under data parallelism on this rank's rows of the
        global batch, as the sharded loader gives them."""
        with self._global(batch):
            if self.feature_cache is not None:
                _, metrics = self._cached_step(batch)
            else:
                _, metrics = self.train_step(self.state, self.backbone, self.device_batch(batch), self.generator,
                                             self.topk)
        self.global_step += 1
        return {k: float(v) for k, v in metrics.items()}

    def _cached_step(self, batch: Dict):
        """The train step on cached frozen-backbone features: no backbone
        pass and no images. The loader's prefetch threads normally supply
        ``batch["fmap"]``; a hand-built batch has its rows gathered here."""
        fmap = batch.get("fmap")
        if fmap is None:
            from ..training.feature_cache import frame_key

            fmap = self.feature_cache.gather([frame_key(sr, p[half]) for half in (0, 1)
                                              for sr, p in zip(batch["scene_root"], batch["pair_names"])])
        return self.train_step.grad_step(self.state, torch.as_tensor(fmap).to(self.device),
                                         self.device_batch(batch, images=False), self.generator, self.topk)

    def validation_step(self, batch: Dict) -> Dict[str, np.ndarray]:
        """Validation of a batch; under data parallelism of this rank's rows,
        the per-pair outputs gathered into the global batch's (its padding
        dropped) and the loss metrics the global batch's."""
        with self._global(batch):
            if self._cached_val and "scene_root" in batch and "pair_names" in batch:
                out = self._validation_step_cached(batch)
            else:
                out = self.val_step(self.state.params, self.backbone, self.device_batch(batch), self.generator)
        if self.dp.size > 1:
            real = batch.get("global_batch")
            out = {k: self.dp.all_gather_rows(v)[:real] if v.ndim else v for k, v in out.items()}
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    def _validation_step_cached(self, batch: Dict):
        """Validation with per-frame reuse of the backbone's features.

        Keyframe (frame0) features come from this run's memory cache, else
        from the training feature cache when one is open and holds the
        frame, else from one backbone pass over the batch's missing
        keyframes, padded to the batch as the query pass is. Query (frame1)
        features come from the feature cache when it holds all of the
        batch's queries, else from one backbone pass; queries are unique to
        their pair and never enter the memory cache. Every map is in
        ``val_fmap_dtype``, whatever its source."""
        from ..training.feature_cache import frame_key

        step, disk = self.val_step, self.feature_cache
        db = self.device_batch(batch, images=False)
        pairs = list(zip(batch["scene_root"], batch["pair_names"]))
        keys0 = [frame_key(sr, p[0]) for sr, p in pairs]
        keys1 = [frame_key(sr, p[1]) for sr, p in pairs]

        if disk is not None and all(k in disk for k in keys1):
            q_feats = disk.gather(keys1).to(self.device, step.dtype)
        else:
            q_feats = step.backbone_fwd(self.backbone, self.images(batch["image1"]))

        missing = [k for k in dict.fromkeys(keys0)
                   if k not in self._val_kf_cache and not (disk is not None and k in disk)]
        if missing:
            rows = [keys0.index(k) for k in missing]
            rows += rows[-1:] * (len(keys0) - len(rows))  # the query pass's batch
            feats = step.backbone_fwd(self.backbone, self.images(batch["image0"][rows]))
            for j, k in enumerate(missing):
                self._val_kf_cache[k] = feats[j].clone()
            if len(self._val_kf_cache) > VAL_KEYFRAME_BOUND:
                # evict only what the batch in flight does not need
                keep = set(keys0)
                for k in [k for k in self._val_kf_cache if k not in keep]:
                    del self._val_kf_cache[k]

        def kf_row(k):
            if k in self._val_kf_cache:
                return self._val_kf_cache[k]
            return disk.gather([k])[0].to(self.device, step.dtype)

        fmap = torch.cat([torch.stack([kf_row(k) for k in keys0]), q_feats], dim=0)
        return step.tail(self.state.params, fmap, db, self.generator)

    def on_train_epoch_end(self) -> None:
        if self.curriculum:
            self.topk = min(self.topk_max, self.topk + 5)

    # -- epoch-end validation aggregation -------------------------------------
    def aggregate_validation(self, outputs) -> Dict[str, float]:
        agg = {k: np.concatenate([np.atleast_1d(o[k]) for o in outputs]) for k in outputs[0]}
        inliers = agg["inliers"].reshape(-1)

        res = {
            "val_loss/loss": float(np.mean(agg["loss"])),
            "val_loss/loss_R": float(np.mean(agg["avg_loss_rot"])),
            "val_loss/loss_t": float(np.mean(agg["avg_loss_trans"])),
            "val_metric_pose/ours_t_err_ang": float(np.mean(agg["t_err_ang"])),
            "val_metric_pose/ours_t_err_euc": float(np.mean(agg["t_err_euc"])),
            "val_metric_pose/ours_R_err": float(np.mean(agg["R_err"])),
            "val_vcre/metric_ours_vcre": float(np.mean(agg["vcre"])),
        }

        for t_th, r_th, tag in ((0.25, 5, ""), (0.5, 10, "_10")):
            ok = (agg["t_err_euc"].reshape(-1) < t_th) & (agg["R_err"].reshape(-1) < r_th)
            res[f"val_AUC_pose/prec_pose_ours{tag}"] = float(ok.mean())
            _, _, auc = precision_recall(inliers=inliers, tp=ok, failures=0)
            res[f"val_AUC_pose/auc_pose{tag}"] = float(auc)

        ok_vcre = agg["vcre"].reshape(-1) < 90
        res["val_vcre/prec_vcre_ours"] = float(ok_vcre.mean())
        _, _, auc_vcre = precision_recall(inliers=inliers, tp=ok_vcre, failures=0)
        res["val_vcre/auc_vcre"] = float(auc_vcre)
        return res

    # -- checkpoints (native: training/checkpoint.py) ---------------------------
    def _moments(self, moments):
        """A list of moments over the trainables -> ``mickey_tpu``'s tree, zeros
        at the BatchNorm stats."""
        it = iter(moments)
        flat = [torch.zeros_like(t) if is_bn_stat(p) else next(it) for p, t in tree_leaves(self.state.params)]
        return params_to_numpy(tree_unflatten(self.state.params, iter(flat)))

    def maybe_checkpoint(self, val_metrics: Dict[str, float], epoch: int):
        """best_vcre / best_pose when their AUC improves (parameters only),
        and last every epoch with the optimizer state. Every rank tracks the
        best AUCs; global rank 0 alone writes."""
        write = self.main
        params_host = params_to_numpy(self.state.params) if write else None
        extra = {"topk": self.topk, "epoch": epoch}
        for key, metric, name in (("auc_vcre", "val_vcre/auc_vcre", "best_vcre"),
                                  ("auc_pose", "val_AUC_pose/auc_pose", "best_pose")):
            if val_metrics.get(metric, -1) > self.best[key]:
                self.best[key] = val_metrics[metric]
                if write:
                    save_checkpoint(os.path.join(self.out_dir, name), params_host, step=self.global_step, extra=extra)
        if write:
            opt = self.state.opt_state
            save_checkpoint(os.path.join(self.out_dir, "last"), params_host, step=self.global_step,
                            opt_state={"count": int(opt.count), "mu": self._moments(opt.mu),
                                       "nu": self._moments(opt.nu)}, extra=extra)

    def resume(self, path: str) -> int:
        """Restore parameters, both moments, Adam's count, the step and topk
        from a ``last`` checkpoint, in place; returns its epoch."""
        restored = restore_checkpoint(path)
        if "opt_state" not in restored:
            raise ValueError(f"{path} holds no optimizer state: resume from a 'last' checkpoint")

        def leaves(tree):
            return dict(tree_leaves(trainable_to_torch(tree, self.device)))

        params, opt = leaves(restored["params"]), restored["opt_state"]
        mu, nu = leaves(opt["mu"]), leaves(opt["nu"])
        state = self.state
        with torch.no_grad():
            trainables = 0
            for path_, t in tree_leaves(state.params):
                t.copy_(params[path_])
                if not is_bn_stat(path_):
                    state.opt_state.mu[trainables].copy_(mu[path_])
                    state.opt_state.nu[trainables].copy_(nu[path_])
                    trainables += 1
            state.opt_state.count.fill_(opt["count"])
        state.step = restored["step"]
        self.global_step = restored["step"]
        self.topk = float(restored["extra"]["topk"])
        return int(restored["extra"]["epoch"])

    # -- image panels --------------------------------------------------------
    def log_training_images(self, batch: Dict):
        """Log match, score-map, depth-map and reward panels of the batch's
        first pair. Only small tensors reach the host: the top-60 mutual
        matches, the patch-grid score and depth maps and the REINFORCE
        coefficients of the first draw's samples."""
        from ..nn.extractor import compute_correspondences, normalize_images
        from ..nn.matcher import mutual_matches_device
        from ..training.loss import metric_pose_loss
        from ..training.train_step import batch_pose
        from ..utils.viz import colorize_depth, draw_matches, draw_reward_matches, prepare_score_map

        db = {k: v[:1] for k, v in self.device_batch(batch).items()}
        with torch.no_grad():
            params = dict(self.state.params, dinov2=self.backbone)
            corr, _ = compute_correspondences(params, db["image0"], db["image1"], self.cfg, train=False, tp=self.tp)
            fs = corr.final_scores
            rows, cols, msc = mutual_matches_device(fs[0])
            Rgt, tgt = batch_pose(db)
            _, aux = metric_pose_loss(fs, corr.kps0, corr.depth0, corr.kps1, corr.depth1, db["K_color0"],
                                      db["K_color1"], db["Kori_color0"], db["Kori_color1"], Rgt, tgt,
                                      self.train_step.lc, 100.0, generator=self.generator)
            n1 = fs.shape[2]
            draw0 = aux["sampled_idx"][0, 0]  # (S,)
            # a sample's REINFORCE coefficient: the sum over the draws that hold
            # it of (loss_i - baseline)
            lv = aux["loss_value"][0] - aux["loss_value"][0].mean()  # (it,)
            membership = draw0[:, None, None] == aux["sampled_idx"][0][None, :, :]
            out = {
                "pts0": corr.kps0[0][rows.clamp(min=0)], "pts1": corr.kps1[0][cols.clamp(min=0)],
                "msc": msc, "rows": rows, "scr0": corr.scr0[0], "scr1": corr.scr1[0],
                "depth0": corr.depth_map0[0, :, :, 0], "depth1": corr.depth_map1[0, :, :, 0],
                "samp0": corr.kps0[0][draw0 // n1], "samp1": corr.kps1[0][draw0 % n1],
                "coeff": (membership * lv[None, :, None]).sum(dim=(1, 2)),
            }
        out = {k: v.cpu().numpy() for k, v in out.items()}
        im0, im1 = (normalize_images(db[k][0]).cpu().numpy() for k in ("image0", "image1"))
        valid = out["rows"] >= 0
        if valid.any():
            self.log_image("training_matching/best_matches_desc",
                           draw_matches(im0, im1, out["pts0"][valid], out["pts1"][valid], out["msc"][valid]))
        self.log_image("training_scores/map0", prepare_score_map(out["scr0"], im0)[:, :, ::-1] / 255.0)
        self.log_image("training_scores/map1", prepare_score_map(out["scr1"], im1)[:, :, ::-1] / 255.0)
        self.log_image("training_depth/map0", colorize_depth(out["depth0"])[:, :, :3] / 255.0)
        self.log_image("training_depth/map1", colorize_depth(out["depth1"])[:, :, :3] / 255.0)
        self.log_image("training_rewards/pair0",
                       draw_reward_matches(im0, im1, out["samp0"], out["samp1"], out["coeff"]))

    # -- the fit loop ----------------------------------------------------------
    def open_feature_cache(self, dataset):
        """The configured feature cache, its fingerprint and dtype checked
        against this backbone and FEATURE_CACHE_DTYPE; built over ``dataset``
        first where there is none, in passes of the train step's 2B frames.
        Data rank 0 builds (under tensor parallelism all of global rank 0's
        model group, which the passes need, global rank 0 writing) while the
        other data ranks wait."""
        from ..training.feature_cache import FeatureCache, build_feature_cache

        cache_dtype = str(self.cfg.TPU.get("FEATURE_CACHE_DTYPE", "bfloat16"))

        def opened():
            return FeatureCache(self._cache_path, backbone=self.backbone, expect_dtype=cache_dtype,
                                fingerprint=self._fingerprint)

        builder = self.dp.rank == 0
        if not builder:  # data rank 0 builds the cache where there is none
            self.dp.barrier()
        # one branch for the whole model group: its peers run the passes together
        exists = self.tp.broadcast_object(FeatureCache.exists(self._cache_path))
        if exists:
            cache = opened()
            if builder:
                self.dp.barrier()
            return cache
        if not builder:
            raise FileNotFoundError(f"rank 0 left no feature cache at {self._cache_path}")
        if self.main:
            print(f"building feature cache at {self._cache_path}", flush=True)
        cache = build_feature_cache(self.cfg, self.backbone, dataset, self._cache_path,
                                    batch_size=2 * int(self.cfg.TRAINING.BATCH_SIZE), dtype=cache_dtype,
                                    log=(lambda m: print(m, flush=True)) if self.main else None, tp=self.tp,
                                    fingerprint=self._fingerprint, write=self.main)
        self.tp.barrier()  # global rank 0 has written it
        if cache is None:
            cache = opened()
        self.dp.barrier()
        return cache

    def fit(self, datamodule, max_epochs: Optional[int] = None, val_batches: Optional[int] = None,
            log_interval: Optional[int] = None, resume_path: Optional[str] = None):
        cfg = self.cfg
        max_epochs = max_epochs or cfg.TRAINING.EPOCHS
        val_batches = val_batches or cfg.TRAINING.VAL_BATCHES
        log_interval = log_interval or cfg.TRAINING.LOG_INTERVAL

        # a checkpoint closes its epoch: go on with the next one (the JAX
        # package's fit starts the saved epoch over)
        start_epoch = self.resume(resume_path) + 1 if resume_path else 0
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        if self.dp.size > 1:  # each rank reads its rows of every global batch
            train_loader.shard = val_loader.shard = (self.dp.rank, self.dp.size)
        main = self.main
        if self._cache_path:
            if self.feature_cache is None:
                self.feature_cache = self.open_feature_cache(train_loader.dataset)
            # the loader's prefetch threads gather the rows (batch["fmap"])
            train_loader.feature_cache = self.feature_cache

        for epoch in range(start_epoch, max_epochs):
            t_ep = time.time()
            for batch in train_loader:
                metrics = self.training_step(batch)
                if self.global_step % log_interval == 0:
                    for k, v in metrics.items():
                        self.log_scalar(f"train/{k}", v)
                    self.log_scalar("train/topk", self.topk)
                    self.log_scalar("train/lr", float(self._lr_fn(self.global_step)))
                    if cfg.TPU.get("LOG_IMAGES", False) and "image0" in batch:
                        # every rank draws the panels' samples, so the generator stays
                        # the same on all of them; only rank 0's writer logs
                        self.log_training_images(batch)
                    if main:
                        print(f"epoch {epoch} step {self.global_step} loss {metrics['loss']:.4f} "
                              f"gnorm {metrics['grad_norm']:.2f}", flush=True)
            self.on_train_epoch_end()

            outputs = []
            for i, batch in enumerate(val_loader):
                if val_batches and i >= val_batches:
                    break
                outputs.append(self.validation_step(batch))
            if outputs:
                val_metrics = self.aggregate_validation(outputs)
                for k, v in val_metrics.items():
                    self.log_scalar(k, v)
                self.maybe_checkpoint(val_metrics, epoch)
                if main:
                    print(f"epoch {epoch} done in {time.time() - t_ep:.0f}s val auc_vcre "
                          f"{val_metrics['val_vcre/auc_vcre']:.4f} auc_pose {val_metrics['val_AUC_pose/auc_pose']:.4f}",
                          flush=True)
