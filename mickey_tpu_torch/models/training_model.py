"""A minimal trainer (``mickey_tpu/models/training_model.py::MicKeyTrainer``):
state, the staged step and the curriculum. Validation, checkpoints, the
feature cache, logging and ``fit`` are not ported yet."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..training.checkpoint import convert_dinov2_state_dict, load_torch_state_dict, resolve_dinov2_weights
from ..training.train_step import StagedTrainStep, init_train_state
from ..weights import init_params_numpy, params_to_torch

BATCH_KEYS = ("image0", "image1", "T_0to1", "K_color0", "K_color1", "Kori_color0", "Kori_color1")


class MicKeyTrainer:
    """``params``: a ``mickey_tpu`` pytree with numpy leaves, or None for
    ``init_params_numpy(cfg, seed)`` with the frozen ViT-L backbone
    bootstrapped as the JAX trainer does: the DINOv2 file that
    ``resolve_dinov2_weights(dinov2_path)`` finds (the argument,
    ``$MICKEY_DINOV2_PATH``, ``weights/``, ``~/.cache/mickey_tpu/``; never a
    download), converted; the random backbone where there is none, or for
    another variant. The draws come from a generator on ``device`` seeded
    with ``seed + 1``.

    Turns TF32 off process-wide, as ``models.build_model`` does: the
    matcher's fp32 correlation stands in for the reference's
    Precision.HIGHEST product."""

    def __init__(self, cfg, params=None, seed: int = 0, device="cuda", dinov2_path: Optional[str] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if params is None:
            params = init_params_numpy(cfg, seed)
            if cfg.MICKEY.DINOV2.get("VARIANT", "vit_large") == "vit_large":
                path = resolve_dinov2_weights(dinov2_path)
                if path:
                    params["dinov2"] = convert_dinov2_state_dict(load_torch_state_dict(path))
        self.state, self.backbone = init_train_state(cfg, params_to_torch(params, cfg, self.device))
        self.train_step = StagedTrainStep(cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        cl = cfg.LOSS_CLASS.CURRICULUM_LEARNING
        self.curriculum = bool(cl.TRAIN_CURRICULUM)
        self.topk = float(cl.TOPK_INIT)
        self.topk_max = float(cl.TOPK)

    def device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in BATCH_KEYS}

    def training_step(self, batch: Dict) -> Dict[str, float]:
        _, metrics = self.train_step(self.state, self.backbone, self.device_batch(batch), self.generator, self.topk)
        return {k: float(v) for k, v in metrics.items()}

    def on_train_epoch_end(self) -> None:
        if self.curriculum:
            self.topk = min(self.topk_max, self.topk + 5)
