"""Model builder (``mickey_tpu/models/builder.py``): a ``MickeyRelativePose``
from a random init, a ``mickey_tpu`` parameter pytree, the upstream
checkpoint files, or a native checkpoint directory of the port's trainer.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..training.checkpoint import (
    convert_dinov2_state_dict,
    load_reference_checkpoint,
    load_torch_state_dict,
    resolve_dinov2_weights,
    restore_checkpoint,
)
from ..weights import init_params_numpy, params_to_torch
from .relative_pose import MickeyRelativePose


def build_model(cfg, params=None, *, checkpoint: str = "", dinov2_path: Optional[str] = None, seed: int = 0,
                device="cuda") -> MickeyRelativePose:
    """``params``: a ``mickey_tpu`` pytree with numpy leaves, or None for
    ``init_params_numpy(cfg, seed)``. ``checkpoint``: an upstream Lightning
    ``.ckpt``, or a directory the port's trainer wrote
    (``training.checkpoint.save_checkpoint``), whose heads and matcher are
    overlaid on those params, with the frozen DINOv2 from ``dinov2_path``
    (or where ``resolve_dinov2_weights`` finds it). A checkpoint without
    DINOv2 weights raises, since a trained head on a random backbone gives
    poses that look valid and are garbage, unless
    ``MICKEY_ALLOW_RANDOM_BACKBONE=1``. Any other directory, an orbax one of
    ``mickey_tpu`` among them, raises ``NotImplementedError``.

    Turns TF32 off process-wide: the matcher's fp32 correlation stands in
    for the reference's Precision.HIGHEST product, and cuDNN would otherwise
    run the fp32 head convs in TF32.
    """
    if cfg.MODEL != "MicKey":
        raise NotImplementedError(cfg.MODEL)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if params is None:
        params = init_params_numpy(cfg, seed)
    if checkpoint:
        dinov2_path = resolve_dinov2_weights(dinov2_path)
        if not dinov2_path and os.environ.get("MICKEY_ALLOW_RANDOM_BACKBONE") != "1":
            raise FileNotFoundError(
                "Loading a trained checkpoint requires the frozen DINOv2 backbone weights, which were not "
                "found (no local file; the port never downloads). Set MICKEY_DINOV2_PATH or pass dinov2_path, "
                "or set MICKEY_ALLOW_RANDOM_BACKBONE=1 to knowingly run with a random backbone (smoke tests only).")
        if os.path.isdir(checkpoint):  # the port's native checkpoint; any other directory raises
            params = {**params, **restore_checkpoint(checkpoint)["params"]}
            if dinov2_path:
                params["dinov2"] = convert_dinov2_state_dict(load_torch_state_dict(dinov2_path))
        else:
            params = {**params, **load_reference_checkpoint(checkpoint, dinov2_path)}
    return MickeyRelativePose(cfg, params_to_torch(params, cfg, device), device=device)
