"""Model builder (``mickey_tpu/models/builder.py``), random or bridged weights.

Loading the upstream ``.ckpt`` and DINOv2 ``.pth`` files is not ported yet;
``params`` takes a ``mickey_tpu`` parameter pytree instead.
"""

from __future__ import annotations

import torch

from ..weights import init_params_numpy, params_to_torch
from .relative_pose import MickeyRelativePose


def build_model(cfg, params=None, seed: int = 0, device="cuda") -> MickeyRelativePose:
    """``params``: a ``mickey_tpu`` pytree with numpy leaves, or None for
    ``init_params_numpy(cfg, seed)``.

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
    return MickeyRelativePose(cfg, params_to_torch(params, cfg, device), device=device)
