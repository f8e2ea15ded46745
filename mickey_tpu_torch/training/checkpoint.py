"""Upstream checkpoint loading (``mickey_tpu/training/checkpoint.py``, the
reference converters).

Converts the upstream release's files into ``mickey_tpu``'s parameter
layout, with numpy leaves, which ``weights.params_to_torch`` then maps to the
port's tensors (one layout mapping, not two):

- ``dinov2_vitl14_pretrain.pth``: the frozen backbone (``convert_dinov2_state_dict``);
- ``mickey.ckpt`` / ``mickey_sc.ckpt``: Lightning checkpoints holding the
  heads and the matcher only (``convert_mickey_state_dict``).

Layout conversions: conv OIHW -> HWIO, linear (out, in) -> (in, out), the
fused qkv columns from torch's [q|k|v] to head-major (H, 3, D), BatchNorm
weight / bias / running_mean / running_var -> scale / bias / mean / var,
transformer blocks and head-transformer layers stacked on a leading depth
axis.

``resolve_dinov2_weights`` looks in the same local places as the JAX
package but never downloads. Native (orbax) checkpoints, save and restore,
are not ported.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]

DINOV2_FILE = "dinov2_vitl14_pretrain.pth"


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _conv(t) -> np.ndarray:
    return _np(t).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _lin(t) -> np.ndarray:
    return _np(t).T  # (out, in) -> (in, out)


def _stack(dicts):
    if isinstance(dicts[0], dict):
        return {k: _stack([d[k] for d in dicts]) for k in dicts[0]}
    return np.stack(dicts)


# -- DINOv2 backbone -------------------------------------------------------------


def qkv_to_head_major(w: np.ndarray, b: np.ndarray, num_heads: int):
    """Fused-qkv columns (in, 3C) / (3C,) from torch's [q|k|v] to head-major
    (H, 3, D), the layout ``nn.dinov2`` reads."""
    cin, c3 = w.shape
    d = c3 // (3 * num_heads)
    w = w.reshape(cin, 3, num_heads, d).transpose(0, 2, 1, 3).reshape(cin, c3)
    b = b.reshape(3, num_heads, d).transpose(1, 0, 2).reshape(c3)
    return w, b


def convert_dinov2_state_dict(sd: Dict[str, Any], depth: Optional[int] = None) -> Params:
    """torch DINOv2 state dict -> ViT params (numpy, blocks stacked). ``depth``
    defaults to the number of blocks in ``sd`` (the JAX package's default is
    ViT-L's 24)."""
    dim = int(_np(sd["blocks.0.norm1.weight"]).shape[0])
    num_heads = {384: 6, 768: 12, 1024: 16, 1536: 24}[dim]
    if depth is None:
        depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))

    def vec(key):
        return _np(sd[key])

    def lin(pre):
        return {"w": _lin(sd[pre + ".weight"]), "b": vec(pre + ".bias")}

    def norm(pre):
        return {"scale": vec(pre + ".weight"), "bias": vec(pre + ".bias")}

    blocks = []
    for i in range(depth):
        pre = f"blocks.{i}."
        qkv_w, qkv_b = qkv_to_head_major(_lin(sd[pre + "attn.qkv.weight"]), vec(pre + "attn.qkv.bias"), num_heads)
        mlp = ({"fc1": lin(pre + "mlp.fc1"), "fc2": lin(pre + "mlp.fc2")} if pre + "mlp.fc1.weight" in sd
               else {"w12": lin(pre + "mlp.w12"), "w3": lin(pre + "mlp.w3")})
        blocks.append({
            "norm1": norm(pre + "norm1"),
            "attn": {"qkv": {"w": qkv_w, "b": qkv_b}, "proj": lin(pre + "attn.proj")},
            "ls1": {"gamma": vec(pre + "ls1.gamma")},
            "norm2": norm(pre + "norm2"),
            "mlp": mlp,
            "ls2": {"gamma": vec(pre + "ls2.gamma")},
        })
    return {
        "patch_embed": {"w": _conv(sd["patch_embed.proj.weight"]), "b": vec("patch_embed.proj.bias")},
        "cls_token": vec("cls_token"),
        "pos_embed": vec("pos_embed"),
        "blocks": _stack(blocks),
        "norm": norm("norm"),
    }


# -- heads + matcher --------------------------------------------------------------

# each head's output conv key (None: the descriptor head has no output conv)
HEAD_OUT_KEY = {"det_head": "score", "det_offset": "xy_offset", "depth_head": "depth", "dsc_head": None}


def _convert_basic_block(sd, pre: str) -> Params:
    p: Params = {"conv1": {"w": _conv(sd[pre + "conv1.weight"])}, "conv2": {"w": _conv(sd[pre + "conv2.weight"])}}
    if pre + "bn1.weight" in sd:
        for bn in ("bn1", "bn2"):
            p[bn] = {"scale": _np(sd[f"{pre}{bn}.weight"]), "bias": _np(sd[f"{pre}{bn}.bias"]),
                     "mean": _np(sd[f"{pre}{bn}.running_mean"]), "var": _np(sd[f"{pre}{bn}.running_var"])}
    if pre + "shortcut.0.weight" in sd:
        p["shortcut"] = {"w": _conv(sd[pre + "shortcut.0.weight"])}
    return p


def _convert_att_transformer(sd, pre: str, num_layers: int = 3) -> Params:
    layers = []
    for i in range(num_layers):
        lp = f"{pre}layers.{i}."
        layers.append({
            "q_proj": {"w": _lin(sd[lp + "q_proj.weight"])},
            "k_proj": {"w": _lin(sd[lp + "k_proj.weight"])},
            "v_proj": {"w": _lin(sd[lp + "v_proj.weight"])},
            "merge": {"w": _lin(sd[lp + "merge.weight"])},
            "mlp_fc1": {"w": _lin(sd[lp + "mlp.0.weight"])},
            "mlp_fc2": {"w": _lin(sd[lp + "mlp.2.weight"])},
            "norm1": {"scale": _np(sd[lp + "norm1.weight"]), "bias": _np(sd[lp + "norm1.bias"])},
            "norm2": {"scale": _np(sd[lp + "norm2.weight"]), "bias": _np(sd[lp + "norm2.bias"])},
        })
    return {"layers": _stack(layers)}


def convert_mickey_state_dict(sd: Dict[str, Any]) -> Params:
    """Upstream Lightning state dict (heads + matcher) -> params (numpy).
    Takes the raw state dict or the ``{"state_dict": ...}`` checkpoint, with
    or without the ``compute_matches.`` prefix."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {re.sub(r"^compute_matches\.", "", k): v for k, v in sd.items()}
    params: Params = {}
    for head, out_key in HEAD_OUT_KEY.items():
        pre = f"extractor.{head}."
        p = {f"resblock{i}": _convert_basic_block(sd, f"{pre}resblock{i}.") for i in range(1, 5)}
        p["att"] = _convert_att_transformer(sd, f"{pre}att_layer.")
        p["out"] = {"w": _conv(sd[f"{pre}{out_key}.weight"])} if out_key else None
        params[head] = p
    params["matcher"] = {}
    if "matcher.matching_mat.dustbin_score" in sd:
        params["matcher"]["dustbin_score"] = _np(sd["matcher.matching_mat.dustbin_score"])
    return params


def load_torch_state_dict(path: str):
    """``torch.load`` restricted to tensors (``weights_only=True``): the
    paths come from arguments, the environment and the working directory, so
    full unpickling would run whatever a planted file holds. Plain state
    dicts never need it; a Lightning ``.ckpt`` with non-tensor metadata loads
    only with ``MICKEY_UNSAFE_TORCH_LOAD=1``."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if os.environ.get("MICKEY_UNSAFE_TORCH_LOAD") != "1":
            raise RuntimeError(f"{path} is not loadable with weights_only=True. If you trust this file, "
                               "set MICKEY_UNSAFE_TORCH_LOAD=1 to allow full unpickling.") from e
        return torch.load(path, map_location="cpu", weights_only=False)


def load_reference_checkpoint(ckpt_path: str, dinov2_path: Optional[str] = None) -> Params:
    """``mickey.ckpt`` (and a DINOv2 ``.pth``, if given) -> params (numpy)."""
    params = convert_mickey_state_dict(load_torch_state_dict(ckpt_path))
    if dinov2_path:
        params["dinov2"] = convert_dinov2_state_dict(load_torch_state_dict(dinov2_path))
    return params


def resolve_dinov2_weights(path: Optional[str] = None) -> Optional[str]:
    """The first of these that exists: ``path``; ``$MICKEY_DINOV2_PATH``;
    ``weights/dinov2_vitl14_pretrain.pth`` under the working directory;
    ``~/.cache/mickey_tpu/dinov2_vitl14_pretrain.pth``. None when there is
    none: unlike the JAX package, the port never downloads the file."""
    candidates = [
        path,
        os.environ.get("MICKEY_DINOV2_PATH"),
        os.path.join("weights", DINOV2_FILE),
        os.path.expanduser(os.path.join("~", ".cache", "mickey_tpu", DINOV2_FILE)),
    ]
    return next((c for c in candidates if c and os.path.exists(c)), None)
