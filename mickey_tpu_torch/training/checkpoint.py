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
package but never downloads.

Native checkpoints (``save_checkpoint`` / ``restore_checkpoint``): the JAX
package writes orbax directories, which the port neither reads nor writes
(``tools/checkpoint_bridge_torch.py``, run where jax and orbax are
installed, converts them both ways).
The port's native checkpoint is a directory holding one file,
``checkpoint.pt``, that ``torch.load(..., weights_only=True)`` reads: plain
tensors and numbers only, in ``mickey_tpu``'s layout (``weights.params_to_numpy``),
so the file maps onto the JAX package's tree leaf for leaf:

- ``params``: the trainables (heads with their BatchNorm stats, matcher);
  the frozen DINOv2 is left out, as in the reference;
- ``opt_state`` (``last`` only): Adam's ``count`` and its moments ``mu``
  and ``nu`` as trees of the trainables' structure (zeros at the BatchNorm
  stats, which the optimizer never moves, as optax's moments hold them);
- ``step`` and ``extra`` (``topk``, ``epoch``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]

DINOV2_FILE = "dinov2_vitl14_pretrain.pth"
CHECKPOINT_FILE = "checkpoint.pt"
FORMAT_VERSION = 1


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


# -- native checkpoints ---------------------------------------------------------


def _tensor_tree(tree):
    """numpy leaves -> CPU tensors (None kept)."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    return None if tree is None else torch.from_numpy(np.array(tree, copy=True))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.numpy()


def is_native_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, CHECKPOINT_FILE))


def save_checkpoint(path: str, params: Params, step: int = 0, opt_state=None, extra=None) -> None:
    """Write ``path/checkpoint.pt`` (module docstring). ``params``: the
    trainable tree in ``mickey_tpu``'s layout with numpy leaves (a
    ``dinov2`` entry is dropped); ``opt_state``: {"count": int, "mu": tree,
    "nu": tree} in the same layout, or None; ``extra``: a dict of numbers.
    The file is written whole, then renamed into place."""
    payload: Dict[str, Any] = {
        "version": FORMAT_VERSION,
        "params": _tensor_tree({k: v for k, v in params.items() if k != "dinov2"}),
        "step": int(step),
    }
    if opt_state is not None:
        payload["opt_state"] = {"count": torch.tensor(int(opt_state["count"]), dtype=torch.int32),
                                "mu": _tensor_tree(opt_state["mu"]), "nu": _tensor_tree(opt_state["nu"])}
    if extra is not None:
        payload["extra"] = dict(extra)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, CHECKPOINT_FILE)
    torch.save(payload, final + ".tmp")
    os.replace(final + ".tmp", final)


def restore_checkpoint(path: str) -> Dict:
    """Read a native checkpoint directory: {"params", "step", "extra"[,
    "opt_state"]} with numpy leaves in ``mickey_tpu``'s layout (DINOv2 is
    the caller's to supply). Raises ``NotImplementedError`` for any other
    directory; an orbax one (``mickey_tpu``'s) is named as such."""
    if not is_native_checkpoint(path):
        orbax = any(os.path.exists(os.path.join(path, f)) for f in ("_CHECKPOINT_METADATA", "_METADATA",
                                                                     "manifest.ocdbt"))
        kind = ("an orbax checkpoint (mickey_tpu's format), which the port cannot read; convert it with "
                "`python tools/checkpoint_bridge_torch.py to-native <orbax_dir> <out_dir> [--config ...]` where "
                "jax and orbax are installed") if orbax else (
            f"not a native checkpoint of the port (no {CHECKPOINT_FILE})")
        raise NotImplementedError(f"{path}: {kind}")
    payload = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu", weights_only=True)
    out = {"params": _numpy_tree(payload["params"]), "step": int(payload["step"]),
           "extra": dict(payload.get("extra", {}))}
    if "opt_state" in payload:
        o = payload["opt_state"]
        out["opt_state"] = {"count": int(o["count"]), "mu": _numpy_tree(o["mu"]), "nu": _numpy_tree(o["nu"])}
    return out
