"""Weight bridge between ``mickey_tpu``'s parameter pytree and the port.

``params_to_torch`` takes the JAX package's pytree, as numpy arrays (or
anything ``np.asarray`` accepts), and returns the port's nested dict of
tensors on ``device``:

- conv weights HWIO -> OIHW; linear weights (in, out) -> (out, in);
- scan-stacked ``(depth, ...)`` ViT blocks and head-transformer layers ->
  lists of per-block dicts;
- the fused qkv columns stay head-major ``(H, 3, D)`` as the JAX package
  stores them (``training/checkpoint.py::_qkv_to_head_major``);
- BatchNorm keeps scale / bias / mean / var; the patch-embed kernel stays
  ``(p, q, c, d)`` for the einsum; the dustbin logit becomes a float.

``init_params_numpy`` builds a pytree of the same structure, shapes and
layout from a numpy ``Generator``, for machines without JAX.

For training, ``split_trainable`` separates the frozen backbone from the
trainable heads and matcher (leaves that require grad, BatchNorm running
stats held as tensors without grad, the dustbin as a 0-d tensor), and
``params_to_numpy`` bridges the trainable part back to the JAX package's
layout, so that tests compare parameters and gradients leaf by leaf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .nn.dinov2 import VIT_CONFIGS

_HEADS = ("det_head", "det_offset", "depth_head", "dsc_head")


# -- numpy init ------------------------------------------------------------------


def _trunc_normal(rng, shape, std=0.02):
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2.0
    return std * x


def _uniform(rng, shape, bound):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _conv_init(rng, cin, cout, k):
    # torch Conv2d default: kaiming-uniform with a = sqrt(5)
    return {"w": _uniform(rng, (k, k, cin, cout), math.sqrt(1.0 / 3.0) * math.sqrt(3.0 / (k * k * cin)))}


def _bn_init(c):
    return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
            "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}


def _ln_init(c):
    return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}


def _stack(dicts):
    if isinstance(dicts[0], dict):
        return {k: _stack([d[k] for d in dicts]) for k in dicts[0]}
    return np.stack(dicts)


def _vit_init(rng, variant, img_size=518, patch=14, mlp_ratio=4.0):
    c = VIT_CONFIGS[variant]
    dim, depth = c["embed_dim"], c["depth"]
    hidden = int(dim * mlp_ratio)

    def lin(cin, cout):
        return {"w": _trunc_normal(rng, (cin, cout)), "b": _uniform(rng, (cout,), 1.0 / math.sqrt(cin))}

    blocks = [
        {
            "norm1": _ln_init(dim),
            "attn": {"qkv": lin(dim, 3 * dim), "proj": lin(dim, dim)},
            "ls1": {"gamma": np.ones(dim, np.float32)},
            "norm2": _ln_init(dim),
            "mlp": {"fc1": lin(dim, hidden), "fc2": lin(hidden, dim)},
            "ls2": {"gamma": np.ones(dim, np.float32)},
        }
        for _ in range(depth)
    ]
    return {
        "patch_embed": {"w": _trunc_normal(rng, (patch, patch, 3, dim)), "b": np.zeros(dim, np.float32)},
        "cls_token": 1e-6 * rng.standard_normal((1, 1, dim), dtype=np.float32),
        "pos_embed": _trunc_normal(rng, (1, (img_size // patch) ** 2 + 1, dim)),
        "blocks": _stack(blocks),
        "norm": _ln_init(dim),
    }


def _transformer_init(rng, d, num_layers=3):
    def xavier(cin, cout):
        return {"w": _uniform(rng, (cin, cout), math.sqrt(6.0 / (cin + cout)))}

    layers = [
        {"q_proj": xavier(d, d), "k_proj": xavier(d, d), "v_proj": xavier(d, d), "merge": xavier(d, d),
         "mlp_fc1": xavier(2 * d, 2 * d), "mlp_fc2": xavier(2 * d, d),
         "norm1": _ln_init(d), "norm2": _ln_init(d)}
        for _ in range(num_layers)
    ]
    return {"layers": _stack(layers)}


def _head_init(rng, cin, block_dims, last_dim, bn, out_channels):
    dims = [cin] + list(block_dims[:3]) + [last_dim]
    p = {}
    for i in range(4):
        a, b = dims[i], dims[i + 1]
        blk = {"conv1": _conv_init(rng, a, b, 3), "conv2": _conv_init(rng, b, b, 3)}
        if bn:
            blk["bn1"], blk["bn2"] = _bn_init(b), _bn_init(b)
        if a != b:
            blk["shortcut"] = _conv_init(rng, a, b, 1)
        p[f"resblock{i + 1}"] = blk
    p["att"] = _transformer_init(rng, block_dims[2])
    p["out"] = _conv_init(rng, dims[4], out_channels, 1) if out_channels else None
    return p


def init_params_numpy(cfg, seed: int = 0):
    """Random parameters in ``mickey_tpu``'s pytree layout, from ``seed``:
    trunc-normal(0.02) ViT, kaiming-uniform convs, xavier transformer
    linears, identity BatchNorm, dustbin 1.0."""
    rng = np.random.default_rng(seed)
    mk = cfg.MICKEY
    cin, bd, bn = mk.DINOV2.CHANNEL_DIM, mk.KP_HEADS.BLOCKS_DIM, mk.KP_HEADS.BN
    p = {
        "det_head": _head_init(rng, cin, bd, bd[3], bn, 1),
        "det_offset": _head_init(rng, cin, bd, bd[3], bn, 2),
        "depth_head": _head_init(rng, cin, bd, bd[3], bn, 1),
        "dsc_head": _head_init(rng, cin, bd, mk.DSC_HEAD.LAST_DIM, bn, 0),
        "dinov2": _vit_init(rng, mk.DINOV2.get("VARIANT", "vit_large")),
        "matcher": {},
    }
    if cfg.FEATURE_MATCHER.DUAL_SOFTMAX.USE_DUSTBIN:
        p["matcher"]["dustbin_score"] = np.float32(1.0)
    return p


# -- pytree -> torch -----------------------------------------------------------------


def _unstack(tree):
    """{'k': (depth, ...)} -> [{'k': (...)}, ...]."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree)


def params_to_torch(params, cfg, device="cpu"):
    """``mickey_tpu`` param pytree (numpy leaves) -> the port's tensor dicts."""
    if cfg.MICKEY.DINOV2.get("INT8", False):
        raise NotImplementedError("the int8 backbone is not ported yet")

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)

    def lin(p):
        out = {"w": t(np.asarray(p["w"]).T)}
        if "b" in p:
            out["b"] = t(p["b"])
        return out

    def conv(p):
        return {"w": t(np.asarray(p["w"]).transpose(3, 2, 0, 1))}

    def vec(p):
        return {k: t(v) for k, v in p.items()}

    vit = params["dinov2"]
    if "fc1" not in vit["blocks"]["mlp"]:
        raise NotImplementedError("the SwiGLU ViT variant is not ported yet")
    blocks = [
        {
            "norm1": vec(bp["norm1"]),
            "attn": {"qkv": lin(bp["attn"]["qkv"]), "proj": lin(bp["attn"]["proj"])},
            "ls1": vec(bp["ls1"]),
            "norm2": vec(bp["norm2"]),
            "mlp": {"fc1": lin(bp["mlp"]["fc1"]), "fc2": lin(bp["mlp"]["fc2"])},
            "ls2": vec(bp["ls2"]),
        }
        for bp in _unstack(vit["blocks"])
    ]
    out = {
        "dinov2": {
            "patch_embed": vec(vit["patch_embed"]),
            "cls_token": t(vit["cls_token"]),
            "pos_embed": t(vit["pos_embed"]),
            "blocks": blocks,
            "norm": vec(vit["norm"]),
        },
        "matcher": {k: float(np.asarray(v)) for k, v in params["matcher"].items()},
    }
    for name in _HEADS:
        hp = params[name]
        head = {}
        for i in range(1, 5):
            bp = hp[f"resblock{i}"]
            head[f"resblock{i}"] = {
                k: (conv(v) if k in ("conv1", "conv2", "shortcut") else vec(v)) for k, v in bp.items()
            }
        head["att"] = {
            "layers": [
                {k: (vec(v) if k.startswith("norm") else lin(v)) for k, v in lp.items()}
                for lp in _unstack(hp["att"]["layers"])
            ]
        }
        head["out"] = conv(hp["out"]) if hp.get("out") is not None else None
        out[name] = head
    return out


# -- training: trainable split and the reverse bridge --------------------------------


def is_bn_stat(path) -> bool:
    """BatchNorm running stats: advanced by the forward, never by the optimizer."""
    return path[-1] in ("mean", "var")


def tree_leaves(tree, path=()):
    """[(path, tensor)] of a nested dict / list of tensors, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in tree_leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in tree_leaves(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def split_trainable(params):
    """The port's params (``params_to_torch``) -> (trainable, backbone), as
    ``mickey_tpu/training/train_step.py::init_train_state`` splits them. The
    trainable leaves are set to require grad, in place."""
    backbone = params["dinov2"]
    trainable = {k: v for k, v in params.items() if k != "dinov2"}
    device = params["det_head"]["resblock1"]["conv1"]["w"].device
    trainable["matcher"] = {k: torch.as_tensor(v, dtype=torch.float32, device=device).clone()
                            for k, v in params["matcher"].items()}
    for path, t in tree_leaves(trainable):
        t.requires_grad_(not is_bn_stat(path))
    return trainable, backbone


def params_to_numpy(tree):
    """The port's trainable tree (heads, matcher) -> ``mickey_tpu``'s layout
    with numpy leaves: OIHW -> HWIO, (out, in) -> (in, out), head-transformer
    layers stacked again, the dustbin a 0-d float32 array."""

    def a(t):
        return t.detach().cpu().numpy()

    def conv(p):
        return {"w": a(p["w"]).transpose(2, 3, 1, 0)}

    def lin(p):
        out = {"w": a(p["w"]).T}
        if "b" in p:
            out["b"] = a(p["b"])
        return out

    def vec(p):
        return {k: a(v) for k, v in p.items()}

    out = {}
    for name in _HEADS:
        if name not in tree:
            continue
        hp = tree[name]
        head = {}
        for i in range(1, 5):
            bp = hp[f"resblock{i}"]
            head[f"resblock{i}"] = {
                k: (conv(v) if k in ("conv1", "conv2", "shortcut") else vec(v)) for k, v in bp.items()
            }
        head["att"] = {"layers": _stack([
            {k: (vec(v) if k.startswith("norm") else lin(v)) for k, v in lp.items()}
            for lp in hp["att"]["layers"]
        ])}
        head["out"] = conv(hp["out"]) if hp.get("out") is not None else None
        out[name] = head
    if "matcher" in tree:
        out["matcher"] = {k: np.asarray(a(torch.as_tensor(v)), np.float32) for k, v in tree["matcher"].items()}
    return out
