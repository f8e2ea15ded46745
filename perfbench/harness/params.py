"""Seeded random weights made on the device, in the layout the program's
``MickeyRelativePose`` takes (``mickey_tpu_torch.weights.params_to_torch``'s
output: linears (out, in), convs OIHW, ViT blocks and head-transformer
layers as lists of dicts, the dustbin a float), fp32.

Every random number comes from two calls on one ``torch.Generator`` on the
card: one normal draw and one uniform draw over all leaves at once, sliced
and scaled into each leaf's own tensor. The distributions are those of
``init_params_numpy``: normal ViT weights (std 0.02, clamped at two
sigma where that function redraws), the
default kaiming-uniform of a torch conv, xavier-uniform transformer
linears, identity BatchNorm and LayerNorm, LayerScale 1, dustbin 1.
"""

from __future__ import annotations

import math

import torch

VIT = {"vit_small": (384, 12, 6), "vit_base": (768, 12, 12), "vit_large": (1024, 24, 16),
       "vit_giant2": (1536, 40, 24)}  # (width, depth, heads)


def swiglu_hidden(dim: int, ratio: float = 4.0) -> int:
    """DINOv2's SwiGLU hidden size: 2/3 of the MLP's, up to a multiple of 8."""
    return (int(dim * ratio * 2 / 3) + 7) // 8 * 8


class _Spec:
    """Leaves to draw: (holder dict, key, shape, kind, scale)."""

    def __init__(self):
        self.leaves = []

    def add(self, holder, key, shape, kind, scale=1.0):
        self.leaves.append((holder, key, tuple(shape), kind, scale))

    def fill(self, generator, device):
        numel = {k: sum(math.prod(s) for _, _, s, kind, _ in self.leaves if kind == k) for k in ("normal", "uniform")}
        pools = {"normal": torch.randn(numel["normal"], generator=generator, device=device),
                 "uniform": torch.rand(numel["uniform"], generator=generator, device=device)}
        pools["normal"].clamp_(-2.0, 2.0)
        pools["uniform"].mul_(2.0).sub_(1.0)
        at = {"normal": 0, "uniform": 0}
        for holder, key, shape, kind, scale in self.leaves:
            if kind in pools:
                n = math.prod(shape)
                holder[key] = pools[kind][at[kind]:at[kind] + n].view(shape).mul(scale)  # a tensor of its own
                at[kind] += n
            else:
                holder[key] = torch.full(shape, float(kind), device=device)


def _vec(spec, c, **vals):
    d = {}
    for k, v in vals.items():
        spec.add(d, k, (c,), v)
    return d


def _vit(spec, variant: str, ffn: str, patch: int = 14, img: int = 518):
    dim, depth, _ = VIT[variant]

    def lin(cin, cout):
        d = {}
        spec.add(d, "w", (cout, cin), "normal", 0.02)
        spec.add(d, "b", (cout,), "uniform", 1.0 / math.sqrt(cin))
        return d

    blocks = []
    for _ in range(depth):
        if ffn == "mlp":
            mlp = {"fc1": lin(dim, 4 * dim), "fc2": lin(4 * dim, dim)}
        else:
            sh = swiglu_hidden(dim)
            mlp = {"w12": lin(dim, 2 * sh), "w3": lin(sh, dim)}
        blocks.append({"norm1": _vec(spec, dim, scale=1, bias=0),
                       "attn": {"qkv": lin(dim, 3 * dim), "proj": lin(dim, dim)},
                       "ls1": _vec(spec, dim, gamma=1),
                       "norm2": _vec(spec, dim, scale=1, bias=0),
                       "mlp": mlp,
                       "ls2": _vec(spec, dim, gamma=1)})
    vit = {"patch_embed": {}, "blocks": blocks, "norm": _vec(spec, dim, scale=1, bias=0)}
    spec.add(vit["patch_embed"], "w", (patch, patch, 3, dim), "normal", 0.02)
    spec.add(vit["patch_embed"], "b", (dim,), 0)
    spec.add(vit, "cls_token", (1, 1, dim), "normal", 1e-6)
    spec.add(vit, "pos_embed", (1, (img // patch) ** 2 + 1, dim), "normal", 0.02)
    return vit


def _conv(spec, cin, cout, k):
    d = {}
    spec.add(d, "w", (cout, cin, k, k), "uniform", 1.0 / math.sqrt(k * k * cin))
    return d


def _transformer(spec, d, layers=3):
    def xavier(cin, cout):
        w = {}
        spec.add(w, "w", (cout, cin), "uniform", math.sqrt(6.0 / (cin + cout)))
        return w

    return {"layers": [{"q_proj": xavier(d, d), "k_proj": xavier(d, d), "v_proj": xavier(d, d), "merge": xavier(d, d),
                        "mlp_fc1": xavier(2 * d, 2 * d), "mlp_fc2": xavier(2 * d, d),
                        "norm1": _vec(spec, d, scale=1, bias=0), "norm2": _vec(spec, d, scale=1, bias=0)}
                       for _ in range(layers)]}


def _head(spec, cin, block_dims, last_dim, bn, out_channels):
    dims = [cin] + list(block_dims[:3]) + [last_dim]
    head = {}
    for i in range(4):
        a, b = dims[i], dims[i + 1]
        blk = {"conv1": _conv(spec, a, b, 3), "conv2": _conv(spec, b, b, 3)}
        if bn:
            blk["bn1"] = _vec(spec, b, scale=1, bias=0, mean=0, var=1)
            blk["bn2"] = _vec(spec, b, scale=1, bias=0, mean=0, var=1)
        if a != b:
            blk["shortcut"] = _conv(spec, a, b, 1)
        head[f"resblock{i + 1}"] = blk
    head["att"] = _transformer(spec, block_dims[2])
    head["out"] = _conv(spec, dims[4], out_channels, 1) if out_channels else None
    return head


def make_params(cfg, ffn: str, seed: int, device) -> dict:
    """The model's weights for ``cfg`` from ``seed``, on ``device``. ``ffn``:
    the backbone's feed-forward, "mlp" (ViT-L/14) or "swiglu" (ViT-g/14)."""
    mk = cfg["MICKEY"]
    cin, bd, bn = mk["DINOV2"]["CHANNEL_DIM"], mk["KP_HEADS"]["BLOCKS_DIM"], mk["KP_HEADS"]["BN"]
    spec = _Spec()
    params = {
        "dinov2": _vit(spec, mk["DINOV2"]["VARIANT"], ffn),
        "det_head": _head(spec, cin, bd, bd[3], bn, 1),
        "det_offset": _head(spec, cin, bd, bd[3], bn, 2),
        "depth_head": _head(spec, cin, bd, bd[3], bn, 1),
        "dsc_head": _head(spec, cin, bd, mk["DSC_HEAD"]["LAST_DIM"], bn, 0),
        "matcher": {},
    }
    fm = cfg["FEATURE_MATCHER"]
    if fm["TYPE"] != "DualSoftmax":
        params["matcher"]["dustbin_score"] = float(fm["SINKHORN"]["DUSTBIN_SCORE_INIT"])
    elif fm["DUAL_SOFTMAX"]["USE_DUSTBIN"]:
        params["matcher"]["dustbin_score"] = 1.0
    generator = torch.Generator(device=device).manual_seed(seed)
    spec.fill(generator, device)
    return params
