"""Plain PyTorch reference of MicKey's served path: DINOv2 backbone, the four
keypoint heads, the dual-softmax matcher with its top-L / top-P sampling
table, and Procrustes RANSAC.

It imports nothing of the program under test. It follows the published
MicKey (nianticlabs/mickey: ``lib/models/MicKey``) and DINOv2
(facebookresearch/dinov2) and takes the parameter layout the benchmark makes
(``perfbench/harness/params.py``): linears (out, in), convs OIHW, the fused
qkv columns head-major (heads, 3, head_dim).

Two precisions (``Precision``):

- ``REF``: what the configuration states, or above it. Backbone linears in
  bf16 with fp32 accumulation and LayerNorm in fp32, attention on bf16
  q, k, v with an fp32 softmax; heads in fp32 with TF32 off; matcher and
  solver in fp64.
- ``CONTROL``: one step below each stated precision. Backbone block
  linears on fp8 (e4m3, per-tensor scale) operands, every fp32 product
  (heads, matcher, solver) on operands rounded to TF32.

The solver's random draws are replayed from the caller's
``torch.Generator`` by the same calls, in the same order and on the same
device, as the served path makes them, so both sides sample the same
positions of the same table.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


@dataclass(frozen=True)
class Precision:
    name: str
    backbone: str  # block linears' operands: "bf16" or "fp8"
    tf32: bool  # fp32 products on TF32-rounded operands
    exact: torch.dtype  # matcher and solver dtype


REF = Precision("ref", backbone="bf16", tf32=False, exact=torch.float64)
CONTROL = Precision("control", backbone="fp8", tf32=True, exact=torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10-bit mantissa (to nearest, ties away
    from zero), as the tensor cores read fp32 operands; the gradient passes
    as through the identity."""
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


def _op(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return tf32_round(x) if prec.tf32 and x.dtype == torch.float32 else x


# -- backbone ------------------------------------------------------------------------


def _layernorm(p, x, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"].float(), p["bias"].float(), eps)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled to e4m3's largest value, rounded to e4m3, back in fp32."""
    s = (t.abs().amax() / 448.0).clamp_min(1e-12)
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _block_linear(p, x, prec: Precision):
    if prec.backbone == "fp8":  # e4m3 operands, fp32 sums
        out = _fp8(x.float()) @ _fp8(p["w"].float()).t()
        return (out + p["b"].float() if "b" in p else out).to(x.dtype)
    return F.linear(x, p["w"].to(x.dtype), p["b"].to(x.dtype) if "b" in p else None)


def _attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Softmax attention on the head-major packed qkv (B, S, 3C), in fp32,
    output in qkv's dtype."""
    b, s, c3 = qkv.shape
    d = c3 // 3 // heads
    q, k, v = qkv.reshape(b, s, heads, 3, d).float().unbind(3)  # (B, S, H, D)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
    return (att @ v).transpose(1, 2).reshape(b, s, heads * d).to(qkv.dtype)


def _pos_embed(pos: torch.Tensor, h0: int, w0: int) -> torch.Tensor:
    """DINOv2's bicubic resize of the (1, 1 + M*M, C) position embedding,
    with its +0.1 offset on the scale factors."""
    m = int(round(math.sqrt(pos.shape[1] - 1)))
    if (h0, w0) == (m, m):
        return pos
    grid = pos[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2).float()
    grid = F.interpolate(grid, scale_factor=((h0 + 0.1) / m, (w0 + 0.1) / m), mode="bicubic", align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, h0 * w0, -1)
    return torch.cat([pos[:, :1].float(), grid], dim=1)


def vit_block(bp, x: torch.Tensor, heads: int, prec: Precision) -> torch.Tensor:
    """One pre-norm DINOv2 block with LayerScale on (B, S, C) tokens in the
    compute dtype."""
    dtype = x.dtype
    y = _layernorm(bp["norm1"], x.float(), 1e-6).to(dtype)
    y = _block_linear(bp["attn"]["proj"], _attention(_block_linear(bp["attn"]["qkv"], y, prec), heads), prec)
    x = x + bp["ls1"]["gamma"].to(dtype) * y
    y = _layernorm(bp["norm2"], x.float(), 1e-6).to(dtype)
    mlp = bp["mlp"]
    if "fc1" in mlp:
        y = _block_linear(mlp["fc2"], F.gelu(_block_linear(mlp["fc1"], y, prec)), prec)
    else:  # SwiGLU (DINOv2 ViT-g/14)
        a, g = _block_linear(mlp["w12"], y, prec).chunk(2, dim=-1)
        y = _block_linear(mlp["w3"], F.silu(a) * g, prec)
    return x + bp["ls2"]["gamma"].to(dtype) * y


def backbone(p, images: torch.Tensor, heads: int, patch: int, dtype: torch.dtype, prec: Precision,
             taps: Optional[dict] = None) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> DINOv2 patch tokens (B, H/14, W/14, C) in fp32.
    ``taps``: block index -> None, filled with that block's output tokens
    (B, 1 + H/14 * W/14, C) in the compute dtype."""
    b, h, w, _ = images.shape
    h0, w0 = h // patch, w // patch
    x = (images.float() * (1.0 / 255.0)).to(dtype).reshape(b, h0, patch, w0, patch, 3)
    x = torch.einsum("bipjqc,pqcd->bijd", x, p["patch_embed"]["w"].to(dtype)) + p["patch_embed"]["b"].to(dtype)
    x = torch.cat([p["cls_token"].to(dtype).expand(b, 1, -1), x.reshape(b, h0 * w0, -1)], dim=1)
    x = x + _pos_embed(p["pos_embed"], h0, w0).to(dtype)
    for i, bp in enumerate(p["blocks"]):
        x = vit_block(bp, x, heads, prec)  # looked up here at each call, so that a capture can wrap it
        if taps is not None and i in taps:
            taps[i] = x
    x = _layernorm(p["norm"], x.float(), 1e-6)
    return x[:, 1:].reshape(b, h0, w0, -1)


# -- heads ---------------------------------------------------------------------------


def _conv(p, x, prec: Precision):
    """NHWC conv, stride 1, 'same' padding, fp32."""
    w = p["w"].float()
    out = F.conv2d(_op(x.permute(0, 3, 1, 2), prec), _op(w, prec), padding=w.shape[-1] // 2).permute(0, 2, 3, 1)
    return out + p["b"].float() if "b" in p else out


def _bn(p, x, train: bool):
    """BatchNorm over all but the channel axis: the batch's biased
    statistics in training, the running ones in eval."""
    if train:
        dims = tuple(range(x.ndim - 1))
        mean = x.mean(dim=dims)
        var = (x * x).mean(dim=dims) - mean * mean
    else:
        mean, var = p["mean"], p["var"]
    return (x - mean) * (torch.rsqrt(var + 1e-5) * p["scale"]) + p["bias"]


def _block(p, x, relu: bool, prec: Precision, train: bool = False):
    short = _conv(p["shortcut"], x, prec) if "shortcut" in p else x
    y = _conv(p["conv1"], x, prec)
    if "bn1" in p:
        y = _bn(p["bn1"], y, train)
    y = _conv(p["conv2"], torch.relu(y), prec)
    if "bn2" in p:
        y = _bn(p["bn2"], y, train)
    y = y + short
    return torch.relu(y) if relu else y


def _lin(p, x, prec: Precision):
    out = _op(x, prec) @ _op(p["w"].float(), prec).t()
    return out + p["b"].float() if "b" in p else out


def sine_encoding(c: int, h: int, w: int, device) -> torch.Tensor:
    """LoFTR's 2-D sinusoidal position encoding (h, w, c), positions from 1."""
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    div = torch.exp(torch.arange(0, c // 2, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / (c // 2)))
    pe = torch.zeros(c, h, w, device=device)
    pe[0::4] = torch.sin(x[None] * div[:, None, None])
    pe[1::4] = torch.cos(x[None] * div[:, None, None])
    pe[2::4] = torch.sin(y[None] * div[:, None, None])
    pe[3::4] = torch.cos(y[None] * div[:, None, None])
    return pe.permute(1, 2, 0)


def _transformer(p, fmap, pos: bool, prec: Precision, nheads: int = 8):
    """LoFTR encoder layers with linear (elu + 1) attention, queries, keys and
    values from the same map."""
    b, h, w, c = fmap.shape
    if pos:
        fmap = fmap + sine_encoding(c, h, w, fmap.device)[None]
    x = fmap.reshape(b, h * w, c)
    d = c // nheads
    for lp in p["layers"]:
        q = F.elu(_lin(lp["q_proj"], x, prec).reshape(b, -1, nheads, d)) + 1.0
        k = F.elu(_lin(lp["k_proj"], x, prec).reshape(b, -1, nheads, d)) + 1.0
        v = _lin(lp["v_proj"], x, prec).reshape(b, -1, nheads, d) / (h * w)
        kv = torch.einsum("nshd,nshv->nhdv", _op(k, prec), _op(v, prec))
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", _op(q, prec), _op(k.sum(dim=1), prec)) + 1e-6)
        msg = torch.einsum("nlhd,nhdv->nlhv", _op(q, prec), _op(kv, prec)) * z[..., None] * (h * w)
        msg = F.layer_norm(_lin(lp["merge"], msg.reshape(b, -1, c), prec), (c,),
                           lp["norm1"]["scale"], lp["norm1"]["bias"], 1e-5)
        msg = _lin(lp["mlp_fc2"], torch.relu(_lin(lp["mlp_fc1"], torch.cat([x, msg], dim=-1), prec)), prec)
        x = x + F.layer_norm(msg, (c,), lp["norm2"]["scale"], lp["norm2"]["bias"], 1e-5)
    return x.reshape(b, h, w, c)


def _trunk(p, fmap, pos: bool, last_relu: bool, prec: Precision, train: bool):
    x = _block(p["resblock1"], fmap, True, prec, train)
    x = _block(p["resblock2"], x, True, prec, train)
    x = _block(p["resblock3"], x, True, prec, train)
    x = _transformer(p["att"], x, pos, prec)
    return _block(p["resblock4"], x, last_relu, prec, train)


def heads(params, fmap: torch.Tensor, cfg, prec: Precision, train: bool = False):
    """The heads on a (B, H, W, C) fp32 map -> (offsets (B, H, W, 2), depths
    (B, H, W, 1), scores (B, H, W, 1), descriptors (B, H, W, D)); ``train``:
    BatchNorm on the batch's statistics."""
    kp, dh = cfg["MICKEY"]["KP_HEADS"], cfg["MICKEY"]["DSC_HEAD"]
    s = _conv(params["det_head"]["out"], _trunk(params["det_head"], fmap, kp["POS_ENCODING"], True, prec, train), prec)
    b, h, w, _ = s.shape
    if kp["USE_SOFTMAX"]:
        shift = (s.detach().reshape(b, -1).mean(dim=-1) + 1e-16).reshape(b, 1, 1, 1)  # carries no gradient
        e = torch.exp((s - shift) / 100.0)
        border = torch.zeros(h, w, device=s.device)
        border[3:h - 3, 3:w - 3] = 1.0
        e = e * border[None, :, :, None]
        scores = e / (e.reshape(b, -1).sum(dim=-1).reshape(b, 1, 1, 1) + 1e-16)
    else:
        border = torch.zeros(h, w, device=s.device)
        border[3:h - 3, 3:w - 3] = 1.0
        scores = torch.sigmoid(s) * border[None, :, :, None]
    offsets = torch.sigmoid(_conv(params["det_offset"]["out"],
                                  _trunk(params["det_offset"], fmap, kp["POS_ENCODING"], True, prec, train), prec))
    depths = _conv(params["depth_head"]["out"],
                   _trunk(params["depth_head"], fmap, kp["POS_ENCODING"], True, prec, train), prec)
    if kp["USE_DEPTHSIGMOID"]:
        depths = kp["MAX_DEPTH"] * torch.sigmoid(depths)
    descs = _trunk(params["dsc_head"], fmap, dh["POS_ENCODING"], False, prec, train)
    if dh["NORM_DSC"]:
        descs = descs / torch.sqrt((descs * descs).sum(dim=-1, keepdim=True) + 1e-10)
    return offsets, depths, scores, descs


def extract(params, images: torch.Tensor, cfg, prec: Precision, chunk: int = 2, taps: Optional[dict] = None):
    """uint8 images (B, H, W, 3), already cut to multiples of the patch ->
    the four head maps, ``chunk`` images at a time; ``taps`` as
    ``backbone``'s, over all the images."""
    d = cfg["MICKEY"]["DINOV2"]
    heads_n = {"vit_small": 6, "vit_base": 12, "vit_large": 16, "vit_giant2": 24}[d["VARIANT"]]
    dtype = torch.bfloat16 if d["FLOAT16"] else torch.float32
    outs, parts = [], {k: [] for k in taps or ()}
    for i in range(0, images.shape[0], chunk):
        got = dict.fromkeys(parts)
        fmap = backbone(params["dinov2"], images[i:i + chunk], heads_n, d["DOWN_FACTOR"], dtype, prec,
                        got if taps is not None else None)
        for k in parts:
            parts[k].append(got[k])
        outs.append(heads(params, fmap, cfg, prec))
    for k in parts:
        taps[k] = torch.cat(parts[k])
    return tuple(torch.cat([o[j] for o in outs]) for j in range(4))


# -- matcher -------------------------------------------------------------------------


def keypoints(offsets: torch.Tensor, df: int) -> torch.Tensor:
    """Cell offsets (B, H, W, 2) -> absolute pixels (B, H*W, 2) as (x, y)."""
    b, h, w, _ = offsets.shape
    gx = torch.arange(w, dtype=offsets.dtype, device=offsets.device)[None, None, :]
    gy = torch.arange(h, dtype=offsets.dtype, device=offsets.device)[None, :, None]
    return torch.stack([(offsets[..., 0] + gx) * df, (offsets[..., 1] + gy) * df], dim=-1).reshape(b, h * w, 2)


def final_scores(dsc0, dsc1, scr0, scr1, dustbin, temperature: float, use_dustbin: bool,
                 prec: Precision) -> torch.Tensor:
    """Dual softmax of dsc0 dsc1^T / T with a dustbin row and column of logit
    ``dustbin`` (a float, or a tensor that carries its gradient), times the
    keypoint scores: (B, M, N) in ``prec.exact``."""
    dt = prec.exact
    s = (_op(dsc0.float(), prec).to(dt) @ _op(dsc1.float(), prec).to(dt).transpose(1, 2)) / temperature
    b, m, n = s.shape
    if use_dustbin:
        a = torch.as_tensor(dustbin, device=s.device).to(dt)
        lse_row = torch.logsumexp(torch.cat([s, a.expand(b, m, 1)], dim=2), dim=2)
        lse_col = torch.logsumexp(torch.cat([s, a.expand(b, 1, n)], dim=1), dim=1)
    else:
        lse_row, lse_col = torch.logsumexp(s, dim=2), torch.logsumexp(s, dim=1)
    p = torch.exp(2.0 * s - lse_row[:, :, None] - lse_col[:, None, :])
    return p * scr0.to(dt).reshape(b, m, 1) * scr1.to(dt).reshape(b, 1, n)


def topk_table(final: torch.Tensor, prefilter: int, row_topl: int):
    """Each row's ``row_topl`` largest final scores (negative and non-finite
    ones count as -1 and 0), then the ``prefilter`` largest of those
    candidates: (values (B, P) descending, flat indices i * N + j (B, P),
    row_ok (B,))."""
    b, m, n = final.shape
    flat = final.reshape(b, m * n)
    row_ok = torch.isfinite(flat).all(-1) & (flat >= 0).all(-1) & (flat.sum(-1) > 0)
    s = torch.where(torch.isfinite(final), final, torch.full_like(final, -1.0))
    v, j = torch.topk(s, row_topl, dim=-1)
    idx = torch.arange(m, device=final.device)[None, :, None] * n + j
    cand_v = torch.clamp(v, min=0.0).reshape(b, m * row_topl)
    cand_i = idx.reshape(b, m * row_topl)
    top_v, pos = torch.topk(cand_v, prefilter, dim=-1)
    return top_v, torch.gather(cand_i, 1, pos), row_ok


# -- solver --------------------------------------------------------------------------


def backproject(uv: torch.Tensor, depth: torch.Tensor, K: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Pixels (..., N, 2) and depths (..., N, 1) -> camera points (..., N, 3)."""
    dt = prec.exact
    uv1 = torch.cat([uv.to(dt), torch.ones_like(uv[..., :1], dtype=dt)], dim=-1)
    kinv = torch.linalg.inv(K.to(dt))
    return depth.to(dt) * torch.einsum("...ij,...nj->...ni", _op(kinv, prec), _op(uv1, prec))


def transform(R, t, X, prec: Precision):
    return torch.einsum("...ij,...nj->...ni", _op(R, prec), _op(X, prec)) + t


def soft_inliers(X, Y, R, t, th: float, prec: Precision) -> torch.Tensor:
    """sum over points of sigmoid((5 / th) (th - ||R X + t - Y||)), with
    MicKey's +1e-6 under the square root: (...)."""
    d = torch.sqrt(((transform(R, t, X, prec) - Y) ** 2).sum(dim=-1) + 1e-6)
    return torch.sigmoid((5.0 / th) * (th - d)).sum(dim=-1)


def hard_inliers(X, Y, R, t, th: float, prec: Precision) -> torch.Tensor:
    d = torch.sqrt(((transform(R, t, X, prec) - Y) ** 2).sum(dim=-1) + 1e-6)
    return (d <= th).to(X.dtype)


class _SVD(torch.autograd.Function):
    """H = U diag(S) V^T with Townsend's SVD differential in the backward,
    its gap inverse 1 / (s_j^2 - s_i^2) regularized as D / (D^2 + (1e-5 s_0^2)^2):
    exact where the singular values are apart, bounded where they (nearly)
    coincide, as near-collinear point sets make them. The training step
    defines its gradient so; the exact one is unbounded there."""

    @staticmethod
    def forward(ctx, H):
        U, S, Vh = torch.linalg.svd(H)
        V = Vh.transpose(-1, -2)
        ctx.save_for_backward(U, S, V)
        return U, S, V

    @staticmethod
    def backward(ctx, gU, gS, gV):
        U, S, V = ctx.saved_tensors
        gU = torch.zeros_like(U) if gU is None else gU
        gV = torch.zeros_like(V) if gV is None else gV
        gS = torch.zeros_like(S) if gS is None else gS
        s2 = S * S
        D = s2[..., None, :] - s2[..., :, None]
        reg = (1e-5 * (s2[..., 0:1, None] + 1e-30)) ** 2 + 1e-30
        Fg = D / (D * D + reg)
        UtgU = U.transpose(-1, -2) @ gU
        VtgV = V.transpose(-1, -2) @ gV
        term = (Fg * (UtgU - UtgU.transpose(-1, -2))) * S[..., None, :]
        term = term + S[..., :, None] * (Fg * (VtgV - VtgV.transpose(-1, -2))) + torch.diag_embed(gS)
        return U @ term @ V.transpose(-1, -2)


def kabsch(A, B, prec: Precision, w: Optional[torch.Tensor] = None):
    """R, t with B ~ A R^T + t; ``w`` (..., N) weights both the means (as
    normalized weights) and the covariance (as given). Returns (R, t (..., 1,
    3), valid: the covariance's second singular value above 1e-7 of the
    first)."""
    if w is None:
        a_mean, b_mean = A.mean(-2, keepdim=True), B.mean(-2, keepdim=True)
        cw = torch.ones_like(A[..., :1])
    else:
        wn = (w / (w.abs().sum(-1, keepdim=True) + 1e-16))[..., None]
        a_mean, b_mean = (wn * A).sum(-2, keepdim=True), (wn * B).sum(-2, keepdim=True)
        cw = w[..., None]
    H = _op(A - a_mean, prec).transpose(-1, -2) @ _op(cw * (B - b_mean), prec)
    U, S, V = _SVD.apply(H)
    d = torch.linalg.det(V @ U.transpose(-1, -2))
    V = torch.cat([V[..., :, :2], V[..., :, 2:] * d[..., None, None]], dim=-1)
    R = V @ U.transpose(-1, -2)
    t = b_mean - a_mean @ R.transpose(-1, -2)
    return R, t, S[..., 1] > 1e-7 * torch.clamp(S[..., 0], min=1e-20)


def _gumbel_topk(generator, logw: torch.Tensor, k: int) -> torch.Tensor:
    """The served path's draw of k positions without replacement: fp32
    uniforms from ``generator`` (one call of logw's shape), Gumbel noise,
    then k argmax rounds (k <= 8), a stable descending sort (4k >= N) or
    topk."""
    u = torch.rand(logw.shape, generator=generator, device=logw.device, dtype=torch.float32)
    g = logw + -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    if k <= 8:
        idx = []
        for _ in range(k):
            i = g.argmax(dim=-1, keepdim=True)
            idx.append(i)
            g = g.scatter(-1, i, float("-inf"))
        return torch.cat(idx, dim=-1)
    if 4 * k >= g.shape[-1]:
        return torch.sort(g, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.topk(g, k, dim=-1).indices


def _log_weights(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= torch.finfo(w.dtype).tiny, torch.log(torch.clamp(w, min=1e-30)), NEG_INF)


class Draws(NamedTuple):
    outer: torch.Tensor  # (it, B, S) table positions
    ridx: torch.Tensor  # (it, B, R, C) positions among a draw's S samples


def draw(generator, table: torch.Tensor, it: int, n_ransac: int, n_samples: int, n_corr: int) -> Draws:
    """The solver's two levels of draws from the (B, P) fp32 table, in the
    served path's order: ``it`` samples of ``n_samples`` positions, then
    ``n_ransac`` minimal sets of ``n_corr`` within each."""
    table = table.float()
    b, p = table.shape
    logw = _log_weights(table)
    if it * logw.numel() <= 1 << 26:
        outer = _gumbel_topk(generator, logw.expand(it, b, p), n_samples)
    else:
        outer = torch.stack([_gumbel_topk(generator, logw, n_samples) for _ in range(it)])
    w = torch.gather(table.expand(it, -1, -1), 2, outer)
    inner = _log_weights(w)[:, :, None, :].expand(it, b, n_ransac, n_samples)
    return Draws(outer, _gumbel_topk(generator, inner, n_corr))


def _rows(table, idx):
    return torch.gather(table, -2, idx[..., None].expand(*idx.shape, table.shape[-1]))


def sampled_points(draws: Draws, top_idx, kps0, depth0, kps1, depth1, K0, K1, prec: Precision):
    """(X, Y) of every draw's samples, (it, B, S, 3), in ``prec.exact``."""
    n1 = kps1.shape[1]
    X_all = backproject(kps0, depth0, K0, prec)
    Y_all = backproject(kps1, depth1, K1, prec)
    it = draws.outer.shape[0]
    flat = torch.gather(top_idx.long().expand(it, -1, -1), 2, draws.outer)
    return _rows(X_all.expand(it, -1, -1, -1), flat // n1), _rows(Y_all.expand(it, -1, -1, -1), flat % n1)


def hypothesis_scores(X, Y, draws: Draws, th_soft: float, prec: Precision):
    """Every minimal set's Kabsch pose and its soft-inlier score over its
    draw's samples: (R (it, B, R, 3, 3), t (it, B, R, 1, 3), score (it, B,
    R), invalid ones -1e30), one draw at a time."""
    Rs, ts, scores = [], [], []
    for i in range(X.shape[0]):
        ridx = draws.ridx[i]  # (B, R, C)
        b, nr, c = ridx.shape
        Xk = _rows(X[i], ridx.reshape(b, nr * c)).reshape(b, nr, c, 3)
        Yk = _rows(Y[i], ridx.reshape(b, nr * c)).reshape(b, nr, c, 3)
        R, t, ok = kabsch(Xk, Yk, prec)
        s = soft_inliers(X[i][:, None], Y[i][:, None], R, t, th_soft, prec)
        ok = ok & torch.isfinite(R).flatten(-2).all(-1) & torch.isfinite(t).flatten(-2).all(-1)
        scores.append(torch.where(ok, s, torch.full_like(s, NEG_INF)))
        Rs.append(R)
        ts.append(t)
    return torch.stack(Rs), torch.stack(ts), torch.stack(scores)


class Solve(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 1, 3)
    confidence: torch.Tensor  # (B,)
    valid: torch.Tensor  # (B,)
    weights: torch.Tensor  # (B, S) the best draw's table values


def solve(table, top_idx, row_ok, kps0, depth0, kps1, depth1, K0, K1, generator, pc, prec: Precision) -> Solve:
    """Procrustes RANSAC on the table: the best hypothesis of the best draw,
    ``NUM_REFINEMENTS`` refinements on its draw's hard inliers (each kept
    only where the inlier count grows), the soft-inlier confidence and the
    returned pose's hard inliers, and the zero pose where no hypothesis is
    valid."""
    d = draw(generator, table, pc["IT_MATCHES"], pc["IT_RANSAC"], pc["NUM_SAMPLED_MATCHES"], pc["NUM_CORR_3D_3D"])
    X, Y = sampled_points(d, top_idx, kps0, depth0, kps1, depth1, K0, K1, prec)
    Rh, th, score = hypothesis_scores(X, Y, d, pc["TH_SOFT_INLIER"], prec)
    it, b = score.shape[:2]
    best_r = score.argmax(dim=-1)  # (it, B)
    step = torch.gather(score, 2, best_r[..., None])[..., 0]
    best_it = step.argmax(dim=0)
    bi = torch.arange(b, device=score.device)
    R = Rh[best_it, bi, best_r[best_it, bi]]
    t = th[best_it, bi, best_r[best_it, bi]]
    Xb, Yb = X[best_it, bi], Y[best_it, bi]
    n_pre = torch.full((b,), float(pc["NUM_CORR_3D_3D"]), dtype=X.dtype, device=X.device)
    w_ref = torch.zeros_like(Xb[..., 0])
    for _ in range(pc["NUM_REFINEMENTS"]):
        inl = hard_inliers(Xb, Yb, R, t, pc["TH_INLIER"], prec)
        n = inl.sum(-1)
        do = (n >= pc["NUM_CORR_3D_3D"]) & (n > n_pre)
        n_pre = torch.where(do, n, n_pre)
        w_ref = torch.where(do[:, None], inl, w_ref)
        Rr, tr, _ = kabsch(Xb, Yb, prec, w=w_ref)
        R = torch.where(do[:, None, None], Rr, R)
        t = torch.where(do[:, None, None], tr, t)
    conf = soft_inliers(Xb, Yb, R, t, pc["TH_INLIER"], prec)
    hard_inliers(Xb, Yb, R, t, pc["TH_INLIER"], prec)  # the returned pose's mask, counted as the program counts it
    valid = (row_ok & torch.isfinite(R).flatten(1).all(-1) & torch.isfinite(t).flatten(1).all(-1)
             & (step.amax(dim=0) > NEG_INF / 2))
    zero = torch.zeros_like
    weights = torch.gather(table.float(), 1, d.outer[best_it, bi])
    return Solve(torch.where(valid[:, None, None], R, zero(R)), torch.where(valid[:, None, None], t, zero(t)),
                 torch.where(valid, conf, zero(conf)), valid, weights)


def quat_to_rot(q) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix, fp64."""
    q = torch.as_tensor(q, dtype=torch.float64)
    q = q / torch.linalg.norm(q)
    w, x, y, z = q.tolist()
    return torch.tensor([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                         [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                         [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]], dtype=torch.float64)
