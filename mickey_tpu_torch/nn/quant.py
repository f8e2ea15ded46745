"""Int8 post-training quantization of the frozen DINOv2 backbone
(``mickey_tpu/nn/quant.py``), under ``MICKEY.DINOV2.INT8``.

- Weights: symmetric per-output-channel int8, quantized once when the
  inference model is built (``vit_quantize_int8``). In the port's (out, in)
  layout the absmax runs over ``in``: ``w_q`` int8 (out, in) contiguous,
  ``w_s`` fp32 (out,).
- Activations: symmetric per-token dynamic absmax int8 on ``x.float()``,
  rounded half to even.
- Product: int8 x int8 -> int32. On the card it is ``torch._int_mm`` (cuBLASLt's
  int8 tensor-core GEMM; the JAX package computes it as an XLA ``dot_general``,
  not in a Pallas kernel); on the CPU it is ``int_mm_plain``, an fp64 product,
  exact because every partial sum is an integer below 2^53.
- Dequantization in the JAX package's order: ``y * (a_s * w_s)``, then the
  bias, then the input's dtype.

Only the transformer-block linears are quantized (qkv, proj, fc1, fc2, w12,
w3). Patch embedding, LayerNorms, LayerScale and attention keep their dtype.
"""

from __future__ import annotations

import torch

from .common import linear

_QUANT_KEYS = ("qkv", "proj", "fc1", "fc2", "w12", "w3")
_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes M > 16 rows


def quantize_linear_int8(p):
    """{"w": (out, in)[, "b"]} -> {"w_q": int8 (out, in), "w_s": fp32 (out,)[, "b"]}."""
    w = p["w"].float()
    scale = (w.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    out = {"w_q": torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8).contiguous(), "w_s": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_rows_int8(x: torch.Tensor):
    """Per-row dynamic absmax of (M, K) activations: (x_q int8, a_s fp32 (M, 1))."""
    xf = x.float()
    a_s = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(xf / a_s).clamp(-127, 127).to(torch.int8), a_s


def int_mm_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) @ w_q (N, K)^T as int32, through an exact fp64 product."""
    return (x_q.double() @ w_q.double().t()).to(torch.int32)


def int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int32 product x_q (M, K) @ w_q (N, K)^T: ``torch._int_mm`` on a CUDA
    tensor (rows padded with zeros to its minimum of 17), the plain version
    on a CPU tensor."""
    if not x_q.is_cuda:
        return int_mm_plain(x_q, w_q)
    m = x_q.shape[0]
    if m < _INT_MM_MIN_ROWS:
        x_q = torch.cat([x_q, x_q.new_zeros(_INT_MM_MIN_ROWS - m, x_q.shape[1])])
    return torch._int_mm(x_q.contiguous(), w_q.t())[:m]


def linear_int8(p, x: torch.Tensor) -> torch.Tensor:
    """Dynamic per-token int8 linear: (x_q @ w_q^T) * a_s * w_s + b, in x's dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_q, a_s = quantize_rows_int8(x.reshape(-1, k))
    out = int_mm(x_q, p["w_q"]).float() * (a_s * p["w_s"])
    if "b" in p:
        out = out + p["b"]
    return out.to(x.dtype).reshape(*lead, -1)


def maybe_linear(p, x: torch.Tensor) -> torch.Tensor:
    """The int8 linear where the tree was quantized, else the plain one."""
    return linear_int8(p, x) if "w_q" in p else linear(p, x)


def vit_quantize_int8(params):
    """A ViT tree (``weights.params_to_torch``'s ``dinov2``) with its block
    linears quantized; the other leaves are shared, not copied. Idempotent:
    a quantized tree comes back unchanged."""
    if "w_q" in params["blocks"][0]["attn"]["qkv"]:
        return params

    def q(sub):
        return {k: (quantize_linear_int8(v) if k in _QUANT_KEYS else v) for k, v in sub.items()}

    return dict(params, blocks=[dict(bp, attn=q(bp["attn"]), mlp=q(bp["mlp"])) for bp in params["blocks"]])
