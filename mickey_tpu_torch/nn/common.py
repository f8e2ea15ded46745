"""NN primitives on plain parameter dicts (``mickey_tpu/nn/common.py``).

Activations stay NHWC at every public function, as in the JAX package, so
tests compare like with like. Parameters arrive already in PyTorch layout
(``weights.params_to_torch``): conv weights OIHW, linear weights
(out, in).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import parallel


def conv2d(p, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, Cin) -> (B, H, W, Cout); stride 1, 'SAME' padding."""
    w = p["w"].to(x.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2).permute(0, 2, 3, 1)
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out


def batchnorm(p, x: torch.Tensor, train: bool = False, momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm over all but the channel (last) axis, in the JAX op order.

    Returns (out, new_state). In train mode it normalizes with the batch's
    biased variance and advances the running stats by an EMA of ``momentum``
    with the unbiased variance (torch.nn.BatchNorm2d semantics); the new
    stats carry no gradient. In eval mode new_state is ``p``.

    Inside a data-parallel step (``parallel.global_batch``) the statistics
    are the global batch's: the sums and sums of squares are all-reduced
    with their gradients and the count is every rank's."""
    if train:
        dims = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        step = parallel.active()
        if step is None:
            mean = x.mean(dim=dims)
            var = (x * x).mean(dim=dims) - mean * mean
        else:
            c = x.shape[-1]
            sums = parallel.all_reduce_sum(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims)]), step.dp)
            n *= step.dp.size
            mean = sums[:c] / n
            var = sums[c:] / n - mean * mean
        unbiased = var.detach() * n / max(n - 1, 1)
        new_p = dict(p)
        new_p["mean"] = (1 - momentum) * p["mean"] + momentum * mean.detach().float()
        new_p["var"] = (1 - momentum) * p["var"] + momentum * unbiased.float()
    else:
        mean, var, new_p = p["mean"], p["var"], p
    inv = torch.rsqrt(var.to(x.dtype) + eps) * p["scale"].to(x.dtype)
    return (x - mean.to(x.dtype)) * inv + p["bias"].to(x.dtype), new_p


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    return out * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    b = p.get("b")
    return F.linear(x, p["w"].to(x.dtype), None if b is None else b.to(x.dtype))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-10) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=dim, keepdim=True) + eps)
