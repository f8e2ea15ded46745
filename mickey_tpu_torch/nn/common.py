"""NN primitives on plain parameter dicts (``mickey_tpu/nn/common.py``).

Activations stay NHWC at every public function, as in the JAX package, so
tests compare like with like. Parameters arrive already in PyTorch layout
(``weights.params_to_torch``): conv weights OIHW, linear weights
(out, in).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .. import parallel

# Rounded convs (conv2d's compute_dtype) on the card run cuDNN with TF32
# allowed for that call; ``rounded_convs_plain`` turns it off.
_ROUNDED_TF32 = [True]


@contextlib.contextmanager
def rounded_convs_plain():
    """Within it, conv2d's rounded convs on the card take cuDNN's fp32
    kernels (TF32 off): the plain version of the mode, for holding it and
    timing it against."""
    _ROUNDED_TF32[0] = False
    try:
        yield
    finally:
        _ROUNDED_TF32[0] = True


@contextlib.contextmanager
def _tf32_convs(on: bool):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv2d(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """x (B, H, W, Cin) -> (B, H, W, Cout); stride 1, 'SAME' padding.

    ``compute_dtype`` (bf16, ``TPU.HEADS_BF16``) rounds only the product's
    operands, x and the weights, to nearest even, as JAX's ``astype``; the
    sums stay fp32 and so does the output (the JAX package's
    ``preferred_element_type``). Gradients flow through the rounding as
    through JAX's cast: the conv's backward in fp32 at the rounded operands,
    its gradients rounded to bf16 on their way back. On the card the conv
    runs in cuDNN with TF32 allowed for this call only: bf16 values are
    exact in TF32, so every product is exact; the tensor cores' fp32 sums
    truncate. Elsewhere the port keeps TF32 off (``models.builder``)."""
    w = p["w"].to(x.dtype)
    rounded = compute_dtype is not None and x.dtype != compute_dtype
    if rounded:
        x, w = (t.to(compute_dtype).to(t.dtype) for t in (x, w))
    with _tf32_convs(_ROUNDED_TF32[0]) if rounded and x.is_cuda else contextlib.nullcontext():
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
