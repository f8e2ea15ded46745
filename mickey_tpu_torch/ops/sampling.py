"""Weighted sampling without replacement via Gumbel top-k.

Port of ``mickey_tpu/ops/sampling.py`` driven by a ``torch.Generator``
instead of a JAX key. The two give different numbers from the same seed, so
the parity tests replay JAX's draws and inject the indices (see
``solver.procrustes_ransac``).
"""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """-log(-log(U)) with U uniform on [tiny, 1), as jax.random.gumbel."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_topk_sample(generator: Optional[torch.Generator], log_weights: torch.Tensor,
                       k: int) -> torch.Tensor:
    """k indices (..., k) drawn without replacement with probability
    proportional to exp(log_weights) (..., N)."""
    perturbed = log_weights + gumbel_noise(log_weights.shape, generator, log_weights.device)
    if k <= 8:
        # k rounds of argmax + mask: cheaper than a sort for minimal sets
        idxs = []
        for _ in range(k):
            i = perturbed.argmax(dim=-1, keepdim=True)
            idxs.append(i)
            perturbed = perturbed.scatter(-1, i, float("-inf"))
        idx = torch.cat(idxs, dim=-1)
    elif 4 * k >= perturbed.shape[-1]:
        idx = torch.sort(perturbed, dim=-1, descending=True, stable=True).indices[..., :k]
    else:
        idx = torch.topk(perturbed, k, dim=-1).indices
    return idx.to(torch.int32)


def gumbel_topk_sample_draws(generator: Optional[torch.Generator], log_weights: torch.Tensor,
                             k: int, draws: int, max_elems: int = 1 << 26) -> torch.Tensor:
    """``draws`` independent samples: (draws, *batch, k) int32. One batched
    top-k while the perturbed (draws, *batch, N) tensor stays within
    ``max_elems`` elements (256 MB of fp32); above that (the exact regime
    over a whole N0 x N1 match matrix, no prefilter) one draw at a time, so
    the peak is one (*batch, N) noise tensor. The distribution is the same
    either way: the noise is iid across draws."""
    if draws * log_weights.numel() <= max_elems:
        return gumbel_topk_sample(generator, log_weights.expand((draws,) + log_weights.shape), k)
    return torch.stack([gumbel_topk_sample(generator, log_weights, k) for _ in range(draws)])
