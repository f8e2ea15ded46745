"""Weighted sampling without replacement via Gumbel top-k.

Port of ``mickey_tpu/ops/sampling.py`` driven by a ``torch.Generator``
instead of a JAX key: ``gumbel_topk_sample``, ``gumbel_topk_sample_draws``
and the public ``weighted_sample_without_replacement`` (torch.multinomial
without replacement). The JAX package's ``approx`` option (``approx_max_k``
for large k) is not taken: off a TPU it returns the exact top-k. The two
PRNGs give different numbers from the same seed, so the parity tests replay
JAX's draws and inject the indices (see ``solver.procrustes_ransac``).

Inside a data-parallel step (``parallel.global_batch``) a call that names
its ``batch_axis`` draws the noise of the whole global batch from the
generator, which every rank holds alike, and keeps this rank's rows: N ranks
draw what one process draws for the global batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import parallel


def gumbel_noise(shape, generator: Optional[torch.Generator], device,
                 batch_axis: Optional[int] = None) -> torch.Tensor:
    """-log(-log(U)) with U uniform on [tiny, 1), as jax.random.gumbel.
    ``batch_axis``: the axis of the pairs, whose global rows a data-parallel
    step draws (module docstring)."""
    step = parallel.active() if batch_axis is not None else None
    if step is None:
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        if shape[batch_axis] != step.hi - step.lo:
            raise ValueError(f"noise of shape {tuple(shape)}: axis {batch_axis} holds {shape[batch_axis]} "
                             f"rows, this rank has {step.hi - step.lo}")
        full = list(shape)
        full[batch_axis] = step.size
        u = torch.rand(full, generator=generator, device=device, dtype=torch.float32)
        u = u.narrow(batch_axis, step.lo, step.hi - step.lo)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_topk_sample(generator: Optional[torch.Generator], log_weights: torch.Tensor,
                       k: int, batch_axis: Optional[int] = None) -> torch.Tensor:
    """k indices (..., k) drawn without replacement with probability
    proportional to exp(log_weights) (..., N)."""
    perturbed = log_weights + gumbel_noise(log_weights.shape, generator, log_weights.device, batch_axis)
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
                             k: int, draws: int, max_elems: int = 1 << 26,
                             batch_axis: Optional[int] = None) -> torch.Tensor:
    """``draws`` independent samples: (draws, *batch, k) int32. One batched
    top-k while the perturbed (draws, *batch, N) tensor stays within
    ``max_elems`` elements (256 MB of fp32); above that (the exact regime
    over a whole N0 x N1 match matrix, no prefilter) one draw at a time, so
    the peak is one (*batch, N) noise tensor. The distribution is the same
    either way: the noise is iid across draws. A data-parallel step decides
    on the global batch's size, as one process would."""
    numel = log_weights.numel()
    step = parallel.active() if batch_axis is not None else None
    if step is not None:
        numel = numel // (step.hi - step.lo) * step.size
    if draws * numel <= max_elems:
        return gumbel_topk_sample(generator, log_weights.expand((draws,) + log_weights.shape), k,
                                  None if batch_axis is None else batch_axis + 1)
    return torch.stack([gumbel_topk_sample(generator, log_weights, k, batch_axis) for _ in range(draws)])


NEG_INF = -1e30


def sample_log_weights(weights: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """log(weights) where positive (floored at ``eps``), -1e30 elsewhere, as
    the JAX package's ``weighted_sample_without_replacement`` forms them. A
    subnormal weight counts as 0, as there: XLA flushes subnormals to zero
    on the CPU and the TPU alike."""
    positive = weights >= torch.finfo(weights.dtype).tiny
    return torch.where(positive, torch.log(torch.clamp(weights, min=eps)), NEG_INF)


def weighted_sample_without_replacement(generator: Optional[torch.Generator], weights: torch.Tensor, k: int,
                                        eps: float = 1e-30) -> torch.Tensor:
    """``torch.multinomial(weights, k)`` without replacement, as the JAX
    package's public sampler (``mickey_tpu/ops/sampling.py:100``): k indices
    (..., k) int32 drawn with probability proportional to the nonnegative
    ``weights`` (..., N); zero weights are never drawn while enough positive
    ones remain."""
    return gumbel_topk_sample(generator, sample_log_weights(weights, eps), k)
