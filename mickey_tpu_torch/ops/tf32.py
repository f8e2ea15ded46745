"""The TF32 split of the port's 3xTF32 kernels, on the CPU.

The fp32-accurate kernels (K1f in ``csrc/flash_attention_f32.cu``; K2a, K2b,
K4, K5 and K6 on the correlation engine of ``csrc/corr_tf32.cuh``) split every
fp32 operand into two TF32 values and run each product as three TF32 passes
on the tensor cores. These functions repeat that split bit for bit, so that
the plain versions that mimic the kernels' arithmetic
(``attention_3xtf32_plain``, ``corr_3xtf32_plain`` and the matcher's
``*_3xtf32_plain``) can be held against the JAX package on the CPU.

K5's and K6's second product, dd = dS X_oth, splits dS in registers by the
descriptors' rule (``desc_split``), not by ``tf32_split``: X_oth is split by
that rule, and against an infinite X_oth value only a hi truncated to x's
sign, with a lo of the same sign (2^-126 for an exact TF32 value), gives the
fp32 product's +-inf in all three passes; a lo of the other sign would give
inf - inf, a lo of 0 would give 0 * inf, both NaN. Its extra error (a hi
within 2^-10 of x instead of 2^-11) is lost in lo: x - hi - lo stays within
2^-21 |x|. Two infinities meet as 0 * inf in a lo pass, NaN where fp32 gives
+-inf, in the correlation as in dd.
"""

from __future__ import annotations

import torch


def _rna(y: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero (``cvt.rna.tf32.f32``)."""
    return ((y.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """fp32 ``x`` -> (hi, lo), both TF32 values (10 mantissa bits) in fp32:
    hi = x rounded to nearest TF32, ties away from zero (``cvt.rna.tf32.f32``,
    done here on the bits), lo = the same rounding of x - hi (exact in fp32).
    x - hi - lo is within 2^-22 |x|."""
    hi = _rna(x)
    return hi, _rna(x - hi)


def desc_split(x: torch.Tensor):
    """The correlation engine's split of a descriptor (``split_desc`` in
    ``csrc/corr_tf32.cuh``): hi = x truncated to TF32 (its low 13 bits
    cleared), lo = x - hi rounded to nearest, so x, hi and lo have one sign
    and x - hi - lo is within 2^-21 |x|. Where hi is not finite lo is 0
    (inf - inf would be NaN); where x is a nonzero TF32 value lo is 2^-126
    with x's sign, not 0. So against an infinite value of the other operand
    every pass of lo*hi + hi*lo + hi*hi is an infinity of the fp32 product's
    sign: a lo of the other sign would make inf - inf, a lo of 0 would make
    0 * inf, both NaN where the fp32 product is +-inf."""
    hi = (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    lo = _rna(x - hi)
    tiny = torch.copysign(torch.full_like(hi, 2.0 ** -126), hi)
    lo = torch.where((lo == 0) & (hi != 0), tiny, lo)
    return hi, torch.where(torch.isfinite(hi), lo, torch.zeros_like(lo))
