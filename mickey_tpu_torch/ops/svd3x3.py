"""The 3 x 3 SVD of the solver's covariances in one launch: ``csrc/svd3x3.cu``.

It replaces no TPU kernel: XLA fuses the JAX package's Jacobi SVD, and eager
PyTorch runs it as ~830 launches a call (the kernel's source note). Its plain
version is ``geometry/kabsch.py::svd3x3_plain``, which repeats the kernel's
arithmetic op for op; ``geometry/kabsch.py::_svd3x3_primal`` takes the plain
version for a CPU tensor and this wrapper for any other.
"""

from __future__ import annotations

import torch

from . import _cuda


def svd3x3(H: torch.Tensor):
    """H (..., 3, 3) on the card -> fp32 (U, S, V): U (..., 3, 3) with
    columns [u0, u1, u2], S (..., 3) descending, V (..., 3, 3); H ~= U
    diag(S) V^T."""
    Hf = H.float().contiguous()
    lead = tuple(Hf.shape[:-2])
    _cuda.require(Hf, "H", torch.float32, lead + (3, 3), H.device)
    U, V = torch.empty_like(Hf), torch.empty_like(Hf)
    S = torch.empty(lead + (3,), dtype=torch.float32, device=H.device)
    n = Hf.numel() // 9
    if n:
        rc = _cuda.lib().mk_svd3x3_f32(Hf.data_ptr(), U.data_ptr(), S.data_ptr(), V.data_ptr(), n,
                                       _cuda.stream_ptr(Hf))
        _cuda.check(rc, "svd3x3")
        _cuda.LAUNCHES["svd3x3"] += 1
    return U, S, V
