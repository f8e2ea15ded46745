"""The solver's 3 x 3 SVD: the kernel (``csrc/svd3x3.cu``) and its plain version.

On the CPU ``geometry/kabsch.py::_svd3x3_primal`` takes the plain version,
``svd3x3_plain``, and launches nothing; the plain version is held against
numpy's fp64 SVD where fp32's squared column norms neither overflow nor
underflow. On the card (``cuda`` cases, skipped without one) the kernel is
held against the plain version bit for bit, NaN where NaN: it repeats each
of the plain version's operations in its order and rounding (the kernel's
source note), so any difference is a fault, not rounding. The cases and
checks are ``chip_smoke.py``'s (``svd_inputs``, ``svd_bitwise``,
``svd_solve_bitwise``). The file imports neither JAX nor ``mickey_tpu``: on
a machine with a card and no JAX, ``python -m pytest --noconftest
tests/test_torch_svd3x3.py`` runs it.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mickey_tpu_torch import default_config
from mickey_tpu_torch.geometry import kabsch
from mickey_tpu_torch.models import MickeyRelativePose
from mickey_tpu_torch.ops import _cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.SVD_SHAPES, ids=str)
@pytest.mark.parametrize("case", chip_smoke.SVD_CASES)
def test_kernel_matches_plain(cuda, case, shape):
    H = torch.from_numpy(chip_smoke.svd_inputs(case, shape)).to(cuda)
    before = _cuda.LAUNCHES["svd3x3"]
    out = kabsch.svd3x3(H)
    assert _cuda.LAUNCHES["svd3x3"] == before + 1
    assert [x.shape for x in out] == [shape + (3, 3), shape + (3,), shape + (3, 3)]
    chip_smoke.svd_bitwise(out, kabsch.svd3x3_plain(H), f"svd3x3 {case} {shape}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.SVD_SHAPES, ids=str)
def test_procrustes_and_gradient_through_kernel(cuda, shape):
    """R, t and valid of ``weighted_procrustes`` and the gradient of
    ``svd3x3`` through the kernel's forward: bit for bit the plain
    version's (the SVD is, and the rest is the same code)."""
    chip_smoke.svd_solve_bitwise(cuda, shape)


@pytest.mark.cuda
def test_estimate_launches_the_kernel_once_a_procrustes(cuda):
    """One ``MickeyRelativePose.estimate`` at a served batch: the minimal
    sets, then each refinement, one launch each."""
    cfg = default_config()
    corr, K0, K1 = chip_smoke.solver_inputs(cuda, pairs=8, kpts=1938, table=int(cfg.TPU.SAMPLING_PREFILTER))
    before = _cuda.LAUNCHES["svd3x3"]
    est = MickeyRelativePose(cfg, {}, device=cuda).estimate(corr, K0, K1, torch.Generator(device=cuda).manual_seed(0))
    assert _cuda.LAUNCHES["svd3x3"] - before == cfg.PROCRUSTES.NUM_REFINEMENTS + 1 == 5
    assert bool(torch.isfinite(est.R).all())


@pytest.mark.parametrize("case", chip_smoke.SVD_CASES)
def test_cpu_takes_the_plain_version(case):
    H = torch.from_numpy(chip_smoke.svd_inputs(case, (4, 5)))
    before = dict(_cuda.LAUNCHES)
    out = kabsch.svd3x3(H)
    assert _cuda.LAUNCHES == before
    chip_smoke.svd_bitwise(out, kabsch.svd3x3_plain(H), f"svd3x3 {case} on the CPU")


@pytest.mark.parametrize("case", chip_smoke.SVD_FINITE_CASES)
def test_plain_matches_numpy(case):
    """S and U diag(S) V^T against numpy's fp64 SVD of the same fp32
    matrices, within 1e-5 of each matrix's largest singular value: six fp32
    Jacobi sweeps reach a few fp32 ulps of the converged values. Singular
    vectors are compared only through the product: with repeated or zero
    singular values they are not unique."""
    H = chip_smoke.svd_inputs(case, (64,))
    U, S, V = (x.double().numpy() for x in kabsch.svd3x3_plain(torch.from_numpy(H)))
    H = H.astype(np.float64)
    ref = np.linalg.svd(H, compute_uv=False)
    tol = 1e-5 * ref[:, :1]
    assert (np.abs(S - ref) <= tol).all()
    assert (np.abs((U * S[:, None, :]) @ V.transpose(0, 2, 1) - H).max((1, 2)) <= tol[:, 0]).all()
    assert (np.diff(S, axis=-1) <= 0).all()
