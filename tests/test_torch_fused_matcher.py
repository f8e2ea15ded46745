"""K2a / K2b, the fused matcher -> top-K route: the port against mickey_tpu.

The plain versions (the CPU path) are held against the JAX Pallas kernels in
interpret mode: candidate tables with the selection semantics (first index
on exact ties, NaN rows clamped to the last column, flat index i*N + j), the
final top-P table and the validity bit. fp32 throughout; values at 1e-5
relative (the correlation is summed in another order), indices exactly
where values are distinct. The CUDA kernels are held against the plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mickey_tpu.ops import fused_matcher as jfm
from mickey_tpu_torch.nn.matcher import dual_softmax
from mickey_tpu_torch.ops import fused_matcher as fm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(b=2, m=100, n=90, c=32, seed=0, ties=False, nan=False):
    rng = np.random.default_rng(seed)
    d0 = rng.standard_normal((b, m, c)).astype(np.float32)
    d1 = rng.standard_normal((b, n, c)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    s0 = rng.uniform(0, 1, (b, m)).astype(np.float32)
    s1 = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if ties:  # columns 7 and 3 identical: every row ties them exactly
        d1[:, 7], s1[:, 7] = d1[:, 3], s1[:, 3]
    if nan:  # pair 0 poisoned, pair 1 fine
        d0[0, 5] = np.nan
    return d0, d1, s0, s1


@pytest.mark.parametrize("ties,nan", [(False, False), (True, False), (False, True)])
def test_candidate_table_matches_jax_interpret(ties, nan):
    d0, d1, s0, s1 = _inputs(ties=ties, nan=nan)
    L, M = 16, d0.shape[1]
    cv, ci, ok, _, lse_col = jfm._topk_candidates(
        *(jnp.asarray(a) for a in (d0, d1, s0, s1)), jnp.float32(0.7),
        0.1, True, L, 128, True,
    )
    cv = np.asarray(cv).reshape(2, L, -1)[:, :, :M]
    ci = np.asarray(ci).reshape(2, L, -1)[:, :, :M]
    t = [torch.from_numpy(a) for a in (d0, d1, s0, s1)]
    lse_c = fm.col_lse(t[0], t[1], 10.0, 0.7)
    vals, idxs, stats, _ = fm.pair_topk(*t, lse_c, 10.0, 0.7, L)
    np.testing.assert_allclose(lse_c.numpy(), np.asarray(lse_col)[:, 0, : d1.shape[1]], rtol=1e-5)
    np.testing.assert_allclose(vals.numpy(), cv, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(idxs.numpy(), ci)
    row_ok = (stats[..., 1].sum(-1) == 0) & (stats[..., 2].amin(-1) >= 0) & (stats[..., 0].sum(-1) > 0)
    np.testing.assert_array_equal(row_ok.numpy(), np.asarray(ok))
    if nan:
        assert not row_ok[0] and row_ok[1]


def test_route_matches_jax_interpret_and_dense_oracle():
    d0, d1, s0, s1 = _inputs(seed=3)
    P, L = 200, 16
    jv, ji, jok = jfm.fused_topk_scores(*(jnp.asarray(a) for a in (d0, d1, s0, s1)), jnp.float32(1.0), P,
                                        temperature=0.1, row_topl=L, block_m=128, interpret=True)
    t = [torch.from_numpy(a) for a in (d0, d1, s0, s1)]
    v, i, ok = fm.fused_topk_scores(*t, 1.0, P, row_topl=L)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5)
    for b in range(2):  # distinct random values: the same entries
        assert set(i[b].tolist()) == set(np.asarray(ji)[b].tolist())
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    dense = dual_softmax(t[0], t[1], 1.0) * t[2][:, :, None] * t[3][:, None, :]
    ov, oi, ook = fm.dense_topk_scores(dense, P, row_topl=L)
    np.testing.assert_allclose(v.numpy(), ov.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(ook.numpy(), ok.numpy())


def test_dual_softmax_matches_jax():
    from mickey_tpu.config import default_config
    from mickey_tpu.nn.matcher import dual_softmax as jax_dual_softmax

    d0, d1, _, _ = _inputs(seed=4)
    ref = jax_dual_softmax({"dustbin_score": jnp.float32(1.0)}, jnp.asarray(d0), jnp.asarray(d1), default_config())
    out = dual_softmax(torch.from_numpy(d0), torch.from_numpy(d1), 1.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("ties,nan", [(False, False), (True, False), (False, True)])
def test_kernels_match_plain(cuda, ties, nan):
    d0, d1, s0, s1 = (torch.from_numpy(a).to(cuda) for a in _inputs(m=1938, n=1938, c=128, ties=ties, nan=nan))
    lse_c = fm.col_lse(d0, d1, 10.0, 1.0)
    lse_p = fm.col_lse_plain(d0, d1, 10.0, 1.0)
    out = fm.pair_topk(d0, d1, s0, s1, lse_p, 10.0, 1.0, 16)
    ref = fm.pair_topk_plain(d0, d1, s0, s1, lse_p, 10.0, 1.0, 16)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse_c, lse_p, rtol=1e-5, atol=1e-5, equal_nan=True)
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=1e-9, equal_nan=True)
    if ties or nan:  # the selection semantics: exact where the inputs tie exactly
        assert (out[1] == ref[1]).float().mean().item() > 0.999


# -- K2a's arithmetic: 3xTF32 on the correlation engine ------------------------------

# (B, M, N, C): ragged tiles, a single row, the production depth
TF32_SHAPES = [(2, 37, 45, 16), (1, 129, 65, 128), (2, 1, 70, 128)]


def _jax_forward(d0, d1, use_dustbin):
    """lse_col (B, N), P (B, M, N), lse_row (B, M) of the JAX package's
    forward (``_forward_padded``, Pallas in interpret mode), cropped."""
    b, m, _ = d0.shape
    n = d1.shape[1]
    p0, p1, alpha = jfm._pad_inputs(jnp.asarray(d0), jnp.asarray(d1), jnp.float32(0.7), use_dustbin, 128)
    out, lse_row, lse_col = jfm._forward_padded(p0, p1, alpha, 10.0, m, n, 128, True)
    return (np.asarray(lse_col)[:, 0, :n], np.asarray(out)[:, :m, :n], np.asarray(lse_row).reshape(b, -1)[:, :m])


def _ratio(out, ref, rtol):
    """max |out - ref| over the kernels' bound rtol |ref| + 1e-6 max|ref|
    (chip_smoke's RTOL / DS_RTOL checks): <= 1 passes."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return (np.abs(out - ref) / (rtol * np.abs(ref) + 1e-6 * np.abs(ref).max())).max()


@pytest.mark.parametrize("use_dustbin", [True, False])
@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_col_lse_3xtf32_plain_matches_jax_interpret(shape, use_dustbin):
    """K2a's arithmetic (descriptors split once, lo*hi + hi*lo, then hi*hi)
    against the JAX kernel's lse_col at RTOL (1e-5 |ref| + 1e-6 max|ref|);
    one TF32 pass (hi*hi alone) is the negative control that misses it."""
    b, m, n, c = shape
    d0, d1, _, _ = _inputs(b, m, n, c, seed=20 + m)
    ref = _jax_forward(d0, d1, use_dustbin)[0]
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    alpha = fm._alpha(0.7, use_dustbin)
    assert _ratio(fm.col_lse_3xtf32_plain(t0, t1, 10.0, alpha), ref, 1e-5) <= 1.0
    assert _ratio(fm.col_lse_3xtf32_plain(t0, t1, 10.0, alpha, passes=1), ref, 1e-5) > 1.0


def test_desc_split_keeps_an_inf_descriptor_infinite():
    """An infinite descriptor value gives the fp32 product's +-inf scores
    through the engine's split: hi truncated (x, hi and lo of one sign), lo
    0 where hi is infinite and 2^-126 with x's sign where x is an exact TF32
    number. NaN stays NaN. The attention kernels' split (hi rounded to
    nearest) gives NaN there: its lo of an infinity is NaN, and with that lo
    set to 0 a lo of the other sign still makes inf - inf."""
    from mickey_tpu_torch.ops.tf32 import desc_split, tf32_split

    d0, d1, _, _ = _inputs(1, 6, 9, 16, seed=5)
    d0[0, 2, 3] = np.inf
    d0[0, 4, 0] = np.nan
    d1[0, :2, 3] = [0.5, -0.75]  # exact in TF32: lo would be 0
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    ref = fm._correlation(t0, t1, 10.0)
    assert torch.isinf(ref[0, 2]).all() and torch.isnan(ref[0, 4]).all()
    torch.testing.assert_close(fm.corr_3xtf32_plain(t0, t1, 10.0), ref, rtol=1e-5, atol=1e-5, equal_nan=True)
    hi, lo = desc_split(t1)
    assert ((torch.sign(hi) == torch.sign(t1)) & (torch.sign(lo) == torch.sign(t1))).all()
    assert lo[0, :2, 3].tolist() == [2.0 ** -126, -(2.0 ** -126)]
    assert desc_split(torch.tensor([np.inf, -np.inf, 0.0]))[1].tolist() == [0.0, 0.0, 0.0]

    def product(split):
        (ah, al), (bh, bl) = split(t0), split(t1)
        return (al @ bh.transpose(1, 2) + ah @ bl.transpose(1, 2)) + ah @ bh.transpose(1, 2)

    assert torch.isnan(product(tf32_split)[0, 2]).all()

    def rna_lo0(x):
        hi, lo = tf32_split(x)
        return hi, torch.where(torch.isfinite(hi), lo, torch.zeros_like(lo))

    assert torch.isnan(product(rna_lo0)[0, 2]).any()


def test_corr_geometry():
    """The engine's tensor maps: a (B, rows, 128) fp32 scratch array as
    dims (32, rows, 4, 1, B) with byte strides (512, 128, rows 512, rows 512)
    and a box of 64 rows of all four 128-byte blocks; own map first."""
    geom = list(fm.corr_geometry(2, 1938, 129))
    own = [32, 1938, 4, 1, 2, 512, 128, 1938 * 512, 1938 * 512, 32, 64, 4, 1, 1]
    oth = [32, 129, 4, 1, 2, 512, 128, 129 * 512, 129 * 512, 32, 64, 4, 1, 1]
    assert geom == own + oth
    assert list(fm.corr_geometry(1, 1, 64))[:14] == [32, 1, 4, 1, 1, 512, 128, 512, 512, 32, 64, 4, 1, 1]


def test_col_lse_chunks():
    """K2a's chunks of dsc0's rows fill one wave at one CTA an SM: 2 x 31
    column tiles x 2 chunks = 124 CTAs on 132 SMs at the serving shape; the
    training shape (8 x 31 tiles) needs none; never more than a chunk per
    64 rows; every chunk the same number of row tiles and none empty (5 row
    tiles for 4 wanted chunks: 3 chunks of 2)."""
    assert fm.col_lse_chunks(132, 2, 1938, 1938) == 2
    assert fm.col_lse_chunks(132, 8, 1938, 1938) == 1
    assert fm.col_lse_chunks(132, 1, 70, 64) == 2
    assert fm.col_lse_chunks(132, 1, 1, 1) == 1
    assert fm.col_lse_chunks(132, 1, 320, 1920) == 3


# -- K2b's arithmetic: 3xTF32 on the correlation engine, the selection in lists ------


def _topk_inputs(shape, case, seed):
    """Seeded unit descriptors and uniform scores of ``shape`` (B, M, N, C):
    ``ties`` makes column 7 a copy of column 3 (every row ties them
    exactly), ``nan`` poisons row 5 of pair 0, ``nan_last`` makes scr1's
    last entry NaN (the rows' only NaN, in their last column)."""
    b, m, n, c = shape
    d0, d1, s0, s1 = _inputs(b, m, n, c, seed=seed, ties=case == "ties")
    if case == "nan":
        d0[0, min(5, m - 1)] = np.nan
    if case == "nan_last":
        s1[:, n - 1] = np.nan
    return d0, d1, s0, s1


def _rounds_exact_where_apart(idx, ref_idx, ref_vals, rel=1e-4):
    """Rounds (B, L, M) whose reference value is apart from each other
    value of its row's rounds by ``rel`` (relative), ties exactly, or is
    NaN: the same index."""
    v = ref_vals.transpose(0, 2, 1).astype(np.float64)
    with np.errstate(invalid="ignore"):
        gap = np.abs(v[..., :, None] - v[..., None, :])
    gap = np.where(np.eye(v.shape[-1], dtype=bool), np.inf, gap)
    gap = np.nan_to_num(gap, nan=np.inf).min(-1)
    keep = (gap > rel * np.abs(v)) | (gap == 0) | np.isnan(v)
    np.testing.assert_array_equal(np.where(keep, idx.transpose(0, 2, 1), 0), np.where(keep, ref_idx.transpose(0, 2, 1), 0))


@pytest.mark.parametrize("case", ["plain", "ties", "nan", "nan_last"])
@pytest.mark.parametrize("shape", TF32_SHAPES)
def test_pair_topk_3xtf32_plain_matches_jax_interpret(shape, case):
    """K2b's arithmetic (the engine's correlation, f in the JAX order, the
    selection in lists merged by rank) against the JAX kernel's candidate
    table on the JAX lse_col: values at RTOL (1e-5 |ref| + 1e-6 max|ref|)
    with NaN where the JAX kernel has it, indices exact where values are
    apart or tie exactly; one TF32 pass misses RTOL (negative control)."""
    b, m, n, c = shape
    d0, d1, s0, s1 = _topk_inputs(shape, case, seed=40 + m)
    L = 16
    cv, ci, _, _, lse_col = jfm._topk_candidates(*(jnp.asarray(a) for a in (d0, d1, s0, s1)), jnp.float32(0.7),
                                                 0.1, True, L, 128, True)
    ref_v = np.asarray(cv).reshape(b, L, -1)[:, :, :m]
    ref_i = np.asarray(ci).reshape(b, L, -1)[:, :, :m]
    lc = torch.from_numpy(np.array(lse_col)[:, 0, :n])
    t = [torch.from_numpy(a) for a in (d0, d1, s0, s1)]
    v, i, stats, _ = fm.pair_topk_3xtf32_plain(*t, lc, 10.0, 0.7, L)
    v = v.numpy()
    np.testing.assert_array_equal(np.isnan(v), np.isnan(ref_v))
    fin = np.isfinite(ref_v)
    if fin.any():
        assert _ratio(v[fin], ref_v[fin], 1e-5) <= 1.0
    _rounds_exact_where_apart(i.numpy(), ref_i, ref_v)
    if case == "nan":
        assert np.isnan(v[0, :, min(5, m - 1)]).all() and (i[0, :, min(5, m - 1)] % n == n - 1).all()
    if case == "nan_last":  # (NaN, N - 1) first, then the normal order of the rest
        assert np.isnan(v[:, 0]).all() and np.isfinite(v[:, 1:]).all() and (i[:, 0] % n == n - 1).all()
    if case == "plain":
        one = fm.pair_topk_3xtf32_plain(*t, lc, 10.0, 0.7, L, passes=1)[0].numpy()
        assert _ratio(one, ref_v, 1e-5) > 1.0


def _awkward_scores(seed):
    """Integer scores (exact ties everywhere), NaN before and in the last
    column, -inf, +inf and negative rows, at widths below and above 64
    columns and below L."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (1, 5, 37, 70, 130):
        f = rng.integers(0, 6, (2, 9, n)).astype(np.float32)
        f[0, 1, min(3, n - 1)] = np.nan
        f[0, 2, n - 1] = np.nan
        f[1, 3, 0] = -np.inf
        f[1, 4] = -np.inf
        f[1, 5, min(2, n - 1)] = np.inf
        f[1, 6] = -1.0 - f[1, 6]
        out.append(torch.from_numpy(f))
    return out


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
def test_topk_lists_equal_the_rounds(chunks):
    """K2b's selection (per-chunk lists of the best scores above -inf, NaN
    left out, merged; the rounds' rules at the end) gives exactly what L
    rounds of (max, first index attaining it, mask with -inf) give, in one
    launch and in column chunks: on exact ties, NaN rows, a NaN only in the
    last column, -inf, +inf and negative scores, and rows shorter than L."""
    shape_scores = []
    for shape in TF32_SHAPES:
        for case in ("ties", "nan", "nan_last"):
            d0, d1, s0, s1 = (torch.from_numpy(a) for a in _topk_inputs(shape, case, seed=7))
            s = fm._correlation(d0, d1, 10.0)
            lse_row = fm._row_lse(s, 0.7)
            lc = fm.col_lse_plain(d0, d1, 10.0, 0.7)
            shape_scores.append(torch.exp(s - lse_row[..., None]) * torch.exp(s - lc[:, None, :]) * s0[..., None]
                                * s1[:, None, :])
    for f in shape_scores + _awkward_scores(chunks):
        for L in (1, 4, 16):
            rv, ri = fm._topk_rounds(f, L)
            v, i = fm.topk_lists_plain(f, L, chunks)
            assert torch.equal(i, ri)
            torch.testing.assert_close(v, rv, rtol=0, atol=0, equal_nan=True)


def test_pair_topk_chunks():
    """K2b splits the column tiles into chunks only where its row tiles
    leave SMs idle: 2 x 31 row tiles x 2 chunks = 124 CTAs on 132 SMs at the
    serving shape, none at the training shape (8 x 31); at most the
    kernel's limit (2, ``mk_pair_topk_max_chunks``), each the same number of
    tiles, none empty."""
    for most in (2, 4):
        assert fm.pair_topk_chunks(132, 2, 1938, 1938, most) == 2
        assert fm.pair_topk_chunks(132, 8, 1938, 1938, most) == 1
        assert fm.pair_topk_chunks(132, 1, 64, 70, most) == 2
        assert fm.pair_topk_chunks(132, 1, 1, 1, most) == 1
    assert fm.pair_topk_chunks(132, 1, 64, 1938, 2) == 2
    assert fm.pair_topk_chunks(132, 1, 64, 1938, 4) == 4
    assert fm.pair_topk_chunks(132, 1, 64, 320, 2) == 2  # 5 tiles: chunks of 3 and 2
    assert fm.pair_topk_chunks(132, 1, 64, 320, 4) == 3  # 5 tiles for 4 wanted: 3 chunks of 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "ties", "nan", "nan_last"])
def test_pair_topk_kernel_matches_3xtf32_plain(cuda, case):
    """On the card, K2b on K2a's split against its arithmetic's CPU mimic
    at the serving shape: values at RTOL, NaN where the mimic has it,
    indices exact where values are apart or tie exactly; two launches
    bitwise equal."""
    d0, d1, s0, s1 = (torch.from_numpy(a) for a in _topk_inputs((2, 1938, 1938, 128), case, seed=3))
    lc = fm.col_lse_plain(d0, d1, 10.0, 1.0)
    ref_v, ref_i = fm.pair_topk_3xtf32_plain(d0, d1, s0, s1, lc, 10.0, 1.0, 16)[:2]
    g = [x.to(cuda) for x in (d0, d1, s0, s1, lc)]
    split = fm.topk_split(g[0], g[1])
    fm.col_lse(g[0], g[1], 10.0, 1.0, split)
    out = fm.pair_topk(*g, 10.0, 1.0, 16, split)
    again = fm.pair_topk(*g, 10.0, 1.0, 16, split)
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(out, again))
    v = out[0].cpu().numpy()
    np.testing.assert_array_equal(np.isnan(v), np.isnan(ref_v.numpy()))
    fin = np.isfinite(ref_v.numpy())
    assert _ratio(v[fin], ref_v.numpy()[fin], 1e-5) <= 1.0
    _rounds_exact_where_apart(out[1].cpu().numpy(), ref_i.numpy(), ref_v.numpy())
