"""The fused matcher kernels: dual-softmax of dsc0 dsc1^T / T with a dustbin,
without the (B, M, N) couplings in device memory.

Counterpart of ``mickey_tpu/ops/fused_matcher.py``. Two routes:

Serving, ``fused_topk_scores``: the per-pair top-P sampling table of
dual_softmax(dsc0, dsc1) * (scr0 x scr1), without the dense match matrix.
Two kernels (``csrc/fused_topk.cu``) replace its two Pallas passes:

  ``col_lse``   (K2a) dustbin-augmented column logsumexp of the correlation;
  ``pair_topk`` (K2b) row logsumexp, final scores, per-row top-L candidates
                (value, flat index ``i*N + j``) and per-row validity partials.

The exact top-P over the L*M candidates (``exact_topk_desc``) is glue in
plain PyTorch, as it is XLA glue in the JAX package.

Training, ``fused_dual_softmax`` (forward) and ``fused_dual_softmax_vjp``
(a ``torch.autograd.Function``): the dense (B, M, N) output written once, and
its analytic backward. With A = softmax over rows, B = softmax over columns,
P = A*B and upstream cotangent G,

    dS = 2*P*G - A*colsum(G*P) - B*rowsum(G*P)
    d dsc0 = dS @ dsc1 / T,   d dsc1 = dS^T @ dsc0 / T
    d alpha = -sum_j exp(a - lse_col_j) c_j - sum_i exp(a - lse_row_i) r_i

Forward (K4): ``col_lse`` again, then ``pair_softmax`` (``csrc/dual_softmax.cu``).
Backward (K5): ``dual_softmax_bwd_sums`` (r, c) and ``dual_softmax_bwd_grads``
(dd0, dd1), both recomputing the correlation from the saved logsumexps.

Each kernel wrapper launches its kernel on a CUDA tensor and takes its plain
version on a CPU tensor; there is no fallback on the card.
``dense_topk_scores`` applied to ``nn.matcher.dual_softmax`` is the oracle of
the serving route, autograd of ``nn.matcher.dual_softmax`` that of the
training route.
"""

from __future__ import annotations

import torch

from . import _cuda

NEG_INF = -1e30


def _alpha(dustbin: float, use_dustbin: bool) -> float:
    return float(dustbin) if use_dustbin else NEG_INF


def _correlation(dsc0: torch.Tensor, dsc1: torch.Tensor, inv_temp: float) -> torch.Tensor:
    # fp32 product; TF32 is off (models.builder pins it), as the reference's
    # Precision.HIGHEST demands
    return torch.matmul(dsc0.float(), dsc1.float().transpose(1, 2)) * inv_temp


# -- K2a: column logsumexp -----------------------------------------------------


def col_lse_plain(dsc0, dsc1, inv_temp: float, alpha: float) -> torch.Tensor:
    s = _correlation(dsc0, dsc1, inv_temp)
    lse = torch.logsumexp(s, dim=1)  # (B, N)
    return torch.logaddexp(lse, torch.tensor(alpha, dtype=lse.dtype, device=lse.device))


def col_lse(dsc0: torch.Tensor, dsc1: torch.Tensor, inv_temp: float, alpha: float) -> torch.Tensor:
    """(B, N) logaddexp(logsumexp_i s_ij, alpha) with s = dsc0 dsc1^T * inv_temp."""
    if dsc0.device.type == "cpu":
        return col_lse_plain(dsc0, dsc1, inv_temp, alpha)
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    _cuda.require(dsc0, "dsc0", torch.float32, (B, M, C), dsc0.device)
    _cuda.require(dsc1, "dsc1", torch.float32, (B, N, C), dsc0.device)
    out = torch.empty((B, N), dtype=torch.float32, device=dsc0.device)
    rc = _cuda.lib().mk_col_lse_f32(
        dsc0.data_ptr(), dsc1.data_ptr(), out.data_ptr(), B, M, N, C,
        float(inv_temp), float(alpha), _cuda.stream_ptr(dsc0),
    )
    _cuda.check(rc, "col_lse")
    _cuda.LAUNCHES["col_lse"] += 1
    return out


# -- K2b: row logsumexp, final scores, per-row top-L ---------------------------


def _row_lse(s: torch.Tensor, alpha: float) -> torch.Tensor:
    """Row logsumexp with the dustbin column, in the TPU kernels' op order."""
    row_max = torch.clamp(s.amax(dim=2), min=alpha)
    row_sum = torch.exp(s - row_max[..., None]).sum(dim=2) + torch.exp(alpha - row_max)
    return torch.log(row_sum) + row_max


def pair_topk_plain(dsc0, dsc1, scr0, scr1, lse_col, inv_temp: float, alpha: float, topl: int):
    """Plain version of ``pair_topk``: the same four outputs from the dense
    (B, M, N) final scores, with the kernel's selection rounds written out."""
    s = _correlation(dsc0, dsc1, inv_temp)
    B, M, N = s.shape
    lse_row = _row_lse(s, alpha)
    f = torch.exp(s - lse_row[..., None]) * torch.exp(s - lse_col[:, None, :])
    f = f * scr0[..., None] * scr1[:, None, :]
    stats = torch.stack(
        [f.sum(dim=2), (~torch.isfinite(f)).sum(dim=2).float(), f.amin(dim=2)], dim=-1
    )
    col = torch.arange(N, device=f.device)
    row = torch.arange(M, device=f.device, dtype=torch.int32)
    sel = f.clone()
    vals, idxs = [], []
    for _ in range(topl):
        m = sel.amax(dim=2)  # NaN-propagating, as jnp.max
        idx = torch.where(sel == m[..., None], col, N).amin(dim=2).clamp(max=N - 1)
        vals.append(torch.where(torch.isnan(m), m, torch.clamp(m, min=0.0)))
        idxs.append(row * N + idx.to(torch.int32))
        sel = sel.scatter(2, idx[..., None], float("-inf"))
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1), stats, lse_row


def pair_topk(dsc0, dsc1, scr0, scr1, lse_col, inv_temp: float, alpha: float, topl: int):
    """Returns (vals (B, L, M) f32, idxs (B, L, M) i32 flat ``i*N + j``,
    stats (B, M, 3) = per-row (mass, non-finite count, min), lse_row (B, M))."""
    if dsc0.device.type == "cpu":
        return pair_topk_plain(dsc0, dsc1, scr0, scr1, lse_col, inv_temp, alpha, topl)
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    for t, name, shape in (
        (dsc0, "dsc0", (B, M, C)), (dsc1, "dsc1", (B, N, C)), (scr0, "scr0", (B, M)),
        (scr1, "scr1", (B, N)), (lse_col, "lse_col", (B, N)),
    ):
        _cuda.require(t, name, torch.float32, shape, dsc0.device)
    lib = _cuda.lib()
    smem = lib.mk_pair_topk_smem_bytes(N, C)
    if smem > 232448:
        raise ValueError(f"pair_topk: N={N}, C={C} needs {smem} B of shared memory (> 227 KB)")
    dev = dsc0.device
    vals = torch.empty((B, topl, M), dtype=torch.float32, device=dev)
    idxs = torch.empty((B, topl, M), dtype=torch.int32, device=dev)
    stats = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    lse_row = torch.empty((B, M), dtype=torch.float32, device=dev)
    rc = lib.mk_pair_topk_f32(
        dsc0.data_ptr(), dsc1.data_ptr(), scr0.data_ptr(), scr1.data_ptr(), lse_col.data_ptr(),
        vals.data_ptr(), idxs.data_ptr(), stats.data_ptr(), lse_row.data_ptr(),
        B, M, N, C, topl, float(inv_temp), float(alpha), _cuda.stream_ptr(dsc0),
    )
    _cuda.check(rc, "pair_topk")
    _cuda.LAUNCHES["pair_topk"] += 1
    return vals, idxs, stats, lse_row


# -- glue ------------------------------------------------------------------------


def exact_topk_desc(vals: torch.Tensor, k: int):
    """Exact descending top-k over the last axis: (values, positions int64).
    Same branch structure as ``_exact_topk_desc``: a stable descending sort
    when k is a sizable fraction of the axis, ``topk`` otherwise."""
    n = vals.shape[-1]
    if 4 * k >= n:
        order = torch.sort(vals, dim=-1, descending=True, stable=True).indices[..., :k]
        return torch.gather(vals, -1, order), order
    v, i = torch.topk(vals, k, dim=-1, sorted=True)
    return v, i


def fused_topk_scores(
    dsc0: torch.Tensor,  # (B, M, C) L2-normalized descriptors, fp32
    dsc1: torch.Tensor,  # (B, N, C)
    scr0: torch.Tensor,  # (B, M) detection scores
    scr1: torch.Tensor,  # (B, N)
    dustbin: float,
    prefilter: int,
    temperature: float = 0.1,
    use_dustbin: bool = True,
    row_topl: int = 16,
):
    """Returns (top_scores (B, P) fp32 descending, top_idx (B, P) int32 flat
    indices into the M x N matrix, row_ok (B,) bool)."""
    B, M, _ = dsc0.shape
    inv_temp = float(1.0 / temperature)
    alpha = _alpha(dustbin, use_dustbin)
    scr0 = scr0.float().contiguous()
    scr1 = scr1.float().contiguous()
    lse_c = col_lse(dsc0, dsc1, inv_temp, alpha)
    vals, idxs, stats, _ = pair_topk(dsc0, dsc1, scr0, scr1, lse_c, inv_temp, alpha, row_topl)
    row_ok = (
        (stats[..., 1].sum(dim=-1) == 0)  # all finite
        & (stats[..., 2].amin(dim=-1) >= 0)  # nonnegative
        & (stats[..., 0].sum(dim=-1) > 0)  # positive mass
    )
    top_scores, pos = exact_topk_desc(vals.reshape(B, row_topl * M), prefilter)
    top_idx = torch.gather(idxs.reshape(B, row_topl * M), 1, pos)
    return top_scores, top_idx, row_ok


def dense_topk_scores(scores: torch.Tensor, prefilter: int, row_topl: int = 16):
    """Selection semantics of ``fused_topk_scores`` on a dense (B, M, N)
    final-score matrix (``mickey_tpu.ops.fused_matcher.dense_topk_scores``):
    the test oracle of the fused route."""
    B, M, N = scores.shape
    flat = scores.reshape(B, M * N).float()
    row_ok = torch.isfinite(flat).all(-1) & (flat >= 0).all(-1) & (flat.sum(-1) > 0)
    s = torch.where(torch.isfinite(scores), scores.float(), torch.full_like(scores.float(), -1.0))
    v, i = torch.topk(s, row_topl, dim=-1)  # (B, M, L)
    gidx = torch.arange(M, device=scores.device, dtype=torch.int32)[None, :, None] * N + i.to(torch.int32)
    cand_v = torch.clamp(v, min=0.0).transpose(1, 2).reshape(B, row_topl * M)
    cand_i = gidx.transpose(1, 2).reshape(B, row_topl * M)
    top_scores, pos = exact_topk_desc(cand_v, prefilter)
    return top_scores, torch.gather(cand_i, 1, pos), row_ok


# -- K4: dense dual-softmax (training forward) -----------------------------------

# deepest descriptor the dual-softmax kernels stage (csrc/dual_softmax.cu CMAX)
DUAL_SOFTMAX_MAX_C = 128


def _require_descs(dsc0, dsc1, name: str):
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    if C > DUAL_SOFTMAX_MAX_C:
        raise ValueError(f"{name}: descriptor depth {C} > {DUAL_SOFTMAX_MAX_C}")
    _cuda.require(dsc0, "dsc0", torch.float32, (B, M, C), dsc0.device)
    _cuda.require(dsc1, "dsc1", torch.float32, (B, N, C), dsc0.device)
    return B, M, N, C


def pair_softmax_plain(dsc0, dsc1, lse_col, inv_temp: float, alpha: float):
    s = _correlation(dsc0, dsc1, inv_temp)
    lse_row = _row_lse(s, alpha)
    return torch.exp(s - lse_row[..., None]) * torch.exp(s - lse_col[:, None, :]), lse_row


def pair_softmax(dsc0, dsc1, lse_col, inv_temp: float, alpha: float):
    """(out (B, M, N) = exp(s - lse_row) exp(s - lse_col), lse_row (B, M)),
    lse_row with the dustbin column ``alpha``; ``lse_col`` from ``col_lse``."""
    if dsc0.device.type == "cpu":
        return pair_softmax_plain(dsc0, dsc1, lse_col, inv_temp, alpha)
    B, M, N, C = _require_descs(dsc0, dsc1, "pair_softmax")
    _cuda.require(lse_col, "lse_col", torch.float32, (B, N), dsc0.device)
    out = torch.empty((B, M, N), dtype=torch.float32, device=dsc0.device)
    lse_row = torch.empty((B, M), dtype=torch.float32, device=dsc0.device)
    rc = _cuda.lib().mk_pair_softmax_f32(
        dsc0.data_ptr(), dsc1.data_ptr(), lse_col.data_ptr(), out.data_ptr(), lse_row.data_ptr(),
        B, M, N, C, float(inv_temp), float(alpha), _cuda.stream_ptr(dsc0),
    )
    _cuda.check(rc, "pair_softmax")
    _cuda.LAUNCHES["pair_softmax"] += 1
    return out, lse_row


# -- K5: analytic backward -------------------------------------------------------


def dual_softmax_bwd_sums_plain(dsc0, dsc1, g, lse_row, lse_col, inv_temp: float):
    s = _correlation(dsc0, dsc1, inv_temp)
    gp = g * torch.exp(2.0 * s - lse_row[..., None] - lse_col[:, None, :])
    return gp.sum(dim=2), gp.sum(dim=1)


def dual_softmax_bwd_sums(dsc0, dsc1, g, lse_row, lse_col, inv_temp: float):
    """(r (B, M), c (B, N)): row and column sums of G * P."""
    if dsc0.device.type == "cpu":
        return dual_softmax_bwd_sums_plain(dsc0, dsc1, g, lse_row, lse_col, inv_temp)
    B, M, N, C = _require_descs(dsc0, dsc1, "dual_softmax_bwd_sums")
    for t, name, shape in ((g, "g", (B, M, N)), (lse_row, "lse_row", (B, M)), (lse_col, "lse_col", (B, N))):
        _cuda.require(t, name, torch.float32, shape, dsc0.device)
    lib = _cuda.lib()
    dev = dsc0.device
    r = torch.empty((B, M), dtype=torch.float32, device=dev)
    c = torch.empty((B, N), dtype=torch.float32, device=dev)
    cpart = torch.empty((B, lib.mk_dual_softmax_row_blocks(M), N), dtype=torch.float32, device=dev)
    rc = lib.mk_dual_softmax_bwd_sums_f32(
        dsc0.data_ptr(), dsc1.data_ptr(), g.data_ptr(), lse_row.data_ptr(), lse_col.data_ptr(),
        r.data_ptr(), c.data_ptr(), cpart.data_ptr(), B, M, N, C, float(inv_temp), _cuda.stream_ptr(dsc0),
    )
    _cuda.check(rc, "dual_softmax_bwd_sums")
    _cuda.LAUNCHES["dual_softmax_bwd_sums"] += 1
    return r, c


def dual_softmax_bwd_grads_plain(dsc0, dsc1, g, lse_row, lse_col, r, c, inv_temp: float):
    s = _correlation(dsc0, dsc1, inv_temp)
    A = torch.exp(s - lse_col[:, None, :])  # softmax over rows
    Bm = torch.exp(s - lse_row[..., None])  # softmax over columns
    dS = 2.0 * (A * Bm) * g - A * c[:, None, :] - Bm * r[..., None]
    return torch.matmul(dS, dsc1.float()) * inv_temp, torch.matmul(dS.transpose(1, 2), dsc0.float()) * inv_temp


def dual_softmax_bwd_grads(dsc0, dsc1, g, lse_row, lse_col, r, c, inv_temp: float):
    """(dd0 (B, M, C), dd1 (B, N, C)) = (dS dsc1 / T, dS^T dsc0 / T)."""
    if dsc0.device.type == "cpu":
        return dual_softmax_bwd_grads_plain(dsc0, dsc1, g, lse_row, lse_col, r, c, inv_temp)
    B, M, N, C = _require_descs(dsc0, dsc1, "dual_softmax_bwd_grads")
    for t, name, shape in ((g, "g", (B, M, N)), (lse_row, "lse_row", (B, M)), (lse_col, "lse_col", (B, N)),
                           (r, "r", (B, M)), (c, "c", (B, N))):
        _cuda.require(t, name, torch.float32, shape, dsc0.device)
    dd0 = torch.empty((B, M, C), dtype=torch.float32, device=dsc0.device)
    dd1 = torch.empty((B, N, C), dtype=torch.float32, device=dsc0.device)
    rc = _cuda.lib().mk_dual_softmax_bwd_grads_f32(
        dsc0.data_ptr(), dsc1.data_ptr(), g.data_ptr(), lse_row.data_ptr(), lse_col.data_ptr(),
        r.data_ptr(), c.data_ptr(), dd0.data_ptr(), dd1.data_ptr(), B, M, N, C, float(inv_temp),
        _cuda.stream_ptr(dsc0),
    )
    _cuda.check(rc, "dual_softmax_bwd_grads")
    _cuda.LAUNCHES["dual_softmax_bwd_grads"] += 1
    return dd0, dd1


# -- the route -------------------------------------------------------------------


def _forward(dsc0, dsc1, inv_temp: float, alpha: float):
    lse_col = col_lse(dsc0, dsc1, inv_temp, alpha)
    out, lse_row = pair_softmax(dsc0, dsc1, lse_col, inv_temp, alpha)
    return out, lse_row, lse_col


def fused_dual_softmax(dsc0, dsc1, dustbin, temperature: float = 0.1, use_dustbin: bool = True):
    """(B, M, N) dual-softmax match scores, forward only (no autograd graph)."""
    d0, d1 = (d.detach().float().contiguous() for d in (dsc0, dsc1))
    return _forward(d0, d1, float(1.0 / temperature), _alpha(dustbin, use_dustbin))[0]


class _FusedDualSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dsc0, dsc1, dustbin, inv_temp: float, use_dustbin: bool):
        d0, d1 = (d.float().contiguous() for d in (dsc0, dsc1))
        alpha = _alpha(dustbin, use_dustbin)
        out, lse_row, lse_col = _forward(d0, d1, inv_temp, alpha)
        ctx.save_for_backward(d0, d1, lse_row, lse_col)
        ctx.inv_temp, ctx.alpha, ctx.use_dustbin = inv_temp, alpha, use_dustbin
        ctx.dtypes = (dsc0.dtype, dsc1.dtype)
        ctx.dustbin_meta = (dustbin.shape, dustbin.dtype) if torch.is_tensor(dustbin) else None
        return out

    @staticmethod
    def backward(ctx, g):
        d0, d1, lse_row, lse_col = ctx.saved_tensors
        g = g.float().contiguous()
        r, c = dual_softmax_bwd_sums(d0, d1, g, lse_row, lse_col, ctx.inv_temp)
        dd0, dd1 = dual_softmax_bwd_grads(d0, d1, g, lse_row, lse_col, r, c, ctx.inv_temp)
        dalpha = None
        if ctx.dustbin_meta is not None:
            shape, dtype = ctx.dustbin_meta
            if ctx.use_dustbin:
                # closed-form dustbin row / column contributions (G vanishes there)
                a = ctx.alpha
                da = -(torch.exp(a - lse_col) * c).sum() - (torch.exp(a - lse_row) * r).sum()
            else:
                da = torch.zeros((), dtype=torch.float32, device=g.device)
            dalpha = da.reshape(shape).to(dtype)
        return dd0.to(ctx.dtypes[0]), dd1.to(ctx.dtypes[1]), dalpha, None, None


def fused_dual_softmax_vjp(dsc0, dsc1, dustbin, temperature: float = 0.1, use_dustbin: bool = True):
    """Differentiable fused dual-softmax: K4 forward, K5 backward. Gradients
    reach dsc0, dsc1 and, where it is a tensor, the dustbin logit."""
    return _FusedDualSoftmax.apply(dsc0, dsc1, dustbin, float(1.0 / temperature), bool(use_dustbin))
