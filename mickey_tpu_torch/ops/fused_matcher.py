"""The fused matcher kernels: dual-softmax of dsc0 dsc1^T / T with a dustbin,
without the (B, M, N) couplings in device memory.

Counterpart of ``mickey_tpu/ops/fused_matcher.py``. Two routes:

Serving, ``fused_topk_scores``: the per-pair top-P sampling table of
dual_softmax(dsc0, dsc1) * (scr0 x scr1), without the dense match matrix.
Two kernels (``csrc/fused_topk.cu``) replace its two Pallas passes:

  ``col_lse``   (K2a) dustbin-augmented column logsumexp of the correlation;
  ``pair_topk`` (K2b) row logsumexp, final scores, per-row top-L candidates
                (value, flat index ``i*N + j``) and per-row validity partials.

Both run on the correlation engine below, on one split of the descriptors:
``_topk_table`` hands K2a's scratch (``topk_split``) to K2b, which splits
nothing itself. ``pair_topk_3xtf32_plain`` repeats K2b's arithmetic on the
CPU, ``topk_lists_plain`` its selection (per-row lists in chunks of columns,
merged; ``pair_topk_chunks``).

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
K2a, K2b and K4 compute the correlation at fp32 accuracy as 3xTF32 on the
tensor cores (the engine of ``csrc/corr_tf32.cuh``): the descriptors are
split once into TF32 hi / lo parts in a scratch buffer that the kernels read
through TMA tensor maps (``corr_geometry``). ``corr_3xtf32_plain``,
``col_lse_3xtf32_plain``, ``pair_topk_3xtf32_plain`` and
``pair_softmax_3xtf32_plain`` repeat that arithmetic on the CPU, for the
tests.

bf16 descriptors (``cfg.TPU.MATCHER_BF16``, the forward routes only): the
three wrappers dispatch on the descriptors' dtype, as the JAX package's
``_corr_block`` does, to the engine's bf16 mode (``mk_col_lse_bf16``,
``mk_pair_topk_bf16``, ``mk_pair_softmax_bf16``: one bf16 ``wgmma`` pass
with fp32 accumulation, exact for bf16 operands). Both sets share one dtype;
scores, logsumexps and outputs stay fp32. Their plain versions are the fp32
ones: ``_correlation`` upcasts bf16 descriptors before an fp32 product, which
is the bf16 kernels' arithmetic up to the order of the sums.
Backward (K5): ``dual_softmax_bwd_sums`` (r, c) and ``dual_softmax_bwd_grads``
(dd0, dd1), both recomputing the correlation from the saved logsumexps on
the same engine; the gradients' dS products are 3xTF32 too, dS split in
registers, the other descriptors read a second time transposed
(``corr_t_geometry``). ``dual_softmax_bwd_sums_3xtf32_plain`` and
``dual_softmax_bwd_grads_3xtf32_plain`` repeat that arithmetic on the CPU.

Fused top-K training, ``fused_topk_scores_train`` (a ``torch.autograd.Function``):
the serving route's table (K2a, K2b, top-P glue), detached, plus the
grad-carrying lse_row and lse_col. With final_ij = P_ij scr0_i scr1_j,

    log final_ij = 2 s_ij - lse_row_i - lse_col_j + log scr0_i + log scr1_j

is linear in s and the two logsumexps, so the loss needs the dense matrix in
neither direction. The VJP of the logsumexps for cotangents gr (B, M),
gc (B, N) is K6 (``lse_bwd``, ``csrc/dual_softmax.cu``, the gradient kernel of K5 with
another dS; ``lse_bwd_3xtf32_plain`` on the CPU):

    dS = gr_i exp(s_ij - lse_row_i) + gc_j exp(s_ij - lse_col_j)
    d dsc0 = dS @ dsc1 / T,   d dsc1 = dS^T @ dsc0 / T
    d alpha = sum_i gr_i exp(a - lse_row_i) + sum_j gc_j exp(a - lse_col_j)

Each kernel wrapper launches its kernel on a CUDA tensor and takes its plain
version on a CPU tensor; there is no fallback on the card.
``dense_topk_scores`` applied to ``nn.matcher.dual_softmax`` is the oracle of
the serving route, autograd of ``nn.matcher.dual_softmax`` that of the
training route, ``dense_topk_scores_train`` (autograd of ``dense_lse``) that
of the fused training route.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _cuda
from .flash_attention import map_geometry
from .tf32 import desc_split

NEG_INF = -1e30


def _alpha(dustbin: float, use_dustbin: bool) -> float:
    return float(dustbin) if use_dustbin else NEG_INF


def _correlation(dsc0: torch.Tensor, dsc1: torch.Tensor, inv_temp: float) -> torch.Tensor:
    # fp32 product; TF32 is off (models.builder pins it), as the reference's
    # Precision.HIGHEST demands. bf16 descriptors are upcast first: every
    # product of two bf16 values is exact in fp32, as in the bf16 kernels.
    return torch.matmul(dsc0.float(), dsc1.float().transpose(1, 2)) * inv_temp


# -- the correlation engine (K2a, K4): 3xTF32 on descriptors split once --------

CORR_C = 128  # channels of the engine's scratch (csrc/corr_tf32.cuh CORR_C): the deepest descriptor
CORR_ROWS = 64  # rows of a TMA box, own tile and other tile alike (CORR_BM, CORR_BN)


def corr_3xtf32_plain(x_own: torch.Tensor, x_oth: torch.Tensor, inv_temp: float, passes: int = 3) -> torch.Tensor:
    """The engine's correlation on the CPU: (B, R_own, C) x (B, R_oth, C) ->
    (B, R_own, R_oth) = x_own x_oth^T * inv_temp, both split by
    ``desc_split``, the product as the lo*hi and hi*lo passes summed first,
    then hi*hi (``passes=1``: hi*hi alone, one TF32 product), every term exact
    in fp32 and the sums in fp32."""
    (ah, al), (bh, bl) = (desc_split(x.float()) for x in (x_own, x_oth))
    bh, bl = bh.transpose(1, 2), bl.transpose(1, 2)
    hh = torch.matmul(ah, bh)
    s = hh if passes == 1 else (torch.matmul(al, bh) + torch.matmul(ah, bl)) + hh
    return s * inv_temp


def _col_lse_from(s: torch.Tensor, alpha: float) -> torch.Tensor:
    lse = torch.logsumexp(s, dim=1)  # (B, N)
    return torch.logaddexp(lse, torch.tensor(alpha, dtype=lse.dtype, device=lse.device))


def col_lse_3xtf32_plain(dsc0, dsc1, inv_temp: float, alpha: float, passes: int = 3) -> torch.Tensor:
    """K2a's arithmetic on the CPU: ``col_lse_plain`` on the engine's
    correlation (own = dsc1)."""
    return _col_lse_from(corr_3xtf32_plain(dsc1, dsc0, inv_temp, passes).transpose(1, 2), alpha)


def pair_softmax_3xtf32_plain(dsc0, dsc1, lse_col, inv_temp: float, alpha: float, passes: int = 3):
    """K4's arithmetic on the CPU: ``pair_softmax_plain`` on the engine's
    correlation (own = dsc0)."""
    return _pair_softmax_from(corr_3xtf32_plain(dsc0, dsc1, inv_temp, passes), lse_col, alpha)


@functools.lru_cache(maxsize=64)
def corr_geometry(b: int, n_own: int, n_oth: int, item: int = 4):
    """The ``geom`` argument of the engine's C entries: the tensor maps of
    the prepared own rows, then of the other rows, each a contiguous
    (B, rows, 128) array of ``item``-byte values read ``CORR_ROWS`` rows of
    all 128 channels a box (``map_geometry`` of it as (B, 1, rows, 128)).
    fp32 (item 4, the split's hi and lo parts alike): dims (32, rows, 4, 1,
    B), a box (32, 64, 4, 1, 1) lands as four blocks of 64 128-byte rows;
    bf16 (item 2): dims (64, rows, 2, 1, B), a box (64, 64, 2, 1, 1) lands as
    two. The cache is keyed by the item size too."""
    maps = [map_geometry((b, 1, rows, CORR_C), (rows * CORR_C, rows * CORR_C, CORR_C, 1), item, CORR_ROWS, CORR_C)
            for rows in (n_own, n_oth)]
    return (ctypes.c_longlong * 28)(*(x for g in maps for part in g for x in part))


def _prep_floats(b: int, m: int, n: int, dtype) -> int:
    """Floats of the prepared descriptors in scratch: fp32, dsc0 hi, lo,
    then dsc1 hi, lo, each (B, rows, 128); bf16, dsc0 then dsc1, each (B,
    rows, 128) bf16."""
    per_row = 2 * CORR_C if dtype == torch.float32 else CORR_C // 2
    return (b * m + b * n) * per_row


def _corr_scratch(b: int, m: int, n: int, device, chunks: int = 0, dtype=torch.float32) -> torch.Tensor:
    """The prepared descriptors of ``dtype`` (``_prep_floats``); then, for
    K2a, ``chunks`` (max, sum) partials of each of B x N columns."""
    return torch.empty(_prep_floats(b, m, n, dtype) + 2 * b * chunks * n, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=8)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def pair_topk_chunks(sms: int, b: int, m: int, n: int, most: int) -> int:
    """How many chunks K2b splits dsc1's column tiles into: about enough
    CTAs (B times M / 64 row tiles, times the chunks) for one wave on
    ``sms`` SMs at one CTA an SM, at most ``most`` (the kernel's limit,
    ``mk_pair_topk_max_chunks``); every chunk the same whole number of
    64-column tiles (the last one's columns may run out sooner), none empty.
    One chunk runs both sweeps in one launch; more add a launch of row
    partials before and a merge after."""
    col_tiles = math.ceil(n / CORR_ROWS)
    want = max(1, min(col_tiles, most, sms // (b * math.ceil(m / CORR_ROWS))))
    per = math.ceil(col_tiles / want)
    return math.ceil(col_tiles / per)


def topk_split(dsc0: torch.Tensor, dsc1: torch.Tensor):
    """The scratch that K2a prepares dsc0 and dsc1 in (splits them, or
    copies bf16 ones) and K2b reads (``_corr_scratch`` with K2a's partials);
    None on the CPU."""
    if not dsc0.is_cuda:
        return None
    b, m, _ = dsc0.shape
    n = dsc1.shape[1]
    return _corr_scratch(b, m, n, dsc0.device, col_lse_chunks(_sm_count(dsc0.device), b, m, n), dsc0.dtype)


def col_lse_chunks(sms: int, b: int, m: int, n: int) -> int:
    """How many chunks K2a splits dsc0's rows into: about enough CTAs (B
    times N / 64 column tiles, times the chunks) for one wave on ``sms`` SMs
    at one CTA an SM; every chunk the same whole number of 64-row tiles (the
    last one's rows may run out sooner), none empty."""
    row_tiles = math.ceil(m / CORR_ROWS)
    want = max(1, min(row_tiles, sms // (b * math.ceil(n / CORR_ROWS))))
    per = math.ceil(row_tiles / want)
    return math.ceil(row_tiles / per)


def _rows_padded(rows: int) -> int:
    return -(-rows // CORR_ROWS) * CORR_ROWS


def corr_t_geometry(b: int, rows: int):
    """The tensor map of a transposed split descriptor set, a contiguous (B,
    128, rows padded to 64) fp32 array read 64 rows of all 128 channels a
    box (``map_geometry`` of it as (B, 1, 128, padded rows): dims (32, 128,
    padded / 32, 1, B), a box (32, 128, 2, 1, 1) lands as two blocks of 128
    128-byte rows)."""
    pad = _rows_padded(rows)
    return map_geometry((b, 1, CORR_C, pad), (CORR_C * pad, CORR_C * pad, pad, 1), 4, CORR_C, CORR_ROWS)


@functools.lru_cache(maxsize=64)
def corr_bwd_geometry(b: int, m: int, n: int):
    """The ``geom`` argument of the gradient kernels' C entries: the maps of
    dsc0's and dsc1's split rows (``corr_geometry``), then of their
    transposed copies (``corr_t_geometry``)."""
    maps = [map_geometry((b, 1, rows, CORR_C), (rows * CORR_C, rows * CORR_C, CORR_C, 1), 4, CORR_ROWS, CORR_C)
            for rows in (m, n)] + [corr_t_geometry(b, rows) for rows in (m, n)]
    return (ctypes.c_longlong * 56)(*(x for g in maps for part in g for x in part))


def _t_scratch(b: int, m: int, n: int, device) -> torch.Tensor:
    """The gradient kernels' transposed split descriptors: dsc0^T hi, lo and
    dsc1^T hi, lo, each (B, 128, rows padded to 64)."""
    return torch.empty(2 * b * (_rows_padded(m) + _rows_padded(n)) * CORR_C, dtype=torch.float32, device=device)


def _launch(kernel: str, dsc0, dsc1, *args) -> None:
    """Launch the C entry of ``kernel`` in the descriptors' mode,
    ``mk_<kernel>_f32`` or ``mk_<kernel>_bf16``, on (dsc0, dsc1, *args, the
    current stream), and count it in ``LAUNCHES[kernel]`` or
    ``LAUNCHES[kernel + "_bf16"]``."""
    bf16 = dsc0.dtype == torch.bfloat16
    name = f"{kernel}_bf16" if bf16 else kernel
    rc = getattr(_cuda.lib(), f"mk_{kernel}_{'bf16' if bf16 else 'f32'}")(
        dsc0.data_ptr(), dsc1.data_ptr(), *args, _cuda.stream_ptr(dsc0))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1


def _split_for(split, b: int, m: int, n: int, device, dtype=torch.float32):
    """The prepared descriptors of ``dtype`` a kernel reads and whether it
    writes them: ``split``, a scratch that holds this (B, M, N) pair's
    already (K2a's for K2b; K2a's or K4's, saved in the autograd context, for
    the backward), or a new one."""
    if split is None:
        return _corr_scratch(b, m, n, device, dtype=dtype), 1
    need = _prep_floats(b, m, n, dtype)
    if split.device != device or split.dtype != torch.float32 or split.numel() < need:
        raise ValueError(f"split: expected an fp32 scratch on {device} of at least {need} "
                         f"values, got {split.dtype} {tuple(split.shape)} on {split.device}")
    return split, 0


# -- K2a: column logsumexp -----------------------------------------------------


def col_lse_plain(dsc0, dsc1, inv_temp: float, alpha: float) -> torch.Tensor:
    """Plain version of ``col_lse``, of its fp32 and bf16 kernels alike
    (``_correlation`` upcasts bf16 descriptors)."""
    return _col_lse_from(_correlation(dsc0, dsc1, inv_temp), alpha)


def col_lse(dsc0: torch.Tensor, dsc1: torch.Tensor, inv_temp: float, alpha: float, scratch=None) -> torch.Tensor:
    """(B, N) logaddexp(logsumexp_i s_ij, alpha) with s = dsc0 dsc1^T * inv_temp;
    fp32 or bf16 descriptors, an fp32 result. ``scratch`` (``_corr_scratch``
    of their dtype with ``col_lse_chunks``' partials): where the kernel
    prepares the descriptors, for a caller that keeps them."""
    if dsc0.device.type == "cpu":
        return col_lse_plain(dsc0, dsc1, inv_temp, alpha)
    B, M, N, C = _require_descs(dsc0, dsc1, "col_lse")
    dev = dsc0.device
    chunks = col_lse_chunks(_sm_count(dev), B, M, N)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    scratch = _corr_scratch(B, M, N, dev, chunks, dsc0.dtype) if scratch is None else scratch
    _launch("col_lse", dsc0, dsc1, out.data_ptr(), scratch.data_ptr(), corr_geometry(B, N, M, dsc0.element_size()),
            B, M, N, C, chunks, float(inv_temp), float(alpha))
    return out


# -- K2b: row logsumexp, final scores, per-row top-L ---------------------------


def _row_lse(s: torch.Tensor, alpha: float) -> torch.Tensor:
    """Row logsumexp with the dustbin column, in the TPU kernels' op order."""
    row_max = torch.clamp(s.amax(dim=2), min=alpha)
    row_sum = torch.exp(s - row_max[..., None]).sum(dim=2) + torch.exp(alpha - row_max)
    return torch.log(row_sum) + row_max


def _pair_topk_from(s: torch.Tensor, scr0, scr1, lse_col, alpha: float, topl: int, select):
    """K2b's four outputs from the correlation ``s``: f in the JAX order,
    the row stats, and the selection ``select(f, topl)``."""
    lse_row = _row_lse(s, alpha)
    f = torch.exp(s - lse_row[..., None]) * torch.exp(s - lse_col[:, None, :])
    f = f * scr0[..., None] * scr1[:, None, :]
    stats = torch.stack(
        [f.sum(dim=2), (~torch.isfinite(f)).sum(dim=2).float(), f.amin(dim=2)], dim=-1
    )
    vals, idxs = select(f, topl)
    return vals, idxs, stats, lse_row


def _topk_rounds(f: torch.Tensor, topl: int):
    """The TPU kernel's selection: ``topl`` rounds of (max, first index
    attaining it, mask with -inf) over each row of f (B, M, N), values
    clamped at 0, a NaN max's index clamped to N - 1. Returns (vals (B, L, M),
    idxs (B, L, M) i32 flat ``i*N + j``)."""
    B, M, N = f.shape
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
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def topk_lists_plain(f: torch.Tensor, topl: int, chunks: int = 1):
    """K2b's selection as its kernels make it, on the CPU: per row and chunk
    of 64-column tiles (``chunks`` as ``pair_topk_chunks`` gives) a list of
    the ``topl`` first scores above -inf by (value desc, column asc), NaN
    left out, and two flags (a NaN before the last column; in it); the
    chunks' lists merged in order; then the rounds: all (NaN, N - 1) for the
    first flag, (NaN, N - 1) first for the second alone, then the list,
    values clamped at 0, and (0, column 0) once it runs out. It gives what
    ``_topk_rounds`` gives."""
    B, M, N = f.shape
    per = math.ceil(math.ceil(N / CORR_ROWS) / chunks) * CORR_ROWS
    nan = torch.isnan(f)
    nan_other, nan_last = nan[..., :-1].any(-1, keepdim=True), nan[..., -1:]
    # left out: NaN and -inf, keyed -inf, behind every entry kept
    out = nan | (f == float("-inf"))
    key = torch.where(out, torch.full_like(f, float("-inf")), f)

    def first(key, out, cols):  # a stable sort on the value keeps ties in column order
        order = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :topl]
        return torch.gather(key, -1, order), torch.gather(out, -1, order), torch.gather(cols, -1, order)

    cols = torch.arange(N, device=f.device).expand(B, M, N)
    lists = [first(key[..., c:c + per], out[..., c:c + per], cols[..., c:c + per]) for c in range(0, N, per)]
    v, o, j = first(*(torch.cat(x, -1) for x in zip(*lists)))  # the merge, chunks in column order
    v = torch.where(o, torch.zeros_like(v), torch.clamp(v, min=0.0))
    j = torch.where(o, torch.zeros_like(j), j)
    short = topl + 1 - v.shape[-1]  # a list shorter than the rounds: (0, column 0) after it
    v, j = (torch.nn.functional.pad(x, (0, short)) for x in (v, j))
    head_v, head_j = torch.full_like(v[..., :1], float("nan")), torch.full_like(j[..., :1], N - 1)
    v = torch.where(nan_last, torch.cat([head_v, v[..., :-1]], -1), v)[..., :topl]
    j = torch.where(nan_last, torch.cat([head_j, j[..., :-1]], -1), j)[..., :topl]
    v = torch.where(nan_other, torch.full_like(v, float("nan")), v)
    j = torch.where(nan_other, torch.full_like(j, N - 1), j)
    row = torch.arange(M, device=f.device)[None, :, None]
    return v.transpose(1, 2).contiguous(), (row * N + j).to(torch.int32).transpose(1, 2).contiguous()


def pair_topk_plain(dsc0, dsc1, scr0, scr1, lse_col, inv_temp: float, alpha: float, topl: int):
    """Plain version of ``pair_topk``, of its fp32 and bf16 kernels alike:
    the same four outputs from the dense (B, M, N) final scores, with the TPU
    kernel's selection rounds written out."""
    return _pair_topk_from(_correlation(dsc0, dsc1, inv_temp), scr0, scr1, lse_col, alpha, topl, _topk_rounds)


def pair_topk_3xtf32_plain(dsc0, dsc1, scr0, scr1, lse_col, inv_temp: float, alpha: float, topl: int,
                           passes: int = 3, chunks: int = 1):
    """K2b's arithmetic on the CPU: the engine's correlation (own = dsc0),
    the same f and stats, and the kernel's selection (``topk_lists_plain``
    in ``chunks``)."""
    return _pair_topk_from(corr_3xtf32_plain(dsc0, dsc1, inv_temp, passes), scr0, scr1, lse_col, alpha, topl,
                           lambda f, topl: topk_lists_plain(f, topl, chunks))


def topk_chunks(b: int, m: int, n: int, device) -> int:
    """``pair_topk_chunks`` on ``device``'s SMs within the kernel's limit."""
    return pair_topk_chunks(_sm_count(device), b, m, n, _cuda.lib().mk_pair_topk_max_chunks())


def _topk_work(b: int, m: int, topl: int, chunks: int, device):
    """A split K2b's partials, as large as the kernel lays them out
    (``mk_pair_topk_work_floats``); None for one chunk, which needs none."""
    floats = _cuda.lib().mk_pair_topk_work_floats(b, m, topl, chunks)
    if floats < 0:
        raise ValueError(f"pair_topk: row_topl {topl} or {chunks} chunks outside the kernel's limits")
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def pair_topk(dsc0, dsc1, scr0, scr1, lse_col, inv_temp: float, alpha: float, topl: int, split=None):
    """Returns (vals (B, L, M) f32, idxs (B, L, M) i32 flat ``i*N + j``,
    stats (B, M, 3) = per-row (mass, non-finite count, min), lse_row (B, M));
    fp32 or bf16 descriptors. ``split``: ``col_lse``'s scratch after its
    launch on these descriptors (``topk_split``), whose prepared copy the
    kernel reads; without it the wrapper prepares them first."""
    if dsc0.device.type == "cpu":
        return pair_topk_plain(dsc0, dsc1, scr0, scr1, lse_col, inv_temp, alpha, topl)
    B, M, N, C = _require_descs(dsc0, dsc1, "pair_topk")
    for t, name, shape in ((scr0, "scr0", (B, M)), (scr1, "scr1", (B, N)), (lse_col, "lse_col", (B, N))):
        _cuda.require(t, name, torch.float32, shape, dsc0.device)
    most = _cuda.lib().mk_pair_topk_max_l()
    if not 1 <= topl <= most:
        raise ValueError(f"pair_topk: row_topl {topl} outside 1..{most}")
    dev = dsc0.device
    chunks = topk_chunks(B, M, N, dev)
    vals = torch.empty((B, topl, M), dtype=torch.float32, device=dev)
    idxs = torch.empty((B, topl, M), dtype=torch.int32, device=dev)
    stats = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    lse_row = torch.empty((B, M), dtype=torch.float32, device=dev)
    split, do_split = _split_for(split, B, M, N, dev, dsc0.dtype)
    work = _topk_work(B, M, topl, chunks, dev)
    _launch("pair_topk", dsc0, dsc1, scr0.data_ptr(), scr1.data_ptr(), lse_col.data_ptr(), vals.data_ptr(),
            idxs.data_ptr(), stats.data_ptr(), lse_row.data_ptr(), split.data_ptr(),
            None if work is None else work.data_ptr(), corr_geometry(B, M, N, dsc0.element_size()), B, M, N, C,
            topl, chunks, float(inv_temp), float(alpha), do_split)
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


def _topk_table(dsc0, dsc1, scr0, scr1, inv_temp: float, alpha: float, prefilter: int, row_topl: int, split=None):
    """K2a, K2b and the top-P glue: (top_scores, top_idx, row_ok, lse_row,
    lse_col); K2a splits the descriptors into ``split`` (``topk_split``,
    made here where it is not given) and K2b reads them there."""
    B, M, _ = dsc0.shape
    scr0 = scr0.float().contiguous()
    scr1 = scr1.float().contiguous()
    split = topk_split(dsc0, dsc1) if split is None else split
    lse_col = col_lse(dsc0, dsc1, inv_temp, alpha, split)
    vals, idxs, stats, lse_row = pair_topk(dsc0, dsc1, scr0, scr1, lse_col, inv_temp, alpha, row_topl, split)
    row_ok = (
        (stats[..., 1].sum(dim=-1) == 0)  # all finite
        & (stats[..., 2].amin(dim=-1) >= 0)  # nonnegative
        & (stats[..., 0].sum(dim=-1) > 0)  # positive mass
    )
    top_scores, pos = exact_topk_desc(vals.reshape(B, row_topl * M), prefilter)
    top_idx = torch.gather(idxs.reshape(B, row_topl * M), 1, pos)
    return top_scores, top_idx, row_ok, lse_row, lse_col


def fused_topk_scores(
    dsc0: torch.Tensor,  # (B, M, C) L2-normalized descriptors, fp32 or bf16
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
    return _topk_table(dsc0, dsc1, scr0, scr1, float(1.0 / temperature), _alpha(dustbin, use_dustbin),
                       prefilter, row_topl)[:3]


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

# deepest descriptor the matcher kernels take (csrc/corr_tf32.cuh CORR_C)
DUAL_SOFTMAX_MAX_C = CORR_C


def _require_descs(dsc0, dsc1, name: str, dtypes=(torch.float32, torch.bfloat16)):
    """(B, M, N, C) of descriptors a kernel takes: contiguous, on one card,
    of one dtype among ``dtypes`` (the forward kernels: fp32 or bf16; the
    backward: fp32)."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    if C > DUAL_SOFTMAX_MAX_C:
        raise ValueError(f"{name}: descriptor depth {C} > {DUAL_SOFTMAX_MAX_C}")
    if dsc0.dtype not in dtypes:
        raise TypeError(f"{name}: descriptors of {dsc0.dtype}; the kernels take {', '.join(map(str, dtypes))}")
    _cuda.require(dsc0, "dsc0", dsc0.dtype, (B, M, C), dsc0.device)
    _cuda.require(dsc1, "dsc1", dsc0.dtype, (B, N, C), dsc0.device)
    return B, M, N, C


def _pair_softmax_from(s: torch.Tensor, lse_col: torch.Tensor, alpha: float):
    lse_row = _row_lse(s, alpha)
    return torch.exp(s - lse_row[..., None]) * torch.exp(s - lse_col[:, None, :]), lse_row


def pair_softmax_plain(dsc0, dsc1, lse_col, inv_temp: float, alpha: float):
    """Plain version of ``pair_softmax``, of its fp32 and bf16 kernels alike."""
    return _pair_softmax_from(_correlation(dsc0, dsc1, inv_temp), lse_col, alpha)


def pair_softmax(dsc0, dsc1, lse_col, inv_temp: float, alpha: float, scratch=None):
    """(out (B, M, N) = exp(s - lse_row) exp(s - lse_col), lse_row (B, M)),
    both fp32, lse_row with the dustbin column ``alpha``; fp32 or bf16
    descriptors; ``lse_col`` from ``col_lse``; ``scratch``
    (``_corr_scratch`` of their dtype) as for ``col_lse``."""
    if dsc0.device.type == "cpu":
        return pair_softmax_plain(dsc0, dsc1, lse_col, inv_temp, alpha)
    B, M, N, C = _require_descs(dsc0, dsc1, "pair_softmax")
    _cuda.require(lse_col, "lse_col", torch.float32, (B, N), dsc0.device)
    dev = dsc0.device
    out = torch.empty((B, M, N), dtype=torch.float32, device=dev)
    lse_row = torch.empty((B, M), dtype=torch.float32, device=dev)
    scratch = _corr_scratch(B, M, N, dev, dtype=dsc0.dtype) if scratch is None else scratch
    _launch("pair_softmax", dsc0, dsc1, lse_col.data_ptr(), out.data_ptr(), lse_row.data_ptr(), scratch.data_ptr(),
            corr_geometry(B, M, N, dsc0.element_size()), B, M, N, C, float(inv_temp), float(alpha))
    return out, lse_row


# -- K5: analytic backward -------------------------------------------------------


def _bwd_sums_from(s, g, lse_row, lse_col):
    gp = g * torch.exp(2.0 * s - lse_row[..., None] - lse_col[:, None, :])
    return gp.sum(dim=2), gp.sum(dim=1)


def dual_softmax_bwd_sums_plain(dsc0, dsc1, g, lse_row, lse_col, inv_temp: float):
    return _bwd_sums_from(_correlation(dsc0, dsc1, inv_temp), g, lse_row, lse_col)


def dual_softmax_bwd_sums_3xtf32_plain(dsc0, dsc1, g, lse_row, lse_col, inv_temp: float, passes: int = 3):
    """K5's first body's arithmetic on the CPU: ``dual_softmax_bwd_sums_plain``
    on the engine's correlation (own = dsc0)."""
    return _bwd_sums_from(corr_3xtf32_plain(dsc0, dsc1, inv_temp, passes), g, lse_row, lse_col)


def dual_softmax_bwd_sums(dsc0, dsc1, g, lse_row, lse_col, inv_temp: float, split=None):
    """(r (B, M), c (B, N)): row and column sums of G * P. ``split``: the
    forward's split of these descriptors (``_split_for``), else made here."""
    if dsc0.device.type == "cpu":
        return dual_softmax_bwd_sums_plain(dsc0, dsc1, g, lse_row, lse_col, inv_temp)
    B, M, N, C = _require_descs(dsc0, dsc1, "dual_softmax_bwd_sums", (torch.float32,))
    for t, name, shape in ((g, "g", (B, M, N)), (lse_row, "lse_row", (B, M)), (lse_col, "lse_col", (B, N))):
        _cuda.require(t, name, torch.float32, shape, dsc0.device)
    lib = _cuda.lib()
    dev = dsc0.device
    r = torch.empty((B, M), dtype=torch.float32, device=dev)
    c = torch.empty((B, N), dtype=torch.float32, device=dev)
    cpart = torch.empty((B, lib.mk_dual_softmax_row_blocks(M), N), dtype=torch.float32, device=dev)
    split, do_split = _split_for(split, B, M, N, dev)
    rc = lib.mk_dual_softmax_bwd_sums_f32(
        dsc0.data_ptr(), dsc1.data_ptr(), g.data_ptr(), lse_row.data_ptr(), lse_col.data_ptr(),
        r.data_ptr(), c.data_ptr(), cpart.data_ptr(), split.data_ptr(), corr_geometry(B, M, N), B, M, N, C,
        float(inv_temp), do_split, _cuda.stream_ptr(dsc0),
    )
    _cuda.check(rc, "dual_softmax_bwd_sums")
    _cuda.LAUNCHES["dual_softmax_bwd_sums"] += 1
    return r, c


def _grads_ds(s, g, lse_own, lse_oth, w_own, w_oth):
    """dS of one side, the owned axis first: K5's 2 P G - A w_oth - B w_own
    (``g`` given) or K6's w_own B + w_oth A, with A = exp(s - lse_oth) the
    softmax along the owned axis and B = exp(s - lse_own)."""
    A = torch.exp(s - lse_oth[:, None, :])
    Bm = torch.exp(s - lse_own[..., None])
    if g is None:
        return w_own[..., None] * Bm + w_oth[:, None, :] * A
    return 2.0 * (A * Bm) * g - A * w_oth[:, None, :] - Bm * w_own[..., None]


def dual_softmax_bwd_grads_plain(dsc0, dsc1, g, lse_row, lse_col, r, c, inv_temp: float):
    dS = _grads_ds(_correlation(dsc0, dsc1, inv_temp), g, lse_row, lse_col, r, c)
    return torch.matmul(dS, dsc1.float()) * inv_temp, torch.matmul(dS.transpose(1, 2), dsc0.float()) * inv_temp


def dual_softmax_bwd_grads_3xtf32_plain(dsc0, dsc1, g, lse_row, lse_col, r, c, inv_temp: float, passes: int = 3):
    """The gradient kernels' arithmetic on the CPU (K5's second body; K6's
    with ``g`` None and the cotangents as r, c): per side (dd0 owns dsc0's
    rows, dd1 dsc1's, as the kernel's two launches) s on the engine, dS in
    fp32, then dS X_oth with dS split as the descriptors are
    (``corr_3xtf32_plain`` of dS and X_oth^T)."""
    out = []
    for x_own, x_oth, g_side, l_own, l_oth, w_own, w_oth in (
            (dsc0, dsc1, g, lse_row, lse_col, r, c),
            (dsc1, dsc0, None if g is None else g.transpose(1, 2), lse_col, lse_row, c, r)):
        dS = _grads_ds(corr_3xtf32_plain(x_own, x_oth, inv_temp, passes), g_side, l_own, l_oth, w_own, w_oth)
        out.append(corr_3xtf32_plain(dS, x_oth.float().transpose(1, 2), inv_temp, passes))
    return tuple(out)


def _grads_launch(entry: str, dsc0, dsc1, vecs, inv_temp: float, split):
    """The gradient kernels' wrapper body: dd0, dd1 from the C entry
    ``entry`` on the checked descriptors and the vectors' pointers."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    dev = dsc0.device
    dd0 = torch.empty((B, M, C), dtype=torch.float32, device=dev)
    dd1 = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    split, do_split = _split_for(split, B, M, N, dev)
    rc = getattr(_cuda.lib(), entry)(
        dsc0.data_ptr(), dsc1.data_ptr(), *(v.data_ptr() for v in vecs), dd0.data_ptr(), dd1.data_ptr(),
        split.data_ptr(), _t_scratch(B, M, N, dev).data_ptr(), corr_bwd_geometry(B, M, N), B, M, N, C,
        float(inv_temp), do_split, _cuda.stream_ptr(dsc0),
    )
    return rc, dd0, dd1


def dual_softmax_bwd_grads(dsc0, dsc1, g, lse_row, lse_col, r, c, inv_temp: float, split=None):
    """(dd0 (B, M, C), dd1 (B, N, C)) = (dS dsc1 / T, dS^T dsc0 / T);
    ``split`` as for ``dual_softmax_bwd_sums``."""
    if dsc0.device.type == "cpu":
        return dual_softmax_bwd_grads_plain(dsc0, dsc1, g, lse_row, lse_col, r, c, inv_temp)
    B, M, N, C = _require_descs(dsc0, dsc1, "dual_softmax_bwd_grads", (torch.float32,))
    for t, name, shape in ((g, "g", (B, M, N)), (lse_row, "lse_row", (B, M)), (lse_col, "lse_col", (B, N)),
                           (r, "r", (B, M)), (c, "c", (B, N))):
        _cuda.require(t, name, torch.float32, shape, dsc0.device)
    rc, dd0, dd1 = _grads_launch("mk_dual_softmax_bwd_grads_f32", dsc0, dsc1, (g, lse_row, lse_col, r, c), inv_temp,
                                 split)
    _cuda.check(rc, "dual_softmax_bwd_grads")
    _cuda.LAUNCHES["dual_softmax_bwd_grads"] += 1
    return dd0, dd1


# -- the route -------------------------------------------------------------------


def _save_meta(ctx, dsc0, dsc1, dustbin, inv_temp: float, alpha: float, use_dustbin: bool) -> None:
    """What a backward needs besides its saved tensors."""
    ctx.inv_temp, ctx.alpha, ctx.use_dustbin = inv_temp, alpha, use_dustbin
    ctx.dtypes = (dsc0.dtype, dsc1.dtype)
    ctx.dustbin_meta = (dustbin.shape, dustbin.dtype) if torch.is_tensor(dustbin) else None


def _dustbin_grad(ctx, w_row, w_col, lse_row, lse_col):
    """d alpha = sum_i w_row_i exp(a - lse_row_i) + sum_j w_col_j exp(a - lse_col_j),
    in the dustbin input's shape and type; None where it was a float. The
    closed form holds because the dustbin entries carry no cotangent of
    their own."""
    if ctx.dustbin_meta is None:
        return None
    shape, dtype = ctx.dustbin_meta
    if ctx.use_dustbin:
        a = ctx.alpha
        da = (w_row * torch.exp(a - lse_row)).sum() + (w_col * torch.exp(a - lse_col)).sum()
    else:
        da = torch.zeros((), dtype=torch.float32, device=lse_row.device)
    return da.reshape(shape).to(dtype)


def _forward(dsc0, dsc1, inv_temp: float, alpha: float, split=None):
    lse_col = col_lse(dsc0, dsc1, inv_temp, alpha)
    out, lse_row = pair_softmax(dsc0, dsc1, lse_col, inv_temp, alpha, split)
    return out, lse_row, lse_col


def fused_dual_softmax(dsc0, dsc1, dustbin, temperature: float = 0.1, use_dustbin: bool = True):
    """(B, M, N) fp32 dual-softmax match scores, forward only (no autograd
    graph). bf16 descriptors (``cfg.TPU.MATCHER_BF16``) stay bf16 and take
    the kernels' bf16 mode; any other dtype is computed in fp32."""
    d0, d1 = (d.detach().contiguous() if d.dtype == torch.bfloat16 else d.detach().float().contiguous()
              for d in (dsc0, dsc1))
    return _forward(d0, d1, float(1.0 / temperature), _alpha(dustbin, use_dustbin))[0]


class _FusedDualSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dsc0, dsc1, dustbin, inv_temp: float, use_dustbin: bool):
        d0, d1 = (d.float().contiguous() for d in (dsc0, dsc1))
        alpha = _alpha(dustbin, use_dustbin)
        # K4's split descriptors, kept for the backward's kernels
        ctx.split = _corr_scratch(d0.shape[0], d0.shape[1], d1.shape[1], d0.device) if d0.is_cuda else None
        out, lse_row, lse_col = _forward(d0, d1, inv_temp, alpha, ctx.split)
        ctx.save_for_backward(d0, d1, lse_row, lse_col)
        _save_meta(ctx, dsc0, dsc1, dustbin, inv_temp, alpha, use_dustbin)
        return out

    @staticmethod
    def backward(ctx, g):
        d0, d1, lse_row, lse_col = ctx.saved_tensors
        g = g.float().contiguous()
        r, c = dual_softmax_bwd_sums(d0, d1, g, lse_row, lse_col, ctx.inv_temp, ctx.split)
        dd0, dd1 = dual_softmax_bwd_grads(d0, d1, g, lse_row, lse_col, r, c, ctx.inv_temp, ctx.split)
        dalpha = _dustbin_grad(ctx, -r, -c, lse_row, lse_col)
        return dd0.to(ctx.dtypes[0]), dd1.to(ctx.dtypes[1]), dalpha, None, None


def fused_dual_softmax_vjp(dsc0, dsc1, dustbin, temperature: float = 0.1, use_dustbin: bool = True):
    """Differentiable fused dual-softmax: K4 forward, K5 backward. Gradients
    reach dsc0, dsc1 and, where it is a tensor, the dustbin logit."""
    return _FusedDualSoftmax.apply(dsc0, dsc1, dustbin, float(1.0 / temperature), bool(use_dustbin))


# -- K6: the logsumexps' backward (fused top-K training) --------------------------


def lse_bwd_plain(dsc0, dsc1, gr, gc, lse_row, lse_col, inv_temp: float):
    dS = _grads_ds(_correlation(dsc0, dsc1, inv_temp), None, lse_row, lse_col, gr, gc)
    return torch.matmul(dS, dsc1.float()) * inv_temp, torch.matmul(dS.transpose(1, 2), dsc0.float()) * inv_temp


def lse_bwd_3xtf32_plain(dsc0, dsc1, gr, gc, lse_row, lse_col, inv_temp: float, passes: int = 3):
    """K6's arithmetic on the CPU (``dual_softmax_bwd_grads_3xtf32_plain`` without G)."""
    return dual_softmax_bwd_grads_3xtf32_plain(dsc0, dsc1, None, lse_row, lse_col, gr, gc, inv_temp, passes)


def lse_bwd(dsc0, dsc1, gr, gc, lse_row, lse_col, inv_temp: float, split=None):
    """(dd0 (B, M, C), dd1 (B, N, C)) = (dS dsc1 / T, dS^T dsc0 / T) with
    dS = gr exp(s - lse_row) + gc exp(s - lse_col): the VJP of the two
    dustbin-augmented logsumexps; ``split`` as for ``dual_softmax_bwd_sums``."""
    if dsc0.device.type == "cpu":
        return lse_bwd_plain(dsc0, dsc1, gr, gc, lse_row, lse_col, inv_temp)
    B, M, N, C = _require_descs(dsc0, dsc1, "lse_bwd", (torch.float32,))
    for t, name, shape in ((gr, "gr", (B, M)), (gc, "gc", (B, N)), (lse_row, "lse_row", (B, M)),
                           (lse_col, "lse_col", (B, N))):
        _cuda.require(t, name, torch.float32, shape, dsc0.device)
    rc, dd0, dd1 = _grads_launch("mk_lse_bwd_f32", dsc0, dsc1, (gr, gc, lse_row, lse_col), inv_temp, split)
    _cuda.check(rc, "lse_bwd")
    _cuda.LAUNCHES["lse_bwd"] += 1
    return dd0, dd1


class _FusedTopKTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dsc0, dsc1, dustbin, scr0, scr1, inv_temp: float, use_dustbin: bool, prefilter: int,
                row_topl: int):
        d0, d1 = (d.float().contiguous() for d in (dsc0, dsc1))
        alpha = _alpha(dustbin, use_dustbin)
        # K2a's split descriptors, read by K2b and kept for the backward's kernels
        ctx.split = topk_split(d0, d1)
        top_scores, top_idx, row_ok, lse_row, lse_col = _topk_table(d0, d1, scr0, scr1, inv_temp, alpha,
                                                                    prefilter, row_topl, ctx.split)
        ctx.save_for_backward(d0, d1, lse_row, lse_col)
        _save_meta(ctx, dsc0, dsc1, dustbin, inv_temp, alpha, use_dustbin)
        ctx.mark_non_differentiable(top_scores, top_idx, row_ok)
        return top_scores, top_idx, row_ok, lse_row, lse_col

    @staticmethod
    def backward(ctx, _g_scores, _g_idx, _g_ok, gr, gc):
        d0, d1, lse_row, lse_col = ctx.saved_tensors
        gr = torch.zeros_like(lse_row) if gr is None else gr.float().contiguous()
        gc = torch.zeros_like(lse_col) if gc is None else gc.float().contiguous()
        dd0, dd1 = lse_bwd(d0, d1, gr, gc, lse_row, lse_col, ctx.inv_temp, ctx.split)
        dalpha = _dustbin_grad(ctx, gr, gc, lse_row, lse_col)
        return dd0.to(ctx.dtypes[0]), dd1.to(ctx.dtypes[1]), dalpha, None, None, None, None, None, None


def fused_topk_scores_train(
    dsc0: torch.Tensor,  # (B, M, C) L2-normalized descriptors
    dsc1: torch.Tensor,  # (B, N, C)
    scr0: torch.Tensor,  # (B, M) detection scores
    scr1: torch.Tensor,  # (B, N)
    dustbin,
    prefilter: int,
    temperature: float = 0.1,
    use_dustbin: bool = True,
    row_topl: int = 16,
):
    """Training route of the fused matcher -> top-K. Returns (top_scores
    (B, P) detached final scores, descending, top_idx (B, P) int32 flat
    indices, row_ok (B,), lse_row (B, M) and lse_col (B, N), both
    grad-carrying: K2a + K2b forward, K6 backward). scr0 / scr1 enter the
    table detached; their gradient flows through the loss's explicit log
    terms. Gradients reach dsc0, dsc1 and, where it is a tensor, the dustbin
    logit."""
    return _FusedTopKTrain.apply(dsc0, dsc1, dustbin, scr0.detach(), scr1.detach(), float(1.0 / temperature),
                                 bool(use_dustbin), int(prefilter), int(row_topl))


def dense_lse(dsc0, dsc1, dustbin, temperature: float, use_dustbin: bool):
    """(lse_row (B, M), lse_col (B, N)) over the dustbin-augmented correlation,
    differentiable by autograd: the oracle of K6."""
    s = torch.einsum("bmc,bnc->bmn", dsc0.float(), dsc1.float()) / temperature
    lse_row = torch.logsumexp(s, dim=2)
    lse_col = torch.logsumexp(s, dim=1)
    if use_dustbin:
        a = torch.as_tensor(dustbin, dtype=torch.float32, device=s.device)
        lse_row = torch.logaddexp(lse_row, a)
        lse_col = torch.logaddexp(lse_col, a)
    return lse_row, lse_col


def dense_topk_scores_train(dsc0, dsc1, scr0, scr1, dustbin, prefilter: int, temperature: float = 0.1,
                            use_dustbin: bool = True, row_topl: int = 16):
    """The five outputs of ``fused_topk_scores_train`` from the dense
    dual-softmax product (table detached, logsumexps by autograd)."""
    lse_row, lse_col = dense_lse(dsc0, dsc1, dustbin, temperature, use_dustbin)
    with torch.no_grad():
        s = torch.einsum("bmc,bnc->bmn", dsc0.float(), dsc1.float()) / temperature
        final = torch.exp(2.0 * s - lse_row[:, :, None] - lse_col[:, None, :]) * scr0[:, :, None] * scr1[:, None, :]
        top_scores, top_idx, row_ok = dense_topk_scores(final, prefilter, row_topl=row_topl)
    return top_scores, top_idx, row_ok, lse_row, lse_col
