"""Attention for the frozen DINOv2 backbone, on its two layouts and in both
backbone precisions.

Counterparts of ``mickey_tpu/ops/flash_attention.py``:

``flash_attention_packed`` (K1): ``qkv`` is the fused qkv linear output,
(B, S, 3C) with its minor dim packed head-major as (H, 3, D) (the layout
``mickey_tpu``'s checkpoint converter writes); the result is head-concat
(B, S, C) for the proj linear.

``flash_attention`` (K1b): q, k, v of shape (B, H, S, D), keys at positions
>= ``seq_len`` masked; the result is (B, H, S, D). The kernel reads any
strides over (B, H, S), so the permuted views of the qkv output need no copy.

Both dispatch on the dtype, as the JAX kernels run in the stored dtype: bf16
(``MICKEY.DINOV2.FLOAT16``, the default) goes to the tensor-core kernel of
``csrc/flash_attention_packed.cu``; fp32 (the exact mode, ``FLOAT16=False``)
to K1f in ``csrc/flash_attention_f32.cu`` (``flash_attention_packed_f32``,
``flash_attention_f32``), whose products are 3xTF32 on the tensor cores:
each fp32 operand split into two TF32 parts, three passes a product, fp32
accuracy. K1f's third entry, ``flash_attention_packed_upcast``, is the tools'
K1-old (``tools/bench_backbone_profile.py::old_packed_kernel``): packed bf16
qkv upcast, fp32-accurate math, bf16 out, keys at or past ``seq_len`` masked.

On a CUDA tensor each wrapper launches its hand-written kernel (D = 64) or
raises; on a CPU tensor it takes the plain version, which upcasts to fp32
like ``attention_reference``. The sequence is never padded: the kernels mask
their ragged last key tile themselves.

Both kernels read their tiles through TMA tensor maps: ``map_geometry``
turns a (B, H, S, D) layout into the dims, byte strides and box that a C
entry encodes. The bf16 kernel maps q, k and v themselves, so K1 is K1b on
the ``qkv_heads`` views of its packed input (``packed_heads_layout``) with a
head-concat output. K1f first splits K and V into a scratch buffer (K hi / lo
as (B, H, S_kv, D), V^T hi / lo as (B, H, D, S_kv), S_kv = ``seq_len``
rounded up to 64) and maps that (``_f32_geometry``).
``attention_tiled_plain`` repeats the bf16 kernel's arithmetic tile by tile
(the online softmax in the exp2 domain, bf16-rounded probabilities) and
``attention_3xtf32_plain`` K1f's (the TF32 split, the three passes), for the
tests.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _cuda
from .tf32 import tf32_split

NEG_INF = -1e30  # the TPU kernels' mask value


def qkv_heads(qkv: torch.Tensor, num_heads: int):
    """q, k, v (B, H, S, D): views, with no copy, of a head-major packed
    (B, S, 3C) qkv."""
    b, s, c3 = qkv.shape
    qkv5 = qkv.reshape(b, s, num_heads, 3, c3 // (3 * num_heads))
    return tuple(qkv5[:, :, :, i].transpose(1, 2) for i in range(3))


def attention_packed_plain(qkv: torch.Tensor, num_heads: int, seq_len: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: fp32 softmax attention over the keys before
    ``seq_len`` (default: all), output in qkv.dtype."""
    b, s, c3 = qkv.shape
    seq_len = s if seq_len is None else seq_len
    return attention_plain(*qkv_heads(qkv, num_heads), seq_len).transpose(1, 2).reshape(b, s, c3 // 3)


def _packed_checks(name: str, qkv: torch.Tensor, num_heads: int, dtype: torch.dtype):
    """Check a (B, S, 3C) head-major packed qkv on the card: D = 64, the
    dtype, contiguous, 16-byte aligned (the kernels' 16-byte vector and TMA
    loads). Returns (B, S, C)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    if c % num_heads or c // num_heads != 64:
        raise ValueError(f"{name}: head dim must be 64, got C={c}, H={num_heads}")
    _cuda.require(qkv, "qkv", dtype, (b, s, c3), qkv.device)
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned (16-byte vector loads)")
    return b, s, c


def _packed_launch(entry: str, name: str, qkv: torch.Tensor, num_heads: int, dtype: torch.dtype,
                   seq_len: int | None = None) -> torch.Tensor:
    """Launch K1f's packed entry ``entry`` on a checked qkv and count it
    under ``name``; (B, S, C) out in qkv's dtype. K1-old's entry takes
    ``seq_len``; K1 at fp32 attends to every key."""
    b, s, c = _packed_checks(name, qkv, num_heads, dtype)
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    scratch, geom = _f32_scratch(b, num_heads, s if seq_len is None else seq_len, dtype == torch.float32, qkv.device)
    extra = () if seq_len is None else (seq_len,)
    rc = getattr(_cuda.lib(), entry)(qkv.data_ptr(), out.data_ptr(), scratch.data_ptr(), geom, b, s, num_heads, *extra,
                                     1.0 / math.sqrt(64), _cuda.stream_ptr(qkv))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


TMA_BOX_ROWS = 64  # sequence rows per TMA box: the bf16 Q tile, half a K or V tile
SWIZZLE_BYTES = 128  # one row of the 128-byte swizzle: the widest box row a map may have


def map_geometry(shape, strides, item: int, box_rows: int = TMA_BOX_ROWS, box_cols: int | None = None):
    """What a TMA tensor map of a (B, H, S, D) array encodes, from its
    ``shape``, element ``strides`` and element size, innermost dimension
    first: ``dims``, the byte strides of every dimension but the innermost
    (whose stride is the element size), and the ``box`` one TMA load copies.

    Where a row of D values fits one 128-byte swizzle row (bf16, D = 64):
    dims (D, S, H, B), strides of S, H and B, box (D, box_rows, 1, 1). Where
    it does not (fp32, D = 64 is 256 bytes), D is split as (w, D / w) with
    w = 128 / item values a swizzle row, the second part placed after S:
    dims (w, S, D / w, H, B), strides of S, of the w-blocks (128 bytes), of H
    and B, box (w, box_rows, box_cols / w, 1, 1) with ``box_cols`` (default
    D) values of each row; the box lands in shared memory as box_cols / w
    blocks of box_rows 128-byte rows.

    The sequence is a dimension of its own, so a box that runs past S is
    zero-filled and never reads the next head or image. TMA takes unit stride
    over D and strides in multiples of 16 bytes; a dimension of size 1 gets
    the stride a contiguous array would have, whatever stride the view
    reports for it."""
    b, h, s, d = shape
    if strides[3] != 1:
        raise ValueError(f"tensor map: D must have unit stride, got strides {tuple(strides)}")
    out, dense = [], d * item
    for size, stride in ((s, strides[2]), (h, strides[1]), (b, strides[0])):
        out.append(dense if size == 1 else stride * item)
        dense *= size
    if any(st % 16 for st in out):
        raise ValueError(f"tensor map: strides must be multiples of 16 bytes, got byte strides {tuple(out)}")
    if d * item <= SWIZZLE_BYTES:
        return (d, s, h, b), tuple(out), (d, box_rows, 1, 1)
    w = SWIZZLE_BYTES // item
    cols = d if box_cols is None else box_cols
    if d % w or cols % w:
        raise ValueError(f"tensor map: D = {d} and box_cols = {cols} must be multiples of {w}")
    return (w, s, d // w, h, b), (out[0], SWIZZLE_BYTES, out[1], out[2]), (w, box_rows, cols // w, 1, 1)


F32_KEY_TILE = 32  # K1f's keys per tile (csrc/flash_attention_f32.cu BK)
F32_KEY_PAD = 64  # K1f's scratch keys are padded to a multiple of this


def _contiguous_strides(shape):
    return tuple(int(math.prod(shape[i + 1:])) for i in range(len(shape)))


@functools.lru_cache(maxsize=64)
def _f32_geometry(b: int, h: int, s_kv: int):
    """K1f's ``geom`` argument: the tensor maps of its scratch, K (hi or lo)
    as a contiguous (B, H, S_kv, 64) array read ``F32_KEY_TILE`` rows a box,
    then V^T as a contiguous (B, H, 64, S_kv) array read ``F32_KEY_TILE``
    columns of all 64 rows a box; each dims, strides, box (``map_geometry``)."""
    k = map_geometry((b, h, s_kv, 64), _contiguous_strides((b, h, s_kv, 64)), 4, F32_KEY_TILE)
    v = map_geometry((b, h, 64, s_kv), _contiguous_strides((b, h, 64, s_kv)), 4, 64, F32_KEY_TILE)
    return (ctypes.c_longlong * 28)(*(x for g in (k, v) for part in g for x in part))


def _f32_scratch(b: int, h: int, seq_len: int, split_kv: bool, device):
    """K1f's scratch (K hi, [K lo,] V^T hi, [V^T lo], fp32, keys up to
    ``seq_len`` rounded up to 64) and its geometry. bf16 operands (K1-old)
    are exact in TF32 and have no lo parts."""
    s_kv = -(-seq_len // F32_KEY_PAD) * F32_KEY_PAD
    parts = 4 if split_kv else 2
    scratch = torch.empty(parts * b * h * s_kv * 64, dtype=torch.float32, device=device)
    return scratch, _f32_geometry(b, h, s_kv)


def packed_heads_layout(b: int, s: int, num_heads: int, d: int = 64):
    """Shape, element strides and the element offsets of q, k and v of the
    ``qkv_heads`` views of a contiguous head-major packed (B, S, 3 H D) qkv,
    computed without making the views."""
    row = 3 * num_heads * d
    return (b, num_heads, s, d), (s * row, 3 * d, row, 1), (0, d, 2 * d)


@functools.lru_cache(maxsize=256)
def _launch_geometry(shape, q_strides, k_strides, v_strides, item: int, out_strides):
    """The C entry's ``geom`` argument: dims, the three maps' byte strides,
    the box, out's element strides over (B, H, S). Kept per layout, so a
    backbone's 24 blocks compute it once."""
    geoms = [map_geometry(shape, st, item) for st in (q_strides, k_strides, v_strides)]
    dims, _, box = geoms[0]
    return (ctypes.c_longlong * 20)(*dims, *(st for g in geoms for st in g[1]), *box, *out_strides)


def _bf16_launch(name: str, like: torch.Tensor, ptrs, shape, strides, seq_len: int, out: torch.Tensor,
                 out_strides) -> torch.Tensor:
    """Launch the bf16 kernel on checked (B, H, S, D) arrays at ``ptrs`` with
    the element ``strides`` of q, k and v, on ``like``'s stream, and count it
    under ``name``. ``out_strides``: out's element strides over (B, H, S)."""
    geom = _launch_geometry(shape, *strides, like.element_size(), out_strides)
    rc = _cuda.lib().mk_flash_attention_bf16(*ptrs, out.data_ptr(), geom, seq_len, 1.0 / math.sqrt(64),
                                             _cuda.stream_ptr(like))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def flash_attention_packed(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, 3C) head-major packed qkv -> (B, S, C) attention output; bf16
    on the card goes to K1, fp32 to K1f."""
    if qkv.device.type == "cpu":
        return attention_packed_plain(qkv, num_heads)
    if qkv.dtype == torch.float32:
        return flash_attention_packed_f32(qkv, num_heads)
    b, s, c = _packed_checks("flash_attention_packed", qkv, num_heads, torch.bfloat16)
    shape, strides, offsets = packed_heads_layout(b, s, num_heads)
    base, item = qkv.data_ptr(), qkv.element_size()
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)  # head-concat: head h at columns [64 h, 64 h + 64)
    return _bf16_launch("flash_attention_packed", qkv, [base + o * item for o in offsets], shape, (strides,) * 3, s,
                        out, (s * c, 64, c))


def flash_attention_packed_f32(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K1 at fp32: (B, S, 3C) fp32 head-major packed qkv -> (B, S, C) fp32."""
    if qkv.device.type == "cpu":
        return attention_packed_plain(qkv, num_heads)
    return _packed_launch("mk_flash_attention_packed_f32", "flash_attention_packed_f32", qkv, num_heads,
                          torch.float32)


def flash_attention_packed_upcast(qkv: torch.Tensor, num_heads: int, seq_len: int) -> torch.Tensor:
    """K1-old: (B, S, 3C) bf16 head-major packed qkv, upcast to fp32,
    fp32-accurate products and softmax -> (B, S, C) bf16; keys at positions
    >= ``seq_len`` are masked, and rows at or past it are computed like any
    other (the TPU's padded rows)."""
    if qkv.device.type == "cpu":
        return attention_packed_plain(qkv, num_heads, seq_len)
    if not 1 <= seq_len <= qkv.shape[1]:
        raise ValueError(f"flash_attention_packed_upcast: seq_len {seq_len} outside [1, {qkv.shape[1]}]")
    return _packed_launch("mk_flash_attention_packed_upcast_bf16", "flash_attention_packed_upcast", qkv, num_heads,
                          torch.bfloat16, seq_len)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention`` (``attention_reference``):
    fp32 softmax attention over the keys before ``seq_len``, output in q.dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    masked = torch.arange(k.shape[2], device=q.device) >= seq_len
    logits = logits.masked_fill(masked, NEG_INF)
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def attention_tiled_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: int,
                          block_k: int = 128) -> torch.Tensor:
    """The bf16 kernel's arithmetic in plain PyTorch, key tile by key tile:
    fp32 scores, the online softmax in the exp2 domain with
    ``scale * log2(e)`` folded into the exponent, the running max kept on the
    raw scores, probabilities rounded to v's dtype before the PV product (the
    sums take them unrounded), tiles from ``seq_len`` on skipped and only the
    ragged last tile masked. (B, H, S, D) in, (B, H, S, D) out in q's dtype."""
    b, h, s, d = q.shape
    c = (1.0 / math.sqrt(d)) * math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros_like(m)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, seq_len, block_k):
        scores = torch.matmul(qf, kf[:, :, k0:k0 + block_k].transpose(-1, -2))
        if k0 + block_k > seq_len:
            scores[..., seq_len - k0:] = NEG_INF
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        p = torch.exp2(scores * c - m_new * c)
        alpha = torch.exp2((m - m_new) * c)
        denom = alpha * denom + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.matmul(p.to(v.dtype).float(), vf[:, :, k0:k0 + block_k])
        m = m_new
    return (acc / denom.clamp_min(1e-30)).to(q.dtype)


def attention_3xtf32_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: int,
                           block_k: int = F32_KEY_TILE, passes: int = 3) -> torch.Tensor:
    """K1f's arithmetic in plain PyTorch, key tile by key tile: q, k, v and
    the probabilities split by ``tf32_split``; each product as lo*hi + hi*lo
    + hi*hi (``passes=3``; ``passes=1``: hi*hi alone, one TF32 product) with
    every term exact in fp32 and the sums in fp32; the online softmax in the
    exp2 domain as in ``attention_tiled_plain``, its sums on the unsplit
    probabilities; tiles from ``seq_len`` on skipped and only the ragged last
    tile masked. bf16 inputs have lo = 0, which is K1-old's arithmetic.
    (B, H, S, D) in, (B, H, S, D) out in q's dtype."""
    b, h, s, d = q.shape
    c = (1.0 / math.sqrt(d)) * math.log2(math.e)
    (qh, ql), (kh, kl), (vh, vl) = (tf32_split(x.float()) for x in (q, k, v))

    def product(ah, al, bh, bl):
        return torch.matmul(ah, bh) if passes == 1 else (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)

    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros_like(m)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, seq_len, block_k):
        tile = slice(k0, k0 + block_k)
        scores = product(qh, ql, kh[:, :, tile].transpose(-1, -2), kl[:, :, tile].transpose(-1, -2))
        if k0 + block_k > seq_len:
            scores[..., seq_len - k0:] = NEG_INF
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        p = torch.exp2(scores * c - m_new * c)
        alpha = torch.exp2((m - m_new) * c)
        denom = alpha * denom + p.sum(-1, keepdim=True)
        ph, pl = tf32_split(p)
        acc = alpha * acc + product(ph, pl, vh[:, :, tile], vl[:, :, tile])
        m = m_new
    return (acc / denom.clamp_min(1e-30)).to(q.dtype)


def _views_checks(name: str, q, k, v, seq_len: int, dtype: torch.dtype):
    """The checks of the strided entries: D = 64, 1 <= seq_len <= S, one
    device and dtype, one shape, unit stride over D and 16-byte aligned rows
    (the kernels' 16-byte vector loads)."""
    b, h, s, d = q.shape
    if d != 64:
        raise ValueError(f"{name}: head dim must be 64, got {d}")
    if not 1 <= seq_len <= s:
        raise ValueError(f"{name}: seq_len {seq_len} outside [1, {s}]")
    per16 = 128 // torch.finfo(dtype).bits  # elements in 16 bytes
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != (b, h, s, d):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, q {(b, h, s, d)}")
        if t.stride(3) != 1 or any(st % per16 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} rows must be contiguous and 16-byte aligned, "
                             f"strides {t.stride()}")
    return b, h, s, d


def _strided_launch(entry: str, name: str, q, k, v, seq_len: int, dtype: torch.dtype) -> torch.Tensor:
    b, h, s, d = _views_checks(name, q, k, v, seq_len, dtype)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    scratch, geom = _f32_scratch(b, h, seq_len, True, q.device)
    rc = getattr(_cuda.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, scratch.data_ptr(), geom, b, h, s, seq_len,
        1.0 / math.sqrt(64), _cuda.stream_ptr(q),
    )
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B, H, S, D) q, k, v -> (B, H, S, D) attention output; keys at
    positions >= ``seq_len`` are masked. bf16 on the card goes to K1b, fp32
    to K1f."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seq_len)
    if q.dtype == torch.float32:
        return flash_attention_f32(q, k, v, seq_len)
    b, h, s, d = _views_checks("flash_attention", q, k, v, seq_len, torch.bfloat16)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    return _bf16_launch("flash_attention", q, [t.data_ptr() for t in (q, k, v)], (b, h, s, d),
                        tuple(t.stride() for t in (q, k, v)), seq_len, out, (h * s * d, s * d, d))


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: int) -> torch.Tensor:
    """K1b at fp32: (B, H, S, D) fp32 q, k, v -> (B, H, S, D) fp32."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seq_len)
    return _strided_launch("mk_flash_attention_f32", "flash_attention_f32", q, k, v, seq_len, torch.float32)
