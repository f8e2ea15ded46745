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
(``MICKEY.DINOV2.FLOAT16``, the default) goes to the tensor-core kernels of
``csrc/flash_attention_packed.cu``; fp32 (the exact mode, ``FLOAT16=False``)
to K1f in ``csrc/flash_attention_f32.cu``, fp32 FFMA throughout
(``flash_attention_packed_f32``, ``flash_attention_f32``). K1f's third entry,
``flash_attention_packed_upcast``, is the tools' K1-old
(``tools/bench_backbone_profile.py::old_packed_kernel``): packed bf16 qkv
upcast at load, fp32 math, bf16 out, keys at or past ``seq_len`` masked.

On a CUDA tensor each wrapper launches its hand-written kernel (D = 64) or
raises; on a CPU tensor it takes the plain version, which upcasts to fp32
like ``attention_reference``. The sequence is never padded: the kernels mask
their ragged last key tile themselves.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda

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


def _packed_launch(entry: str, name: str, qkv: torch.Tensor, num_heads: int, dtype: torch.dtype,
                   *seq_len: int) -> torch.Tensor:
    """Check a (B, S, 3C) head-major packed qkv on the card (D = 64, the
    dtype, contiguous, 16-byte aligned for the kernels' vector loads), launch
    ``entry`` and count it under ``name``; (B, S, C) out in qkv's dtype."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    if c % num_heads or c // num_heads != 64:
        raise ValueError(f"{name}: head dim must be 64, got C={c}, H={num_heads}")
    _cuda.require(qkv, "qkv", dtype, (b, s, c3), qkv.device)
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be 16-byte aligned (16-byte vector loads)")
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    rc = getattr(_cuda.lib(), entry)(qkv.data_ptr(), out.data_ptr(), b, s, num_heads, *seq_len, 1.0 / math.sqrt(64),
                                     _cuda.stream_ptr(qkv))
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
    return _packed_launch("mk_flash_attention_packed_bf16", "flash_attention_packed", qkv, num_heads, torch.bfloat16)


def flash_attention_packed_f32(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K1 at fp32: (B, S, 3C) fp32 head-major packed qkv -> (B, S, C) fp32."""
    if qkv.device.type == "cpu":
        return attention_packed_plain(qkv, num_heads)
    return _packed_launch("mk_flash_attention_packed_f32", "flash_attention_packed_f32", qkv, num_heads,
                          torch.float32)


def flash_attention_packed_upcast(qkv: torch.Tensor, num_heads: int, seq_len: int) -> torch.Tensor:
    """K1-old: (B, S, 3C) bf16 head-major packed qkv, upcast to fp32 at load,
    fp32 products and softmax -> (B, S, C) bf16; keys at positions
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
    rc = getattr(_cuda.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides, b, h, s, seq_len,
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
    return _strided_launch("mk_flash_attention_bf16", "flash_attention", q, k, v, seq_len, torch.bfloat16)


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: int) -> torch.Tensor:
    """K1b at fp32: (B, H, S, D) fp32 q, k, v -> (B, H, S, D) fp32."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seq_len)
    return _strided_launch("mk_flash_attention_f32", "flash_attention_f32", q, k, v, seq_len, torch.float32)
