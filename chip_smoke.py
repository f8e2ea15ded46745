#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``mickey_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:

1. build   - compile the CUDA kernels (``mickey_tpu_torch/csrc``) with nvcc
             for sm_90a and print ``-Xptxas -v`` per kernel;
2. kernels - every kernel against its plain PyTorch version at the shapes
             its main path gives it (serving: B = 2 pairs; training: B = 8
             pairs, 1938 keypoints; K1-old: the tools' (16, 2048, 3072)
             bf16 ablation input), with the tolerances stated below, and
             the attention kernels (bf16 K1 / K1b, fp32 K1f) on ragged
             lengths and with seq_len < S; the
             training matcher's whole forward and backward against
             torch.autograd of the dense dual-softmax, and the fused top-K
             training route's against the dense table and torch.autograd of
             the dense logsumexps;
3. slice   - the pose-serving main path at full ViT-L width (714x532 images,
             1938 keypoints, B = 2 pairs, seeded random weights) in both
             layouts (general pairs, shared keyframe); outputs finite and of
             the right shape, every serving kernel launched; then the general
             layout with ``TPU.PACKED_ATTENTION=False`` (K1b launched, K1 not,
             backbone features within the bf16 bound of the packed run's);
             then a small input run on the card checked stage by stage
             against the plain CPU path;
   exact   - the exact inference path at full width
             (``MICKEY.DINOV2.FLOAT16=False``: the fp32 backbone through
             K1f): the full output (``lite=False``, dense route) with every
             field of the JAX package's shape, and the dense route's lite
             outputs (``TPU.FUSED_TOPK=False``, both layouts); K1f and the
             dense kernels launched, no bf16 attention nor K2b; then the
             fp32 backbone on unpacked attention against packed (1e-5
             relative) and the bf16 backbone against the fp32 one (cosine
             > 0.999), the default config's dense full output against the
             fused route's top-P table, a synthetic upstream checkpoint
             loaded bitwise, and a small input against the plain CPU path;
   train   - the staged training step (``MicKeyTrainer``) at full width,
             default config, B = 8 pairs of 714x532, on both matcher routes
             (dense; fused top-K with ``TPU.TRAIN_FUSED_TOPK=True``): 3 steps
             each with finite loss, grad norm and gradients, every trainable
             leaf and the BN running stats changed, the backbone unchanged,
             every kernel of the route launched and none of the other's;
             then one small-input step's loss, gradients and BN stats on each
             route on the card against the plain CPU path with injected draws;
4. timing  - CUDA-event medians of both serving layouts (pairs/s) and their
             stages, of the exact path and its stages, of the default
             config's full output, of the train step and its stages on both
             routes, of each kernel beside its plain version, its bound on
             the card and, where one PyTorch call computes the same function,
             that call (these three per call of 10 enqueued back to back, so
             that the host's launch work hides behind the queue as it does
             inside a model); and the tools' K1-old A/B (K1's bf16 body
             against K1-old's counterpart at (16, 2048, 3072)).

``python3 chip_smoke.py --attention`` runs the bf16 attention kernel alone
(``attention_report``): its checks, its times beside the library call, single
calls and back to back, and its timing ablations, as one JSON line.
``python3 chip_smoke.py --attention-f32`` does the same for the fp32 one, K1f
(``attention_f32_report``): its checks, its three entries back to back
beside SDPA fp32 with TF32 off, and its timing ablations.

Prints the card's name and power limit first, a JSON line of per-kernel
results before the last line, and ``{"ok": true, "device": ...}`` last. There
is no CPU mode: without CUDA it exits 1 before printing any result. The phase
functions take the device and the sizes as arguments, so the CPU tests
rehearse them at a tiny size, where every wrapper takes its plain version.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

SEED = 0
# (name, source, TPU kernel body replaced)
KERNELS = (
    ("flash_attention_packed", "mickey_tpu_torch/csrc/flash_attention_packed.cu",
     "mickey_tpu/ops/flash_attention.py:132"),
    ("flash_attention", "mickey_tpu_torch/csrc/flash_attention_packed.cu",
     "mickey_tpu/ops/flash_attention.py:75"),
    ("flash_attention_packed_f32", "mickey_tpu_torch/csrc/flash_attention_f32.cu",
     "mickey_tpu/ops/flash_attention.py:132"),
    ("flash_attention_f32", "mickey_tpu_torch/csrc/flash_attention_f32.cu",
     "mickey_tpu/ops/flash_attention.py:75"),
    ("flash_attention_packed_upcast", "mickey_tpu_torch/csrc/flash_attention_f32.cu",
     "tools/bench_backbone_profile.py:92"),
    ("col_lse", "mickey_tpu_torch/csrc/fused_topk.cu", "mickey_tpu/ops/fused_matcher.py:82"),
    ("pair_topk", "mickey_tpu_torch/csrc/fused_topk.cu", "mickey_tpu/ops/fused_matcher.py:432"),
    ("hypothesis_scores", "mickey_tpu_torch/csrc/hypothesis_scoring.cu",
     "mickey_tpu/ops/hypothesis_scoring.py:33"),
    ("pair_softmax", "mickey_tpu_torch/csrc/dual_softmax.cu", "mickey_tpu/ops/fused_matcher.py:107"),
    ("dual_softmax_bwd_sums", "mickey_tpu_torch/csrc/dual_softmax.cu", "mickey_tpu/ops/fused_matcher.py:234"),
    ("dual_softmax_bwd_grads", "mickey_tpu_torch/csrc/dual_softmax.cu", "mickey_tpu/ops/fused_matcher.py:256"),
    ("lse_bwd", "mickey_tpu_torch/csrc/dual_softmax.cu", "mickey_tpu/ops/fused_matcher.py:665"),
)
# each main path's kernels, and the kernels it must not launch
SERVING_KERNELS = ("flash_attention_packed", "col_lse", "pair_topk", "hypothesis_scores")
UNPACKED_SERVING_KERNELS = ("flash_attention", "col_lse", "pair_topk", "hypothesis_scores")
TRAIN_KERNELS = ("flash_attention_packed", "col_lse", "pair_softmax", "dual_softmax_bwd_sums",
                 "dual_softmax_bwd_grads")
FUSED_TRAIN_KERNELS = ("flash_attention_packed", "col_lse", "pair_topk", "lse_bwd")
DENSE_MATCHER_KERNELS = ("pair_softmax", "dual_softmax_bwd_sums", "dual_softmax_bwd_grads")
# the exact path (FLOAT16=False, the dense route's full output and its lite
# outputs with FUSED_TOPK=False), and the tools' K1-old A/B
EXACT_KERNELS = ("flash_attention_packed_f32", "col_lse", "pair_softmax", "hypothesis_scores")
EXACT_ABSENT = ("flash_attention_packed", "flash_attention", "pair_topk")
ABLATION_KERNELS = ("flash_attention", "flash_attention_packed_upcast")
# Tolerances (kernel vs plain, same inputs):
#  K1, K1b: bf16 operands and bf16-rounded probabilities against the fp32
#      plain version: |diff| < 2e-2 on O(1) outputs.
#  K1f (fp32 packed and strided): 3xTF32 products (each term within ~2^-21
#      of fp32's) against the plain version's fp32 cuBLAS products (TF32
#      off): |diff| <= 1e-5 max|ref|, at the serving shape, on ragged S and
#      with seq_len < S; two launches bitwise equal; strided bitwise packed.
#      K1-old (bf16 in, fp32-accurate math, bf16 out): within
#      one bf16 ulp of the plain version's rounded output (at the larger of
#      the two), plus K1f's 1e-5 max|ref| for the fp32 results' own
#      difference, on rows below seq_len (the rows past it are the TPU's
#      padded rows).
#  K2, K3: fp32 throughout; only the summation order differs:
#      |diff| <= 1e-5 |ref| + 1e-6 max|ref|; indices that one side selects
#      with a margin above its selection boundary must be selected by the
#      other (exact ties and near-ties may swap).
#  K4, K5: fp32 throughout; the summation order differs and the exponentials
#      amplify it (|s| <= 1/T = 10 carries ~1e-6 absolute error, exp(2 s) twice
#      that relative): P, lse, r, c to |diff| <= 1e-4 |ref| + 1e-6 max|ref|;
#      dd0, dd1 (sums of 1938 terms of both signs) to 1e-4 max|ref|. The whole
#      fused_dual_softmax_vjp against torch.autograd of the dense dual_softmax:
#      values and the dustbin gradient at 1e-4 relative, dsc gradients at
#      1e-4 max|ref|.
#  K6: fp32, summation order amplified by exp as in K5: dd0, dd1 to 1e-4
#      max|ref|. The whole fused_topk_scores_train: the table against the
#      dense dual-softmax's (values at 1e-5 relative, index sets up to
#      near-ties, row_ok equal), lse_row and lse_col against dense_lse at
#      1e-5 relative; its backward against torch.autograd of dense_lse: dsc
#      gradients at 1e-4 max|ref|, the dustbin gradient at 1e-4 relative.
#  Backbone, packed against unpacked attention (K1 against K1b, one kernel
#      body on two addressings, bf16 either way): cosine > 0.999 per image,
#      as the backbone against the plain CPU path.
ATTN_TOL = 2e-2
F32_ATTN_TOL = 1e-5
RTOL = 1e-5
DS_RTOL = 1e-4
MARGIN = 1e-4
#  Train step, small input, card against the plain CPU path stage by stage:
#      see check_train_against_plain; GRAD_TOL bounds each head parameter's
#      gradient on the card against fp64, normwise.
GRAD_TOL = 5e-2


class SmokeError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _close(a: torch.Tensor, b: torch.Tensor, what: str, rtol: float = RTOL) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    err = (a - b).abs()
    bound = rtol * b.abs() + 1e-6 * b.abs().max()
    if not bool((err <= bound).all()):
        raise SmokeError(f"{what}: max |diff| {err.max().item():.3e} exceeds rtol {rtol}")
    return err.max().item()


def _close_to_max(a: torch.Tensor, b: torch.Tensor, what: str, tol: float) -> float:
    """|a - b| <= tol max|b|, for sums whose terms cancel."""
    a, b = a.double().cpu(), b.double().cpu()
    err = (a - b).abs().max().item()
    if not err <= tol * b.abs().max().item():
        raise SmokeError(f"{what}: max |diff| {err:.3e} exceeds {tol} max|ref| = {tol * b.abs().max().item():.3e}")
    return err


def _within_bf16_ulp(a: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Two bf16 roundings of fp32 results that agree to F32_ATTN_TOL max|ref|
    (K1f's bound): |a - ref| <= one bf16 ulp at the larger of the two, plus
    F32_ATTN_TOL max|ref| (near zero the ulp is smaller than the fp32
    results' own difference). Returns max |diff|."""
    a, ref = a.float().cpu(), ref.float().cpu()
    big = torch.maximum(a.abs(), ref.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)  # 2^(e-8) for |x| in [2^(e-1), 2^e)
    err = (a - ref).abs()
    bad = int((err > ulp + F32_ATTN_TOL * ref.abs().max()).sum())
    if bad:
        raise SmokeError(f"{what}: {bad} values beyond one bf16 ulp, max |diff| {err.max().item():.3e}")
    return err.max().item()


def _sets_agree(vals_a, idx_a, vals_b, idx_b, what: str) -> None:
    """Rows of (value, index) selections: each side's entries above its own
    boundary value by MARGIN (relative) must appear in the other's row."""
    va, ia, vb, ib = (np.asarray(x.cpu()).reshape(-1, x.shape[-1]) for x in (vals_a, idx_a, vals_b, idx_b))
    bad = 0
    for r in range(va.shape[0]):
        for v1, i1, i2 in ((va[r], ia[r], ib[r]), (vb[r], ib[r], ia[r])):
            strict = i1[v1 > v1.min() * (1 + MARGIN) + 1e-30]
            bad += int(not np.isin(strict, i2).all())
    if bad:
        raise SmokeError(f"{what}: {bad} rows select different indices beyond near-ties")


def kernel_inputs(device, *, images: int, seq: int, heads: int, kpts: int, desc: int,
                  topl: int, prefilter: int, samples: int, hyps: int, old_images: int, old_seq: int,
                  old_len: int, seed: int = SEED):
    """Seeded inputs at the main path's shapes for each kernel; K1-old's at
    the tools' ablation shape (``old_images`` x ``old_seq`` rows, keys from
    ``old_len`` on masked, N(0, 0.05^2) values as the tool draws them)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    qkv = t(rng.standard_normal((images, seq, 3 * heads * 64), dtype=np.float32)).to(torch.bfloat16)
    d = rng.standard_normal((2, images // 2, kpts, desc), dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    scr = rng.uniform(0, 1, (2, images // 2, kpts)).astype(np.float32)
    scr /= scr.sum(-1, keepdims=True)
    X = rng.uniform(-2, 2, (images // 2, samples, 3)).astype(np.float32)
    ang = rng.uniform(-0.2, 0.2, (images // 2, hyps, 3))
    R = np.stack([_rot(a) for a in ang.reshape(-1, 3)]).reshape(images // 2, hyps, 3, 3).astype(np.float32)
    tr = rng.uniform(-0.1, 0.1, (images // 2, hyps, 1, 3)).astype(np.float32)
    Y = X @ _rot(np.array([0.1, -0.05, 0.02])).T.astype(np.float32) + 0.05
    Y = Y + rng.normal(0, 0.1, Y.shape).astype(np.float32)
    qkv32 = t(rng.standard_normal((images, seq, 3 * heads * 64), dtype=np.float32))
    qkv_old = t(0.05 * rng.standard_normal((old_images, old_seq, 3 * heads * 64), dtype=np.float32)).to(torch.bfloat16)
    return dict(qkv=qkv, heads=heads, dsc0=t(d[0]), dsc1=t(d[1]), scr0=t(scr[0]), scr1=t(scr[1]),
                topl=topl, prefilter=prefilter, X=t(X), Y=t(Y), R=t(R), t=t(tr), qkv32=qkv32, qkv_old=qkv_old,
                old_len=old_len)


def _rot(a) -> np.ndarray:
    ax, ay, az = a
    cx, sx, cy, sy, cz, sz = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def kernel_calls(inp, alpha: float = 1.0, inv_temp: float = 10.0):
    """name -> (kernel call, plain call), both on the same inputs."""
    from mickey_tpu_torch.ops import fused_matcher as fm
    from mickey_tpu_torch.ops.flash_attention import (
        attention_packed_plain,
        attention_plain,
        flash_attention,
        flash_attention_f32,
        flash_attention_packed,
        flash_attention_packed_f32,
        flash_attention_packed_upcast,
        qkv_heads,
    )
    from mickey_tpu_torch.ops.hypothesis_scoring import hypothesis_scores, hypothesis_scores_plain

    heads = inp["heads"]
    q, k, v = qkv_heads(inp["qkv"], heads)  # the strided views the unpacked backbone hands K1b
    q32, k32, v32 = qkv_heads(inp["qkv32"], heads)
    old, old_len = inp["qkv_old"], inp["old_len"]
    seq = q.shape[2]
    lse_c = fm.col_lse_plain(inp["dsc0"], inp["dsc1"], inv_temp, alpha)
    k2b = (inp["dsc0"], inp["dsc1"], inp["scr0"], inp["scr1"], lse_c, inv_temp, alpha, inp["topl"])
    hyp = (inp["X"], inp["Y"], inp["R"], inp["t"], 0.3)
    return {
        "flash_attention_packed": (lambda: flash_attention_packed(inp["qkv"], inp["heads"]),
                                   lambda: attention_packed_plain(inp["qkv"].float(), inp["heads"])),
        "flash_attention": (lambda: flash_attention(q, k, v, seq),
                            lambda: attention_plain(q.float(), k.float(), v.float(), seq)),
        "flash_attention_packed_f32": (lambda: flash_attention_packed_f32(inp["qkv32"], heads),
                                       lambda: attention_packed_plain(inp["qkv32"], heads)),
        "flash_attention_f32": (lambda: flash_attention_f32(q32, k32, v32, seq),
                                lambda: attention_plain(q32, k32, v32, seq)),
        "flash_attention_packed_upcast": (lambda: flash_attention_packed_upcast(old, heads, old_len),
                                          lambda: attention_packed_plain(old, heads, old_len)),
        "col_lse": (lambda: fm.col_lse(inp["dsc0"], inp["dsc1"], inv_temp, alpha),
                    lambda: fm.col_lse_plain(inp["dsc0"], inp["dsc1"], inv_temp, alpha)),
        "pair_topk": (lambda: fm.pair_topk(*k2b), lambda: fm.pair_topk_plain(*k2b)),
        "hypothesis_scores": (lambda: hypothesis_scores(*hyp), lambda: hypothesis_scores_plain(*hyp)),
    }


def check_kernels(inp) -> dict:
    """Phase 2: each kernel against its plain version; returns name -> max |diff|."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    calls = kernel_calls(inp)
    res = check_attention_kernels(inp, calls)
    res.update(check_f32_attention_kernels(inp, calls))
    out, ref = (f()[:, :inp["old_len"]] for f in calls["flash_attention_packed_upcast"])
    res["flash_attention_packed_upcast"] = _within_bf16_ulp(out, ref, "flash_attention_packed_upcast")
    res["col_lse"] = _close(*(f() for f in calls["col_lse"]), "col_lse")
    (v, i, st, lr), (pv, pi, pst, plr) = (f() for f in calls["pair_topk"])
    err = _close(v, pv, "pair_topk values")
    _sets_agree(v.transpose(1, 2), i.transpose(1, 2), pv.transpose(1, 2), pi.transpose(1, 2), "pair_topk rows")
    err = max(err, _close(lr, plr, "pair_topk lse_row"), _close(st[..., 0], pst[..., 0], "pair_topk mass"),
              _close(st[..., 2], pst[..., 2], "pair_topk min"))
    if not torch.equal(st[..., 1].cpu(), pst[..., 1].cpu()):
        raise SmokeError("pair_topk: non-finite counts differ")
    res["pair_topk"] = err
    # the whole route against the dense oracle (dual_softmax -> dense_topk_scores)
    from mickey_tpu_torch.nn.matcher import dual_softmax

    top = fm.fused_topk_scores(inp["dsc0"], inp["dsc1"], inp["scr0"], inp["scr1"], 1.0, inp["prefilter"],
                               row_topl=inp["topl"])
    dense = dual_softmax(inp["dsc0"], inp["dsc1"], 1.0) * inp["scr0"][:, :, None] * inp["scr1"][:, None, :]
    oracle = fm.dense_topk_scores(dense, inp["prefilter"], row_topl=inp["topl"])
    _close(top[0], oracle[0], "fused_topk_scores values")
    _sets_agree(top[0], top[1], oracle[0], oracle[1], "fused_topk_scores table")
    if not torch.equal(top[2].cpu(), oracle[2].cpu()):
        raise SmokeError("fused_topk_scores: row_ok differs from the dense oracle")
    res["hypothesis_scores"] = _close(*(f() for f in calls["hypothesis_scores"]), "hypothesis_scores")
    return res


def _attn_err(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    _sync(out)
    err = (out.float() - ref).abs().max().item()
    if not err < ATTN_TOL:
        raise SmokeError(f"{what}: max |diff| {err:.3e} >= {ATTN_TOL}")
    return err


def check_attention_kernels(inp, calls=None) -> dict:
    """K1 and K1b (bf16) against their plain versions at the serving shape;
    K1b bitwise K1 on the same input (one kernel body on two addressings);
    two launches of each bitwise equal (no atomics, a fixed summation order);
    and K1b with ``seq_len`` < S, on the views of the first 4 images of
    K1-old's padded input (scaled to unit variance) with the keys from
    ``old_len`` on masked, every row against the plain version. Returns
    name -> max |diff|."""
    from mickey_tpu_torch.ops.flash_attention import attention_plain, flash_attention, qkv_heads

    calls = kernel_calls(inp) if calls is None else calls
    res, outs = {}, {}
    for name in ("flash_attention_packed", "flash_attention"):
        outs[name], ref = (f() for f in calls[name])
        res[name] = _attn_err(outs[name], ref, name)
        del ref
    b, s, c3 = inp["qkv"].shape
    if not torch.equal(outs["flash_attention"].transpose(1, 2).reshape(b, s, c3 // 3), outs["flash_attention_packed"]):
        raise SmokeError("flash_attention on the views of a packed qkv differs from flash_attention_packed")
    for name, out in outs.items():
        if not torch.equal(calls[name][0](), out):
            raise SmokeError(f"{name}: two launches on the same input differ")
    # scaled to N(0, 1) like qkv: at K1-old's 0.05 the outputs are far below the tolerance
    views = qkv_heads((inp["qkv_old"][:4].float() * 20.0).to(torch.bfloat16), inp["heads"])
    masked = _attn_err(flash_attention(*views, inp["old_len"]),
                       attention_plain(*(x.float() for x in views), inp["old_len"]),
                       f"flash_attention, seq_len {inp['old_len']} < S {views[0].shape[2]}")
    res["flash_attention"] = max(res["flash_attention"], masked)
    return res


def check_f32_attention_kernels(inp, calls=None) -> dict:
    """K1f packed and strided (fp32) against their plain versions at the
    serving shape, F32_ATTN_TOL of the largest output; strided on the views
    of the packed qkv bitwise packed (one body, one scratch layout); two
    launches of each bitwise equal. Returns name -> max |diff|."""
    calls = kernel_calls(inp) if calls is None else calls
    res, outs = {}, {}
    for name in ("flash_attention_packed_f32", "flash_attention_f32"):
        outs[name], ref = (f() for f in calls[name])
        res[name] = _close_to_max(outs[name], ref, name, F32_ATTN_TOL)
        del ref
        if not torch.equal(calls[name][0](), outs[name]):
            raise SmokeError(f"{name}: two launches on the same input differ")
    b, s, c3 = inp["qkv32"].shape
    if not torch.equal(outs["flash_attention_f32"].transpose(1, 2).reshape(b, s, c3 // 3),
                       outs["flash_attention_packed_f32"]):
        raise SmokeError("flash_attention_f32 on the views of a packed qkv differs from flash_attention_packed_f32")
    return res


ATTN_SEQS = (1939, 129, 128, 127, 65, 64, 1)  # whole tiles, one key over, one under, a single key


def check_attention_shapes(device, dtype=torch.bfloat16, seqs=ATTN_SEQS, heads: int = 16, seed: int = SEED) -> float:
    """The attention kernels on ragged sequences: K1 and K1b for bf16, K1f's
    packed and strided entries for fp32. For each length in ``seqs`` a
    seeded (2, seq, 3 heads 64) qkv (16 images at the second length) through
    both entries against the plain version, the strided entry bitwise the
    packed one; then ``seq_len`` < S on contiguous q, k, v (130 of 200 keys;
    1 of 64). bf16 within ATTN_TOL, fp32 within F32_ATTN_TOL of max|ref|.
    Returns the largest max |diff| (fp32: relative to its max|ref|)."""
    from mickey_tpu_torch.ops import flash_attention as fa

    if dtype == torch.bfloat16:
        packed, strided, rng = fa.flash_attention_packed, fa.flash_attention, np.random.default_rng(seed + 7)
        err = _attn_err
    else:
        packed, strided, rng = fa.flash_attention_packed_f32, fa.flash_attention_f32, np.random.default_rng(seed + 8)

        def err(out, ref, what):
            return _close_to_max(out, ref, what, F32_ATTN_TOL) / ref.abs().max().item()

    make = lambda shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device).to(dtype)  # noqa: E731
    worst = 0.0
    for i, seq in enumerate(seqs):
        qkv = make((16 if i == 1 else 2, seq, 3 * heads * 64))
        out = packed(qkv, heads)
        worst = max(worst, err(out, fa.attention_packed_plain(qkv.float(), heads), f"{packed.__name__}, S = {seq}"))
        out_u = strided(*fa.qkv_heads(qkv, heads), seq)
        if not torch.equal(out_u.transpose(1, 2).reshape(out.shape), out):
            raise SmokeError(f"{strided.__name__} differs from {packed.__name__} at S = {seq}")
    for s, seq_len in ((200, 130), (64, 1)):
        q, k, v = (make((1, 2, s, 64)) for _ in range(3))
        worst = max(worst, err(strided(q, k, v, seq_len), fa.attention_plain(q.float(), k.float(), v.float(), seq_len),
                               f"{strided.__name__}, seq_len {seq_len} < S {s}"))
    return worst


def train_kernel_inputs(device, *, pairs: int, kpts: int, desc: int, seed: int = SEED):
    """Seeded descriptors, an upstream cotangent G, the logsumexps'
    cotangents gr, gc and detection scores at the training matcher's shapes,
    with the intermediate inputs of each K4 / K5 / K6 kernel made by the
    plain versions."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    rng = np.random.default_rng(seed + 2)
    d = rng.standard_normal((2, pairs, kpts, desc), dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    inp = dict(dsc0=t(d[0]), dsc1=t(d[1]), G=t(rng.standard_normal((pairs, kpts, kpts), dtype=np.float32)),
               alpha=1.0, inv_temp=10.0)
    # K6: the logsumexps' cotangents, and detection scores for the table
    for name in ("gr", "gc"):
        inp[name] = t(rng.standard_normal((pairs, kpts), dtype=np.float32))
    for name in ("scr0", "scr1"):
        inp[name] = t(rng.uniform(0.1, 1, (pairs, kpts)).astype(np.float32))
    inp["lse_col"] = fm.col_lse_plain(inp["dsc0"], inp["dsc1"], inp["inv_temp"], inp["alpha"])
    _, inp["lse_row"] = fm.pair_softmax_plain(inp["dsc0"], inp["dsc1"], inp["lse_col"], inp["inv_temp"], inp["alpha"])
    inp["r"], inp["c"] = fm.dual_softmax_bwd_sums_plain(inp["dsc0"], inp["dsc1"], inp["G"], inp["lse_row"],
                                                        inp["lse_col"], inp["inv_temp"])
    return inp


def train_kernel_calls(tin):
    """name -> (kernel call, plain call) for K4, K5 and K6, on the same inputs."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    d0, d1, G, it, a = tin["dsc0"], tin["dsc1"], tin["G"], tin["inv_temp"], tin["alpha"]
    sums = (d0, d1, G, tin["lse_row"], tin["lse_col"], it)
    grads = (d0, d1, G, tin["lse_row"], tin["lse_col"], tin["r"], tin["c"], it)
    lse = (d0, d1, tin["gr"], tin["gc"], tin["lse_row"], tin["lse_col"], it)
    return {
        "pair_softmax": (lambda: fm.pair_softmax(d0, d1, tin["lse_col"], it, a),
                         lambda: fm.pair_softmax_plain(d0, d1, tin["lse_col"], it, a)),
        "dual_softmax_bwd_sums": (lambda: fm.dual_softmax_bwd_sums(*sums),
                                  lambda: fm.dual_softmax_bwd_sums_plain(*sums)),
        "dual_softmax_bwd_grads": (lambda: fm.dual_softmax_bwd_grads(*grads),
                                   lambda: fm.dual_softmax_bwd_grads_plain(*grads)),
        "lse_bwd": (lambda: fm.lse_bwd(*lse), lambda: fm.lse_bwd_plain(*lse)),
    }


def check_train_kernels(tin) -> dict:
    """Phase 2, training matcher: K4 and K5 against their plain versions,
    then the whole fused_dual_softmax_vjp against torch.autograd of the dense
    dual_softmax. Returns name -> max |diff|."""
    from mickey_tpu_torch.nn.matcher import dual_softmax
    from mickey_tpu_torch.ops import fused_matcher as fm

    calls = train_kernel_calls(tin)
    res = {}
    (out, lr), (pout, plr) = (f() for f in calls["pair_softmax"])
    res["pair_softmax"] = max(_close(out, pout, "pair_softmax out", DS_RTOL), _close(lr, plr, "pair_softmax lse_row", DS_RTOL))
    (r, c), (pr, pc) = (f() for f in calls["dual_softmax_bwd_sums"])
    res["dual_softmax_bwd_sums"] = max(_close(r, pr, "bwd_sums r", DS_RTOL), _close(c, pc, "bwd_sums c", DS_RTOL))
    (g0, g1), (pg0, pg1) = (f() for f in calls["dual_softmax_bwd_grads"])
    res["dual_softmax_bwd_grads"] = max(_close_to_max(g0, pg0, "bwd_grads dd0", DS_RTOL),
                                        _close_to_max(g1, pg1, "bwd_grads dd1", DS_RTOL))
    vjp = {}
    for name, fn in (("fused", fm.fused_dual_softmax_vjp), ("dense", dual_softmax)):
        d0, d1 = (tin[k].clone().requires_grad_(True) for k in ("dsc0", "dsc1"))
        a = torch.tensor(tin["alpha"], device=d0.device, requires_grad=True)
        out = fn(d0, d1, a, temperature=1.0 / tin["inv_temp"])
        (out * tin["G"]).sum().backward()
        vjp[name] = (out.detach(), d0.grad, d1.grad, a.grad)
        del out, d0, d1
    (o, g0, g1, ga), (po, pg0, pg1, pga) = vjp["fused"], vjp["dense"]
    _close(o, po, "fused_dual_softmax_vjp values", DS_RTOL)
    _close_to_max(g0, pg0, "fused_dual_softmax_vjp d dsc0", DS_RTOL)
    _close_to_max(g1, pg1, "fused_dual_softmax_vjp d dsc1", DS_RTOL)
    _close(ga.reshape(1), pga.reshape(1), "fused_dual_softmax_vjp d dustbin", DS_RTOL)
    return res


def check_topk_train_kernels(tin, prefilter: int, topl: int) -> dict:
    """Phase 2, fused top-K training route: K6 against its plain version,
    then the whole fused_topk_scores_train against the dense route: its
    table and logsumexps against dense_topk_scores_train, its backward for
    the cotangents (gr, gc) against torch.autograd of dense_lse. Returns
    name -> max |diff|."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    (g0, g1), (pg0, pg1) = (f() for f in train_kernel_calls(tin)["lse_bwd"])
    res = {"lse_bwd": max(_close_to_max(g0, pg0, "lse_bwd dd0", DS_RTOL), _close_to_max(g1, pg1, "lse_bwd dd1", DS_RTOL))}
    temp = 1.0 / tin["inv_temp"]
    runs = {}
    for name, fn in (("fused", fm.fused_topk_scores_train), ("dense", fm.dense_topk_scores_train)):
        d0, d1 = (tin[k].clone().requires_grad_(True) for k in ("dsc0", "dsc1"))
        a = torch.tensor(tin["alpha"], device=d0.device, requires_grad=True)
        out = fn(d0, d1, tin["scr0"], tin["scr1"], a, prefilter, temperature=temp, row_topl=topl)
        ((out[3] * tin["gr"]).sum() + (out[4] * tin["gc"]).sum()).backward()
        runs[name] = [x.detach() for x in out] + [d0.grad, d1.grad, a.grad]
        del out, d0, d1
    (v, i, ok, lr, lc, g0, g1, ga), (pv, pi, pok, plr, plc, pg0, pg1, pga) = runs["fused"], runs["dense"]
    _close(v, pv, "fused_topk_scores_train values")
    _sets_agree(v, i, pv, pi, "fused_topk_scores_train table")
    if not torch.equal(ok.cpu(), pok.cpu()):
        raise SmokeError("fused_topk_scores_train: row_ok differs from the dense oracle")
    _close(lr, plr, "fused_topk_scores_train lse_row")
    _close(lc, plc, "fused_topk_scores_train lse_col")
    _close_to_max(g0, pg0, "fused_topk_scores_train d dsc0", DS_RTOL)
    _close_to_max(g1, pg1, "fused_topk_scores_train d dsc1", DS_RTOL)
    _close(ga.reshape(1), pga.reshape(1), "fused_topk_scores_train d dustbin", DS_RTOL)
    return res


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def slice_inputs(device, pairs: int, height: int, width: int, seed: int = SEED):
    rng = np.random.default_rng(seed + 1)
    ims = rng.uniform(0, 1, (2, pairs, height, width, 3)).astype(np.float32)
    K = np.tile(np.array([[[590.0, 0, width / 2], [0, 590.0, height / 2], [0, 0, 1]]], np.float32), (pairs, 1, 1))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(ims[0]), t(ims[1]), t(K), t(K)


def run_slice(model, image0, image1, K0, K1, layouts=("general", "shared")) -> dict:
    """Phase 3: the serving layouts' lite outputs; finite and of the right shapes."""
    B = image0.shape[0]
    gen = lambda: torch.Generator(device=image0.device).manual_seed(SEED)  # noqa: E731
    outs = {}
    if "general" in layouts:
        outs["general"] = model(image0, image1, K0, K1, generator=gen(), lite=True)
    if "shared" in layouts:
        key_feats = model.extract_feats(image0[:1])
        ref_feats = tuple(f.expand(B, *f.shape[1:]) for f in key_feats)  # one keyframe, every pair
        outs["shared"] = model.call_with_ref_feats(ref_feats, image1, K0, K1, generator=gen())
    for name, out in outs.items():
        _sync(out.R)
        for field, shape in (("R", (B, 3, 3)), ("t", (B, 1, 3)), ("inliers", (B,)), ("valid", (B,))):
            v = getattr(out, field)
            if tuple(v.shape) != shape:
                raise SmokeError(f"{name}.{field}: shape {tuple(v.shape)} != {shape}")
            if v.dtype != torch.bool and not bool(torch.isfinite(v).all()):
                raise SmokeError(f"{name}.{field}: non-finite values")
    return outs


def run_full(model, image0, image1, K0, K1) -> object:
    """Phase 3, exact: the full output (``lite=False``); every field finite
    and of the JAX package's shape."""
    B, h, w, _ = image0.shape
    df = model.cfg.MICKEY.DINOV2.DOWN_FACTOR
    n = (h // df) * (w // df)
    S = int(model.cfg.PROCRUSTES.NUM_SAMPLED_MATCHES)
    out = model(image0, image1, K0, K1, generator=torch.Generator(device=image0.device).manual_seed(SEED))
    _sync(out.R)
    est, corr = out.estimate, out.corr
    fields = [("R", out.R, (B, 3, 3)), ("t", out.t, (B, 1, 3)), ("inliers", out.inliers, (B,)),
              ("valid", out.valid, (B,)), ("corr.final_scores", corr.final_scores, (B, n, n)),
              ("corr.depth_map0", corr.depth_map0, (B, h // df, w // df, 1)), ("corr.kps1", corr.kps1, (B, n, 2))]
    fields += [(f"estimate.{f}", getattr(est, f), (B, S) + tail) for f, tail in
               (("cor0", (2,)), ("cor1", (2,)), ("d0", (1,)), ("d1", (1,)), ("weights", ()), ("inlier_mask", ()))]
    for name, v, shape in fields:
        if tuple(v.shape) != shape:
            raise SmokeError(f"full output {name}: shape {tuple(v.shape)} != {shape}")
        if v.dtype != torch.bool and not bool(torch.isfinite(v).all()):
            raise SmokeError(f"full output {name}: non-finite values")
    return out


def compare_backbones(model_a, model_b, image0, image1, what: str, min_cos: float = 0.999,
                      max_rel: float | None = None) -> dict:
    """Two models' backbone features on the same images: cosine per image
    above ``min_cos`` and, if given, max |diff| within ``max_rel`` of
    max|a|. Returns the worst cosine, the max |diff| and that ratio."""
    from mickey_tpu_torch.nn.extractor import backbone_features

    ims = torch.cat([image0, image1])
    with torch.inference_mode():
        a = backbone_features(model_a.params, ims, model_a.cfg).flatten(1).double()
        b = backbone_features(model_b.params, ims, model_b.cfg).flatten(1).double()
    cos = torch.nn.functional.cosine_similarity(b, a).min().item()
    max_abs = (a - b).abs().max().item()
    rel = max_abs / a.abs().max().item()
    if not cos > min_cos:
        raise SmokeError(f"{what}: cosine {cos:.9f} <= {min_cos}")
    if max_rel is not None and not rel <= max_rel:
        raise SmokeError(f"{what}: max |diff| {max_abs:.3e} is {rel:.3e} of max|ref| > {max_rel}")
    return {"backbone_cos": cos, "backbone_max_abs": max_abs, "backbone_rel": rel}


def check_dense_table(model, image0, image1, K0, K1) -> dict:
    """Phase 3, table cross-check on the default config: the full output's
    dense final scores (K2a + K4) against the fused route's K2 table on the
    same head outputs. The fused table is the top-P over each row's top-L
    candidates; under that selection (``dense_topk_scores``) the dense
    matrix must give the same table: values at 1e-5 relative, index sets up
    to near-ties, row_ok equal. Also reports the share of the exact global
    top-P (``torch.topk`` over the whole matrix) that the fused table holds,
    by count and by score mass."""
    from mickey_tpu_torch.ops.fused_matcher import dense_topk_scores

    B = image0.shape[0]
    cfg = model.cfg
    full = model(image0, image1, K0, K1, generator=torch.Generator(device=image0.device).manual_seed(SEED))
    feats = model.extract_feats(torch.cat([image0, image1]))
    tc = model.match_feats(tuple(f[:B] for f in feats), tuple(f[B:] for f in feats), fused=True)
    final = full.corr.final_scores
    P, L = int(cfg.TPU.SAMPLING_PREFILTER), int(cfg.TPU.MATCHER_TOPL)
    dv, di, dok = dense_topk_scores(final, P, row_topl=L)
    err = _close(tc.top_scores, dv, "dense vs fused table values")
    _sets_agree(tc.top_scores, tc.top_idx, dv, di, "dense vs fused table")
    if not torch.equal(tc.row_ok.cpu(), dok.cpu()):
        raise SmokeError("dense vs fused table: row_ok differs")
    gv, gi = torch.topk(final.reshape(B, -1).float(), P, dim=-1)
    recall = [len(set(a.tolist()) & set(b.tolist())) / P for a, b in zip(tc.top_idx.long().cpu(), gi.cpu())]
    mass = (tc.top_scores.double().sum(-1) / gv.double().sum(-1)).tolist()
    return {"table_max_abs": err, "global_topP_recall": recall, "global_topP_mass": mass}


def upstream_state_dicts(params):
    """The upstream release's two state dicts, made from a ``mickey_tpu``
    layout params tree by inverting the converters (HWIO -> OIHW, (in, out)
    -> (out, in), head-major qkv -> [q|k|v], stacked -> numbered): the
    Lightning checkpoint's ``state_dict`` (heads and matcher, with the
    ``compute_matches.`` prefix) and the DINOv2 ``.pth``."""
    from mickey_tpu_torch.training.checkpoint import HEAD_OUT_KEY

    def T(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a copy; 0-d stays 0-d

    def conv(a):
        return T(np.asarray(a).transpose(3, 2, 0, 1))

    def lin(a):
        return T(np.asarray(a).T)

    vit = params["dinov2"]
    dino = {"patch_embed.proj.weight": conv(vit["patch_embed"]["w"]), "patch_embed.proj.bias": T(vit["patch_embed"]["b"]),
            "cls_token": T(vit["cls_token"]), "pos_embed": T(vit["pos_embed"]),
            "norm.weight": T(vit["norm"]["scale"]), "norm.bias": T(vit["norm"]["bias"])}
    blocks = vit["blocks"]
    heads = {384: 6, 768: 12, 1024: 16, 1536: 24}[np.asarray(blocks["norm1"]["scale"]).shape[1]]
    for i in range(np.asarray(blocks["norm1"]["scale"]).shape[0]):
        pre = f"blocks.{i}."
        get = lambda *path: np.asarray(functools.reduce(lambda d, k: d[k], path, blocks))[i]  # noqa: E731
        w, b = get("attn", "qkv", "w"), get("attn", "qkv", "b")
        cin, c3 = w.shape
        w = w.reshape(cin, heads, 3, c3 // (3 * heads)).transpose(0, 2, 1, 3).reshape(cin, c3)
        b = b.reshape(heads, 3, c3 // (3 * heads)).transpose(1, 0, 2).reshape(c3)
        dino.update({pre + "attn.qkv.weight": lin(w), pre + "attn.qkv.bias": T(b)})
        for name, path in (("attn.proj", ("attn", "proj")), ("mlp.fc1", ("mlp", "fc1")), ("mlp.fc2", ("mlp", "fc2"))):
            dino.update({f"{pre}{name}.weight": lin(get(*path, "w")), f"{pre}{name}.bias": T(get(*path, "b"))})
        for n in ("norm1", "norm2"):
            dino.update({f"{pre}{n}.weight": T(get(n, "scale")), f"{pre}{n}.bias": T(get(n, "bias"))})
        for n in ("ls1", "ls2"):
            dino[f"{pre}{n}.gamma"] = T(get(n, "gamma"))

    sd = {}
    for head, out_key in HEAD_OUT_KEY.items():
        pre, hp = f"compute_matches.extractor.{head}.", params[head]
        for r in range(1, 5):
            blk, bp = f"{pre}resblock{r}.", hp[f"resblock{r}"]
            for c in ("conv1", "conv2"):
                sd[f"{blk}{c}.weight"] = conv(bp[c]["w"])
            if "shortcut" in bp:
                sd[f"{blk}shortcut.0.weight"] = conv(bp["shortcut"]["w"])
            for bn in ("bn1", "bn2"):
                if bn in bp:
                    for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                                         ("var", "running_var")):
                        sd[f"{blk}{bn}.{theirs}"] = T(bp[bn][ours])
        layers = hp["att"]["layers"]
        for i in range(np.asarray(layers["q_proj"]["w"]).shape[0]):
            lp = f"{pre}att_layer.layers.{i}."
            for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"), ("merge", "merge"),
                                 ("mlp_fc1", "mlp.0"), ("mlp_fc2", "mlp.2")):
                sd[f"{lp}{theirs}.weight"] = lin(np.asarray(layers[ours]["w"])[i])
            for n in ("norm1", "norm2"):
                sd[f"{lp}{n}.weight"] = T(np.asarray(layers[n]["scale"])[i])
                sd[f"{lp}{n}.bias"] = T(np.asarray(layers[n]["bias"])[i])
        if out_key:
            sd[f"{pre}{out_key}.weight"] = conv(hp["out"]["w"])
    if "dustbin_score" in params["matcher"]:
        sd["compute_matches.matcher.matching_mat.dustbin_score"] = T(params["matcher"]["dustbin_score"])
    return sd, dino


def check_checkpoint(cfg, params, device, image0, image1, K0, K1) -> dict:
    """Phase 3, checkpoint: a synthetic upstream ``.ckpt`` and DINOv2
    ``.pth`` written from ``params`` to a temporary directory, loaded with
    ``build_model(cfg, checkpoint=..., dinov2_path=...)``: every parameter
    bitwise equal to ``build_model(cfg, params)``'s, and the same pose under
    the same generator seed."""
    import tempfile

    from mickey_tpu_torch.models import build_model
    from mickey_tpu_torch.weights import tree_leaves

    sd, dino = upstream_state_dicts(params)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, pth = os.path.join(tmp, "mickey.ckpt"), os.path.join(tmp, "dinov2_vitl14_pretrain.pth")
        torch.save({"state_dict": sd}, ckpt)
        torch.save(dino, pth)
        del sd, dino
        # from another random init, so every parameter has to come from the files
        loaded = build_model(cfg, checkpoint=ckpt, dinov2_path=pth, seed=SEED + 1, device=device)
    ref = build_model(cfg, params, device=device)
    a, b = tree_leaves(loaded.params), tree_leaves(ref.params)
    if [p for p, _ in a] != [p for p, _ in b]:
        raise SmokeError("checkpoint: the loaded parameter tree differs in structure")
    differ = [".".join(map(str, p)) for (p, x), (_, y) in zip(a, b)
              if not (torch.equal(x, y) if torch.is_tensor(x) else x == y)]
    if differ:
        raise SmokeError(f"checkpoint: {len(differ)} parameters differ, e.g. {differ[:3]}")
    gen = lambda: torch.Generator(device=image0.device).manual_seed(SEED)  # noqa: E731
    pa = loaded(image0, image1, K0, K1, generator=gen(), lite=True)
    pb = ref(image0, image1, K0, K1, generator=gen(), lite=True)
    if not all(torch.equal(x, y) for x, y in zip(pa[:4], pb[:4])):
        raise SmokeError("checkpoint: the loaded model's pose differs")
    return {"leaves": len(a), "bitwise": True, "pose_equal": True}


def check_exact_against_plain(model, cpu_model, image0, image1, K0, K1) -> dict:
    """Phase 3, exact path, small input: the card's stages against the plain
    CPU path of the same weights, all fp32. The backbone (24 layers of fp32
    products in two summation orders) to 1e-3 of its largest feature, far
    inside the bf16 path's bound (cosine 0.999, errors of a few percent);
    the heads at 1e-4 relative on the
    card's feature map; the dense final scores (K4 against the plain
    dual-softmax) at 1e-4 relative plus 1e-6 of the largest; the top-P
    prefilter on identical final scores to the same values; the pose
    (identical final scores, the same injected draws carried over by match)
    R and t to 1e-4 absolute, the confidence to 1e-4 relative, validity
    equal, at most 1% of the inlier mask flipped."""
    from mickey_tpu_torch.nn.extractor import backbone_features, correspondences_from_heads, heads_apply
    from mickey_tpu_torch.solver import draw_samples, estimate_pose_from_cfg

    cfg = model.cfg
    cpu = torch.device("cpu")
    ims = torch.cat([image0, image1])
    b = image0.shape[0]
    with torch.inference_mode():
        fmap = backbone_features(model.params, ims, cfg)
        fmap_ref = backbone_features(cpu_model.params, ims.to(cpu), cfg)
        backbone_rel = _rel(fmap, fmap_ref)
        if not backbone_rel <= 1e-3:
            raise SmokeError(f"exact backbone: {backbone_rel:.3e} of max|ref| from the plain CPU path")
        feats = heads_apply(model.params, fmap, cfg)[0]
        feats_ref = heads_apply(cpu_model.params, fmap.to(cpu), cfg)[0]
        heads_err = max(_rel(x, y) for x, y in zip(feats, feats_ref))
        if not heads_err < 1e-4:
            raise SmokeError(f"exact heads: relative error {heads_err:.3e} >= 1e-4")
        corr = correspondences_from_heads(model.params, feats, cfg)
        corr_ref = correspondences_from_heads(cpu_model.params, tuple(f.to(cpu) for f in feats), cfg)
        scores_err = _close(corr.final_scores, corr_ref.final_scores, "exact final scores", DS_RTOL)
        pc = cfg.PROCRUSTES
        dev = image0.device
        corr_dev = type(corr_ref)(*(x.to(dev) for x in corr_ref))
        P = int(cfg.TPU.SAMPLING_PREFILTER)
        table, idx = torch.topk(corr_ref.final_scores.reshape(b, -1), P, dim=-1)
        table_dev, idx_dev = torch.topk(corr_dev.final_scores.reshape(b, -1), P, dim=-1)
        if not torch.equal(table_dev.cpu(), table):
            raise SmokeError("exact prefilter: the card's top-P values differ from the CPU's on the same scores")
        draws = draw_samples(torch.Generator().manual_seed(SEED), table, pc.IT_MATCHES, pc.IT_RANSAC,
                             pc.NUM_SAMPLED_MATCHES, pc.NUM_CORR_3D_3D)
        ref = estimate_pose_from_cfg(corr_ref, K0.to(cpu), K1.to(cpu), cfg, draws=draws)
        # the same draws by match: exact ties may sit in another order in the card's table
        moved = _carry_draws(draws, idx, idx_dev.cpu())
        out = estimate_pose_from_cfg(corr_dev, K0, K1, cfg, draws=type(draws)(*(d.to(dev) for d in moved)))
        errs = {"R_abs": (out.R.cpu() - ref.R).abs().max().item(), "t_abs": (out.t.cpu() - ref.t).abs().max().item(),
                "conf_rel": _rel(out.confidence, ref.confidence)}
        # a distance within rounding of the hard 0.15 m threshold may flip
        flips = int((out.inlier_mask.cpu() != ref.inlier_mask).sum())
        if not (max(errs.values()) < 1e-4 and torch.equal(out.valid.cpu(), ref.valid)
                and flips <= 0.01 * ref.inlier_mask.numel()):
            raise SmokeError(f"exact solver: {errs}, {flips} inlier flips vs the plain CPU path "
                             f"(|t| {ref.t.abs().max().item():.3e}, table order moved at "
                             f"{int((idx_dev.cpu() != idx).sum())} positions)")
    return {"backbone_rel": backbone_rel, "heads_rel": heads_err, "final_scores_max_abs": scores_err,
            **errs, "inlier_flips": flips}


def _carry_draws(draws, idx_from, idx_to):
    """Draws (outer positions in a table of flat match indices ``idx_from``)
    moved to the positions of the same matches in ``idx_to`` (B, P)."""
    outer = draws.outer_local.clone()
    for bb in range(outer.shape[1]):
        where = {int(m): p for p, m in enumerate(idx_to[bb].tolist())}
        frm = idx_from[bb]
        outer[:, bb] = torch.tensor([[where[int(frm[p])] for p in row] for row in outer[:, bb].tolist()],
                                    dtype=outer.dtype)
    return type(draws)(outer, draws.ridx)


def check_against_plain(model, cpu_model, image0, image1, K0, K1) -> dict:
    """Phase 3, small input: the card's path stage by stage against the plain
    CPU path of the same weights. Backbone: bf16 either side, so a cosine
    bound; from the card's feature map on, fp32: heads at 1e-4, the top-P
    table and the solver (identical table and injected draws) at 1e-4."""
    from mickey_tpu_torch.nn.extractor import backbone_features, heads_apply
    from mickey_tpu_torch.solver import draw_samples

    cfg = model.cfg
    cpu = torch.device("cpu")
    ims = torch.cat([image0, image1])
    with torch.inference_mode():
        fmap = backbone_features(model.params, ims, cfg)
        fmap_ref = backbone_features(cpu_model.params, ims.to(cpu), cfg)
        cos = torch.nn.functional.cosine_similarity(fmap.float().cpu().flatten(1), fmap_ref.flatten(1)).min().item()
        if not cos > 0.999:
            raise SmokeError(f"backbone: cosine to the plain CPU path {cos:.6f} <= 0.999")
        feats = heads_apply(model.params, fmap, cfg)[0]
        feats_ref = heads_apply(cpu_model.params, fmap.to(cpu), cfg)[0]
        heads_err = max(_rel(a, b) for a, b in zip(feats, feats_ref))
        if not heads_err < 1e-4:
            raise SmokeError(f"heads: relative error {heads_err:.3e} >= 1e-4")
        b = image0.shape[0]
        split = lambda fs: (tuple(f[:b] for f in fs), tuple(f[b:] for f in fs))  # noqa: E731
        tc = model.match_feats(*split(feats))
        tc_ref = cpu_model.match_feats(*split(feats_ref))
        if _rel(tc.top_scores, tc_ref.top_scores) > 1e-4:
            raise SmokeError("matcher: top-P values differ from the plain CPU path")
        _sets_agree(tc.top_scores, tc.top_idx, tc_ref.top_scores, tc_ref.top_idx, "matcher table")
        pc = cfg.PROCRUSTES
        draws = draw_samples(torch.Generator().manual_seed(SEED), tc_ref.top_scores, pc.IT_MATCHES,
                             pc.IT_RANSAC, pc.NUM_SAMPLED_MATCHES, pc.NUM_CORR_3D_3D)
        dev = image0.device
        tc_dev = type(tc_ref)(*(x.to(dev) for x in tc_ref))
        out = model.solve(tc_dev, K0, K1, draws=type(draws)(*(d.to(dev) for d in draws)))
        ref = cpu_model.solve(tc_ref, K0.to(cpu), K1.to(cpu), draws=draws)
        pose_err = max(_rel(out.R, ref.R), _rel(out.t, ref.t), _rel(out.inliers, ref.inliers))
        if not (pose_err < 1e-4 and torch.equal(out.valid.cpu(), ref.valid)):
            raise SmokeError(f"solver: relative error {pose_err:.3e} vs the plain CPU path")
    return {"backbone_cos": cos, "heads_rel": heads_err, "pose_rel": pose_err}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def train_batch(device, pairs: int, height: int, width: int, seed: int = SEED) -> dict:
    """Synthetic training pairs: seeded images, intrinsics as in
    ``slice_inputs`` and a ground-truth T_0to1 of small rotation and ~0.3 m
    translation."""
    image0, image1, K0, K1 = slice_inputs(device, pairs, height, width, seed)
    rng = np.random.default_rng(seed + 3)
    T = np.tile(np.eye(4, dtype=np.float32), (pairs, 1, 1))
    for b in range(pairs):
        T[b, :3, :3] = _rot(rng.uniform(-0.15, 0.15, 3))
        T[b, :3, 3] = rng.normal(0, 0.3, 3)
    return {"image0": image0, "image1": image1, "T_0to1": torch.from_numpy(T).to(device),
            "K_color0": K0, "K_color1": K1, "Kori_color0": K0.clone(), "Kori_color1": K1.clone()}


def inject_draws(rng, b, rows, cols, it, S, R_it, C, border=3):
    """Loss draws to inject into two runs: outer draws (B, it, S) among
    keypoint pairs inside the score head's border (nonzero final scores) of a
    rows x cols patch grid, and inner minimal sets (B, it, R_it, C) whose
    samples have distinct keypoints on both sides (a set that repeats one can
    have a rank-deficient covariance, whose rotation is arbitrary)."""
    cells = (np.arange(border, rows - border)[:, None] * cols + np.arange(border, cols - border)[None, :]).reshape(-1)
    n = rows * cols
    pairs = (cells[:, None] * n + cells[None, :]).reshape(-1)
    idx = np.stack([[rng.choice(pairs, S, replace=False) for _ in range(it)] for _ in range(b)]).astype(np.int64)

    def minimal_set(draw):
        while True:
            chosen, seen0, seen1 = [], set(), set()
            for s in rng.permutation(S):
                i, j = divmod(int(draw[s]), n)
                if i not in seen0 and j not in seen1:
                    chosen.append(s)
                    seen0.add(i)
                    seen1.add(j)
                if len(chosen) == C:
                    return chosen

    ridx = np.array([[[minimal_set(idx[bb, i]) for _ in range(R_it)] for i in range(it)] for bb in range(b)], np.int64)
    return torch.from_numpy(idx), torch.from_numpy(ridx)


def _snapshot(tensors):
    return [t.detach().clone() for t in tensors]


def run_train(trainer, batch, steps: int) -> list:
    """Phase 3, training: ``steps`` staged steps on one batch. Each must give
    a finite loss and grad norm with finite gradients and advance every BN
    running stat; after each, every trainable leaf must differ from its
    value before the first step (a single step of a leaf can round away: an
    Adam step below half an fp32 ulp of the dustbin logit's 1.0, when its
    gradient's sign flips); the frozen backbone must be as it was."""
    from mickey_tpu_torch.weights import is_bn_stat, tree_leaves

    leaves = tree_leaves(trainer.state.params)
    initial = _snapshot(t for _, t in leaves)
    backbone = _snapshot(t for _, t in tree_leaves(trainer.backbone))
    out = []
    for step in range(steps):
        before = _snapshot(t for _, t in leaves)
        m = trainer.training_step(batch)
        if not (all(np.isfinite(v) for v in m.values()) and m["grads_finite"] == 1.0):
            raise SmokeError(f"train step {step}: non-finite metrics {m}")
        same = [".".join(map(str, p)) for (p, t), b0, b in zip(leaves, initial, before)
                if torch.equal(t.detach(), b if is_bn_stat(p) else b0)]
        if same:
            raise SmokeError(f"train step {step}: leaves did not change: {same[:5]} ({len(same)} in all)")
        out.append(m)
    if not all(torch.equal(a, b) for a, b in zip(backbone, (t for _, t in tree_leaves(trainer.backbone)))):
        raise SmokeError("train: the frozen backbone changed")
    return out


def small_loss_cfg(cfg):
    """``cfg`` with the loss budget cut to 4 x 4 hypotheses over 64 samples and
    one refinement, for the card-against-CPU check. The refinement counts
    inliers against a hard 0.15 m threshold; at the full budget (B x 20 x 20
    x 512 distances, 4 refinements) a few distances fall within the two
    paths' rounding of it, and each flip moves the loss by ~1e-3 (measured
    1.6e-3 at B = 2 on the card). At the cut budget a flip is improbable."""
    cfg = cfg.clone()
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    gh.IT_MATCHES, gh.IT_RANSAC, gh.NUM_REF_STEPS = 4, 4, 1
    cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES = 64
    return cfg


def _norm_rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| over ||ref|| (Frobenius), for one leaf."""
    a, ref = a.double().cpu(), ref.double().cpu()
    return (torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref).clamp(min=1e-300)).item()


def check_train_against_plain(cfg, params, device, *, pairs: int, height: int, width: int) -> dict:
    """Phase 3, training, small input: one staged step on the card against the
    plain CPU path, stage by stage, from the same params, the card's feature
    map and the same injected draws.

    1. Heads in train mode: outputs at 1e-4 and the forward's BN running
       stats at 1e-5, each relative to the leaf's largest entry.
    2. Matcher and loss on the card's head outputs, on the route ``cfg``
       selects (dense: K4 forward, K5 backward; fused top-K: K2 forward, K6
       backward): the loss at 1e-4 relative; its gradients with respect to
       the four head maps and the dustbin at 1e-3 of each one's largest
       entry.
    3. The heads' backward for the plain path's head-output gradients, on
       the card and on the CPU in fp32, each against the same backward in
       fp64 on the CPU: every parameter leaf's gradient on the card within
       GRAD_TOL normwise (||g - g_fp64|| / ||g_fp64||) of the fp64 one. No
       bound of the size of the steps above holds here: the gradient is
       ill-conditioned with respect to the heads' activations (ReLU gating and
       train-mode BatchNorm's cancelling backward, at random weights). In fp32
       on the CPU alone, against fp64, single leaves are off by up to 3.3e-3
       normwise and 5.0e-2 in their largest entry relative to the leaf's
       largest (a random feature map, this check's shapes); a wrong backward
       is off by O(1). The CPU's own distance is reported beside the card's."""
    from mickey_tpu_torch.nn.extractor import (
        correspondences_from_heads,
        heads_apply,
        topk_train_correspondences_from_heads,
    )
    from mickey_tpu_torch.training.loss import LossConfig, metric_pose_loss, metric_pose_loss_topk
    from mickey_tpu_torch.training.train_step import (
        StagedTrainStep,
        batch_pose,
        init_train_state,
        use_train_fused_topk,
    )
    from mickey_tpu_torch.weights import is_bn_stat, params_to_torch, tree_leaves

    cpu = torch.device("cpu")
    batch = train_batch(device, pairs, height, width, seed=SEED + 5)
    batch_c = {k: v.to(cpu) for k, v in batch.items()}
    state, backbone = init_train_state(cfg, params_to_torch(params, cfg, device))
    state_c, _ = init_train_state(cfg, params_to_torch(params, cfg, cpu))
    fmap = StagedTrainStep(cfg).backbone_fwd(backbone, batch["image0"], batch["image1"])
    lc = LossConfig.from_cfg(cfg)
    df = cfg.MICKEY.DINOV2.DOWN_FACTOR
    draws = inject_draws(np.random.default_rng(SEED + 6), pairs, height // df, width // df, lc.it_matches,
                         lc.num_samples_matches, lc.it_ransac, lc.num_corr)
    topk = float(cfg.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT)

    # 1. heads forward
    with torch.no_grad():
        feats, fwd = heads_apply(state.params, fmap, cfg, train=True)
        feats_c, fwd_c = heads_apply(state_c.params, fmap.to(cpu), cfg, train=True)
    heads_rel = max(_rel(a, b) for a, b in zip(feats, feats_c))
    bn_rel = max(_rel(a, b) for (p, a), (_, b) in zip(tree_leaves(fwd), tree_leaves(fwd_c)) if is_bn_stat(p))
    if not (heads_rel <= 1e-4 and bn_rel <= 1e-5):
        raise SmokeError(f"train small input: heads rel {heads_rel:.3e}, BN stats rel {bn_rel:.3e}")

    # 2. matcher + loss on the same head outputs
    def tail(st, fs, b, dev):
        fs = [f.detach().to(dev).requires_grad_(True) for f in fs]
        Rgt, tgt = batch_pose(b)
        Ks = (b["K_color0"], b["K_color1"], b["Kori_color0"], b["Kori_color1"])
        override = tuple(d.to(dev) for d in draws)
        if use_train_fused_topk(cfg, lc):
            c = topk_train_correspondences_from_heads(st.params, fs, cfg)
            total, _ = metric_pose_loss_topk(
                (c.top_scores, c.top_idx, c.row_ok, c.lse_row, c.lse_col), c.dsc0, c.dsc1, c.scr0, c.scr1,
                c.kps0, c.depth0, c.kps1, c.depth1, *Ks, Rgt, tgt, lc, topk,
                temperature=float(cfg.FEATURE_MATCHER.DUAL_SOFTMAX.TEMPERATURE), sample_override=override)
        else:
            c = correspondences_from_heads(st.params, fs, cfg, train=True)
            total, _ = metric_pose_loss(c.final_scores, c.kps0, c.depth0, c.kps1, c.depth1, *Ks, Rgt, tgt,
                                        lc, topk, sample_override=override)
        return total.item(), torch.autograd.grad(total, fs + [st.params["matcher"]["dustbin_score"]])

    loss, g_tail = tail(state, feats, batch, device)
    loss_c, g_tail_c = tail(state_c, feats, batch_c, cpu)
    loss_rel = abs(loss - loss_c) / abs(loss_c)
    tail_rel = max(_rel(a, b) for a, b in zip(g_tail, g_tail_c))
    if not (loss_rel <= 1e-4 and tail_rel <= 1e-3):
        raise SmokeError(f"train small input: loss {loss} vs plain {loss_c} (rel {loss_rel:.3e}), "
                         f"head-output gradients rel {tail_rel:.3e}")

    def head_leaves(params):
        return [(p, t) for p, t in tree_leaves(params) if p[0] != "matcher" and not is_bn_stat(p)]

    def heads_vjp(params, fm, cot):
        leaves = [t for _, t in head_leaves(params)]
        return torch.autograd.grad(heads_apply(params, fm, cfg, train=True)[0], leaves, cot, allow_unused=True)

    # 3. heads backward: the card and the CPU, each against fp64 on the CPU
    cot = g_tail_c[:4]
    g = heads_vjp(state.params, fmap, [c.to(device) for c in cot])
    g_c = heads_vjp(state_c.params, fmap.to(cpu), cot)
    g_64 = heads_vjp(_double_tree(state_c.params), fmap.to(cpu).double(), [c.double() for c in cot])
    worst = {"card": (0.0, ""), "cpu": (0.0, "")}
    for (path, _), a, c, r in zip(head_leaves(state.params), g, g_c, g_64):
        if r is None:
            continue
        name = ".".join(map(str, path))
        for side, x in (("card", a), ("cpu", c)):
            worst[side] = max(worst[side], (_norm_rel(x, r), name))
        if worst["card"][0] > GRAD_TOL:
            raise SmokeError(f"train small input: {name} gradient {worst['card'][0]:.3e} from fp64 (normwise)")
    flat = lambda gs: torch.cat([x.double().cpu().reshape(-1) for x in gs if x is not None])  # noqa: E731
    return {"heads_rel": heads_rel, "bn_rel": bn_rel, "loss_rel": loss_rel, "head_output_grad_rel": tail_rel,
            "param_grad_rel": _norm_rel(flat(g), flat(g_c)), "card_worst_leaf_vs_fp64": worst["card"][0],
            "card_worst_leaf": worst["card"][1], "cpu_worst_leaf_vs_fp64": worst["cpu"][0],
            "cpu_worst_leaf": worst["cpu"][1]}


def _double_tree(tree):
    """A detached fp64 copy of a nested dict / list of tensors; leaves keep
    whether they require grad."""
    if isinstance(tree, dict):
        return {k: _double_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_double_tree(v) for v in tree]
    return tree if tree is None else tree.detach().double().requires_grad_(tree.requires_grad)


def _elapsed_ms(fn) -> float:
    """CUDA-event time of one call of ``fn()`` in milliseconds."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    return statistics.median(_elapsed_ms(fn) for _ in range(iters))


# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def _bound(flops: float, nbytes: float, peak: float):
    """(least ms the card could take, what binds): operations over the peak
    rate of their type against the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _attention_bound(qkv: torch.Tensor, heads: int, peak: float, passes: float = 1.0, keys: int | None = None):
    """The bound of attention on a packed (images, seq, 3C) qkv: the two
    products' 4 S^2 D flops per head (S keys, or ``keys``) at ``peak``, times
    ``passes`` (3xTF32: three TF32 products for one fp32-accurate one),
    against qkv read and the (images, seq, C) output written once."""
    imgs, seq, three_c = qkv.shape
    d = three_c // 3 // heads
    keys = seq if keys is None else keys
    return _bound(passes * 4.0 * imgs * heads * seq * keys * d,
                  (imgs * seq * three_c + imgs * seq * heads * d) * qkv.element_size(), peak)


def k1_old_bound(inp):
    """K1-old's bound: every query row of its padded sequence against the
    keys before ``old_len``. Its operands are bf16: Q K^T is exact in fp32 at
    one bf16 pass; P V at fp32 accuracy on a bf16 V is cheapest with P split
    into three bf16 parts (three bf16 passes take less than two TF32 ones).
    Each product is half the flops: (1 + 3) / 2 bf16 passes of both."""
    pv_passes = min(3.0, 2.0 * PEAK_BF16 / PEAK_TF32)
    return _attention_bound(inp["qkv_old"], inp["heads"], PEAK_BF16, passes=(1.0 + pv_passes) / 2,
                            keys=inp["old_len"])


def kernel_bounds(inp, tin) -> dict:
    """name -> (bound_ms, bound_by) at this run's kernel inputs. Operations
    counted: the matrix products (2 flops per multiply-add; K1's two products
    on bf16 tensor cores; K1f's at fp32 accuracy as 3xTF32, three TF32
    passes each; K1-old's on bf16 tensor cores, ``k1_old_bound``; the others
    fp32 FMA) and, for K3, the ~30 fp32 operations of one soft-inlier term;
    exponentials are left out."""
    f32 = 4
    imgs, seq, three_c = inp["qkv"].shape
    heads = inp["heads"]
    d = three_c // 3 // heads
    B, M, C = inp["dsc0"].shape
    N = inp["dsc1"].shape[1]
    L = inp["topl"]
    Bt, Mt, Ct = tin["dsc0"].shape
    Nt = tin["dsc1"].shape[1]
    hb, hs = inp["X"].shape[:2]
    hr = inp["R"].shape[1]
    corr_t = 2.0 * Bt * Mt * Nt * Ct
    descs_t = (Bt * Mt * Ct + Bt * Nt * Ct) * f32
    attn = _attention_bound(inp["qkv"], heads, PEAK_BF16)
    attn32 = _attention_bound(inp["qkv32"], heads, PEAK_TF32, passes=3)
    return {
        "flash_attention_packed": attn,
        "flash_attention": attn,  # the same q, k, v read and output written, on another layout
        "flash_attention_packed_f32": attn32,
        "flash_attention_f32": attn32,
        "flash_attention_packed_upcast": k1_old_bound(inp),
        "col_lse": _bound(2.0 * B * M * N * C, (B * M * C + B * N * C + B * N) * f32, PEAK_FP32),
        "pair_topk": _bound(2.0 * B * M * N * C,
                            (B * M * C + B * N * C + B * M + 2 * B * N + 2 * B * L * M + 4 * B * M) * f32, PEAK_FP32),
        "hypothesis_scores": _bound(30.0 * hb * hr * hs, (2 * hb * hs * 3 + hb * hr * 12 + hb * hr) * f32, PEAK_FP32),
        "pair_softmax": _bound(corr_t, descs_t + (Bt * Nt + Bt * Mt * Nt + Bt * Mt) * f32, PEAK_FP32),
        "dual_softmax_bwd_sums": _bound(corr_t, descs_t + (Bt * Mt * Nt + 2 * Bt * Mt + 2 * Bt * Nt) * f32, PEAK_FP32),
        "dual_softmax_bwd_grads": _bound(3 * corr_t, 2 * descs_t + (Bt * Mt * Nt + 2 * Bt * Mt + 2 * Bt * Nt) * f32,
                                         PEAK_FP32),
        # s, dS dsc1 and dS^T dsc0: three products (the kernel recomputes s
        # in each of its two launches, four)
        "lse_bwd": _bound(3 * corr_t, 2 * descs_t + (2 * Bt * Mt + 2 * Bt * Nt) * f32, PEAK_FP32),
    }


def library_calls(inp) -> dict:
    """name -> one PyTorch call computing the kernel's function, where one
    exists: K1 and K1b are scaled_dot_product_attention on the unpacked heads,
    K1f the same on the fp32 heads (TF32 off). K1-old has none: no single
    call upcasts bf16 operands and returns bf16."""
    from mickey_tpu_torch.ops.flash_attention import qkv_heads

    q, k, v = (x.contiguous() for x in qkv_heads(inp["qkv"], inp["heads"]))
    q32, k32, v32 = (x.contiguous() for x in qkv_heads(inp["qkv32"], inp["heads"]))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
    sdpa32 = lambda: torch.nn.functional.scaled_dot_product_attention(q32, k32, v32)  # noqa: E731
    return {"flash_attention_packed": sdpa, "flash_attention": sdpa, "flash_attention_packed_f32": sdpa32,
            "flash_attention_f32": sdpa32}


def _launched(launches: dict, path: str, needed, absent=()) -> dict:
    """Fail unless every kernel in ``needed`` was launched and none in ``absent``."""
    missing = [k for k in needed if launches[k] == 0]
    extra = [k for k in absent if launches[k] != 0]
    if missing or extra:
        raise SmokeError(f"{path}: kernels never launched {missing}, launched but off this path {extra}")
    return launches


def _counted(fn):
    """Run ``fn`` with every launch count at 0; returns (its result, the counts)."""
    from mickey_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    out = fn()
    return out, dict(_cuda.LAUNCHES)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    from mickey_tpu_torch import default_config
    from mickey_tpu_torch.models import MicKeyTrainer, MickeyRelativePose, build_model
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.weights import init_params_numpy

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)

    # 1. build
    lib, log = _cuda.build()
    ptx = [ln.strip() for ln in log.splitlines() if any(w in ln for w in ("registers", "Compiling entry", "spill", "arning"))]
    print("build: ok | " + " | ".join(ptx), flush=True)

    # 2. kernels vs plain, at the main paths' shapes: serving (ViT-L 714x532,
    #    B = 2) and training (B = 8 pairs, 1938 keypoints, C = 128)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config()
    inp = kernel_inputs(dev, images=4, seq=1939, heads=16, kpts=1938, desc=128, topl=16,
                        prefilter=4096, samples=2048, hyps=100, old_images=16, old_seq=2048, old_len=1939)
    if "--attention" in sys.argv[1:]:
        return attention_report(inp, card)
    if "--attention-f32" in sys.argv[1:]:
        return attention_f32_report(inp, card)
    errs = check_kernels(inp)
    ragged = check_attention_shapes(dev)
    ragged32 = check_attention_shapes(dev, torch.float32)
    tin = train_kernel_inputs(dev, pairs=8, kpts=1938, desc=128)
    errs.update(check_train_kernels(tin))
    errs.update(check_topk_train_kernels(tin, prefilter=int(cfg.TPU.SAMPLING_PREFILTER),
                                         topl=int(cfg.TPU.MATCHER_TOPL)))
    print("kernels: ok | " + " ".join(f"{k} max|diff|={v:.3e}" for k, v in errs.items())
          + f" | bf16 attention at S in {ATTN_SEQS} and seq_len < S: max|diff|={ragged:.3e}"
          + f" | fp32 attention there: max|diff| / max|ref| = {ragged32:.3e}", flush=True)

    # 3a. serving slice at full width in both layouts, the general layout on
    #     unpacked attention, then a small input against the plain CPU path
    params = init_params_numpy(cfg, SEED)
    model = build_model(cfg, params, device=dev)
    image0, image1, K0, K1 = slice_inputs(dev, pairs=2, height=714, width=532)
    outs, serve_launches = _counted(lambda: run_slice(model, image0, image1, K0, K1))
    _launched(serve_launches, "serving", SERVING_KERNELS, ("flash_attention",))
    cfg_u = cfg.clone()
    cfg_u.TPU.PACKED_ATTENTION = False
    model_u = MickeyRelativePose(cfg_u, model.params, device=dev)  # the same weights
    outs_u, unpacked_launches = _counted(lambda: run_slice(model_u, image0, image1, K0, K1, ("general",)))
    _launched(unpacked_launches, "serving, unpacked attention", UNPACKED_SERVING_KERNELS, ("flash_attention_packed",))
    # K1b against K1 on the same images: one body, bf16 either way
    unpacked = compare_backbones(model, model_u, image0, image1, "unpacked backbone")
    cpu_model = build_model(cfg, params, device="cpu")
    small_ims = slice_inputs(dev, pairs=2, height=224, width=252)
    small = check_against_plain(model, cpu_model, *small_ims)
    g = outs["general"]
    print(f"slice: ok | launches {serve_launches} | conf {g.inliers.tolist()} valid {g.valid.tolist()} | "
          f"unpacked attention: launches {unpacked_launches} conf {outs_u['general'].inliers.tolist()} {unpacked} | "
          f"small-input vs plain {small}", flush=True)

    # 3b. the exact path at full width: fp32 backbone (K1f), the full output
    #     on the dense route, and the dense route's lite outputs; then the
    #     backbone agreements, the dense/fused table cross-check, the
    #     checkpoint loader and a small input against the plain CPU path
    cfg_x = cfg.clone()
    cfg_x.MICKEY.DINOV2.FLOAT16 = False
    cfg_xd = cfg_x.clone()
    cfg_xd.TPU.FUSED_TOPK = False
    model_x = MickeyRelativePose(cfg_x, model.params, device=dev)  # the same weights
    model_xd = MickeyRelativePose(cfg_xd, model.params, device=dev)
    (full_x, outs_xd), exact_launches = _counted(
        lambda: (run_full(model_x, image0, image1, K0, K1), run_slice(model_xd, image0, image1, K0, K1)))
    _launched(exact_launches, "exact path", EXACT_KERNELS, EXACT_ABSENT)
    cfg_xu = cfg_x.clone()
    cfg_xu.TPU.PACKED_ATTENTION = False
    model_xu = MickeyRelativePose(cfg_xu, model.params, device=dev)
    agree_xu, exact_unpacked_launches = _counted(lambda: compare_backbones(
        model_x, model_xu, image0, image1, "fp32 backbone, unpacked against packed", max_rel=1e-5))
    _launched(exact_unpacked_launches, "exact backbone, unpacked attention", ("flash_attention_f32",),
              ("flash_attention_packed", "flash_attention"))
    agree_bf16 = compare_backbones(model_x, model, image0, image1, "bf16 backbone against fp32")
    table = check_dense_table(model, image0, image1, K0, K1)
    ckpt = check_checkpoint(cfg, params, dev, image0, image1, K0, K1)
    small_x = check_exact_against_plain(model_x, MickeyRelativePose(cfg_x, cpu_model.params, device="cpu"), *small_ims)
    del cpu_model
    print(f"exact: ok | launches {exact_launches} | full output conf {full_x.inliers.tolist()} "
          f"valid {full_x.valid.tolist()} inliers {full_x.estimate.inlier_mask.sum(-1).tolist()} | dense lite conf "
          f"{outs_xd['general'].inliers.tolist()} shared {outs_xd['shared'].inliers.tolist()} | fp32 unpacked vs packed "
          f"{agree_xu} launches {exact_unpacked_launches} | bf16 vs fp32 {agree_bf16} | dense vs fused table {table} | "
          f"checkpoint {ckpt} | small-input vs plain {small_x}", flush=True)

    # 3c. training at full width: B = 8 pairs of 714x532, 3 staged steps on
    #     each matcher route, then a small step of each against the CPU path
    cfg_f = cfg.clone()
    cfg_f.TPU.TRAIN_FUSED_TOPK = True
    batch = train_batch(dev, pairs=cfg.TRAINING.BATCH_SIZE, height=714, width=532)
    trainers, train_launches = {}, {}
    for route, c, needed, absent in (("dense", cfg, TRAIN_KERNELS, ("flash_attention", "pair_topk", "lse_bwd")),
                                     ("fused", cfg_f, FUSED_TRAIN_KERNELS, ("flash_attention",) + DENSE_MATCHER_KERNELS)):
        trainers[route] = MicKeyTrainer(c, params=params, seed=SEED, device=dev)
        steps, train_launches[route] = _counted(lambda: run_train(trainers[route], batch, steps=3))
        _launched(train_launches[route], f"train, {route} route", needed, absent)
        small_train = check_train_against_plain(small_loss_cfg(c), params, dev, pairs=2, height=224, width=252)
        print(f"train ({route}): ok | launches {train_launches[route]} | steps {steps} | "
              f"small-input vs plain {small_train}", flush=True)
    del params

    # 4. timing
    B = image0.shape[0]
    key_feats = model.extract_feats(image0[:1])
    ref_feats = tuple(f.expand(B, *f.shape[1:]) for f in key_feats)
    gen = torch.Generator(device=dev)
    t_general = time_ms(lambda: model(image0, image1, K0, K1, generator=gen.manual_seed(SEED), lite=True))
    t_shared = time_ms(lambda: model.call_with_ref_feats(ref_feats, image1, K0, K1, generator=gen.manual_seed(SEED)))
    t_unpacked = time_ms(lambda: model_u(image0, image1, K0, K1, generator=gen.manual_seed(SEED), lite=True))
    t_exact = time_ms(lambda: model_x(image0, image1, K0, K1, generator=gen.manual_seed(SEED)))
    t_full = time_ms(lambda: model(image0, image1, K0, K1, generator=gen.manual_seed(SEED)))
    stages = _stage_times(model, image0, image1, K0, K1)
    exact_stages = _stage_times(model_x, image0, image1, K0, K1, fused=False)
    train_stages = {route: _train_stage_times(tr, batch) for route, tr in trainers.items()}
    calls = {**kernel_calls(inp), **train_kernel_calls(tin)}
    # kernels, plain versions and library calls alike: per call of 10 enqueued back to back
    kt = {name: (time_many_ms(k, reps=10), time_many_ms(p, reps=10)) for name, (k, p) in calls.items()}
    lib_ms = {name: time_many_ms(f, reps=10) for name, f in library_calls(inp).items()}
    bounds = kernel_bounds(inp, tin)
    # the tools' K1-old A/B at its shape: K1's body in bf16 (through K1b, the
    # entry with seq_len) against K1-old's counterpart, in turns
    ab, ablation_launches = _counted(lambda: ablation_times(inp))
    _launched(ablation_launches, "K1-old ablation", ABLATION_KERNELS)
    print(f"timing: ok | {card} | general {B / t_general * 1e3:.3f} pairs/s ({t_general:.3f} ms/batch of {B}) | "
          f"shared keyframe {B / t_shared * 1e3:.3f} pairs/s ({t_shared:.3f} ms) | "
          f"general, unpacked attention {B / t_unpacked * 1e3:.3f} pairs/s ({t_unpacked:.3f} ms) | "
          f"exact path (FLOAT16=False, full output) {B / t_exact * 1e3:.3f} pairs/s ({t_exact:.3f} ms) | "
          f"default config, full output {B / t_full * 1e3:.3f} pairs/s ({t_full:.3f} ms) | "
          f"stages ms {stages} | exact stages ms {exact_stages} | K1-old A/B ms {ab} | "
          f"train ms (B = {cfg.TRAINING.BATCH_SIZE}) {train_stages} | "
          + " ".join(f"{n} {k:.4f}/{p:.4f} ms kernel/plain" for n, (k, p) in kt.items())
          + " | " + " ".join(f"{n} library {t:.4f} ms" for n, t in lib_ms.items()), flush=True)

    runs = (serve_launches, unpacked_launches, exact_launches, exact_unpacked_launches, *train_launches.values(),
            ablation_launches)
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(r[n] for r in runs), "max_abs_err": errs[n], "ms": kt[n][0],
         "plain_ms": kt[n][1], "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": lib_ms.get(n)}
        for n, src, rep in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def time_many_ms(fn, reps: int = 20, iters: int = 5) -> float:
    """Median CUDA-event time per call of ``reps`` calls of ``fn()`` enqueued
    back to back: the device's time, with the host's launch work hidden
    behind the queue as it is inside the backbone."""
    def run():
        for _ in range(reps):
            fn()
    run()
    return statistics.median(_elapsed_ms(run) for _ in range(iters)) / reps


def clocks_under(fn, launches: int = 3000) -> str:
    """The card's SM clock and power draw (``nvidia-smi``) read while
    ``launches`` calls of ``fn()`` are queued and running."""
    for _ in range(launches):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return out


# timing builds of the attention kernels (-D defines; results wrong): csrc/flash_attention_packed.cu (bf16)
ATTN_ABLATIONS = {"no_exp": ("MK_ABLATE_EXP",), "no_loads": ("MK_ABLATE_LOADS",),
                  "no_exp_no_loads": ("MK_ABLATE_EXP", "MK_ABLATE_LOADS"), "products_only": ("MK_ABLATE_SOFTMAX",),
                  "products_only_no_loads": ("MK_ABLATE_SOFTMAX", "MK_ABLATE_LOADS")}
# csrc/flash_attention_f32.cu (fp32, K1f)
ATTN_F32_ABLATIONS = {"no_exp": ("MK_ABLATE_EXP",), "no_loads": ("MK_ABLATE_LOADS",),
                      "products_only": ("MK_ABLATE_SOFTMAX",), "one_tf32_pass": ("MK_ABLATE_1XTF32",),
                      "no_prep": ("MK_ABLATE_PREP",)}


def _attention_loop(card, checks: dict, fns: dict, timer, clock_launches: int, source: str, ablations: dict, launch,
                    extra: dict) -> int:
    """The body of both attention loops. ``fns`` (the library call, then the
    kernel's entries) timed with ``timer`` in turns, forward then backward
    (library, packed, strided, strided, packed, library); the SM clock and
    power under ``clock_launches`` calls of the library and the packed entry
    and, with the softmax ablated, of the products alone; each of
    ``ablations`` (name -> -D defines) built from ``source`` and its entry
    ``launch(variant, name)`` timed back to back. Prints one JSON line with
    ``checks`` and ``extra``; no ``ok`` line, which belongs to the whole
    run."""
    from mickey_tpu_torch.ops import _cuda

    t = {k: [] for k in fns}
    for name in list(fns) + list(fns)[::-1]:
        t[name].append(timer(fns[name]))
    clocks = {k: clocks_under(fns[k], clock_launches) for k in list(fns)[:2]}
    ablated = {}
    for name, defines in ablations.items():
        fn = launch(_cuda.build_variant(source, defines), name)
        ablated[name] = time_many_ms(fn)
        if name == "products_only":
            clocks[name] = clocks_under(fn, clock_launches)
    r4 = lambda d: {k: ([round(x, 4) for x in v] if isinstance(v, list) else round(v, 4)) for k, v in d.items()}  # noqa: E731
    print(json.dumps({"card": card, **checks, "in_turns_ms_4_images": r4(t),
                      "ablated_back_to_back_ms_4_images": r4(ablated), "sm_clock_and_power_under_load": clocks,
                      **extra}))
    return 0


def attention_report(inp, card: str) -> int:
    """``python3 chip_smoke.py --attention``: the bf16 attention kernel alone.
    K1 and K1b against their plain versions (serving shape, ragged lengths,
    ``seq_len`` < S, bitwise equal to each other and from launch to launch);
    CUDA-event medians of single calls in turns at the serving shape (4
    images), as the ``kernels`` line times them; the same three enqueued back
    to back (``time_many_ms``), and K1 and SDPA at the training shape (16
    images); the timing ablations (``ATTN_ABLATIONS``) on the serving input
    (``_attention_loop``)."""
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.ops import flash_attention as fa

    checks = {"max_abs_err": check_attention_kernels(inp),
              "ragged_max_abs_err": check_attention_shapes(inp["qkv"].device)}
    calls, lib = kernel_calls(inp), library_calls(inp)
    fns = {"library": lib["flash_attention_packed"], "flash_attention_packed": calls["flash_attention_packed"][0],
           "flash_attention": calls["flash_attention"][0]}
    qkv, heads = inp["qkv"], inp["heads"]
    qkv16 = inp["qkv_old"][:, :qkv.shape[1]].contiguous()  # (16, 1939, 3072): the training step's backbone
    q, k, v = (x.contiguous() for x in fa.qkv_heads(qkv16, heads))
    extra = {"back_to_back_ms_4_images": {k: round(time_many_ms(f), 4) for k, f in fns.items()},
             "back_to_back_ms_16_images": {
                 "flash_attention_packed": round(time_many_ms(lambda: fa.flash_attention_packed(qkv16, heads)), 4),
                 "library": round(time_many_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)), 4)}}
    extra["bound_ms_4_images"], extra["bound_by"] = _attention_bound(qkv, heads, PEAK_BF16)

    b, s, c3 = qkv.shape
    shape, strides, offsets = fa.packed_heads_layout(b, s, heads)
    geom = fa._launch_geometry(shape, strides, strides, strides, qkv.element_size(), (s * c3 // 3, 64, c3 // 3))
    ptrs = [qkv.data_ptr() + o * qkv.element_size() for o in offsets]
    out = torch.empty((b, s, c3 // 3), dtype=qkv.dtype, device=qkv.device)

    def launch(variant, name):
        entry = variant.mk_flash_attention_bf16
        return lambda: _cuda.check(entry(*ptrs, out.data_ptr(), geom, s, 0.125, _cuda.stream_ptr(qkv)), name)
    return _attention_loop(card, checks, fns, lambda f: time_ms(f, iters=50, warmup=5), 3000,
                           "flash_attention_packed.cu", ATTN_ABLATIONS, launch, extra)


def attention_f32_report(inp, card: str) -> int:
    """``python3 chip_smoke.py --attention-f32``: the fp32 attention kernel
    K1f alone. K1f packed and strided against their plain versions (serving
    shape, ragged lengths, ``seq_len`` < S, strided bitwise packed, two
    launches bitwise equal) and K1-old within one bf16 ulp; CUDA-event
    medians per call of 20 enqueued back to back (``time_many_ms``) in turns
    (SDPA fp32 with TF32 off, K1f packed, K1f strided), of K1-old at its
    shape, and of the timing ablations (``ATTN_F32_ABLATIONS``) on the
    packed serving input (``_attention_loop``); the bounds: 3xTF32, K1-old's
    (``k1_old_bound``) and the fp32 FMA one of the body K1f replaced."""
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.ops import flash_attention as fa

    calls, lib = kernel_calls(inp), library_calls(inp)
    errs = check_f32_attention_kernels(inp, calls)
    out, ref = (f()[:, :inp["old_len"]] for f in calls["flash_attention_packed_upcast"])
    errs["flash_attention_packed_upcast"] = _within_bf16_ulp(out, ref, "flash_attention_packed_upcast")
    del out, ref
    checks = {"max_abs_err": errs, "ragged_max_rel_err": check_attention_shapes(inp["qkv32"].device, torch.float32)}
    fns = {"library": lib["flash_attention_packed_f32"], "flash_attention_packed_f32": calls["flash_attention_packed_f32"][0],
           "flash_attention_f32": calls["flash_attention_f32"][0]}
    qkv, heads = inp["qkv32"], inp["heads"]
    extra = {"k1_old_back_to_back_ms": round(time_many_ms(calls["flash_attention_packed_upcast"][0], reps=10), 4),
             "k1_old_bound_ms": k1_old_bound(inp)[0],
             "ffma_bound_ms_4_images": _attention_bound(qkv, heads, PEAK_FP32)[0]}
    extra["bound_ms_4_images"], extra["bound_by"] = _attention_bound(qkv, heads, PEAK_TF32, passes=3)

    b, s, c3 = qkv.shape
    out = torch.empty((b, s, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    scratch, geom = fa._f32_scratch(b, heads, s, True, qkv.device)

    def launch(variant, name):
        entry = variant.mk_flash_attention_packed_f32
        return lambda: _cuda.check(entry(qkv.data_ptr(), out.data_ptr(), scratch.data_ptr(), geom, b, s, heads, 0.125,
                                         _cuda.stream_ptr(qkv)), name)
    return _attention_loop(card, checks, fns, time_many_ms, 300, "flash_attention_f32.cu", ATTN_F32_ABLATIONS, launch,
                           extra)


def _stage_times(model, image0, image1, K0, K1, fused: bool = True) -> dict:
    """Per-layer medians on the general layout's 2B stacked images, on the
    fused matcher route or (``fused=False``) the dense one, whose solver
    stage includes the top-P prefilter."""
    from mickey_tpu_torch.nn.extractor import backbone_features, heads_apply

    cfg, B = model.cfg, image0.shape[0]
    ims = torch.cat([image0, image1])
    with torch.inference_mode():
        fmap = backbone_features(model.params, ims, cfg)
        feats = heads_apply(model.params, fmap, cfg)[0]
        halves = (tuple(f[:B] for f in feats), tuple(f[B:] for f in feats))
        tc = model.match_feats(*halves, fused=fused)
        gen = torch.Generator(device=image0.device)
        return {
            "backbone": round(time_ms(lambda: backbone_features(model.params, ims, cfg)), 3),
            "heads": round(time_ms(lambda: heads_apply(model.params, fmap, cfg)), 3),
            "matcher": round(time_ms(lambda: model.match_feats(*halves, fused=fused)), 3),
            "solver": round(time_ms(lambda: model.solve(tc, K0, K1, gen.manual_seed(SEED))), 3),
        }


def ablation_times(inp, iters: int = 20) -> dict:
    """The tools' K1-old A/B (``kernel_new`` against ``kernel_old``) at
    K1-old's inputs: CUDA-event medians of K1's bf16 body (through the K1b
    entry, which takes ``seq_len``) and of K1-old's counterpart, timed in
    turns (new, old, old, new) and averaged per kernel."""
    from mickey_tpu_torch.ops.flash_attention import flash_attention, flash_attention_packed_upcast, qkv_heads

    old, heads, old_len = inp["qkv_old"], inp["heads"], inp["old_len"]
    views = qkv_heads(old, heads)
    fns = {"k1_bf16": lambda: flash_attention(*views, old_len),
           "k1_old_f32": lambda: flash_attention_packed_upcast(old, heads, old_len)}
    t = {k: [] for k in fns}
    for name in ("k1_bf16", "k1_old_f32", "k1_old_f32", "k1_bf16"):
        t[name].append(time_ms(fns[name], iters=iters))
    return {k: round(sum(v) / len(v), 4) for k, v in t.items()}


def _train_stage_times(trainer, batch, iters: int = 5) -> dict:
    """CUDA-event medians of the staged train step at its batch, and of its
    stages: backbone forward, heads forward, matcher forward, loss forward
    (each building its autograd graph, as in training), one backward pass,
    the optimizer; and on the card the peak device memory of one step. The
    matcher and loss are the trainer's route: dense (``match_scores``,
    ``metric_pose_loss``) or fused top-K (``fused_topk_scores_train``,
    ``metric_pose_loss_topk``). The optimizer and whole-step timings update
    the state."""
    from mickey_tpu_torch.nn.extractor import (
        correspondences_from_heads,
        heads_apply,
        topk_train_correspondences_from_heads,
    )
    from mickey_tpu_torch.nn.matcher import match_scores
    from mickey_tpu_torch.ops.fused_matcher import fused_topk_scores_train
    from mickey_tpu_torch.training.loss import metric_pose_loss, metric_pose_loss_topk
    from mickey_tpu_torch.training.train_step import batch_pose, train_loss, use_train_fused_topk

    cfg, step, st, gen, topk = trainer.cfg, trainer.train_step, trainer.state, trainer.generator, trainer.topk
    db = trainer.device_batch(batch)
    Rgt, tgt = batch_pose(db)
    Ks = [db[k] for k in ("K_color0", "K_color1", "Kori_color0", "Kori_color1")]
    fmap = step.backbone_fwd(trainer.backbone, db["image0"], db["image1"])
    leaf = lambda t: t.detach().requires_grad_(True)  # noqa: E731
    with torch.no_grad():
        feats = heads_apply(st.params, fmap, cfg, train=True)[0]
    if use_train_fused_topk(cfg, step.lc):
        c = topk_train_correspondences_from_heads(st.params, feats, cfg)
        fm = cfg.FEATURE_MATCHER.DUAL_SOFTMAX
        d0, d1, s0, s1, kps0, dep0, kps1, dep1 = (leaf(t) for t in (c.dsc0, c.dsc1, c.scr0, c.scr1, c.kps0, c.depth0,
                                                                     c.kps1, c.depth1))
        tk = (c.top_scores, c.top_idx, c.row_ok, leaf(c.lse_row), leaf(c.lse_col))
        matcher = lambda: fused_topk_scores_train(  # noqa: E731
            d0, d1, s0[..., 0], s1[..., 0], st.params["matcher"].get("dustbin_score", 0.0), step.lc.prefilter,
            temperature=float(fm.TEMPERATURE), use_dustbin=bool(fm.USE_DUSTBIN), row_topl=int(cfg.TPU.MATCHER_TOPL))
        loss = lambda: metric_pose_loss_topk(tk, d0, d1, s0, s1, kps0, dep0, kps1, dep1, *Ks, Rgt, tgt,  # noqa: E731
                                             step.lc, topk, temperature=float(fm.TEMPERATURE), generator=gen)
    else:
        c = correspondences_from_heads(st.params, feats, cfg, train=True)
        d0, d1 = leaf(c.dsc0), leaf(c.dsc1)
        loss_in = [leaf(c.final_scores)] + [leaf(t) for t in (c.kps0, c.depth0, c.kps1, c.depth1)]
        matcher = lambda: match_scores(st.params["matcher"], d0, d1, cfg, train=True)  # noqa: E731
        loss = lambda: metric_pose_loss(*loss_in, *Ks, Rgt, tgt, step.lc, topk, generator=gen)  # noqa: E731
    del c

    leaves = st.trainable()
    forward = lambda: train_loss(st.params, fmap, db, cfg, step.lc, topk, gen)[0]  # noqa: E731
    bwd = []
    for i in range(iters + 1):
        total = forward()
        t = _elapsed_ms(lambda: torch.autograd.grad(total, leaves, allow_unused=True))
        if i:
            bwd.append(t)
        del total
    grads = torch.autograd.grad(forward(), leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    out = {
        "backbone_fwd": time_ms(lambda: step.backbone_fwd(trainer.backbone, db["image0"], db["image1"]), iters, 1),
        "heads_fwd": time_ms(lambda: heads_apply(st.params, fmap, cfg, train=True), iters, 1),
        "matcher_fwd": time_ms(matcher, iters, 1),
        "loss_fwd": time_ms(loss, iters, 1),
        "backward": statistics.median(bwd),
        "optimizer": time_ms(lambda: step.optimizer.update(leaves, grads, st.opt_state), iters, 1),
        "step": time_ms(lambda: step(st, trainer.backbone, db, gen, topk), iters, 1),
    }
    if fmap.is_cuda:  # the peak device memory of one whole step
        torch.cuda.reset_peak_memory_stats(fmap.device)
        step(st, trainer.backbone, db, gen, topk)
        out["step_peak_gib"] = torch.cuda.max_memory_allocated(fmap.device) / 2**30
    return {k: round(v, 3) for k, v in out.items()}


if __name__ == "__main__":
    sys.exit(main())
