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
             lengths and with seq_len < S, K2b on ragged sizes with exact
             ties, NaN and infinities, K2b and K3 bitwise from launch to
             launch; the training matcher's whole forward and backward
             against torch.autograd of the dense dual-softmax, and the fused
             top-K training route's against the dense table and
             torch.autograd of the dense logsumexps;
3. slice   - the pose-serving main path at full ViT-L width (714x532 images,
             1938 keypoints, B = 2 pairs, seeded random weights) in both
             layouts (general pairs, shared keyframe); outputs finite and of
             the right shape, every serving kernel launched, K3 once a solve;
             then the general layout with ``TPU.PACKED_ATTENTION=False`` (K1b
             launched, K1 not, backbone features within the bf16 bound of the
             packed run's);
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
   submission - the Map-free submission CLI (``cli.submission.eval_split``
             with the default config's model injected) on a synthetic val
             split written to a temporary directory: two scenes, each a
             keyframe and 65 queries of 540 x 720 held only in a raw-frame
             cache (no decoder needed), 26 pairs after the x5
             subsampling, batches of 12, 12 and 2 (the second spans both
             scenes). The zip holds both scenes' pose files, every line
             parses in the loader's order, the model saw 714 x 532 images,
             the serving kernels launched and no dense-route or unpacked
             one, K3 once a batch, each keyframe extracted once, a second
             run gives the same zip byte for byte, ``--no_shared_ref`` the
             same names in the same order (its largest |dt| printed), and
             the evaluator scores the zip with every metric;
4. timing  - CUDA-event medians of both serving layouts (pairs/s) and their
             stages, of the exact path and its stages, of the default
             config's full output, of the train step and its stages on both
             routes, of each kernel beside its plain version, its bound on
             the card and, where one PyTorch call computes the same function,
             that call (these three per call of 10 enqueued back to back, so
             that the host's launch work hides behind the queue as it does
             inside a model); and the tools' K1-old A/B (K1's bf16 body
             against K1-old's counterpart at (16, 2048, 3072)); then the
             submission path on a larger split of the same kind (five
             scenes of 300 queries: 300 pairs, 25 full batches of 12):
             ``predict`` end to end over all of it (pairs/s, the share of
             it spent waiting on the loader, the device's busy share in one
             profiled run), and ``call_with_ref_feats`` and
             ``model(..., lite=True)`` alone at B = 12.

``python3 chip_smoke.py --submission`` runs the submission phase and its
timing alone.
``python3 chip_smoke.py --attention`` runs the bf16 attention kernel alone
(``attention_report``): its checks, its times beside the library call, single
calls and back to back, and its timing ablations, as one JSON line.
``python3 chip_smoke.py --attention-f32`` does the same for the fp32 one, K1f
(``attention_f32_report``): its checks, its three entries back to back
beside SDPA fp32 with TF32 off, and its timing ablations.
``python3 chip_smoke.py --matcher`` does it for the matcher's forward kernels
on the 3xTF32 correlation engine, K2a, K2b and K4 (``matcher_report``): their
checks on ragged sizes, NaN and infinities (K2b's with exact ties and a NaN
in the last column), their times back to back beside the plain versions
(K2b's in one launch and split in column chunks), their bounds, timing
ablations and distances from fp64.
``python3 chip_smoke.py --scoring`` does it for the RANSAC scoring kernel K3
(``scoring_report``): its checks, one launch a solve against the 20
launches of one a draw, its bound and timing ablations.
``python3 chip_smoke.py --matcher-bwd`` does the same for the gradient
kernels on that engine, K5 (``dual_softmax_bwd_sums``,
``dual_softmax_bwd_grads``) and K6 (``lse_bwd``) (``matcher_bwd_report``),
and adds their and their plain versions' distances from fp64.

Prints the card's name and power limit first, then which of the image
decoders ``cv2``, ``PIL`` and ``torchvision.io`` import, a JSON line of per-kernel
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
import tempfile
import time
from pathlib import Path

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
#  K2a, K2b, K4, K5, K6: the correlation (and K5's and K6's dS products) as
#      3xTF32 on the tensor cores (each term within ~2^-20 of fp32's) against
#      the plain version's fp32 cuBLAS products; the tolerances below are
#      those of fp32 arithmetic, unchanged.
#  K2, K3: fp32 throughout; only the summation order differs:
#      |diff| <= 1e-5 |ref| + 1e-6 max|ref|; indices that one side selects
#      with a margin above its selection boundary must be selected by the
#      other (exact ties and near-ties may swap); K2b's rounds of the same
#      index where the plain version's value is apart from the row's other
#      selected values by MARGIN, NaN and infinities where the plain
#      version has them, non-finite counts equal. K3 at (it B) point sets
#      also at rtol 1e-5, atol 1e-4.
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
#  Dense against fused table (phase 3, check_dense_table): the two routes
#      share K2a's lse_col and recompute the correlation in different
#      kernels (K4, K2b: the same s, but f in one exponential or two), so
#      each route's table values are held at RTOL against the fp64 final
#      scores of the same head outputs and that lse_col, and lse_col at RTOL
#      against fp64; index sets up to near-ties, row_ok equal.
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
MATCHER_SIZES = (1938, 129, 128, 127, 65, 64, 1)  # whole 64-row tiles, one over, one under, a single row


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
                  topl: int, prefilter: int, draws: int, samples: int, hyps: int, old_images: int, old_seq: int,
                  old_len: int, seed: int = SEED):
    """Seeded inputs at the main path's shapes for each kernel (K3's: the
    ``draws`` outer draws of a solve times the pairs, stacked as the solver
    hands them over); K1-old's at the tools' ablation shape (``old_images``
    x ``old_seq`` rows, keys from ``old_len`` on masked, N(0, 0.05^2) values
    as the tool draws them)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    qkv = t(rng.standard_normal((images, seq, 3 * heads * 64), dtype=np.float32)).to(torch.bfloat16)
    d = rng.standard_normal((2, images // 2, kpts, desc), dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    scr = rng.uniform(0, 1, (2, images // 2, kpts)).astype(np.float32)
    scr /= scr.sum(-1, keepdims=True)
    sets = draws * (images // 2)
    X = rng.uniform(-2, 2, (sets, samples, 3)).astype(np.float32)
    ang = rng.uniform(-0.2, 0.2, (sets, hyps, 3))
    R = np.stack([_rot(a) for a in ang.reshape(-1, 3)]).reshape(sets, hyps, 3, 3).astype(np.float32)
    tr = rng.uniform(-0.1, 0.1, (sets, hyps, 1, 3)).astype(np.float32)
    Y = X @ _rot(np.array([0.1, -0.05, 0.02])).T.astype(np.float32) + 0.05
    Y = Y + rng.normal(0, 0.1, Y.shape).astype(np.float32)
    qkv32 = t(rng.standard_normal((images, seq, 3 * heads * 64), dtype=np.float32))
    qkv_old = t(0.05 * rng.standard_normal((old_images, old_seq, 3 * heads * 64), dtype=np.float32)).to(torch.bfloat16)
    return dict(qkv=qkv, heads=heads, dsc0=t(d[0]), dsc1=t(d[1]), scr0=t(scr[0]), scr1=t(scr[1]),
                topl=topl, prefilter=prefilter, draws=draws, X=t(X), Y=t(Y), R=t(R), t=t(tr), qkv32=qkv32,
                qkv_old=qkv_old, old_len=old_len)


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
    # K2b reads the split descriptors K2a writes, as on the main path
    split = fm.topk_split(inp["dsc0"], inp["dsc1"])
    fm.col_lse(inp["dsc0"], inp["dsc1"], inv_temp, alpha, split)
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
        "pair_topk": (lambda: fm.pair_topk(*k2b, split), lambda: fm.pair_topk_plain(*k2b)),
        "hypothesis_scores": (lambda: hypothesis_scores(*hyp), lambda: hypothesis_scores_plain(*hyp)),
    }


def check_kernels(inp, topk_sizes=MATCHER_SIZES) -> dict:
    """Phase 2: each kernel against its plain version; returns name -> max |diff|."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    calls = kernel_calls(inp)
    res = check_attention_kernels(inp, calls)
    res.update(check_f32_attention_kernels(inp, calls))
    out, ref = (f()[:, :inp["old_len"]] for f in calls["flash_attention_packed_upcast"])
    res["flash_attention_packed_upcast"] = _within_bf16_ulp(out, ref, "flash_attention_packed_upcast")
    res["col_lse"] = _close(*(f() for f in calls["col_lse"]), "col_lse")
    out, ref = (f() for f in calls["pair_topk"])
    res["pair_topk"] = _topk_checked(out, ref, "pair_topk")
    _bitwise(calls["pair_topk"][0], out, "pair_topk")
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
    out, ref = (f() for f in calls["hypothesis_scores"])
    res["hypothesis_scores"] = _close_k3(out, ref, "hypothesis_scores")
    _bitwise(calls["hypothesis_scores"][0], out, "hypothesis_scores")
    res["pair_topk"] = max(res["pair_topk"], check_topk_shapes(inp["dsc0"].device, topk_sizes))
    return res


def _bitwise(call, first, what: str) -> None:
    """A second launch of ``call`` gives ``first`` bit for bit (NaN too)."""
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x  # noqa: E731
    again = call()
    pairs = zip(again, first) if isinstance(first, tuple) else ((again, first),)
    if not all(torch.equal(bits(a), bits(b)) for a, b in pairs):
        raise SmokeError(f"{what}: two launches differ")


K3_RTOL, K3_ATOL = 1e-5, 1e-4


def _close_k3(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """K3 against its plain version: |diff| <= K3_ATOL + K3_RTOL |ref|."""
    a, b = a.double().cpu(), b.double().cpu()
    err = (a - b).abs()
    if not bool((err <= K3_ATOL + K3_RTOL * b.abs()).all()):
        raise SmokeError(f"{what}: max |diff| {err.max().item():.3e} beyond rtol {K3_RTOL}, atol {K3_ATOL}")
    return err.max().item()


def _rounds_agree(v, i, pv, pi, what: str) -> None:
    """K2b's rounds (B, L, M) against the plain version's: the same index
    at every round whose plain value is apart from each other value of its
    row's rounds by MARGIN (relative; NaN rounds apart from none but equal
    to the plain version's (NaN, N - 1)), and the kernel's own rounds of
    positive values (not clamped at 0) in (value desc, index asc) order."""
    v, i, pv, pi = (np.asarray(x.cpu(), dtype=np.float64 if x.is_floating_point() else np.int64).transpose(0, 2, 1)
                    for x in (v, i, pv, pi))
    with np.errstate(invalid="ignore"):  # inf - inf
        gap = np.abs(pv[..., :, None] - pv[..., None, :])
    gap = np.where(np.eye(pv.shape[-1], dtype=bool), np.inf, gap)
    apart = np.nan_to_num(gap, nan=np.inf).min(-1) > MARGIN * np.abs(pv)
    apart |= np.isnan(pv)
    if not np.array_equal(np.where(apart, i, 0), np.where(apart, pi, 0)):
        raise SmokeError(f"{what}: {int((apart & (i != pi)).sum())} rounds select another index than the plain version")
    a, b, ia, ib = v[..., :-1], v[..., 1:], i[..., :-1], i[..., 1:]
    ordered = (a > b) | ((a == b) & (ia < ib)) | ~(b > 0) | np.isnan(a)
    if not ordered.all():
        raise SmokeError(f"{what}: {int((~ordered).sum())} rounds out of (value desc, index asc) order")


def _topk_checked(out, ref, what: str) -> float:
    """K2b's four outputs against the plain version's: values, lse_row,
    mass and minimum by ``_close_nan`` (RTOL, NaN and infinities where the
    plain version has them), non-finite counts equal, the rounds by
    ``_rounds_agree`` and, over the rows, ``_sets_agree``. Returns the
    largest max |diff|."""
    (v, i, st, lr), (pv, pi, pst, plr) = out, ref
    err = max(_close_nan(v, pv, f"{what} values"), _close_nan(lr, plr, f"{what} lse_row"),
              _close_nan(st[..., 0], pst[..., 0], f"{what} mass"), _close_nan(st[..., 2], pst[..., 2], f"{what} min"))
    if not torch.equal(st[..., 1].cpu(), pst[..., 1].cpu()):
        raise SmokeError(f"{what}: non-finite counts differ")
    _rounds_agree(v, i, pv, pi, what)
    fin = torch.isfinite(pv).all(1)[:, None, :].expand_as(pv)  # rows without NaN or infinities
    if bool(fin.any()):
        rows = lambda x: x.transpose(1, 2)[fin.transpose(1, 2)].reshape(-1, x.shape[1])  # noqa: E731
        _sets_agree(rows(v), rows(i), rows(pv), rows(pi), f"{what} rows")
    return err


def check_topk_shapes(device, sizes=MATCHER_SIZES, desc: int = 128, topl: int = 16, seed: int = SEED) -> float:
    """K2b on ragged sizes: M = sizes[i], N = sizes[i + 1] (cyclic), 3
    images of seeded unit descriptors and uniform scores, with the dustbin
    on and off, against its plain version on the plain lse_col
    (``_topk_checked``). Image 0: column 7 a copy of column 3 (exact ties in
    every row) and scr1 +inf at column 5, where N > 7; image 1: an infinite
    descriptor value (dsc1, row 3); image 2: scr1 NaN at the last column (its
    only NaN, in most rows) and, in the first pair, a NaN row of dsc0 (row
    5). N = 1 leaves rounds past the row's end. K2b reads the split K2a
    writes (dustbin on) or splits the descriptors itself (off). Returns the
    largest max |diff|."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    rng = np.random.default_rng(seed + 11)

    def unit(rows):
        d = rng.standard_normal((3, rows, desc), dtype=np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    worst = 0.0
    for k, m in enumerate(sizes):
        n = sizes[(k + 1) % len(sizes)]
        d0, d1 = unit(m), unit(n)
        s0, s1 = (rng.uniform(0, 1, (3, r)).astype(np.float32) for r in (m, n))
        if n > 7:
            d1[0, 7], s1[0, 7] = d1[0, 3], s1[0, 3]
            s1[0, 5] = np.inf
        d1[1, min(3, n - 1), 7 % desc] = np.inf
        s1[2, n - 1] = np.nan
        if k == 0:
            d0[2, min(5, m - 1)] = np.nan
        d0, d1, s0, s1 = (t(x) for x in (d0, d1, s0, s1))
        for use_dustbin in (True, False):
            alpha = fm._alpha(1.0, use_dustbin)
            lc = fm.col_lse_plain(d0, d1, 10.0, alpha)
            split = fm.topk_split(d0, d1) if use_dustbin else None
            if split is not None:
                fm.col_lse(d0, d1, 10.0, alpha, split)
            call = lambda: fm.pair_topk(d0, d1, s0, s1, lc, 10.0, alpha, topl, split)  # noqa: E731
            out = call()
            what = f"pair_topk, M {m}, N {n}, dustbin {use_dustbin}"
            worst = max(worst, _topk_checked(out, fm.pair_topk_plain(d0, d1, s0, s1, lc, 10.0, alpha, topl), what))
            _bitwise(call, out, what)
    return worst


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
    return with_alpha(inp, inp["alpha"])


def with_alpha(tin, alpha: float) -> dict:
    """``tin`` with the dustbin logit ``alpha`` (``fused_matcher.NEG_INF``:
    no dustbin) and the intermediate inputs of K4 / K5 / K6 for it, made by
    the plain versions: lse_col, lse_row, r and c."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    inp = dict(tin, alpha=alpha)
    d0, d1, it = inp["dsc0"], inp["dsc1"], inp["inv_temp"]
    inp["lse_col"] = fm.col_lse_plain(d0, d1, it, alpha)
    _, inp["lse_row"] = fm.pair_softmax_plain(d0, d1, inp["lse_col"], it, alpha)
    inp["r"], inp["c"] = fm.dual_softmax_bwd_sums_plain(d0, d1, inp["G"], inp["lse_row"], inp["lse_col"], it)
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


def _close_nan(a: torch.Tensor, b: torch.Tensor, what: str, rtol: float = RTOL) -> float:
    """``_close`` where the plain version ``b`` may hold NaN and infinities:
    NaN exactly where ``b`` is NaN, the same infinity where ``b`` is
    infinite, ``rtol`` elsewhere. Returns max |diff| over the finite values."""
    a, b = a.double().cpu(), b.double().cpu()
    inf = torch.isinf(b)
    if not (torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a[inf], b[inf])):
        raise SmokeError(f"{what}: NaN or infinite values differ from the plain version's")
    fin = torch.isfinite(b)
    return _close(a[fin], b[fin], what, rtol) if bool(fin.any()) else 0.0


def check_matcher_kernels(inp, tin) -> dict:
    """``--matcher``: K2a (col_lse) against its plain version at RTOL at the
    serving shape and at the training shape (the dense training route runs it
    there), K4 (pair_softmax) at DS_RTOL at the training shape; K2b
    (pair_topk, on K2a's split) by ``_topk_checked`` at both shapes (split
    in column chunks at the serving shape, one launch at the training shape,
    where its lse_row is K4's bit for bit: the same correlation and sweep);
    two launches of each bitwise equal (no atomics, a fixed order of the
    chunks' sums). Returns name -> max |diff|."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    res = {}
    for shape, d0, d1 in (("serving", inp["dsc0"], inp["dsc1"]), ("training", tin["dsc0"], tin["dsc1"])):
        out = fm.col_lse(d0, d1, 10.0, 1.0)
        res[f"col_lse {shape}"] = _close(out, fm.col_lse_plain(d0, d1, 10.0, 1.0), f"col_lse, {shape} shape")
        if not torch.equal(fm.col_lse(d0, d1, 10.0, 1.0), out):
            raise SmokeError(f"col_lse: two launches differ at the {shape} shape")
    d0, d1, lc = tin["dsc0"], tin["dsc1"], tin["lse_col"]
    out, lse_row = fm.pair_softmax(d0, d1, lc, 10.0, 1.0)
    ref, ref_row = fm.pair_softmax_plain(d0, d1, lc, 10.0, 1.0)
    res["pair_softmax training"] = max(_close(out, ref, "pair_softmax out", DS_RTOL),
                                       _close(lse_row, ref_row, "pair_softmax lse_row", DS_RTOL))
    del ref
    again = fm.pair_softmax(d0, d1, lc, 10.0, 1.0)
    if not (torch.equal(again[0], out) and torch.equal(again[1], lse_row)):
        raise SmokeError("pair_softmax: two launches differ")
    for shape, x in (("serving", inp), ("training", tin)):
        a0, a1, s0, s1 = (x[k] for k in ("dsc0", "dsc1", "scr0", "scr1"))
        lc = fm.col_lse_plain(a0, a1, 10.0, 1.0)
        split = fm.topk_split(a0, a1)
        fm.col_lse(a0, a1, 10.0, 1.0, split)
        call = lambda: fm.pair_topk(a0, a1, s0, s1, lc, 10.0, 1.0, inp["topl"], split)  # noqa: E731
        k2b = call()
        res[f"pair_topk {shape}"] = _topk_checked(k2b, fm.pair_topk_plain(a0, a1, s0, s1, lc, 10.0, 1.0, inp["topl"]),
                                                  f"pair_topk, {shape} shape")
        _bitwise(call, k2b, f"pair_topk, {shape} shape")
    if not torch.equal(k2b[3], fm.pair_softmax(d0, d1, lc, 10.0, 1.0)[1]):
        raise SmokeError("pair_topk's lse_row differs from pair_softmax's at the training shape")
    return res


def check_matcher_shapes(device, sizes=MATCHER_SIZES, desc: int = 128, seed: int = SEED) -> float:
    """K2a and K4 on ragged sizes: M = sizes[i], N = sizes[i + 1] (cyclic),
    3 images of seeded unit descriptors, with the dustbin on and off, against
    their plain versions (K4 on the plain lse_col): lse_col at RTOL, P and
    lse_row at DS_RTOL, NaN and infinities where the plain version has them.
    In the first pair image 1 holds an infinite descriptor value (dsc1, row
    3) and image 2 a NaN row (dsc0, row 5). Returns the largest max |diff|."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    rng = np.random.default_rng(seed + 9)

    def unit(rows):
        d = rng.standard_normal((3, rows, desc), dtype=np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    worst = 0.0
    for i, m in enumerate(sizes):
        n = sizes[(i + 1) % len(sizes)]
        d0, d1 = unit(m), unit(n)
        if i == 0:
            d1[1, min(3, n - 1), 7] = np.inf
            d0[2, min(5, m - 1)] = np.nan
        d0, d1 = (torch.from_numpy(x).to(device) for x in (d0, d1))
        for use_dustbin in (True, False):
            alpha = fm._alpha(1.0, use_dustbin)
            what = f"M {m}, N {n}, dustbin {use_dustbin}"
            lc = fm.col_lse_plain(d0, d1, 10.0, alpha)
            worst = max(worst, _close_nan(fm.col_lse(d0, d1, 10.0, alpha), lc, f"col_lse, {what}"))
            (p, lr), (pp, plr) = fm.pair_softmax(d0, d1, lc, 10.0, alpha), fm.pair_softmax_plain(d0, d1, lc, 10.0, alpha)
            worst = max(worst, _close_nan(p, pp, f"pair_softmax out, {what}", DS_RTOL),
                        _close_nan(lr, plr, f"pair_softmax lse_row, {what}", DS_RTOL))
    return worst


def _close_to_max_nan(a: torch.Tensor, b: torch.Tensor, what: str, tol: float) -> float:
    """``_close_to_max`` where the plain version ``b`` may hold NaN and
    infinities, as ``_close_nan``: the same non-finite pattern, ``tol``
    max|finite ref| on the finite values. Returns their max |diff|."""
    a, b = a.double().cpu(), b.double().cpu()
    inf = torch.isinf(b)
    if not (torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a[inf], b[inf])):
        raise SmokeError(f"{what}: NaN or infinite values differ from the plain version's")
    fin = torch.isfinite(b)
    return _close_to_max(a[fin], b[fin], what, tol) if bool(fin.any()) else 0.0


def _bwd_checked(tin, what: str, close, close_to_max) -> float:
    """K5's two bodies and K6 on ``tin`` against their plain versions: r, c
    with ``close`` at DS_RTOL, dd0 and dd1 with ``close_to_max`` at DS_RTOL
    max|ref|. Returns the largest max |diff|."""
    calls = train_kernel_calls(tin)
    (r, c), (pr, pc) = (f() for f in calls["dual_softmax_bwd_sums"])
    worst = max(close(r, pr, f"bwd_sums r, {what}", DS_RTOL), close(c, pc, f"bwd_sums c, {what}", DS_RTOL))
    for name in ("dual_softmax_bwd_grads", "lse_bwd"):
        (g0, g1), (pg0, pg1) = (f() for f in calls[name])
        worst = max(worst, close_to_max(g0, pg0, f"{name} dd0, {what}", DS_RTOL),
                    close_to_max(g1, pg1, f"{name} dd1, {what}", DS_RTOL))
    return worst


def check_matcher_bwd_kernels(tin) -> dict:
    """``--matcher-bwd``: K5's two bodies (bwd_sums, bwd_grads) and K6
    (lse_bwd) against their plain versions at the training shape, with the
    dustbin on and off (the intermediate inputs remade for each); two
    launches of each bitwise equal (no atomics, the column sums and both
    gradients in a fixed order). Returns "dustbin on / off" -> max |diff|."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    res = {}
    for use_dustbin in (True, False):
        t = tin if use_dustbin else with_alpha(tin, fm.NEG_INF)
        what = f"dustbin {'on' if use_dustbin else 'off'}"
        res[what] = _bwd_checked(t, what, _close, _close_to_max)
        for name, (kernel, _) in train_kernel_calls(t).items():
            if name != "pair_softmax" and not all(torch.equal(x, y) for x, y in zip(kernel(), kernel())):
                raise SmokeError(f"{name}: two launches differ, {what}")
    return res


def check_matcher_bwd_shapes(device, sizes=MATCHER_SIZES, desc: int = 128, seed: int = SEED) -> float:
    """K5's two bodies and K6 on ragged sizes: M = sizes[i], N = sizes[i +
    1] (cyclic), 3 images of seeded unit descriptors, a seeded G and
    cotangents, with the dustbin on and off, against their plain versions
    (on the plain versions' intermediate inputs): r, c at DS_RTOL, dd0, dd1
    at DS_RTOL max|ref|, NaN and infinities where the plain version has
    them. In the first pair image 1 holds an infinite descriptor value
    (dsc1, row 3) and image 2 a NaN row (dsc0, row 5). Returns the largest
    max |diff|."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    rng = np.random.default_rng(seed + 10)

    def unit(rows):
        d = rng.standard_normal((3, rows, desc), dtype=np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    worst = 0.0
    for i, m in enumerate(sizes):
        n = sizes[(i + 1) % len(sizes)]
        d0, d1 = unit(m), unit(n)
        if i == 0:
            d1[1, min(3, n - 1), 7 % desc] = np.inf
            d0[2, min(5, m - 1)] = np.nan
        tin = dict(dsc0=t(d0), dsc1=t(d1), G=t(rng.standard_normal((3, m, n), dtype=np.float32)),
                   gr=t(rng.standard_normal((3, m), dtype=np.float32)),
                   gc=t(rng.standard_normal((3, n), dtype=np.float32)), inv_temp=10.0)
        for use_dustbin in (True, False):
            what = f"M {m}, N {n}, C {desc}, dustbin {use_dustbin}"
            worst = max(worst, _bwd_checked(with_alpha(tin, fm._alpha(1.0, use_dustbin)), what, _close_nan,
                                            _close_to_max_nan))
    return worst


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
    matrix must give the same table: index sets up to near-ties, row_ok
    equal, and the values of each at RTOL (1e-5 relative) against the same
    final scores recomputed in fp64 from the head outputs
    and K2a's lse_col, which both routes share and which is itself held
    against fp64 at RTOL. The routes differ in the kernel that recomputes
    the correlation (K2b in fp32 FMA, K4 in 3xTF32), so each is held to the
    exact function rather than to the other. Reports the largest |diff|
    between the two tables, each side's largest share of its RTOL bound,
    and the share of the exact global top-P (``torch.topk`` over the whole
    matrix) that the fused table holds, by count and by score mass."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    B = image0.shape[0]
    cfg = model.cfg
    full = model(image0, image1, K0, K1, generator=torch.Generator(device=image0.device).manual_seed(SEED))
    feats = model.extract_feats(torch.cat([image0, image1]))
    tc = model.match_feats(tuple(f[:B] for f in feats), tuple(f[B:] for f in feats), fused=True)
    final = full.corr.final_scores
    P, L = int(cfg.TPU.SAMPLING_PREFILTER), int(cfg.TPU.MATCHER_TOPL)
    dv, di, dok = fm.dense_topk_scores(final, P, row_topl=L)
    _sets_agree(tc.top_scores, tc.top_idx, dv, di, "dense vs fused table")
    if not torch.equal(tc.row_ok.cpu(), dok.cpu()):
        raise SmokeError("dense vs fused table: row_ok differs")
    dsm = cfg.FEATURE_MATCHER.DUAL_SOFTMAX
    inv_temp = 1.0 / float(dsm.TEMPERATURE)
    alpha = fm._alpha(float(model.params["matcher"].get("dustbin_score", 0.0)), bool(dsm.USE_DUSTBIN))
    d0, d1 = full.corr.dsc0.float().contiguous(), full.corr.dsc1.float().contiguous()
    lse_col = fm.col_lse(d0, d1, inv_temp, alpha)
    s64 = torch.matmul(d0.double(), d1.double().transpose(1, 2)) * inv_temp
    _close(lse_col, fm._col_lse_from(s64, alpha), "K2a lse_col vs fp64")
    ref = torch.exp(2.0 * s64 - fm._row_lse(s64, alpha)[..., None] - lse_col.double()[:, None, :])
    ref = (ref * full.corr.scr0.double() * full.corr.scr1.double().transpose(1, 2)).reshape(B, -1)
    del s64
    shares = {}
    for name, vals, idx in (("fused", tc.top_scores, tc.top_idx), ("dense", dv, di)):
        want = torch.gather(ref, 1, idx.long())
        _close(vals, want, f"{name} table values vs fp64")
        err = (vals.double() - want).abs()
        shares[f"{name}_share_of_rtol"] = (err / (RTOL * want.abs() + 1e-6 * want.abs().max())).max().item()
    del ref
    gv, gi = torch.topk(final.reshape(B, -1).float(), P, dim=-1)
    recall = [len(set(a.tolist()) & set(b.tolist())) / P for a, b in zip(tc.top_idx.long().cpu(), gi.cpu())]
    mass = (tc.top_scores.double().sum(-1) / gv.double().sum(-1)).tolist()
    return {"table_max_abs": (tc.top_scores.double() - dv.double()).abs().max().item(), **shares,
            "global_topP_recall": recall, "global_topP_mass": mass}


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


def col_lse_bound(dsc0, dsc1, peak: float = PEAK_TF32, passes: float = 3.0):
    """K2a's bound: the correlation's 2 B M N C flops at fp32 accuracy, three
    TF32 passes at 495 TFLOP/s (``peak=PEAK_FP32, passes=1``: the fp32 FMA
    bound of the body it replaced), against both descriptor sets read and
    lse_col written once."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    return _bound(passes * 2.0 * B * M * N * C, (B * M * C + B * N * C + B * N) * 4, peak)


def pair_softmax_bound(dsc0, dsc1, peak: float = PEAK_TF32, passes: float = 3.0):
    """K4's bound: one correlation (a second sweep is the kernel's choice, not
    work the function needs) as for K2a, against the descriptors and lse_col
    read and P (B, M, N) and lse_row written once."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    return _bound(passes * 2.0 * B * M * N * C, (B * M * C + B * N * C + B * N + B * M * N + B * M) * 4, peak)


def bwd_sums_bound(dsc0, dsc1, peak: float = PEAK_TF32, passes: float = 3.0):
    """K5's first body's bound: one correlation as for K2a, against the
    descriptors, G (B, M, N), lse_row and lse_col read and r, c written
    once."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    return _bound(passes * 2.0 * B * M * N * C, (B * M * C + B * N * C + B * M * N + 2 * B * M + 2 * B * N) * 4, peak)


def bwd_grads_bound(dsc0, dsc1, peak: float = PEAK_TF32, passes: float = 3.0):
    """K5's second body's bound: the function's three products (s, dS dsc1,
    dS^T dsc0; recomputing s in each of its two launches is the kernel's
    choice) at fp32 accuracy, three TF32 passes each at 495 TFLOP/s
    (``peak=PEAK_FP32, passes=1``: the FFMA bound of the body it replaced),
    against the descriptors, G, both logsumexps and r, c read and dd0, dd1
    written once (G read twice by the two launches adds 0.036 ms at the
    training shape, still under the operations' 0.14)."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    return _bound(passes * 3 * 2.0 * B * M * N * C,
                  (2 * (B * M * C + B * N * C) + B * M * N + 2 * B * M + 2 * B * N) * 4, peak)


def lse_bwd_bound(dsc0, dsc1, peak: float = PEAK_TF32, passes: float = 3.0):
    """K6's bound: three products as ``bwd_grads_bound``, against the
    descriptors, the two logsumexps and their cotangents read and dd0, dd1
    written once (no (B, M, N) tensor)."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    return _bound(passes * 3 * 2.0 * B * M * N * C, (2 * (B * M * C + B * N * C) + 2 * B * M + 2 * B * N) * 4, peak)


def pair_topk_bound(dsc0, dsc1, topl: int, peak: float = PEAK_TF32, passes: float = 3.0):
    """K2b's bound: one correlation (its second sweep is the kernel's
    choice) at fp32 accuracy, three TF32 passes at 495 TFLOP/s
    (``peak=PEAK_FP32, passes=1``: the FFMA bound of the body it replaced), against
    the descriptors, scr0, scr1 and lse_col read and the (B, L, M) values and
    indices, the stats and lse_row written once."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    return _bound(passes * 2.0 * B * M * N * C,
                  (B * M * C + B * N * C + B * M + 2 * B * N + 2 * B * topl * M + 4 * B * M) * 4, peak)


SM_COUNT = 132  # an H100 SXM's SMs
SFU_PER_CLOCK = 16  # special-function results a clock on each SM (sm_90)
H100_MAX_SM_HZ = 1.98e9  # the SM clock's maximum (nvidia-smi clocks.max.sm: 1980 MHz)


def hypothesis_bound(X, R):
    """K3's bound: per (point set, hypothesis, sample) term ~30 fp32
    operations at 67 TFLOP/s and 3 special-function ones (the square root,
    the exponential and the reciprocal) at SFU_PER_CLOCK a clock on each of
    SM_COUNT SMs at the card's peak clock H100_MAX_SM_HZ (as every other
    bound takes the card's peak rate; the clock under load is printed
    beside it), against X, Y, the poses read and the (E, R) scores written
    once."""
    E, S = X.shape[:2]
    nR = R.shape[1]
    terms = E * nR * S
    ms, by = _bound(30.0 * terms, (2 * E * S * 3 + E * nR * 12 + E * nR) * 4, PEAK_FP32)
    sfu_ms = 3.0 * terms / (SFU_PER_CLOCK * SM_COUNT * H100_MAX_SM_HZ) * 1e3
    return (sfu_ms, "operations") if sfu_ms > ms else (ms, by)


def kernel_bounds(inp, tin) -> dict:
    """name -> (bound_ms, bound_by) at this run's kernel inputs. Operations
    counted: the matrix products (2 flops per multiply-add; K1's two products
    on bf16 tensor cores; K1f's, K2a's, K2b's, K4's, K5's and K6's at fp32
    accuracy as 3xTF32, three TF32 passes each; K1-old's on bf16 tensor
    cores, ``k1_old_bound``) and, for K3, the ~30 fp32 operations and 3
    special-function ones of one soft-inlier term (``hypothesis_bound``, at
    the peak SM clock); the matcher's exponentials are left out."""
    heads = inp["heads"]
    attn = _attention_bound(inp["qkv"], heads, PEAK_BF16)
    attn32 = _attention_bound(inp["qkv32"], heads, PEAK_TF32, passes=3)
    return {
        "flash_attention_packed": attn,
        "flash_attention": attn,  # the same q, k, v read and output written, on another layout
        "flash_attention_packed_f32": attn32,
        "flash_attention_f32": attn32,
        "flash_attention_packed_upcast": k1_old_bound(inp),
        "col_lse": col_lse_bound(inp["dsc0"], inp["dsc1"]),
        "pair_topk": pair_topk_bound(inp["dsc0"], inp["dsc1"], inp["topl"]),
        "hypothesis_scores": hypothesis_bound(inp["X"], inp["R"]),
        "pair_softmax": pair_softmax_bound(tin["dsc0"], tin["dsc1"]),
        "dual_softmax_bwd_sums": bwd_sums_bound(tin["dsc0"], tin["dsc1"]),
        "dual_softmax_bwd_grads": bwd_grads_bound(tin["dsc0"], tin["dsc1"]),
        "lse_bwd": lse_bwd_bound(tin["dsc0"], tin["dsc1"]),
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


def _once_per_solve(launches: dict, path: str, solves: int) -> None:
    """Fail unless K3 was launched once for each of the path's ``solves``
    solves: the solver scores all its outer draws in one launch."""
    if launches["hypothesis_scores"] != solves:
        raise SmokeError(f"{path}: hypothesis_scores launched {launches['hypothesis_scores']} times for {solves} solves")


def sm_clock_hz(fn, launches: int = 3000) -> float:
    """The SM clock (Hz) ``nvidia-smi`` reads while ``launches`` calls of
    ``fn()`` are queued and running."""
    return float(clocks_under(fn, launches).split(",")[0].split()[0]) * 1e6


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
    print(f"decoders: {decoders_line()}", flush=True)

    # 1. build
    lib, log = _cuda.build()
    ptx = [ln.strip() for ln in log.splitlines() if any(w in ln for w in ("registers", "Compiling entry", "spill", "arning"))]
    print("build: ok | " + " | ".join(ptx), flush=True)

    # 2. kernels vs plain, at the main paths' shapes: serving (ViT-L 714x532,
    #    B = 2) and training (B = 8 pairs, 1938 keypoints, C = 128)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config()
    if "--submission" in sys.argv[1:]:
        return submission_report(cfg, dev, card)
    inp = kernel_inputs(dev, images=4, seq=1939, heads=16, kpts=1938, desc=128, topl=int(cfg.TPU.MATCHER_TOPL),
                        prefilter=int(cfg.TPU.SAMPLING_PREFILTER), draws=int(cfg.PROCRUSTES.IT_MATCHES),
                        samples=int(cfg.PROCRUSTES.NUM_SAMPLED_MATCHES), hyps=int(cfg.PROCRUSTES.IT_RANSAC),
                        old_images=16, old_seq=2048, old_len=1939)
    if "--attention" in sys.argv[1:]:
        return attention_report(inp, card)
    if "--attention-f32" in sys.argv[1:]:
        return attention_f32_report(inp, card)
    if "--matcher" in sys.argv[1:]:
        return matcher_report(inp, train_kernel_inputs(dev, pairs=8, kpts=1938, desc=128), card)
    if "--matcher-bwd" in sys.argv[1:]:
        return matcher_bwd_report(train_kernel_inputs(dev, pairs=8, kpts=1938, desc=128), card)
    if "--scoring" in sys.argv[1:]:
        return scoring_report(inp, card)
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
    _once_per_solve(serve_launches, "serving", 2)  # general and shared keyframe
    cfg_u = cfg.clone()
    cfg_u.TPU.PACKED_ATTENTION = False
    model_u = MickeyRelativePose(cfg_u, model.params, device=dev)  # the same weights
    outs_u, unpacked_launches = _counted(lambda: run_slice(model_u, image0, image1, K0, K1, ("general",)))
    _launched(unpacked_launches, "serving, unpacked attention", UNPACKED_SERVING_KERNELS, ("flash_attention_packed",))
    _once_per_solve(unpacked_launches, "serving, unpacked attention", 1)
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
    _once_per_solve(exact_launches, "exact path", 3)  # the full output, the dense lite outputs in both layouts
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

    # 3d. the submission CLI at full width on a synthetic val split (two
    #     scenes of 540 x 720 raw-cached frames, 26 pairs, batches of 12)
    sub_dir = tempfile.TemporaryDirectory(prefix="mickey_submission_")
    write_val_split(sub_dir.name)
    sub = run_submission(model, cfg, sub_dir.name)
    print(submission_line(sub), flush=True)

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
    sm_hz = sm_clock_hz(calls["hypothesis_scores"][0])
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
          f"train ms (B = {cfg.TRAINING.BATCH_SIZE}) {train_stages} | SM clock under K3 {sm_hz / 1e6:.0f} MHz "
          f"(its bound at the peak {H100_MAX_SM_HZ / 1e6:.0f}) | "
          + " ".join(f"{n} {k:.4f}/{p:.4f} ms kernel/plain" for n, (k, p) in kt.items())
          + " | " + " ".join(f"{n} library {t:.4f} ms" for n, t in lib_ms.items()), flush=True)
    sub_dir.cleanup()
    print(f"timing (submission): ok | {card} | {json.dumps(submission_times(model, cfg))}", flush=True)

    runs = (serve_launches, unpacked_launches, exact_launches, exact_unpacked_launches, *train_launches.values(),
            ablation_launches, *sub["launches"])
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


def _kernel_loop(card, checks: dict, fns: dict, timer, clocked, clock_launches: int, ablations: dict, launch,
                 extra: dict, clock_ablation: str | None = None) -> int:
    """The body of the quick loops (``--attention``, ``--attention-f32``,
    ``--matcher``, ``--matcher-bwd``). ``fns`` (name -> call) timed with ``timer`` in turns,
    forward then backward (a, b, c, c, b, a); the SM clock and power under
    ``clock_launches`` calls of each of ``clocked``; each of ``ablations``
    (name -> -D defines) built and timed back to back: ``launch(defines,
    name)`` returns label -> call on the timing builds, and the clock is read
    under the one named ``clock_ablation``. Prints one JSON line with
    ``checks`` and ``extra``; no ``ok`` line, which belongs to the whole
    run."""
    t = {k: [] for k in fns}
    for name in list(fns) + list(fns)[::-1]:
        t[name].append(timer(fns[name]))
    clocks = {k: clocks_under(fns[k], clock_launches) for k in clocked}
    ablated = {}
    for name, defines in ablations.items():
        for label, fn in launch(defines, name).items():
            ablated[label] = time_many_ms(fn)
            if name == clock_ablation:
                clocks[label] = clocks_under(fn, clock_launches)
    r4 = lambda d: {k: ([round(x, 4) for x in v] if isinstance(v, list) else round(v, 4)) for k, v in d.items()}  # noqa: E731
    print(json.dumps({"card": card, **checks, "in_turns_ms": r4(t), "ablated_back_to_back_ms": r4(ablated),
                      "sm_clock_and_power_under_load": clocks, **extra}))
    return 0


def _variant_launch(source: str, make):
    """``launch`` for ``_kernel_loop`` on one source: the timing build of
    ``source`` with the defines, and ``make(variant, name)``'s call on it."""
    from mickey_tpu_torch.ops import _cuda

    return lambda defines, name: {name: make(_cuda.build_variant(source, defines), name)}


def attention_report(inp, card: str) -> int:
    """``python3 chip_smoke.py --attention``: the bf16 attention kernel alone.
    K1 and K1b against their plain versions (serving shape, ragged lengths,
    ``seq_len`` < S, bitwise equal to each other and from launch to launch);
    CUDA-event medians of single calls in turns at the serving shape (4
    images), as the ``kernels`` line times them; the same three enqueued back
    to back (``time_many_ms``), and K1 and SDPA at the training shape (16
    images); the timing ablations (``ATTN_ABLATIONS``) on the serving input
    (``_kernel_loop``)."""
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

    def make(variant, name):
        entry = variant.mk_flash_attention_bf16
        return lambda: _cuda.check(entry(*ptrs, out.data_ptr(), geom, s, 0.125, _cuda.stream_ptr(qkv)), name)
    extra["timed_shape"] = "4 images"
    return _kernel_loop(card, checks, fns, lambda f: time_ms(f, iters=50, warmup=5), list(fns)[:2], 3000,
                        ATTN_ABLATIONS, _variant_launch("flash_attention_packed.cu", make), extra, "products_only")


def attention_f32_report(inp, card: str) -> int:
    """``python3 chip_smoke.py --attention-f32``: the fp32 attention kernel
    K1f alone. K1f packed and strided against their plain versions (serving
    shape, ragged lengths, ``seq_len`` < S, strided bitwise packed, two
    launches bitwise equal) and K1-old within one bf16 ulp; CUDA-event
    medians per call of 20 enqueued back to back (``time_many_ms``) in turns
    (SDPA fp32 with TF32 off, K1f packed, K1f strided), of K1-old at its
    shape, and of the timing ablations (``ATTN_F32_ABLATIONS``) on the
    packed serving input (``_kernel_loop``); the bounds: 3xTF32, K1-old's
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

    def make(variant, name):
        entry = variant.mk_flash_attention_packed_f32
        return lambda: _cuda.check(entry(qkv.data_ptr(), out.data_ptr(), scratch.data_ptr(), geom, b, s, heads, 0.125,
                                         _cuda.stream_ptr(qkv)), name)
    extra["timed_shape"] = "4 images"
    return _kernel_loop(card, checks, fns, time_many_ms, list(fns)[:2], 300, ATTN_F32_ABLATIONS,
                        _variant_launch("flash_attention_f32.cu", make), extra, "products_only")


def matcher_fp64_errors(tin) -> dict:
    """How close K4 and its plain version come to the exact function at the
    training shape: P from both (on the fp64 lse_col rounded to fp32) against
    P computed in fp64, relative error over the entries above 1e-6 of the
    largest (max and mean, the mean showing a bias); and K2a's and its plain
    version's lse_col, max |diff| from fp64."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    d0, d1 = tin["dsc0"], tin["dsc1"]
    s64 = torch.matmul(d0.double(), d1.double().transpose(1, 2)) * tin["inv_temp"]
    alpha = torch.tensor(tin["alpha"], dtype=torch.float64, device=d0.device)
    lc64 = torch.logaddexp(torch.logsumexp(s64, dim=1), alpha)
    p64 = torch.exp(2.0 * s64 - fm._row_lse(s64, tin["alpha"])[..., None] - lc64[:, None, :])
    del s64
    big = p64 > 1e-6 * p64.max()
    out = {}
    for name, lse_fn, pair_fn in (("kernel", fm.col_lse, fm.pair_softmax), ("plain", fm.col_lse_plain, fm.pair_softmax_plain)):
        rel = ((pair_fn(d0, d1, lc64.float(), tin["inv_temp"], tin["alpha"])[0].double() - p64) / p64)[big]
        out[name] = {"p_max": rel.abs().max().item(), "p_mean": rel.mean().item(),
                     "lse_col_max_abs": (lse_fn(d0, d1, tin["inv_temp"], tin["alpha"]).double() - lc64).abs().max().item()}
        del rel
    return out


def topk_fp64_shares(x, topl: int) -> dict:
    """How close K2b's and its plain version's values come to the exact
    function (on ``x``'s descriptors and scores, K2a's plain lse_col as
    their input): each side's (B, L, M) values against the final scores
    recomputed in fp64 at its own indices, as the largest share of the RTOL
    bound (1e-5 |ref| + 1e-6 max|ref|), as ``check_dense_table`` reads it."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    d0, d1, s0, s1 = (x[k] for k in ("dsc0", "dsc1", "scr0", "scr1"))
    lc = fm.col_lse_plain(d0, d1, 10.0, 1.0)
    s64 = torch.matmul(d0.double(), d1.double().transpose(1, 2)) * 10.0
    f64 = torch.exp(2.0 * s64 - fm._row_lse(s64, 1.0)[..., None] - lc.double()[:, None, :])
    f64 = (f64 * s0.double()[..., None] * s1.double()[:, None, :]).reshape(s64.shape[0], -1)
    del s64
    out = {}
    for name, fn in (("kernel", fm.pair_topk), ("plain", fm.pair_topk_plain)):
        v, i = fn(d0, d1, s0, s1, lc, 10.0, 1.0, topl)[:2]
        want = torch.gather(f64, 1, i.reshape(i.shape[0], -1).long()).reshape(v.shape)
        out[name] = ((v.double() - want).abs() / (RTOL * want.abs() + 1e-6 * want.abs().max())).max().item()
    return out


def _topk_entry(variant, x, topl: int, chunks: int):
    """A call of ``variant``'s ``mk_pair_topk_f32`` on ``x``'s descriptors and
    scores in ``chunks`` column chunks, on K2a's split (made here) and the
    plain lse_col, into buffers of its own: K2b without its wrapper."""
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.ops import fused_matcher as fm

    d0, d1, s0, s1 = (x[k] for k in ("dsc0", "dsc1", "scr0", "scr1"))
    B, M, C = d0.shape
    N = d1.shape[1]
    dev = d0.device
    lc = fm.col_lse_plain(d0, d1, 10.0, 1.0)
    split = fm.topk_split(d0, d1)
    fm.col_lse(d0, d1, 10.0, 1.0, split)
    outs = (torch.empty((B, topl, M), device=dev), torch.empty((B, topl, M), dtype=torch.int32, device=dev),
            torch.empty((B, M, 3), device=dev), torch.empty((B, M), device=dev))
    work = fm._topk_work(B, M, topl, chunks, dev)
    ptrs = [t.data_ptr() for t in (d0, d1, s0, s1, lc, *outs, split)] + [None if work is None else work.data_ptr()]
    geom, stream = fm.corr_geometry(B, M, N), _cuda.stream_ptr(d0)
    return lambda: _cuda.check(variant.mk_pair_topk_f32(*ptrs, geom, B, M, N, C, topl, chunks, 10.0, 1.0, 0, stream),
                               "pair_topk")


# csrc/corr_tf32.cuh (K2a, K2b in fused_topk.cu, K4 in dual_softmax.cu); MK_ABLATE_SELECT: K2b's lists
MATCHER_ABLATIONS = {"no_exp": ("MK_ABLATE_EXP",), "no_loads": ("MK_ABLATE_LOADS",),
                     "one_tf32_pass": ("MK_ABLATE_1XTF32",), "no_selection": ("MK_ABLATE_SELECT",)}


def matcher_report(inp, tin, card: str) -> int:
    """``python3 chip_smoke.py --matcher``: the matcher's forward kernels on
    the correlation engine alone. K2a, K2b and K4 against their plain
    versions (``check_matcher_kernels``, ``check_matcher_shapes``,
    ``check_topk_shapes``); CUDA-event medians per call of 20 enqueued back
    to back (``time_many_ms``) in turns: K2a and K2b and their plain versions
    at the serving shape, K4 and its plain version at the training shape;
    K2b at the training shape, and at the serving shape in one launch and in
    the wrapper's column chunks (``_topk_entry``); the dense route's forward
    (K2a + K4, ``_forward``) and the fused route's table (K2a + K2b + top-P,
    ``_topk_table``) at both shapes; the kernels' and their plain versions'
    errors from fp64 (``matcher_fp64_errors``, ``topk_fp64_shares``); the
    bounds at the 3xTF32 rate
    beside the fp32 FMA ones; and the timing ablations
    (``MATCHER_ABLATIONS``) of the three kernels (``_kernel_loop``)."""
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.ops import fused_matcher as fm

    checks = {"max_abs_err": check_matcher_kernels(inp, tin),
              "ragged_max_abs_err": max(check_matcher_shapes(inp["dsc0"].device),
                                        check_topk_shapes(inp["dsc0"].device))}
    calls = {**kernel_calls(inp), **train_kernel_calls(tin)}
    fns = {"col_lse plain": calls["col_lse"][1], "col_lse": calls["col_lse"][0],
           "pair_topk plain": calls["pair_topk"][1], "pair_topk": calls["pair_topk"][0],
           "pair_softmax plain": calls["pair_softmax"][1], "pair_softmax": calls["pair_softmax"][0]}
    s0, s1, t0, t1 = inp["dsc0"], inp["dsc1"], tin["dsc0"], tin["dsc1"]
    B, M, C = s0.shape
    N = s1.shape[1]
    Bt, Mt, _ = t0.shape
    Nt = t1.shape[1]
    dev = s0.device
    chunks = fm.col_lse_chunks(fm._sm_count(dev), B, M, N)
    topl = inp["topl"]
    k2b_chunks = fm.topk_chunks(B, M, N, dev)
    lib = _cuda.lib()
    table = lambda x: fm._topk_table(x["dsc0"], x["dsc1"], x["scr0"], x["scr1"], 10.0, 1.0, inp["prefilter"], topl)  # noqa: E731
    k2b = {f"{c} chunks": _topk_entry(lib, inp, topl, c) for c in sorted({1, k2b_chunks})}
    extra = {"p_rel_err_vs_fp64": matcher_fp64_errors(tin),
             "pair_topk_share_of_rtol_vs_fp64": topk_fp64_shares(inp, topl),
             "timed_shapes": {"col_lse": list(s0.shape), "pair_topk": list(s0.shape), "pair_softmax": list(t0.shape)},
             "col_lse_chunks": chunks, "pair_topk_chunks": k2b_chunks,
             "pair_topk_entry_serving_back_to_back_ms": {k: round(time_many_ms(f), 4) for k, f in k2b.items()},
             "pair_topk_entry_training_back_to_back_ms": round(time_many_ms(_topk_entry(lib, tin, topl, 1)), 4),
             "dense_forward_back_to_back_ms": round(time_many_ms(lambda: fm._forward(t0, t1, 10.0, 1.0)), 4),
             "fused_table_back_to_back_ms": {"serving": round(time_many_ms(lambda: table(inp)), 4),
                                             "training": round(time_many_ms(lambda: table(tin)), 4)},
             "bound_ms": {"col_lse": col_lse_bound(s0, s1), "pair_topk": pair_topk_bound(s0, s1, topl),
                          "pair_topk_training": pair_topk_bound(t0, t1, topl), "pair_softmax": pair_softmax_bound(t0, t1)},
             "ffma_bound_ms": {"col_lse": col_lse_bound(s0, s1, PEAK_FP32, 1.0),
                               "pair_topk": pair_topk_bound(s0, s1, topl, PEAK_FP32, 1.0),
                               "pair_softmax": pair_softmax_bound(t0, t1, PEAK_FP32, 1.0)}}

    lse = torch.empty((B, N), dtype=torch.float32, device=dev)
    scratch_s, scratch_t = fm._corr_scratch(B, M, N, dev, chunks), fm._corr_scratch(Bt, Mt, Nt, dev)
    geom_s, geom_t = fm.corr_geometry(B, N, M), fm.corr_geometry(Bt, Mt, Nt)
    out = torch.empty((Bt, Mt, Nt), dtype=torch.float32, device=dev)
    lse_row = torch.empty((Bt, Mt), dtype=torch.float32, device=dev)
    stream = _cuda.stream_ptr(s0)

    def launch(defines, name):
        topk = _cuda.build_variant("fused_topk.cu", defines)
        k2a = topk.mk_col_lse_f32
        calls = {f"col_lse {name}": lambda: _cuda.check(k2a(
                     s0.data_ptr(), s1.data_ptr(), lse.data_ptr(), scratch_s.data_ptr(), geom_s, B, M, N, C, chunks,
                     10.0, 1.0, stream), name),
                 f"pair_topk {name}": _topk_entry(topk, inp, topl, k2b_chunks)}
        if "MK_ABLATE_SELECT" not in defines:  # K4 has no selection
            k4 = _cuda.build_variant("dual_softmax.cu", defines).mk_pair_softmax_f32
            calls[f"pair_softmax {name}"] = lambda: _cuda.check(k4(
                t0.data_ptr(), t1.data_ptr(), tin["lse_col"].data_ptr(), out.data_ptr(), lse_row.data_ptr(),
                scratch_t.data_ptr(), geom_t, Bt, Mt, Nt, C, 10.0, 1.0, stream), name)
        return calls
    return _kernel_loop(card, checks, fns, time_many_ms, ["col_lse", "pair_topk", "pair_softmax"], 3000,
                        MATCHER_ABLATIONS, launch, extra)


def _fp64_distance(x: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far ``x`` lies from the fp64 ``ref``: max |x - ref| / max|ref|
    (the tolerances' measure), and the max and mean of (x - ref) / ref over
    the entries above 1e-3 of max|ref| (sums of both signs cancel to ~0
    elsewhere). The mean shows a bias: sums that truncate shrink |x|, a
    negative mean."""
    x, ref = x.double(), ref.double()
    top = ref.abs().max()
    big = ref.abs() > 1e-3 * top
    rel = ((x - ref) / ref)[big]
    return {"max_over_max": ((x - ref).abs().max() / top).item(), "rel_max": rel.abs().max().item(),
            "rel_mean": rel.mean().item()}


def matcher_bwd_fp64_errors(tin) -> dict:
    """How close K5's two bodies, K6 and their plain versions come to the
    exact functions at the training shape: r, c, and each gradient's dd0,
    dd1 from both, on the fp64 intermediate inputs rounded to fp32, against
    the same functions in fp64 (``_fp64_distance``)."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    d0, d1, G, it = tin["dsc0"], tin["dsc1"], tin["G"], tin["inv_temp"]
    s64 = torch.matmul(d0.double(), d1.double().transpose(1, 2)) * it
    alpha = torch.tensor(tin["alpha"], dtype=torch.float64, device=d0.device)
    lc64 = torch.logaddexp(torch.logsumexp(s64, dim=1), alpha)
    lr64 = fm._row_lse(s64, tin["alpha"])
    r64, c64 = fm._bwd_sums_from(s64, G.double(), lr64, lc64)
    ref = {"r": r64, "c": c64}
    for name, g, w_row, w_col in (("bwd_grads", G.double(), r64, c64),
                                  ("lse_bwd", None, tin["gr"].double(), tin["gc"].double())):
        dS = fm._grads_ds(s64, g, lr64, lc64, w_row, w_col)
        ref[f"{name} dd0"] = torch.matmul(dS, d1.double()) * it
        ref[f"{name} dd1"] = torch.matmul(dS.transpose(1, 2), d0.double()) * it
        del dS
    del s64
    lr, lc, r, c = (x.float() for x in (lr64, lc64, r64, c64))
    out = {}
    for name, sums, grads, lse in (("kernel", fm.dual_softmax_bwd_sums, fm.dual_softmax_bwd_grads, fm.lse_bwd),
                                   ("plain", fm.dual_softmax_bwd_sums_plain, fm.dual_softmax_bwd_grads_plain,
                                    fm.lse_bwd_plain)):
        got = dict(zip(("r", "c"), sums(d0, d1, G, lr, lc, it)))
        got.update(zip(("bwd_grads dd0", "bwd_grads dd1"), grads(d0, d1, G, lr, lc, r, c, it)))
        got.update(zip(("lse_bwd dd0", "lse_bwd dd1"), lse(d0, d1, tin["gr"], tin["gc"], lr, lc, it)))
        out[name] = {k: _fp64_distance(v, ref[k]) for k, v in got.items()}
    return out


# csrc/dual_softmax.cu's gradient kernels (corr_bwd_kernel; MK_ABLATE_PREP: no prep kernels, stale scratch)
MATCHER_BWD_ABLATIONS = {"no_exp": ("MK_ABLATE_EXP",), "no_loads": ("MK_ABLATE_LOADS",),
                         "one_tf32_pass": ("MK_ABLATE_1XTF32",), "no_prep": ("MK_ABLATE_PREP",)}


def matcher_bwd_report(tin, card: str) -> int:
    """``python3 chip_smoke.py --matcher-bwd``: the matcher's gradient
    kernels on the correlation engine alone. K5's two bodies and K6 against
    their plain versions (``check_matcher_bwd_kernels``, and
    ``check_matcher_bwd_shapes`` at C = 128 and at an odd C); CUDA-event
    medians per call of 20 enqueued back to back (``time_many_ms``) in turns
    with the plain versions at the training shape; the dense route's whole
    backward (bwd_sums then bwd_grads); the kernels' and the plain versions'
    errors from fp64 (``matcher_bwd_fp64_errors``); the bounds at the 3xTF32
    rate beside the fp32 FMA ones; the three on a split kept from the
    forward, as the autograd functions call them; and the timing ablations
    (``MATCHER_BWD_ABLATIONS``, ``_kernel_loop``)."""
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.ops import fused_matcher as fm

    dev = tin["dsc0"].device
    checks = {"max_abs_err": check_matcher_bwd_kernels(tin),
              "ragged_max_abs_err": max(check_matcher_bwd_shapes(dev), check_matcher_bwd_shapes(dev, (130, 67), 45))}
    calls = train_kernel_calls(tin)
    names = ("dual_softmax_bwd_sums", "dual_softmax_bwd_grads", "lse_bwd")
    fns = {k: v for name in names for k, v in ((f"{name} plain", calls[name][1]), (name, calls[name][0]))}
    d0, d1, G, it = tin["dsc0"], tin["dsc1"], tin["G"], tin["inv_temp"]
    B, M, C = d0.shape
    N = d1.shape[1]
    lr, lc, r, c, gr, gc = (tin[k] for k in ("lse_row", "lse_col", "r", "c", "gr", "gc"))

    def dense_backward():
        rr, cc = fm.dual_softmax_bwd_sums(d0, d1, G, lr, lc, it)
        return fm.dual_softmax_bwd_grads(d0, d1, G, lr, lc, rr, cc, it)

    bounds = {"dual_softmax_bwd_sums": bwd_sums_bound, "dual_softmax_bwd_grads": bwd_grads_bound,
              "lse_bwd": lse_bwd_bound}
    extra = {"fp64_errors": matcher_bwd_fp64_errors(tin), "timed_shape": list(d0.shape),
             "dense_backward_back_to_back_ms": round(time_many_ms(dense_backward), 4),
             "bound_ms": {k: f(d0, d1) for k, f in bounds.items()},
             "ffma_bound_ms": {k: f(d0, d1, PEAK_FP32, 1.0) for k, f in bounds.items()}}

    # the same calls on a split kept from a forward (the autograd functions' ctx.split): no split in the backward
    split = fm._corr_scratch(B, M, N, dev)
    fm.pair_softmax(d0, d1, lc, it, tin["alpha"], split)
    extra["with_forward_split_back_to_back_ms"] = {
        "dual_softmax_bwd_sums": round(time_many_ms(lambda: fm.dual_softmax_bwd_sums(d0, d1, G, lr, lc, it, split)), 4),
        "dual_softmax_bwd_grads": round(time_many_ms(
            lambda: fm.dual_softmax_bwd_grads(d0, d1, G, lr, lc, r, c, it, split)), 4),
        "lse_bwd": round(time_many_ms(lambda: fm.lse_bwd(d0, d1, gr, gc, lr, lc, it, split)), 4)}

    rr, cc = torch.empty_like(r), torch.empty_like(c)
    lib = _cuda.lib()
    cpart = torch.empty((B, lib.mk_dual_softmax_row_blocks(M), N), dtype=torch.float32, device=dev)
    xt = fm._t_scratch(B, M, N, dev)
    dd0, dd1 = torch.empty_like(d0), torch.empty_like(d1)
    geom, geom_bwd = fm.corr_geometry(B, M, N), fm.corr_bwd_geometry(B, M, N)
    stream = _cuda.stream_ptr(d0)
    p = lambda *ts: [x.data_ptr() for x in ts]  # noqa: E731

    def launch(defines, name):
        v = _cuda.build_variant("dual_softmax.cu", defines)
        return {f"dual_softmax_bwd_sums {name}": lambda: _cuda.check(v.mk_dual_softmax_bwd_sums_f32(
                    *p(d0, d1, G, lr, lc, rr, cc, cpart, split), geom, B, M, N, C, it, 1, stream), name),
                f"dual_softmax_bwd_grads {name}": lambda: _cuda.check(v.mk_dual_softmax_bwd_grads_f32(
                    *p(d0, d1, G, lr, lc, r, c, dd0, dd1, split, xt), geom_bwd, B, M, N, C, it, 1, stream), name),
                f"lse_bwd {name}": lambda: _cuda.check(v.mk_lse_bwd_f32(
                    *p(d0, d1, gr, gc, lr, lc, dd0, dd1, split, xt), geom_bwd, B, M, N, C, it, 1, stream), name)}
    return _kernel_loop(card, checks, fns, time_many_ms, list(names), 1000, MATCHER_BWD_ABLATIONS, launch, extra)


# csrc/hypothesis_scoring.cu (K3): () the kernel as the port builds it, through its C entry
SCORING_ABLATIONS = {"entry": (), "no_sfu": ("MK_ABLATE_SFU",), "fast_intrinsics": ("MK_FAST_INTRINSICS",),
                     "staging_only": ("MK_ABLATE_SCORING",)}


def check_scoring_kernel(inp, seed: int = SEED) -> dict:
    """K3 against its plain version (K3_RTOL, K3_ATOL) at the solver's shape
    (the outer draws times the pairs, stacked) and on ragged shapes: 1001
    samples (a point set of 3003 floats, staged 4 bytes at a time), 3001
    (two staged chunks of 2048), hypotheses not a multiple of a CTA's 16, a
    single sample and hypothesis; two launches bitwise equal at the solver's
    shape. Returns shape -> max |diff|."""
    from mickey_tpu_torch.ops.hypothesis_scoring import hypothesis_scores, hypothesis_scores_plain

    call = kernel_calls(inp)["hypothesis_scores"]
    out = call[0]()
    res = {"solver": _close_k3(out, call[1](), "hypothesis_scores, the solver's shape")}
    _bitwise(call[0], out, "hypothesis_scores")
    rng = np.random.default_rng(seed + 12)
    dev = inp["X"].device
    for E, S, nR in ((3, 1001, 13), (2, 3001, 17), (1, 1, 1)):
        X = rng.uniform(-2, 2, (E, S, 3)).astype(np.float32)
        Y = X + rng.normal(0, 0.2, X.shape).astype(np.float32)
        R = np.stack([_rot(a) for a in rng.uniform(-0.2, 0.2, (E * nR, 3))]).reshape(E, nR, 3, 3).astype(np.float32)
        t = rng.uniform(-0.1, 0.1, (E, nR, 1, 3)).astype(np.float32)
        args = [torch.from_numpy(a).to(dev) for a in (X, Y, R, t)]
        res[f"{E}x{S}x{nR}"] = _close_k3(hypothesis_scores(*args, 0.3), hypothesis_scores_plain(*args, 0.3),
                                         f"hypothesis_scores, {E} sets of {S} samples, {nR} hypotheses")
    return res


def scoring_report(inp, card: str) -> int:
    """``python3 chip_smoke.py --scoring``: the RANSAC scoring kernel K3
    alone. Its checks (``check_scoring_kernel``); CUDA-event medians in
    turns (``time_many_ms``, the 20 a solve per call of 5 solves back to
    back): one launch on a solve's stacked point sets, the 20 launches of
    one a draw that the solver made before, the plain version; the bound
    (``hypothesis_bound``, at the peak clock) and the SM clock under load
    beside it; the timing
    ablations (``SCORING_ABLATIONS``, through the C entry, without the
    wrapper's host work) and the error of the fast intrinsics' build."""
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.ops.hypothesis_scoring import hypothesis_scores, hypothesis_scores_plain

    checks = {"max_abs_err": check_scoring_kernel(inp)}
    kernel, plain = kernel_calls(inp)["hypothesis_scores"]
    X, Y, R, t = (inp[k] for k in ("X", "Y", "R", "t"))
    E, S, _ = X.shape
    nR = R.shape[1]
    draws = [tuple(a[d * (E // inp["draws"]):(d + 1) * (E // inp["draws"])] for a in (X, Y, R, t))
             for d in range(inp["draws"])]
    fns = {"plain": plain, "one_launch": kernel, "one_launch_a_draw": lambda: [hypothesis_scores(*d, 0.3) for d in draws]}
    sm_hz = sm_clock_hz(kernel)
    R9, t3 = R.reshape(E, nR, 9).contiguous(), t.reshape(E, nR, 3).contiguous()
    out = torch.empty((E, nR), dtype=torch.float32, device=X.device)
    stream = _cuda.stream_ptr(X)

    def launch(defines, name):
        entry = _cuda.build_variant("hypothesis_scoring.cu", defines).mk_hypothesis_scores_f32
        return {name: lambda: _cuda.check(entry(X.data_ptr(), Y.data_ptr(), R9.data_ptr(), t3.data_ptr(),
                                                out.data_ptr(), E, S, nR, 0.3, stream), name)}
    fast = launch(SCORING_ABLATIONS["fast_intrinsics"], "fast_intrinsics")["fast_intrinsics"]
    fast()
    ref = hypothesis_scores_plain(X, Y, R, t, 0.3)
    extra = {"timed_shape": {"point_sets": E, "samples": S, "hypotheses": nR, "draws_a_solve": inp["draws"]},
             "sm_clock_mhz": sm_hz / 1e6, "bound_ms": hypothesis_bound(X, R),
             "fp32_only_bound_ms": _bound(30.0 * E * nR * S, 0.0, PEAK_FP32)[0],
             "fast_intrinsics_max_abs_err": (out - ref).abs().max().item(),
             "fast_intrinsics_max_rel_err": ((out - ref).abs() / ref.abs()).max().item()}
    return _kernel_loop(card, checks, fns, time_many_ms, ["one_launch"], 3000, SCORING_ABLATIONS, launch, extra)


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


# -- 3d. the Map-free submission CLI ------------------------------------------

SUBMISSION_ABSENT = ("flash_attention", "pair_softmax")  # the serving route: packed attention, fused top-K
SUBMISSION_SCENES = 2
SUBMISSION_QUERIES = 65  # x5 subsampling: 13 pairs a scene
TIMING_SCENES = 5
TIMING_QUERIES = 300  # x5 subsampling: 60 pairs a scene, 300 in all: 25 full batches of 12


def decoders_line() -> str:
    """Which image decoders import here: ``cv2``, ``PIL``, ``torchvision.io``."""
    import importlib

    found = []
    for name in ("cv2", "PIL.Image", "torchvision.io"):
        try:
            importlib.import_module(name)
            found.append(f"{name} yes")
        except Exception as e:  # a broken install raises more than ImportError; report it and go on
            found.append(f"{name} no ({type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''})")
    return " | ".join(found)


def write_val_split(root, scenes: int = SUBMISSION_SCENES, queries: int = SUBMISSION_QUERIES, height: int = 720,
                    width: int = 540, seed: int = SEED):
    """A Map-free val split under ``root/val``: each scene a keyframe
    ``seq0/frame_00000`` and ``queries`` frames ``seq1/frame_*``, seeded
    poses and intrinsics at ``width`` x ``height``, and its frames only in a
    raw-frame cache (``rawcache_{W}x{H}.u8`` and its JSON index, written
    here with numpy in ``data/raw_cache.py``'s layout): no JPEG, so the
    split needs no decoder and its pixels are exact."""
    from mickey_tpu_torch.data.raw_cache import cache_paths

    rng = np.random.default_rng(seed + 2)
    for s in range(scenes):
        sdir = os.path.join(root, "val", f"s{s:05}")
        os.makedirs(sdir)
        names = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05}.jpg" for i in range(queries)]
        q = rng.normal(size=(len(names), 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        t = rng.normal(size=(len(names), 3))
        with open(os.path.join(sdir, "poses.txt"), "w") as f:
            f.writelines(f"{n} " + " ".join(f"{v:.6f}" for v in [*q[i], *t[i]]) + "\n" for i, n in enumerate(names))
        with open(os.path.join(sdir, "intrinsics.txt"), "w") as f:
            f.writelines(f"{n} 590.0 590.0 {width / 2 - 0.5} {height / 2 - 0.5} {width} {height}\n" for n in names)
        data_path, index_path = cache_paths(sdir, (width, height))
        frames = np.lib.format.open_memmap(str(data_path), mode="w+", dtype=np.uint8,
                                           shape=(len(names), height, width, 3))
        for i in range(len(names)):
            frames[i] = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        frames.flush()
        del frames
        index_path.write_text(json.dumps({"frames": {n: i for i, n in enumerate(names)}}))


class ServingProbe:
    """The model as ``predict`` sees it: counts the images it extracts alone
    (the keyframes) and records the image sizes it is given."""

    def __init__(self, model):
        self.model, self.cfg, self.device = model, model.cfg, model.device
        self.keyframes, self.sizes = 0, set()

    def extract_feats(self, images):
        self.keyframes += images.shape[0]
        self.sizes.add(tuple(images.shape[1:3]))
        return self.model.extract_feats(images)

    def call_with_ref_feats(self, ref_feats, image1, K0, K1, generator=None):
        self.sizes.add(tuple(image1.shape[1:3]))
        return self.model.call_with_ref_feats(ref_feats, image1, K0, K1, generator=generator)

    def __call__(self, image0, image1, K0, K1, generator=None, lite=False):
        self.sizes.update((tuple(image0.shape[1:3]), tuple(image1.shape[1:3])))
        return self.model(image0, image1, K0, K1, generator=generator, lite=lite)


def _zip_poses(path) -> dict:
    """{member: its bytes} of a submission zip."""
    from zipfile import ZipFile

    with ZipFile(path) as zf:
        return {n: zf.read(n) for n in sorted(zf.namelist())}


def run_submission(model, cfg, root, batch: int | None = None) -> dict:
    """Phase 3d: the val split under ``root`` through the submission CLI's
    entry (``cli.submission.eval_split`` with the model injected): the zip
    holds a pose file a scene whose every line parses (with confidence) in
    the loader's order; the model saw the images cropped to the patch grid;
    every serving kernel launched, no dense-route or unpacked one, K3 once a
    batch (a solve); each keyframe extracted once; a second run gives the
    same zip, byte for byte; ``--no_shared_ref`` the same names in the same
    order (its largest |t| difference is reported, not held: the keyframe
    runs the backbone alone in one path and stacked in the other); the
    evaluator scores the zip with every metric. ``batch`` overrides the
    split's batch of 12 (CPU rehearsal)."""
    import argparse
    from io import TextIOWrapper
    from zipfile import ZipFile

    from mickey_tpu_torch.cli import submission
    from mickey_tpu_torch.data import MapFreeDataset
    from mickey_tpu_torch.evaluation import METRIC_NAMES, evaluate, parse_pose_table, score_scene

    cfg = cfg.clone()
    cfg.DATASET.DATA_ROOT = str(root)
    scenes = MapFreeDataset(cfg, "val").datasets
    expected = {f"pose_{d.scene_root.name}.txt": d.paths1 for d in scenes}
    pairs = sum(len(d) for d in scenes)
    df = int(cfg.MICKEY.DINOV2.DOWN_FACTOR)
    h, w = int(cfg.DATASET.HEIGHT), int(cfg.DATASET.WIDTH)
    crop = (df * (h // df), df * (w // df))

    def run(name, shared=True):
        args = argparse.Namespace(config="", dataset_config="", checkpoint="", dinov2=None,
                                  output_root=Path(root) / name, split="val", batch_size=batch,
                                  no_shared_ref=not shared)
        probe = ServingProbe(model)
        _, launches = _counted(lambda: submission.eval_split(args, cfg=cfg.clone(), model=probe))
        return Path(root) / name / "submission.zip", probe, launches

    zip_a, probe, launches = run("a")
    solves = -(-pairs // (batch or 12))
    _launched(launches, "submission", SERVING_KERNELS, SUBMISSION_ABSENT)
    _once_per_solve(launches, "submission", solves)
    if probe.keyframes != len(scenes):
        raise SmokeError(f"submission: {probe.keyframes} keyframes extracted for {len(scenes)} scenes")
    if probe.sizes != {crop}:
        raise SmokeError(f"submission: the model saw images of {sorted(probe.sizes)}, not {crop}")
    poses = _zip_poses(zip_a)
    if sorted(poses) != sorted(expected):
        raise SmokeError(f"submission: the zip holds {sorted(poses)}, not {sorted(expected)}")
    lines = 0
    with ZipFile(zip_a) as zf:
        for member, text in poses.items():
            names = [ln.split(" ")[0] for ln in text.decode().splitlines()]
            order = iter(expected[member])
            if not all(n in order for n in names):  # a subsequence: skipped poses leave gaps
                raise SmokeError(f"submission: {member} lines out of the loader's order")
            table = parse_pose_table(TextIOWrapper(zf.open(member), encoding="utf-8"), with_confidence=True)
            if len(table) != len(names):
                raise SmokeError(f"submission: {member}: {len(table)} of {len(names)} lines parse")
            lines += len(names)
    zip_b, _, launches_b = run("b")
    if zip_b.read_bytes() != zip_a.read_bytes():
        differ = [m for m, v in _zip_poses(zip_b).items() if poses.get(m) != v]
        raise SmokeError(f"submission: a second run gave another zip ({differ} differ)")
    zip_p, _, launches_p = run("plain", shared=False)
    _launched(launches_p, "submission, no_shared_ref", SERVING_KERNELS, SUBMISSION_ABSENT)
    plain = _zip_poses(zip_p)
    dt = 0.0
    for member, text in poses.items():
        a = [ln.split(" ") for ln in text.decode().splitlines()]
        b = [ln.split(" ") for ln in plain.get(member, b"").decode().splitlines()]
        if [x[0] for x in a] != [x[0] for x in b]:
            raise SmokeError(f"submission: --no_shared_ref gave other names or order in {member}")
        if a:
            dt = max(dt, float(np.abs(np.array([x[5:8] for x in a], float) - np.array([x[5:8] for x in b], float)).max()))
    metrics, _ = evaluate(zip_a, Path(root) / "val")
    with ZipFile(zip_a) as zf:
        scored = [score_scene(Path(root) / "val", zf, d.scene_root.name) for d in scenes]
    if any(list(sc.metrics) != list(METRIC_NAMES) for sc in scored):
        raise SmokeError(f"submission: the evaluator's metrics {[list(sc.metrics) for sc in scored]} != {METRIC_NAMES}")
    return {"pairs": pairs, "poses": lines, "solves": solves, "keyframes": probe.keyframes, "crop": crop,
            "launches": [launches, launches_b, launches_p], "no_shared_ref_max_dt": dt,
            "metrics": {k: float(v) for k, v in metrics.items()}}


class _TimedLoader:
    """A loader whose consumer's waits for batches are summed in ``wait_s``."""

    def __init__(self, loader):
        self.loader, self.wait_s = loader, 0.0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                self.wait_s += time.perf_counter() - t0
            yield batch


def _busy_s(prof) -> float:
    """Seconds in which the device ran at least one kernel or copy: the
    union of the profiled device events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def submission_times(model, cfg, runs: int = 3) -> dict:
    """The submission path on the card, on its own split under a temporary
    directory (``TIMING_SCENES`` scenes of ``TIMING_QUERIES`` queries written
    as ``write_val_split`` writes them: only full batches of 12), after one
    warm-up run over it: ``predict`` end to end over all of it
    (loader, crop, copies, model, drain; host clock, it ends on the last
    poses' copy to the host), each of ``runs`` runs, pairs/s from their
    median, with the share of each spent waiting on the loader; one more
    run under ``torch.profiler`` (CPU and CUDA activity) for the device's
    busy seconds (the union of its kernels' and copies' intervals), over
    that run's own wall time (the profiler's cost included) and over the
    unprofiled median; and ``call_with_ref_feats``, ``model(..., lite=True)``
    and the general layout's stages (``_stage_times``) alone at the split's
    batch on its first batch's images (CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    from mickey_tpu_torch.cli.submission import predict
    from mickey_tpu_torch.data import DataModule
    from mickey_tpu_torch.data.io import pad_to_multiple

    root = tempfile.TemporaryDirectory(prefix="mickey_submission_timing_")
    t0 = time.perf_counter()
    write_val_split(root.name, scenes=TIMING_SCENES, queries=TIMING_QUERIES, height=int(cfg.DATASET.HEIGHT),
                    width=int(cfg.DATASET.WIDTH))
    write_s = time.perf_counter() - t0
    cfg = cfg.clone()
    cfg.DATASET.DATA_ROOT = root.name
    cfg.TRAINING.BATCH_SIZE, cfg.TRAINING.NUM_WORKERS = 12, 8  # as eval_split sets them for val
    loader = DataModule(cfg, drop_last_val=False).val_dataloader()
    pairs, batches = len(loader.dataset), len(loader)
    predict(loader, model, progress=False)  # warm-up
    walls, waits = [], []
    for _ in range(runs):
        timed = _TimedLoader(loader)
        t0 = time.perf_counter()
        predict(timed, model, progress=False)
        walls.append(time.perf_counter() - t0)
        waits.append(timed.wait_s)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict(loader, model, progress=False)
        profiled_s = time.perf_counter() - t0
    device_s = _busy_s(prof)
    batch = next(iter(loader))
    df = int(cfg.MICKEY.DINOV2.DOWN_FACTOR)
    dev = model.device
    im0, im1 = (torch.from_numpy(np.ascontiguousarray(pad_to_multiple(batch[k], df))).to(dev) for k in ("image0", "image1"))
    K0, K1 = (torch.from_numpy(batch[k]).to(dev) for k in ("K_color0", "K_color1"))
    B = im1.shape[0]
    ref = tuple(f.expand(B, *f.shape[1:]) for f in model.extract_feats(im0[:1]))
    gen = torch.Generator(device=dev)
    shared = time_ms(lambda: model.call_with_ref_feats(ref, im1, K0, K1, generator=gen.manual_seed(SEED)), iters=5)
    general = time_ms(lambda: model(im0, im1, K0, K1, generator=gen.manual_seed(SEED), lite=True), iters=5)
    stages = _stage_times(model, im0, im1, K0, K1)
    root.cleanup()  # after the calls above: the loader's threads read ahead of the batch taken
    return {"scenes": TIMING_SCENES, "pairs": pairs, "batches": batches, "split_write_s": write_s,
            "predict_s": walls, "pairs_per_s": pairs / wall,
            "loader_wait_share": [w / x for w, x in zip(waits, walls)],
            "profiled_predict_s": profiled_s, "device_busy_s": device_s, "device_busy_share": device_s / profiled_s,
            "device_busy_over_unprofiled_wall": device_s / wall,
            "batch": B, "call_with_ref_feats_ms": shared, "shared_pairs_per_s": B / shared * 1e3,
            "lite_call_ms": general, "general_pairs_per_s": B / general * 1e3,
            "general_stages_ms": stages}


def submission_line(sub: dict) -> str:
    return (f"submission: ok | pairs {sub['pairs']} poses {sub['poses']} | solves {sub['solves']} | keyframes "
            f"extracted {sub['keyframes']} | model saw {sub['crop']} | launches {sub['launches'][0]} | second run: "
            f"the same zip | --no_shared_ref: the same names, max |dt| {sub['no_shared_ref_max_dt']:.3e} | "
            f"evaluator {sub['metrics']}")


def submission_report(cfg, dev, card: str) -> int:
    """``--submission``: phase 3d and its timing alone, at full width with
    the seeded random weights."""
    from mickey_tpu_torch.models import build_model
    from mickey_tpu_torch.weights import init_params_numpy

    model = build_model(cfg, init_params_numpy(cfg, SEED), device=dev)
    with tempfile.TemporaryDirectory(prefix="mickey_submission_") as root:
        write_val_split(root)
        print(submission_line(run_submission(model, cfg, root)), flush=True)
    print(f"timing (submission): ok | {card} | {json.dumps(submission_times(model, cfg))}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
