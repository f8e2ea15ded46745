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
   fit     - the training CLI's entry (``cli.train.train_model`` on parsed
             arguments: ``MicKeyTrainer.fit``) at full width on a synthetic
             Map-free split of 540 x 720 raw-cached frames (2 train scenes
             of 16 pairs, 4 steps of 8; 2 keyframe-shared val scenes, 2
             validation batches): checkpoints, the curriculum, the LR
             scalar, the dense route's kernels; ``--resume`` bitwise and a
             bitwise step after it; cached validation against plain; the
             feature cache's fp32 rows bitwise the train step's maps, a
             cached step bitwise a staged one, bf16 rows their rounding, an
             epoch with ``--feature_cache`` with no attention launch; the
             image panels where cv2 imports; K1 and K3 against their
             plain versions at the fit's shapes first;
   demo and variants (3f) - the demo CLI's entry (``cli.demo``, parsed
             arguments, default config, random weights, ``--save_matches
             --generate_3D_vis``) on two 720 x 540 JPEGs written to a
             temporary directory: R, t and the confidence finite, the model
             saw 714 x 532 (``pad_to_multiple`` cuts to the patch grid), six
             images written, decoded and of their sizes, the dense route's
             kernels (K3 once) and neither K2b nor K1b, a second run's files
             byte for byte the first's; the int8 backbone
             (``MICKEY.DINOV2.INT8``) at B = 2 in both layouts and the full
             output: finite, the serving kernels launched, ``torch._int_mm``'s
             products bitwise the plain fp64 ones at the four block linears,
             per-token cosine to the bf16 backbone > 0.995, a small input
             against the plain CPU path; the ViT-g/14 SwiGLU backbone
             (``vit_giant2``, 1536 channels, a synthetic DINOv2-g state dict
             with ``mlp.w12`` / ``mlp.w3``) in bf16 and int8: the general
             layout and the full output finite, K1 at 24 heads of 64, the
             first 4 blocks on a small input against the plain CPU path;
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
             ``model(..., lite=True)`` alone at B = 12; and the training
             entry point on a larger split of its own (two train scenes of
             48 pairs: 12 steps an epoch; two val scenes of 48 pairs, drawn
             in one shuffled order: 12 batches): ms a step inside
             ``fit`` and its loader share, staged and from the bf16 cache,
             validation pairs/s cached and plain with the cached runs'
             keyframe hit share, the cache's build rate and bytes; the
             staged step (in turns with it on PyTorch's default backward
             kernels) against the cached-feature step, CUDA events; and
             checkpoint save and restore seconds; and phase 3f's: the int8
             and bf16 backbone stages and general calls at B = 2 and 12, the
             four block linears' int8 passes (quantize, ``torch._int_mm``,
             dequantize) against bf16 ``F.linear``, the ViT-g/14 backbone in
             bf16 and int8, and the demo's wall seconds and model call.

   ddp and ingest (3g) - the native JPEG ingest (``data/native.py``): built
             or unavailable and why, its frames/s on 48 synthetic 540 x 720
             JPEGs at 8 threads against cv2 sample by sample (alone and on 8
             threads); the training step under the data-parallel layer
             (``parallel.py``, ``data_parallel_steps``) at full width, B = 8
             of 714x532: 3 steps in a world-1 NCCL group bitwise 3 steps with
             no group, both step times; one step on two ranks (gloo on
             cuda:0, or NCCL where there are two cards) against one process
             at the small loss budget with injected draws, at DDP_RTOL and
             GRAD_TOL, the kernels each rank launched; the submission CLI's
             ``main`` on two ranks over a split like phase 3d's, its zip
             byte for byte the zip of the same ranks' rows served here in
             turn (the same draws), and the one-process zip's names in its
             order.

   bf16 modes (3h) - the matcher's bf16 kernels (K2a, K2b, K4 in the
             correlation engine's bf16 mode: ``col_lse_bf16``,
             ``pair_topk_bf16``, ``pair_softmax_bf16``) on bf16-rounded
             descriptors against their plain versions at RTOL, at the main
             paths' shapes and on ragged sizes with ties, NaN and
             infinities, bitwise launch to launch; serving at full width
             with ``TPU.MATCHER_BF16=True``, B = 2 of 714x532, both layouts
             and the full output: the bf16 kernels launched and the fp32
             engine's not, the dense / fused table cross-check against fp64
             on the rounded descriptors, a table that is not the fp32
             route's; the heads under ``TPU.HEADS_BF16``: each conv shape
             against fp64 on the rounded operands, the stage at B = 2 and 12
             against its plain version (cuDNN fp32 on the same rounding) and
             timed in turns with it and the fp32 heads; the bf16 kernels
             timed beside the fp32 engine on the same descriptors.

   tensor parallel (3i) - the Megatron-sharded backbone (``parallel.py``'s
             grid, ``shard_backbone``) on two gloo ranks sharing the card
             against one process, at full width with the seeded weights: the
             ViT-L forward on B = 2 pairs of 714x532 (4 images) in bf16 with
             packed (K1) and unpacked (K1b) attention and in fp32 (K1f), 8
             heads a rank: the fp32 map within rtol = atol = 2e-5, each bf16
             map within twice the bf16 backbone's own envelope, the ranks
             bitwise, two passes bitwise, the mode's kernel once a block and
             no other attention kernel, each rank's split leaves half of one
             process's bytes; then dp 1 x tp 2 steps (B = 8, 3 steps, the
             small loss budget and the same injected draws): with the exact
             backbone against one process at phase 3g's tolerances, with the
             default bf16 backbone against one process fed the ranks' own
             feature map, bit for bit; the forward's and the step's ms a rank.

   gates (3j) - the fused-against-dense route gate
             (``tools/fused_route_gate_torch.py``) at the production shape:
             64 planted-geometry pairs in batches of 8, 1938 keypoints, C =
             128, the default config's P = 4096, L = 16 and RANSAC budget;
             K2b (8, 1938, 128) at L = 16 against its plain version, bitwise
             launch to launch, and K3 on 160 point sets of 2048 samples x 100
             hypotheses; each route in a counted run of its own (the dense
             route K2a + K4 and K3, the fused one K2a + K2b and K3, K3 once a
             solve), the JAX tool's gates on the two routes' poses and
             confidences, each route's ms a batch; then the quality tool's
             dry run (``tools/quality_run_torch.py --dry-run``: random
             weights, a synthesized micro-dataset, ViT-S fp32 through K1f,
             the dense route without a prefilter) with its demo leg on two
             JPEGs: exit 0, the zip, the evaluator's metrics, its launches.

``python3 chip_smoke.py --submission`` runs the submission phase and its
timing alone; ``--fit`` the training entry point's; ``--demo`` phase 3f's;
``--ddp`` phase 3g's; ``--bf16`` phase 3h's, with its kernels' rows; ``--tp``
phase 3i's; ``--route-gate`` and ``--quality`` the two parts of phase 3j.
``python3 chip_smoke.py --curve`` runs the overfit proxy
(``tools/train_curve_torch.py``) alone: 150 steps of the staged step on the
geometric feature map at seeds 0-7, in fp32 and under ``TPU.HEADS_BF16``
(its convs in bf16), every step finite, each mode's seed set held to the
seed-set gate (the medians over the seeds of the eval loss ratio, the VCRE
ratio and the final rotation error against thresholds fixed from
``mickey_tpu``'s own curves at the same seeds), ``tests/test_convergence.py``'s
three gates counted per curve; it is not a phase of the whole run.
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
``python3 chip_smoke.py --svd`` does it for the solver's 3 x 3 SVD kernel
(``svd_report``): its checks, bit for bit against its plain version, its
times beside the plain version's at the solver's three shapes, and the
launches and host time left inside ``MickeyRelativePose.estimate`` at a
served batch and inside ``train.forward`` at a training step.
``python3 chip_smoke.py --matcher-bwd`` does the same for the gradient
kernels on that engine, K5 (``dual_softmax_bwd_sums``,
``dual_softmax_bwd_grads``) and K6 (``lse_bwd``) (``matcher_bwd_report``),
and adds their and their plain versions' distances from fp64.

Prints the card's name and power limit first, then which of the image
decoders ``cv2``, ``PIL`` and ``torchvision.io`` import and whether the
trainer's optional ``matplotlib`` and ``tensorboardX`` do, the script's
seconds with each phase's, a JSON line of per-kernel results before the last
line, and
``{"ok": true, "device": ...}`` last. There
is no CPU mode: without CUDA it exits 1 before printing any result. The phase
functions take the device and the sizes as arguments, so the CPU tests
rehearse them at a tiny size, where every wrapper takes its plain version.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import random
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
    ("svd3x3", "mickey_tpu_torch/csrc/svd3x3.cu", "none (XLA fuses mickey_tpu/geometry/kabsch.py:69)"),
)
# each main path's kernels, and the kernels it must not launch
SERVING_KERNELS = ("flash_attention_packed", "col_lse", "pair_topk", "hypothesis_scores", "svd3x3")
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
    H = t(svd_inputs("rank2", (draws, images // 2, hyps), seed))  # a solve's minimal sets' covariances
    return dict(qkv=qkv, heads=heads, dsc0=t(d[0]), dsc1=t(d[1]), scr0=t(scr[0]), scr1=t(scr[1]),
                topl=topl, prefilter=prefilter, draws=draws, X=t(X), Y=t(Y), R=t(R), t=t(tr), qkv32=qkv32,
                qkv_old=qkv_old, old_len=old_len, H=H)


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
    from mickey_tpu_torch.geometry import kabsch
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
        "svd3x3": (lambda: kabsch.svd3x3(inp["H"]), lambda: kabsch.svd3x3_plain(inp["H"])),
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
    res["svd3x3"] = svd_bitwise(*(f() for f in calls["svd3x3"]), "svd3x3, a solve's minimal sets")
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


def check_topk_shapes(device, sizes=MATCHER_SIZES, desc: int = 128, topl: int = 16, seed: int = SEED,
                      dtype=torch.float32) -> float:
    """K2b on ragged sizes: M = sizes[i], N = sizes[i + 1] (cyclic), 3
    images of seeded unit descriptors and uniform scores, with the dustbin
    on and off, against its plain version on the plain lse_col
    (``_topk_checked``). Image 0: column 7 a copy of column 3 (exact ties in
    every row) and scr1 +inf at column 5, where N > 7; image 1: an infinite
    descriptor value (dsc1, row 3); image 2: scr1 NaN at the last column (its
    only NaN, in most rows) and, in the first pair, a NaN row of dsc0 (row
    5). N = 1 leaves rounds past the row's end. K2b reads the split K2a
    writes (dustbin on) or splits the descriptors itself (off). ``dtype``
    bf16: the descriptors rounded to bf16 first (the bf16 mode's kernels).
    Returns the largest max |diff|."""
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
        d0, d1 = d0.to(dtype), d1.to(dtype)
        for use_dustbin in (True, False):
            alpha = fm._alpha(1.0, use_dustbin)
            lc = fm.col_lse_plain(d0, d1, 10.0, alpha)
            split = fm.topk_split(d0, d1) if use_dustbin else None
            if split is not None:
                fm.col_lse(d0, d1, 10.0, alpha, split)
            call = lambda: fm.pair_topk(d0, d1, s0, s1, lc, 10.0, alpha, topl, split)  # noqa: E731
            out = call()
            what = f"pair_topk, M {m}, N {n}, dustbin {use_dustbin}, {dtype}"
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


def check_matcher_shapes(device, sizes=MATCHER_SIZES, desc: int = 128, seed: int = SEED, dtype=torch.float32,
                         p_rtol: float = DS_RTOL) -> float:
    """K2a and K4 on ragged sizes: M = sizes[i], N = sizes[i + 1] (cyclic),
    3 images of seeded unit descriptors, with the dustbin on and off, against
    their plain versions (K4 on the plain lse_col): lse_col at RTOL, P and
    lse_row at ``p_rtol``, NaN and infinities where the plain version has them.
    In the first pair image 1 holds an infinite descriptor value (dsc1, row
    3) and image 2 a NaN row (dsc0, row 5). ``dtype`` bf16: the descriptors
    rounded to bf16 first. Returns the largest max |diff|."""
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
        d0, d1 = (torch.from_numpy(x).to(device).to(dtype) for x in (d0, d1))
        for use_dustbin in (True, False):
            alpha = fm._alpha(1.0, use_dustbin)
            what = f"M {m}, N {n}, dustbin {use_dustbin}, {dtype}"
            lc = fm.col_lse_plain(d0, d1, 10.0, alpha)
            worst = max(worst, _close_nan(fm.col_lse(d0, d1, 10.0, alpha), lc, f"col_lse, {what}"))
            (p, lr), (pp, plr) = fm.pair_softmax(d0, d1, lc, 10.0, alpha), fm.pair_softmax_plain(d0, d1, lc, 10.0, alpha)
            worst = max(worst, _close_nan(p, pp, f"pair_softmax out, {what}", p_rtol),
                        _close_nan(lr, plr, f"pair_softmax lse_row, {what}", p_rtol))
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
    matrix) that the fused table holds, by count and by score mass. Under
    ``TPU.MATCHER_BF16`` both routes run the bf16 kernels (K2a, K2b, K4 in
    bf16) and the fp64 recomputation starts from the descriptors rounded to
    bf16, as the routes do."""
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
    if cfg.TPU.get("MATCHER_BF16", False):
        d0, d1 = d0.to(torch.bfloat16), d1.to(torch.bfloat16)
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


def _T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a copy; 0-d stays 0-d


def _T_conv(a):
    return _T(np.asarray(a).transpose(3, 2, 0, 1))


def _T_lin(a):
    return _T(np.asarray(a).T)


def dinov2_state_dict(vit):
    """A DINOv2 ``.pth`` state dict made from a ``mickey_tpu`` layout ViT
    tree by inverting ``convert_dinov2_state_dict`` (HWIO -> OIHW, (in, out)
    -> (out, in), head-major qkv -> [q|k|v], stacked -> numbered): the MLP's
    ``mlp.fc1`` / ``mlp.fc2`` or, for ViT-g/14, the SwiGLU's ``mlp.w12`` /
    ``mlp.w3``."""
    dino = {"patch_embed.proj.weight": _T_conv(vit["patch_embed"]["w"]),
            "patch_embed.proj.bias": _T(vit["patch_embed"]["b"]), "cls_token": _T(vit["cls_token"]),
            "pos_embed": _T(vit["pos_embed"]), "norm.weight": _T(vit["norm"]["scale"]),
            "norm.bias": _T(vit["norm"]["bias"])}
    blocks = vit["blocks"]
    heads = {384: 6, 768: 12, 1024: 16, 1536: 24}[np.asarray(blocks["norm1"]["scale"]).shape[1]]
    mlp = ("fc1", "fc2") if "fc1" in blocks["mlp"] else ("w12", "w3")
    for i in range(np.asarray(blocks["norm1"]["scale"]).shape[0]):
        pre = f"blocks.{i}."
        get = lambda *path: np.asarray(functools.reduce(lambda d, k: d[k], path, blocks))[i]  # noqa: E731
        w, b = get("attn", "qkv", "w"), get("attn", "qkv", "b")
        cin, c3 = w.shape
        w = w.reshape(cin, heads, 3, c3 // (3 * heads)).transpose(0, 2, 1, 3).reshape(cin, c3)
        b = b.reshape(heads, 3, c3 // (3 * heads)).transpose(1, 0, 2).reshape(c3)
        dino.update({pre + "attn.qkv.weight": _T_lin(w), pre + "attn.qkv.bias": _T(b)})
        for name, path in (("attn.proj", ("attn", "proj")), *((f"mlp.{m}", ("mlp", m)) for m in mlp)):
            dino.update({f"{pre}{name}.weight": _T_lin(get(*path, "w")), f"{pre}{name}.bias": _T(get(*path, "b"))})
        for n in ("norm1", "norm2"):
            dino.update({f"{pre}{n}.weight": _T(get(n, "scale")), f"{pre}{n}.bias": _T(get(n, "bias"))})
        for n in ("ls1", "ls2"):
            dino[f"{pre}{n}.gamma"] = _T(get(n, "gamma"))
    return dino


def upstream_state_dicts(params):
    """The upstream release's two state dicts, made from a ``mickey_tpu``
    layout params tree by inverting the converters: the Lightning
    checkpoint's ``state_dict`` (heads and matcher, with the
    ``compute_matches.`` prefix) and the DINOv2 ``.pth``
    (``dinov2_state_dict``)."""
    from mickey_tpu_torch.training.checkpoint import HEAD_OUT_KEY

    dino = dinov2_state_dict(params["dinov2"])
    sd = {}
    for head, out_key in HEAD_OUT_KEY.items():
        pre, hp = f"compute_matches.extractor.{head}.", params[head]
        for r in range(1, 5):
            blk, bp = f"{pre}resblock{r}.", hp[f"resblock{r}"]
            for c in ("conv1", "conv2"):
                sd[f"{blk}{c}.weight"] = _T_conv(bp[c]["w"])
            if "shortcut" in bp:
                sd[f"{blk}shortcut.0.weight"] = _T_conv(bp["shortcut"]["w"])
            for bn in ("bn1", "bn2"):
                if bn in bp:
                    for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                                         ("var", "running_var")):
                        sd[f"{blk}{bn}.{theirs}"] = _T(bp[bn][ours])
        layers = hp["att"]["layers"]
        for i in range(np.asarray(layers["q_proj"]["w"]).shape[0]):
            lp = f"{pre}att_layer.layers.{i}."
            for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"), ("merge", "merge"),
                                 ("mlp_fc1", "mlp.0"), ("mlp_fc2", "mlp.2")):
                sd[f"{lp}{theirs}.weight"] = _T_lin(np.asarray(layers[ours]["w"])[i])
            for n in ("norm1", "norm2"):
                sd[f"{lp}{n}.weight"] = _T(np.asarray(layers[n]["scale"])[i])
                sd[f"{lp}{n}.bias"] = _T(np.asarray(layers[n]["bias"])[i])
        if out_key:
            sd[f"{pre}{out_key}.weight"] = _T_conv(hp["out"]["w"])
    if "dustbin_score" in params["matcher"]:
        sd["compute_matches.matcher.matching_mat.dustbin_score"] = _T(params["matcher"]["dustbin_score"])
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


def _desc_bytes(dsc0, dsc1) -> int:
    """Bytes of both descriptor sets read once, in their own dtype (fp32, or
    bf16 under ``TPU.MATCHER_BF16``)."""
    return (dsc0.numel() + dsc1.numel()) * dsc0.element_size()


def col_lse_bound(dsc0, dsc1, peak: float = PEAK_TF32, passes: float = 3.0):
    """K2a's bound: the correlation's 2 B M N C flops at fp32 accuracy, three
    TF32 passes at 495 TFLOP/s (``peak=PEAK_FP32, passes=1``: the fp32 FMA
    bound of the body it replaced; ``peak=PEAK_BF16, passes=1`` on bf16
    descriptors, whose products are exact in one bf16 pass), against both
    descriptor sets read and lse_col written once."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    return _bound(passes * 2.0 * B * M * N * C, _desc_bytes(dsc0, dsc1) + B * N * 4, peak)


def pair_softmax_bound(dsc0, dsc1, peak: float = PEAK_TF32, passes: float = 3.0):
    """K4's bound: one correlation (a second sweep is the kernel's choice, not
    work the function needs) as for K2a, against the descriptors and lse_col
    read and P (B, M, N) and lse_row written once."""
    B, M, C = dsc0.shape
    N = dsc1.shape[1]
    return _bound(passes * 2.0 * B * M * N * C, _desc_bytes(dsc0, dsc1) + (B * N + B * M * N + B * M) * 4, peak)


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
                  _desc_bytes(dsc0, dsc1) + (B * M + 2 * B * N + 2 * B * topl * M + 4 * B * M) * 4, peak)


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
        "svd3x3": svd_bound(inp["H"].numel() // 9),
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

    t_start = time.perf_counter()
    phase_s, lap = {}, [t_start]

    def _lap() -> float:  # seconds since the previous lap
        now = time.perf_counter()
        lap.append(now)
        return round(now - lap[-2], 1)

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"decoders: {decoders_line()}", flush=True)
    print(f"optional: {optional_line()}", flush=True)

    # 1. build
    lib, log = _cuda.build()
    ptx = [ln.strip() for ln in log.splitlines() if any(w in ln for w in ("registers", "Compiling entry", "spill", "arning"))]
    print("build: ok | " + " | ".join(ptx), flush=True)
    phase_s["1 build"] = _lap()

    # 2. kernels vs plain, at the main paths' shapes: serving (ViT-L 714x532,
    #    B = 2) and training (B = 8 pairs, 1938 keypoints, C = 128)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config()
    if "--submission" in sys.argv[1:]:
        return submission_report(cfg, dev, card)
    if "--fit" in sys.argv[1:]:
        return fit_report(cfg, dev, card)
    if "--demo" in sys.argv[1:]:
        return demo_report(cfg, dev, card)
    if "--ddp" in sys.argv[1:]:
        return ddp_report(cfg, dev, card)
    if "--tp" in sys.argv[1:]:
        return tp_report(cfg, dev, card)
    if "--curve" in sys.argv[1:]:
        return curve_report(dev, card)
    if "--route-gate" in sys.argv[1:]:
        return gates_report(cfg, dev, card, "route")
    if "--quality" in sys.argv[1:]:
        return gates_report(cfg, dev, card, "quality")
    if "--svd" in sys.argv[1:]:
        return svd_report(cfg, dev, card)
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
    if "--bf16" in sys.argv[1:]:
        return bf16_report(cfg, dev, card, inp, train_kernel_inputs(dev, pairs=8, kpts=1938, desc=128))
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
    phase_s["2 kernels"] = _lap()

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
    phase_s["3a slice"] = _lap()

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
    print(f"exact: ok | launches {exact_launches} | full output conf {full_x.inliers.tolist()} "
          f"valid {full_x.valid.tolist()} inliers {full_x.estimate.inlier_mask.sum(-1).tolist()} | dense lite conf "
          f"{outs_xd['general'].inliers.tolist()} shared {outs_xd['shared'].inliers.tolist()} | fp32 unpacked vs packed "
          f"{agree_xu} launches {exact_unpacked_launches} | bf16 vs fp32 {agree_bf16} | dense vs fused table {table} | "
          f"checkpoint {ckpt} | small-input vs plain {small_x}", flush=True)
    phase_s["3b exact"] = _lap()

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
    phase_s["3c train"] = _lap()

    # 3d. the submission CLI at full width on a synthetic val split (two
    #     scenes of 540 x 720 raw-cached frames, 26 pairs, batches of 12)
    sub_dir = tempfile.TemporaryDirectory(prefix="mickey_submission_")
    write_val_split(sub_dir.name)
    sub = run_submission(model, cfg, sub_dir.name)
    print(submission_line(sub), flush=True)
    phase_s["3d submission"] = _lap()

    # 3e. the training entry point at full width on a synthetic Map-free
    #     split of 540 x 720 raw-cached frames: fit, resume, validation, the
    #     feature cache (its kernels checked first, outside the counted run)
    fit_errs = check_fit_kernels(fit_kernel_inputs(dev, cfg))
    fit_dir = tempfile.TemporaryDirectory(prefix="mickey_fit_")
    (fit, fit_ctx), fit_launches = _counted(lambda: run_fit(cfg, fit_dir.name, dev, params=params))
    print(fit_line(fit, fit_errs), flush=True)
    fit_timing = fit_times(fit_ctx)  # printed after phase 4; its trainers freed before phase 4 reads peak memory
    del fit_ctx
    gc.collect()
    fit_dir.cleanup()
    phase_s["3e fit"] = _lap()

    # 3f. the demo CLI at full width on two 720 x 540 JPEGs, the int8
    #     backbone, the ViT-g/14 SwiGLU backbone (bf16 and int8); their
    #     timing taken now and printed after phase 4, their weights freed
    variants_timing, variant_launches = run_demo_and_variants(cfg, model, cpu_model, dev, card, image0, image1,
                                                              K0, K1, small_ims)
    del cpu_model
    gc.collect()
    phase_s["3f demo and variants"] = _lap()

    # 3g. the native ingest; the train step under the data-parallel layer (a
    #     world-1 NCCL group bitwise no group, two ranks against one
    #     process); predict on two ranks over phase 3d's split
    ddp_dir = tempfile.TemporaryDirectory(prefix="mickey_ddp_")
    ingest = ingest_rates(ddp_dir.name)
    ddp_train, ddp_launches = run_ddp_train(cfg, dev, params=params)
    write_val_split(ddp_dir.name)
    ddp_sub = run_ddp_submission(model, cfg, ddp_dir.name)
    print(ddp_line(ingest, ddp_train, ddp_sub, card), flush=True)
    ddp_dir.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["3g ddp"] = _lap()

    # 3h. the bf16 modes: the bf16 kernels against their plain versions, the
    #     MATCHER_BF16 paths at full width (both layouts, the full output),
    #     the HEADS_BF16 heads at B = 2 and 12; their timing taken now
    bf16 = run_bf16_phase(model, inp, tin, dev)
    print(bf16_lines(bf16, card), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["3h bf16"] = _lap()

    # 3i. the tensor-parallel backbone: the ViT-L forward on two ranks (bf16
    #     packed and unpacked, fp32) and dp 1 x tp 2 steps (exact and bf16
    #     backbone), each against one process
    tp_res, tp_launches, tp_rank_launches = run_tp_phase(cfg, dev, params=params)
    del params
    print(tp_line(tp_res, card), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["3i tp"] = _lap()

    # 3j. the JAX repo's gates: the fused-against-dense route gate at the
    #     production shape (64 planted pairs, B = 8), K2b and K3 at its
    #     shape first; the quality tool's dry run
    gate_lines, gate_errs, gate_launches = run_gates_phase(cfg, dev, card)
    for line in gate_lines:
        print(line, flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["3j gates"] = _lap()
    print(f"phase 3j: {phase_s['3j gates']} s", flush=True)

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
    print(fit_timing_line(fit, fit_timing, fit_window_times(cfg, dev), card), flush=True)
    print(variants_timing, flush=True)

    runs = (serve_launches, unpacked_launches, exact_launches, exact_unpacked_launches, *train_launches.values(),
            ablation_launches, *sub["launches"], fit_launches, *variant_launches, ddp_launches, ddp_sub["launches"],
            bf16["paths"]["launches"], tp_launches, *tp_rank_launches, *gate_launches)
    for n, e in (*fit_errs.items(), *gate_errs.items()):  # the kernels checked again at the fit's and gate's shapes
        errs[n] = max(errs[n], e)
    phase_s["4 timing"] = _lap()
    print(f"total: {time.perf_counter() - t_start:.1f} s | phases s {json.dumps(phase_s)}", flush=True)
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(r[n] for r in runs), "max_abs_err": errs[n], "ms": kt[n][0],
         "plain_ms": kt[n][1], "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": lib_ms.get(n)}
        for n, src, rep in KERNELS
    ] + bf16_kernel_rows(bf16, {n: sum(r[n] for r in runs) for n, _, _ in BF16_KERNELS})}))
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


# csrc/svd3x3.cu: the solver's 3 x 3 SVD. Shapes: the minimal sets of a served
# batch (it_matches, B, it_RANSAC), the B = 8 pairs of a refinement, the
# training loss's re-solve (B, it, it)
SVD_SHAPES = ((20, 8, 100), (8,), (8, 20, 20))
SVD_CASES = ("random", "zero", "rank1", "rank2", "reflection", "repeated", "diagonal", "tiny", "huge", "nonfinite")
# the cases whose squared column norms stay inside fp32's range: there the
# Jacobi SVD is an SVD (at 1e-20 the squares underflow and every rotation is
# skipped, at 1e20 they overflow)
SVD_FINITE_CASES = SVD_CASES[:7]
# the runtime calls that launch a kernel (PERF.md section 7's counting rules)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _rotations(rng, n: int, reflect: bool = False) -> np.ndarray:
    """n random rotations (det +1), or reflections (det -1)."""
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[:, :, 2] *= (np.sign(np.linalg.det(q)) * (-1.0 if reflect else 1.0))[:, None]
    return q


def svd_inputs(case: str, shape: tuple, seed: int = SEED) -> np.ndarray:
    """fp32 (*shape, 3, 3) matrices of one of SVD_CASES: "random" U diag(s)
    V^T with s in [0.5, 2]; "rank1" outer products; "rank2" the covariance of
    three points and their noisy rotated copies (a minimal set's); "reflection"
    det < 0; "repeated" singular values (2, 2, 1), (2, 1, 1), (1, 1, 1) in
    turn; "diagonal" (every rotation takes the skip path); "tiny" and "huge"
    Gaussian entries at 1e-20 and 1e20; "nonfinite" Gaussian with a NaN, an
    inf or a -inf in three of every four."""
    rng = np.random.default_rng([seed, SVD_CASES.index(case)])
    n = int(np.prod(shape))
    s = np.sort(rng.uniform(0.5, 2.0, (n, 3)), -1)[:, ::-1]
    if case in ("random", "reflection", "repeated"):
        if case == "repeated":
            s = np.array([[2, 2, 1], [2, 1, 1], [1, 1, 1]], np.float64)[np.arange(n) % 3]
        H = _rotations(rng, n, case == "reflection") @ (s[:, :, None] * _rotations(rng, n).transpose(0, 2, 1))
    elif case == "zero":
        H = np.zeros((n, 3, 3))
    elif case == "rank1":
        H = rng.standard_normal((n, 3, 1)) @ rng.standard_normal((n, 1, 3))
    elif case == "rank2":
        P = rng.standard_normal((n, 3, 3))
        Q = P @ _rotations(rng, n) + 0.01 * rng.standard_normal((n, 3, 3))
        H = (P - P.mean(1, keepdims=True)).transpose(0, 2, 1) @ (Q - Q.mean(1, keepdims=True))
    elif case == "diagonal":
        H = np.eye(3) * rng.standard_normal((n, 1, 3))
    elif case in ("tiny", "huge"):
        H = (1e-20 if case == "tiny" else 1e20) * rng.standard_normal((n, 3, 3))
    else:
        H = rng.standard_normal((n, 3, 3))
        k = np.arange(n)
        H[k % 4 == 0, 1, 2], H[k % 4 == 1, 0, 0], H[k % 4 == 2, 2, 1] = np.nan, np.inf, -np.inf
    return H.astype(np.float32).reshape(*shape, 3, 3)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN where NaN (of any payload)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def svd_bitwise(out, ref, what: str) -> float:
    """The kernel's (U, S, V) against the plain version's: bit for bit (NaN
    where NaN). The kernel repeats each of the plain version's operations in
    its order and rounding, PyTorch's sum over three values and
    ``linalg.cross``'s fused product included (the kernel's source note).
    Returns the max |diff| (0.0)."""
    for name, a, b in zip("USV", out, ref):
        if a.shape != b.shape or a.dtype != b.dtype or not _same_bits(a, b):
            raise SmokeError(f"{what}: {name} differs from the plain version")
    return 0.0


def check_svd_kernel(device, shapes=SVD_SHAPES, seed: int = SEED) -> dict:
    """The SVD kernel against its plain version on every case of SVD_CASES
    at each shape (``svd_bitwise``), then ``svd_solve_bitwise`` at each
    shape. Returns "shape case" -> max |diff|."""
    from mickey_tpu_torch.geometry import kabsch

    res = {}
    for shape in shapes:
        for case in SVD_CASES:
            H = torch.from_numpy(svd_inputs(case, shape, seed)).to(device)
            res[f"{shape} {case}"] = svd_bitwise(kabsch.svd3x3(H), kabsch.svd3x3_plain(H), f"svd3x3 {case} {shape}")
        svd_solve_bitwise(device, shape, seed)
    return res


def svd_solve_bitwise(device, shape: tuple, seed: int = SEED) -> None:
    """Through the kernel and through the plain version, bit for bit (the
    rest is the same eager code): ``weighted_procrustes``'s R, t and valid
    on (*shape) point sets, of 3 points unweighted (a minimal set) where
    ``shape`` has more than one axis, else of 2048 points under 0 / 1
    weights (a refinement); and the gradient of ``svd3x3`` on "random"
    matrices through ``svd3x3_vjp``."""
    from mickey_tpu_torch.geometry import kabsch

    rng = np.random.default_rng([seed, 13, len(shape)])
    points = 3 if len(shape) > 1 else 2048
    X = rng.uniform(-2, 2, (*shape, points, 3))
    Y = X @ _rotations(rng, 1)[0].T + 0.05 * rng.standard_normal(X.shape)
    w = (rng.uniform(0, 1, (*shape, points)) < 0.7).astype(np.float32)
    X, Y, w = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (X, Y, w))
    H = torch.from_numpy(svd_inputs("random", shape, seed)).to(device)
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
           for s in (H.shape, H.shape[:-1], H.shape)]

    def solve_and_grad():
        if points == 3:
            sol = kabsch.weighted_procrustes(X, Y, use_weights=False)
        else:
            sol = kabsch.weighted_procrustes(X, Y, w=w, use_weights=True, use_mask=True)
        Hg = H.clone().requires_grad_(True)
        grad, = torch.autograd.grad(sum((o * c).sum() for o, c in zip(kabsch.svd3x3(Hg), cot)), Hg)
        return sol, grad

    sol, grad = solve_and_grad()
    primal, kabsch._svd3x3_primal = kabsch._svd3x3_primal, kabsch.svd3x3_plain
    try:
        sol_p, grad_p = solve_and_grad()
    finally:
        kabsch._svd3x3_primal = primal
    for name, a, b in (("R", sol.R, sol_p.R), ("t", sol.t, sol_p.t), ("gradient", grad, grad_p)):
        if not _same_bits(a, b):
            raise SmokeError(f"svd3x3 {shape}: {name} through the kernel differs from the plain version's")
    if not torch.equal(sol.valid, sol_p.valid):
        raise SmokeError(f"svd3x3 {shape}: weighted_procrustes's valid differs from the plain version's")


def svd_bound(n: int) -> tuple:
    """The SVD kernel's bound on n matrices: ~1.3 kFLOP a matrix (18
    rotations of ~70 fp32 operations, the sort and U's completion) at 67
    TFLOP/s against 36 bytes read and 84 written a matrix."""
    return _bound(1300.0 * n, 120.0 * n, PEAK_FP32)


def solver_inputs(device, pairs: int, kpts: int, table: int, seed: int = SEED):
    """The fused route's solver input at a served batch, made up: keypoints
    on a 714 x 532 frame with depths in [1, 5] m, a descending top-``table``
    table of positive scores over random flat match indices. Returns
    (TopKCorrespondences, K0, K1)."""
    from mickey_tpu_torch.nn.extractor import TopKCorrespondences

    rng = np.random.default_rng(seed + 14)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    kp = lambda: t(rng.uniform(0, 1, (pairs, kpts, 2)).astype(np.float32) * np.float32([532, 714]))  # noqa: E731
    dep = lambda: t(rng.uniform(1, 5, (pairs, kpts, 1)).astype(np.float32))  # noqa: E731
    scores = np.sort(rng.uniform(1e-4, 1e-2, (pairs, table)).astype(np.float32), -1)[:, ::-1]
    idx = np.stack([rng.choice(kpts * kpts, table, replace=False) for _ in range(pairs)]).astype(np.int32)
    corr = TopKCorrespondences(kp(), dep(), kp(), dep(), t(scores), t(idx), t(np.ones(pairs, bool)))
    K = t(np.tile(np.array([[[590.0, 0, 266], [0, 590.0, 357], [0, 0, 1]]], np.float32), (pairs, 1, 1)))
    return corr, K, K.clone()


def span_launches(fn, spans, iters: int = 3) -> tuple:
    """Launches and host time a call of ``fn()`` inside each of the port's
    ``spans``, by PERF.md section 7's rules: ``fn`` runs ``iters`` times with
    ``tracing`` on under ``torch.profiler``; a runtime call of LAUNCH_CALLS
    counts in a span when it starts inside one of the span's ``span:<name>``
    ranges. Returns ({span: launches a call}, {span: median host ms from the
    records}, {kernel: ``LAUNCHES`` a call})."""
    import bisect

    from torch.profiler import ProfilerActivity, profile

    from mickey_tpu_torch import tracing
    from mickey_tpu_torch.ops import _cuda

    fn()
    torch.cuda.synchronize()
    tracing.enable()
    try:
        tracing.take()
        _cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        records = tracing.take()
    finally:
        tracing.disable()
    kernels = {k: v / iters for k, v in _cuda.LAUNCHES.items() if v}
    # host events only: each ``span:`` range is also recorded on the device's
    # timeline, and a launch inside both would count twice
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    starts = sorted(e.time_range.start for e in events if e.name in LAUNCH_CALLS)
    counts = {}
    for name in spans:
        ranges = [(e.time_range.start, e.time_range.end) for e in events if e.name == "span:" + name]
        counts[name] = sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a) for a, b in ranges) / iters
    host = {name: round(statistics.median((r.end_ns - r.start_ns) / 1e6 for r in records if r.name == name), 3)
            for name in spans if any(r.name == name for r in records)}
    return counts, host, kernels


SOLVER_SPANS = ("model.estimate", "solver.draws", "solver.hypotheses", "solver.refine")


def svd_report(cfg, dev, card: str) -> int:
    """``python3 chip_smoke.py --svd``: the solver's SVD kernel alone. Its
    checks (``check_svd_kernel``); CUDA-event medians in turns, of 10 calls
    enqueued back to back (``time_many_ms``), of the kernel, its C entry
    without the wrapper's host work, and the plain version at each of
    SVD_SHAPES beside the bound (``svd_bound``); then the launches and host
    ms inside ``MickeyRelativePose.estimate`` and its stages at a served
    batch of 8 (``solver_inputs``: 1938 keypoints a frame, the top-P table)
    and inside ``train.forward`` at a training step of 8 pairs of 714 x 532,
    by PERF.md section 7's rules (``span_launches``), with the SVD kernel's
    launches a call (``NUM_REFINEMENTS + 1`` either way)."""
    from mickey_tpu_torch.geometry import kabsch
    from mickey_tpu_torch.models import MicKeyTrainer, MickeyRelativePose
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.weights import init_params_numpy

    t_start = time.perf_counter()
    checks = check_svd_kernel(dev)
    times = {}
    for shape in SVD_SHAPES:
        H = torch.from_numpy(svd_inputs("rank2", shape)).to(dev)
        n = H.numel() // 9
        U, S, V = (torch.empty_like(x) for x in kabsch.svd3x3_plain(H))
        entry = lambda: _cuda.check(_cuda.lib().mk_svd3x3_f32(  # noqa: E731
            H.data_ptr(), U.data_ptr(), S.data_ptr(), V.data_ptr(), n, _cuda.stream_ptr(H)), "svd3x3")
        fns = {"kernel": lambda: kabsch.svd3x3(H), "entry": entry, "plain": lambda: kabsch.svd3x3_plain(H)}
        t = {k: [] for k in fns}
        for name in list(fns) + list(fns)[::-1]:
            t[name].append(time_many_ms(fns[name], reps=10))
        times[str(shape)] = {"matrices": n, **{k: round(statistics.mean(v), 4) for k, v in t.items()},
                             "bound_ms": svd_bound(n)[0], "bound_by": svd_bound(n)[1]}
    model = MickeyRelativePose(cfg, {}, device=dev)
    corr, K0, K1 = solver_inputs(dev, pairs=8, kpts=1938, table=int(cfg.TPU.SAMPLING_PREFILTER))
    gen = torch.Generator(device=dev)
    serve = span_launches(lambda: model.estimate(corr, K0, K1, gen.manual_seed(SEED)), SOLVER_SPANS)
    trainer = MicKeyTrainer(cfg, params=init_params_numpy(cfg, SEED), seed=SEED, device=dev)
    batch = train_batch(dev, pairs=cfg.TRAINING.BATCH_SIZE, height=714, width=532)
    train = span_launches(lambda: trainer.training_step(batch), ("train.forward",))
    expected = int(cfg.PROCRUSTES.NUM_REFINEMENTS) + 1
    for what, (_, _, kernels) in (("model.estimate", serve), ("training step", train)):
        if kernels.get("svd3x3") != expected:
            raise SmokeError(f"{what}: svd3x3 launched {kernels.get('svd3x3')} times a call, not {expected}")
    print(json.dumps({"card": card, "bitwise_cases": len(checks), "max_abs_err": max(checks.values()),
                      "back_to_back_ms_in_turns": times,
                      "estimate_b8": {"launches": serve[0], "host_ms": serve[1], "kernels": serve[2]},
                      "train_b8": {"launches": train[0], "host_ms": train[1], "kernels": train[2]},
                      "seconds": round(time.perf_counter() - t_start, 1)}))
    return 0


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
    return _imports(("cv2", "PIL.Image", "torchvision.io"))


def _imports(names) -> str:
    import importlib

    found = []
    for name in names:
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
    rng = np.random.default_rng(seed + 2)
    for s in range(scenes):
        _write_scene(os.path.join(root, "val", f"s{s:05}"), queries, height, width, rng)


def write_train_split(root, scenes: int, queries: int, height: int = 720, width: int = 540, seed: int = SEED):
    """A Map-free train split under ``root/train``, written as
    ``write_val_split`` writes its scenes, each with an ``overlaps.npz`` of
    its ``queries - 1`` consecutive query pairs at overlap 0.5 (inside the
    default 0.2-0.7 window)."""
    rng = np.random.default_rng(seed + 4)
    for s in range(scenes):
        sdir = os.path.join(root, "train", f"t{s:05}")
        _write_scene(sdir, queries, height, width, rng)
        idxs = np.array([[1, i, 1, i + 1] for i in range(queries - 1)], dtype=np.uint16)
        np.savez(os.path.join(sdir, "overlaps.npz"), idxs=idxs, overlaps=np.full(len(idxs), 0.5))


def _write_scene(sdir, queries: int, height: int, width: int, rng) -> None:
    """One scene: keyframe and queries, seeded poses and intrinsics, frames
    of seeded random bytes in a raw-frame cache only."""
    from mickey_tpu_torch.data.raw_cache import cache_paths

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
    frames = np.lib.format.open_memmap(str(data_path), mode="w+", dtype=np.uint8, shape=(len(names), height, width, 3))
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
    """A loader whose consumer's waits for batches are summed in ``wait_s``
    and kept one a batch in ``waits``. The trainer's feature cache reaches
    the loader inside."""

    def __init__(self, loader):
        self.loader, self.wait_s, self.waits = loader, 0.0, []
        self.dataset = loader.dataset

    @property
    def feature_cache(self):
        return self.loader.feature_cache

    @feature_cache.setter
    def feature_cache(self, cache):
        self.loader.feature_cache = cache

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
            self.waits.append(time.perf_counter() - t0)
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
    from mickey_tpu_torch.data.io import crop_to_patches

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
    dev = model.device
    im0, im1 = (torch.from_numpy(np.ascontiguousarray(crop_to_patches(batch[k], cfg))).to(dev) for k in ("image0", "image1"))
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

# -- 3e. the training entry point: fit, resume, validation, the feature cache -----

FIT_KERNELS = ("flash_attention_packed", "col_lse", "pair_softmax", "dual_softmax_bwd_sums",
               "dual_softmax_bwd_grads", "hypothesis_scores")
FIT_ABSENT = ("flash_attention", "pair_topk", "lse_bwd")  # the dense route on packed attention
ATTENTION_KERNELS = ("flash_attention_packed", "flash_attention", "flash_attention_packed_f32", "flash_attention_f32",
                     "flash_attention_packed_upcast")
FIT_SCENES = 2
FIT_TRAIN_QUERIES = 17  # 16 consecutive pairs a scene
FIT_SAMPLES_A_SCENE = 16  # N_SAMPLES_SCENE: 32 pairs, 4 batches of 8
FIT_VAL_QUERIES = 40  # x5 subsampling: 8 pairs a scene
VAL_BATCHES = 2
# the timing's own split (fit_window_times): FIT_SCENES scenes of each kind; half the scale it
# first had (24 steps and 24 val batches), to keep the whole script near 900 s
FIT_TIMING_TRAIN_QUERIES = 49  # 48 consecutive pairs a scene
FIT_TIMING_SAMPLES = 48  # N_SAMPLES_SCENE: 96 pairs, 12 steps of 8
FIT_TIMING_VAL_QUERIES = 240  # x5 subsampling: 48 pairs a scene, each drawn once
VAL_TOL = 1e-5  # cached against plain validation: tests/test_training.py's lock (rtol, atol)


def optional_line() -> str:
    """Whether the trainer's optional packages import here: ``matplotlib``
    (the image panels) and ``tensorboardX`` (the logs)."""
    return _imports(("matplotlib", "tensorboardX"))


def fit_config(cfg, root, batch: int, samples: int, val_batches: int):
    """``cfg`` on the synthetic split under ``root``: batches of ``batch``
    pairs, ``samples`` pairs drawn a scene an epoch, a log line every step,
    ``val_batches`` validation batches, one epoch."""
    cfg = cfg.clone()
    cfg.DATASET.DATA_ROOT = str(root)
    cfg.TRAINING.BATCH_SIZE = batch
    cfg.TRAINING.N_SAMPLES_SCENE = samples
    cfg.TRAINING.LOG_INTERVAL = 1
    cfg.TRAINING.VAL_BATCHES = val_batches
    cfg.TRAINING.EPOCHS = 1
    return cfg


class _TimedData:
    """A datamodule whose train loader is a ``_TimedLoader`` (kept in ``train``)."""

    def __init__(self, dm):
        self.dm, self.train = dm, None

    def train_dataloader(self):
        self.train = _TimedLoader(self.dm.train_dataloader())
        return self.train

    def val_dataloader(self):
        return self.dm.val_dataloader()


class _StepProbe:
    """Wraps a trainer's ``training_step``: each step's end on the host
    clock, its kernel launches and its batch's keys."""

    def __init__(self, trainer):
        from mickey_tpu_torch.ops import _cuda

        self.ends, self.launches, self.keys = [], [], []
        step = trainer.training_step

        def probed(batch):
            before = dict(_cuda.LAUNCHES)
            out = step(batch)
            self.ends.append(time.perf_counter())
            self.launches.append({k: v - before[k] for k, v in _cuda.LAUNCHES.items()})
            self.keys.append(sorted(batch))
            return out

        trainer.training_step = probed

    def summed(self) -> dict:
        return {k: sum(d[k] for d in self.launches) for k in self.launches[0]}

    def timing(self, loader: _TimedLoader) -> dict:
        """ms a step after the first (host clock, logging included) and the
        share of that time spent waiting on the loader."""
        span = self.ends[-1] - self.ends[0]
        return {"steps": len(self.ends), "step_ms": span / (len(self.ends) - 1) * 1e3,
                "loader_wait_share": sum(loader.waits[1:len(self.ends)]) / span}


class _CliRun:
    """One run of the training CLI's entry, ``cli.train.train_model`` on
    parsed ``argv`` and a clone of ``cfg``, on ``dev``, with the trainer it
    builds probed: its steps (``trainer`` and ``probe``, a ``_StepProbe``),
    its logged scalars (``logged``), the scenes it validates
    (``val_scenes``) and its train loader timed (``data``, a ``_TimedData``);
    ``seconds`` on the host clock."""

    def __init__(self, argv, cfg, dev):
        from mickey_tpu_torch.cli import train as cli
        from mickey_tpu_torch.data import loader
        from mickey_tpu_torch.models.training_model import MicKeyTrainer

        self.logged, self.val_scenes = {}, set()
        fit, make_data = MicKeyTrainer.fit, loader.DataModuleTraining

        def probed_fit(trainer, datamodule, *args, **kwargs):
            self.trainer, self.probe = trainer, _StepProbe(trainer)
            log_scalar, validation_step = trainer.log_scalar, trainer.validation_step
            trainer.log_scalar = lambda name, value, step=None: (self.logged.__setitem__(name, float(value)),
                                                                 log_scalar(name, value, step))[1]
            trainer.validation_step = lambda b: (self.val_scenes.update(b["scene_root"]), validation_step(b))[1]
            try:
                return fit(trainer, datamodule, *args, **kwargs)
            finally:
                del trainer.log_scalar, trainer.validation_step, trainer.training_step

        def timed_data(c):
            self.data = _TimedData(make_data(c))
            return self.data

        MicKeyTrainer.fit, loader.DataModuleTraining = probed_fit, timed_data
        try:
            t0 = time.perf_counter()
            cli.train_model(cli.parser().parse_args(argv), cfg=cfg.clone(), device=dev)
            self.seconds = time.perf_counter() - t0
        finally:
            MicKeyTrainer.fit, loader.DataModuleTraining = fit, make_data


def _state_tensors(trainer) -> list:
    from mickey_tpu_torch.weights import tree_leaves

    opt = trainer.state.opt_state
    return [t.detach() for _, t in tree_leaves(trainer.state.params)] + list(opt.mu) + list(opt.nu) + [opt.count]


def _same_state(a, b, what: str) -> None:
    differ = sum(not torch.equal(x, y) for x, y in zip(_state_tensors(a), _state_tensors(b)))
    if differ:
        raise SmokeError(f"{what}: {differ} parameter, moment or count tensors differ")


def check_fit_kernels(inp) -> dict:
    """K1 (bf16, packed) and K3 against their plain versions at the shapes
    the training entry point gives them: the train step's 2B images, and a
    validation solve's outer draws times B pairs. Returns name -> max |diff|."""
    calls = kernel_calls(inp)
    out = {"flash_attention_packed": _attn_err(*(f() for f in calls["flash_attention_packed"]),
                                               "flash_attention_packed, the train step's images")}
    out["hypothesis_scores"] = _close_k3(*(f() for f in calls["hypothesis_scores"]),
                                         "hypothesis_scores, a validation solve")
    return out


def run_fit(cfg, root, dev, *, batch: int = 8, samples: int = FIT_SAMPLES_A_SCENE,
            val_batches: int = VAL_BATCHES, train_queries: int = FIT_TRAIN_QUERIES,
            val_queries: int = FIT_VAL_QUERIES, params=None):
    """Phase 3e: the training entry point at ``cfg``'s width on a synthetic
    Map-free split under ``root`` (frames of ``cfg``'s size in raw-frame
    caches: ``FIT_SCENES`` train scenes of ``train_queries`` queries with
    overlaps, ``FIT_SCENES`` keyframe-shared val scenes of ``val_queries``):

    - one epoch of training through the CLI's entry, ``cli.train.train_model``
      on parsed arguments (``MicKeyTrainer.fit``, a log line every step):
      ``last/`` and a ``best_*/`` written, topk advanced once, ``train/lr``
      logged, the dense route's kernels launched (K3 once a validation
      batch), no K1b, K2b, K6; the keyframe cache one entry a validated scene;
    - a second run of the entry with ``--resume`` on ``last/``: its trainer's
      parameters, moments, count, step, topk and epoch bitwise the first's,
      and one more step of each from one generator seed bitwise equal;
    - cached validation against plain on one val batch (one generator seed)
      within VAL_TOL, the memory hit path too;
    - the feature cache over the train split: fp32 rows bitwise the train
      step's backbone maps, a cached step's metrics bitwise a staged step's,
      bf16 rows bitwise the fp32 rows' rounding (within one bf16 ulp), then one
      epoch through the entry with ``--feature_cache`` on the bf16 cache,
      whose train steps launch no attention kernel and read no image;
    - the image panels, where ``cv2`` imports.

    Returns (results, the trainers and batches ``fit_times`` times)."""
    from mickey_tpu_torch.data import DataModuleTraining
    from mickey_tpu_torch.models import MicKeyTrainer
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.training.feature_cache import build_feature_cache, frame_key

    h, w = int(cfg.DATASET.HEIGHT), int(cfg.DATASET.WIDTH)
    write_train_split(root, FIT_SCENES, train_queries, h, w)
    write_val_split(root, FIT_SCENES, val_queries, h, w)
    cfg = fit_config(cfg, root, batch, samples, val_batches)
    res, steps = {}, FIT_SCENES * samples // batch
    argv = ["--path_weights", os.path.join(root, "weights"), "--seed", str(SEED)]
    random.seed(SEED)  # train_model draws the sampler's seed from it

    # one epoch through the CLI's entry; its trainer, like every one built
    # below, starts from init_params_numpy(cfg, SEED) and the DINOv2 file
    # resolve_dinov2_weights finds, if any
    before = dict(_cuda.LAUNCHES)
    first = _CliRun(argv + ["--experiment", "smoke"], cfg, dev)
    launches = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}
    tr, logged, val_scenes = first.trainer, first.logged, first.val_scenes
    _launched(launches, "fit", FIT_KERNELS, FIT_ABSENT)
    _once_per_solve(launches, "fit", val_batches)
    best = [d for d in ("best_vcre", "best_pose") if os.path.isdir(os.path.join(tr.out_dir, d))]
    if tr.global_step != steps or not os.path.isdir(os.path.join(tr.out_dir, "last")) or not best:
        raise SmokeError(f"fit: {tr.global_step} steps for {steps}, checkpoints {os.listdir(tr.out_dir)}")
    topk0 = float(cfg.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT)
    if tr.topk != topk0 + 5 or logged.get("train/lr") != float(cfg.TRAINING.LR):
        raise SmokeError(f"fit: topk {tr.topk} (not {topk0 + 5}) or train/lr {logged.get('train/lr')} "
                         f"(not {cfg.TRAINING.LR})")
    if sorted(tr._val_kf_cache) != sorted(frame_key(r, "seq0/frame_00000.jpg") for r in val_scenes):
        raise SmokeError(f"fit: keyframe cache {sorted(tr._val_kf_cache)} for the val scenes {sorted(val_scenes)}")
    res.update(launches=launches, timing=first.probe.timing(first.data.train), keyframes=len(tr._val_kf_cache),
               val_auc_vcre=logged["val_vcre/auc_vcre"], best=best)

    # the entry again with --resume on last/ (the one epoch is done: it only
    # resumes), bitwise; then a step of each from one generator seed
    last = os.path.join(tr.out_dir, "last")
    tr2 = _CliRun(argv + ["--experiment", "smoke", "--resume", last], cfg, dev).trainer
    if (tr2.topk, tr2.global_step, tr2.state.step) != (tr.topk, tr.global_step, tr.state.step):
        raise SmokeError(f"resume: topk {tr2.topk}, step {tr2.global_step} / {tr2.state.step}")
    _same_state(tr2, tr, "resume")
    t0 = time.perf_counter()
    epoch = tr2.resume(last)
    res["restore_s"] = time.perf_counter() - t0
    if epoch != 0:
        raise SmokeError(f"resume: epoch {epoch}, not 0")
    tb = next(iter(DataModuleTraining(cfg).train_dataloader()))
    for t in (tr, tr2):
        t.generator.manual_seed(SEED + 11)
        t.training_step(tb)
    _same_state(tr2, tr, "resume, one step each")
    del tr2
    t0 = time.perf_counter()
    tr.maybe_checkpoint({}, epoch=1)  # no AUC given: last/ alone, with the moments
    res["save_s"] = time.perf_counter() - t0

    # cached validation against plain on one val batch
    vbatches = [b for _, b in zip(range(val_batches), DataModuleTraining(cfg).val_dataloader())]
    outs = {}
    for name, cached in (("cached", True), ("cached, memory hit", True), ("plain", False)):
        if name == "cached":
            tr._val_kf_cache.clear()
        tr._cached_val = cached
        tr.generator.manual_seed(SEED + 13)
        outs[name] = tr.validation_step(vbatches[0])
    val_err = 0.0
    for name in ("cached", "cached, memory hit"):
        for k, ref in outs["plain"].items():
            err = np.abs(outs[name][k] - ref)
            if not np.all(err <= VAL_TOL + VAL_TOL * np.abs(ref)):
                raise SmokeError(f"validation, {name} against plain: {k} max |diff| {err.max():.3e}")
            val_err = max(val_err, float(err.max()))
    res["val_cached_vs_plain"] = val_err

    # the feature cache: fp32 rows against the train step's maps, a cached
    # step against a staged one, bf16 rows, then an epoch from the cache
    train_ds = DataModuleTraining(cfg).train_dataloader().dataset
    c32 = build_feature_cache(cfg, tr.backbone, train_ds, os.path.join(root, "fc32"), batch_size=2 * batch,
                              dtype="float32")
    res["cache_frames"] = len(c32)
    res["cache_bytes_fp32"] = os.path.getsize(os.path.join(root, "fc32", "features.dat"))
    pairs = list(zip(tb["scene_root"], tb["pair_names"]))
    keys = [frame_key(sr, p[half]) for half in (0, 1) for sr, p in pairs]
    db = tr.device_batch(tb)
    fmap = tr.train_step.backbone_fwd(tr.backbone, db["image0"], db["image1"])
    rows = c32.gather(keys).to(dev)
    if not torch.equal(rows, fmap):
        raise SmokeError(f"feature cache: fp32 rows differ from the train step's maps, max |diff| "
                         f"{(rows - fmap).abs().max().item():.3e}")
    # params: init_params_numpy(cfg, SEED) made once by the caller, or by each trainer
    staged = MicKeyTrainer(cfg, params=params, seed=SEED, device=dev, out_dir=os.path.join(root, "run3"))
    cached = MicKeyTrainer(cfg, params=params, seed=SEED, device=dev, out_dir=os.path.join(root, "run4"))
    cached.feature_cache = c32
    m_staged = staged.training_step(tb)
    m_cached = cached.training_step({k: v for k, v in tb.items() if not k.startswith("image")})
    if m_staged != m_cached:
        raise SmokeError(f"feature cache: the cached step's metrics {m_cached} differ from the staged step's {m_staged}")
    _same_state(cached, staged, "feature cache, a cached step against a staged one")
    res["cached_step_loss"] = m_cached["loss"]
    c16 = build_feature_cache(cfg, tr.backbone, train_ds, os.path.join(root, "fc16"), batch_size=2 * batch,
                              dtype="bfloat16")
    res["cache_bytes_bf16"] = os.path.getsize(os.path.join(root, "fc16", "features.dat"))
    all32, all16 = c32.gather(list(c32.index)), c16.gather(list(c32.index))
    res["bf16_rows_max_diff"] = _within_bf16_ulp(all16, all32, "feature cache, bf16 rows")
    if not torch.equal(all16, all32.to(torch.bfloat16)):
        raise SmokeError("feature cache: bf16 rows are not the round-to-nearest-even of the fp32 rows")
    del all32, all16

    cfg.TPU.FEATURE_CACHE_DTYPE = "bfloat16"
    run = _CliRun(argv + ["--experiment", "smoke_cached", "--feature_cache", os.path.join(root, "fc16")], cfg, dev)
    from_cache, cprobe, cdata = run.trainer, run.probe, run.data
    step_launches = cprobe.summed()
    _launched(step_launches, "fit from the feature cache, train steps", DENSE_MATCHER_KERNELS, ATTENTION_KERNELS)
    if from_cache.global_step != steps or any("image0" in k or "fmap" not in k for k in cprobe.keys):
        raise SmokeError(f"fit from the feature cache: {from_cache.global_step} steps, batches {cprobe.keys[:1]}")
    res.update(cached_step_launches=step_launches, cached_timing=cprobe.timing(cdata.train))

    # the image panels (LOG_IMAGES, off by default), where cv2 imports (their
    # colours come from the port's own tables, not from matplotlib)
    if " yes" not in _imports(("cv2",)):
        res["image_panels"] = "skipped: cv2 does not import"
    else:
        panels = []
        tr.log_image = lambda name, img, step=None: panels.append(name)
        tr.log_training_images(tb)
        del tr.log_image
        res["image_panels"] = f"ran: {len(panels)} panels"
    ctx = {"trainer": tr, "staged": staged, "cached": cached, "batch": tb, "fmap": rows, "val": vbatches}
    return res, ctx


def fit_times(ctx, runs: int = 3, iters: int = 10) -> dict:
    """The train step's pieces on the card, CUDA-event medians at B of
    ``iters`` steps: the staged step (backbone, heads, matcher, loss, backward,
    optimizer) in ``runs`` turns with the same step on PyTorch's default
    backward kernels (each turn's median kept), each mode's peak memory, and
    the gradient leaves two equal backward passes leave apart on each (none
    allowed on the deterministic ones); and the cached-feature step on a
    device feature map."""
    from mickey_tpu_torch.training import train_step

    staged, cached, tb = ctx["staged"], ctx["cached"], ctx["batch"]
    db = staged.device_batch(tb)
    meta = {k: v for k, v in db.items() if not k.startswith("image")}
    gen = staged.generator
    out = {"cached_step_ms": time_ms(lambda: cached.train_step.grad_step(cached.state, ctx["fmap"], meta, gen,
                                                                         cached.topk), iters=iters, warmup=1)}
    # the staged step, and in turns with it the same step on PyTorch's default
    # (atomic) backward kernels: what the deterministic backward costs, in
    # time and on the card in one step's peak memory
    deterministic, steps = train_step.deterministic_backward, {"staged_step_ms": [], "staged_default_bwd_ms": []}

    def step():
        return staged.train_step(staged.state, staged.backbone, db, gen, staged.topk)

    for name in ("staged_step_ms", "staged_default_bwd_ms") * runs:
        train_step.deterministic_backward = deterministic if name == "staged_step_ms" else contextlib.nullcontext
        try:
            steps[name].append(time_ms(step, iters=iters, warmup=1))
            if db["T_0to1"].is_cuda:
                torch.cuda.reset_peak_memory_stats(db["T_0to1"].device)
                step()
                out[name.replace("_ms", "_peak_gib")] = torch.cuda.max_memory_allocated(db["T_0to1"].device) / 2**30
        finally:
            train_step.deterministic_backward = deterministic
    out.update({k: statistics.median(v) for k, v in steps.items()})
    out.update({f"{k}_turns": v for k, v in steps.items()})
    # why the backward is deterministic: two equal backward passes, the
    # gradient leaves they leave apart on each mode's kernels
    from mickey_tpu_torch.weights import tree_leaves

    fmap = staged.train_step.backbone_fwd(staged.backbone, db["image0"], db["image1"])

    def grads():
        gen.manual_seed(SEED + 17)
        return tree_leaves(train_step.loss_and_grads(staged.state.params, fmap, db, staged.cfg, staged.train_step.lc,
                                                     staged.topk, gen)[3])

    for mode, ctx_fn in (("deterministic", deterministic), ("default", contextlib.nullcontext)):
        train_step.deterministic_backward = ctx_fn
        try:
            a, b = grads(), grads()
        finally:
            train_step.deterministic_backward = deterministic
        out[f"grad_leaves_apart_{mode}"] = sum(not torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    out["grad_leaves"] = len(a)
    if out["grad_leaves_apart_deterministic"]:
        raise SmokeError(f"two equal backward passes left {out['grad_leaves_apart_deterministic']} gradient leaves apart")
    return out


def fit_window_times(cfg, dev, runs: int = 2, batch: int = 8) -> dict:
    """The training entry point timed on its own split under a temporary
    directory, long enough to read rates: ``FIT_SCENES`` train scenes of
    ``FIT_TIMING_TRAIN_QUERIES`` queries and ``FIT_SCENES`` val scenes of
    ``FIT_TIMING_VAL_QUERIES`` (each scene's pairs sharing its keyframe),
    ``FIT_TIMING_SAMPLES`` pairs drawn a scene, written as
    ``write_train_split`` and ``write_val_split`` write them, at ``cfg``'s
    frame size and width with its seeded random weights:

    - one epoch through the CLI's entry (``cli.train.train_model``, a log
      line every step, validation over every val batch): ms a step after the
      first (host clock) and the share of it spent waiting on the loader;
    - the feature cache over the train split at fp32 and at bf16: frames/s
      and bytes;
    - one epoch through the entry from the bf16 cache: ms a step, loader share;
    - the validation epoch over every val batch, the batches held in memory
      (host clock: each step ends on its metrics' copy to the host), plain
      and cached in turns (plain, cached, cached, plain for ``runs`` = 2),
      the keyframe cache emptied before each cached run; the share of a
      cached run's batches whose keyframes were all held already (hits)."""
    from mickey_tpu_torch.data import DataModuleTraining
    from mickey_tpu_torch.training.feature_cache import build_feature_cache, frame_key

    out = {}
    with tempfile.TemporaryDirectory(prefix="mickey_fit_timing_") as root:
        h, w = int(cfg.DATASET.HEIGHT), int(cfg.DATASET.WIDTH)
        t0 = time.perf_counter()
        write_train_split(root, FIT_SCENES, FIT_TIMING_TRAIN_QUERIES, h, w)
        write_val_split(root, FIT_SCENES, FIT_TIMING_VAL_QUERIES, h, w)
        out["split_write_s"] = time.perf_counter() - t0
        cfg = fit_config(cfg, root, batch, FIT_TIMING_SAMPLES, val_batches=0)  # 0: every val batch
        argv = ["--path_weights", os.path.join(root, "weights"), "--seed", str(SEED)]
        random.seed(SEED)
        run = _CliRun(argv + ["--experiment", "timing"], cfg, dev)
        out["fit"], out["train_model_s"] = run.probe.timing(run.data.train), run.seconds
        tr = run.trainer
        del run
        train_ds = DataModuleTraining(cfg).train_dataloader().dataset
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            cache = build_feature_cache(cfg, tr.backbone, train_ds, os.path.join(root, dtype), batch_size=2 * batch,
                                        dtype=dtype)
            s = time.perf_counter() - t0
            out[f"cache_{dtype}"] = {"frames": len(cache), "s": s, "frames_per_s": len(cache) / s,
                                     "bytes": os.path.getsize(os.path.join(root, dtype, "features.dat"))}
            del cache
        cfg.TPU.FEATURE_CACHE_DTYPE = "bfloat16"
        run = _CliRun(argv + ["--experiment", "timing_cached", "--feature_cache", os.path.join(root, "bfloat16")],
                      cfg, dev)
        out["fit_from_cache"] = run.probe.timing(run.data.train)
        del run

        vbatches = list(DataModuleTraining(cfg).val_dataloader())
        walls, hits = {"plain": [], "cached": []}, []
        for name in (["plain", "cached", "cached", "plain"] * runs)[: 2 * runs]:
            tr._cached_val, tr._val_kf_cache = name == "cached", {}
            held = 0
            t0 = time.perf_counter()
            for b in vbatches:
                held += all(frame_key(sr, p[0]) in tr._val_kf_cache for sr, p in zip(b["scene_root"], b["pair_names"]))
                tr.validation_step(b)
            walls[name].append(time.perf_counter() - t0)
            if name == "cached":
                hits.append(held / len(vbatches))
        pairs = sum(len(b["scene_root"]) for b in vbatches)
        out.update(val_pairs=pairs, val_batches=len(vbatches), val_keyframe_hit_share=hits)
        for name, wall in walls.items():
            out[f"val_{name}_s"] = wall
            out[f"val_{name}_pairs_per_s"] = pairs / statistics.median(wall)
        del tr, vbatches
    gc.collect()
    return out


def fit_line(res: dict, errs: dict) -> str:
    return (f"fit: ok | steps {res['timing']['steps']} | launches {res['launches']} | checkpoints last, {res['best']} | "
            f"resume bitwise, one more step bitwise | validation cached vs plain max |diff| "
            f"{res['val_cached_vs_plain']:.3e} (keyframes cached {res['keyframes']}) | feature cache "
            f"{res['cache_frames']} frames, fp32 rows bitwise, cached step = staged step (loss "
            f"{res['cached_step_loss']:.6f}), bf16 rows the fp32 rows' rounding (max |diff| "
            f"{res['bf16_rows_max_diff']:.3e}) | epoch from the cache: step launches {res['cached_step_launches']} | "
            f"image panels {res['image_panels']} | kernels at the fit's shapes "
            + " ".join(f"{k} max|diff|={v:.3e}" for k, v in errs.items()))


def fit_timing_line(res: dict, times: dict, window: dict, card: str) -> str:
    """``fit_window_times``' rates, ``fit_times``' step timings, and from
    phase 3e the checkpoint's save and restore seconds."""
    keep = {k: res[k] for k in ("restore_s", "save_s")}
    return f"timing (fit): ok | {card} | " + json.dumps({**window, **keep, **times})


def fit_report(cfg, dev, card: str) -> int:
    """``--fit``: phase 3e and its timing alone, at full width with the
    seeded random weights (``run_fit``)."""
    t_start = time.perf_counter()
    errs = check_fit_kernels(fit_kernel_inputs(dev, cfg))
    with tempfile.TemporaryDirectory(prefix="mickey_fit_") as root:
        (res, ctx), launches = _counted(lambda: run_fit(cfg, root, dev))
        print(fit_line(res, errs), flush=True)
        times = fit_times(ctx)
        del ctx
        print(fit_timing_line(res, times, fit_window_times(cfg, dev), card), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s after the build | phase launches {launches}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def fit_kernel_inputs(dev, cfg):
    """``kernel_inputs`` at the training entry point's shapes: 2B images, B
    pairs, a validation solve's outer draws (K1-old's inputs, unused here,
    at a token size)."""
    b = int(cfg.TRAINING.BATCH_SIZE)
    return kernel_inputs(dev, images=2 * b, seq=1939, heads=16, kpts=1938, desc=128, topl=int(cfg.TPU.MATCHER_TOPL),
                         prefilter=int(cfg.TPU.SAMPLING_PREFILTER), draws=int(cfg.PROCRUSTES.IT_MATCHES),
                         samples=int(cfg.PROCRUSTES.NUM_SAMPLED_MATCHES), hyps=int(cfg.PROCRUSTES.IT_RANSAC),
                         old_images=1, old_seq=64, old_len=37)


# -- 3f. the demo entry point and the backbone variants: int8, ViT-g/14 SwiGLU ------

DEMO_KERNELS = ("flash_attention_packed", "col_lse", "pair_softmax", "hypothesis_scores")
DEMO_ABSENT = ("flash_attention", "pair_topk")  # the full output's dense route, packed attention
DEMO_FILES = ("im0.depth.jpg", "im1.depth.jpg", "im0.score.jpg", "im1.score.jpg", "im0.matches.jpg",
              "im0.3d_vis.jpg")
# the int8 and ViT-g runs: both serving layouts' lite outputs (fused top-K) and the full output (dense route)
VARIANT_KERNELS = ("flash_attention_packed", "col_lse", "pair_topk", "hypothesis_scores", "pair_softmax")
#  Int8 backbone: torch._int_mm's int32 products bitwise the plain fp64
#      product (exact: int8 sums stay below 2^53); the int8 backbone's
#      features against the bf16 backbone's on the same weights and images,
#      per-token cosine above 0.995 (mickey_tpu's gate, tests/test_quant.py:89).
INT8_MIN_COS = 0.995
GIANT_CUT_DEPTH = 4  # the ViT-g/14 small-input check against the CPU runs the first 4 of its 40 blocks


def write_demo_inputs(root, height: int = 720, width: int = 540, seed: int = SEED) -> None:
    """Two ``height`` x ``width`` JPEGs (smooth random texture plus noise) and
    an ``intrinsics.txt`` for them (f = 590 px, centred principal point) in
    ``root``, as the demo reads them."""
    import cv2

    rng = np.random.default_rng(seed + 5)
    root = Path(root)
    for name in ("im0.jpg", "im1.jpg"):
        base = cv2.resize(rng.uniform(0, 255, (height // 16, width // 16, 3)).astype(np.uint8), (width, height))
        noisy = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
        if not cv2.imwrite(str(root / name), noisy):
            raise SmokeError(f"cv2 could not write {root / name}")
    (root / "intrinsics.txt").write_text("".join(f"{n} 590.0 590.0 {width / 2} {height / 2} {width} {height}\n"
                                                 for n in ("im0.jpg", "im1.jpg")))


def demo_argv(root, out: str) -> list:
    root = Path(root)
    return ["--im_path_ref", str(root / "im0.jpg"), "--im_path_dst", str(root / "im1.jpg"),
            "--intrinsics", str(root / "intrinsics.txt"), "--checkpoint", "", "--save_matches",
            "--generate_3D_vis", "--out_dir", str(root / out), "--seed", str(SEED)]


def demo_image_sizes(h: int, w: int) -> dict:
    """(H, W) of each file the demo writes for an ``h`` x ``w`` model input."""
    side = int((w + 30) / 2.5)  # the render's 2D composite: bordered inputs scaled by 1 / 2.5 beside it
    return {**{n: (h, w) for n in DEMO_FILES[:4]}, "im0.matches.jpg": (h, 2 * w + 50),
            "im0.3d_vis.jpg": (720, 1000 + side + 100)}


class _CallProbe:
    """While open, ``MickeyRelativePose.__call__`` records the image sizes it
    is given and its time (CUDA events on the card, the host clock on the
    CPU, each call synchronised)."""

    def __enter__(self):
        from mickey_tpu_torch.models import MickeyRelativePose

        self.sizes, self.ms, self._cls = set(), [], MickeyRelativePose
        call = self._call = MickeyRelativePose.__call__

        def probed(model, image0, image1, *args, **kwargs):
            self.sizes.update((tuple(image0.shape[1:3]), tuple(image1.shape[1:3])))
            if image0.is_cuda:
                out = None

                def run():
                    nonlocal out
                    out = call(model, image0, image1, *args, **kwargs)

                self.ms.append(_elapsed_ms(run))
                return out
            t0 = time.perf_counter()
            out = call(model, image0, image1, *args, **kwargs)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        MickeyRelativePose.__call__ = probed
        return self

    def __exit__(self, *exc):
        self._cls.__call__ = self._call


def run_demo(root, model=None) -> dict:
    """Phase 3f, demo: the demo CLI's entry (``cli.demo.run_demo_inference``
    on parsed arguments: the default config, random weights, ``--save_matches
    --generate_3D_vis --out_dir``) on the two JPEGs in ``root``, twice. R, t
    and the confidence finite; the model saw the images cut to the patch grid
    (720 x 540 -> 714 x 532, as ``mickey_tpu``'s demo cuts them); every file
    written, decoded and of its size; the full output's dense-route kernels
    launched (K3 once), neither K2b nor K1b; the second run's files byte for
    byte the first's. ``model`` injects a model (CPU rehearsal); without it
    the demo builds its own on the card."""
    import cv2

    from mickey_tpu_torch.cli import demo

    res, files = {"seconds": []}, []
    for out in ("demo", "demo_again"):
        args = demo.parser().parse_args(demo_argv(root, out))
        with _CallProbe() as probe:
            t0 = time.perf_counter()
            result, launches = _counted(lambda: demo.run_demo_inference(args, model=model))
            res["seconds"].append(time.perf_counter() - t0)
        files.append({n: (Path(root) / out / n).read_bytes() for n in DEMO_FILES})
        res.setdefault("launches", launches)
        res.setdefault("model_ms", []).extend(probe.ms)
        res.setdefault("sizes", set()).update(probe.sizes)
    _sync(result.R)
    for name, v in (("R", result.R), ("t", result.t), ("confidence", result.inliers)):
        if not bool(torch.isfinite(v).all()):
            raise SmokeError(f"demo: {name} is not finite")
    if len(res["sizes"]) != 1:
        raise SmokeError(f"demo: the model saw images of {sorted(res['sizes'])}")
    (h, w), = res["sizes"]
    expect = demo_image_sizes(h, w)
    for name, data in files[0].items():
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None or img.shape[:2] != expect[name]:
            raise SmokeError(f"demo: {name} {None if img is None else img.shape} is not an image of {expect[name]}")
    if files[0] != files[1]:
        raise SmokeError(f"demo: the second run wrote other bytes in {[n for n in DEMO_FILES if files[0][n] != files[1][n]]}")
    _launched(res["launches"], "demo", DEMO_KERNELS, DEMO_ABSENT)
    _once_per_solve(res["launches"], "demo", 1)
    res.update(R=result.R[0].tolist(), t=result.t[0, 0].tolist(), confidence=float(result.inliers[0]),
               valid=bool(result.valid[0]), model_saw=(h, w))
    return res


def demo_line(res: dict) -> str:
    return (f"demo: ok | model saw {res['model_saw'][0]} x {res['model_saw'][1]} | conf {res['confidence']:.3f} "
            f"valid {res['valid']} | t {[round(v, 4) for v in res['t']]} | launches {res['launches']} | files "
            f"{len(DEMO_FILES)} written, decoded, of their sizes; second run byte-identical")


def int8_model(model):
    """``model``'s weights under ``MICKEY.DINOV2.INT8``: every block linear of
    the backbone int8, and building again quantizes nothing twice."""
    from mickey_tpu_torch.models import MickeyRelativePose

    cfg_q = model.cfg.clone()
    cfg_q.MICKEY.DINOV2.INT8 = True
    model_q = MickeyRelativePose(cfg_q, model.params, device=model.device)
    for bp in model_q.params["dinov2"]["blocks"]:
        for sub in ("attn", "mlp"):
            if not all(p["w_q"].dtype == torch.int8 for p in bp[sub].values()):
                raise SmokeError("int8: a block linear is not quantized")
    if MickeyRelativePose(cfg_q, model_q.params, device=model.device).params["dinov2"] is not model_q.params["dinov2"]:
        raise SmokeError("int8: building the model again quantized the backbone again")
    return model_q


def block_linears(model_q) -> dict:
    """{name: its quantized params} of the backbone's first block."""
    bp = model_q.params["dinov2"]["blocks"][0]
    return {k: p for sub in ("attn", "mlp") for k, p in bp[sub].items()}


def check_int8_products(model_q, tokens: int, seed: int = SEED) -> dict:
    """``int_mm`` (``torch._int_mm`` on the card) bitwise ``int_mm_plain`` at
    each block linear's (M = ``tokens``, K, N), on int8 activations drawn
    over [-127, 127] whose first row is all 127 (the largest sums)."""
    from mickey_tpu_torch.nn import quant

    gen = torch.Generator(device=model_q.device).manual_seed(seed)
    shapes = {}
    for name, p in block_linears(model_q).items():
        n, k = p["w_q"].shape
        x_q = torch.randint(-127, 128, (tokens, k), generator=gen, device=model_q.device).to(torch.int8)
        x_q[0] = 127
        if not torch.equal(quant.int_mm(x_q, p["w_q"]), quant.int_mm_plain(x_q, p["w_q"])):
            raise SmokeError(f"int8: the {name} product ({tokens}, {k}) x ({k}, {n}) differs from the plain one")
        shapes[name] = (tokens, k, n)
    return shapes


def token_cosine(model_a, model_b, image0, image1) -> float:
    """The least cosine between the two models' backbone features of the
    same token, over both images of every pair."""
    from mickey_tpu_torch.nn.extractor import backbone_features

    ims = torch.cat([image0, image1])
    with torch.inference_mode():
        a = backbone_features(model_a.params, ims, model_a.cfg)
        b = backbone_features(model_b.params, ims, model_b.cfg)
    return torch.nn.functional.cosine_similarity(a.reshape(-1, a.shape[-1]).double(),
                                                 b.reshape(-1, b.shape[-1]).double(), dim=-1).min().item()


class _HeadsProbe:
    """While open, the backbone's packed attention records (heads, head dim)
    of each call."""

    def __enter__(self):
        from mickey_tpu_torch.nn import dinov2

        self.seen, self._mod, attn = set(), dinov2, dinov2.flash_attention_packed
        self._attn = attn

        def probed(qkv, num_heads):
            self.seen.add((num_heads, qkv.shape[-1] // (3 * num_heads)))
            return attn(qkv, num_heads)

        dinov2.flash_attention_packed = probed
        return self

    def __exit__(self, *exc):
        self._mod.flash_attention_packed = self._attn


def run_variant(model, image0, image1, K0, K1, what: str, layouts=("general",)) -> tuple:
    """The serving ``layouts``' lite outputs and the full output of ``model``:
    finite and of the right shapes, the serving and dense-route kernels
    launched (K3 once a solve). Returns ((lite outputs, full output),
    launches, {(heads, head dim)} of K1's calls)."""
    with _HeadsProbe() as heads:
        (outs, full), launches = _counted(lambda: (run_slice(model, image0, image1, K0, K1, layouts),
                                                   run_full(model, image0, image1, K0, K1)))
    _launched(launches, what, VARIANT_KERNELS, ("flash_attention",))
    _once_per_solve(launches, what, len(layouts) + 1)
    return (outs, full), launches, heads.seen


def run_int8(model, cpu_model, image0, image1, K0, K1, small_ims) -> tuple:
    """Phase 3f, int8: the default config with ``INT8=True`` on ``model``'s
    weights, both serving layouts and the full output (outputs finite, the
    serving and dense kernels launched as on the bf16 path, K1 on bf16 qkv);
    its int32 products bitwise the plain ones at the four block linears with
    M = the general call's tokens; its features against the bf16 backbone's
    (per-token cosine > INT8_MIN_COS); a small input against the plain CPU
    path (``check_against_plain``). Returns (results, launches, the int8 model)."""
    model_q = int8_model(model)
    (outs, full), launches, heads = run_variant(model_q, image0, image1, K0, K1, "int8", ("general", "shared"))
    tokens = 2 * image0.shape[0] * (1 + (image0.shape[1] // 14) * (image0.shape[2] // 14))
    shapes = check_int8_products(model_q, tokens)
    cos = token_cosine(model_q, model, image0, image1)
    if not cos > INT8_MIN_COS:
        raise SmokeError(f"int8: backbone features' least per-token cosine to bf16 {cos:.6f} <= {INT8_MIN_COS}")
    small = check_against_plain(model_q, int8_model(cpu_model), *small_ims)
    res = {"launches": launches, "heads": sorted(heads), "products": shapes, "token_cos_min": cos,
           "conf": outs["general"].inliers.tolist(), "shared_conf": outs["shared"].inliers.tolist(),
           "full_conf": full.inliers.tolist(), "small": small}
    return res, launches, model_q


def swiglu_params(cfg_v, seed: int = SEED, depth: int | None = None):
    """Seeded random weights for ``cfg_v`` with a SwiGLU ViT (ViT-g/14's FFN,
    as ``vit_giant2`` in the ViT-g/14 configuration): the heads at its
    channels from ``init_params_numpy`` (on a ViT-S stand-in, dropped), and
    a DINOv2 state dict with ``mlp.w12`` / ``mlp.w3`` (``dinov2_state_dict``
    of one numpy init of the ``VARIANT``, cut to ``depth`` blocks if given)
    loaded through ``convert_dinov2_state_dict``."""
    from mickey_tpu_torch.training.checkpoint import convert_dinov2_state_dict
    from mickey_tpu_torch.weights import _vit_init, init_params_numpy

    cfg_h = cfg_v.clone()
    cfg_h.MICKEY.DINOV2.VARIANT = "vit_small"
    params = init_params_numpy(cfg_h, seed)
    vit = {"dinov2": _vit_init(np.random.default_rng(seed + 1), cfg_v.MICKEY.DINOV2.VARIANT, ffn_layer="swiglufused")}
    if depth is not None:
        vit = cut_depth(vit, depth)
    params["dinov2"] = convert_dinov2_state_dict(dinov2_state_dict(vit["dinov2"]))
    return params


def cut_depth(params, depth: int):
    """``params`` with the backbone's first ``depth`` blocks."""
    vit = params["dinov2"]

    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:depth]

    return dict(params, dinov2=dict(vit, blocks=cut(vit["blocks"])))


def run_giant(cfg_g, params_g, dev, image0, image1, K0, K1, small_ims, depth: int | None = None) -> tuple:
    """Phase 3f, ViT-g/14: ``VARIANT="vit_giant2"``, ``CHANNEL_DIM=1536`` on
    ``params_g`` (``swiglu_params``), bf16 and int8: the backbone all of its
    variant's SwiGLU blocks (``depth`` of them if given: CPU rehearsal); the
    general layout's lite output and the full output finite, the kernels
    launched, K1 at the variant's heads of 64 (24 for ViT-g/14); then the
    same weights cut to GIANT_CUT_DEPTH blocks on a small input against the
    plain CPU path, bf16 and int8. Returns (results, launches per run, the
    two models)."""
    from mickey_tpu_torch.models import build_model
    from mickey_tpu_torch.nn.dinov2 import VIT_CONFIGS, swiglu_hidden_dim

    vc = VIT_CONFIGS[cfg_g.MICKEY.DINOV2.VARIANT]
    dim, want_heads = vc["embed_dim"], {(vc["num_heads"], vc["embed_dim"] // vc["num_heads"])}
    model_g = build_model(cfg_g, params_g, device=dev)
    blk = model_g.params["dinov2"]["blocks"]
    if (len(blk) != (depth or vc["depth"]) or set(blk[0]["mlp"]) != {"w12", "w3"}
            or tuple(blk[0]["mlp"]["w12"]["w"].shape) != (2 * swiglu_hidden_dim(dim), dim)):
        raise SmokeError(f"{cfg_g.MICKEY.DINOV2.VARIANT}: not the {vc['depth']}-block SwiGLU ViT of width {dim}")
    model_gq = int8_model(model_g)
    res, launches = {}, []
    for name, m in (("bf16", model_g), ("int8", model_gq)):
        (outs, full), ln, heads = run_variant(m, image0, image1, K0, K1, f"vit_giant2 {name}")
        if heads != want_heads:
            raise SmokeError(f"vit_giant2 {name}: attention ran at (heads, head dim) {sorted(heads)}, not {want_heads}")
        launches.append(ln)
        res[name] = {"launches": ln, "heads": sorted(heads), "conf": outs["general"].inliers.tolist(),
                     "full_conf": full.inliers.tolist()}
    cut = cut_depth(params_g, GIANT_CUT_DEPTH)
    card, cpu = build_model(cfg_g, cut, device=dev), build_model(cfg_g, cut, device="cpu")
    res["bf16"]["small"] = check_against_plain(card, cpu, *small_ims)
    res["int8"]["small"] = check_against_plain(int8_model(card), int8_model(cpu), *small_ims)
    return res, launches, (model_g, model_gq)


def giant_config(cfg):
    cfg_g = cfg.clone()
    cfg_g.MICKEY.DINOV2.VARIANT = "vit_giant2"
    cfg_g.MICKEY.DINOV2.CHANNEL_DIM = 1536
    return cfg_g


def linear_int8_times(model_q, tokens: int, reps: int = 10) -> dict:
    """Per block linear of ``model_q`` at M = ``tokens`` bf16 activations:
    ms of the activation quantization, ``int_mm`` (``torch._int_mm`` on the
    (out, in) weight's transposed view) and, for the layout's sake, the same
    product on a row-major (in, out) copy, the dequantization (scales, bias,
    cast) and the whole ``linear_int8``, against bf16 ``F.linear`` on the same
    weights (``time_many_ms``)."""
    from mickey_tpu_torch.nn import quant

    gen = torch.Generator(device=model_q.device).manual_seed(SEED)
    out = {}
    for name, p in block_linears(model_q).items():
        n, k = p["w_q"].shape
        x = torch.randn(tokens, k, generator=gen, device=model_q.device).to(torch.bfloat16)
        w = (p["w_q"].float() * p["w_s"][:, None]).to(torch.bfloat16)
        b = p["b"].to(torch.bfloat16)
        x_q, a_s = quant.quantize_rows_int8(x)
        y = quant.int_mm(x_q, p["w_q"])
        w_kn = p["w_q"].t().contiguous()
        out[name] = {
            "quantize": time_many_ms(lambda: quant.quantize_rows_int8(x), reps=reps),
            "int_mm": time_many_ms(lambda: quant.int_mm(x_q, p["w_q"]), reps=reps),
            "int_mm_row_major_weight": time_many_ms(
                (lambda: torch._int_mm(x_q, w_kn)) if x_q.is_cuda else (lambda: quant.int_mm_plain(x_q, p["w_q"])),
                reps=reps),
            "dequantize": time_many_ms(lambda: (y.float() * (a_s * p["w_s"]) + p["b"]).to(torch.bfloat16), reps=reps),
            "linear_int8": time_many_ms(lambda: quant.linear_int8(p, x), reps=reps),
            "bf16_linear": time_many_ms(lambda: torch.nn.functional.linear(x, w, b), reps=reps),
            "shape": [tokens, k, n],
        }
        out[name] = {k2: (round(v, 4) if isinstance(v, float) else v) for k2, v in out[name].items()}
    return out


def variant_times(model, model_q, giant, dev, batches=(2, 12), height: int = 714, width: int = 532,
                  iters: int = 5) -> dict:
    """CUDA-event medians: the bf16 and int8 backbone stages and the whole
    general call (lite) at B = 2 and at the submission batch B = 12, of
    714 x 532 pairs; the four block linears int8 against bf16 at B = 2's
    tokens; the ViT-g/14 backbone stage, bf16 and int8, at B = 2."""
    from mickey_tpu_torch.nn.extractor import backbone_features

    gen = torch.Generator(device=dev)
    out = {}
    for B in batches:
        image0, image1, K0, K1 = slice_inputs(dev, pairs=B, height=height, width=width)
        ims = torch.cat([image0, image1])
        for name, m in (("bf16", model), ("int8", model_q)):
            with torch.inference_mode():
                out[f"B{B}_{name}_backbone"] = round(time_ms(lambda: backbone_features(m.params, ims, m.cfg),
                                                             iters=iters), 3)
            out[f"B{B}_{name}_general"] = round(time_ms(lambda: m(image0, image1, K0, K1, generator=gen.manual_seed(SEED),
                                                                  lite=True), iters=iters), 3)
        del image0, image1, K0, K1, ims
    tokens = 2 * batches[0] * (1 + (height // 14) * (width // 14))
    out["linears"] = linear_int8_times(model_q, tokens)
    image0, image1, _, _ = slice_inputs(dev, pairs=batches[0], height=height, width=width)
    ims = torch.cat([image0, image1])
    for name, m in zip(("bf16", "int8"), giant):
        with torch.inference_mode():
            out[f"vit_giant2_B{batches[0]}_{name}_backbone"] = round(time_ms(lambda: backbone_features(m.params, ims, m.cfg),
                                                                  iters=iters), 3)
    return out


def run_demo_and_variants(cfg, model, cpu_model, dev, card: str, image0, image1, K0, K1, small_ims) -> tuple:
    """Phase 3f: the demo (``run_demo``, in a temporary directory), the int8
    backbone (``run_int8``) and the ViT-g/14 SwiGLU backbone
    (``run_giant``), each checked and printed; then their timing, taken now
    so that the variants' weights are freed before phase 4. Returns (the
    timing line, the launch counts of each counted run)."""
    with tempfile.TemporaryDirectory(prefix="mickey_demo_") as root:
        write_demo_inputs(root)
        demo = run_demo(root)
    print(demo_line(demo), flush=True)
    q, q_launches, model_q = run_int8(model, cpu_model, image0, image1, K0, K1, small_ims)
    print(f"int8: ok | launches {q_launches} | K1 at (heads, head dim) {q['heads']} | int32 products bitwise the "
          f"plain ones at {q['products']} | backbone vs bf16 least per-token cosine {q['token_cos_min']:.6f} | conf "
          f"{q['conf']} shared {q['shared_conf']} full {q['full_conf']} | small-input vs plain {q['small']}", flush=True)
    cfg_g = giant_config(cfg)
    g, g_launches, giant = run_giant(cfg_g, swiglu_params(cfg_g), dev, image0, image1, K0, K1, small_ims)
    print(f"vit_giant2: ok | {len(giant[0].params['dinov2']['blocks'])} SwiGLU blocks | "
          + " | ".join(f"{k}: launches {v['launches']} K1 at (heads, head dim) {v['heads']} conf {v['conf']} full "
                       f"{v['full_conf']} small-input vs plain {v['small']}" for k, v in g.items()), flush=True)
    times = variant_times(model, model_q, giant, dev)
    times["demo_seconds"] = [round(s, 3) for s in demo["seconds"]]
    times["demo_model_ms"] = [round(t, 3) for t in demo["model_ms"]]
    return f"timing (demo and variants): ok | {card} | {json.dumps(times)}", [demo["launches"], q_launches, *g_launches]


def demo_report(cfg, dev, card: str) -> int:
    """``--demo``: phase 3f and its timing alone, at full width with the
    seeded random weights."""
    from mickey_tpu_torch.models import build_model
    from mickey_tpu_torch.weights import init_params_numpy

    t_start = time.perf_counter()
    params = init_params_numpy(cfg, SEED)
    model, cpu_model = build_model(cfg, params, device=dev), build_model(cfg, params, device="cpu")
    line, launches = run_demo_and_variants(cfg, model, cpu_model, dev, card,
                                           *slice_inputs(dev, pairs=2, height=714, width=532),
                                           slice_inputs(dev, pairs=2, height=224, width=252))
    print(line, flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s after the build | phase launches "
          f"{ {k: sum(r[k] for r in launches) for k in launches[0]} }", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# -- phase 3g: the data-parallel layer and the native ingest ---------------------------------
#  2 ranks against one process (``run_ddp_train``): the same global batch of
#  B = 8 at 714 x 532 and the same injected loss draws, at the small loss
#  budget of ``small_loss_cfg`` (a refinement threshold flip moves the loss
#  by ~1e-3 at the full one). Only the order of the sums differs (the
#  BatchNorm statistics from all-reduced sums, the gradient a sum over the
#  ranks) and each rank runs the backbone on 4 pairs, not 8 (cuBLAS may take
#  another algorithm): the first step's loss and grad norm at DDP_RTOL
#  relative, BN running stats at DDP_RTOL relative, Adam's first moments
#  (0.1 x the summed gradient) at GRAD_TOL normwise per leaf; both ranks'
#  states bitwise equal. The later steps' loss and grad norm are held only at
#  DDP_LATER_RTOL relative: Adam's first update moves an entry whose gradient
#  is near 0 by lr times a sign a rounding can flip, so the two runs' states
#  part after step 1 (measured on the card: 4.8e-3 and 9.4e-3 at steps 2
#  and 3), yet a fault fed back from step 1 (BatchNorm's running stats, a
#  rank's state drifting from the broadcast one) moves them by far more.
DDP_RTOL = 1e-3
DDP_LATER_RTOL = 5e-2
INGEST_JPEGS = 48


def write_jpegs(root, n: int = INGEST_JPEGS, height: int = 720, width: int = 540, seed: int = SEED) -> list:
    """``n`` seeded JPEGs of ``width`` x ``height`` under ``root`` (smooth
    random fields with noise, quality 90), written with cv2; [] without it."""
    try:
        import cv2
    except ImportError:
        return []
    rng = np.random.default_rng(seed + 5)
    paths = []
    for i in range(n):
        coarse = rng.integers(0, 256, (height // 12, width // 12, 3), dtype=np.uint8)
        im = cv2.resize(coarse, (width, height), interpolation=cv2.INTER_CUBIC).astype(np.int16)
        im = np.clip(im + rng.integers(-8, 9, im.shape), 0, 255).astype(np.uint8)
        paths.append(os.path.join(root, f"frame_{i:05}.jpg"))
        cv2.imwrite(paths[-1], im, [cv2.IMWRITE_JPEG_QUALITY, 90])
    return paths


def ingest_rates(root, threads: int = 8, runs: int = 3) -> dict:
    """The native ingest (``data/native.py``): whether it built here (and why
    not), then its frames/s on ``INGEST_JPEGS`` synthetic 540 x 720 JPEGs in
    one call of ``threads`` threads, against the loader's fallback, cv2 sample
    by sample (``data.io.read_color_image``) alone and on a pool of
    ``threads`` threads, best of ``runs``, the host clock; and the mean
    |difference| of their pixels (libjpeg and cv2's resize are not cv2's
    decode)."""
    from concurrent.futures import ThreadPoolExecutor

    from mickey_tpu_torch.data import native
    from mickey_tpu_torch.data.io import read_color_image

    res = {"native": "built" if native.ensure_built() is not None else f"unavailable ({native.unavailable_reason()})"}
    paths = write_jpegs(root)
    if not paths:
        res["rates"] = "not measured: cv2 does not import, no JPEG to decode"
        return res
    size = (540, 720)

    def best(fn):
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return len(paths) / min(times), out

    res["cv2_fps"], ref = best(lambda: np.stack([read_color_image(p, size) for p in paths]))
    with ThreadPoolExecutor(threads) as pool:
        res[f"cv2_{threads}_threads_fps"], _ = best(lambda: list(pool.map(lambda p: read_color_image(p, size), paths)))
    if native.ensure_built() is not None:
        res[f"native_{threads}_threads_fps"], out = best(
            lambda: native.read_batch(paths, size[0], size[1], num_threads=threads))
        if out.shape != ref.shape or not np.isfinite(out).all():
            raise SmokeError(f"ingest: native batch {out.shape}, not {ref.shape}, or not finite")
        res["native_vs_cv2_mean_abs"] = float(np.abs(out - ref).mean())
        if res["native_vs_cv2_mean_abs"] > 5e-3:  # tests/test_data_pipeline.py's bound for the JAX package's
            raise SmokeError(f"ingest: native pixels {res['native_vs_cv2_mean_abs']:.3e} from cv2's on average")
    res["jpegs"], res["cpus"] = len(paths), os.cpu_count()
    return res


def _dp_backend(dev) -> tuple:
    """NCCL over two cards where there are two, else gloo with both ranks on
    ``cuda:0`` (NCCL refuses two ranks on one card); gloo on the CPU for a
    CPU rehearsal."""
    if torch.device(dev).type != "cuda":
        return "gloo", "cpu"
    return ("nccl", None) if torch.cuda.device_count() >= 2 else ("gloo", "cuda:0")


def run_ddp_train(cfg, dev, *, pairs: int = 8, height: int = 714, width: int = 532, steps: int = 3,
                  launch_timeout: float = 600.0, params=None) -> dict:
    """The training step under the data-parallel layer
    (``parallel.data_parallel_steps``) at ``cfg``'s width:

    - a world-1 NCCL group in this process against no group: ``steps``
      steps from one seed, the trainables, both moments and every metric
      bitwise; the step times of both (the host clock, synchronized);
    - two ranks (``_dp_backend``) against one process, ``steps`` steps at
      the small loss budget with the same injected draws each step: the
      first step's metrics, BN running stats and Adam's first moments at
      the tolerances above, the later steps' loss and grad norm at the
      looser one; each step's time (the first holds each process's
      warm-up).

    Every run starts from ``params`` (``init_params_numpy(cfg, SEED)``, made
    once by the caller and sent to the ranks), or makes it itself. Returns
    the checks' numbers and this process's kernel launches."""
    from mickey_tpu_torch import parallel
    from mickey_tpu_torch.parallel import data_parallel_steps

    batch = {k: v.cpu().numpy() for k, v in train_batch(dev, pairs, height, width).items()}
    res = {}
    (plain, grouped), launches = _counted(lambda: _world_one(cfg, dev, batch, steps, params))
    for k, a, b in (("first step's parameters", plain["first"]["params"], grouped["first"]["params"]),
                    ("first step's moments", (plain["first"]["mu"], plain["first"]["nu"]),
                     (grouped["first"]["mu"], grouped["first"]["nu"])),
                    ("last step's parameters", plain["params"], grouped["params"])):
        a, b = _flat(a), _flat(b)
        if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise SmokeError(f"ddp: a world-1 NCCL group's {k} differ from no group's")
    if plain["metrics"] != grouped["metrics"]:
        raise SmokeError(f"ddp: a world-1 group's metrics {grouped['metrics']} differ from {plain['metrics']}")
    res["world1_step_ms"] = {"no group": [t * 1e3 for t in plain["seconds"]],
                             "nccl world 1": [t * 1e3 for t in grouped["seconds"]]}

    small = small_loss_cfg(cfg)
    gh = small.LOSS_CLASS.GENERATE_HYPOTHESES
    df = int(cfg.MICKEY.DINOV2.DOWN_FACTOR)
    idx, ridx = inject_draws(np.random.default_rng(SEED + 21), pairs, height // df, width // df, gh.IT_MATCHES,
                             small.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES, gh.IT_RANSAC, gh.NUM_CORR_3d3d)
    override = (idx.numpy(), ridx.numpy())
    one, one_launches = _counted(lambda: data_parallel_steps(small, batch, steps, SEED, override, params,
                                                             device=dev))
    _launched(one_launches, "ddp, one process", TRAIN_KERNELS)
    backend, device = _dp_backend(dev)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    two = parallel.launch(data_parallel_steps, 2, backend, device, args=(small, batch, steps, SEED, override, params),
                          timeout_s=launch_timeout)
    res["two_rank_launch_s"] = time.perf_counter() - t0
    res["default_launch"] = default_launch_ranks()
    res.update(hold_ranks_against_one(one, two, "ddp"))
    res.update(backend=f"{backend} on {device or 'cuda:0, cuda:1'}",
               one_process_step_ms=[t * 1e3 for t in one["seconds"]],
               two_rank_step_ms=[[t * 1e3 for t in r["seconds"]] for r in two],
               rank_launches=[t["launches"] for t in two])
    return res, {k: launches[k] + one_launches[k] for k in launches}


def hold_ranks_against_one(one: dict, ranks: list, what: str, kernels=TRAIN_KERNELS) -> dict:
    """``data_parallel_steps``' results on the ranks of a group against one
    process's, on the same batch and injected draws: every rank's state
    bitwise rank 0's, every rank's launches ``kernels``, the first step's
    metrics and BN running stats at DDP_RTOL, its Adam first moments at
    GRAD_TOL normwise, the later steps' loss and grad norm at
    DDP_LATER_RTOL. Returns the distances."""
    for what_tree, tree in (("first step's state", lambda t: t["first"]), ("last parameters", lambda t: t["params"])):
        for r, other in enumerate(ranks[1:], 1):
            if not all(np.array_equal(x, y) for x, y in zip(_flat(tree(ranks[0])), _flat(tree(other)))):
                raise SmokeError(f"{what}: rank {r}'s {what_tree} differs from rank 0's")
    for r, t in enumerate(ranks):
        _launched(t["launches"], f"{what}, rank {r}", kernels)

    def rel(m1, m2):
        return {k: abs(m2[k] - m1[k]) / max(abs(m1[k]), 1e-12) for k in ("loss", "grad_norm", "loss_rot", "loss_trans")}

    # the first step is held tight; Adam's first update moves an entry whose gradient is near 0 by lr
    # times a sign that a rounding may flip, so the later steps are held loosely (constants above)
    n = len(ranks)
    m1, m2 = one["metrics"][0], ranks[0]["metrics"][0]
    errs = rel(m1, m2)
    if m2["num_valid"] != m1["num_valid"] or max(errs.values()) > DDP_RTOL:
        raise SmokeError(f"{what}: {n}-rank metrics {m2} against one process's {m1}")
    later = [rel(a, b) for a, b in zip(one["metrics"][1:], ranks[0]["metrics"][1:])]
    for i, (e, a, b) in enumerate(zip(later, one["metrics"][1:], ranks[0]["metrics"][1:])):
        if b["num_valid"] != a["num_valid"] or max(e["loss"], e["grad_norm"]) > DDP_LATER_RTOL:
            raise SmokeError(f"{what}: step {i + 2}'s {n}-rank metrics {b} against one process's {a}")
    f1, f2 = one["first"], ranks[0]["first"]
    bn = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
             for path, a, b in _leaves(f2["params"], f1["params"]) if path[-1] in ("mean", "var"))
    if bn > DDP_RTOL:
        raise SmokeError(f"{what}: {n}-rank BN running stats {bn:.3e} from one process's")
    mu = max(_norm_rel(torch.from_numpy(a), torch.from_numpy(b))
             for path, a, b in _leaves(f2["mu"], f1["mu"]) if path[-1] not in ("mean", "var"))
    if mu > GRAD_TOL:
        raise SmokeError(f"{what}: {n}-rank first moments {mu:.3e} normwise from one process's")
    return {"metrics_rel": errs, "bn_rel": bn, "moments_rel": mu, "later_steps_metrics_rel": later}


def default_launch_ranks() -> str:
    """Two ranks by ``parallel.launch``'s default backend: NCCL, a card a
    rank, where there are cards, so on one card the second rank raises
    rather than running on the CPU; gloo on the CPU where there is none.
    Returns what happened; raises SmokeError where a rank landed elsewhere."""
    from mickey_tpu_torch import parallel

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    t0 = time.perf_counter()
    try:
        devices = [str(dp.device) for dp in parallel.launch(parallel.world, 2, timeout_s=120)]
    except RuntimeError as e:
        if cards == 1 and "asks for cuda:1" in str(e):
            return f"refused in {time.perf_counter() - t0:.1f} s: rank 1 asks for cuda:1 on a one-card machine"
        raise SmokeError(f"ddp: the default launch failed ({str(e)[-400:]})") from e
    expected = [f"cuda:{r}" for r in range(2)] if cards else ["cpu", "cpu"]
    if cards == 1 or devices != expected:
        raise SmokeError(f"ddp: the default launch ran its ranks on {devices}, not {expected}")
    return f"ranks on {devices} in {time.perf_counter() - t0:.1f} s"


def _world_one(cfg, dev, batch, steps: int, params=None):
    """``steps`` steps with no process group, then the same in a world-1
    NCCL group (gloo on the CPU) joined by this process (and left after)."""
    from mickey_tpu_torch import parallel
    from mickey_tpu_torch.parallel import data_parallel_steps

    plain = data_parallel_steps(cfg, batch, steps, SEED, params=params, device=dev)
    with tempfile.TemporaryDirectory(prefix="mickey_rdv_") as tmp:
        backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
        parallel.init_data_parallel(backend, dev, init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
        try:
            if parallel.world().size != 1:
                raise SmokeError("ddp: the world-1 group has another size")
            grouped = data_parallel_steps(cfg, batch, steps, SEED, params=params, device=dev)
        finally:
            parallel.close_data_parallel()
    return plain, grouped


def _leaves(a, b, path=()):
    """(path, leaf of a, leaf of b) over two trees of dicts and lists of
    arrays (None leaves skipped)."""
    if a is None:
        return
    if isinstance(a, (dict, list, tuple)):
        for k in (a if isinstance(a, dict) else range(len(a))):
            yield from _leaves(a[k], b[k], path + (k,))
    else:
        yield path, np.asarray(a), np.asarray(b)


def _flat(tree: dict) -> list:
    return [a for _, a, _ in _leaves(tree, tree)]


def run_ddp_submission(model, cfg, root, batch: int | None = None, launch_timeout: float = 600.0) -> dict:
    """``predict`` on two ranks: the submission CLI's ``main`` on each
    (``parallel.launch``; the model the CLI builds from no checkpoint,
    ``init_params_numpy(cfg, 0)``, the weights of ``model``) on the
    synthetic val split under ``root``, rank 0 writing the zip. Held against this process serving each
    rank's rows in turn with that rank's generator and keyframe cache
    (``_OneRankOfTwo``): the same draws, so the same zip byte for byte; and
    against the one-process zip of the same split: the same names in the
    same order (the draws differ, so the poses too; the largest |dt|
    printed)."""
    import argparse

    from mickey_tpu_torch import parallel
    from mickey_tpu_torch.cli import submission
    from mickey_tpu_torch.data import DataModule, MapFreeDataset

    cfg = cfg.clone()
    cfg.DATASET.DATA_ROOT = str(root)
    cfg_path = os.path.join(root, "ddp_config.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg.dump())
    argv = ["--config", cfg_path, "--split", "val", "-o", os.path.join(root, "ddp2")]
    if batch:
        argv += ["--batch_size", str(batch)]
    backend, device = _dp_backend(model.device)
    t0 = time.perf_counter()
    parallel.launch(submission.main, 2, backend, device, args=(argv,), timeout_s=launch_timeout)
    seconds = time.perf_counter() - t0
    two = Path(root) / "ddp2" / "submission.zip"

    # this process: each rank's rows in turn, then the one-process run
    dev = model.device
    cfg.TRAINING.NUM_WORKERS = 8
    cfg.TRAINING.BATCH_SIZE = batch or 12
    results = {}
    for r in range(2):
        loader = DataModule(cfg, drop_last_val=False).val_dataloader()
        for scene, poses in submission.predict(loader, model, progress=False, dp=_OneRankOfTwo(r, 2, dev)).items():
            results.setdefault(scene, []).extend(poses)
    scenes = MapFreeDataset(cfg, "val").datasets
    order = {d.scene_root.name: {n: i for i, n in enumerate(d.paths1)} for d in scenes}
    results = {d.scene_root.name: sorted(results[d.scene_root.name], key=lambda p: order[d.scene_root.name][p.image_name])
               for d in scenes if d.scene_root.name in results}
    submission.save_submission(results, Path(root) / "ddp_serial.zip")
    serial = Path(root) / "ddp_serial.zip"
    args = argparse.Namespace(config="", dataset_config="", checkpoint="", dinov2=None,
                              output_root=Path(root) / "ddp1", split="val", batch_size=batch, no_shared_ref=False)
    (_, launches) = _counted(lambda: submission.eval_split(args, cfg=cfg.clone(), model=model))
    one = Path(root) / "ddp1" / "submission.zip"
    a, b = _zip_poses(two), _zip_poses(serial)
    if list(a) != list(b) or a != b:
        differ = [m for m in set(a) | set(b) if a.get(m) != b.get(m)]
        raise SmokeError(f"ddp submission: the 2-rank zip differs from the ranks' rows served here ({differ})")
    if two.read_bytes() != serial.read_bytes():
        raise SmokeError("ddp submission: the 2-rank zip's bytes differ from the same poses' zip")
    c = _zip_poses(one)
    dt = 0.0
    if list(c) != list(a):
        raise SmokeError(f"ddp submission: members {list(a)} against one process's {list(c)}")
    for member, text in a.items():
        x = [ln.split(" ") for ln in text.decode().splitlines()]
        y = [ln.split(" ") for ln in c[member].decode().splitlines()]
        if [v[0] for v in x] != [v[0] for v in y]:
            raise SmokeError(f"ddp submission: {member}'s names or order differ from one process's")
        if x:
            dt = max(dt, float(np.abs(np.array([v[5:8] for v in x], float) - np.array([v[5:8] for v in y], float)).max()))
    return {"backend": f"{backend} on {device or 'cuda:0, cuda:1'}", "poses": sum(len(v) for v in results.values()),
            "two_rank_s": seconds, "max_dt_vs_one_process": dt, "launches": launches}


class _OneRankOfTwo:
    """Rank ``rank`` of a group that this process plays alone, for
    ``predict``: its rows, its folded generator, and a gather that places
    its rows among the others' left NaN (whose poses ``predict`` skips as
    non-finite) and its pairs' names in every rank's slot."""

    def __init__(self, rank: int, size: int, device):
        from mickey_tpu_torch.parallel import DataParallel

        self.dp = DataParallel(rank, size, torch.device(device))
        self.rank, self.size, self.device = rank, size, self.dp.device

    def fold(self, generator):
        return self.dp.fold(generator)

    def all_gather_rows(self, x):
        out = torch.full((self.size * x.shape[0],) + tuple(x.shape[1:]), float("nan"), dtype=x.dtype,
                         device=x.device)
        out[self.dp.rows(out.shape[0])] = x
        return out

    def all_gather_objects(self, obj):
        return [obj] * self.size


def ddp_line(ingest: dict, train: dict, sub: dict, card: str) -> str:
    return (f"ddp: ok | {card} | ingest {json.dumps(ingest)} | train {json.dumps(train)} | "
            f"submission {json.dumps({k: v for k, v in sub.items() if k != 'launches'})}")


def ddp_report(cfg, dev, card: str) -> int:
    """``--ddp``: phase 3g alone, at full width with the seeded random weights."""
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mickey_ddp_") as tmp:
        ingest = ingest_rates(tmp)
        train, _ = run_ddp_train(cfg, dev)
        write_val_split(tmp)
        from mickey_tpu_torch.models import build_model

        sub = run_ddp_submission(build_model(cfg, device=dev), cfg, tmp)
    print(ddp_line(ingest, train, sub, card), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s after the build", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0

# -- 3h. the bf16 modes: the bf16-descriptor matcher and bf16 head convolutions ---

# (name, source, TPU kernel body replaced): the matcher's forward kernels in
# the correlation engine's bf16 mode (cfg.TPU.MATCHER_BF16)
BF16_KERNELS = (
    ("col_lse_bf16", "mickey_tpu_torch/csrc/fused_topk.cu", "mickey_tpu/ops/fused_matcher.py:82"),
    ("pair_topk_bf16", "mickey_tpu_torch/csrc/fused_topk.cu", "mickey_tpu/ops/fused_matcher.py:432"),
    ("pair_softmax_bf16", "mickey_tpu_torch/csrc/dual_softmax.cu", "mickey_tpu/ops/fused_matcher.py:107"),
)
# the MATCHER_BF16 paths (both serving layouts: K2a, K2b; the full output:
# K2a, K4), and the fp32 engine's kernels they must not launch
BF16_PATH_KERNELS = ("flash_attention_packed", "col_lse_bf16", "pair_topk_bf16", "pair_softmax_bf16",
                     "hypothesis_scores")
BF16_PATH_ABSENT = ("flash_attention", "col_lse", "pair_topk", "pair_softmax")
#  bf16 kernels against their plain versions: the plain versions upcast the
#      bf16 descriptors and multiply in fp32 (TF32 off), and every product
#      of two bf16 values is exact in fp32, so only the order of the sums
#      differs: values, lse_row and lse_col at RTOL (K4's P too, where the
#      fp32 engine's P is held at DS_RTOL for the terms its split drops),
#      K2b's rounds and sets as ``_topk_checked``, bitwise launch to launch.
#  bf16 heads, conv by conv: each of the heads' conv shapes on bf16-rounded
#      operands against the fp64 conv of the same operands, max |diff| within
#      (K / 8) 2^-23 of max |ref| (K = Cin k^2 terms a sum): the mode's TF32
#      tensor-core products are exact for bf16 operands, but their fp32 sums
#      truncate, up to one ulp a k8 step; the plain version (cuDNN fp32, TF32
#      off) is reported beside it.
#  bf16 heads, the stage: against its plain version (the same rounded
#      operands through cuDNN's fp32 kernels) within HEADS_STAGE_TOL normwise
#      per output. Each conv's output is rounded to bf16 again by the next
#      conv, so two sum orders that differ in the last fp32 bit round some
#      values to neighbouring bf16 values: the stage cannot agree with any
#      other sum order to fp32 accuracy, only to within a bf16 rounding step
#      (2^-8 relative).
HEADS_STAGE_TOL = 2.0 ** -8


def bf16_kernel_inputs(inp, tin) -> tuple:
    """``inp`` and ``tin`` with their descriptors rounded to bf16 (to nearest
    even, as the routes round them) and ``tin``'s lse_col made again by the
    plain version on the rounded descriptors."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    inp_b = dict(inp, dsc0=inp["dsc0"].to(torch.bfloat16), dsc1=inp["dsc1"].to(torch.bfloat16))
    tin_b = dict(tin, dsc0=tin["dsc0"].to(torch.bfloat16), dsc1=tin["dsc1"].to(torch.bfloat16))
    tin_b["lse_col"] = fm.col_lse_plain(tin_b["dsc0"], tin_b["dsc1"], tin["inv_temp"], tin["alpha"])
    return inp_b, tin_b


def bf16_kernel_calls(inp_b, tin_b, alpha: float = 1.0, inv_temp: float = 10.0) -> dict:
    """name -> (bf16 kernel call, plain call, the fp32 engine's call), all on
    the same rounded descriptors (the fp32 engine on their fp32 copy, exact):
    K2a and K2b at the serving shape, K2b on K2a's prepared copy as on the
    main path; K4 at the training shape."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    b0, b1, t0, t1 = inp_b["dsc0"], inp_b["dsc1"], tin_b["dsc0"], tin_b["dsc1"]
    f0, f1, u0, u1 = (x.float() for x in (b0, b1, t0, t1))
    lse_c = fm.col_lse_plain(b0, b1, inv_temp, alpha)
    k2b = (inp_b["scr0"], inp_b["scr1"], lse_c, inv_temp, alpha, inp_b["topl"])
    split_b, split_f = fm.topk_split(b0, b1), fm.topk_split(f0, f1)
    fm.col_lse(b0, b1, inv_temp, alpha, split_b)
    fm.col_lse(f0, f1, inv_temp, alpha, split_f)
    lc = tin_b["lse_col"]
    return {
        "col_lse_bf16": (lambda: fm.col_lse(b0, b1, inv_temp, alpha), lambda: fm.col_lse_plain(b0, b1, inv_temp, alpha),
                         lambda: fm.col_lse(f0, f1, inv_temp, alpha)),
        "pair_topk_bf16": (lambda: fm.pair_topk(b0, b1, *k2b, split_b), lambda: fm.pair_topk_plain(b0, b1, *k2b),
                           lambda: fm.pair_topk(f0, f1, *k2b, split_f)),
        "pair_softmax_bf16": (lambda: fm.pair_softmax(t0, t1, lc, inv_temp, alpha),
                              lambda: fm.pair_softmax_plain(t0, t1, lc, inv_temp, alpha),
                              lambda: fm.pair_softmax(u0, u1, lc, inv_temp, alpha)),
    }


def check_bf16_kernels(inp_b, tin_b, sizes=MATCHER_SIZES) -> dict:
    """Phase 3h: K2a, K2b and K4 in bf16 against their plain versions at the
    main paths' shapes (tolerances above), two launches of each bitwise
    equal; then on ragged sizes with NaN and infinities
    (``check_matcher_shapes``, with K4 at RTOL) and K2b's ties and NaN in
    the last column (``check_topk_shapes``), on bf16-rounded descriptors.
    Returns name -> max |diff|."""
    calls = bf16_kernel_calls(inp_b, tin_b)
    res = {}
    k, p, _ = calls["col_lse_bf16"]
    out = k()
    res["col_lse_bf16"] = _close(out, p(), "col_lse_bf16")
    _bitwise(k, out, "col_lse_bf16")
    k, p, _ = calls["pair_topk_bf16"]
    out = k()
    res["pair_topk_bf16"] = _topk_checked(out, p(), "pair_topk_bf16")
    _bitwise(k, out, "pair_topk_bf16")
    k, p, _ = calls["pair_softmax_bf16"]
    out = k()
    (po, plr) = p()
    res["pair_softmax_bf16"] = max(_close(out[0], po, "pair_softmax_bf16 out"),
                                   _close(out[1], plr, "pair_softmax_bf16 lse_row"))
    del po
    _bitwise(k, out, "pair_softmax_bf16")
    dev = inp_b["dsc0"].device
    ragged = check_matcher_shapes(dev, sizes, dtype=torch.bfloat16, p_rtol=RTOL)
    res["col_lse_bf16"] = max(res["col_lse_bf16"], ragged)
    res["pair_softmax_bf16"] = max(res["pair_softmax_bf16"], ragged)
    res["pair_topk_bf16"] = max(res["pair_topk_bf16"], check_topk_shapes(dev, sizes, dtype=torch.bfloat16))
    return res


def run_bf16_paths(model, image0, image1, K0, K1) -> dict:
    """Phase 3h, the main paths under ``TPU.MATCHER_BF16`` at the weights of
    ``model``: both serving layouts' lite outputs (the fused route, K2a and
    K2b in bf16) and the full output (the dense route, K2a and K4 in bf16),
    finite and of their shapes, their launches counted; then the dense /
    fused table cross-check on that config (``check_dense_table``: each
    route's values at RTOL against fp64 on the bf16-rounded descriptors) and
    the fp32 route's table on the same head outputs, which the knob must
    change. Returns the launches, the confidences and the table's numbers."""
    from mickey_tpu_torch.models import MickeyRelativePose

    cfg_b = model.cfg.clone()
    cfg_b.TPU.MATCHER_BF16 = True
    model_b = MickeyRelativePose(cfg_b, model.params, device=model.device)
    (outs, full), launches = _counted(lambda: (run_slice(model_b, image0, image1, K0, K1),
                                               run_full(model_b, image0, image1, K0, K1)))
    table = check_dense_table(model_b, image0, image1, K0, K1)
    B = image0.shape[0]
    feats = model.extract_feats(torch.cat([image0, image1]))
    halves = (tuple(f[:B] for f in feats), tuple(f[B:] for f in feats))
    t16, t32 = model_b.match_feats(*halves, fused=True), model.match_feats(*halves, fused=True)
    if torch.equal(t16.top_scores, t32.top_scores):
        raise SmokeError("MATCHER_BF16: the top-P table is the fp32 route's bit for bit")
    table["vs_fp32_table_rel"] = _rel(t16.top_scores, t32.top_scores)
    return {"launches": launches, "table": table, "conf": {k: o.inliers.tolist() for k, o in outs.items()},
            "full_conf": full.inliers.tolist()}


def check_rounded_convs(model, device, maps: int = 4, rows: int = 38, cols: int = 51, seed: int = SEED) -> dict:
    """Phase 3h: each distinct conv of the heads' blocks (its weights; seeded
    N(0, 1) inputs of ``maps`` maps of rows x cols, the serving grid) in the
    bf16 mode (``common.conv2d`` with bf16 compute) and in its plain version
    (``rounded_convs_plain``) against the fp64 conv of the same rounded
    operands: the mode within (K / 8) 2^-23 of max |ref|. Returns per shape
    the mode's and the plain version's max |diff| / max |ref| and the bound."""
    from mickey_tpu_torch.nn.common import conv2d, rounded_convs_plain

    convs = {}
    for head in ("det_head", "det_offset", "depth_head", "dsc_head"):
        for blk in ("resblock1", "resblock2", "resblock3", "resblock4"):
            for name in ("conv1", "conv2", "shortcut"):
                p = model.params[head][blk].get(name)
                if p is not None:
                    convs.setdefault(tuple(p["w"].shape), p)
    g = torch.Generator(device=device).manual_seed(seed)
    res = {}
    with torch.inference_mode():
        for (o, i, k, _), p in sorted(convs.items(), reverse=True):
            x = torch.randn(maps, rows, cols, i, device=device, generator=g)
            out = conv2d(p, x, torch.bfloat16)
            with rounded_convs_plain():
                plain = conv2d(p, x, torch.bfloat16)
            xr, wr = (t.to(torch.bfloat16).double() for t in (x, p["w"]))
            ref = torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2), wr, padding=k // 2).permute(0, 2, 3, 1)
            bound = i * k * k / 8 * 2.0 ** -23
            err = _rel(out, ref)
            if not err <= bound:
                raise SmokeError(f"rounded conv {i}->{o} k{k}: {err:.3e} of max|ref| from fp64 > {bound:.3e}")
            res[f"{i}->{o} k{k}"] = {"mode": err, "plain": _rel(plain, ref), "bound": bound}
    return res


def check_heads_bf16(model, device, batches=(2, 12), height: int = 714, width: int = 532, iters: int = 5) -> dict:
    """Phase 3h, the heads stage under ``TPU.HEADS_BF16`` (and
    ``HEADS_BF16_ON_CPU``, for the CPU rehearsal) on the backbone's feature
    map of B pairs (2B images, the serving stage): each output fp32, finite,
    within HEADS_STAGE_TOL normwise of the plain version
    (``rounded_convs_plain``: the same rounding, cuDNN's fp32 kernels), and
    not the fp32 heads' output (its normwise distance from the plain version
    reported beside, the rounding's own effect); CUDA-event medians of the
    fp32 heads, the bf16 mode and its plain version, in turns (a, b, c, c, b,
    a). Returns per B the distances and ms."""
    from mickey_tpu_torch.nn.common import rounded_convs_plain
    from mickey_tpu_torch.nn.extractor import backbone_features, heads_apply

    cfg = model.cfg
    cfg_h = cfg.clone()
    cfg_h.TPU.HEADS_BF16 = True
    cfg_h.TPU.HEADS_BF16_ON_CPU = True
    res = {}
    for B in batches:
        image0, image1 = slice_inputs(device, pairs=B, height=height, width=width)[:2]
        with torch.inference_mode():
            fmap = backbone_features(model.params, torch.cat([image0, image1]), cfg)
            fns = {"fp32": lambda: heads_apply(model.params, fmap, cfg)[0],
                   "bf16": lambda: heads_apply(model.params, fmap, cfg_h)[0]}

            def plain():
                with rounded_convs_plain():
                    return fns["bf16"]()
            fns["bf16_plain"] = plain
            out, ref, f32 = fns["bf16"](), plain(), fns["fp32"]()
            for x in out:
                if x.dtype != torch.float32 or not bool(torch.isfinite(x).all()):
                    raise SmokeError(f"HEADS_BF16, B = {B}: an output is {x.dtype} or not finite")
            err = max(_norm_rel(a, b) for a, b in zip(out, ref))
            if not err <= HEADS_STAGE_TOL:
                raise SmokeError(f"HEADS_BF16, B = {B}: {err:.3e} normwise from its plain version > {HEADS_STAGE_TOL}")
            moved = max(_norm_rel(a, b) for a, b in zip(out, f32))
            if not moved > 0:
                raise SmokeError(f"HEADS_BF16, B = {B}: the outputs are the fp32 heads' bit for bit")
            fp32_from_plain = max(_norm_rel(a, b) for a, b in zip(f32, ref))
            del out, ref, f32
            t = {k: [] for k in fns}
            for name in list(fns) + list(fns)[::-1]:
                t[name].append(time_ms(fns[name], iters=iters))
        res[f"B={B}"] = {"norm_rel_vs_plain": err, "norm_rel_vs_fp32": moved, "fp32_norm_rel_vs_plain": fp32_from_plain,
                         "ms": {k: round(statistics.mean(v), 3) for k, v in t.items()}}
        del fmap
    return res


def bf16_bounds(inp_b, tin_b) -> dict:
    """name -> (bound_ms, bound_by) of the bf16 kernels: one bf16 pass of the
    correlation at 989 TFLOP/s (products of bf16 values are exact in it)
    against the bytes as the fp32 rows count them, the descriptors at 2
    bytes a value."""
    b0, b1, t0, t1 = inp_b["dsc0"], inp_b["dsc1"], tin_b["dsc0"], tin_b["dsc1"]
    return {"col_lse_bf16": col_lse_bound(b0, b1, PEAK_BF16, 1.0),
            "pair_topk_bf16": pair_topk_bound(b0, b1, inp_b["topl"], PEAK_BF16, 1.0),
            "pair_softmax_bf16": pair_softmax_bound(t0, t1, PEAK_BF16, 1.0)}


def bf16_kernel_times(inp_b, tin_b, reps: int = 10) -> dict:
    """name -> (ms, plain ms, the fp32 engine's ms on the same descriptors):
    per call of ``reps`` enqueued back to back (``time_many_ms``), kernel and
    fp32 engine in turns (k, f, f, k), the plain version once."""
    times = {}
    for name, (k, p, f) in bf16_kernel_calls(inp_b, tin_b).items():
        t = {"k": [], "f": []}
        for which, fn in (("k", k), ("f", f), ("f", f), ("k", k)):
            t[which].append(time_many_ms(fn, reps=reps))
        times[name] = (statistics.mean(t["k"]), time_many_ms(p, reps=reps), statistics.mean(t["f"]))
    return times


def run_bf16_phase(model, inp, tin, device) -> dict:
    """Phase 3h: the bf16 kernels' checks, the MATCHER_BF16 paths at full
    width (B = 2 pairs of 714 x 532, both layouts and the full output; their
    launches checked), the bf16 heads conv by conv and as a stage at B = 2
    and 12, the kernels' times and bounds, and the general layout's stages
    (``_stage_times``) on both matcher routes with and without the knob."""
    from mickey_tpu_torch.models import MickeyRelativePose

    inp_b, tin_b = bf16_kernel_inputs(inp, tin)
    errs = check_bf16_kernels(inp_b, tin_b)
    ims = slice_inputs(device, pairs=2, height=714, width=532)
    paths = run_bf16_paths(model, *ims)
    _launched(paths["launches"], "serving, MATCHER_BF16", BF16_PATH_KERNELS, BF16_PATH_ABSENT)
    _once_per_solve(paths["launches"], "serving, MATCHER_BF16", 3)  # both layouts and the full output
    heads = {"convs": check_rounded_convs(model, device), "stage": check_heads_bf16(model, device)}
    cfg_b = model.cfg.clone()
    cfg_b.TPU.MATCHER_BF16 = True
    model_b = MickeyRelativePose(cfg_b, model.params, device=model.device)
    stages = {f"{name}, {route}": _stage_times(m, *ims, fused=route == "fused")
              for route in ("fused", "dense") for name, m in (("fp32 matcher", model), ("MATCHER_BF16", model_b))}
    return {"errs": errs, "paths": paths, "heads": heads, "kt": bf16_kernel_times(inp_b, tin_b),
            "bounds": bf16_bounds(inp_b, tin_b), "stages": stages}


def bf16_lines(res: dict, card: str) -> str:
    p = res["paths"]
    return (f"bf16: ok | launches {p['launches']} | conf {p['conf']} full output {p['full_conf']} | dense vs fused "
            f"table {p['table']} | kernels " + " ".join(f"{k} max|diff|={v:.3e}" for k, v in res["errs"].items())
            + f" | heads {json.dumps(res['heads'])}\n"
            f"timing (bf16): ok | {card} | "
            + " ".join(f"{n} {k:.4f}/{f:.4f}/{pl:.4f} ms kernel/fp32 engine/plain"
                       for n, (k, pl, f) in res["kt"].items())
            + " | bound " + " ".join(f"{n} {ms:.4f} ms ({by})" for n, (ms, by) in res["bounds"].items())
            + f" | general layout's stages ms, B = 2 {json.dumps(res.get('stages'))}")


def bf16_kernel_rows(res: dict, launches: dict) -> list:
    """The bf16 kernels' rows of the ``kernels`` line; ``launches`` name ->
    count over the main paths' runs."""
    return [{"name": n, "route": "cuda", "source": src, "replaces": rep, "launches": launches[n],
             "max_abs_err": res["errs"][n], "ms": res["kt"][n][0], "plain_ms": res["kt"][n][1],
             "bound_ms": res["bounds"][n][0], "bound_by": res["bounds"][n][1], "library_ms": None,
             "fp32_engine_ms": res["kt"][n][2]}
            for n, src, rep in BF16_KERNELS]


def bf16_report(cfg, dev, card: str, inp, tin) -> int:
    """``--bf16``: phase 3h alone, at full width with the seeded random
    weights; its kernels' rows as the whole run prints them."""
    from mickey_tpu_torch.models import build_model
    from mickey_tpu_torch.weights import init_params_numpy

    t_start = time.perf_counter()
    res = run_bf16_phase(build_model(cfg, init_params_numpy(cfg, SEED), device=dev), inp, tin, dev)
    print(bf16_lines(res, card), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s after the build", flush=True)
    print(json.dumps({"kernels": bf16_kernel_rows(res, res["paths"]["launches"])}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# -- 3i. the tensor-parallel backbone -----------------------------------------------------

TP = 2
# the backbone's modes under tensor parallelism: (MICKEY.DINOV2.FLOAT16, TPU.PACKED_ATTENTION) and the one
# attention kernel each must launch, once a block a pass
TP_MODES = {"bf16 packed": (True, True, "flash_attention_packed"),
            "bf16 unpacked": (True, False, "flash_attention"),
            "fp32": (False, True, "flash_attention_packed_f32")}
#  Tensor-parallel against one process (the same weights and images): the
#      fp32 map at rtol = atol = TP_F32_RTOL, mickey_tpu's own lock on its TP
#      forward (tests/test_tensor_parallel.py); only the order of the
#      row-parallel sums differs. A bf16 map is held to the bf16 backbone's
#      own envelope E, the one-process bf16 map's max |diff| / max |ref|
#      from the one-process fp32 map: its distance from the one-process bf16
#      map within TP_BF16_ENVELOPES x E. Both bf16 maps are roundings of the
#      one fp32 function by different sums (a rank rounds its partial sums
#      to bf16 before the group adds them, as the JAX partitioner does for a
#      bf16 dot), each at about E from it, so they lie up to 2 E apart (on
#      the CPU at ViT-S: 1.77e-2 apart, each 1.44e-2 and 1.52e-2 from fp32).
#      The ranks' maps bitwise equal, each rank's passes bitwise equal.
TP_F32_RTOL = 2e-5
TP_BF16_ENVELOPES = 2.0
#  The dp 1 x tp 2 step against one process: with the exact backbone
#      (MICKEY.DINOV2.FLOAT16=False, K1f on each rank's 8 heads) at phase 3g's
#      tolerances, only the order of the row-parallel sums differing; with the
#      default bf16 backbone against one process fed the ranks' own feature
#      map, bit for bit (the heads are replicated: one step). The bf16 TP map
#      is another bf16 rounding of the backbone (above); the one process's
#      step on its own bf16 map is printed beside, how far the step moves for
#      that rounding alone.
TP_TRAIN_KERNELS = ("flash_attention_packed_f32",) + TRAIN_KERNELS[1:]


def tp_configs(cfg) -> dict:
    """name -> ``cfg`` in each of ``TP_MODES``."""
    out = {}
    for name, (bf16, packed, _) in TP_MODES.items():
        c = cfg.clone()
        c.MICKEY.DINOV2.FLOAT16, c.TPU.PACKED_ATTENTION = bf16, packed
        out[name] = c
    return out


def _attention_each_block(launches: dict, path: str, kernel: str, blocks: int) -> None:
    """``path`` launched ``kernel`` once in each of its ``blocks`` block
    passes and no other attention kernel."""
    _launched(launches, path, (kernel,), tuple(k for k in ATTENTION_KERNELS if k != kernel))
    if launches[kernel] != blocks:
        raise SmokeError(f"{path}: {kernel} launched {launches[kernel]} times in {blocks} block passes")


def check_tp_forward(one: dict, ranks: list, depth: int, runs: int) -> dict:
    """``parallel.tensor_parallel_features`` on the ranks of a model group
    against one process's (tolerances above); each rank's passes launched
    its mode's attention kernel once a block and no other attention kernel;
    each rank's split leaves 1/tp of one process's bytes. Returns the
    distances and the bytes."""
    tp = len(ranks)
    res = {}
    f32 = one["maps"]["fp32"]["fmap"]
    for name, (_, _, kernel) in TP_MODES.items():
        ref = one["maps"][name]["fmap"]
        got = [r["maps"][name]["fmap"] for r in ranks]
        if got[0].shape != ref.shape or not np.isfinite(got[0]).all():
            raise SmokeError(f"tp {name}: map {got[0].shape} against {ref.shape}, or not finite")
        for r, (g, rk) in enumerate(zip(got, ranks)):
            if not np.array_equal(g, got[0]):
                raise SmokeError(f"tp {name}: rank {r}'s map differs from rank 0's")
            if not rk["maps"][name]["repeats"]:
                raise SmokeError(f"tp {name}: rank {r}'s passes differ from each other")
            _attention_each_block(rk["maps"][name]["launches"], f"tp {name}, rank {r}", kernel, depth * runs)
        dist = float(np.abs(got[0] - ref).max() / np.abs(ref).max())
        if name == "fp32":
            over = np.abs(got[0] - ref) - TP_F32_RTOL * (1.0 + np.abs(ref))
            if (over > 0).any():
                raise SmokeError(f"tp fp32: map beyond rtol = atol = {TP_F32_RTOL} of one process's "
                                 f"(max |diff| / max |ref| {dist:.3e})")
            res[name] = {"max_rel": dist}
        else:
            envelope = float(np.abs(ref - f32).max() / np.abs(f32).max())
            if dist > TP_BF16_ENVELOPES * envelope:
                raise SmokeError(f"tp {name}: map {dist:.3e} from one process's, beyond {TP_BF16_ENVELOPES} x the "
                                 f"bf16 backbone's own {envelope:.3e} from fp32")
            res[name] = {"max_rel": dist, "one_process_vs_fp32_max_rel": envelope,
                         "vs_fp32_max_rel": float(np.abs(got[0] - f32).max() / np.abs(f32).max())}
    for r, rk in enumerate(ranks):
        if rk["split_bytes"] * tp != one["split_bytes"]:
            raise SmokeError(f"tp: rank {r} holds {rk['split_bytes']} bytes of split leaves, not 1/{tp} of "
                             f"{one['split_bytes']}")
    res["bytes"] = {"one_process": {"backbone": one["backbone_bytes"], "split": one["split_bytes"]},
                    "ranks": [{"backbone": rk["backbone_bytes"], "split": rk["split_bytes"]} for rk in ranks]}
    return res


def backbone_bytes(backbone) -> int:
    """Bytes of storage behind a backbone tree's leaves."""
    from mickey_tpu_torch.weights import tree_leaves

    return sum(t.untyped_storage().nbytes() for _, t in tree_leaves(backbone))


def split_bytes(backbone) -> int:
    """Bytes of storage behind the leaves that tensor parallelism splits
    (``vit_tp_split``: the qkv, proj, fc1 and fc2 weights, the qkv and fc1
    biases) in a backbone tree: 1/tp of one process's on a rank."""
    from mickey_tpu_torch.parallel import vit_tp_split
    from mickey_tpu_torch.weights import tree_leaves

    dims = dict(tree_leaves(vit_tp_split(backbone)))
    return sum(t.untyped_storage().nbytes() for path, t in tree_leaves(backbone) if dims.get(path) is not None)


def tensor_parallel_features(cfgs: dict, images, params=None, seed: int = 0, device="cuda",
                             runs: int = 2) -> dict:
    """The frozen backbone's feature map of ``images`` (an array (B, H, W,
    3)) on this rank's shard of the backbone, under each config of ``cfgs``
    (name -> config: the dtype and the attention layout may differ, the
    weights do not), ``runs`` passes each: what each rank of a model group
    runs in phase 3i, and one process alone to be held against them. The
    weights are ``params`` (``mickey_tpu``'s layout) or
    ``init_params_numpy(first config, seed)``. The model group is this
    process's (``parallel.tensor_parallel()``). In a process group the
    backbone runs on the rank's device, else on ``device``.

    Returns, per config, the first pass's map (numpy fp32), whether every
    later pass gave it bit for bit, each pass's ms on the host clock (the
    device synchronized) and the kernels launched; and the bytes behind this
    rank's backbone and behind its split leaves (``split_bytes``)."""
    from mickey_tpu_torch import parallel
    from mickey_tpu_torch.nn.dinov2 import VIT_CONFIGS
    from mickey_tpu_torch.nn.extractor import backbone_features
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.weights import init_params_numpy, params_to_torch

    tp = parallel.tensor_parallel()
    first = next(iter(cfgs.values()))
    dev = parallel.world().device if torch.distributed.is_initialized() else torch.device(device)
    params = init_params_numpy(first, seed) if params is None else params
    heads = VIT_CONFIGS[first.MICKEY.DINOV2.get("VARIANT", "vit_large")]["num_heads"]
    backbone = parallel.shard_backbone(tp, params_to_torch(params, first, dev)["dinov2"], heads)
    x = torch.as_tensor(np.ascontiguousarray(images)).to(dev)
    out = {}
    for name, cfg in cfgs.items():
        before = dict(_cuda.LAUNCHES)
        maps, ms = [], []
        for _ in range(runs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                fmap = backbone_features({"dinov2": backbone}, x, cfg, tp)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            maps.append(fmap)
        out[name] = {"fmap": maps[0].float().cpu().numpy(), "repeats": all(torch.equal(m, maps[0]) for m in maps[1:]),
                     "ms": ms, "launches": {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}}
    return {"tp": (tp.rank, tp.size), "maps": out,
            "backbone_bytes": backbone_bytes(backbone), "split_bytes": split_bytes(backbone)}


def tp_fmap_steps(cfg, batch: dict, steps: int, seed: int, override, params, fmap=None, device="cuda") -> dict:
    """``steps`` staged steps of a ``MicKeyTrainer`` in this process's model
    group (``parallel.tensor_parallel()``; dp 1) on one ``batch``, split
    where the staged step splits (``StagedTrainStep.__call__``): the feature
    map of ``train_step.backbone_fwd`` on the rank's shard (fp32, the bf16
    backbone's output cast), or ``fmap`` where given, then
    ``train_step.grad_step`` on it
    with the injected draws ``override``. The one-process side of a check
    feeds it the ranks' own map, so that only the backbone's split differs.
    Returns the map, the metrics, the trainables and Adam's moments after
    the first step and the trainables after the last (``data_parallel_steps``'
    keys), and the kernels launched."""
    from mickey_tpu_torch import parallel
    from mickey_tpu_torch.models import MicKeyTrainer
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.weights import params_to_numpy

    before = dict(_cuda.LAUNCHES)
    tp = parallel.tensor_parallel()
    dev = parallel.world().device if torch.distributed.is_initialized() else device
    tr = MicKeyTrainer(cfg, params=params, seed=seed, device=dev, tp=tp)
    b = tr.device_batch(batch)
    if fmap is None:
        x = tr.train_step.backbone_fwd(tr.backbone, b["image0"], b["image1"])
    else:
        x = torch.from_numpy(fmap).to(tr.device)
    override = tuple(torch.as_tensor(o).to(tr.device) for o in override)
    metrics, first = [], None
    for _ in range(steps):
        _, m = tr.train_step.grad_step(tr.state, x, b, tr.generator, tr.topk, sample_override=override)
        metrics.append({k: float(v) for k, v in m.items()})
        if first is None:
            opt = tr.state.opt_state
            first = {"params": params_to_numpy(tr.state.params), "mu": tr._moments(opt.mu), "nu": tr._moments(opt.nu)}
    return {"fmap": x.cpu().numpy(), "first": first, "params": params_to_numpy(tr.state.params), "metrics": metrics,
            "launches": {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}}


def tp_rank(forward, cfgs: dict, images, runs: int, small, small_bf16, batch: dict, steps: int, override,
            params) -> tuple:
    """What each rank of phase 3i runs, in one spawn on the seeded weights
    ``params``: ``forward`` (``tensor_parallel_features``) on its shard in
    each of ``cfgs``, then, where ``steps``, ``parallel.data_parallel_steps``
    of ``small`` (the exact backbone) and ``tp_fmap_steps`` of
    ``small_bf16`` on ``batch`` with the injected draws ``override``."""
    from mickey_tpu_torch import parallel

    out = forward(cfgs, images, params, SEED, "cuda", runs)
    if not steps:
        return out, None, None
    return (out, parallel.data_parallel_steps(small, batch, steps, SEED, override, params=params),
            tp_fmap_steps(small_bf16, batch, steps, SEED, override, params))


def hold_tp_bf16_step(ranks: list, one: dict, own: dict, what: str) -> dict:
    """``tp_fmap_steps`` on the ranks of a model group (the default bf16
    backbone split over them) against one process fed the ranks' own
    feature map (``one``): the heads are replicated, so the two compute one
    step, and every rank's map, metrics and state must be bit for bit the
    one process's; each rank launched ``TRAIN_KERNELS``. ``own``: one
    process on its own bf16 map (not held): how far the step moves for the
    backbone's other rounding. Returns the maps' and the steps' distances."""
    for r, t in enumerate(ranks):
        _launched(t["launches"], f"{what}, rank {r}", TRAIN_KERNELS)
        if not np.array_equal(t["fmap"], ranks[0]["fmap"]):
            raise SmokeError(f"{what}: rank {r}'s feature map differs from rank 0's")
        for name, a, b in (("metrics", t["metrics"], one["metrics"]), ("first step's state", t["first"], one["first"]),
                           ("last parameters", t["params"], one["params"])):
            if name == "metrics":
                same = a == b
            else:
                same = all(np.array_equal(x, y) for x, y in zip(_flat(a), _flat(b)))
            if not same:
                raise SmokeError(f"{what}: rank {r}'s {name} differ from one process's on the ranks' map")
    _launched(one["launches"], f"{what}, one process on the ranks' map", TRAIN_KERNELS[1:], ATTENTION_KERNELS)

    tp_map, own_map = ranks[0]["fmap"], own["fmap"]
    return {"bitwise_one_process_on_the_ranks_map": True,
            "map_max_rel_vs_own": float(np.abs(tp_map - own_map).max() / np.abs(own_map).max()),
            "own_map_step_metrics": own["metrics"], "tp_step_metrics": one["metrics"],
            "grad_norm_rel_vs_own": [abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                                     for a, b in zip(one["metrics"], own["metrics"])]}


def run_tp_phase(cfg, dev, *, pairs: int = 2, height: int = 714, width: int = 532, runs: int = 2,
                 train_pairs: int = 8, steps: int = 3, launch_timeout: float = 900.0,
                 entry=None, params=None) -> tuple:
    """Phase 3i: the tensor-parallel backbone on ``TP`` ranks
    (``_dp_backend``: gloo on cuda:0 with one card; ``tp_rank``) against
    one process, at ``cfg``'s width with the seeded weights:

    - the forward (``tensor_parallel_features``; ``entry`` in its place,
      for the CPU tests) on 2 ``pairs`` (2 x pairs images) in each of
      ``TP_MODES``, ``runs`` passes: ``check_tp_forward``; each rank's ms a
      pass against one process's;
    - a dp 1 x tp ``TP`` training step (``parallel.data_parallel_steps``)
      with the exact backbone against one process: ``train_pairs`` pairs,
      ``steps`` steps at the small loss budget with the same injected draws,
      held as phase 3g holds its ranks (``hold_ranks_against_one``); the
      step ms of both;
    - the same steps with the default bf16 backbone (``tp_fmap_steps``)
      against one process fed the ranks' feature map, bit for bit
      (``hold_tp_bf16_step``), and beside one process on its own bf16 map.

    Steps are left out where ``steps`` is 0. Every run starts from
    ``params`` (``init_params_numpy(cfg, SEED)``, made here where not given;
    sent to the ranks). Returns (the checks' numbers and times, this
    process's kernel launches in the counted runs, the ranks' launches)."""
    from mickey_tpu_torch import parallel
    from mickey_tpu_torch.nn.dinov2 import VIT_CONFIGS
    from mickey_tpu_torch.weights import init_params_numpy

    entry = tensor_parallel_features if entry is None else entry
    cfgs = tp_configs(cfg)
    depth = VIT_CONFIGS[cfg.MICKEY.DINOV2.get("VARIANT", "vit_large")]["depth"]
    image0, image1, _, _ = slice_inputs(dev, pairs, height, width)
    images = torch.cat([image0, image1]).cpu().numpy()
    small_bf16, small = small_loss_cfg(cfg), small_loss_cfg(cfg)
    small_bf16.MICKEY.DINOV2.FLOAT16, small.MICKEY.DINOV2.FLOAT16 = True, False
    gh = small.LOSS_CLASS.GENERATE_HYPOTHESES
    df = int(cfg.MICKEY.DINOV2.DOWN_FACTOR)
    batch = {k: v.cpu().numpy() for k, v in train_batch(dev, train_pairs, height, width).items()}
    idx, ridx = inject_draws(np.random.default_rng(SEED + 21), train_pairs, height // df, width // df,
                             gh.IT_MATCHES, small.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES, gh.IT_RANSAC, gh.NUM_CORR_3d3d)
    override = (idx.numpy(), ridx.numpy())
    backend, device = _dp_backend(dev)
    res = {"backend": f"{backend} on {device or 'cuda:0, cuda:1'}", "tp": TP}

    params = init_params_numpy(cfg, SEED) if params is None else params
    one, launches = _counted(lambda: tensor_parallel_features(cfgs, images, params, SEED, dev, runs))
    one_step, step_launches = _counted(
        lambda: parallel.data_parallel_steps(small, batch, steps, SEED, override, params=params, device=dev)
        if steps else None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.launch(tp_rank, TP, backend, device, timeout_s=launch_timeout, tp=TP,
                            args=(entry, cfgs, images, runs, small, small_bf16, batch, steps, override, params))
    res["launch_s"] = time.perf_counter() - t0
    fwd, two, two_bf16 = zip(*ranks)
    res["forward"] = check_tp_forward(one, list(fwd), depth, runs)
    res["forward_ms"] = {name: {"one_process": one["maps"][name]["ms"], "ranks": [r["maps"][name]["ms"] for r in fwd]}
                         for name in TP_MODES}
    rank_launches = [r["maps"][name]["launches"] for r in fwd for name in TP_MODES]
    if steps:
        _launched(step_launches, "tp step, one process", TP_TRAIN_KERNELS)
        res["train"] = hold_ranks_against_one(one_step, list(two), f"tp step (dp 1 x tp {TP})", TP_TRAIN_KERNELS)
        res["train_step_ms"] = {"one_process": [t * 1e3 for t in one_step["seconds"]],
                                "ranks": [[t * 1e3 for t in r["seconds"]] for r in two]}
        fed, fed_launches = _counted(
            lambda: tp_fmap_steps(small_bf16, batch, steps, SEED, override, params, two_bf16[0]["fmap"], dev))
        own = tp_fmap_steps(small_bf16, batch, steps, SEED, override, params, device=dev)
        res["train_bf16"] = hold_tp_bf16_step(list(two_bf16), fed, own, f"tp bf16 step (dp 1 x tp {TP})")
        launches = {k: launches[k] + step_launches[k] + fed_launches[k] for k in launches}
        rank_launches += [t["launches"] for t in two] + [t["launches"] for t in two_bf16]
    return res, launches, rank_launches


def tp_line(res: dict, card: str) -> str:
    return (f"tp: ok | {card} | times on the host clock of {res['tp']} ranks over {res['backend']} (gloo's "
            f"collectives pass through the host: the layer's cost, not scaling over cards) | {json.dumps(res)}")


def tp_report(cfg, dev, card: str) -> int:
    """``--tp``: phase 3i alone, at full width with the seeded random weights."""
    t_start = time.perf_counter()
    res, _, _ = run_tp_phase(cfg, dev)
    print(tp_line(res, card), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s after the build", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# -- phase 3j: the JAX repo's gates on the card ----------------------------------------------
#
#   The fused-against-dense route gate (tools/fused_route_gate_torch.py) at the production
#   shape: 64 planted-geometry pairs in batches of 8, N = 1938, C = 128, the default config's
#   P, L and RANSAC budget; the dense route (K2a + K4, the exact top-P, K3) and the fused one
#   (K2a + K2b, K3) each in a counted run of its own, K3 once a solve, the JAX tool's gates;
#   K2b and K3 first against their plain versions at that shape (K2b on the first batch's
#   descriptors, bitwise launch to launch; K3 on the solve's 20 draws x 8 pairs = 160 point
#   sets of 2048 samples x 100 hypotheses). Then the quality tool's dry run
#   (tools/quality_run_torch.py: random weights, a synthesized micro-dataset, ViT-S fp32,
#   the dense route without a prefilter) on the card, with its demo leg on two JPEGs.

ROUTE_PAIRS, ROUTE_BATCH = 64, 8
ROUTE_KERNELS = {"dense": ("col_lse", "pair_softmax", "hypothesis_scores"),
                 "fused": ("col_lse", "pair_topk", "hypothesis_scores")}
ROUTE_ABSENT = {"dense": ("pair_topk",), "fused": ("pair_softmax",)}
QUALITY_KERNELS = ("flash_attention_packed_f32", "col_lse", "pair_softmax", "hypothesis_scores")
QUALITY_ABSENT = ("flash_attention_packed", "flash_attention", "pair_topk")
# evaluation.mapfree.summarize's keys, the JAX dry run's
QUALITY_METRICS = ("Average Median Translation Error", "Average Median Rotation Error",
                   "Average Median Reprojection Error", "Precision @ Pose Error < (25.0cm, 5deg)",
                   "AUC @ Pose Error < (25.0cm, 5deg)", "Precision @ VCRE < 90px", "AUC @ VCRE < 90px",
                   "Estimates for % of frames")


def route_kernel_inputs(dev, shape: dict, d: dict) -> dict:
    """K2b's and K3's inputs at the route gate's shape: ``kernel_inputs``'
    recipe for K3 (the solve's draws x the batch's pairs point sets), the
    gate's batch ``d`` (device tensors) for K2b's descriptors and scores;
    the attention inputs a token."""
    batch = d["dsc0"].shape[0]
    inp = kernel_inputs(dev, images=2 * batch, seq=2, heads=1, kpts=shape["N"], desc=shape["C"], topl=shape["L"],
                        prefilter=shape["P"], draws=shape["it_matches"], samples=shape["num_samples"],
                        hyps=shape["it_ransac"], old_images=1, old_seq=2, old_len=1)
    return dict(inp, dsc0=d["dsc0"], dsc1=d["dsc1"], scr0=d["scr0"][..., 0], scr1=d["scr1"][..., 0])


def check_route_kernels(inp) -> dict:
    """K2b and K3 against their plain versions at the route gate's shape
    (``_topk_checked``, ``_close_k3``), each bitwise from launch to launch.
    Returns name -> max |diff|."""
    calls = kernel_calls(inp)
    out, ref = (f() for f in calls["pair_topk"])
    res = {"pair_topk": _topk_checked(out, ref, "pair_topk, the route gate's shape")}
    _bitwise(calls["pair_topk"][0], out, "pair_topk, the route gate's shape")
    out, ref = (f() for f in calls["hypothesis_scores"])
    res["hypothesis_scores"] = _close_k3(out, ref, "hypothesis_scores, the route gate's shape")
    _bitwise(calls["hypothesis_scores"][0], out, "hypothesis_scores, the route gate's shape")
    return res


def run_route_gate(cfg, dev, *, pairs: int = ROUTE_PAIRS, batch: int = ROUTE_BATCH, n: int = 1938, c: int = 128,
                   tiny: bool = False) -> dict:
    """Phase 3j's route gate: the kernels at its shape (on its first
    batch), then each route over the ``pairs`` planted pairs in a counted
    run of its own (its kernels launched, the other route's not, K3 once a
    solve), the JAX tool's gates (``gate_failures``) on ``summarize``'s
    stats, and each route's ms on the first batch (CUDA events). ``tiny``:
    the JAX tool's ``--cpu`` shape. Returns the stats, the kernels' max
    |diff|, the launches and the ms."""
    from tools.fused_route_gate_torch import (batch_generator, gate_failures, gate_shape, make_pair_batch,
                                              make_routes, run_routes, summarize)

    shape = gate_shape(cfg, n, c, tiny=tiny)
    d, _ = make_pair_batch(np.random.default_rng(SEED), batch, shape["N"], shape["C"])
    d = {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    errs = check_route_kernels(route_kernel_inputs(dev, shape, d))
    rows, launches = {}, {}
    for route in ("dense", "fused"):
        out, launches[route] = _counted(lambda: run_routes(shape, pairs, batch, SEED, dev, cfg, names=(route,)))
        rows.update(out)
        _launched(launches[route], f"route gate, {route} route", ROUTE_KERNELS[route],
                  ROUTE_ABSENT[route] + ("flash_attention_packed", "flash_attention", "flash_attention_packed_f32"))
        _once_per_solve(launches[route], f"route gate, {route} route", max(1, pairs // batch))
    stats = summarize(rows, shape)
    missed = gate_failures(stats)
    if missed:
        raise SmokeError(f"route gate: {missed}; stats {json.dumps(stats)}")
    ms = {name: time_ms(lambda: fn(d, batch_generator(dev, 0)), iters=5, warmup=1)
          for name, fn in make_routes(cfg, shape).items()}
    return {"stats": stats, "errs": errs, "launches": launches, "ms": ms, "pairs": pairs, "batch": batch}


def route_line(res: dict, card: str) -> str:
    st = res["stats"]
    return (f"route gate: ok | {card} | {res['pairs']} pairs in batches of {res['batch']}, shape {json.dumps(st['shape'])}"
            f" | dense {json.dumps(st['dense'])} | fused {json.dumps(st['fused'])} | paired {json.dumps(st['paired'])}"
            f" | the JAX tool's gates met | K2b, K3 against plain max|diff| {json.dumps(res['errs'])}, bitwise launch "
            f"to launch | launches {json.dumps({r: _nonzero(c) for r, c in res['launches'].items()})} | ms a batch "
            f"{json.dumps(res['ms'])}")


def run_quality(dev, root) -> dict:
    """Phase 3j's quality run: ``tools/quality_run_torch.py --dry-run`` on
    ``dev`` in a counted run, its demo leg on two 720 x 540 JPEGs
    (``write_demo_inputs``, ``MICKEY_TOY_EXAMPLE``): exit 0, the zip
    written, the evaluator's metrics those of the JAX dry run
    (``QUALITY_METRICS``), K1f and the dense route's kernels launched (no
    prefilter: no K2b), K3 once a solve (the demo pair and one batch of the
    micro split's 6 pairs). Returns the metrics, the launches and seconds."""
    from tools.quality_run_torch import parser, quality_run

    root = Path(root)
    (root / "toy").mkdir(parents=True, exist_ok=True)
    write_demo_inputs(root / "toy")
    args = parser().parse_args(["--dry-run", "--out", str(root / "q"), "--device", str(dev)])
    saved = {k: os.environ.get(k) for k in ("MICKEY_TOY_EXAMPLE", "MICKEY_ALLOW_RANDOM_BACKBONE")}
    os.environ["MICKEY_TOY_EXAMPLE"] = str(root / "toy")
    t0 = time.perf_counter()
    try:
        (rc, metrics), launches = _counted(lambda: quality_run(args))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    if rc != 0 or not (root / "q" / "submission.zip").is_file():
        raise SmokeError(f"quality dry run: exit {rc}, zip written {(root / 'q' / 'submission.zip').is_file()}")
    if tuple(metrics) != QUALITY_METRICS:
        raise SmokeError(f"quality dry run: metrics {sorted(metrics)}, the JAX dry run's {sorted(QUALITY_METRICS)}")
    _launched(launches, "quality dry run", QUALITY_KERNELS, QUALITY_ABSENT)
    _once_per_solve(launches, "quality dry run", 2)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "launches": launches, "seconds": round(seconds, 1)}


def quality_line(res: dict, card: str) -> str:
    return (f"quality: ok | {card} | tools/quality_run_torch.py --dry-run exit 0 in {res['seconds']} s, demo leg and "
            f"submission.zip, the evaluator's metrics {json.dumps(res['metrics'])} | launches "
            f"{json.dumps(_nonzero(res['launches']))}")


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def run_gates_phase(cfg, dev, card: str) -> tuple:
    """Phase 3j: the route gate, then the quality dry run. Returns (the
    lines, the kernels' max |diff|, the runs' launch counts)."""
    route = run_route_gate(cfg, dev)
    with tempfile.TemporaryDirectory(prefix="mickey_quality_") as root:
        quality = run_quality(dev, root)
    return ([route_line(route, card), quality_line(quality, card)], route["errs"],
            [*route["launches"].values(), quality["launches"]])


def gates_report(cfg, dev, card: str, which: str) -> int:
    """``--route-gate`` / ``--quality``: that part of phase 3j alone."""
    t_start = time.perf_counter()
    if which == "route":
        print(route_line(run_route_gate(cfg, dev), card), flush=True)
    else:
        with tempfile.TemporaryDirectory(prefix="mickey_quality_") as root:
            print(quality_line(run_quality(dev, root), card), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s after the build", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# -- the overfit proxy (tools/train_curve_torch.py) ------------------------------------------

CURVE_STEPS, CURVE_EVAL_EVERY, CURVE_LR = 150, 30, 4e-4  # tests/test_convergence.py's run
# the mode's gate on a CPU device (HEADS_BF16_ON_CPU) lets the CPU tests rehearse it; the card ignores it
CURVE_MODES = {"fp32": None, "HEADS_BF16": {"TPU.HEADS_BF16": True, "TPU.HEADS_BF16_ON_CPU": True}}


def run_curve_phase(dev, steps: int = CURVE_STEPS, eval_every: int = CURVE_EVAL_EVERY) -> tuple:
    """The port's overfit proxy (``tools/train_curve_torch.run_curve``:
    ``grad_step`` on the geometric feature map, ``ValStep.tail`` at a fixed
    seed at each eval point), ``steps`` steps at lr 4e-4 at each of
    ``CURVE_SEEDS`` (the reference's), in fp32 and
    under ``TPU.HEADS_BF16``, each curve in a process of its own, one a core
    at once (``run_curves``), every step's loss and gradients finite
    (``require_finite``); then ``hold_curves``. Returns (each mode's
    seed-set report, the kernels the curves launched)."""
    from tools.train_curve_torch import CURVE_SEEDS, run_curves

    results = run_curves(CURVE_MODES, steps, eval_every, CURVE_SEEDS, CURVE_LR, dev)
    launches = {}
    for _, counts in results.values():
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
    return hold_curves({name: [results[(name, seed)][0] for seed in CURVE_SEEDS] for name in CURVE_MODES}), launches


def hold_curves(curves: dict) -> dict:
    """Each mode of ``CURVE_MODES`` -> its seed set of curves: the mode's
    with its convs in bf16 and the fp32 one without, every one; each set
    held to the seed-set gate (``seed_set_report``: the medians of the eval
    loss ratio, the VCRE ratio and the final rotation error over the seeds
    against ``SEED_GATE``, from ``mickey_tpu``'s own curves at the same
    seeds), with ``tests/test_convergence.py``'s three per-curve gates
    counted over the seeds. Returns each mode's report and its seeds'
    figures; raises where a mode misses the gate."""
    from tools.train_curve_torch import seed_metrics, seed_set_report

    out, missed = {}, {}
    for name, runs in curves.items():
        for curve in runs:
            if curve["heads_bf16"] != (CURVE_MODES[name] is not None):
                raise SmokeError(f"curve {name}, seed {curve['seed']}: the heads' convs "
                                 f"{'did not run' if CURVE_MODES[name] else 'ran'} in bf16")
        out[name] = dict(seed_set_report(runs), per_seed={c["seed"]: dict(seed_metrics(c), wall_s=c["wall_s"])
                                                          for c in runs})
        if out[name]["missed"]:
            missed[name] = out[name]["missed"]
    if missed:
        raise SmokeError(f"curve: the seed-set gate missed {json.dumps(missed)}; reports {json.dumps(out)}")
    return out


def curve_line(curves: dict, card: str) -> str:
    return f"curve: ok | {card} | every mode's seed set meets the seed-set gate | {json.dumps(curves)}"


def curve_report(dev, card: str) -> int:
    """``--curve``: the overfit proxy's seed sets, failing where a mode
    misses the seed-set gate."""
    t_start = time.perf_counter()
    curves, launches = run_curve_phase(dev)
    print(curve_line(curves, card), flush=True)
    print(f"curve launches {launches}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s after the build", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
