#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``mickey_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:

1. build   - compile the CUDA kernels (``mickey_tpu_torch/csrc``) with nvcc
             for sm_90a and print ``-Xptxas -v`` per kernel;
2. kernels - every kernel against its plain PyTorch version at the shapes
             its main path gives it (serving: B = 2 pairs; training: B = 8
             pairs, 1938 keypoints), with the tolerances stated below, and
             the training matcher's whole forward and backward against
             torch.autograd of the dense dual-softmax;
3. slice   - the pose-serving main path at full ViT-L width (714x532 images,
             1938 keypoints, B = 2 pairs, seeded random weights) in both
             layouts (general pairs, shared keyframe); outputs finite and of
             the right shape, every serving kernel launched; then a small
             input run on the card checked stage by stage against the plain
             CPU path;
   train   - the staged training step (``MicKeyTrainer``) at full width,
             default config, B = 8 pairs of 714x532: 3 steps with finite loss,
             grad norm and gradients, every trainable leaf and the BN running
             stats changed, the backbone unchanged, every training kernel
             launched; then one small-input step's loss, gradients and BN
             stats on the card against the plain CPU path with injected draws;
4. timing  - CUDA-event medians of both serving layouts (pairs/s) and their
             stages, of the train step and its stages, and of each kernel
             beside its plain version, its bound on the card and, where one
             PyTorch call computes the same function, that call.

Prints the card's name and power limit first, a JSON line of per-kernel
results before the last line, and ``{"ok": true, "device": ...}`` last. There
is no CPU mode: without CUDA it exits 1 before printing any result. The phase
functions take the device and the sizes as arguments, so the CPU tests
rehearse them at a tiny size, where every wrapper takes its plain version.
"""

from __future__ import annotations

import json
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
    ("col_lse", "mickey_tpu_torch/csrc/fused_topk.cu", "mickey_tpu/ops/fused_matcher.py:82"),
    ("pair_topk", "mickey_tpu_torch/csrc/fused_topk.cu", "mickey_tpu/ops/fused_matcher.py:432"),
    ("hypothesis_scores", "mickey_tpu_torch/csrc/hypothesis_scoring.cu",
     "mickey_tpu/ops/hypothesis_scoring.py:33"),
    ("pair_softmax", "mickey_tpu_torch/csrc/dual_softmax.cu", "mickey_tpu/ops/fused_matcher.py:107"),
    ("dual_softmax_bwd_sums", "mickey_tpu_torch/csrc/dual_softmax.cu", "mickey_tpu/ops/fused_matcher.py:234"),
    ("dual_softmax_bwd_grads", "mickey_tpu_torch/csrc/dual_softmax.cu", "mickey_tpu/ops/fused_matcher.py:256"),
)
SERVING_KERNELS = ("flash_attention_packed", "col_lse", "pair_topk", "hypothesis_scores")
TRAIN_KERNELS = ("flash_attention_packed", "col_lse", "pair_softmax", "dual_softmax_bwd_sums",
                 "dual_softmax_bwd_grads")
# Tolerances (kernel vs plain, same inputs):
#  K1: bf16 operands and bf16-rounded probabilities against the fp32 plain
#      version: |diff| < 2e-2 on O(1) outputs.
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
ATTN_TOL = 2e-2
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
                  topl: int, prefilter: int, samples: int, hyps: int, seed: int = SEED):
    """Seeded inputs at the main path's shapes for each kernel."""
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
    return dict(qkv=qkv, heads=heads, dsc0=t(d[0]), dsc1=t(d[1]), scr0=t(scr[0]), scr1=t(scr[1]),
                topl=topl, prefilter=prefilter, X=t(X), Y=t(Y), R=t(R), t=t(tr))


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
    from mickey_tpu_torch.ops.flash_attention import attention_packed_plain, flash_attention_packed
    from mickey_tpu_torch.ops.hypothesis_scoring import hypothesis_scores, hypothesis_scores_plain

    lse_c = fm.col_lse_plain(inp["dsc0"], inp["dsc1"], inv_temp, alpha)
    k2b = (inp["dsc0"], inp["dsc1"], inp["scr0"], inp["scr1"], lse_c, inv_temp, alpha, inp["topl"])
    hyp = (inp["X"], inp["Y"], inp["R"], inp["t"], 0.3)
    return {
        "flash_attention_packed": (lambda: flash_attention_packed(inp["qkv"], inp["heads"]),
                                   lambda: attention_packed_plain(inp["qkv"].float(), inp["heads"])),
        "col_lse": (lambda: fm.col_lse(inp["dsc0"], inp["dsc1"], inv_temp, alpha),
                    lambda: fm.col_lse_plain(inp["dsc0"], inp["dsc1"], inv_temp, alpha)),
        "pair_topk": (lambda: fm.pair_topk(*k2b), lambda: fm.pair_topk_plain(*k2b)),
        "hypothesis_scores": (lambda: hypothesis_scores(*hyp), lambda: hypothesis_scores_plain(*hyp)),
    }


def check_kernels(inp) -> dict:
    """Phase 2: each kernel against its plain version; returns name -> max |diff|."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    calls = kernel_calls(inp)
    res = {}
    out, ref = (f() for f in calls["flash_attention_packed"])
    _sync(out)
    err = (out.float() - ref).abs().max().item()
    if not err < ATTN_TOL:
        raise SmokeError(f"flash_attention_packed: max |diff| {err:.3e} >= {ATTN_TOL}")
    res["flash_attention_packed"] = err
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


def train_kernel_inputs(device, *, pairs: int, kpts: int, desc: int, seed: int = SEED):
    """Seeded descriptors and an upstream cotangent G at the training
    matcher's shapes, with the intermediate inputs of each K4 / K5 kernel
    made by the plain versions."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    rng = np.random.default_rng(seed + 2)
    d = rng.standard_normal((2, pairs, kpts, desc), dtype=np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    inp = dict(dsc0=t(d[0]), dsc1=t(d[1]), G=t(rng.standard_normal((pairs, kpts, kpts), dtype=np.float32)),
               alpha=1.0, inv_temp=10.0)
    inp["lse_col"] = fm.col_lse_plain(inp["dsc0"], inp["dsc1"], inp["inv_temp"], inp["alpha"])
    _, inp["lse_row"] = fm.pair_softmax_plain(inp["dsc0"], inp["dsc1"], inp["lse_col"], inp["inv_temp"], inp["alpha"])
    inp["r"], inp["c"] = fm.dual_softmax_bwd_sums_plain(inp["dsc0"], inp["dsc1"], inp["G"], inp["lse_row"],
                                                        inp["lse_col"], inp["inv_temp"])
    return inp


def train_kernel_calls(tin):
    """name -> (kernel call, plain call) for K4 and K5, on the same inputs."""
    from mickey_tpu_torch.ops import fused_matcher as fm

    d0, d1, G, it, a = tin["dsc0"], tin["dsc1"], tin["G"], tin["inv_temp"], tin["alpha"]
    sums = (d0, d1, G, tin["lse_row"], tin["lse_col"], it)
    grads = (d0, d1, G, tin["lse_row"], tin["lse_col"], tin["r"], tin["c"], it)
    return {
        "pair_softmax": (lambda: fm.pair_softmax(d0, d1, tin["lse_col"], it, a),
                         lambda: fm.pair_softmax_plain(d0, d1, tin["lse_col"], it, a)),
        "dual_softmax_bwd_sums": (lambda: fm.dual_softmax_bwd_sums(*sums),
                                  lambda: fm.dual_softmax_bwd_sums_plain(*sums)),
        "dual_softmax_bwd_grads": (lambda: fm.dual_softmax_bwd_grads(*grads),
                                   lambda: fm.dual_softmax_bwd_grads_plain(*grads)),
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


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def slice_inputs(device, pairs: int, height: int, width: int, seed: int = SEED):
    rng = np.random.default_rng(seed + 1)
    ims = rng.uniform(0, 1, (2, pairs, height, width, 3)).astype(np.float32)
    K = np.tile(np.array([[[590.0, 0, width / 2], [0, 590.0, height / 2], [0, 0, 1]]], np.float32), (pairs, 1, 1))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(ims[0]), t(ims[1]), t(K), t(K)


def run_slice(model, image0, image1, K0, K1) -> dict:
    """Phase 3: both serving layouts; outputs finite and of the right shapes."""
    B = image0.shape[0]
    gen = lambda: torch.Generator(device=image0.device).manual_seed(SEED)  # noqa: E731
    general = model(image0, image1, K0, K1, generator=gen())
    key_feats = model.extract_feats(image0[:1])
    ref_feats = tuple(f.expand(B, *f.shape[1:]) for f in key_feats)  # one keyframe, every pair
    shared = model.call_with_ref_feats(ref_feats, image1, K0, K1, generator=gen())
    _sync(general.R)
    for name, out in (("general", general), ("shared", shared)):
        for field, shape in (("R", (B, 3, 3)), ("t", (B, 1, 3)), ("inliers", (B,)), ("valid", (B,))):
            v = getattr(out, field)
            if tuple(v.shape) != shape:
                raise SmokeError(f"{name}.{field}: shape {tuple(v.shape)} != {shape}")
            if v.dtype != torch.bool and not bool(torch.isfinite(v).all()):
                raise SmokeError(f"{name}.{field}: non-finite values")
    return {"general": general, "shared": shared}


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
    2. Matcher (K4 forward, K5 backward) and loss on the card's head outputs:
       the loss at 1e-4 relative; its gradients with respect to the four head
       maps and the dustbin at 1e-3 of each one's largest entry.
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
    from mickey_tpu_torch.nn.extractor import correspondences_from_heads, heads_apply
    from mickey_tpu_torch.training.loss import LossConfig, metric_pose_loss
    from mickey_tpu_torch.training.train_step import StagedTrainStep, batch_pose, init_train_state
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
        corr = correspondences_from_heads(st.params, fs, cfg, train=True)
        Rgt, tgt = batch_pose(b)
        total, _ = metric_pose_loss(corr.final_scores, corr.kps0, corr.depth0, corr.kps1, corr.depth1,
                                    b["K_color0"], b["K_color1"], b["Kori_color0"], b["Kori_color1"], Rgt, tgt,
                                    lc, topk, sample_override=tuple(d.to(dev) for d in draws))
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


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def _bound(flops: float, nbytes: float, peak: float):
    """(least ms the card could take, what binds): operations over the peak
    rate of their type against the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_bounds(inp, tin) -> dict:
    """name -> (bound_ms, bound_by) at this run's kernel inputs. Operations
    counted: the matrix products (2 flops per multiply-add; K1's two products
    on bf16 tensor cores, the others fp32 FMA) and, for K3, the ~30 fp32
    operations of one soft-inlier term; exponentials are left out."""
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
    return {
        "flash_attention_packed": _bound(4.0 * imgs * heads * seq * seq * d,
                                         (imgs * seq * three_c + imgs * seq * heads * d) * 2, PEAK_BF16),
        "col_lse": _bound(2.0 * B * M * N * C, (B * M * C + B * N * C + B * N) * f32, PEAK_FP32),
        "pair_topk": _bound(2.0 * B * M * N * C,
                            (B * M * C + B * N * C + B * M + 2 * B * N + 2 * B * L * M + 4 * B * M) * f32, PEAK_FP32),
        "hypothesis_scores": _bound(30.0 * hb * hr * hs, (2 * hb * hs * 3 + hb * hr * 12 + hb * hr) * f32, PEAK_FP32),
        "pair_softmax": _bound(corr_t, descs_t + (Bt * Nt + Bt * Mt * Nt + Bt * Mt) * f32, PEAK_FP32),
        "dual_softmax_bwd_sums": _bound(corr_t, descs_t + (Bt * Mt * Nt + 2 * Bt * Mt + 2 * Bt * Nt) * f32, PEAK_FP32),
        "dual_softmax_bwd_grads": _bound(3 * corr_t, 2 * descs_t + (Bt * Mt * Nt + 2 * Bt * Mt + 2 * Bt * Nt) * f32,
                                         PEAK_FP32),
    }


def library_calls(inp) -> dict:
    """name -> one PyTorch call computing the kernel's function, where one
    exists: K1 is scaled_dot_product_attention on the unpacked heads."""
    imgs, seq, three_c = inp["qkv"].shape
    heads = inp["heads"]
    qkv = inp["qkv"].reshape(imgs, seq, heads, 3, three_c // 3 // heads)
    q, k, v = (qkv[:, :, :, i].permute(0, 2, 1, 3).contiguous() for i in range(3))
    return {"flash_attention_packed": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    from mickey_tpu_torch import default_config
    from mickey_tpu_torch.models import MicKeyTrainer, build_model
    from mickey_tpu_torch.ops import _cuda
    from mickey_tpu_torch.weights import init_params_numpy

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)

    # 1. build
    lib, log = _cuda.build()
    ptx = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling entry" in ln]
    print("build: ok | " + " | ".join(ptx), flush=True)

    # 2. kernels vs plain, at the main paths' shapes: serving (ViT-L 714x532,
    #    B = 2) and training (B = 8 pairs, 1938 keypoints, C = 128)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = kernel_inputs(dev, images=4, seq=1939, heads=16, kpts=1938, desc=128, topl=16,
                        prefilter=4096, samples=2048, hyps=100)
    errs = check_kernels(inp)
    tin = train_kernel_inputs(dev, pairs=8, kpts=1938, desc=128)
    errs.update(check_train_kernels(tin))
    print("kernels: ok | " + " ".join(f"{k} max|diff|={v:.3e}" for k, v in errs.items()), flush=True)

    # 3a. serving slice at full width, then a small input against the plain CPU path
    cfg = default_config()
    params = init_params_numpy(cfg, SEED)
    model = build_model(cfg, params, device=dev)
    image0, image1, K0, K1 = slice_inputs(dev, pairs=2, height=714, width=532)
    _cuda.reset_launches()
    outs = run_slice(model, image0, image1, K0, K1)
    serve_launches = dict(_cuda.LAUNCHES)
    missing = [k for k in SERVING_KERNELS if serve_launches[k] == 0]
    if missing:
        raise SmokeError(f"slice: kernels never launched on the serving path: {missing}")
    cpu_model = build_model(cfg, params, device="cpu")
    small = check_against_plain(model, cpu_model, *slice_inputs(dev, pairs=2, height=224, width=252))
    del cpu_model
    g = outs["general"]
    print(f"slice: ok | launches {serve_launches} | conf {g.inliers.tolist()} valid {g.valid.tolist()} | "
          f"small-input vs plain {small}", flush=True)

    # 3b. training at full width: B = 8 pairs of 714x532, 3 staged steps
    trainer = MicKeyTrainer(cfg, params=params, seed=SEED, device=dev)
    batch = train_batch(dev, pairs=cfg.TRAINING.BATCH_SIZE, height=714, width=532)
    _cuda.reset_launches()
    steps = run_train(trainer, batch, steps=3)
    train_launches = dict(_cuda.LAUNCHES)
    missing = [k for k in TRAIN_KERNELS if train_launches[k] == 0]
    if missing:
        raise SmokeError(f"train: kernels never launched on the training path: {missing}")
    small_train = check_train_against_plain(small_loss_cfg(cfg), params, dev, pairs=2, height=224, width=252)
    del params
    print(f"train: ok | launches {train_launches} | steps {steps} | small-input vs plain {small_train}", flush=True)

    # 4. timing
    B = image0.shape[0]
    key_feats = model.extract_feats(image0[:1])
    ref_feats = tuple(f.expand(B, *f.shape[1:]) for f in key_feats)
    gen = torch.Generator(device=dev)
    t_general = time_ms(lambda: model(image0, image1, K0, K1, generator=gen.manual_seed(SEED)))
    t_shared = time_ms(lambda: model.call_with_ref_feats(ref_feats, image1, K0, K1, generator=gen.manual_seed(SEED)))
    stages = _stage_times(model, image0, image1, K0, K1)
    train_stages = _train_stage_times(trainer, batch)
    calls = {**kernel_calls(inp), **train_kernel_calls(tin)}
    kt = {name: (time_ms(k, iters=20), time_ms(p, iters=20)) for name, (k, p) in calls.items()}
    lib_ms = {name: time_ms(f, iters=20) for name, f in library_calls(inp).items()}
    bounds = kernel_bounds(inp, tin)
    print(f"timing: ok | {card} | general {B / t_general * 1e3:.3f} pairs/s ({t_general:.3f} ms/batch of {B}) | "
          f"shared keyframe {B / t_shared * 1e3:.3f} pairs/s ({t_shared:.3f} ms) | stages ms {stages} | "
          f"train ms (B = {cfg.TRAINING.BATCH_SIZE}) {train_stages} | "
          + " ".join(f"{n} {k:.4f}/{p:.4f} ms kernel/plain" for n, (k, p) in kt.items())
          + " | " + " ".join(f"{n} library {t:.4f} ms" for n, t in lib_ms.items()), flush=True)

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": serve_launches[n] + train_launches[n], "max_abs_err": errs[n], "ms": kt[n][0],
         "plain_ms": kt[n][1], "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": lib_ms.get(n)}
        for n, src, rep in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _stage_times(model, image0, image1, K0, K1) -> dict:
    """Per-layer medians on the general layout's 2B stacked images."""
    from mickey_tpu_torch.nn.extractor import backbone_features, heads_apply

    cfg, B = model.cfg, image0.shape[0]
    ims = torch.cat([image0, image1])
    with torch.inference_mode():
        fmap = backbone_features(model.params, ims, cfg)
        feats = heads_apply(model.params, fmap, cfg)[0]
        halves = (tuple(f[:B] for f in feats), tuple(f[B:] for f in feats))
        tc = model.match_feats(*halves)
        gen = torch.Generator(device=image0.device)
        return {
            "backbone": round(time_ms(lambda: backbone_features(model.params, ims, cfg)), 3),
            "heads": round(time_ms(lambda: heads_apply(model.params, fmap, cfg)), 3),
            "matcher": round(time_ms(lambda: model.match_feats(*halves)), 3),
            "solver": round(time_ms(lambda: model.solve(tc, K0, K1, gen.manual_seed(SEED))), 3),
        }


def _train_stage_times(trainer, batch, iters: int = 5) -> dict:
    """CUDA-event medians of the staged train step at its batch, and of its
    stages: backbone forward, heads forward, matcher forward, loss forward
    (each building its autograd graph, as in training), one backward pass,
    the optimizer. The optimizer and whole-step timings update the state."""
    from mickey_tpu_torch.nn.extractor import compute_correspondences, heads_apply
    from mickey_tpu_torch.nn.matcher import match_scores
    from mickey_tpu_torch.training.loss import metric_pose_loss
    from mickey_tpu_torch.training.train_step import batch_pose

    cfg, step, st, gen, topk = trainer.cfg, trainer.train_step, trainer.state, trainer.generator, trainer.topk
    db = trainer.device_batch(batch)
    Rgt, tgt = batch_pose(db)
    Ks = [db[k] for k in ("K_color0", "K_color1", "Kori_color0", "Kori_color1")]
    fmap = step.backbone_fwd(trainer.backbone, db["image0"], db["image1"])
    corr, _ = compute_correspondences(st.params, None, None, cfg, train=True, fmap=fmap)
    leaf = lambda t: t.detach().requires_grad_(True)  # noqa: E731
    d0, d1 = leaf(corr.dsc0), leaf(corr.dsc1)
    loss_in = [leaf(corr.final_scores)] + [leaf(t) for t in (corr.kps0, corr.depth0, corr.kps1, corr.depth1)]
    del corr

    def full_forward():
        c, _ = compute_correspondences(st.params, None, None, cfg, train=True, fmap=fmap)
        return metric_pose_loss(c.final_scores, c.kps0, c.depth0, c.kps1, c.depth1, *Ks, Rgt, tgt,
                                step.lc, topk, generator=gen)[0]

    leaves = st.trainable()
    bwd = []
    for i in range(iters + 1):
        total = full_forward()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        end.record()
        end.synchronize()
        if i:
            bwd.append(start.elapsed_time(end))
        del total
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    out = {
        "backbone_fwd": time_ms(lambda: step.backbone_fwd(trainer.backbone, db["image0"], db["image1"]), iters, 1),
        "heads_fwd": time_ms(lambda: heads_apply(st.params, fmap, cfg, train=True), iters, 1),
        "matcher_fwd": time_ms(lambda: match_scores(st.params["matcher"], d0, d1, cfg, train=True), iters, 1),
        "loss_fwd": time_ms(lambda: metric_pose_loss(*loss_in, *Ks, Rgt, tgt, step.lc, topk, generator=gen), iters, 1),
        "backward": statistics.median(bwd),
        "optimizer": time_ms(lambda: step.optimizer.update(leaves, grads, st.opt_state, st.step), iters, 1),
        "step": time_ms(lambda: step(st, trainer.backbone, db, gen, topk), iters, 1),
    }
    return {k: round(v, 3) for k, v in out.items()}


if __name__ == "__main__":
    sys.exit(main())
