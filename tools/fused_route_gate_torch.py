"""Production-shape statistical gate on the PyTorch port: the dense route
against the fused matcher -> top-K route (``tools/fused_route_gate.py``, run
by ``mickey_tpu_torch``; numpy, torch and the port only).

At the production shape (N0 = N1 = 1938 keypoints, C = 128, P = 4096,
L = 16, RANSAC 20 x 100 x 2048, 64 planted-geometry pairs in batches of 8):

  dense: ``nn.matcher.match_scores`` (the dual-softmax with the dustbin at
         ``matcher_init``'s 1.0; on the card K2a + K4) -> * the score outer
         product -> ``estimate_pose(prefilter=P)`` (an exact top-P, where
         the JAX tool's route takes ``approx_max_k``; then K3)
  fused: ``ops.fused_matcher.fused_topk_scores`` (K2a + K2b and the exact
         top-P of the per-row top-L lists; the dense matrix is never
         written) -> ``estimate_pose_topk`` (K3)

Both routes of a batch draw from one seeded ``torch.Generator`` (seed 1000 +
the batch's index), as the JAX tool gives both one PRNG key. The scenes are
``make_pair_batch``'s, bit for bit the JAX tool's from the same
``np.random.default_rng(seed)``: half of the points are true
correspondences, expressed through noisy descriptors, so the dual-softmax
itself makes the peaked distribution that both routes reduce.

The gate is the JAX tool's, unchanged (``gate_failures``):
  - route validity identical per pair;
  - |median rotation / translation error of one route - the other's| <=
    max(0.05 deg / 5 mm, 25% of the reference route's median);
  - median relative confidence delta <= 10%.

``summarize`` and ``gate_failures`` take any two sets of per-pair rows, so
the same gate holds the port's routes under their own generator against the
JAX tool's routes under JAX's own keys (the solver's distribution gate,
``tests/test_torch_route_gate.py``: the JAX side runs where jax is
installed, on the CPU).

    python tools/fused_route_gate_torch.py [--pairs 64] [--batch 8] [--device cuda] [--json out.json]
    python tools/fused_route_gate_torch.py --cpu   # the JAX tool's tiny shape on the plain versions

Exits 1 where the gate fails. ``chip_smoke.py
--route-gate`` runs it on the card with the kernels counted.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KEY_BASE = 1000  # batch i's generator seed, the JAX tool's PRNGKey(1000 + i)
# the JAX tool's --cpu shape: N, P, L and the solver's budget cut
TINY = dict(N=96, P=64, L=8, it_matches=4, it_ransac=16, num_samples=32)
ROUTES = ("dense", "fused")


def make_pair_batch(rng, B, N, C, inlier_frac=0.5, desc_noise=0.35, depth_noise=0.02):
    """Planted-geometry batch at descriptor level (see module docstring);
    ``tools/fused_route_gate.py::make_pair_batch``, bit for bit."""
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 600.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = 270.0, 360.0, 1.0

    # modest planted pose: 5-30 deg rotation, |t| ~ 0.5 m (keeps depths positive)
    Rs, ts = [], []
    for _ in range(B):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = np.radians(rng.uniform(5.0, 30.0))
        Kx = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        Rs.append(np.eye(3) + math.sin(ang) * Kx + (1 - math.cos(ang)) * (Kx @ Kx))
        t = rng.normal(size=3)
        ts.append(0.5 * t / np.linalg.norm(t))
    R_gt = np.stack(Rs).astype(np.float32)
    t_gt = np.stack(ts).astype(np.float32).reshape(B, 1, 3)

    kps0 = rng.uniform(30, 510, (B, N, 2)).astype(np.float32)
    kps0[..., 1] *= 700.0 / 510.0  # spread over the 540x720 frame
    d0 = rng.uniform(2.0, 8.0, (B, N, 1)).astype(np.float32)

    # backproject -> transform -> project (numpy mirror of geometry.backproject_3d)
    ones = np.ones_like(d0)
    uv1h = np.concatenate([kps0, ones], axis=-1) * d0
    X = np.einsum("bij,bnj->bni", np.linalg.inv(K), uv1h)
    Y = np.einsum("bij,bnj->bni", R_gt, X) + t_gt
    uv = np.einsum("bij,bnj->bni", K, Y)
    kps1_true = (uv[..., :2] / uv[..., 2:3]).astype(np.float32)
    d1_true = uv[..., 2:3].astype(np.float32)

    n_in = int(N * inlier_frac)
    perm = np.stack([rng.permutation(N) for _ in range(B)])  # image-1 slot of point i

    kps1 = rng.uniform(30, 510, (B, N, 2)).astype(np.float32)
    kps1[..., 1] *= 700.0 / 510.0
    d1 = rng.uniform(2.0, 8.0, (B, N, 1)).astype(np.float32)

    dsc1 = rng.normal(size=(B, N, C)).astype(np.float32)
    dsc1 /= np.linalg.norm(dsc1, axis=-1, keepdims=True)
    dsc0 = rng.normal(size=(B, N, C)).astype(np.float32)

    for b in range(B):
        sl = perm[b, :n_in]
        kps1[b, sl] = kps1_true[b, :n_in]
        d1[b, sl] = d1_true[b, :n_in] + rng.normal(size=(n_in, 1)).astype(np.float32) * depth_noise
        dsc0[b, :n_in] = dsc1[b, sl] + rng.normal(size=(n_in, C)).astype(np.float32) * desc_noise
    dsc0 /= np.linalg.norm(dsc0, axis=-1, keepdims=True)

    scr0 = rng.uniform(0.2, 1.0, (B, N, 1)).astype(np.float32)
    scr1 = rng.uniform(0.2, 1.0, (B, N, 1)).astype(np.float32)

    T_gt = np.zeros((B, 4, 4), np.float32)
    T_gt[:, :3, :3] = R_gt
    T_gt[:, :3, 3] = t_gt[:, 0]
    T_gt[:, 3, 3] = 1.0
    return dict(
        kps0=kps0, depth0=d0, kps1=kps1, depth1=d1,
        dsc0=dsc0, dsc1=dsc1, scr0=scr0, scr1=scr1, K=K,
    ), T_gt


def gate_shape(cfg, n: int = 1938, c: int = 128, tiny: bool = False) -> dict:
    """The JAX tool's ``shape`` entry: N, C, P (``TPU.SAMPLING_PREFILTER``),
    L (``TPU.MATCHER_TOPL``) and the solver's PROCRUSTES budget, or with
    ``tiny`` its ``--cpu`` cut (``TINY``)."""
    pc = cfg.PROCRUSTES
    shape = dict(N=n, C=c, P=int(cfg.TPU.SAMPLING_PREFILTER), L=int(cfg.TPU.MATCHER_TOPL),
                 it_matches=pc.IT_MATCHES, it_ransac=pc.IT_RANSAC, num_samples=pc.NUM_SAMPLED_MATCHES,
                 num_corr=pc.NUM_CORR_3D_3D, num_refinements=pc.NUM_REFINEMENTS, th_inlier=pc.TH_INLIER,
                 th_soft_inlier=pc.TH_SOFT_INLIER)
    if tiny:
        shape.update(TINY)
    return shape


def solver_args(shape: dict) -> dict:
    return {k: v for k, v in shape.items() if k not in ("N", "C", "P", "L")}


def make_routes(cfg, shape: dict) -> dict:
    """route name -> fn(batch of device tensors, generator, draws=None) ->
    (R, t, confidence, valid): the two routes of the module docstring;
    ``draws`` injects the solver's samples (positions in the route's top-P
    table) in place of the generator's."""
    import torch

    from mickey_tpu_torch.nn.matcher import match_scores
    from mickey_tpu_torch.ops.fused_matcher import fused_topk_scores
    from mickey_tpu_torch.solver.procrustes_ransac import estimate_pose, estimate_pose_topk

    fm = cfg.FEATURE_MATCHER.DUAL_SOFTMAX
    use_db = bool(fm.USE_DUSTBIN)
    mp = {"dustbin_score": 1.0} if use_db else {}  # matcher_init
    kw = solver_args(shape)

    @torch.inference_mode()
    def dense(d, generator, draws=None):
        scores = match_scores(mp, d["dsc0"], d["dsc1"], cfg)
        final = scores * d["scr0"] * d["scr1"].transpose(1, 2)
        est = estimate_pose(final, d["kps0"], d["depth0"], d["kps1"], d["depth1"], d["K"], d["K"],
                            prefilter=shape["P"], generator=generator, draws=draws, **kw)
        return est.R, est.t, est.confidence, est.valid

    @torch.inference_mode()
    def fused(d, generator, draws=None):
        ts, ti, row_ok = fused_topk_scores(d["dsc0"], d["dsc1"], d["scr0"][..., 0], d["scr1"][..., 0],
                                           mp.get("dustbin_score", 0.0), shape["P"],
                                           temperature=float(fm.TEMPERATURE), use_dustbin=use_db,
                                           row_topl=shape["L"])
        est = estimate_pose_topk(ts, ti, row_ok, d["kps0"], d["depth0"], d["kps1"], d["depth1"], d["K"], d["K"],
                                 n1=shape["N"], generator=generator, draws=draws, **kw)
        return est.R, est.t, est.confidence, est.valid

    return {"dense": dense, "fused": fused}


def batch_generator(device, index: int):
    """Batch ``index``'s generator, seeded ``KEY_BASE + index``."""
    import torch

    return torch.Generator(device=device).manual_seed(KEY_BASE + index)


def pair_rows(R, t, conf, valid, T_gt) -> dict:
    """Per-pair rows (R_err deg, t_err m, conf, valid) of one batch's poses
    under the planted ``T_gt`` (numpy or tensors)."""
    import torch

    from mickey_tpu_torch.metrics.pose_metrics import pose_error

    np_ = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)  # noqa: E731
    err = pose_error(*(torch.from_numpy(np.array(np_(x), np.float32)) for x in (R, t, T_gt)))
    return {"R_err": err["R_err"].numpy(), "t_err": err["t_err_euc"].numpy(),
            "conf": np_(conf).astype(np.float32), "valid": np_(valid)}


def run_routes(shape: dict, pairs: int = 64, batch: int = 8, seed: int = 0, device="cuda", cfg=None,
               names=ROUTES, verbose: bool = False) -> dict:
    """route -> {R_err, t_err, conf, valid: a list of per-batch arrays} for
    each route of ``names``: ``pairs // batch`` batches of
    ``make_pair_batch`` from ``default_rng(seed)``, every route of a batch
    on one generator seed (so one route run alone gives what it gives
    beside the other)."""
    import torch

    from mickey_tpu_torch import default_config

    cfg = default_config() if cfg is None else cfg
    routes = {name: fn for name, fn in make_routes(cfg, shape).items() if name in names}
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    rows = {r: {k: [] for k in ("R_err", "t_err", "conf", "valid")} for r in routes}
    n_batches = max(1, pairs // batch)
    for i in range(n_batches):
        d_np, T_gt = make_pair_batch(rng, batch, shape["N"], shape["C"])
        d = {k: torch.from_numpy(v).to(device) for k, v in d_np.items()}
        t0 = time.perf_counter()
        for name, fn in routes.items():
            out = pair_rows(*fn(d, batch_generator(device, i)), T_gt)
            for k, v in out.items():
                rows[name][k].append(v)
        if verbose:
            print(f"batch {i + 1}/{n_batches}  ({time.perf_counter() - t0:.1f}s)", flush=True)
    return rows


def summarize(rows: dict, shape: dict, names=ROUTES) -> dict:
    """The JAX tool's stats dict: ``shape``, each route's validity share and
    error medians / 90th percentiles and median confidence, and ``paired``:
    per-pair deltas of ``names[1]`` against ``names[0]`` where both are
    valid."""
    st = {}
    raw = {name: {k: np.concatenate(v).ravel() for k, v in rows[name].items()} for name in names}
    for name in names:
        r = raw[name]
        st[name] = dict(
            valid_frac=float(r["valid"].mean()),
            R_err_med=float(np.median(r["R_err"])),
            R_err_p90=float(np.quantile(r["R_err"], 0.9)),
            t_err_med=float(np.median(r["t_err"])),
            t_err_p90=float(np.quantile(r["t_err"], 0.9)),
            conf_med=float(np.median(r["conf"])),
        )
    dv, fv = raw[names[0]], raw[names[1]]
    both = (dv["valid"] > 0) & (fv["valid"] > 0)
    rel_conf = np.abs(fv["conf"][both] - dv["conf"][both]) / np.maximum(dv["conf"][both], 1e-9)
    paired = dict(
        valid_agree_frac=float((dv["valid"] == fv["valid"]).mean()),
        dR_err_med=float(np.median(np.abs(fv["R_err"][both] - dv["R_err"][both]))),
        dt_err_med=float(np.median(np.abs(fv["t_err"][both] - dv["t_err"][both]))),
        rel_conf_delta_med=float(np.median(rel_conf)),
        conf_corr=float(np.corrcoef(dv["conf"][both], fv["conf"][both])[0, 1]),
        pairs=int(both.sum()),
    )
    return dict(shape=dict(shape), **{name: st[name] for name in names}, paired=paired)


def gate_failures(st: dict, names=ROUTES) -> list:
    """The JAX tool's gates on ``summarize``'s dict, ``names[0]`` the
    reference route; returns the gates missed."""
    d_, f_, paired = st[names[0]], st[names[1]], st["paired"]
    missed = []
    if paired["valid_agree_frac"] != 1.0:
        missed.append(f"valid_agree_frac {paired['valid_agree_frac']} != 1.0")
    tol_R = max(0.05, 0.25 * d_["R_err_med"])
    tol_t = max(0.005, 0.25 * d_["t_err_med"])
    if not abs(f_["R_err_med"] - d_["R_err_med"]) <= tol_R:
        missed.append(f"|R_err_med {f_['R_err_med']:.4f} - {d_['R_err_med']:.4f}| > {tol_R:.4f} deg")
    if not abs(f_["t_err_med"] - d_["t_err_med"]) <= tol_t:
        missed.append(f"|t_err_med {f_['t_err_med']:.5f} - {d_['t_err_med']:.5f}| > {tol_t:.5f} m")
    if not paired["rel_conf_delta_med"] <= 0.10:
        missed.append(f"rel_conf_delta_med {paired['rel_conf_delta_med']:.4f} > 0.10")
    return missed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true",
                    help="the JAX tool's tiny shape (N=96, P=64, L=8, budget 4 x 16 x 32) on the CPU's plain versions")
    ap.add_argument("--json", default="", help="write the stats dict to this path")
    args = ap.parse_args(argv)

    from mickey_tpu_torch import default_config

    cfg = default_config()
    device = "cpu" if args.cpu else args.device
    shape = gate_shape(cfg, tiny=args.cpu)
    rows = run_routes(shape, args.pairs, args.batch, 0, device, cfg, verbose=True)
    out = summarize(rows, shape)
    print(json.dumps(out, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    missed = gate_failures(out)
    print("GATE PASSED" if not missed else f"GATE FAILED: {missed}")
    return 1 if missed else 0


if __name__ == "__main__":
    raise SystemExit(main())
