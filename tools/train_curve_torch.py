"""The overfit proxy on the PyTorch port: ``tools/train_curve.py``'s curve,
run by ``mickey_tpu_torch`` (numpy, torch and the port only).

The composed training step (the staged step's heads, matcher, REINFORCE
pose loss, clip + Adam + the non-finite skip, BatchNorm stats threading)
overfits a geometrically consistent synthetic scene in feature-map space
(``geometric_fmap_batch``: image1's feature map is a pose-warp of image0's),
and the inference solver's pose and VCRE errors on the same pairs must fall
with the loss. Only the ``"fmap"`` mode of the JAX tool is ported, the mode
its test (``tests/test_convergence.py``) and its committed artifact use:
each step is ``MicKeyTrainer.train_step.grad_step`` on that map, each eval
point ``ValStep.tail`` with a generator seeded anew with ``EVAL_SEED``, the
counterpart of the JAX tool's fixed ``PRNGKey(1234)``.

    python tools/train_curve_torch.py [--steps 150] [--eval-every 30] [--lr 4e-4] [--heads-bf16] [--device cuda]

prints the curve's summary and, with ``--out``, writes the curve as JSON.
With ``--seed-set`` it runs the curves at ``CURVE_SEEDS`` instead, holds
their medians to the seed-set gate and exits 1 where they miss it (a planted
control, such as ``--lr 1e-4``, shows what the gate can see).
``chip_smoke.py --curve`` runs it on the card at the seeds ``CURVE_SEEDS``
in fp32 and under ``TPU.HEADS_BF16`` and holds each mode's seed set to the
seed-set gate (``seed_set_report``), whose thresholds ``SEED_GATE`` follow
from ``mickey_tpu``'s own curves at the same seeds
(``train_curve_reference_seeds.json``); the convergence test's three gates
(``gate_failures``) are reported per curve.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EVAL_SEED = 1234


def overfit_cfg(lr: float = 4e-4):
    """The JAX tool's ``overfit_cfg`` on the port's config: the production
    structure scaled down (ViT-S-width features, narrow heads, a small loss
    and solver budget), the sigmoid depth head, StepLR 0.5x every 40 steps,
    no curriculum. ``tools/train_curve.py::overfit_cfg`` says why each."""
    from mickey_tpu_torch.config import default_config

    cfg = default_config()
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.DINOV2.FLOAT16 = False
    cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 128, 8]
    cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
    cfg.MICKEY.KP_HEADS.USE_DEPTHSIGMOID = True
    cfg.MICKEY.KP_HEADS.MAX_DEPTH = 8
    cfg.DATASET.WIDTH = 112
    cfg.DATASET.HEIGHT = 126
    cfg.TRAINING.BATCH_SIZE = 8
    cfg.TRAINING.LR = lr
    cfg.TRAINING.LR_STEP_INTERVAL = 40
    cfg.TRAINING.LR_STEP_GAMMA = 0.5
    cfg.LOSS_CLASS.CURRICULUM_LEARNING.TRAIN_CURRICULUM = False
    cfg.LOSS_CLASS.CURRICULUM_LEARNING.TRAIN_WITH_TOPK = False
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    gh.IT_MATCHES = 2
    gh.IT_RANSAC = 4
    gh.NUM_CORR_3d3d = 5
    gh.NUM_REF_STEPS = 1
    cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES = 24
    cfg.PROCRUSTES.IT_MATCHES = 2
    cfg.PROCRUSTES.IT_RANSAC = 4
    cfg.PROCRUSTES.NUM_SAMPLED_MATCHES = 12
    cfg.PROCRUSTES.NUM_CORR_3D_3D = 3
    cfg.PROCRUSTES.NUM_REFINEMENTS = 1
    return cfg


def fixed_batch(seed: int = 0, B: int = 8, H: int = 126, W: int = 112):
    """The JAX tool's ``fixed_batch``: B pairs of random images and random
    (R, t) ground truth, from numpy."""
    from mickey_tpu_torch.geometry.rotations import quat2mat

    rng = np.random.default_rng(seed)
    T = np.zeros((B, 4, 4), np.float32)
    for b in range(B):
        q = rng.normal(size=4)
        T[b, :3, :3] = quat2mat(q / np.linalg.norm(q))
        T[b, :3, 3] = rng.normal(size=3) * 0.3
        T[b, 3, 3] = 1
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 100
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2, H / 2, 1
    return {
        "image0": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        "image1": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        "T_0to1": T,
        "K_color0": K,
        "K_color1": K,
        "Kori_color0": K,
        "Kori_color1": K,
    }


def _axis_angle_R(rng, max_deg: float) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = np.deg2rad(rng.uniform(-max_deg, max_deg))
    kx, ky, kz = axis
    Kx = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * (Kx @ Kx)


def geometric_fmap_batch(seed: int, B: int, H: int, W: int, C: int, down: int = 14, ident_noise: float = 1.0):
    """The JAX tool's ``geometric_fmap_batch``, bit for bit: per pair a
    random pose (within 8 degrees, t ~ 0.2 N(0, 1)), image0's patches with
    random depths and identity features, each warped into image1's cell
    that its projection lands in (the nearest to the cell centre wins), the
    geometry (marker, depth, sub-cell offset) in the first 4 channels and
    N(0, ``ident_noise``) on image1's identities.

    Returns (batch without images, fmap (2B, H/down, W/down, C), image0's
    maps first)."""
    rng = np.random.default_rng(seed)
    hp, wp = H // down, W // down
    fx = fy = 100.0
    cx, cy = W / 2.0, H / 2.0

    T = np.zeros((B, 4, 4), np.float32)
    fmap0 = np.zeros((B, hp, wp, C), np.float32)
    fmap1 = np.zeros((B, hp, wp, C), np.float32)
    for b in range(B):
        R = _axis_angle_R(rng, max_deg=8.0)
        t = rng.normal(size=3) * 0.2
        T[b, :3, :3] = R
        T[b, :3, 3] = t
        T[b, 3, 3] = 1.0

        ident = rng.normal(size=(hp, wp, C)).astype(np.float32)
        d0 = rng.uniform(2.0, 5.0, size=(hp, wp))

        fmap0[b] = ident
        fmap0[b, :, :, 0] = -1.0
        fmap0[b, :, :, 1] = d0 - 3.5
        fmap0[b, :, :, 2] = 0.0
        fmap0[b, :, :, 3] = 0.0

        ii, jj = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")
        u = (jj + 0.5) * down
        v = (ii + 0.5) * down
        X = np.stack([(u - cx) / fx * d0, (v - cy) / fy * d0, d0], axis=-1)
        Y = X @ R.T + t
        z1 = Y[..., 2]
        pu = fx * Y[..., 0] / z1 + cx
        pv = fy * Y[..., 1] / z1 + cy
        j1 = np.floor(pu / down).astype(int)
        i1 = np.floor(pv / down).astype(int)
        ok = (z1 > 0.2) & (i1 >= 0) & (i1 < hp) & (j1 >= 0) & (j1 < wp)

        bg = rng.normal(size=(hp, wp, C)).astype(np.float32)
        bg[:, :, 0] = 1.0
        bg[:, :, 1] = rng.uniform(2.0, 5.0, size=(hp, wp)) - 3.5
        bg[:, :, 2:4] = 0.0
        fmap1[b] = bg

        cell_du = pu / down - (j1 + 0.5)
        cell_dv = pv / down - (i1 + 0.5)
        dist = cell_du**2 + cell_dv**2
        order = np.argsort(dist.ravel())[::-1]  # worst first, best overwrite
        for flat in order:
            si, sj = np.unravel_index(flat, (hp, wp))
            if not ok[si, sj]:
                continue
            ti, tj = i1[si, sj], j1[si, sj]
            fmap1[b, ti, tj] = ident[si, sj]
            if ident_noise:
                fmap1[b, ti, tj, 4:] += ident_noise * rng.normal(size=C - 4)
            fmap1[b, ti, tj, 0] = 1.0
            fmap1[b, ti, tj, 1] = z1[si, sj] - 3.5
            fmap1[b, ti, tj, 2] = pu[si, sj] / down - tj - 0.5
            fmap1[b, ti, tj, 3] = pv[si, sj] / down - ti - 0.5

    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1] = fx, fy
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = cx, cy, 1.0
    batch = {"T_0to1": T, "K_color0": K, "K_color1": K, "Kori_color0": K, "Kori_color1": K}
    return batch, np.concatenate([fmap0, fmap1], axis=0)


def apply_updates(cfg, cfg_update) -> None:
    """Dotted-path overrides, e.g. ``{"TPU.HEADS_BF16": True}``."""
    for path, val in (cfg_update or {}).items():
        node = cfg
        *heads, leaf = path.split(".")
        for h in heads:
            node = getattr(node, h)
        setattr(node, leaf, val)


def run_curve(steps: int = 300, eval_every: int = 25, seed: int = 0, lr: float = 4e-4, cfg_update=None,
              device="cuda", verbose: bool = False, step_hook=None, params=None) -> dict:
    """The ``"fmap"`` overfit loop on ``device``; returns the JAX tool's
    curve (``steps``, ``loss``, ``grad_norm``, ``grads_finite``, ``eval``
    and the summary keys) plus ``heads_bf16`` (whether the heads' convs ran
    in bf16 on ``device``) and ``device``. The weights are ``params``
    (``mickey_tpu``'s layout) or the trainer's ``init_params_numpy(cfg,
    seed)``. ``step_hook(step, metrics)``, if given, sees every step's
    metrics tensors before they are read."""
    import torch

    from mickey_tpu_torch.models import MicKeyTrainer
    from mickey_tpu_torch.nn.heads import heads_conv_dtype

    cfg = overfit_cfg(lr=lr)
    apply_updates(cfg, cfg_update)
    B = cfg.TRAINING.BATCH_SIZE
    device = torch.device(device)
    batch_np, fmap_np = geometric_fmap_batch(seed=seed, B=B, H=cfg.DATASET.HEIGHT, W=cfg.DATASET.WIDTH,
                                             C=cfg.MICKEY.DINOV2.CHANNEL_DIM, down=cfg.MICKEY.DINOV2.DOWN_FACTOR)
    # the loop writes no checkpoint: out_dir is never made
    trainer = MicKeyTrainer(cfg, params=params, seed=seed, device=device,
                            out_dir=os.path.join(tempfile.gettempdir(), "unused"))
    batch = trainer.device_batch(batch_np, images=False)
    fmap = torch.from_numpy(fmap_np).to(device)

    def eval_point():
        gen = torch.Generator(device=device).manual_seed(EVAL_SEED)
        out = trainer.val_step.tail(trainer.state.params, fmap, batch, generator=gen)
        out = {k: v.detach().cpu().numpy() for k, v in out.items()}
        return {"loss": float(np.mean(out["loss"])), "R_err_med": float(np.median(out["R_err"])),
                "t_err_med": float(np.median(out["t_err_euc"])), "vcre_med": float(np.median(out["vcre"]))}

    curve = {"steps": [], "loss": [], "grad_norm": [], "grads_finite": [],
             "eval": {"step": [], "loss": [], "R_err_med": [], "t_err_med": [], "vcre_med": []}}

    def record(step):
        ev = eval_point()
        curve["eval"]["step"].append(step)
        for k, v in ev.items():
            curve["eval"][k].append(v)
        return ev

    t0 = time.time()
    record(0)
    for step in range(1, steps + 1):
        _, m = trainer.train_step.grad_step(trainer.state, fmap, batch, trainer.generator, 100.0)
        if step_hook is not None:
            step_hook(step, m)
        curve["steps"].append(step)
        curve["loss"].append(float(m["loss"]))
        curve["grad_norm"].append(float(m["grad_norm"]))
        curve["grads_finite"].append(bool(m["grads_finite"]))
        if step % eval_every == 0 or step == steps:
            ev = record(step)
            if verbose:
                print(f"step {step:4d}  loss {curve['loss'][-1]:.4f}  val_loss {ev['loss']:.4f}  "
                      f"R_err {ev['R_err_med']:.2f}deg  t_err {ev['t_err_med']:.3f}m  vcre {ev['vcre_med']:.1f}px  "
                      f"({time.time() - t0:.0f}s)", flush=True)
    w = max(1, steps // 10)
    ev = curve["eval"]
    head, tail = float(ev["loss"][0]), float(np.mean(curve["loss"][-w:]))
    eval_head, eval_tail = float(ev["loss"][0]), float(ev["loss"][-1])
    curve.update(
        initial_loss=head,
        final_loss=tail,
        loss_ratio=tail / head if head else float("nan"),
        initial_eval_loss=eval_head,
        final_eval_loss=eval_tail,
        eval_loss_ratio=eval_tail / eval_head if eval_head else float("nan"),
        initial_train_loss_window=float(np.mean(curve["loss"][:w])),
        train_fused_topk=bool(cfg.TPU.get("TRAIN_FUSED_TOPK", False)),
        initial_R_err=ev["R_err_med"][0],
        final_R_err=ev["R_err_med"][-1],
        initial_vcre=ev["vcre_med"][0],
        final_vcre=ev["vcre_med"][-1],
        steps_run=steps,
        mode="fmap",
        lr=lr,
        seed=seed,
        batch_size=B,
        wall_s=round(time.time() - t0, 1),
        heads_bf16=heads_conv_dtype(cfg, device) == torch.bfloat16,
        device=str(device),
    )
    return curve


def require_finite(step: int, metrics: dict) -> None:
    """A ``step_hook`` that raises where a step's loss, grad norm or
    gradients are not finite."""
    import torch

    if not (torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
            and bool(metrics["grads_finite"])):
        raise FloatingPointError(f"step {step}: loss {float(metrics['loss'])}, grad norm "
                                 f"{float(metrics['grad_norm'])}, gradients finite {bool(metrics['grads_finite'])}")


def _curve_process(kwargs: dict) -> tuple:
    """``run_curve(**kwargs)`` with ``require_finite`` in a process of its
    own, on one intra-op thread (the curves share the host's cores); returns
    (the curve, the kernels it launched)."""
    import torch

    from mickey_tpu_torch.ops import _cuda

    torch.set_num_threads(1)
    before = dict(_cuda.LAUNCHES)
    curve = run_curve(**kwargs, step_hook=require_finite)
    return curve, {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}


def run_curves(updates: dict, steps: int, eval_every: int, seeds, lr: float = 4e-4, device="cuda") -> dict:
    """(name, seed) -> (curve, kernels launched) for each named ``cfg_update``
    of ``updates`` at each of ``seeds``, every curve in a process of its
    own, one a core at once: a curve's small steps are bound by its host
    thread, not by the device. On a card the kernels are built here first,
    once, not by each process."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch

    if torch.device(device).type == "cuda":
        from mickey_tpu_torch.ops import _cuda

        _cuda.build()
    jobs = [(name, seed) for name in updates for seed in seeds]
    with ProcessPoolExecutor(min(len(jobs), os.cpu_count() or 1), mp_context=mp.get_context("spawn")) as pool:
        futures = {(name, seed): pool.submit(_curve_process, dict(steps=steps, eval_every=eval_every, seed=seed,
                                                                  lr=lr, cfg_update=updates[name],
                                                                  device=str(device)))
                   for name, seed in jobs}
        return {job: f.result() for job, f in futures.items()}


# tests/test_convergence.py's three gates on one curve
CURVE_GATES = ("eval_loss_ratio < 0.70", "final_vcre < 0.6 x initial", "final_R_err < 45 deg")


def curve_gates(curve: dict) -> dict:
    """``CURVE_GATES`` -> whether ``curve`` meets each."""
    met = (curve["eval_loss_ratio"] < 0.70, curve["final_vcre"] < 0.6 * curve["initial_vcre"],
           curve["final_R_err"] < 45.0)
    return dict(zip(CURVE_GATES, met))


def gate_failures(curve: dict) -> list:
    """``tests/test_convergence.py``'s three gates on a curve: the eval loss
    ratio below 0.70, the final median VCRE below 0.6 of the initial, the
    final median rotation error below 45 degrees. Returns the gates missed.
    At one seed they are a draw: ``mickey_tpu``'s own curves meet all three
    at one of the seeds 0-7 under one XLA thread (``REFERENCE_SEEDS``)."""
    met = curve_gates(curve)
    missed = []
    if not met[CURVE_GATES[0]]:
        missed.append(f"eval_loss_ratio {curve['eval_loss_ratio']:.4f} >= 0.70")
    if not met[CURVE_GATES[1]]:
        missed.append(f"final_vcre {curve['final_vcre']:.3f} >= 0.6 x initial {curve['initial_vcre']:.3f}")
    if not met[CURVE_GATES[2]]:
        missed.append(f"final_R_err {curve['final_R_err']:.3f} >= 45 deg")
    return missed


# -- the seed-set gate -----------------------------------------------------------------------

REFERENCE_SEEDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "train_curve_reference_seeds.json")
CURVE_SEEDS = tuple(range(8))  # the reference's seeds; the port's curves run at the same
SEED_METRICS = ("eval_loss_ratio", "vcre_ratio", "final_R_err")
# The seed-set gate's thresholds, fixed from mickey_tpu's own curves at
# CURVE_SEEDS (REFERENCE_SEEDS: tools/train_curve.py, 150 steps, eval every
# 30, lr 4e-4, one XLA thread a curve) by one rule, before any curve of the
# port was held to them: for each metric, the reference's median over its
# seeds plus half its inter-quartile range (numpy's linear percentiles;
# ``seed_gate_thresholds``). A mode passes where the median of each metric
# over its own seeds is at most the threshold: the reference's medians pass
# by half their IQR, and a set that does not learn (ratios 1.0, the
# zero-pose fallback's 120 deg) fails all three.
SEED_GATE = {
    "eval_loss_ratio": 0.8574496169801362,  # eval loss at the end / at step 0
    "vcre_ratio": 0.9094604753791038,  # median VCRE at the end / at step 0
    "final_R_err": 110.57200598716736,  # median rotation error at the end, degrees
}


def seed_metrics(curve: dict) -> dict:
    """``SEED_METRICS`` of one curve (or of a record of ``REFERENCE_SEEDS``)."""
    return {"eval_loss_ratio": float(curve["eval_loss_ratio"]),
            "vcre_ratio": float(curve["final_vcre"]) / float(curve["initial_vcre"]),
            "final_R_err": float(curve["final_R_err"])}


def seed_gate_thresholds(path: str = REFERENCE_SEEDS) -> dict:
    """``SEED_GATE``'s rule on the curves recorded at ``path``: each metric's
    median over the seeds plus half its inter-quartile range."""
    with open(path) as f:
        per = [seed_metrics(c) for c in json.load(f)["seeds"]]
    out = {}
    for m in SEED_METRICS:
        q1, med, q3 = np.percentile([p[m] for p in per], [25, 50, 75])
        out[m] = float(med + (q3 - q1) / 2)
    return out


def seed_set_report(curves) -> dict:
    """A seed set of curves against ``SEED_GATE``: each metric's median over
    the set, the thresholds, the gates missed (``missed``, empty where the
    set passes), and how many curves meet each of ``CURVE_GATES``."""
    per = [seed_metrics(c) for c in curves]
    med = {m: float(np.median([p[m] for p in per])) for m in SEED_METRICS}
    return {
        "seeds": [c.get("seed") for c in curves],
        "medians": med,
        "thresholds": dict(SEED_GATE),
        "missed": [f"median {m} {med[m]:.4f} > {SEED_GATE[m]:.4f}" for m in SEED_METRICS
                   if not med[m] <= SEED_GATE[m]],
        "curve_gates_met": {g: sum(curve_gates(c)[g] for c in curves) for g in CURVE_GATES},
        "curves": len(per),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--eval-every", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--heads-bf16", action="store_true", help="TPU.HEADS_BF16 (and HEADS_BF16_ON_CPU on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed-set", action="store_true",
                    help="run the curves at CURVE_SEEDS in place of --seed, each in a process of its own, hold their "
                         "medians to SEED_GATE and exit 1 where they miss it")
    ap.add_argument("--out", default=None, help="write the curve (the seed set's report and curves) as JSON here")
    args = ap.parse_args(argv)
    update = {"TPU.HEADS_BF16": True, "TPU.HEADS_BF16_ON_CPU": True} if args.heads_bf16 else None
    if args.seed_set:
        runs = run_curves({"curve": update}, args.steps, args.eval_every, CURVE_SEEDS, args.lr, args.device)
        curves = [runs[("curve", s)][0] for s in CURVE_SEEDS]
        report = dict(seed_set_report(curves), lr=args.lr, heads_bf16=[c["heads_bf16"] for c in curves],
                      per_seed={c["seed"]: dict(seed_metrics(c), wall_s=c["wall_s"]) for c in curves})
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"report": report, "curves": curves}, f, indent=1)
        print(json.dumps(report))
        print("SEED-SET GATE PASSED" if not report["missed"] else f"SEED-SET GATE MISSED: {report['missed']}")
        return 1 if report["missed"] else 0
    curve = run_curve(args.steps, args.eval_every, args.seed, args.lr, update, args.device, verbose=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(curve, f, indent=1)
    print(f"eval loss {curve['initial_eval_loss']:.4f} -> {curve['final_eval_loss']:.4f} "
          f"(ratio {curve['eval_loss_ratio']:.3f}); R_err {curve['initial_R_err']:.2f} -> {curve['final_R_err']:.2f} "
          f"deg; vcre {curve['initial_vcre']:.1f} -> {curve['final_vcre']:.1f} px; heads_bf16 {curve['heads_bf16']}; "
          f"gates missed: {gate_failures(curve) or 'none'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
