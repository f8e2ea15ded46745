"""The port's training step against ``mickey_tpu``'s, step by step along the
JAX overfit tool's own trajectory (``tools/train_curve.py``, fmap mode).

``lockstep`` runs the JAX tool's loop as it is (its trainer, its jitted
``grad_step``, its key schedule and its draws) and feeds each step's loss
draws (idx, ridx) to the port's ``grad_step`` from the same initial weights,
and, where asked, to a twin of the JAX loop whose initial weights are
multiplied by (1 + eps N(0, 1)) leaf by leaf: the drift that fp32 rounding
alone gives the JAX loop, beside the port's drift from it.

One change to the draws: an inner minimal set that repeats a keypoint on
either side is redrawn among distinct keypoints (``well_posed_sets``, the
rule of ``tests/test_torch_training.py::inject_draws``). At the tool's size
the score head's 3-cell border leaves 6 keypoints an image with a nonzero
score, so most of the tool's minimal sets of 5 repeat one; their covariance
is rank deficient or nearly so, and the rotation that solves them is picked
by fp32 rounding, in either package. On such a set the two packages give two
equally valid rotations, and their losses part at the first step.

    python tests/test_torch_curve_lockstep.py [--steps 150] [--seed 0] [--twin-eps 1e-7] [--raw-sets] [--out f.json]

prints each step's loss and grad norm of the three loops and each eval
point's loss, median rotation error and VCRE under the JAX tool's eval (its
fixed key) on each loop's weights, and the gates of
``tests/test_convergence.py`` each loop misses. The test below holds the
first two steps.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

N_ROWS = 72  # keypoints an image at the tool's 126 x 112


def well_posed_sets(idx: np.ndarray, ridx: np.ndarray, n1: int = N_ROWS) -> np.ndarray:
    """``ridx`` (B, it, R_it, C) with every minimal set that repeats a
    keypoint of either image (``idx`` (B, it, S) flat pair indices over
    n0 x n1) redrawn among distinct keypoints, from a generator seeded by
    the set's place and draw, so that the same inputs give the same sets.
    A set that no draw of distinct keypoints can replace is kept."""
    idx, ridx = np.asarray(idx), np.array(ridx)
    B, it, R_it, C = ridx.shape
    for b in range(B):
        for i in range(it):
            rows_all, cols_all = idx[b, i] // n1, idx[b, i] % n1
            if min(len(set(rows_all)), len(set(cols_all))) < C:
                continue
            for r in range(R_it):
                sel = ridx[b, i, r]
                if len(set(rows_all[sel])) == C and len(set(cols_all[sel])) == C:
                    continue
                rng = np.random.default_rng([b, i, r, int(idx[b, i].astype(np.int64).sum())])
                for _ in range(1000):
                    chosen, rows, cols = [], set(), set()
                    for s in rng.permutation(idx.shape[-1]):
                        if rows_all[s] not in rows and cols_all[s] not in cols:
                            chosen.append(s)
                            rows.add(rows_all[s])
                            cols.add(cols_all[s])
                        if len(chosen) == C:
                            ridx[b, i, r] = chosen
                            break
                    if len(chosen) == C:
                        break
    return ridx.astype(np.int32)


class DrawTap:
    """Stands in for ``mickey_tpu.training.train_step.metric_pose_loss``:
    draws JAX's way (``metric_pose_loss``'s own sampling code on its key),
    makes the inner sets well posed (unless ``well_posed`` is False), and
    either records the draws of a
    training step (``force`` None) or replaces them by ``force``; then runs
    the loss with the draws as its ``sample_override``. Eval calls
    (``recording`` False) draw JAX's way and record nothing."""

    def __init__(self, loss_fn, well_posed: bool = True):
        self.loss_fn = loss_fn
        self.well_posed = well_posed
        self.force = None
        self.recording = True
        self.draws = []

    def _choose(self, idx, ridx):
        if self.force is not None:
            return tuple(np.asarray(x, np.int32) for x in self.force)
        out = (np.asarray(idx, np.int32), well_posed_sets(idx, ridx) if self.well_posed else np.asarray(ridx, np.int32))
        if self.recording:
            self.draws.append(out)
        return out

    def __call__(self, final_scores, kps0, depth0, kps1, depth1, K0, K1, K0ori, K1ori, Rgt, tgt, key, lc,
                 topk_pct, **kw):
        from mickey_tpu.ops.sampling import gumbel_topk_sample, gumbel_topk_sample_draws
        from mickey_tpu.training import loss as jloss

        B, N0, N1 = final_scores.shape
        it, R_it, S, C = lc.it_matches, lc.it_ransac, lc.num_samples_matches, lc.num_corr
        matches = jax.lax.stop_gradient(final_scores.reshape(B, N0 * N1))
        key_outer, key_inner = jax.random.split(key)
        if lc.prefilter and lc.prefilter < N0 * N1:
            top_scores, top_idx = jax.lax.approx_max_k(matches, lc.prefilter, recall_target=0.95)
            logw = jnp.where(top_scores > 0, jnp.log(jnp.maximum(top_scores, 1e-30)), jloss._NEG_INF)
            remap = top_idx.astype(jnp.int32)
        else:
            logw = jnp.where(matches > 0, jnp.log(jnp.maximum(matches, 1e-30)), jloss._NEG_INF)
            remap = None
        idx = jnp.moveaxis(gumbel_topk_sample_draws(key_outer, logw, S, it), 0, 1)
        if remap is not None:
            idx = jnp.take_along_axis(remap, idx.reshape(B, it * S), axis=1).reshape(B, it, S)
        weights = jloss._take(idx, matches[..., None])[..., 0]
        logw_in = jnp.where(weights > 0, jnp.log(jnp.maximum(weights, 1e-30)), jloss._NEG_INF)
        ridx = gumbel_topk_sample(key_inner, jnp.broadcast_to(logw_in[:, :, None, :], (B, it, R_it, S)), C)
        shapes = (jax.ShapeDtypeStruct(idx.shape, jnp.int32), jax.ShapeDtypeStruct(ridx.shape, jnp.int32))
        idx, ridx = jax.pure_callback(self._choose, shapes, idx.astype(jnp.int32), ridx.astype(jnp.int32))
        return self.loss_fn(final_scores, kps0, depth0, kps1, depth1, K0, K1, K0ori, K1ori, Rgt, tgt, key, lc,
                            topk_pct, sample_override=(idx, ridx), **kw)


def _perturbed(params, eps: float, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        if x.dtype != np.float32 or not eps:
            return jnp.asarray(x)
        return jnp.asarray((x * (1 + eps * rng.standard_normal(x.shape))).astype(np.float32))

    return jax.tree.map(leaf, params)


def lockstep(seed: int = 0, steps: int = 150, eval_every: int = 30, twin_eps: float = 0.0, log=None,
             out_dir: str = None, well_posed: bool = True) -> dict:
    """The JAX tool's fmap loop at ``seed`` (lr 4e-4), the port's step fed
    its draws, and (``twin_eps`` > 0) the perturbed JAX twin fed them too;
    ``well_posed`` False keeps the JAX loop's inner sets as drawn.
    Patches ``mickey_tpu.training.train_step.metric_pose_loss`` while it
    runs. Returns each step's (loss, grad norm) of each loop and each eval
    point's (loss, median R_err, median VCRE) under the JAX tool's eval."""
    import tempfile

    import mickey_tpu.models.training_model as jtm
    import mickey_tpu.training.train_step as jts
    import tools.train_curve as jax_tool
    import tools.train_curve_torch as tool
    from mickey_tpu_torch.models import MicKeyTrainer
    from mickey_tpu_torch.weights import params_to_numpy

    out_dir = out_dir or tempfile.mkdtemp(prefix="lockstep_")
    tap = DrawTap(jts.metric_pose_loss, well_posed)
    jts.metric_pose_loss = tap
    init = jtm.model_init
    try:
        cfg_j, cfg_t = jax_tool.overfit_cfg(), tool.overfit_cfg()
        B = cfg_j.TRAINING.BATCH_SIZE
        batch_np, fmap_np = jax_tool.geometric_fmap_batch(seed, B, cfg_j.DATASET.HEIGHT, cfg_j.DATASET.WIDTH,
                                                          cfg_j.MICKEY.DINOV2.CHANNEL_DIM)
        jax_loops = {"jax": jtm.MicKeyTrainer(cfg_j, out_dir=out_dir, seed=seed)}
        if twin_eps:
            jtm.model_init = lambda key, cfg, *a, **k: _perturbed(init(key, cfg, *a, **k), twin_eps, seed + 1)
            jax_loops["jax_twin"] = jtm.MicKeyTrainer(cfg_j, out_dir=out_dir, seed=seed)
            jtm.model_init = init
        start = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg_j))
        port = MicKeyTrainer(cfg_t, params=start, seed=seed, device="cpu", out_dir=out_dir)
        jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
        jf = jnp.asarray(fmap_np)
        tb = port.device_batch(batch_np, images=False)
        tf = torch.from_numpy(fmap_np)
        names = list(jax_loops) + ["port"]
        res = {"steps": {n: [] for n in names}, "eval": {n: [] for n in names}, "seed": seed, "twin_eps": twin_eps}

        def evaluate(step):
            tap.recording = False
            try:
                weights = {n: tr.state.params for n, tr in jax_loops.items()}
                weights["port"] = jax.tree.map(jnp.asarray, params_to_numpy(port.state.params))
                for n, p in weights.items():
                    o = {k: np.asarray(v) for k, v in jax_loops["jax"]._staged_val(p, jf, jb,
                                                                                   jax.random.PRNGKey(1234)).items()}
                    res["eval"][n].append((step, float(np.mean(o["loss"])), float(np.median(o["R_err"])),
                                           float(np.median(o["vcre"]))))
            finally:
                tap.recording = True
            if log:
                log(f"eval {step}: " + json.dumps({n: res["eval"][n][-1][1:] for n in names}))

        evaluate(0)
        key = jax.random.PRNGKey(seed + 1)  # MicKeyTrainer's
        t0 = time.time()
        for step in range(1, steps + 1):
            key, sk = jax.random.split(key)
            tap.draws.clear()
            tap.force = None
            tr = jax_loops["jax"]
            tr.state, m = tr.train_step.grad_step(tr.state, jf, jb, sk, jnp.float32(100.0))
            res["steps"]["jax"].append((float(m["loss"]), float(m["grad_norm"])))
            jax.effects_barrier()
            (draws,) = tap.draws
            if "jax_twin" in jax_loops:
                tap.force = draws
                tw = jax_loops["jax_twin"]
                tw.state, m = tw.train_step.grad_step(tw.state, jf, jb, sk, jnp.float32(100.0))
                res["steps"]["jax_twin"].append((float(m["loss"]), float(m["grad_norm"])))
                tap.force = None
            override = tuple(torch.from_numpy(x.astype(np.int64)) for x in draws)
            _, m = port.train_step.grad_step(port.state, tf, tb, None, 100.0, sample_override=override)
            res["steps"]["port"].append((float(m["loss"]), float(m["grad_norm"])))
            if log:
                ref = res["steps"]["jax"][-1]
                log(f"step {step:3d} " + "  ".join(
                    f"{n} loss {res['steps'][n][-1][0]:.6f} gnorm {res['steps'][n][-1][1]:.4f}"
                    + ("" if n == "jax" else f" (rel {abs(res['steps'][n][-1][1] - ref[1]) / abs(ref[1]):.2e})")
                    for n in names) + f"  ({time.time() - t0:.0f} s)")
            if step % eval_every == 0 or step == steps:
                evaluate(step)
        return res
    finally:
        jts.metric_pose_loss = tap.loss_fn
        jtm.model_init = init


def gates(eval_points) -> list:
    """``tests/test_convergence.py``'s three gates on one loop's eval
    points (step, loss, R_err, VCRE): the ones missed."""
    (_, l0, _, v0), (_, l1, r1, v1) = eval_points[0], eval_points[-1]
    missed = []
    if not l1 / l0 < 0.70:
        missed.append(f"eval_loss_ratio {l1 / l0:.4f}")
    if not v1 < 0.6 * v0:
        missed.append(f"final_vcre {v1:.3f} >= 0.6 x {v0:.3f}")
    if not r1 < 45.0:
        missed.append(f"final_R_err {r1:.3f}")
    return missed


def test_port_step_on_jax_draws_is_jax_step():
    """Two steps of the JAX tool's loop and the port's step on its draws
    (the inner sets well posed), from the same weights; the eval points of
    step 0 identical. Step 1: the loss at 1e-5 and the grad norm at 1e-4
    relative (measured 1.1e-7 and 1.5e-5). Step 2 at ten times those: the
    JAX loop itself moves its grad norm by 1.7e-4 at step 2 for weights
    changed by 1e-7 (``lockstep(twin_eps=1e-7)``; the port 1.8e-4, its loss
    7.3e-6)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = lockstep(seed=0, steps=2, eval_every=2)
    finally:
        torch.set_num_threads(threads)
    assert res["eval"]["port"][0] == res["eval"]["jax"][0]
    for scale, (lj, gj), (lt, gt) in zip((1, 10), res["steps"]["jax"], res["steps"]["port"]):
        assert np.isfinite([lj, gj, lt, gt]).all()
        assert abs(lt - lj) <= scale * 1e-5 * abs(lj), (lt, lj)
        assert abs(gt - gj) <= scale * 1e-4 * abs(gj), (gt, gj)


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--eval-every", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--twin-eps", type=float, default=1e-7)
    ap.add_argument("--threads", type=int, default=2, help="torch's intra-op threads")
    ap.add_argument("--raw-sets", action="store_true", help="keep the inner sets as the JAX loop drew them")
    ap.add_argument("--out", default=None, help="write the result as JSON here")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    res = lockstep(args.seed, args.steps, args.eval_every, args.twin_eps, log=lambda s: print(s, flush=True),
                   well_posed=not args.raw_sets)
    res["gates_missed"] = {n: gates(ev) for n, ev in res["eval"].items()}
    print("gates missed: " + json.dumps(res["gates_missed"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
