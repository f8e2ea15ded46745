"""The ranking gate: pose precision and AUC over the confidence ranking, the
port against ``mickey_tpu``, on the CPU at the route gate's tiny shape
(``tests/test_torch_route_gate.py``: N = 96, P = 64, L = 8, RANSAC 4 x 16 x 32).

Map-free ranks submissions by these numbers, and the trainer's validation
computes them (``mickey_tpu/models/training_model.py:303-311``): per pair,
a hit where the translation error is under 25 cm and the rotation error under
5 deg (and under 50 cm / 10 deg); the precision is the share of hits, the AUC
the average precision of the hits ranked by the solver's confidence, each
package through its own ``pose_error`` and ``precision_recall``
(``mickey_tpu/evaluation/pose_io.py:192``,
``mickey_tpu_torch/evaluation/pose_io.py:193``).

Pairs: 64 planted pairs of ``make_pair_batch`` (bit for bit the JAX
tool's), in batches of 8 from ``default_rng(0)``, one batch for each
(inlier fraction, depth noise) of ``SWEEP``: at 2 cm of depth noise a solve
is exact or lost, at 30-40 cm some poses land between the two thresholds,
so both threshold pairs measure something and the ranking matters. Each port
route runs under its own ``torch.Generator`` (seed 1000 + the batch's
index), each JAX route under JAX's own keys (``PRNGKey(1000 + i)``).

The tolerance ``TOL`` was fixed from JAX against JAX before any port run on
this sweep: the JAX routes under eight key streams ``PRNGKey(s * 1000 + i)``,
s = 1 .. 8, the largest difference between any two streams over both routes
and the four numbers (floored at two pairs of 64), rounded up. Command and
its output (on the CPU; both JAX routes gave the same numbers under each
stream, so one line a stream):

    python tests/test_torch_ranking_gate.py
    keys 1000: prec_pose 0.468750, auc_pose 0.814854, prec_pose_10 0.546875, auc_pose_10 0.855304
    keys 2000: prec_pose 0.421875, auc_pose 0.764021, prec_pose_10 0.578125, auc_pose_10 0.869878
    keys 3000: prec_pose 0.437500, auc_pose 0.787273, prec_pose_10 0.531250, auc_pose_10 0.844625
    keys 4000: prec_pose 0.453125, auc_pose 0.792332, prec_pose_10 0.593750, auc_pose_10 0.878845
    keys 5000: prec_pose 0.468750, auc_pose 0.812298, prec_pose_10 0.578125, auc_pose_10 0.877598
    keys 6000: prec_pose 0.484375, auc_pose 0.828694, prec_pose_10 0.578125, auc_pose_10 0.882181
    keys 7000: prec_pose 0.406250, auc_pose 0.750214, prec_pose_10 0.515625, auc_pose_10 0.837692
    keys 8000: prec_pose 0.406250, auc_pose 0.767598, prec_pose_10 0.546875, auc_pose_10 0.852635
    max_delta 0.07848042485496753 (auc_pose, keys 6000 against 7000) -> TOL 0.0785

The precision alone spreads by 5 pairs of 64 (0.078125) over the streams.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import tools.fused_route_gate_torch as tool  # noqa: E402
from mickey_tpu.evaluation.pose_io import precision_recall as jax_precision_recall  # noqa: E402
from mickey_tpu.metrics.pose_metrics import pose_error as jax_pose_error  # noqa: E402
from mickey_tpu_torch.evaluation.pose_io import precision_recall  # noqa: E402
from test_torch_route_gate import SHAPE, _jax_routes, one_torch_thread  # noqa: E402, F401 (fixture)

# (inlier fraction, depth noise in m) of batch 0, 1, ...: the first four
# solve exactly or fail, the last four land some poses between the two
# thresholds (near misses that the second pair counts and the first does not)
SWEEP = ((0.5, 0.02), (0.2, 0.02), (0.1, 0.02), (0.05, 0.02), (0.5, 0.4), (0.2, 0.4), (0.2, 0.3), (0.1, 0.3))
BATCH = 8
PAIRS = BATCH * len(SWEEP)
STREAMS = 8  # JAX key streams PRNGKey(s * 1000 + i), s = 1 .. 8, that fix TOL
THRESHOLDS = ((0.25, 5.0, ""), (0.5, 10.0, "_10"))  # (m, deg, the trainer's metric suffix)
TOL = 0.0785  # fixed from JAX against JAX over eight key streams (module docstring)


def pair_batches():
    """[(batch index, numpy batch, T_gt)]: 64 pairs, a batch for each entry
    of ``SWEEP``."""
    rng = np.random.default_rng(0)
    return [(i, *tool.make_pair_batch(rng, BATCH, SHAPE["N"], SHAPE["C"], inlier_frac=frac, depth_noise=noise))
            for i, (frac, noise) in enumerate(SWEEP)]


def ranking(R_err, t_err, conf, pr) -> dict:
    """The trainer's precision and AUC at both thresholds, ``pr`` the
    package's ``precision_recall``."""
    out = {}
    for t_th, r_th, tag in THRESHOLDS:
        ok = (t_err < t_th) & (R_err < r_th)
        out[f"prec_pose{tag}"] = float(ok.mean())
        out[f"auc_pose{tag}"] = float(pr(inliers=conf, tp=ok, failures=0)[2])
    return out


def jax_ranking(key_base: int = tool.KEY_BASE) -> dict:
    """route -> ``ranking`` of the JAX tool's route under ``PRNGKey(key_base + i)``,
    through ``mickey_tpu``'s ``pose_error`` and ``precision_recall``."""
    out = {}
    for name, fn in _jax_routes().items():
        cols = {"R_err": [], "t_err": [], "conf": []}
        for i, d_np, T_gt in pair_batches():
            R, t, conf, _ = fn(jax.random.PRNGKey(key_base + i), {k: jnp.asarray(v) for k, v in d_np.items()})[:4]
            err = jax_pose_error(R, t, jnp.asarray(T_gt))
            for k, v in (("R_err", err["R_err"]), ("t_err", err["t_err_euc"]), ("conf", conf)):
                cols[k].append(np.asarray(v).reshape(-1))
        out[name] = ranking(*(np.concatenate(cols[k]) for k in ("R_err", "t_err", "conf")), jax_precision_recall)
    return out


def port_ranking(name: str) -> dict:
    """``ranking`` of the port's route under its own generators, through the
    port's ``pose_error`` (``tool.pair_rows``) and ``precision_recall``."""
    from mickey_tpu_torch import default_config

    fn = tool.make_routes(default_config(), SHAPE)[name]
    cols = {"R_err": [], "t_err": [], "conf": []}
    for i, d_np, T_gt in pair_batches():
        rows = tool.pair_rows(*fn({k: torch.from_numpy(v) for k, v in d_np.items()}, tool.batch_generator("cpu", i)),
                              T_gt)
        for k in cols:
            cols[k].append(rows[k].reshape(-1))
    return ranking(*(np.concatenate(cols[k]) for k in ("R_err", "t_err", "conf")), precision_recall)


@pytest.fixture(scope="module")
def jax_own():
    return jax_ranking()


def test_the_sweep_makes_the_ranking_matter(jax_own):
    """JAX's own precision lies inside (0.2, 0.9) on both routes: some solves
    fail, so the confidence ranking decides the AUC; and the looser pair
    counts near misses that the tighter one does not."""
    for name, m in jax_own.items():
        assert 0.2 < m["prec_pose"] < 0.9, (name, m)
        assert 0.2 < m["prec_pose_10"] < 0.9, (name, m)
        assert m["prec_pose_10"] - m["prec_pose"] >= 4 / PAIRS, (name, m)


@pytest.mark.parametrize("route", ["dense", "fused"])
def test_precision_and_auc_port_against_jax(route, jax_own, one_torch_thread):
    ours = port_ranking(route)
    assert ours.keys() == jax_own[route].keys()
    for k, v in jax_own[route].items():
        assert abs(ours[k] - v) <= TOL, (route, k, ours[k], v, TOL)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    runs = {s * tool.KEY_BASE: jax_ranking(s * tool.KEY_BASE) for s in range(1, STREAMS + 1)}
    for base, by_route in runs.items():
        for route, m in by_route.items():
            print(f"keys {base} {route}: " + ", ".join(f"{k} {v:.6f}" for k, v in m.items()))
    delta = max(abs(a[r][k] - b[r][k]) for a in runs.values() for b in runs.values() for r in a for k in a[r])
    print(f"max_delta {delta} -> TOL {max(delta, 2 / PAIRS)}, rounded up")
    sys.exit(0)
