"""The port's route gate (``tools/fused_route_gate_torch.py``) against the JAX
tool it ports (``tools/fused_route_gate.py``), on the CPU at the JAX tool's
tiny shape (N = 96, P = 64, L = 8, RANSAC 4 x 16 x 32).

- ``make_pair_batch`` is the JAX tool's bit for bit.
- Each port route on one batch against the JAX tool's route (its jitted
  recipe, the Pallas matcher in interpret mode) with JAX's draws replayed
  from its key and injected, carried over by match index where near-tied
  table positions swap: R, t at 1e-4, confidence at 1e-4 relative, validity
  equal.
- The tool's ``--cpu`` run passes its gate, with the JAX tool's stats keys.
- The solver's distribution gate: over 64 tiny pairs, each port route under
  its own ``torch.Generator`` against the same JAX route under JAX's own
  keys, held to the JAX tool's three gates (``gate_failures``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.fused_route_gate as jax_tool
import tools.fused_route_gate_torch as tool
from mickey_tpu.config import default_config as jax_default_config
from mickey_tpu.metrics.pose_metrics import pose_error as jax_pose_error
from mickey_tpu.nn.matcher import dual_softmax as jax_dual_softmax
from mickey_tpu.nn.matcher import matcher_init
from mickey_tpu.ops.fused_matcher import fused_topk_scores as jax_fused_topk_scores
from mickey_tpu.ops.sampling import gumbel_topk_sample, gumbel_topk_sample_draws
from mickey_tpu.solver.procrustes_ransac import _log_weights
from mickey_tpu.solver.procrustes_ransac import estimate_pose as jax_estimate_pose
from mickey_tpu.solver.procrustes_ransac import estimate_pose_topk as jax_estimate_pose_topk
from mickey_tpu_torch import default_config
from mickey_tpu_torch.nn.matcher import match_scores
from mickey_tpu_torch.ops.fused_matcher import fused_topk_scores
from mickey_tpu_torch.solver import Draws

SHAPE = tool.gate_shape(default_config(), tiny=True)
KW = tool.solver_args(SHAPE)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: under the tier-1 run's test workers torch's
    OpenMP threads spin against each other's (``tests/test_torch_submission.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_routes():
    """The JAX tool's two jitted routes at its ``--cpu`` shape (its
    ``main``'s recipe: interpret-mode Pallas), each returning its top-P
    table beside the pose: (R, t, confidence, valid, top_scores, top_idx)."""
    cfg = jax_default_config()
    fm = cfg.FEATURE_MATCHER.DUAL_SOFTMAX
    mp = matcher_init(cfg)
    dustbin = mp.get("dustbin_score", jnp.float32(0.0))
    N, P, L = SHAPE["N"], SHAPE["P"], SHAPE["L"]

    @jax.jit
    def dense(key, d):
        scores = jax_dual_softmax(mp, d["dsc0"], d["dsc1"], cfg)
        final = scores * d["scr0"] * jnp.swapaxes(d["scr1"], 1, 2)
        est = jax_estimate_pose(key, final, d["kps0"], d["depth0"], d["kps1"], d["depth1"], d["K"], d["K"],
                                prefilter=P, **KW)
        ts, ti = jax.lax.approx_max_k(final.reshape(final.shape[0], -1), P, recall_target=0.95)
        return est.R, est.t, est.confidence, est.valid, ts, ti

    @jax.jit
    def fused(key, d):
        ts, ti, row_ok = jax_fused_topk_scores(d["dsc0"], d["dsc1"], d["scr0"][..., 0], d["scr1"][..., 0], dustbin, P,
                                               temperature=float(fm.TEMPERATURE), use_dustbin=bool(fm.USE_DUSTBIN),
                                               row_topl=L, interpret=True)
        est = jax_estimate_pose_topk(key, ts, ti, row_ok, d["kps0"], d["depth0"], d["kps1"], d["depth1"], d["K"],
                                     d["K"], n1=N, pallas_interpret=True, **KW)
        return est.R, est.t, est.confidence, est.valid, ts, ti

    return {"dense": dense, "fused": fused}


def _replay(key, top_scores) -> Draws:
    """The draws JAX's solver makes from ``key`` on a (B, P) table
    (``procrustes_ransac._solve_sampled``'s two levels), by JAX's samplers."""
    it, S, R, C = KW["it_matches"], KW["num_samples"], KW["it_ransac"], KW["num_corr"]
    w = jnp.asarray(top_scores, jnp.float32)
    k_outer, k_inner = jax.random.split(key)
    inner = jax.random.split(k_inner, it)
    outer = gumbel_topk_sample_draws(k_outer, _log_weights(w), S, it)
    ridx = [gumbel_topk_sample(inner[s], jnp.broadcast_to(_log_weights(jnp.take_along_axis(w, outer[s], 1))[:, None],
                                                          (w.shape[0], R, S)), C) for s in range(it)]
    return Draws(torch.from_numpy(np.array(outer)), torch.from_numpy(np.array(jnp.stack(ridx))))


def _remap(draws: Draws, jax_idx, our_idx) -> Draws:
    """Each drawn JAX table position replaced by the position of the same
    flat match index in the port's table (near-ties may sit in another order)."""
    jax_idx, our_idx, outer = np.asarray(jax_idx), np.asarray(our_idx), draws.outer_local.numpy()
    out = np.empty_like(outer)
    for b in range(outer.shape[1]):
        where = {int(m): p for p, m in enumerate(our_idx[b])}
        out[:, b] = [[where[int(jax_idx[b][p])] for p in row] for row in outer[:, b]]
    return Draws(torch.from_numpy(out), draws.ridx)


def _port_table(route: str, d: dict):
    """The port route's top-P match indices on the batch ``d`` (torch, CPU)."""
    cfg = default_config()
    fm = cfg.FEATURE_MATCHER.DUAL_SOFTMAX
    if route == "dense":
        final = match_scores({"dustbin_score": 1.0}, d["dsc0"], d["dsc1"], cfg) * d["scr0"] * d["scr1"].transpose(1, 2)
        return torch.topk(final.reshape(final.shape[0], -1), SHAPE["P"], dim=-1, sorted=True).indices
    return fused_topk_scores(d["dsc0"], d["dsc1"], d["scr0"][..., 0], d["scr1"][..., 0], 1.0, SHAPE["P"],
                             temperature=float(fm.TEMPERATURE), use_dustbin=bool(fm.USE_DUSTBIN),
                             row_topl=SHAPE["L"])[1]


@pytest.mark.parametrize("seed", [0, 5])
def test_make_pair_batch_is_the_jax_tools_bit_for_bit(seed):
    for B, N, C in ((2, 96, 128), (3, 40, 16)):
        (ours, T), (ref, T_ref) = (f.make_pair_batch(np.random.default_rng(seed), B, N, C) for f in (tool, jax_tool))
        assert ours.keys() == ref.keys() and T.dtype == T_ref.dtype and np.array_equal(T, T_ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


@pytest.mark.parametrize("route", ["dense", "fused"])
def test_routes_match_the_jax_tools_with_injected_draws(route, one_torch_thread):
    d_np, T_gt = tool.make_pair_batch(np.random.default_rng(3), 2, SHAPE["N"], SHAPE["C"])
    key = jax.random.PRNGKey(1000)
    R, t, conf, valid, ts, ti = _jax_routes()[route](key, {k: jnp.asarray(v) for k, v in d_np.items()})
    d = {k: torch.from_numpy(v) for k, v in d_np.items()}
    ours = _port_table(route, d)
    for b in range(2):  # the same matches; positions may differ among near-ties
        assert set(ours[b].tolist()) == set(np.asarray(ti[b]).tolist())
    draws = _remap(_replay(key, ts), ti, ours)
    out = tool.make_routes(default_config(), SHAPE)[route](d, None, draws=draws)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(valid))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(R), atol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(t), atol=1e-4)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(conf), rtol=1e-4, atol=1e-4)
    assert np.asarray(valid).all()
    # the planted pose is found by both (the angle's arccos is ill-conditioned this close to 0, so it is not
    # compared: R is, above)
    assert (tool.pair_rows(*out, T_gt)["R_err"] < 1.0).all()
    assert (np.asarray(jax_pose_error(R, t, jnp.asarray(T_gt))["R_err"]) < 1.0).all()


def test_cpu_gate_passes_with_the_jax_tools_stats_keys(tmp_path, monkeypatch, one_torch_thread):
    """The tool's ``--cpu`` run (64 pairs) passes, and its stats dict has the
    keys of the JAX tool's (whose ``--cpu`` run on one batch gives them)."""
    ours = tmp_path / "ours.json"
    assert tool.main(["--cpu", "--json", str(ours)]) == 0
    ref = tmp_path / "ref.json"
    monkeypatch.setattr("sys.argv", ["fused_route_gate.py", "--cpu", "--pairs", "8", "--report-only", "--json",
                                     str(ref)])
    jax_tool.main()
    ours, ref = json.loads(ours.read_text()), json.loads(ref.read_text())
    assert list(ours) == list(ref) == ["shape", "dense", "fused", "paired"]
    for k in ref:
        assert list(ours[k]) == list(ref[k]), k
    assert ours["shape"] == ref["shape"]
    assert ours["paired"]["valid_agree_frac"] == 1.0 and ours["paired"]["pairs"] == 64


def test_gate_failures_catch_each_gate():
    st = {"dense": dict(R_err_med=1.0, t_err_med=0.02), "fused": dict(R_err_med=1.1, t_err_med=0.021),
          "paired": dict(valid_agree_frac=1.0, rel_conf_delta_med=0.05)}
    assert tool.gate_failures(st) == []
    for part, change, what in (("paired", dict(valid_agree_frac=63 / 64), "valid_agree_frac"),
                               ("fused", dict(R_err_med=1.3), "R_err_med"), ("fused", dict(t_err_med=0.026), "t_err_med"),
                               ("paired", dict(rel_conf_delta_med=0.11), "rel_conf_delta_med")):
        missed = tool.gate_failures(dict(st, **{part: dict(st[part], **change)}))
        assert len(missed) == 1 and what in missed[0], missed
    # the floors: 0.05 deg and 5 mm where 25% of the reference's median is less
    small = dict(st, dense=dict(R_err_med=0.01, t_err_med=0.001), fused=dict(R_err_med=0.059, t_err_med=0.0059))
    assert tool.gate_failures(small) == []


@pytest.fixture(scope="module")
def jax_own_rows():
    """The JAX tool's two routes over its ``--cpu`` run's 64 pairs (8
    batches from ``default_rng(0)``), each batch under JAX's own key
    ``PRNGKey(1000 + i)``: per-pair rows as the port's tool makes them."""
    routes = _jax_routes()
    rng = np.random.default_rng(0)
    rows = {r: {k: [] for k in ("R_err", "t_err", "conf", "valid")} for r in routes}
    for i in range(8):
        d_np, T_gt = tool.make_pair_batch(rng, 8, SHAPE["N"], SHAPE["C"])
        d = {k: jnp.asarray(v) for k, v in d_np.items()}
        for name, fn in routes.items():
            R, t, conf, valid = (np.asarray(x) for x in fn(jax.random.PRNGKey(1000 + i), d)[:4])
            for k, v in tool.pair_rows(R, t, conf, valid, T_gt).items():
                rows[name][k].append(v)
    return rows


@pytest.mark.parametrize("route", ["dense", "fused"])
def test_distribution_gate_port_draws_against_jax_draws(route, jax_own_rows, one_torch_thread):
    """The solver's distribution gate: the port's route under its own
    generator against the JAX tool's under JAX's own keys, on the same 64
    pairs, held to the JAX tool's three gates."""
    ours = tool.run_routes(SHAPE, 64, 8, 0, "cpu", names=(route,))
    st = tool.summarize({"jax": jax_own_rows[route], "port": ours[route]}, SHAPE, names=("jax", "port"))
    assert st["paired"]["pairs"] == 64
    assert tool.gate_failures(st, names=("jax", "port")) == [], st
