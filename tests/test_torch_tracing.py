"""The port's spans and counters (``mickey_tpu_torch/tracing.py``) on the
CPU: off, they cost a shared no-op and record nothing; on, they nest with
their parents and requests, count where they are asked to, and change no
output of ``predict`` or of the staged training step, bit for bit. The
names the benchmark's harness hooks into stay reached through the module
globals and methods it wraps."""

import json

import numpy as np
import pytest
import torch

from mickey_tpu_torch import tracing
from mickey_tpu_torch.cli import submission
from mickey_tpu_torch.config import default_config
from mickey_tpu_torch.models import build_model
from mickey_tpu_torch.models import relative_pose
from mickey_tpu_torch.nn import dinov2
from mickey_tpu_torch.ops import _cuda, fused_matcher
from mickey_tpu_torch.solver import procrustes_ransac
from mickey_tpu_torch.training import loss as tloss
from mickey_tpu_torch.training import train_step
from mickey_tpu_torch.training.train_step import StagedTrainStep, init_train_state
from mickey_tpu_torch.weights import init_params_numpy, params_to_torch, tree_leaves

H, W = 126, 112  # 9 x 8 patches


@pytest.fixture(autouse=True)
def fresh_tracing():
    """Each test starts and ends with tracing off and no records."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run keeps several workers on the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Annotations:
    """``torch.profiler.record_function`` as the spans call it, the names kept."""

    def __init__(self, monkeypatch, fail=False):
        self.names = []
        real = torch.profiler.record_function

        def record_function(name, *a, **k):
            if fail:
                raise AssertionError(f"record_function({name!r}) while tracing is off")
            self.names.append(name)
            return real(name, *a, **k)

        monkeypatch.setattr(torch.profiler, "record_function", record_function)


def tiny_cfg():
    cfg = default_config()
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.DINOV2.FLOAT16 = False
    cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 128, 8]
    cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
    cfg.PROCRUSTES.IT_MATCHES = 2
    cfg.PROCRUSTES.IT_RANSAC = 8
    cfg.PROCRUSTES.NUM_SAMPLED_MATCHES = 12
    cfg.PROCRUSTES.NUM_REFINEMENTS = 1
    gh = cfg.LOSS_CLASS.GENERATE_HYPOTHESES
    gh.IT_MATCHES, gh.IT_RANSAC, gh.NUM_CORR_3d3d, gh.NUM_REF_STEPS = 2, 3, 5, 1
    cfg.LOSS_CLASS.SAMPLER.NUM_SAMPLES_MATCHES = 16
    return cfg


@pytest.fixture(scope="module")
def model():
    return build_model(tiny_cfg(), device="cpu")


def intrinsics(b):
    K = np.zeros((b, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 100.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2, H / 2, 1.0
    return K


def batches():
    """Three batches of two pairs over two scenes of three queries each: the
    middle batch spans both scenes. Keyframes per batch: {a} missing,
    {a} held and {b} missing, {b} held."""
    rng = np.random.default_rng(5)
    kf = {s: rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for s in ("a", "b")}
    pairs = [(s, q) for s in ("a", "b") for q in range(3)]
    out = []
    for i in range(0, len(pairs), 2):
        chunk = pairs[i:i + 2]
        out.append({"image0": np.stack([kf[s] for s, _ in chunk]),
                    "image1": rng.integers(0, 256, (len(chunk), H, W, 3), dtype=np.uint8),
                    "K_color0": intrinsics(len(chunk)), "K_color1": intrinsics(len(chunk)),
                    "scene_id": [s for s, _ in chunk],
                    "pair_names": [("seq0/frame_00000.jpg", f"seq1/frame_{q:05d}.jpg") for _, q in chunk]})
    return out


def poses(results):
    return {scene: [(p.image_name, p.q, p.t, p.inliers) for p in ps] for scene, ps in results.items()}


def test_off_is_a_shared_noop(monkeypatch):
    Annotations(monkeypatch, fail=True)
    a, b = tracing.span("x", request=1), tracing.span("y", device=True)
    assert a is b is tracing._NOOP and not tracing.enabled()
    with a:
        tracing.count("n", 3)
        tracing.record("r", tracing.clock())
    assert tracing.clock() == 0
    assert tracing.take() == []


def test_off_allocates_nothing():
    """A disabled span, entered and left, a count, a clock read and a record,
    as the port's stages make them, a thousand times: no memory allocated a
    call (tracemalloc's peak moves by under a byte a call; enabled, a span
    takes hundreds)."""
    import tracemalloc

    def stage():
        with tracing.span("predict.stage", request=3):
            tracing.count("kf_hits", 1)
            tracing.record("predict.request", tracing.clock(), request=3)

    stage()
    tracemalloc.start()
    try:
        stage()
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in range(1000):
            stage()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak - before < 1000, peak - before


def test_spans_nest_count_and_take_the_launches(monkeypatch):
    notes = Annotations(monkeypatch)
    tracing.enable()
    before = dict(_cuda.LAUNCHES)
    try:
        with tracing.span("a", request=7):
            with tracing.span("b", device=True):
                tracing.count("n", 2)
                tracing.count("n")
                _cuda.LAUNCHES["pair_topk"] += 3
            with tracing.span("c", request=9):
                pass
            start = tracing.clock()
        tracing.count("outside")  # no span open: nowhere to add
        tracing.record("r", start, request=7)
    finally:
        _cuda.LAUNCHES.update(before)
    recs = tracing.take()
    assert [r.name for r in recs] == ["a", "b", "c", "r"]
    a, b, c, r = recs
    assert [x.parent for x in recs] == [None, a.id, a.id, None]
    assert [x.request for x in recs] == [7, 7, 9, 7]
    assert b.counters == {"n": 3, "launches": 3}
    assert a.counters == {"launches": 3} and c.counters == {"launches": 0} and r.counters == {}
    assert r.crossing and not (a.crossing or b.crossing or c.crossing)
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= c.end_ns <= a.end_ns <= r.end_ns
    assert b.device_ms is None  # no CUDA here: no device time
    assert notes.names == ["span:a", "span:b", "span:c"]
    assert tracing.take() == []
    tracing.disable()
    with tracing.span("d"):
        pass
    assert tracing.take() == []


def test_chrome_trace(tmp_path):
    with tracing.traced(tmp_path / "new" / "t.json"):
        with tracing.span("outer", request=0):
            with tracing.span("inner"):
                tracing.count("k", 2)
            start = tracing.clock()
        tracing.record("predict.request", start, request=0)
    assert not tracing.enabled() and tracing.take() == []
    events = json.loads((tmp_path / "new" / "t.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(spans) == {"outer", "inner", "predict.request"}
    assert spans["inner"]["args"]["k"] == 2 and spans["inner"]["args"]["parent"] == spans["outer"]["args"]["id"]
    assert spans["outer"]["ts"] <= spans["inner"]["ts"] <= spans["inner"]["ts"] + spans["inner"]["dur"]
    assert spans["outer"]["tid"] == spans["inner"]["tid"] != spans["predict.request"]["tid"]
    with tracing.traced(None):  # no path: nothing recorded
        with tracing.span("x"):
            pass
    assert not tracing.enabled() and tracing.take() == []


def test_predict_spans_and_poses(model, monkeypatch):
    """One ``predict.request`` a batch, drained in order; the keyframe
    counts as the scenes give them; the model's and the solver's stages
    under the batch's dispatch; the poses bitwise those with tracing off."""
    plain = poses(submission.predict(batches(), model, progress=False))
    tracing.enable()
    traced = poses(submission.predict(batches(), model, progress=False))
    tracing.disable()
    recs = tracing.take()
    assert traced.keys() == plain.keys()
    for scene in plain:
        for x, y in zip(plain[scene], traced[scene], strict=True):
            assert x[0] == y[0] and np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2]) and x[3] == y[3]

    by_id = {r.id: r for r in recs}
    named = lambda n: [r for r in recs if r.name == n]  # noqa: E731
    requests = named("predict.request")
    assert [r.request for r in requests] == [0, 1, 2] and all(r.parent is None for r in requests)
    for r, d in zip(requests, named("predict.drain"), strict=True):
        assert d.request == r.request and d.start_ns <= r.end_ns <= d.end_ns
    assert [r.request for r in named("predict.load")] == [0, 1, 2, 3]  # the last finds the loader done
    kf = named("predict.kf_cache")
    assert [(r.counters.get("kf_hits", 0), r.counters.get("kf_misses", 0)) for r in kf] == [(0, 1), (1, 1), (1, 0)]
    assert sum(r.counters.get("poses_skipped", 0) for r in named("predict.drain")) == \
        6 - sum(len(v) for v in traced.values())
    for r in named("model.backbone") + named("model.heads"):
        assert by_id[r.parent].name == "model.extract"
    extract_parents = [by_id[r.parent].name for r in named("model.extract")]
    assert extract_parents == ["predict.kf_cache", "predict.dispatch", "predict.kf_cache", "predict.dispatch",
                               "predict.dispatch"]
    for r in named("model.match") + named("model.estimate"):
        assert by_id[r.parent].name == "predict.dispatch"
    for n in ("solver.draws", "solver.hypotheses", "solver.refine"):
        assert [by_id[r.parent].name for r in named(n)] == ["model.estimate"] * 3
        assert [r.request for r in named(n)] == [0, 1, 2]
    assert all(r.counters["launches"] == 0 for r in recs if not r.crossing)  # no kernel on the CPU


def test_staged_step_spans_and_parameters():
    """The training step's phases, each with the step as its request, and
    the parameters after two steps bitwise those with tracing off."""
    cfg = tiny_cfg()
    params = init_params_numpy(cfg, 0)
    rng = np.random.default_rng(3)
    b = 2
    batch = {"image0": torch.from_numpy(rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)),
             "image1": torch.from_numpy(rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8))}
    K = torch.from_numpy(intrinsics(b))
    T = torch.eye(4).repeat(b, 1, 1)
    T[:, :3, 3] = torch.tensor([0.2, -0.1, 0.3])
    batch.update(T_0to1=T, K_color0=K, K_color1=K.clone(), Kori_color0=K.clone(), Kori_color1=K.clone())

    def run():
        state, backbone = init_train_state(cfg, params_to_torch(params, cfg, "cpu"))
        step, gen = StagedTrainStep(cfg), torch.Generator().manual_seed(1)
        for _ in range(2):
            step(state, backbone, batch, gen, 30.0)
        return [t.clone() for _, t in tree_leaves(state.params)]

    plain = run()
    tracing.enable()
    traced = run()
    tracing.disable()
    recs = tracing.take()
    assert all(torch.equal(x, y) for x, y in zip(plain, traced, strict=True))
    top = [(r.name, r.request) for r in recs if r.parent is None]
    assert top == [(n, s) for s in (0, 1)
                   for n in ("train.backbone", "train.forward", "train.backward", "train.optimizer")]
    assert len(recs) == len(top)


def test_harness_hooks_are_called_through(model, monkeypatch):
    """With tracing on, every name the benchmark's harness wraps is still
    looked up where it wraps it and called: a span must not hide one.
    (``fused_matcher.dual_softmax_bwd_sums``, K5, is reached only on the
    card: the CPU's training matcher is the plain dual softmax.)"""
    calls = {}

    def wrap(owner, attr, key):
        fn = getattr(owner, attr)

        def wrapper(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(owner, attr, wrapper)

    for owner, attr in ((relative_pose, "backbone_features"), (relative_pose, "heads_apply"),
                        (procrustes_ransac, "inlier_counting_3d"), (dinov2, "block_apply"),
                        (dinov2, "flash_attention_packed"), (fused_matcher, "pair_topk"),
                        (train_step, "loss_and_grads"),
                        (train_step, "metric_pose_loss"), (tloss, "inlier_counting_3d"),
                        (StagedTrainStep, "backbone_fwd"), (train_step.Optimizer, "update")):
        wrap(owner, attr, attr if owner is not tloss else "loss.inlier_counting_3d")
    for method in ("call_with_ref_feats", "extract_feats", "match_feats", "estimate"):
        wrap(model, method, "model." + method)

    tracing.enable()
    data = batches()
    submission.predict(data[:1], model, progress=False)
    cfg = tiny_cfg()
    state, backbone = init_train_state(cfg, params_to_torch(init_params_numpy(cfg, 0), cfg, "cpu"))
    K = torch.from_numpy(intrinsics(2))
    batch = {"image0": torch.from_numpy(data[0]["image0"]), "image1": torch.from_numpy(data[0]["image1"]),
             "T_0to1": torch.eye(4).repeat(2, 1, 1), "K_color0": K, "K_color1": K, "Kori_color0": K,
             "Kori_color1": K}
    StagedTrainStep(cfg)(state, backbone, batch, torch.Generator().manual_seed(0), 30.0)
    tracing.disable()

    depth = len(model.params["dinov2"]["blocks"])
    refinements = int(model.cfg.PROCRUSTES.NUM_REFINEMENTS)
    # one keyframe and one query extraction; one solve of refinements + 1 counts; then the step's backbone
    assert calls["backbone_features"] == calls["heads_apply"] == 2
    assert calls["inlier_counting_3d"] == refinements + 1
    assert calls["block_apply"] == 3 * depth and calls["flash_attention_packed"] == 3 * depth
    assert calls["pair_topk"] == 1
    for key in ("model.call_with_ref_feats", "model.match_feats", "model.estimate", "loss_and_grads",
                "metric_pose_loss", "backbone_fwd", "update", "loss.inlier_counting_3d"):
        assert calls.get(key, 0) >= 1, key
    assert calls["model.extract_feats"] == 2
