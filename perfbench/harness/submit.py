"""Runner of the Map-free submission traffic: ``cli.submission.predict``
(``shared_ref`` as the mix says) fed by an in-memory loader.

Set-up makes the weights and a pool of frames on the card from the seed,
then runs ``predict`` over a few batches that use every shape of the window
(a keyframe extraction of one image, a query batch). The window is one
``predict`` call: the loader hands over a batch whenever ``predict`` asks
for one, closed loop, until ``--seconds`` have passed since the first
request; the window ends when ``predict`` returns, every pose on the host.

A batch's time runs from its hand-over to the moment its poses reached the
host. ``predict`` drains batch i (its poses to the host) before it asks for
batch i + 2, and the last batch before it returns, so that moment is read
from outside at the request of batch i + 2 (its buffering order).
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..reference import mickey, serve_check
from . import core, trace
from .params import make_params


class Traffic:
    """The mix's frames, scenes and batches, all from the seed: a pool of
    smooth random fields with noise made on the card, each scene's
    intrinsics and keyframe, each batch's queries drawn from the pool."""

    def __init__(self, spec: dict, seed: int, device):
        self.spec, self.seed = spec, seed
        h, w = spec["frame_height"], spec["frame_width"]
        n = spec["pool_queries"] + spec["pool_keyframes"]
        g = torch.Generator(device=device).manual_seed(seed + 1)
        gh, gw = spec["field_grid"]
        field_ = torch.nn.functional.interpolate(torch.rand((n, 3, gh, gw), generator=g, device=device),
                                                 size=(h, w), mode="bicubic", align_corners=False)
        field_ += spec["noise"] * torch.randn((n, 3, h, w), generator=g, device=device)
        frames = (field_.clamp_(0.0, 1.0) * 255.0).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu()
        self.queries = frames[:spec["pool_queries"]].numpy()
        self.keyframes = frames[spec["pool_queries"]:].numpy()

    def _rng(self, *key):
        return np.random.default_rng([self.seed, *key])

    def scene(self, prefix: str, s: int):
        """(scene id, keyframe's pool index, intrinsics) of scene ``s``."""
        h, w = self.spec["frame_height"], self.spec["frame_width"]
        rng = self._rng(1, ord(prefix), s)
        f = rng.uniform(*self.spec["focal"])
        j = rng.uniform(-1.0, 1.0, 2) * self.spec["principal_jitter"]
        K = np.array([[f, 0, w / 2 + j[0]], [0, f, h / 2 + j[1]], [0, 0, 1]], np.float32)
        return f"{prefix}{s:05d}", int(rng.integers(len(self.keyframes))), K

    def query_name(self, q: int) -> str:
        return f"seq1/frame_{q % self.spec['queries_per_scene']:05d}.jpg"

    def batch(self, i: int, prefix: str) -> dict:
        """Batch ``i``: pairs i * bs ... of consecutive scenes, each a query
        frame against its scene's keyframe."""
        bs, per = self.spec["batch_size"], self.spec["queries_per_scene"]
        scenes = [self.scene(prefix, q // per) for q in range(i * bs, (i + 1) * bs)]
        kf_idx = [s[1] for s in scenes]
        q_idx = self._rng(2, ord(prefix), i).choice(len(self.queries), bs, replace=False)
        K = np.stack([s[2] for s in scenes])
        # one scene's pairs share its keyframe: a read-only view, not bs copies
        image0 = (np.broadcast_to(self.keyframes[kf_idx[0]], (bs, *self.keyframes.shape[1:]))
                  if len(set(kf_idx)) == 1 else self.keyframes[kf_idx])
        return {"image0": image0, "image1": self.queries[q_idx], "K_color0": K, "K_color1": K.copy(),
                "scene_id": [s[0] for s in scenes],
                "pair_names": [("seq0/frame_00000.jpg", self.query_name(q)) for q in range(i * bs, (i + 1) * bs)],
                "_frames": (kf_idx, q_idx)}


class Loader:
    """Hands ``predict`` a batch when it asks, for ``n_batches`` or until
    ``seconds`` have passed since the first request; keeps every request's
    and hand-over's time."""

    def __init__(self, traffic: Traffic, prefix: str, n_batches: int | None = None, seconds: float | None = None,
                 on_request=None):
        self.traffic, self.prefix, self.n_batches, self.seconds = traffic, prefix, n_batches, seconds
        self.on_request = on_request
        self.requests, self.handovers, self.frames = [], [], []
        self.wait_s = 0.0

    def __iter__(self):
        i = 0
        while True:
            t = time.perf_counter()
            self.requests.append(t)
            if self.on_request is not None:  # the profiler's stop, in a traced run: not the loader's wait
                self.on_request(t - self.requests[0])
                t = time.perf_counter()
            if (self.n_batches is not None and i >= self.n_batches) or (
                    self.seconds is not None and t - self.requests[0] >= self.seconds):
                return
            data = self.traffic.batch(i, self.prefix)
            self.frames.append(data.pop("_frames"))
            h = time.perf_counter()
            self.handovers.append(h)
            self.wait_s += h - t
            yield data
            i += 1


@dataclass
class Capture:
    """The served path's outputs of the sampled batches, kept as made: the
    keyframe maps the batch used, its query maps, its table, the solver's
    kept draw, the pose and hard-inlier mask at each of the solver's
    inlier counts (each refinement's, then the returned pose's), and the
    query frames' tokens after the backbone blocks ``taps``. The solver's
    counts and the blocks are read where the program makes them, or the
    plain reference where it stands in the program's place (the control)."""

    steps: set
    taps: tuple = (0,)  # the first block: feat_err's (calibrate.py reads others beside it)
    step: int = -1
    active: bool = False
    images: int = 0  # frames extracted in the window
    out: dict = field(default_factory=dict)
    undo: list = field(default_factory=list)

    def _counting(self, fn):
        def counting(X, Y, R, t, *a, **k):
            mask = fn(X, Y, R, t, *a, **k)
            if self.active:
                self.out[self.step]["masks"].append((R, t, mask.to(torch.bool)))
            return mask

        return counting

    def _block(self, fn, depth: int):
        def block(*a, **k):
            x = fn(*a, **k)
            if self.active:
                got = self.out[self.step]
                i = got["blocks"] % depth
                got["blocks"] += 1
                if i in self.taps:
                    got["taps"].setdefault(i, []).append(x)
            return x

        return block

    def _patch(self, owner, attr, wrapper):
        self.undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, wrapper(getattr(owner, attr)))

    def install(self, model, depth: int):
        """Wraps ``model``'s entry points and the functions named above for
        as long as the capture is installed (``remove``)."""
        import mickey_tpu_torch.nn.dinov2 as dinov2
        import mickey_tpu_torch.solver.procrustes_ransac as ransac

        call, extract, match, estimate = (model.call_with_ref_feats, model.extract_feats, model.match_feats,
                                          model.estimate)

        def call_with_ref_feats(ref_feats, image1, K0, K1, generator=None, draws=None):
            self.step += 1
            self.active = self.step in self.steps
            if self.active:
                self.out[self.step] = {"ref_feats": ref_feats, "masks": [], "blocks": 0, "taps": {}}
            try:
                return call(ref_feats, image1, K0, K1, generator=generator, draws=draws)
            finally:
                self.active = False

        def extract_feats(images):
            self.images += images.shape[0]
            out = extract(images)
            if self.active:
                self.out[self.step]["query_feats"] = out
            return out

        def match_feats(feats0, feats1, fused=None):
            out = match(feats0, feats1, fused)
            if self.active:
                self.out[self.step]["corr"] = out
            return out

        def estimate_(corr, K0, K1, generator=None, draws=None):
            out = estimate(corr, K0, K1, generator, draws)
            if self.active:
                self.out[self.step]["weights"] = out.weights
            return out

        model.call_with_ref_feats, model.extract_feats = call_with_ref_feats, extract_feats
        model.match_feats, model.estimate = match_feats, estimate_
        self._patch(ransac, "inlier_counting_3d", self._counting)
        self._patch(mickey, "hard_inliers", self._counting)
        self._patch(dinov2, "block_apply", lambda fn: self._block(fn, depth))
        self._patch(mickey, "vit_block", lambda fn: self._block(fn, depth))

    def remove(self):
        for owner, attr, old in reversed(self.undo):
            setattr(owner, attr, old)
        self.undo.clear()

    def complete(self, num_refinements: int) -> bool:
        """Whether every sampled batch left all that the check reads."""
        need = {"ref_feats", "query_feats", "corr", "weights"}
        return not (self.steps - set(self.out)) and all(
            need <= set(v) and len(v["masks"]) == num_refinements + 1 and set(v["taps"]) == set(self.taps)
            for v in self.out.values())


def program_model(cfg, params, device):
    """The system under test, as ``models.build_model`` makes it (TF32 off
    for matmuls and cuDNN), on the harness's weights."""
    from mickey_tpu_torch.models.relative_pose import MickeyRelativePose

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return MickeyRelativePose(cfg, params, device=device)


class ReferenceModel:
    """The plain reference in the program's place (the control): the entry
    points ``predict`` calls, in ``prec``."""

    def __init__(self, cfg, params, device, prec=mickey.CONTROL):
        self.cfg, self.params, self.device, self.prec = cfg, params, torch.device(device), prec

    def extract_feats(self, images):
        return mickey.extract(self.params, images, self.cfg, self.prec, chunk=images.shape[0])

    def match_feats(self, feats0, feats1, fused=None):
        df = self.cfg["MICKEY"]["DINOV2"]["DOWN_FACTOR"]
        tpu, fm = self.cfg["TPU"], self.cfg["FEATURE_MATCHER"]["DUAL_SOFTMAX"]
        b = feats0[0].shape[0]
        flat = [tuple(f.reshape(b, -1, f.shape[-1]) for f in side) for side in (feats0, feats1)]
        final = mickey.final_scores(flat[0][3], flat[1][3], flat[0][2], flat[1][2],
                                    self.params["matcher"].get("dustbin_score", 0.0), float(fm["TEMPERATURE"]),
                                    bool(fm["USE_DUSTBIN"]), self.prec)
        v, i, ok = mickey.topk_table(final, int(tpu["SAMPLING_PREFILTER"]), int(tpu.get("MATCHER_TOPL", 16)))
        return Table(mickey.keypoints(feats0[0], df), flat[0][1], mickey.keypoints(feats1[0], df), flat[1][1],
                     v.float(), i, ok)

    def estimate(self, c, K0, K1, generator=None, draws=None):
        return mickey.solve(c.top_scores, c.top_idx, c.row_ok, c.kps0, c.depth0, c.kps1, c.depth1, K0, K1, generator,
                            self.cfg["PROCRUSTES"], self.prec)

    def call_with_ref_feats(self, ref_feats, image1, K0, K1, generator=None, draws=None):
        est = self.estimate(self.match_feats(ref_feats, self.extract_feats(image1)), K0, K1, generator)
        return Poses(est.R.float(), est.t.float(), est.confidence.float())


class Table(NamedTuple):
    """The matcher's output the solver takes (the fields of the program's
    ``TopKCorrespondences``)."""

    kps0: torch.Tensor
    depth0: torch.Tensor
    kps1: torch.Tensor
    depth1: torch.Tensor
    top_scores: torch.Tensor
    top_idx: torch.Tensor
    row_ok: torch.Tensor


class Poses(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor


def check(cell, params, traffic: Traffic, loader: Loader, capture: Capture, results: dict, checks: core.Checks,
          device):
    """The comparison numbers over the sampled batches (``serve_check``); the
    solver's draws replayed from the program's own stream of the batch."""
    from mickey_tpu_torch.cli.submission import SOLVER_SEED, step_generator

    cfg = cell.cfg
    df = cfg["MICKEY"]["DINOV2"]["DOWN_FACTOR"]
    answers = {(scene, p.image_name): p for scene, poses in results.items() for p in poses}
    worst = dict.fromkeys(("feat_err", "maps_err", "table_err", "pose_err", "solve_err"), 0.0)
    notes = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for step, got in sorted(capture.out.items()):
        kf_idx, q_idx = loader.frames[step]
        frames = np.concatenate([traffic.keyframes[kf_idx], traffic.queries[q_idx]])
        frames = torch.from_numpy(frames[:, : frames.shape[1] // df * df, : frames.shape[2] // df * df])
        b = len(q_idx)
        taps = dict.fromkeys(capture.taps)
        ref_maps = mickey.extract(params, frames.to(device), cfg, mickey.REF, taps=taps)
        for k in capture.taps:  # the query frames are the batch's last
            served_tok, ref_tok = torch.cat(got["taps"][k]), taps[k][-b:]
            notes[f"feat_block{k}"] = max(notes.get(f"feat_block{k}", 0.0), serve_check.feat_err(served_tok, ref_tok))
        worst["feat_err"] = max([worst["feat_err"]] + [notes[f"feat_block{k}"] for k in capture.taps])
        del taps
        served = tuple(torch.cat([r, q]) for r, q in zip(got["ref_feats"], got["query_feats"]))
        worst["maps_err"] = max(worst["maps_err"], serve_check.maps_err(served, ref_maps))
        corr = dict(zip(Table._fields, got["corr"]))
        for side, feats in (("0", got["ref_feats"]), ("1", got["query_feats"])):
            corr["scr" + side] = feats[2].reshape(b, -1)
            corr["dsc" + side] = feats[3].reshape(b, -1, feats[3].shape[-1])
        worst["table_err"] = max(worst["table_err"], serve_check.table_err(
            corr, params["matcher"].get("dustbin_score", 0.0), cfg))
        pairs = range(step * b, (step + 1) * b)
        scenes = [traffic.scene(loader.prefix, q // traffic.spec["queries_per_scene"]) for q in pairs]
        K = torch.from_numpy(np.stack([s[2] for s in scenes])).to(device)
        ans = []
        for s, q in zip(scenes, pairs):
            p = answers.get((s[0], traffic.query_name(q)))
            ans.append(None if p is None else (p.q, p.t, p.inliers))
        pose, solve = serve_check.pose_check(corr, got, ans, K, K, step_generator(device, SOLVER_SEED, step), cfg)
        worst["pose_err"], worst["solve_err"] = max(worst["pose_err"], pose), max(worst["solve_err"], solve)
    for k, v in worst.items():
        checks.add(k, v)
    for k, v in notes.items():  # feat_err's part at each block read
        checks.note(k, v)


def window_latencies(requests: list, handovers: list, t_end: float) -> tuple:
    """(the window's seconds, every batch's ms from hand-over to its poses on
    the host): the window runs from the first request to ``predict``'s
    return; batch i's poses are on the host by the request of batch i + 2,
    the last two batches' by the final request and the return."""
    n = len(handovers)
    done = [requests[i + 2] if i + 2 < len(requests) else t_end for i in range(n)]
    return t_end - requests[0], [(d - h) * 1e3 for d, h in zip(done, handovers)]


def sample_steps(spec: dict, seed: int) -> set:
    """The checked batches, drawn from the seed among the window's first
    ones: one that extracts its scene's keyframe, the rest any."""
    c = spec["check"]
    rng = np.random.default_rng([seed, 2])
    per = spec["queries_per_scene"] // spec["batch_size"]
    firsts = [i for i in range(c["among_first"]) if i % per == 0]
    steps = {int(rng.choice(firsts))}
    rest = [i for i in range(c["among_first"]) if i not in steps]
    steps.update(int(i) for i in rng.choice(rest, c["batches"] - 1, replace=False))
    return steps


def run(cell: core.Cell, args, t0: float, device="cuda", model_factory=program_model) -> tuple:
    """One run of the cell: (result line, checks, the batches' latencies).
    ``model_factory``: (cfg, params, device) -> what ``predict`` serves, the
    program by default (the control: ``ReferenceModel``)."""
    from mickey_tpu_torch.cli.submission import predict

    spec = cell.traffic
    device = torch.device(device)
    marks = [("imports", time.perf_counter())]
    params = make_params(cell.cfg, cell.config_file["backbone_ffn"], args.seed, device)
    model = model_factory(cell.cfg, params, device)
    traffic = Traffic(spec, args.seed, device)
    shared = bool(spec["shared_ref"])
    marks.append(("weights and frames", time.perf_counter()))

    predict(Loader(traffic, "w", n_batches=spec["warmup_batches"]), model, progress=False, shared_ref=shared)
    marks.append(("warm-up", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    capture = Capture(sample_steps(spec, args.seed), tuple(getattr(args, "taps", None) or Capture.taps))
    capture.install(model, len(params["dinov2"]["blocks"]))
    spans = trace.Spans(model)
    specs = core.span_specs(cell) if args.trace else {}
    tracer = trace.Tracer(spans, spec["trace_seconds"], spec["trace_host_seconds"]) if args.trace else None
    loader = Loader(traffic, "s", seconds=args.seconds, n_batches=getattr(args, "batches", None),
                    on_request=tracer.tick if tracer else None)
    with spans.install(specs):
        if tracer:
            tracer.start()
        setup_s = time.perf_counter() - t0
        results = predict(loader, model, progress=False, shared_ref=shared)
        t_end = time.perf_counter()
    capture.remove()
    host = core.host_note()
    if device.type == "cuda":
        torch.cuda.synchronize()
    device_info = core.device_info(cell.chips) if device.type == "cuda" else {"platform": "cpu", "count": 0}

    n = len(loader.handovers)
    bs = spec["batch_size"]
    window_s, latency_ms = window_latencies(loader.requests, loader.handovers, t_end)
    e2e = {"pairs_per_s": n * bs / window_s,
           "batch_ms_p90": float(np.percentile(latency_ms, 90)) if latency_ms else math.nan,
           "peak_mem_gib": device_info.get("memory_peak_bytes", 0) / 2**30,
           "setup_s": setup_s}
    del model
    checks = core.Checks(cell.limits)
    if not capture.complete(int(cell.cfg["PROCRUSTES"]["NUM_REFINEMENTS"])):
        for k in ("feat_err", "maps_err", "table_err", "pose_err", "solve_err"):
            checks.add(k, math.inf)
    else:
        check(cell, params, traffic, loader, capture, results, checks, device)

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    breakdown = None
    if args.trace:
        profile = tracer.finish()
        run_info = trace.RunInfo(cell=cell, spans=spans.calls, window_s=window_s, profile=profile, batches=n,
                                 pairs=n * bs, images=capture.images, loader_wait_s=loader.wait_s,
                                 tracer_s=tracer.cost_s)
        metrics = core.read_per_layer(cell, run_info)
        device_info.update(busy_s=profile.busy_s, window_s=profile.window_s)
        breakdown = profile.breakdown()
    else:
        metrics = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
    steps = [f"{k} {t - t_prev:.2f} s" for (k, t), t_prev in zip(marks, [t0] + [t for _, t in marks])]
    median = np.median(latency_ms) if latency_ms else math.nan
    print(f"perfbench: set-up {', '.join(steps)}; {n} batches in {window_s:.3f} s, loader wait "
          f"{100 * loader.wait_s / window_s:.2f}%, median batch {median:.1f} ms", file=sys.stderr)
    rates = core.chunk_rates(loader.handovers, loader.requests[0], t_end)
    print(f"perfbench: pairs/s by 10 s of the window {' '.join(f'{r * bs:.2f}' for r in rates)}; host: {host}",
          file=sys.stderr)
    # every pair handed over came back through predict's drain: none failed
    line = core.result_line(checks.correct, n * bs, 0, metrics, units, device_info, checks, breakdown)
    return line, checks, {"latency_ms": latency_ms, "window_s": window_s}
