"""Runner of the training traffic: ``StagedTrainStep.__call__`` as
``MicKeyTrainer.training_step`` calls it (the batch cropped and moved to the
card, the trainer's generator, the curriculum's starting top-K%, the step's
metrics read back to the host), one new batch a step, closed loop.

Set-up builds the step, its model and its optimizer state once, on weights
made on the card from the seed, and drives them through the first
``check_steps`` steps with the window's own call and feed; the window then
goes on with the same objects. The reference follows those first steps
(``reference/train_ref.py``); they are the warm-up too, every shape of the
window being a step's.
"""

from __future__ import annotations

import math
import queue
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..reference import mickey, train_ref
from . import core, trace
from .params import VIT, make_params
from .submit import Traffic


def _rotation(rng, max_deg: float) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(rng.uniform(0.0, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


class TrainTraffic(Traffic):
    """Pairs of pool frames with Map-free-like intrinsics and a ground-truth
    relative pose each, a new batch a step, all from the seed."""

    def batch(self, i: int, prefix: str = "t") -> dict:
        bs, spec = self.spec["batch_size"], self.spec
        rng = self._rng(3, i)
        pick = rng.choice(len(self.queries), 2 * bs, replace=False)
        h, w = spec["frame_height"], spec["frame_width"]
        K = np.zeros((bs, 3, 3), np.float32)
        T = np.tile(np.eye(4, dtype=np.float32), (bs, 1, 1))
        for j in range(bs):
            f = rng.uniform(*spec["focal"])
            c = rng.uniform(-1.0, 1.0, 2) * spec["principal_jitter"]
            K[j] = [[f, 0, w / 2 + c[0]], [0, f, h / 2 + c[1]], [0, 0, 1]]
            T[j, :3, :3] = _rotation(rng, spec["max_rotation_deg"])
            T[j, :3, 3] = rng.normal(size=3) * spec["translation_m"]
        return {"image0": self.queries[pick[:bs]], "image1": self.queries[pick[bs:]], "T_0to1": T,
                "K_color0": K, "K_color1": K.copy(), "Kori_color0": K.copy(), "Kori_color1": K.copy(),
                "_frames": pick}


class Feeder:
    """The window's batches, made ahead of the step in a thread of their own
    (``MicKeyTrainer.fit`` feeds its steps from loader threads), ``depth``
    at a time; ``wait_s``: the seconds the steps waited for one."""

    def __init__(self, traffic: "TrainTraffic", first: int, depth: int = 2):
        self.traffic, self.wait_s = traffic, 0.0
        self.queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._make, args=(first,), name="perfbench-feed", daemon=True)
        self.thread.start()

    def _make(self, i: int):
        while not self.stop.is_set():
            batch = self.traffic.batch(i)
            batch.pop("_frames")
            while not self.stop.is_set():
                try:
                    self.queue.put(batch, timeout=0.05)
                    break
                except queue.Full:
                    pass
            i += 1

    def next(self) -> dict:
        t = time.perf_counter()
        batch = self.queue.get()
        self.wait_s += time.perf_counter() - t
        return batch

    def close(self):
        self.stop.set()
        self.thread.join()


def device_batch(batch: dict, cfg, device) -> dict:
    """``MicKeyTrainer.device_batch``: images cropped to the patch grid, all
    on the card."""
    from mickey_tpu_torch.data.io import crop_to_patches

    out = {k: torch.as_tensor(batch[k]).to(device) for k in ("T_0to1", "K_color0", "K_color1", "Kori_color0",
                                                             "Kori_color1")}
    out.update({k: torch.as_tensor(crop_to_patches(batch[k], cfg)).to(device).contiguous()
                for k in ("image0", "image1")})
    return out


@dataclass
class Program:
    """The system under test: the staged step, its state, the frozen
    backbone and the trainer's generator."""

    step: object
    state: object
    backbone: dict
    generator: torch.Generator
    topk: float

    def trainable(self) -> dict:
        from mickey_tpu_torch.weights import is_bn_stat, tree_leaves

        return {path: t for path, t in tree_leaves(self.state.params) if not is_bn_stat(path)}

    def mu(self) -> dict:
        return dict(zip(self.trainable(), self.state.opt_state.mu))

    def __call__(self, batch: dict, cfg, device) -> dict:
        _, metrics = self.step(self.state, self.backbone, device_batch(batch, cfg, device), self.generator, self.topk)
        return {k: float(v) for k, v in metrics.items()}


def program(cfg, params, device, seed: int) -> Program:
    """``MicKeyTrainer``'s objects on the harness's weights: TF32 off, the
    trainable split, the staged step, the generator seeded ``seed + 1``."""
    from mickey_tpu_torch.training.train_step import StagedTrainStep, init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, backbone = init_train_state(cfg, params)
    return Program(StagedTrainStep(cfg), state, backbone, torch.Generator(device=device).manual_seed(seed + 1),
                   float(cfg.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT))


def _snapshot(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


class Capture:
    """The checked steps' program state the reference follows from: the
    backbone's feature map and the final scores the loss drew from, kept by
    wrappers around ``StagedTrainStep.backbone_fwd`` and the train step's
    ``metric_pose_loss`` while the checked steps run."""

    def __init__(self, prog: Program):
        import mickey_tpu_torch.training.loss as loss_module
        import mickey_tpu_torch.training.train_step as ts

        self.fmaps, self.finals, self.masks = [], [], []
        self.ts, self.loss = ts, ts.metric_pose_loss
        self.loss_module, self.counting = loss_module, loss_module.inlier_counting_3d
        backbone_fwd = prog.step.backbone_fwd

        def counting(*a, **k):
            out = self.counting(*a, **k)
            self.masks[-1].append(out.detach().to(torch.bool))
            return out

        def fwd(*a, **k):
            out = backbone_fwd(*a, **k)
            self.fmaps.append(out)
            return out

        def loss(final_scores, *a, **k):
            self.finals.append(final_scores.detach().clone())
            self.masks.append([])
            return self.loss(final_scores, *a, **k)

        prog.step.backbone_fwd, ts.metric_pose_loss = fwd, loss
        loss_module.inlier_counting_3d = counting
        self.prog = prog

    def remove(self):
        del self.prog.step.backbone_fwd
        self.ts.metric_pose_loss = self.loss
        self.loss_module.inlier_counting_3d = self.counting


class ReferenceProgram:
    """The plain reference in the program's place (the control): the same
    interface as ``Program``, each step through ``reference.train_ref`` in
    ``prec``, drawing from its own final scores and generator."""

    def __init__(self, cfg, params, device, seed: int, prec=mickey.CONTROL):
        from mickey_tpu_torch.weights import is_bn_stat, tree_leaves

        self.cfg, self.prec, self.device = cfg, prec, torch.device(device)
        self.backbone = params["dinov2"]
        flat = {path: torch.as_tensor(t, device=self.device).float()
                for path, t in tree_leaves({k: v for k, v in params.items() if k != "dinov2"})
                if not is_bn_stat(path)}
        self.params = _rebuild({k: v for k, v in params.items() if k != "dinov2"}, flat)
        self.named = dict(train_ref.leaves(self.params))
        self.opt = train_ref.Adam(list(self.named.values()), float(cfg.TRAINING.LR), float(cfg.TRAINING.GRAD_CLIP or 0))
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.topk = float(cfg.LOSS_CLASS.CURRICULUM_LEARNING.TOPK_INIT)
        self.fmaps, self.finals, self.masks, self.recording = [], [], [], False

    def trainable(self) -> dict:
        return self.named

    def mu(self) -> dict:
        return dict(zip(self.named, self.opt.mu))

    def __call__(self, batch: dict, cfg, device) -> dict:
        db = device_batch(batch, cfg, device)
        d = cfg["MICKEY"]["DINOV2"]
        imgs = torch.cat([db["image0"], db["image1"]])
        with torch.no_grad():
            fmap = torch.cat([mickey.backbone(self.backbone, imgs[i:i + 2], VIT[d["VARIANT"]][2], d["DOWN_FACTOR"],
                                              torch.bfloat16, self.prec) for i in range(0, imgs.shape[0], 2)])
        total, loss, drawn, masks, _ = train_ref.step_loss(self.params, fmap, db, None, self.generator, cfg,
                                                           self.topk, self.prec)
        grads = torch.autograd.grad(total, list(self.named.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype) for p, g in zip(self.named.values(), grads)]
        self.opt.update(list(self.named.values()), grads)
        if self.recording:
            self.fmaps.append(fmap)
            self.finals.append(drawn)
            self.masks.append([m.to(torch.bool) for m in masks])
        return {"loss": loss}


class _Recording:
    """``Capture`` for the control, which keeps its own state."""

    def __init__(self, prog: ReferenceProgram):
        self.prog = prog
        prog.recording = True
        self.fmaps, self.finals, self.masks = prog.fmaps, prog.finals, prog.masks

    def remove(self):
        self.prog.recording = False


def _leaf_gaps(served: dict, ref: dict, keep) -> list:
    """Per kept leaf, | ||served|| - ||ref|| | against the larger of the
    leaf's reference norm and the median leaf's."""
    norms = {k: float(torch.linalg.norm(ref[k].double())) for k in keep}
    med = float(np.median(list(norms.values())))
    gaps = [abs(float(torch.linalg.norm(served[k].double())) - norms[k]) / max(norms[k], med, 1e-30) for k in keep]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def check(cell, p0: dict, params_init: dict, served: dict, checks: core.Checks, device):
    """The five comparison numbers (module ``reference.train_ref``):
    ``fmap_err`` the backbone's first-step map against the reference's from
    the frames; ``loss_err`` the first step's reported loss; ``grad_err``
    the first gradient as the optimizer got it (Adam's first moment over
    1 - b1) by the worst leaf; ``delta_err`` and ``delta_median_err`` the
    parameters' change over the checked steps by the worst and the median
    leaf. Leaves whose first reference gradient is under a thousandth of the
    median leaf's are left out of the last three."""
    cfg = cell.cfg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames = served["frames"][0]
    df = cfg["MICKEY"]["DINOV2"]["DOWN_FACTOR"]
    imgs = torch.from_numpy(frames[:, : frames.shape[1] // df * df, : frames.shape[2] // df * df]).to(device)
    d = cfg["MICKEY"]["DINOV2"]
    heads_n = VIT[d["VARIANT"]][2]
    worst = 0.0
    for i in range(0, imgs.shape[0], 2):
        ref = mickey.backbone(params_init["dinov2"], imgs[i:i + 2], heads_n, df, torch.bfloat16, mickey.REF)
        for j in range(ref.shape[0]):
            got = served["fmaps"][0][i + j].to(device).double()
            worst = max(worst, float(torch.linalg.norm(got - ref[j].double()) / torch.linalg.norm(ref[j].double())))
    checks.add("fmap_err", worst)

    p0 = {k: t.to(device) for k, t in p0.items()}
    for key in ("mu1", "p3"):
        served[key] = {k: t.to(device) for k, t in served[key].items()}
    tree = {k: v for k, v in params_init.items() if k != "dinov2"}
    tree = _rebuild(tree, p0)
    named = dict(train_ref.leaves(tree))
    opt = train_ref.Adam(list(named.values()), float(cfg.TRAINING.LR), float(cfg.TRAINING.GRAD_CLIP or 0.0))
    loss_gap, mask_gap, g1 = None, 0.0, None
    for k in range(len(served["losses"])):
        gen = torch.Generator(device=device)
        gen.set_state(served["gen_states"][k])
        batch = {key: v.to(device) for key, v in served["batches"][k].items()}
        total, loss, _, _, gap = train_ref.step_loss(tree, served["fmaps"][k].to(device), batch,
                                                     served["finals"][k].to(device), gen, cfg, served["topk"],
                                                     masks=[m.to(device) for m in served["masks"][k]])
        mask_gap = max(mask_gap, gap)
        grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype) for p, g in zip(named.values(), grads)]
        gnorm = opt.update(list(named.values()), grads)
        if k == 0:  # as the optimizer got it
            scale = opt.clip / gnorm if opt.clip and gnorm >= opt.clip else 1.0
            g1 = {p: g * scale for p, g in zip(named, grads)}
        if k == 0:  # the later steps' losses carry the first update's noise (Adam on tiny gradients)
            loss_gap = abs(served["losses"][0] - loss) / max(abs(loss), 1e-6)
    checks.add("loss_err", loss_gap)
    # not compared: sound runs read up to ~1e-2, the control not three times that (PERF.md, section 2)
    print(f"perfbench: refinement decisions apart from the reference's {mask_gap:.3g}", file=sys.stderr)
    norms = {k: float(torch.linalg.norm(g.double())) for k, g in g1.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k, v in norms.items() if v >= 1e-3 * med]
    b1 = 0.9
    checks.add("grad_err", max(_leaf_gaps({k: v / (1 - b1) for k, v in served["mu1"].items()}, g1, keep)))
    delta_ref = {k: named[k].detach() - p0[k] for k in keep}
    delta_served = {k: served["p3"][k] - p0[k] for k in keep}
    gaps = _leaf_gaps(delta_served, delta_ref, keep)
    checks.add("delta_err", max(gaps))
    # the median leaf: the only number that half the batch left out of the loss fails on a seed whose counted
    # pairs all lie in the kept half (PERF.md, section 2)
    checks.add("delta_median_err", float(np.median(gaps)))
    worst = keep[int(np.argmax(gaps))]
    g = g1[worst].double()
    print(f"perfbench: the worst leaf's change {'/'.join(map(str, worst))} ({g.numel()} elements): gap {max(gaps):.3g}; "
          f"its first gradient {float(torch.linalg.norm(g)):.3g} (median leaf "
          f"{np.median([float(torch.linalg.norm(g1[j].double())) for j in keep]):.3g}), "
          f"{100 * float((g.abs() < 1e-6).double().mean()):.1f}% of its elements under Adam's eps", file=sys.stderr)


def _rebuild(tree, flat: dict, path=()):
    """``tree``'s structure with its trainable leaves replaced by fresh
    leaves that require grad, copied from ``flat`` (path -> tensor); the
    BatchNorm running stats kept."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, flat, path + (i,)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    if path in flat:
        return flat[path].detach().clone().requires_grad_(True)
    return torch.as_tensor(tree, device=next(iter(flat.values())).device)


def run(cell: core.Cell, args, t0: float, device="cuda", control=None) -> tuple:
    """One run of the cell: (result line, checks, step times). ``control``:
    a reference precision that puts ``ReferenceProgram`` in the program's
    place."""
    spec = cell.traffic
    device = torch.device(device)
    marks = [("imports", time.perf_counter())]
    params = make_params(cell.cfg, cell.config_file["backbone_ffn"], args.seed, device)
    if control is None:
        prog = program(cell.cfg, params, device, args.seed)
    else:
        prog = ReferenceProgram(cell.cfg, params, device, args.seed, control)
    traffic = TrainTraffic(spec, args.seed, device)
    marks.append(("weights and frames", time.perf_counter()))

    served = {"losses": [], "gen_states": [], "batches": [], "frames": [], "topk": prog.topk}
    p0 = _snapshot(prog.trainable())
    cap = Capture(prog) if control is None else _Recording(prog)
    for i in range(spec["check_steps"]):
        served["gen_states"].append(prog.generator.get_state())
        batch = traffic.batch(i)
        served["frames"].append(np.concatenate([batch["image0"], batch["image1"]]))
        served["batches"].append({k: torch.as_tensor(batch[k]) for k in ("T_0to1", "K_color0", "K_color1",
                                                                          "Kori_color0", "Kori_color1")})
        batch.pop("_frames")
        served["losses"].append(prog(batch, cell.cfg, device)["loss"])
        if i == 0:
            served["mu1"] = _snapshot(prog.mu())
    served["p3"] = _snapshot(prog.trainable())
    cap.remove()
    served["fmaps"], served["finals"] = cap.fmaps, cap.finals
    # held on the host until the comparison, so that the window's peak is the program's
    host = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731
    for key in ("fmaps", "finals"):
        served[key] = [host(t) for t in served[key]]
    served["masks"] = [[host(m) for m in step] for step in cap.masks]
    for key in ("mu1", "p3"):
        served[key] = {k: host(t) for k, t in served[key].items()}
    p0 = {k: host(t) for k, t in p0.items()}
    marks.append(("checked steps", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    spans = trace.Spans(getattr(prog, "step", prog))
    specs = core.span_specs(cell) if args.trace else {}
    tracer = trace.Tracer(spans, spec["trace_seconds"], spec["trace_host_seconds"]) if args.trace else None
    steps, times, ends = 0, [], []
    feeder = Feeder(traffic, spec["check_steps"])
    try:
        with spans.install(specs):
            if tracer:
                tracer.start()
            setup_s = time.perf_counter() - t0
            start = time.perf_counter()
            limit = getattr(args, "batches", None)
            while True:
                now = time.perf_counter()
                if tracer:
                    tracer.tick(now - start)
                    now = time.perf_counter()
                if (limit is not None and steps >= limit) or (limit is None and now - start >= args.seconds):
                    break
                prog(feeder.next(), cell.cfg, device)
                ends.append(time.perf_counter())
                times.append(ends[-1] - now)
                steps += 1
            if device.type == "cuda":
                torch.cuda.synchronize()
            t_end = time.perf_counter()
    finally:
        feeder.close()
    window_s = t_end - start
    host = core.host_note()
    device_info = core.device_info(cell.chips) if device.type == "cuda" else {"platform": "cpu", "count": 0}
    e2e = {"train_step_ms": 1e3 * window_s / max(steps, 1),
           "peak_mem_gib": device_info.get("memory_peak_bytes", 0) / 2**30, "setup_s": setup_s}
    steps_txt = [f"{k} {t - tp:.2f} s" for (k, t), tp in zip(marks, [t0] + [t for _, t in marks])]
    print(f"perfbench: set-up {', '.join(steps_txt)}; {steps} steps in {window_s:.3f} s, median step "
          f"{1e3 * np.median(times) if times else math.nan:.1f} ms, waiting for batches {100 * feeder.wait_s / window_s:.2f}%",
          file=sys.stderr)
    rates = core.chunk_rates(ends, start, t_end)
    print(f"perfbench: ms a step by 10 s of the window {' '.join(f'{1e3 / r:.1f}' if r else 'none' for r in rates)}; "
          f"host: {host}", file=sys.stderr)
    calls = spans.calls
    del prog, spans
    checks = core.Checks(cell.limits)
    check(cell, p0, params, served, checks, device)

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    breakdown = None
    if args.trace:
        profile = tracer.finish()
        info = trace.RunInfo(cell=cell, spans=calls, steps=steps, window_s=window_s, profile=profile,
                             loader_wait_s=feeder.wait_s, tracer_s=tracer.cost_s)
        metrics = core.read_per_layer(cell, info)
        device_info.update(busy_s=profile.busy_s, window_s=profile.window_s)
        breakdown = profile.breakdown()
    else:
        metrics = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
    # every step of the window completed: none failed
    line = core.result_line(checks.correct, steps, 0, metrics, units, device_info, checks, breakdown)
    return line, checks, {"step_ms": [1e3 * t for t in times], "window_s": window_s}
