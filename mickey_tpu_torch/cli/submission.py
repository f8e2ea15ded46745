"""Map-free submission CLI (``mickey_tpu/cli/submission.py``).

Runs batched inference over the val or test split on one CUDA device, or on
N under ``python -m torch.distributed.run --nproc_per_node=N -m
mickey_tpu_torch.cli.submission ...`` (each rank serves its rows of every
batch, rank 0 writes), and writes the per-scene ``pose_{scene}.txt`` files
into ``submission.zip``, the file the Map-free benchmark scores (offline:
``python -m mickey_tpu_torch.evaluation.mapfree``).

Usage:
    python -m mickey_tpu_torch.cli.submission --config config.yaml \
        --checkpoint weights/mickey.ckpt --split val -o results/
"""

from __future__ import annotations

import argparse
import itertools
import os
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple
from zipfile import ZipFile, ZipInfo

import numpy as np
import torch

from .. import parallel, tracing
from ..data.io import crop_to_patches
from ..geometry.rotations import mat2quat

MAX_REF_CACHE = 32  # keyframes whose extract outputs stay on the device (~1 MB each)
SOLVER_SEED = 0  # the solver's draws: step_generator(SOLVER_SEED, step) for batch `step`


@dataclass
class Pose:
    image_name: str
    q: np.ndarray
    t: np.ndarray
    inliers: float

    def __str__(self) -> str:
        formatter = {"float": lambda v: f"{v:.6f}"}
        q_str = np.array2string(self.q, formatter=formatter, max_line_width=1000)[1:-1]
        t_str = np.array2string(self.t, formatter=formatter, max_line_width=1000)[1:-1]
        return f"{self.image_name} {q_str} {t_str} {self.inliers}"


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The solver's random stream for one batch, from ``seed`` and the step
    index (the JAX package folds the step into PRNGKey(0); the streams differ)."""
    return torch.Generator(device=device).manual_seed(int(np.random.SeedSequence((seed, step)).generate_state(1)[0]))


def predict(loader, model, progress: bool = True, shared_ref: bool = True, dp=None):
    """Batched inference on ``model.device`` -> {scene: [Pose, ...]}
    (reference submission.py:32-61).

    Each batch is cropped on the host to multiples of the backbone's patch
    size (``crop_to_patches``: from the bottom and the right, so K holds),
    then copied to the device, from pinned memory where that is a CUDA
    device. Double-buffered: batch i + 1 is enqueued before batch i's poses
    come to the host, where a pose with a NaN or an infinity, or an all-zero
    rotation (no estimate), is skipped.

    ``shared_ref``: every Map-free query pair takes its scene's
    seq0 keyframe as image0, so the keyframe's ``extract_feats`` outputs stay
    on the device per (scene, keyframe), at most ``MAX_REF_CACHE`` of them,
    and only the queries run the backbone (``call_with_ref_feats``); a batch
    extracts only its keyframes not yet held. ``shared_ref=False`` runs both
    images of every pair (``model(..., lite=True)``). The two agree up to the
    last bits of the keyframe's extract, taken alone or stacked with the
    batch. The solver's draws come from ``step_generator(SOLVER_SEED, step)``.

    Spans of ``tracing``, each with the batch's ``step`` as its request:
    ``predict.load`` (the wait on the loader), ``predict.stage`` (the crop,
    the copies, the generator), ``predict.kf_cache`` (counting
    ``kf_hits``, ``kf_misses`` and ``kf_evicted`` once per keyframe of the
    batch), ``predict.dispatch`` (the model's call) and ``predict.drain``
    (the batch drained: its copies to the host, ``poses_skipped``); and one
    ``predict.request`` a batch, from its hand-over to its poses on the host.

    ``dp`` (by default ``parallel.world()``): with N ranks the loader reads
    each rank's rows of every batch, padded to a multiple of N
    (``DataLoader.shard``); each rank serves them with its own keyframe
    cache and the step's generator folded with its rank
    (``DataParallel.fold``), and the poses and the pairs' names are
    all-gathered, so every rank returns the whole split's poses, the
    padding dropped.
    """
    dp = dp if dp is not None else parallel.world()
    if dp.size > 1:
        loader.shard = (dp.rank, dp.size)
    device = torch.device(model.device)
    results_dict = defaultdict(list)
    # (scene_id, ref_frame) -> the 4 extract maps, each (1, ...), on the
    # device; insertion-ordered, so eviction takes the oldest first
    ref_cache: dict = {}

    it = loader
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(loader, total=len(loader))
        except ImportError:
            pass

    def to_device(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(x)
        if device.type == "cuda":  # one host copy, into pinned memory (it also compacts a crop)
            t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        return t.to(device, non_blocking=True)

    def drain(out, data, step, handed):
        with tracing.span("predict.drain", request=step):
            R_b = out.R.cpu().numpy()
            t_b = out.t.cpu().numpy()
            conf_b = out.inliers.cpu().numpy()
            tracing.record("predict.request", handed, request=step)  # the batch's poses are on the host
            skipped = 0
            for i in range(len(data["pair_names"])):
                R, t, conf = R_b[i], t_b[i].reshape(-1), float(conf_b[i])
                # skip frames without finite estimates (reference submission.py:51-52);
                # an all-zero rotation is the zero-pose fallback: no estimate
                if not (np.isfinite(R).all() and np.isfinite(t).all()) or np.abs(R).max() == 0:
                    skipped += 1
                    continue
                results_dict[data["scene_id"][i]].append(
                    Pose(image_name=data["pair_names"][i][1], q=mat2quat(R).reshape(-1), t=t, inliers=conf)
                )
            tracing.count("poses_skipped", skipped)

    def gather_ref_feats(data, image0: np.ndarray):
        """Per-pair keyframe extract outputs, in pair order, from the cache;
        the batch's keyframes not yet held are extracted together."""
        pair_keys = [(scene, names[0]) for scene, names in zip(data["scene_id"], data["pair_names"])]
        unique = dict.fromkeys(pair_keys)
        missing = [k for k in unique if k not in ref_cache]
        tracing.count("kf_hits", len(unique) - len(missing))
        tracing.count("kf_misses", len(missing))
        if missing:
            feats = model.extract_feats(to_device(image0[[pair_keys.index(k) for k in missing]]))
            for j, k in enumerate(missing):
                ref_cache[k] = tuple(f[j : j + 1] for f in feats)
        ref_feats = tuple(torch.cat([ref_cache[k][j] for k in pair_keys]) for j in range(4))
        if len(ref_cache) > MAX_REF_CACHE:  # evict the oldest keyframes this batch does not use
            keep = set(pair_keys)
            for k in [k for k in ref_cache if k not in keep]:
                if len(ref_cache) <= MAX_REF_CACHE:
                    break
                ref_cache.pop(k)
                tracing.count("kf_evicted")
        return ref_feats

    in_flight = None  # (out, data, step, hand-over time) awaiting its poses
    batches, end = iter(it), object()
    with torch.inference_mode():
        for step in itertools.count():
            with tracing.span("predict.load", request=step):
                data = next(batches, end)
            if data is end:
                break
            handed = tracing.clock()
            with tracing.span("predict.stage", request=step):
                image0 = crop_to_patches(data["image0"], model.cfg)
                image1 = to_device(crop_to_patches(data["image1"], model.cfg))
                if not shared_ref:
                    image0 = to_device(image0)
                K0, K1 = to_device(data["K_color0"]), to_device(data["K_color1"])
                generator = step_generator(device, SOLVER_SEED, step)
                if dp.size > 1:
                    generator = dp.fold(generator)
            if shared_ref:
                with tracing.span("predict.kf_cache", request=step):
                    ref_feats = gather_ref_feats(data, image0)
            with tracing.span("predict.dispatch", request=step):
                if shared_ref:
                    out = model.call_with_ref_feats(ref_feats, image1, K0, K1, generator=generator)
                else:
                    out = model(image0, image1, K0, K1, generator=generator, lite=True)
                if dp.size > 1:
                    out, data = gather_batch(dp, out, data)
            if in_flight is not None:
                drain(*in_flight)
            in_flight = (out, data, step, handed)
        if in_flight is not None:
            drain(*in_flight)
    return results_dict


class _Poses(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor


def gather_batch(dp, out, data: dict):
    """Every rank's poses and pair names of a batch, in rank order, the
    padding of the global batch (``data["global_batch"]`` pairs) dropped."""
    real = data["global_batch"]
    poses = _Poses(*(dp.all_gather_rows(x)[:real] for x in (out.R, out.t, out.inliers)))
    names = dp.all_gather_objects((data["scene_id"], data["pair_names"]))
    return poses, {"scene_id": [s for n in names for s in n[0]][:real],
                   "pair_names": [p for n in names for p in n[1]][:real]}


def save_submission(results_dict: dict, output_path: Path):
    """One ``pose_{scene}.txt`` a scene. Every member carries a fixed date,
    so the same poses give the same zip, byte for byte."""
    with ZipFile(output_path, "w") as zf:
        for scene, poses in results_dict.items():
            poses_str = "\n".join(str(p) for p in poses)
            info = ZipInfo(f"pose_{scene}.txt")
            info.external_attr = 0o600 << 16  # rw for the owner, as ZipFile.writestr gives a name
            zf.writestr(info, poses_str.encode("utf-8"))


def eval_split(args, cfg=None, model=None):
    """Run one split end to end. ``cfg`` / ``model`` let a caller inject a
    configuration and a model (a CPU model runs on the CPU); without a model
    it is built on the CUDA device, and without one this raises. In a
    data-parallel group it is built on the rank's device, and rank 0
    writes; a group joined on the CPU of a machine with CUDA devices raises
    unless the injected model is on the CPU (``main`` joins NCCL)."""
    from ..config import default_config
    from ..data.loader import DataModule
    from ..models import build_model

    dp = parallel.world()
    if dp.size > 1:
        parallel.refuse_cpu_group(dp, asked_cpu=model is not None and torch.device(model.device).type == "cpu")
    device = dp.device if dp.size > 1 else torch.device("cuda")
    if model is None and device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the submission CLI serves on a CUDA device and none is available; "
                           "eval_split(args, model=...) takes a CPU model")
    if cfg is None:
        cfg = default_config()
        if args.dataset_config:
            cfg.merge_from_file(args.dataset_config)
        if args.config:
            cfg.merge_from_file(args.config)

    cfg.TRAINING.NUM_WORKERS = 8  # IO threads for the prefetching loader
    if args.split == "test":
        cfg.TRAINING.BATCH_SIZE = args.batch_size or 8
        loader = DataModule(cfg, drop_last_val=False).test_dataloader()
    elif args.split == "val":
        cfg.TRAINING.BATCH_SIZE = args.batch_size or 12
        loader = DataModule(cfg, drop_last_val=False).val_dataloader()
    else:
        raise NotImplementedError(f"Invalid split: {args.split}")

    if model is None:
        model = build_model(cfg, checkpoint=args.checkpoint, dinov2_path=args.dinov2, device=device)
    results_dict = predict(loader, model, shared_ref=not args.no_shared_ref, dp=dp)

    if dp.rank == 0:
        args.output_root.mkdir(parents=True, exist_ok=True)
        save_submission(results_dict, args.output_root / "submission.zip")
        print(f"Wrote {args.output_root / 'submission.zip'}")


def main(argv=None):
    """The CLI (``argv``: its arguments, by default the command line's); a
    rank that ``parallel.launch`` started serves in its group."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="", help="model config yaml")
    parser.add_argument("--dataset_config", default="", help="dataset config yaml")
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--dinov2", default=None)
    parser.add_argument("--output_root", "-o", type=Path, default=Path("results/"))
    parser.add_argument("--split", choices=("val", "test"), default="test")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument(
        "--no_shared_ref",
        action="store_true",
        help="disable the per-scene keyframe extract cache (recompute the "
        "reference frame for every pair, like the upstream reference)",
    )
    parser.add_argument("--trace_out", default=None,
                        help="write the run's spans (predict's stages, the model's, the solver's) to this file "
                             "as a Chrome trace, which Perfetto opens (rank 0's in a data-parallel run)")
    args = parser.parse_args(argv)
    distributed = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if distributed:  # NCCL on cuda:LOCAL_RANK: a rank without a card raises here
        parallel.build_libraries_once(parallel.init_data_parallel("nccl"))
    try:
        with tracing.traced(args.trace_out if parallel.world().rank == 0 else None):
            eval_split(args)
    finally:
        if distributed:
            parallel.close_data_parallel()


if __name__ == "__main__":
    main()
