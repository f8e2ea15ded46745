"""Map-free submission CLI (``mickey_tpu/cli/submission.py``).

Runs batched inference over the val or test split on one CUDA device and
writes the per-scene ``pose_{scene}.txt`` files into ``submission.zip``, the
file the Map-free benchmark scores (offline:
``python -m mickey_tpu_torch.evaluation.mapfree``).

Usage:
    python -m mickey_tpu_torch.cli.submission --config config.yaml \
        --checkpoint weights/mickey.ckpt --split val -o results/
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from zipfile import ZipFile, ZipInfo

import numpy as np
import torch

from ..data.io import pad_to_multiple
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


def predict(loader, model, progress: bool = True, shared_ref: bool = True):
    """Batched inference on ``model.device`` -> {scene: [Pose, ...]}
    (reference submission.py:32-61).

    Each batch is cropped on the host to multiples of the backbone's patch
    size (``pad_to_multiple``: from the bottom and the right, so K holds),
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
    """
    device = torch.device(model.device)
    df = int(model.cfg.MICKEY.DINOV2.DOWN_FACTOR)
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

    def drain(out, data):
        R_b = out.R.cpu().numpy()
        t_b = out.t.cpu().numpy()
        conf_b = out.inliers.cpu().numpy()
        for i in range(len(R_b)):
            R, t, conf = R_b[i], t_b[i].reshape(-1), float(conf_b[i])
            # skip frames without finite estimates (reference submission.py:51-52)
            if not (np.isfinite(R).all() and np.isfinite(t).all()):
                continue
            if np.abs(R).max() == 0:  # zero-pose fallback = no estimate
                continue
            results_dict[data["scene_id"][i]].append(
                Pose(image_name=data["pair_names"][i][1], q=mat2quat(R).reshape(-1), t=t, inliers=conf)
            )

    def gather_ref_feats(data, image0: np.ndarray):
        """Per-pair keyframe extract outputs, in pair order, from the cache;
        the batch's keyframes not yet held are extracted together."""
        pair_keys = [(scene, names[0]) for scene, names in zip(data["scene_id"], data["pair_names"])]
        missing = [k for k in dict.fromkeys(pair_keys) if k not in ref_cache]
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
        return ref_feats

    in_flight = None  # (out, data) awaiting its poses
    with torch.inference_mode():
        for step, data in enumerate(it):
            image0 = pad_to_multiple(data["image0"], df)
            image1 = to_device(pad_to_multiple(data["image1"], df))
            K0, K1 = to_device(data["K_color0"]), to_device(data["K_color1"])
            generator = step_generator(device, SOLVER_SEED, step)
            if shared_ref:
                out = model.call_with_ref_feats(gather_ref_feats(data, image0), image1, K0, K1, generator=generator)
            else:
                out = model(to_device(image0), image1, K0, K1, generator=generator, lite=True)
            if in_flight is not None:
                drain(*in_flight)
            in_flight = (out, data)
        if in_flight is not None:
            drain(*in_flight)
    return results_dict


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
    it is built on the CUDA device, and without one this raises."""
    from ..config import default_config
    from ..data.loader import DataModule
    from ..models import build_model

    if model is None and not torch.cuda.is_available():
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
        model = build_model(cfg, checkpoint=args.checkpoint, dinov2_path=args.dinov2, device="cuda")
    results_dict = predict(loader, model, shared_ref=not args.no_shared_ref)

    args.output_root.mkdir(parents=True, exist_ok=True)
    save_submission(results_dict, args.output_root / "submission.zip")
    print(f"Wrote {args.output_root / 'submission.zip'}")


def main():
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
    eval_split(parser.parse_args())


if __name__ == "__main__":
    main()
