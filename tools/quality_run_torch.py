"""One-command quality run on real weights, on the PyTorch port
(``tools/quality_run.py``, run by ``mickey_tpu_torch``; numpy, torch and
the port only).

The quality target (VCRE-AUC parity against the reference's released
mickey.ckpt) needs the released weights and the Map-free dataset, which are
not in the repository. With them it is one command:

    python tools/quality_run_torch.py --mickey /path/mickey.ckpt \
        --dinov2 /path/dinov2_vitl14_pretrain.pth \
        --dataset /path/mapfree --split val [--scenes 5] [--device cuda]

Steps:
  1. load the upstream checkpoint (``models.build_model(cfg, checkpoint=...,
     dinov2_path=...)``);
  2. run the toy-example demo pair (``$MICKEY_TOY_EXAMPLE``: im0.jpg,
     im1.jpg, intrinsics.txt; skipped where that directory is absent): a
     finite pose, and a warning where a trained model's confidence is low;
  3. run a val-slice submission (``cli.submission.eval_split``; ``--scenes``
     limits breadth);
  4. score it with the offline evaluator (``evaluation.mapfree.evaluate``)
     and hold the AUCs to ``EXPECTED`` within ``TOLERANCE``.

``--dry-run`` runs the whole path with random weights on a synthesized
micro-dataset (``synthesize_micro_dataset``, byte for byte the JAX tool's)
and the JAX tool's cut configuration (ViT-S fp32, narrow heads, a 2 x 8 x 64
solver budget, 126 x 112 frames, no prefilter): plumbing only, no parity
claim. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Parity thresholds: the reference's published Map-free val numbers for
# MicKey (paper Table; reference README.md quotes the benchmark site).
# A converted checkpoint should land within a few percent of these. Keys are
# evaluation.mapfree.summarize output keys.
EXPECTED = {
    "AUC @ VCRE < 90px": 0.71,
    "AUC @ Pose Error < (25.0cm, 5deg)": 0.31,
}
TOLERANCE = 0.05


def synthesize_micro_dataset(root: Path, n_scenes: int = 2, n_frames: int = 3):
    """A tiny Map-free-format val split (see reference data docs): scene dirs
    with poses.txt / intrinsics.txt / seq0+seq1 jpgs;
    ``tools/quality_run.py::synthesize_micro_dataset``, byte for byte."""
    import numpy as np

    try:
        import cv2
    except ImportError:
        cv2 = None
    rng = np.random.default_rng(0)
    W, H = 540, 720
    for s in range(n_scenes):
        scene = root / "val" / f"s{s:05d}"
        (scene / "seq0").mkdir(parents=True, exist_ok=True)
        (scene / "seq1").mkdir(parents=True, exist_ok=True)
        poses, intr = [], []
        frames = [("seq0/frame_00000.jpg", 0)] + [
            (f"seq1/frame_{i:05d}.jpg", i) for i in range(n_frames)
        ]
        for name, _ in frames:
            img = (rng.uniform(0, 255, (H, W, 3))).astype("uint8")
            if cv2 is not None:
                cv2.imwrite(str(scene / name), img)
            else:
                from PIL import Image

                Image.fromarray(img).save(scene / name)
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            tvec = rng.normal(size=3) * 0.1
            poses.append(f"{name} {q[0]} {q[1]} {q[2]} {q[3]} {tvec[0]} {tvec[1]} {tvec[2]}")
            intr.append(f"{name} 520.0 520.0 {W/2} {H/2} {W} {H}")
        (scene / "poses.txt").write_text("\n".join(poses) + "\n")
        (scene / "intrinsics.txt").write_text("\n".join(intr) + "\n")


def dry_run_config(cfg):
    """The JAX tool's dry-run cut of ``cfg``, in place: a small backbone and
    a tiny RANSAC budget (keeps the micro-run fast); returns the demo
    leg's resize (W, H), as cfg.DATASET."""
    cfg.MICKEY.DINOV2.VARIANT = "vit_small"
    cfg.MICKEY.DINOV2.CHANNEL_DIM = 384
    cfg.MICKEY.DINOV2.FLOAT16 = False
    cfg.MICKEY.KP_HEADS.BLOCKS_DIM = [32, 16, 128, 8]
    cfg.MICKEY.DSC_HEAD.LAST_DIM = 16
    pc = cfg.PROCRUSTES
    pc.IT_MATCHES, pc.IT_RANSAC, pc.NUM_SAMPLED_MATCHES = 2, 8, 64
    cfg.TPU.SAMPLING_PREFILTER = 0
    cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT = 112, 126
    return (112, 126)


def demo_pair(model, toy: Path, resize) -> float:
    """The toy example's pair through the model's full output: its
    confidence; raises where the pose is not finite."""
    import numpy as np
    import torch

    from mickey_tpu_torch.data.io import pad_to_multiple, read_color_image, read_intrinsics

    im0 = pad_to_multiple(read_color_image(str(toy / "im0.jpg"), resize))
    im1 = pad_to_multiple(read_color_image(str(toy / "im1.jpg"), resize))
    Ks, _ = read_intrinsics(str(toy / "intrinsics.txt"), resize)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(model.device)  # noqa: E731
    out = model(t(im0[None]), t(im1[None]), t(Ks["im0.jpg"][None]), t(Ks["im1.jpg"][None]),
                generator=torch.Generator(device=model.device).manual_seed(0))
    if not torch.isfinite(out.R).all():
        raise FloatingPointError("demo pose has NaNs")
    return float(out.inliers[0])


def quality_run(args) -> tuple:
    """The four steps on parsed ``args``; returns (exit code, the
    evaluator's metrics)."""
    from mickey_tpu_torch import default_config
    from mickey_tpu_torch.cli.submission import eval_split
    from mickey_tpu_torch.evaluation.mapfree import evaluate
    from mickey_tpu_torch.models import build_model

    out_root = Path(args.out) if args.out else Path(tempfile.mkdtemp(prefix="mickey_quality_"))
    out_root.mkdir(parents=True, exist_ok=True)
    cfg = default_config()

    if args.dry_run:
        os.environ["MICKEY_ALLOW_RANDOM_BACKBONE"] = "1"
        dataset = out_root / "dataset"
        synthesize_micro_dataset(dataset)
        checkpoint = ""
        resize = dry_run_config(cfg)
    else:
        checkpoint = args.mickey
        dataset = Path(args.dataset)
        resize = None
    cfg.DATASET.DATA_ROOT = str(dataset)
    if args.scenes:
        split_dir = dataset / args.split
        cfg.DATASET.SCENES = sorted(s.name for s in split_dir.iterdir() if s.is_dir())[: args.scenes]

    # -- 1. load ---------------------------------------------------------------
    print(f"[quality] building model on {args.device} (checkpoint={checkpoint or '<random>'})", flush=True)
    model = build_model(cfg, checkpoint=checkpoint, dinov2_path=args.dinov2, device=args.device)

    # -- 2. toy-example demo sanity ----------------------------------------------
    toy = os.environ.get("MICKEY_TOY_EXAMPLE", "")
    if toy and Path(toy).is_dir():
        conf = demo_pair(model, Path(toy), resize)
        print(f"[quality] demo pair OK: confidence={conf:.1f}", flush=True)
        if not args.dry_run and conf < 50:
            print("[quality] WARNING: demo confidence is low for trained weights", flush=True)
    else:
        print("[quality] demo pair skipped: MICKEY_TOY_EXAMPLE names no directory", flush=True)

    # -- 3. val-slice submission ---------------------------------------------------
    sub_args = argparse.Namespace(
        config="", dataset_config="", checkpoint=checkpoint, dinov2=args.dinov2,
        output_root=out_root, split=args.split, batch_size=None, no_shared_ref=False,
    )
    print(f"[quality] running {args.split} submission -> {out_root}", flush=True)
    eval_split(sub_args, cfg=cfg, model=model)

    # -- 4. offline evaluation -----------------------------------------------------
    metrics, _curves = evaluate(out_root / "submission.zip", dataset / args.split)
    print(json.dumps(metrics, indent=2, default=float), flush=True)
    if args.dry_run:
        print("[quality] dry run complete (plumbing OK; no parity claim)", flush=True)
        return 0, metrics
    ok = True
    for k, want in EXPECTED.items():
        got = metrics.get(k)
        if got is not None and got < want - TOLERANCE:
            print(f"[quality] FAIL {k}: {got:.3f} < {want - TOLERANCE:.3f}", flush=True)
            ok = False
    print("[quality] PARITY " + ("PASS" if ok else "FAIL"), flush=True)
    return (0 if ok else 1), metrics


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mickey", default="", help="reference mickey.ckpt")
    p.add_argument("--dinov2", default=None, help="dinov2_vitl14_pretrain.pth")
    p.add_argument("--dataset", default="", help="Map-free dataset root")
    p.add_argument("--split", default="val")
    p.add_argument("--scenes", type=int, default=0, help="limit scene count (0 = all)")
    p.add_argument("--out", default="", help="output dir (default: tmp)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dry-run", action="store_true", help="random weights + synthesized micro-dataset")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if not args.dry_run and (not args.mickey or not args.dataset):
        p.error("--mickey and --dataset are required (or use --dry-run)")
    return quality_run(args)[0]


if __name__ == "__main__":
    raise SystemExit(main())
