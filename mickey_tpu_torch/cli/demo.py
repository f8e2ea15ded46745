"""Two-image relative pose demo CLI (``mickey_tpu/cli/demo.py``, counterpart
of reference demo_inference.py).

Usage:
    python -m mickey_tpu_torch.cli.demo \
        --im_path_ref data/toy_example/im0.jpg \
        --im_path_dst data/toy_example/im1.jpg \
        --intrinsics data/toy_example/intrinsics.txt \
        --checkpoint weights/mickey.ckpt [--config config.yaml] \
        [--save_matches] [--generate_3D_vis] [--out_dir out/]

Builds the model on the CUDA device, prints the estimated pose and writes
colorized depth and score maps next to the inputs (or into --out_dir), with
--save_matches a mutual-nearest-neighbour match panel and with
--generate_3D_vis the offscreen 3D render of both cameras and the inlier
point cloud. The images are cut to multiples of the patch size
(``data.io.pad_to_multiple``, from the bottom and the right, so K holds).
The solver draws from ``torch.Generator(device).manual_seed(--seed)``;
the JAX package draws from ``PRNGKey(seed)``, so the streams differ.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def run_demo_inference(args, model=None, draws=None):
    """The demo on parsed ``args``. ``model`` injects a built model (its
    config is used; a CPU model runs on the CPU); without one it is built on
    the CUDA device, and without that this raises. ``draws`` injects the
    solver's samples (tests). Returns the model's full output."""
    from ..config import default_config
    from ..data.io import pad_to_multiple, read_color_image, read_intrinsics
    from ..geometry.rotations import mat2quat
    from ..models import build_model

    if model is None and not torch.cuda.is_available():
        raise RuntimeError("the demo runs on a CUDA device and none is available; "
                           "run_demo_inference(args, model=...) takes a CPU model")
    if model is None:
        cfg = default_config()
        if args.config:
            cfg.merge_from_file(args.config)
    else:
        cfg = model.cfg

    print("Preparing data...")
    resize = tuple(args.resize) if args.resize else None
    im0 = pad_to_multiple(read_color_image(args.im_path_ref, resize))
    im1 = pad_to_multiple(read_color_image(args.im_path_dst, resize))
    Ks, _ = read_intrinsics(args.intrinsics, resize)
    K0 = Ks[os.path.basename(args.im_path_ref)][None]
    K1 = Ks[os.path.basename(args.im_path_dst)][None]

    if model is None:
        print("Building model...")
        model = build_model(cfg, checkpoint=args.checkpoint, dinov2_path=args.dinov2, device="cuda")

    print("Running MicKey relative pose estimation...")
    dev = model.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    generator = None if draws is not None else torch.Generator(device=dev).manual_seed(args.seed)
    out = model(t(im0[None]), t(im1[None]), t(K0), t(K1), generator=generator, draws=draws)

    R = _np(out.R[0])
    tv = _np(out.t[0]).reshape(-1)
    print(f"R (im0 -> im1):\n{np.array2string(R, precision=4)}")
    print(f"t: {np.array2string(tv, precision=4)}  |t|={np.linalg.norm(tv):.3f} m")
    q = mat2quat(R) if np.isfinite(R).all() and np.abs(R).max() > 0 else np.zeros(4)
    print(f"q (wxyz): {np.array2string(q, precision=4)}")
    print(f"confidence (soft inliers): {float(out.inliers[0]):.1f}   valid: {bool(out.valid[0])}")
    write_demo_images(args, out, im0, im1, K0, K1, cfg)
    print("Done.")
    return out


def write_demo_images(args, out, im0, im1, K0, K1, cfg) -> list:
    """The demo's images from the model's full output ``out`` on the cut
    (H, W, 3) images and (1, 3, 3) intrinsics: depth and score maps of both
    images, with ``args.save_matches`` the match panel, with
    ``args.generate_3D_vis`` the 3D render. Returns the paths written."""
    import cv2

    from ..nn.matcher import get_matches_list
    from ..utils.viz import colorize_depth, draw_matches, prepare_score_map

    print("Saving depth and score maps...")
    out_dir = Path(args.out_dir) if args.out_dir else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    written = []

    def save(src: str, suffix: str, image: np.ndarray) -> str:
        ext = src.split(".")[-1]
        dst = src.replace(f".{ext}", f".{suffix}.jpg")
        path = str(out_dir / os.path.basename(dst)) if out_dir else dst
        if not cv2.imwrite(path, image):
            raise OSError(f"cv2.imwrite could not write {path}")
        written.append(path)
        return path

    corr = out.corr
    d0 = _np(corr.depth_map0[0, :, :, 0])
    d1 = _np(corr.depth_map1[0, :, :, 0])
    save(args.im_path_ref, "depth", colorize_depth(d0, invalid_mask=d0 < 0.001))
    save(args.im_path_dst, "depth", colorize_depth(d1, invalid_mask=d1 < 0.001))
    save(args.im_path_ref, "score", prepare_score_map(_np(corr.scr0[0]), im0))
    save(args.im_path_dst, "score", prepare_score_map(_np(corr.scr1[0]), im1))

    if args.save_matches:
        fs = _np(corr.final_scores[0])
        matches = get_matches_list(fs)
        pts0 = _np(corr.kps0[0])[matches[:, 0]]
        pts1 = _np(corr.kps1[0])[matches[:, 1]]
        canvas = draw_matches(im0, im1, pts0, pts1, fs[matches[:, 0], matches[:, 1]])
        save(args.im_path_ref, "matches", (255 * canvas[:, :, ::-1]).astype(np.uint8))
        print(f"Saved {len(matches)} mutual-NN matches visualization.")

    if args.generate_3D_vis:
        from ..solver.procrustes_ransac import extract_inliers
        from ..utils.render3d import get_render_offscreen
        from ..utils.viz3d import create_point_cloud_from_inliers

        print("Generating 3D visualization image...")
        pts, colors = create_point_cloud_from_inliers(extract_inliers(out.estimate, 0), K0[0])
        P = np.eye(4)
        P[:3, :3], P[:3, 3] = _np(out.R[0]), _np(out.t[0]).reshape(-1)
        frame = get_render_offscreen(P, im0, im1, K0[0], K1[0], pts, colors,
                                     total_matches=cfg.PROCRUSTES.NUM_SAMPLED_MATCHES)
        print(f"Saved {save(args.im_path_ref, '3d_vis', frame[:, :, ::-1])}")
    return written


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MicKey two-image demo (PyTorch / CUDA)")
    p.add_argument("--im_path_ref", default="data/toy_example/im0.jpg")
    p.add_argument("--im_path_dst", default="data/toy_example/im1.jpg")
    p.add_argument("--intrinsics", default="data/toy_example/intrinsics.txt")
    p.add_argument("--resize", nargs=2, type=int, default=None, help="(w, h)")
    p.add_argument("--config", default="", help="path to config yaml")
    p.add_argument("--checkpoint", default="", help="reference .ckpt or native checkpoint dir ('' = random init)")
    p.add_argument("--dinov2", default=None, help="path to dinov2_vitl14_pretrain.pth")
    p.add_argument("--out_dir", default="", help="directory for output maps (default: next to inputs)")
    p.add_argument("--save_matches", action="store_true", help="also save a match visualization")
    p.add_argument("--generate_3D_vis", action="store_true",
                   help="render cameras + inlier point cloud to 3d_vis image")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    run_demo_inference(parser().parse_args(argv))


if __name__ == "__main__":
    main()
