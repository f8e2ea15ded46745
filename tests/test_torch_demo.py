"""The demo entry point and its drawing code against mickey_tpu on the CPU:
the colour tables, the offscreen 3D render, the inlier point cloud, the
matplotlib 3D render, and ``cli.demo`` end to end.

Inputs come from numpy with a fixed seed and go to both packages; the demo
reads two JPEGs and an ``intrinsics.txt`` that the test writes. The demo's
model is ViT-S cut to 2 blocks with narrow heads in fp32 (``test_torch_slice``'s
size, a 12 x 14 patch grid), injected into both packages on the same weights.

Tolerances: the colour tables, the 3D render and the demo's image files
made from the same model output are bitwise (the same numpy / cv2 code on
the same arrays). The point cloud at 1e-6 relative (one fp32 product of a
pixel with the inverse intrinsics). The demo's pose under JAX's draws,
carried over by match index: R and t at 1e-4, the confidence at 1e-4
relative, as the exact-path tests (``test_torch_exact_path``). The image
files of the two packages' own runs: their model outputs differ by fp32
rounding, which can move a pixel across a JPEG or colour level, so they are
held at a mean absolute difference below 1 grey level (of 255) and the same
shape.
"""

import os
from argparse import Namespace

import cv2
import jax
import matplotlib
import numpy as np
import pytest
import torch
import yaml

import mickey_tpu.models as jmodels
from mickey_tpu.cli import demo as jdemo
from mickey_tpu.models.relative_pose import MickeyRelativePose as JaxPose
from mickey_tpu.utils import render3d as jrender3d
from mickey_tpu.utils import viz3d as jviz3d
from mickey_tpu_torch.cli import demo
from mickey_tpu_torch.models import build_model
from mickey_tpu_torch.models.relative_pose import RelativePoseOutput
from mickey_tpu_torch.nn.extractor import Correspondences
from mickey_tpu_torch.solver.procrustes_ransac import PoseEstimate
from mickey_tpu_torch.utils import colormaps, render3d, viz3d
from mickey_tpu_torch.weights import init_params_numpy
from test_torch_exact_path import _jax_table as dense_table
from test_torch_slice import _remap, _replay_jax_draws, small_cfg

T = torch.from_numpy
H, W = 172, 200  # cut to 168 x 196: a 12 x 14 patch grid


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: six xdist workers' OpenMP pools otherwise spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["magma_r", "cool", "viridis"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_colour_tables_are_matplotlibs(name, dtype):
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.3, 1.3, (40, 50)).astype(dtype)
    x[0, :10] = [np.nan, 1.0, 0.0, -0.0, np.inf, -np.inf, -1e-9, 255 / 256, np.nextafter(dtype(1), dtype(0)), 2.0]
    x[1] = np.linspace(0, 1, 50)
    ours = colormaps.lookup(name, x)
    ref = matplotlib.colormaps[name](x, bytes=True)
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape == ref.shape == (40, 50, 4)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(colormaps.TABLES[name], matplotlib.colormaps[name](np.arange(256), bytes=True))
    assert (ours[0, 0] == 0).all()  # NaN: the "bad" colour
    np.testing.assert_array_equal(ours[0, 1], colormaps.TABLES[name][-1])  # exactly 1: the last entry
    np.testing.assert_array_equal(ours[0, 6], colormaps.TABLES[name][0])  # below 0: "under", the first
    np.testing.assert_array_equal(ours[0, 9], colormaps.TABLES[name][-1])  # above 1: "over", the last


def _scene(seed, n=60, uint8=False):
    rng = np.random.default_rng(seed)
    ims = [rng.uniform(0, 1, (126, 168, 3)).astype(np.float32) for _ in range(2)]
    if uint8:
        ims = [(255 * im).astype(np.uint8) for im in ims]
    K = np.float32([[150, 0, 84], [0, 150, 63], [0, 0, 1]])
    a = 0.2
    P = np.eye(4)
    P[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    P[:3, 3] = [0.4, -0.05, 0.1]
    pts = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(1.5, 4, (n, 1))], 1)
    return P, ims, K, pts, rng.uniform(0, 1, (n, 3))


@pytest.mark.parametrize("case", ["points", "orbit", "no_points", "uint8_no_confidence"])
def test_render_offscreen_is_bitwise_jax(case):
    P, (im0, im1), K, pts, cols = _scene(1, uint8=case == "uint8_no_confidence")
    kw = dict(total_matches=80)
    if case == "orbit":
        kw.update(angle_x=-15.0, angle_y=25.0, cam_offset_x=0.2)
    if case == "no_points":
        pts = cols = None
    if case == "uint8_no_confidence":
        kw.update(add_confidence=False, add_ref_pts=False)
    ours = render3d.get_render_offscreen(P, im0, im1, K, K, pts, cols, width=400, height=300, **kw)
    ref = jrender3d.get_render_offscreen(P, im0, im1, K, K, pts, cols, width=400, height=300, **kw)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape and ours.shape[:2] == (300, 400 + int(198 / 2.5) + 100)
    np.testing.assert_array_equal(ours, ref)
    assert len(np.unique(ours.reshape(-1, 3), axis=0)) > 50  # drew images, frames, splats


def _inliers(seed, n=30):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, 196, (n, 4)), rng.uniform(0, 1, (n, 1)), rng.uniform(1, 5, (n, 2))],
                          1).astype(np.float32)


def test_point_cloud_and_matplotlib_render_match_jax():
    K = np.float32([[150, 0, 98], [0, 150, 84], [0, 0, 1]])
    inl = _inliers(2)
    for coded in (True, False):
        pts, cols = viz3d.create_point_cloud_from_inliers(inl, K, coded)
        ref_pts, ref_cols = jviz3d.create_point_cloud_from_inliers(inl, K, coded)
        assert pts.shape == cols.shape == (30, 3) and pts.dtype == np.float32
        np.testing.assert_allclose(pts, ref_pts, rtol=1e-6)
        np.testing.assert_allclose(cols, ref_cols, rtol=1e-5, atol=1e-6)
    empty, _ = viz3d.create_point_cloud_from_inliers(inl[:0], K)
    assert empty.shape == (0, 3)
    P = np.eye(4)
    P[:3, 3] = [0.5, 0, 0.2]
    frame = viz3d.get_render(P, K, K, (196, 168), pts, cols, confidence=20.0)
    np.testing.assert_array_equal(frame, jviz3d.get_render(P, K, K, (196, 168), ref_pts, cols, confidence=20.0))
    assert frame.dtype == np.uint8 and frame.std() > 0


@pytest.fixture(scope="module")
def demo_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    rng = np.random.default_rng(3)
    for name in ("im0.jpg", "im1.jpg"):
        base = cv2.resize(rng.uniform(0, 255, (H // 8, W // 8, 3)).astype(np.uint8), (W, H))
        cv2.imwrite(str(root / name), np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8))
    (root / "intrinsics.txt").write_text("".join(f"{n} 150.0 150.0 {W / 2} {H / 2} {W} {H}\n"
                                                 for n in ("im0.jpg", "im1.jpg")))
    cfg = small_cfg()
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
    params = init_params_numpy(cfg, 0)
    params["dinov2"]["blocks"] = jax.tree.map(lambda a: a[:2], params["dinov2"]["blocks"])
    return root, cfg, params


def _args(root, out, config=""):
    return Namespace(im_path_ref=str(root / "im0.jpg"), im_path_dst=str(root / "im1.jpg"),
                     intrinsics=str(root / "intrinsics.txt"), resize=None, config=config, checkpoint="",
                     dinov2=None, out_dir=str(root / out), save_matches=True, generate_3D_vis=True, seed=5)


def _to_port(ref) -> RelativePoseOutput:
    a = lambda x: T(np.array(x))  # noqa: E731
    return RelativePoseOutput(a(ref.R), a(ref.t), a(ref.inliers), a(ref.valid),
                              PoseEstimate(*(a(getattr(ref.estimate, f)) for f in PoseEstimate._fields)),
                              Correspondences(*(a(getattr(ref.corr, f)) for f in Correspondences._fields)))


SUFFIXES = ("im0.depth.jpg", "im1.depth.jpg", "im0.score.jpg", "im1.score.jpg", "im0.matches.jpg", "im0.3d_vis.jpg")


def test_demo_matches_jax(demo_setup, monkeypatch):
    """``cli.demo`` on the same images and weights as ``mickey_tpu.cli.demo``:
    the pose under JAX's draws, the images the port draws from JAX's own
    model output byte for byte JAX's files, and the port's own files."""
    root, cfg, params = demo_setup
    monkeypatch.setattr(jmodels, "build_model", lambda c, **kw: JaxPose(c, params=params))
    ref = jdemo.run_demo_inference(_args(root, "jax", str(root / "cfg.yaml")))
    assert np.asarray(ref.valid).all()

    model = build_model(cfg, params, device="cpu")
    from mickey_tpu_torch.data.io import pad_to_multiple, read_color_image, read_intrinsics

    im0, im1 = (pad_to_multiple(read_color_image(root / n)) for n in ("im0.jpg", "im1.jpg"))
    assert im0.shape == (168, 196, 3)
    K0 = read_intrinsics(root / "intrinsics.txt")[0]["im0.jpg"][None]
    probe = model(T(im0[None]), T(im1[None]), T(K0), T(K0))  # the port's own table, for the carry-over
    P = cfg.TPU.SAMPLING_PREFILTER
    jtab, jidx = dense_table(np.asarray(ref.corr.final_scores), P)
    our_idx = torch.topk(probe.corr.final_scores.reshape(1, -1), P, dim=-1).indices
    draws = _remap(_replay_jax_draws(jax.random.PRNGKey(5), jtab, cfg), jidx, our_idx)

    out = demo.run_demo_inference(_args(root, "port"), model=model, draws=draws)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(out.inliers.numpy(), np.asarray(ref.inliers), rtol=1e-4)

    written = demo.write_demo_images(_args(root, "from_jax"), _to_port(ref), im0, im1, K0, K0, cfg)
    assert sorted(os.path.basename(p) for p in written) == sorted(SUFFIXES)
    for name in SUFFIXES:
        jax_file = (root / "jax" / name).read_bytes()
        assert (root / "from_jax" / name).read_bytes() == jax_file, name
        ours, theirs = (cv2.imread(str(root / d / name), cv2.IMREAD_UNCHANGED) for d in ("port", "jax"))
        assert ours.shape == theirs.shape, name
        assert np.abs(ours.astype(np.float64) - theirs).mean() < 1.0, name
    assert cv2.imread(str(root / "port" / "im0.score.jpg")).shape == (168, 196, 3)
    assert cv2.imread(str(root / "port" / "im0.matches.jpg")).shape == (168, 2 * 196 + 50, 3)


def test_demo_needs_a_model_or_a_card(demo_setup, monkeypatch):
    root, _, _ = demo_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.run_demo_inference(_args(root, "none"))
    args = demo.parser().parse_args(["--im_path_ref", "a.jpg", "--save_matches", "--generate_3D_vis",
                                     "--resize", "64", "48", "--seed", "3"])
    assert args.save_matches and args.generate_3D_vis and args.resize == [64, 48] and args.seed == 3
    assert vars(args).keys() == vars(_args(root, "x")).keys()
