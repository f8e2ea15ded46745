"""The port's rotations and offline Map-free evaluator against mickey_tpu on
the CPU. Both sides are numpy, so every comparison is bitwise (the same
values and dtypes), on seeded inputs."""

import json
import subprocess
import sys
from io import StringIO
from pathlib import Path
from zipfile import ZipFile

import numpy as np
import pytest

from mickey_tpu.evaluation import mapfree as jmapfree
from mickey_tpu.evaluation import metrics as jmetrics
from mickey_tpu.evaluation import pose_io as jpose_io
from mickey_tpu.evaluation import reprojection as jreprojection
from mickey_tpu.geometry import rotations as jrot
from mickey_tpu_torch import evaluation
from mickey_tpu_torch.evaluation import mapfree, metrics, pose_io, reprojection
from mickey_tpu_torch.geometry import rotations as rot

REPO = Path(__file__).resolve().parents[1]


def same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _rotations(rng, n):
    """Seeded rotations, with matrices for each branch of mat2quat's
    Shepperd selection (trace > 0; R00, R11, R22 the largest diagonal term)
    and quaternions of both signs of w."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mats = [jrot.quat2mat(x) for x in q]
    mats += [np.diag(d).astype(np.float64) for d in ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1))]
    mats += [np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float64), np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float32)]
    return q, mats


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    q, mats = _rotations(rng, 64)
    branches = set()
    for R in mats:
        same(rot.mat2quat(R), jrot.mat2quat(R))
        tr, d = np.trace(R), np.diag(R)
        branches.add("trace" if tr > 0 else int(np.argmax(d)) if d.max() > np.sort(d)[-2] else "tie")
    assert {"trace", 0, 1, 2} <= branches
    assert (q[:, 0] < 0).any() and (q[:, 0] > 0).any()
    for a, b in zip(q[:-1], q[1:] * 1.7):  # non-unit too
        same(rot.quat2mat(b), jrot.quat2mat(b))
        same(rot.qnorm(b), jrot.qnorm(b))
        same(rot.qinverse(b), jrot.qinverse(b))
        same(rot.qmult(a, b), jrot.qmult(a, b))
        v = rng.normal(size=3)
        same(rot.rotate_vector(v, a), jrot.rotate_vector(v, a))
    same(rot.quats_to_mats(q * 2.0), jrot.quats_to_mats(q * 2.0))
    same(rot.quats_to_mats(q.reshape(8, 8, 4)), jrot.quats_to_mats(q.reshape(8, 8, 4)))
    same(rot.qmult_batch(q, q[::-1]), jrot.qmult_batch(q, q[::-1]))
    assert set(rot.__all__) == set(jrot.__all__)


def _pose_lines(rng, frames, conf=True, seq="seq1"):
    q, _ = _rotations(rng, len(frames))
    t = rng.normal(size=(len(frames), 3))
    c = rng.uniform(0, 500, len(frames))
    return [f"{seq}/frame_{f:05}.jpg " + " ".join(f"{v:.6f}" for v in [*q[i], *t[i]])
            + (f" {c[i]}" if conf else "") for i, f in enumerate(frames)]


def test_pose_io_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    lines = _pose_lines(rng, [3, 0, 7, 3, 12, 5])  # frame 3 twice: the last wins
    lines += ["seq1/frame_00009.jpg 1 0 0 0 0 0", "# seq1/frame_00010.jpg 1 0 0 0 0 0 0 1",  # short; comment
              "seq1/frame_xxxxx.jpg 1 0 0 0 0 0 0 1", "seq1/frame_00011.jpg 1 0 0 a 0 0 0 1",  # bad frame; value
              "seq1/frame_00013.jpg 1 0 0 0 nan 0 0 1", "seq1/frame_00014.jpg 0 0 0 0 1 2 3 4"]  # NaN; zero quat
    text = "\n".join(lines) + "\n"
    gt_text = "\n".join(_pose_lines(rng, [1, 2, 1], conf=False)) + "\n"
    for conf, t in ((True, text), (False, gt_text)):
        ours = pose_io.parse_pose_table(StringIO(t), with_confidence=conf)
        theirs = jpose_io.parse_pose_table(StringIO(t), with_confidence=conf)
        for f in ("frame", "q", "t", "conf"):
            same(getattr(ours, f), getattr(theirs, f))
    table = pose_io.parse_pose_table(StringIO(text), with_confidence=True)
    assert list(table.frame) == [0, 7, 3, 12, 5]
    same(table.positions_of(np.array([5, 4, 3, 99])), jpose_io.parse_pose_table(
        StringIO(text), with_confidence=True).positions_of(np.array([5, 4, 3, 99])))
    same(table.take(np.array([2, 0])).t, table.t[[2, 0]])
    empty = pose_io.parse_pose_table(StringIO(""))
    assert len(empty) == 0 and list(empty.positions_of(np.array([1, 2]))) == [-1, -1]

    intr = ["seq0/frame_00000.jpg 100 101 50 60 540 720"] + [
        f"seq1/frame_{i:05}.jpg {100 + i} {101 + i} {50 - i} 60 540 720" for i in (4, 0, 2, 9)] + ["# comment"]
    (tmp_path / "intrinsics.txt").write_text("\n".join(intr) + "\n")
    ours = pose_io.read_intrinsics_table(tmp_path / "intrinsics.txt")
    same(ours, jpose_io.read_intrinsics_table(tmp_path / "intrinsics.txt"))
    frames = np.array([9, 0, 2])
    same(pose_io.lookup_intrinsics(ours[0], ours[1], frames), jpose_io.lookup_intrinsics(ours[0], ours[1], frames))
    with pytest.raises(KeyError):
        pose_io.lookup_intrinsics(ours[0], ours[1], np.array([3]))

    q, _ = _rotations(rng, 32)
    p = q + rng.normal(size=q.shape) * 0.05
    for variant in (pose_io.VARIANTS_ANGLE_SIN, pose_io.VARIANTS_ANGLE_COS):
        same(pose_io.quat_angle_error(q, p, variant), jpose_io.quat_angle_error(q, p, variant))
    same(pose_io.quat_angle_error(q[0], q[0]), jpose_io.quat_angle_error(q[0], q[0]))
    with pytest.raises(ValueError):
        pose_io.quat_angle_error(q, p, "tan")

    conf = np.round(rng.uniform(0, 5, 40))  # ties
    tp = rng.uniform(size=40) < 0.4
    for failures in (0, 7):
        same(pose_io.precision_recall(conf, tp, failures), jpose_io.precision_recall(conf, tp, failures))


def test_reprojection_and_metrics_match_jax():
    rng = np.random.default_rng(2)
    same(reprojection.get_grid_multipleheight(), jreprojection.get_grid_multipleheight())
    same(reprojection.eye_coords_glob, jreprojection.eye_coords_glob)
    K = np.array([[500.0, 0, 270], [0, 500, 360], [0, 0, 1]])
    pts = rng.normal(size=(50, 4)) + np.array([0, 0, 4, 0])
    for size in (None, (540, 720)):
        same(reprojection.project(pts, K, size), jreprojection.project(pts, K, size))
    n = 24
    q_gt, _ = _rotations(rng, n)
    q_est = q_gt + rng.normal(size=q_gt.shape) * 0.02
    t_gt, t_est = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    Ks = np.repeat(K[None], n, 0) * rng.uniform(0.9, 1.1, (n, 1, 1))
    args = (q_est, t_est, q_gt, t_gt, Ks, 540.0, 720.0)
    same(reprojection.reprojection_errors(*args), jreprojection.reprojection_errors(*args))
    one = (q_est[0], t_est[0], q_gt[0], t_gt[0], K, 540, 720)
    assert reprojection.reprojection_error(*one) == jreprojection.reprojection_error(*one)

    conf = rng.uniform(0, 100, n)
    gt = pose_io.PoseTable(np.arange(n), q_gt, t_gt, np.full(n, np.nan))
    est = pose_io.PoseTable(np.arange(n), q_est, t_est, conf)
    jgt = jpose_io.PoseTable(np.arange(n), q_gt, t_gt, np.full(n, np.nan))
    jest = jpose_io.PoseTable(np.arange(n), q_est, t_est, conf)
    assert metrics.METRIC_NAMES == jmetrics.METRIC_NAMES
    ours, theirs = metrics.score_frames(gt, est, Ks, 540.0, 720.0), jmetrics.score_frames(jgt, jest, Ks, 540.0, 720.0)
    assert list(ours) == list(theirs) == list(metrics.METRIC_NAMES)
    for m in ours:
        same(ours[m], theirs[m])
    ours = metrics.score_frames(gt.take(np.arange(0)), est.take(np.arange(0)), Ks[:0], 540.0, 720.0)
    assert all(v.shape == (0,) for v in ours.values())


def write_submission(split_dir, zip_path, rng, skip_scene=None):
    """A zip of estimates for every 5th frame of each scene: every third is
    within 25 cm / 5 degrees of the ground truth, the rest not; some frames
    are missing, one line is malformed; ``skip_scene`` has no file."""
    with ZipFile(zip_path, "w") as zf:
        for scene in sorted(p.name for p in split_dir.iterdir() if p.is_dir()):
            if scene == skip_scene:
                continue
            lines = []
            for k, line in enumerate((split_dir / scene / "poses.txt").read_text().splitlines()[1::5]):  # seq1
                if k == 1:
                    continue  # a missing estimate
                name, *vals = line.split(" ")
                vals = np.array(vals, np.float64)
                q, t = vals[:4], vals[4:7]
                if k % 3:  # far off: 30 degrees and 1 m
                    q = jrot.qmult(q, [np.cos(np.pi / 12), np.sin(np.pi / 12), 0, 0])
                    t = t + np.array([1.0, 0, 0])
                else:  # within 5 cm and ~1 degree
                    q = jrot.qmult(q, [np.cos(0.008), 0, np.sin(0.008), 0])
                    t = t + rng.normal(size=3) * 0.02
                lines.append(f"{name} " + " ".join(f"{v:.6f}" for v in [*q, *t]) + f" {rng.uniform(0, 300):.3f}")
            lines.append("seq1/frame_00099.jpg 1 0 0")
            zf.writestr(f"pose_{scene}.txt", "\n".join(lines))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Three val scenes of 31 frames (poses and intrinsics only)."""
    root = tmp_path_factory.mktemp("mapfree_eval") / "val"
    rng = np.random.default_rng(3)
    for s in range(3):
        sdir = root / f"s{s:05}"
        sdir.mkdir(parents=True)
        names = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05}.jpg" for i in range(30)]
        q, _ = _rotations(rng, len(names))
        t = rng.normal(size=(len(names), 3))
        (sdir / "poses.txt").write_text("\n".join(
            f"{n} " + " ".join(f"{v:.6f}" for v in [*q[i], *t[i]]) for i, n in enumerate(names)) + "\n")
        (sdir / "intrinsics.txt").write_text("\n".join(
            f"{n} {590 + i} {591 + i} 270.5 359.5 540 720" for i, n in enumerate(names)) + "\n")
    return root


@pytest.mark.parametrize("skip_scene", [None, "s00001"])
def test_evaluator_matches_jax(split, tmp_path, skip_scene):
    zip_path = tmp_path / "submission.zip"
    write_submission(split, zip_path, np.random.default_rng(4), skip_scene)
    ours, ours_curves = evaluation.evaluate(zip_path, split)
    theirs, theirs_curves = jmapfree.evaluate(zip_path, split)
    assert list(ours) == list(theirs) and len(ours) == 8
    for k in ours:
        assert ours[k] == theirs[k] and type(ours[k]) is type(theirs[k]), k
    assert 0 < ours["Precision @ Pose Error < (25.0cm, 5deg)"] < 1
    assert ours["Estimates for % of frames"] < 1
    for k in ours_curves:
        same(ours_curves[k], theirs_curves[k])
    with ZipFile(zip_path) as zf:
        for scene in ("s00000", "s00001"):
            a, b = mapfree.score_scene(split, zf, scene), jmapfree.score_scene(split, zf, scene)
            assert a.n_missing == b.n_missing and a.n_scored == b.n_scored
            assert list(a.metrics) == list(b.metrics)
            for m in a.metrics:
                same(a.metrics[m], b.metrics[m])


def test_evaluator_cli_and_exports(split, tmp_path):
    zip_path = tmp_path / "submission.zip"
    write_submission(split, zip_path, np.random.default_rng(5))
    out = subprocess.run([sys.executable, "-m", "mickey_tpu_torch.evaluation.mapfree", "--submission_path",
                          str(zip_path), "--dataset_path", str(split.parent), "--split", "val"],
                         cwd=str(REPO), capture_output=True, text=True, check=True, timeout=120)
    printed = json.loads(out.stdout)
    theirs, _ = jmapfree.evaluate(zip_path, split)
    assert printed == {k: float(v) for k, v in theirs.items()}
    import mickey_tpu.evaluation as jevaluation

    assert evaluation.__all__ == jevaluation.__all__
    empty = tmp_path / "empty.zip"
    ZipFile(empty, "w").close()
    with pytest.raises(RuntimeError):
        evaluation.evaluate(empty, split)
