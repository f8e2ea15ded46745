"""The port's native JPEG ingest (``mickey_tpu_torch/data/native.py``,
``csrc/mickey_io.cpp``) against ``mickey_tpu``'s (``mickey_tpu/data/native.py``,
``native/mickey_io.cpp``) on the CPU: the same JPEGs, written with cv2, give
the same float32 pixels bit for bit, an undecodable blob zeros, and the
port's loader at its default config the JAX loader's batches at its own.
Each test skips only where ``mickey_tpu``'s extension cannot be built.
"""

import ast
import subprocess
import sys
import textwrap
import threading
import warnings
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mickey_tpu.data import native as jnative
from mickey_tpu.data.loader import DataModule as JaxDataModule
from mickey_tpu.data.loader import DataModuleTraining as JaxDataModuleTraining
from mickey_tpu_torch.data import native
from mickey_tpu_torch.data.loader import DataModule, DataModuleTraining
from test_torch_data import assert_same, data_cfgs, write_split

PORT = Path(native.__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_ingest():
    if jnative.ensure_built() is None:
        pytest.skip("mickey_tpu's native extension does not build here (g++ or libjpeg missing)")
    return jnative


def _jpegs(rng, sizes, quality=90):
    return [cv2.imencode(".jpg", rng.uniform(0, 255, (h, w, 3)).astype(np.uint8),
                         [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes() for h, w in sizes]


@pytest.mark.parametrize("out_wh", [(40, 30), (97, 53), (120, 160)])  # down, odd, up
def test_decode_matches_jax_bitwise(jax_ingest, out_wh):
    """Downscale, odd ratios and upscale, several threads: the same bits as
    ``mickey_tpu``'s extension; the corrupt blob and the empty one are all
    zeros, with the same warning."""
    rng = np.random.default_rng(0)
    blobs = _jpegs(rng, [(60, 80), (37, 91), (120, 160), (7, 5)])
    blobs.insert(2, b"\xff\xd8 not a jpeg")
    blobs.append(b"")
    w, h = out_wh
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = jax_ingest.decode_resize_batch(blobs, w, h, num_threads=3)
        ours = native.decode_resize_batch(blobs, w, h, num_threads=3)
    assert ours.dtype == np.float32 and ours.shape == (len(blobs), h, w, 3)
    np.testing.assert_array_equal(ours, ref)
    assert not ours[2].any() and not ours[-1].any() and ours[0].any()
    assert 0.0 <= ours.min() and ours.max() <= 1.0
    messages = [str(c.message) for c in caught]
    assert messages.count("failed to decode 2 image(s)") == 2, messages


def test_read_batch_matches_jax_and_clamps_threads(jax_ingest, tmp_path):
    """Files read from disk; more threads than images or cores change nothing."""
    rng = np.random.default_rng(1)
    paths = []
    for i, blob in enumerate(_jpegs(rng, [(540, 720), (48, 64), (48, 64)])):
        paths.append(tmp_path / f"f{i}.jpg")
        paths[-1].write_bytes(blob)
    ref = jax_ingest.read_batch([str(p) for p in paths], 64, 48, num_threads=2)
    for threads in (1, 64):
        np.testing.assert_array_equal(native.read_batch([str(p) for p in paths], 64, 48, num_threads=threads), ref)


def test_caller_allocated_output(jax_ingest):
    """A numpy or torch CPU buffer is filled in place; a wrong one raises."""
    blobs = _jpegs(np.random.default_rng(2), [(30, 40), (30, 40)])
    ref = jax_ingest.decode_resize_batch(blobs, 20, 10)
    buf = torch.full((2, 10, 20, 3), -1.0)
    assert native.decode_resize_batch(blobs, 20, 10, out=buf) is buf
    np.testing.assert_array_equal(buf.numpy(), ref)
    arr = np.empty((2, 10, 20, 3), np.float32)
    native.decode_resize_batch(blobs, 20, 10, out=arr)
    np.testing.assert_array_equal(arr, ref)
    for bad in (np.empty((2, 10, 20, 3), np.float64), np.empty((2, 20, 10, 3), np.float32),
                np.empty((2, 10, 20, 6), np.float32)[..., ::2]):
        with pytest.raises(ValueError, match="out"):
            native.decode_resize_batch(blobs, 20, 10, out=bad)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("mapfree_native"))


def _native_cfgs(root):
    cfg, jcfg = data_cfgs(root)
    cfg.TRAINING.NATIVE_LOADER = jcfg.TRAINING.NATIVE_LOADER = True  # both packages' default
    return cfg, jcfg


@pytest.mark.parametrize("which", ["val", "test", "train_seeded"])
def test_default_loader_matches_jax_bitwise(jax_ingest, split, which):
    """Both loaders at the default ``TRAINING.NATIVE_LOADER``: the native
    path on both sides, float32 in [0, 1], the same batches bit for bit."""
    cfg, jcfg = _native_cfgs(split)
    module, jmodule = ((DataModuleTraining, JaxDataModuleTraining) if which.endswith("seeded")
                       else (DataModule, JaxDataModule))
    make = f"{which.split('_')[0]}_dataloader"
    kw = {} if which.endswith("seeded") else {"drop_last_val": False}
    ours, theirs = getattr(module(cfg, **kw), make)(), getattr(jmodule(jcfg, **kw), make)()
    got, want = list(ours), list(theirs)
    assert ours._native_batch is True and theirs._native_batch is True
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["image0"].dtype == np.float32 and a["image0"].max() <= 1.0
        assert_same(a, b)


def test_augmentation_takes_the_sample_path(jax_ingest, split, monkeypatch):
    """With an augmentation configured the native path is not taken, as in
    ``mickey_tpu``'s loader."""
    cfg, _ = _native_cfgs(split)
    cfg.DATASET.AUGMENTATION_TYPE = "colorjitter"

    def refuse(*a, **k):
        raise AssertionError("the native ingest read an augmented batch")

    monkeypatch.setattr(native, "read_batch", refuse)
    loader = DataModuleTraining(cfg).train_dataloader()
    batches = list(loader)
    assert batches and loader._native_batch is False
    assert batches[0]["image0"].dtype == np.float32


def test_unbuildable_library_warns_once_and_falls_back(jax_ingest, split, tmp_path, monkeypatch):
    """Without the library (here: a build that fails, as without libjpeg)
    the loader decodes with cv2, the JAX package's fallback semantics: the
    JAX loader's cv2 batches bit for bit, after one warning that names the
    reason."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")

    def no_libjpeg(so):
        raise RuntimeError("g++ failed (1): jpeglib.h: No such file or directory")

    monkeypatch.setattr(native, "_build", no_libjpeg)
    cfg, jcfg = _native_cfgs(split)
    jcfg.TRAINING.NATIVE_LOADER = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = list(DataModule(cfg, drop_last_val=False).val_dataloader())
        assert native.read_batch(["unused.jpg"], 8, 8) is None
    want = list(JaxDataModule(jcfg, drop_last_val=False).val_dataloader())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same(a, b)
    warned = [str(c.message) for c in caught if "native JPEG ingest unavailable" in str(c.message)]
    assert len(warned) == 1 and "jpeglib.h" in warned[0]
    assert "jpeglib.h" in native.unavailable_reason()


def test_build_is_safe_under_threads_and_processes(jax_ingest, tmp_path):
    """Eight threads and two processes build into one empty directory at
    once: each loads a working library, one file remains, no temporary."""
    build = tmp_path / "build"
    code = textwrap.dedent(f"""
        import threading
        from pathlib import Path
        from mickey_tpu_torch.data import native
        native.BUILD_DIR = Path({str(build)!r})
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(native.ensure_built())) for _ in range(8)]
        [t.start() for t in threads]
        [t.join(timeout=120) for t in threads]
        print(len(libs), all(lib is libs[0] is not None for lib in libs))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=str(PORT.parent), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err
        assert out.split() == ["8", "True"], out + err
    assert [f.name for f in build.iterdir()] == [native._library_path().name]


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """``data/native.py`` and ``parallel.py``: no jax, no ``mickey_tpu``, nothing
    of ``native/`` (its build script or its extension); the port's library
    comes from the port's own source."""
    for rel in ("data/native.py", "parallel.py"):
        tree = ast.parse((PORT / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [n for n in names if n.split(".")[0] in ("jax", "mickey_tpu", "build", "_mickey_io", "native")]
    assert native.SOURCE == PORT / "csrc" / "mickey_io.cpp" and native.SOURCE.exists()
    assert "Python.h" not in native.SOURCE.read_text()
