"""Upstream checkpoint loading: the port's converters against mickey_tpu's.

A synthetic upstream Lightning ``.ckpt`` (heads and matcher, under
``state_dict`` with the ``compute_matches.`` prefix) and a DINOv2 ``.pth``
are written from seeded params by inverting the JAX package's layout
(``chip_smoke.upstream_state_dicts``: HWIO -> OIHW, (in, out) -> (out, in),
head-major qkv -> [q|k|v]). Both packages load them; after
``params_to_torch`` every parameter must be bitwise equal, and equal to the
params they were written from. Then the loader's guards: a checkpoint
without DINOv2 weights, the environment opt-outs, a native checkpoint
directory, and the ``weights_only`` refusal.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mickey_tpu.training import checkpoint as jckpt
from mickey_tpu_torch.models import build_model
from mickey_tpu_torch.training import checkpoint as ckpt
from mickey_tpu_torch.weights import init_params_numpy, params_to_torch, tree_leaves
from test_torch_slice import small_cfg

DEPTH = 2


@pytest.fixture(scope="module")
def params():
    p = init_params_numpy(small_cfg(), 3)
    p["dinov2"]["blocks"] = jax.tree.map(lambda a: a[:DEPTH], p["dinov2"]["blocks"])
    return p


@pytest.fixture
def files(params, tmp_path):
    sd, dino = chip_smoke.upstream_state_dicts(params)
    paths = tmp_path / "mickey.ckpt", tmp_path / "dinov2_vitl14_pretrain.pth"
    torch.save({"state_dict": sd}, paths[0])
    torch.save(dino, paths[1])
    return tuple(map(str, paths))


def _assert_bitwise(a, b):
    """The same leaves (by path: ``jax.tree.map`` reorders dict keys), bitwise."""
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    assert sorted(la) == sorted(lb)
    for path, x in la.items():
        assert torch.equal(x, lb[path]) if torch.is_tensor(x) else x == lb[path], path


def test_loader_matches_jax_bitwise(params, files):
    cfg = small_cfg()
    ref = jckpt.load_reference_checkpoint(files[0])  # heads and matcher
    ref["dinov2"] = jckpt.convert_dinov2_state_dict(jckpt.load_torch_state_dict(files[1]), depth=DEPTH)
    ref = params_to_torch(jax.tree.map(np.asarray, ref), cfg)
    ours = build_model(cfg, checkpoint=files[0], dinov2_path=files[1], seed=1, device="cpu").params
    _assert_bitwise(ours, ref)
    _assert_bitwise(ours, params_to_torch(params, cfg))  # the round trip through the upstream layout


def test_raw_state_dict_without_prefix(params, files):
    """The converters take the raw state dict too, with or without the
    ``compute_matches.`` prefix, as the JAX package's do."""
    sd = ckpt.load_torch_state_dict(files[0])["state_dict"]
    raw = {k.removeprefix("compute_matches."): v for k, v in sd.items()}
    a, b = ckpt.convert_mickey_state_dict(raw), jckpt.convert_mickey_state_dict(raw)
    for (pa, x), (pb, y) in zip(jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)):
        assert pa == pb and np.array_equal(x, np.asarray(y))
    qkv = ckpt.convert_dinov2_state_dict(ckpt.load_torch_state_dict(files[1]))["blocks"]["attn"]["qkv"]["w"]
    np.testing.assert_array_equal(qkv, params["dinov2"]["blocks"]["attn"]["qkv"]["w"])  # depth read from the keys


def test_missing_dinov2_guard(params, files, tmp_path, monkeypatch):
    """No DINOv2 file anywhere: a checkpoint raises unless
    ``MICKEY_ALLOW_RANDOM_BACKBONE=1``, which keeps the random backbone;
    ``MICKEY_DINOV2_PATH`` finds the file; a directory (a native
    checkpoint) is refused."""
    cfg = small_cfg()
    monkeypatch.delenv("MICKEY_DINOV2_PATH", raising=False)
    monkeypatch.delenv("MICKEY_ALLOW_RANDOM_BACKBONE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    (tmp_path / "cwd").mkdir()
    monkeypatch.chdir(tmp_path / "cwd")  # no weights/ here
    assert ckpt.resolve_dinov2_weights() is None
    with pytest.raises(FileNotFoundError):
        build_model(cfg, params, checkpoint=files[0], device="cpu")
    monkeypatch.setenv("MICKEY_ALLOW_RANDOM_BACKBONE", "1")
    m = build_model(cfg, params, checkpoint=files[0], device="cpu")
    expected = params_to_torch(params, cfg)
    _assert_bitwise(m.params, expected)  # the heads from the file, the backbone from ``params``
    with pytest.raises(NotImplementedError):
        build_model(cfg, params, checkpoint=str(tmp_path), device="cpu")
    monkeypatch.delenv("MICKEY_ALLOW_RANDOM_BACKBONE")
    monkeypatch.setenv("MICKEY_DINOV2_PATH", files[1])
    assert ckpt.resolve_dinov2_weights() == files[1]
    _assert_bitwise(build_model(cfg, checkpoint=files[0], seed=1, device="cpu").params, expected)


def test_weights_only_refusal(params, tmp_path, monkeypatch):
    """A checkpoint with non-tensor metadata is refused by both packages,
    and loads in the port only with ``MICKEY_UNSAFE_TORCH_LOAD=1``."""
    sd, _ = chip_smoke.upstream_state_dicts(params)
    path = str(tmp_path / "with_hparams.ckpt")
    torch.save({"state_dict": sd, "hyper_parameters": argparse.Namespace(lr=1e-4)}, path)
    monkeypatch.delenv("MICKEY_UNSAFE_TORCH_LOAD", raising=False)
    for load in (ckpt.load_torch_state_dict, jckpt.load_torch_state_dict):
        with pytest.raises(RuntimeError, match="MICKEY_UNSAFE_TORCH_LOAD"):
            load(path)
    monkeypatch.setenv("MICKEY_UNSAFE_TORCH_LOAD", "1")
    loaded = ckpt.load_torch_state_dict(path)
    assert loaded["hyper_parameters"].lr == 1e-4
    ours = ckpt.convert_mickey_state_dict(loaded)
    np.testing.assert_array_equal(ours["det_head"]["out"]["w"], params["det_head"]["out"]["w"])
