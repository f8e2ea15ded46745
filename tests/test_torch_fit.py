"""The port's training entry point on the CPU: ``MicKeyTrainer.fit`` and
``cli/train.py``.

One train scene and one val scene in the Map-free layout
(``test_torch_data.write_split``: cv2 JPEGs of 116 x 130, read at that size,
so every batch is cropped to 112 x 126 before the backbone, as the
Map-free 540 x 720 frames are to 532 x 714), the model at
``tests/test_torch_validation.py``'s size. ``fit`` runs one epoch with
image logging, as ``tests/test_training.py::TestFitLoop`` does for the JAX
package; the CLI trains, writes its run directory and resumes from its
``last/``. ``create_exp_name`` is the JAX package's for every preset.
"""

import os

import numpy as np
import pytest

from mickey_tpu.cli.train import create_exp_name as jax_exp_name
from mickey_tpu.config import default_config as jax_default_config
from mickey_tpu_torch.cli import train as cli
from mickey_tpu_torch.config import PRESETS, default_config, preset_path
from mickey_tpu_torch.data import DataModuleTraining
from mickey_tpu_torch.models import MicKeyTrainer
from mickey_tpu_torch.weights import init_params_numpy
from test_torch_data import write_split
from test_torch_validation import one_intra_op_thread, train_cfg  # noqa: F401 (the fixture applies here too)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_split(tmp_path_factory.mktemp("fit"), splits=(("train", ("s0",)), ("val", ("v0",))),
                       n_queries=6, seed=5)


def fit_cfg(root):
    cfg = train_cfg()
    cfg.DATASET.DATA_ROOT = str(root)
    cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT = 116, 130  # not multiples of 14: the trainer crops
    cfg.DATASET.MIN_OVERLAP_SCORE, cfg.DATASET.MAX_OVERLAP_SCORE = 0.0, 1.0
    cfg.TRAINING.BATCH_SIZE = cfg.TRAINING.N_SAMPLES_SCENE = 8
    cfg.TRAINING.LOG_INTERVAL = 1
    cfg.TRAINING.EPOCHS = 1
    cfg.TRAINING.VAL_BATCHES = 1
    return cfg


def test_fit_one_epoch_with_image_logging(data_root, tmp_path):
    cfg = fit_cfg(data_root)
    cfg.TPU.LOG_IMAGES = True
    out = tmp_path / "run"
    tr = MicKeyTrainer(cfg, params=init_params_numpy(cfg, 0), device="cpu", out_dir=str(out))
    scalars, images, sizes = {}, {}, set()
    log_scalar, log_image = tr.log_scalar, tr.log_image
    tr.log_scalar = lambda name, value, step=None: (scalars.__setitem__(name, float(value)),
                                                    log_scalar(name, value, step))[1]
    tr.log_image = lambda name, img, step=None: (images.__setitem__(name, np.asarray(img)),
                                                 log_image(name, img, step))[1]
    fwd = tr.val_step.backbone_fwd
    tr.val_step.backbone_fwd = lambda bb, im: (sizes.add(tuple(im.shape[1:3])), fwd(bb, im))[1]
    tr.fit(DataModuleTraining(cfg))

    assert tr.global_step == 1 and tr.topk == 35.0  # one batch; the curriculum advanced once
    assert scalars["train/lr"] == pytest.approx(cfg.TRAINING.LR) and scalars["train/topk"] == 30.0
    assert {"train/loss", "val_vcre/auc_vcre", "val_AUC_pose/auc_pose_10"} <= set(scalars)
    assert np.isfinite(scalars["val_loss/loss"])
    assert sizes == {(126, 112)}  # validation saw the crop
    assert set(images) >= {"training_scores/map0", "training_depth/map1", "training_rewards/pair0"}
    assert images["training_scores/map0"].shape == (126, 112, 3)
    assert sorted(os.listdir(out)) == ["best_pose", "best_vcre", "last", "tb"]
    assert os.listdir(out / "tb")  # tensorboardX wrote its events


def test_cli_trains_and_resumes(data_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the run writes nothing outside it
    cfg = fit_cfg(data_root)
    args = cli.parser().parse_args(["--experiment", "t", "--path_weights", str(tmp_path / "w")])
    first = cli.train_model(args, cfg=cfg.clone(), device="cpu")
    run = tmp_path / "w" / cli.create_exp_name("t", cfg)
    assert {"config.yaml", "last", "best_vcre", "best_pose"} <= set(os.listdir(run))
    assert first.global_step == 1 and first.out_dir == str(run)

    cfg.TRAINING.EPOCHS = 2
    args = cli.parser().parse_args(["--experiment", "t", "--path_weights", str(tmp_path / "w"),
                                    "--resume", str(run / "last")])
    second = cli.train_model(args, cfg=cfg, device="cpu")
    assert second.global_step == 2 and second.topk == 40.0  # epoch 1 only, from epoch 0's state


@pytest.mark.parametrize("preset", sorted(str(p.relative_to(PRESETS).with_suffix("")) for p in PRESETS.rglob("*.yaml")))
def test_exp_name_matches_jax(preset):
    ours, theirs = default_config(), jax_default_config()
    for cfg in (ours, theirs):
        cfg.merge_from_file(str(preset_path(preset)))
    assert cli.create_exp_name("run", ours) == jax_exp_name("run", theirs)
    ours.DEBUG = theirs.DEBUG = True
    assert cli.create_exp_name("run", ours) == jax_exp_name("run", theirs)
