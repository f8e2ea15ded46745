"""Training CLI (``mickey_tpu/cli/train.py``), on one card or N.

Usage:
    python -m mickey_tpu_torch.cli.train --config mickey_tpu_torch/configs/MicKey/curriculum_learning.yaml \
        --dataset_config mickey_tpu_torch/configs/datasets/mapfree.yaml --experiment my_run
    python -m torch.distributed.run --nproc_per_node=N -m mickey_tpu_torch.cli.train ...

Under ``torch.distributed.run`` (``WORLD_SIZE`` > 1) every rank joins one
NCCL group on ``cuda:LOCAL_RANK`` and trains data-parallel
(``models/training_model.py``): ``TRAINING.BATCH_SIZE`` is the global batch,
the dataset seed is rank 0's, and rank 0 alone writes the run directory.

Writes ``<path_weights>/<experiment name>/``: the merged config, the
overlay, ``last/``, ``best_vcre/`` and ``best_pose/`` (native checkpoints,
``training/checkpoint.py``; ``--resume <dir>/last`` continues a run) and,
where tensorboardX imports, ``tb/``. ``--feature_cache <dir>`` trains on
cached frozen-backbone features (built on the first run). ``--trace_out
<file>`` writes the run's spans as a Chrome trace (``tracing``). The model
runs on ``cuda``; a caller may pass ``train_model(args, device="cpu")``.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil


def create_exp_name(exp_name: str, cfg) -> str:
    """The run's name from the loss, curriculum, heads and matcher settings."""
    exp_name += "_Loss_" + cfg.LOSS_CLASS.LOSS_FUNCTION
    exp_name += "_SoftClipping" if cfg.LOSS_CLASS.SOFT_CLIPPING else ""
    if cfg.LOSS_CLASS.CURRICULUM_LEARNING.TRAIN_CURRICULUM:
        exp_name += "_Curriculum"
    elif cfg.LOSS_CLASS.CURRICULUM_LEARNING.TRAIN_WITH_TOPK:
        exp_name += "_TrainTop" + str(cfg.LOSS_CLASS.CURRICULUM_LEARNING.TOPK)
    exp_name += "_NullHypothesis" if cfg.LOSS_CLASS.NULL_HYPOTHESIS.ADD_NULL_HYPOTHESIS else ""
    if cfg.MICKEY.KP_HEADS.USE_DEPTHSIGMOID:
        exp_name += "_DepthSigmoid_" + str(int(cfg.MICKEY.KP_HEADS.MAX_DEPTH))
    exp_name += "_" + cfg.FEATURE_MATCHER.TYPE
    exp_name += "_Debug" if cfg.DEBUG else ""
    return exp_name


def train_model(args, cfg=None, device="cuda"):
    """One training run from ``args``; returns the trainer. ``cfg`` (default:
    the merged config files) may be given by a caller. In a data-parallel
    group (``parallel.world()``) the model runs on the rank's device; a
    group joined on the CPU of a machine with CUDA devices raises unless
    ``device`` is the CPU."""
    import torch

    from .. import parallel
    from ..config import default_config
    from ..data.loader import DataModuleTraining
    from ..models.training_model import MicKeyTrainer

    if cfg is None:
        cfg = default_config()
        if args.dataset_config:
            cfg.merge_from_file(args.dataset_config)
        if args.config:
            cfg.merge_from_file(args.config)
    if args.feature_cache:
        cfg.TPU.FEATURE_CACHE = args.feature_cache

    dp = parallel.world()
    if dp.size > 1:
        parallel.refuse_cpu_group(dp, asked_cpu=torch.device(device).type == "cpu")
        device = dp.device
    main = dp.rank == 0
    exp_name = create_exp_name(args.experiment, cfg)
    if main:
        print("Start training of " + exp_name)

    # every rank's sampler draws rank 0's sequence
    cfg.DATASET.SEED = dp.broadcast_object(random.randint(0, 1000000))

    out_dir = os.path.join(args.path_weights, exp_name)
    if main:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.yaml"), "w") as f:
            f.write(cfg.dump())
        if args.config:
            shutil.copyfile(args.config, os.path.join(out_dir, "config_overlay.yaml"))

    trainer = MicKeyTrainer(cfg, seed=args.seed, device=device, out_dir=out_dir, dp=dp)
    datamodule = DataModuleTraining(cfg)
    if main:
        print("Training with {:.2f}/{:.2f} image overlap".format(cfg.DATASET.MIN_OVERLAP_SCORE,
                                                                cfg.DATASET.MAX_OVERLAP_SCORE))
    trainer.fit(datamodule, resume_path=args.resume)
    return trainer


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="", help="model config yaml overlay")
    p.add_argument("--dataset_config", default="", help="dataset config yaml overlay")
    p.add_argument("--experiment", default="MicKey_tpu_default")
    p.add_argument("--path_weights", default="weights/")
    p.add_argument("--resume", default=None, help="native checkpoint directory (a run's last/) to resume from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--feature_cache", default="",
                   help="directory of the frozen-backbone feature cache (built on the first run): training "
                        "skips the DINOv2 forward (training/feature_cache.py)")
    p.add_argument("--trace_out", default=None,
                   help="write the run's spans (the training step's phases, validation's solver stages) to "
                        "this file as a Chrome trace, which Perfetto opens (rank 0's in a data-parallel run)")
    return p


def main(argv=None):
    """The CLI (``argv``: its arguments, by default the command line's); a
    rank that ``parallel.launch`` started trains in its group."""
    from .. import parallel, tracing

    args = parser().parse_args(argv)
    distributed = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if distributed:  # NCCL on cuda:LOCAL_RANK: a rank without a card raises here
        parallel.build_libraries_once(parallel.init_data_parallel("nccl"))
    try:
        with tracing.traced(args.trace_out if parallel.world().rank == 0 else None):
            train_model(args)
    finally:
        if distributed:
            parallel.close_data_parallel()


if __name__ == "__main__":
    main()
