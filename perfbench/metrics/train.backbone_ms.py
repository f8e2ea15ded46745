"""CUDA-event ms a step around ``StagedTrainStep.backbone_fwd`` (the frozen
DINOv2 pass over the 2B images, K1)."""

SPANS = {"train_backbone": "model:backbone_fwd"}


def read(run):
    ms = run.device_ms("train_backbone")
    return None if ms is None or not run.steps else ms / run.steps
