"""CUDA-event ms a step around ``Optimizer.update`` (clipping and Adam over
the trainable leaves, eager)."""

SPANS = {"train_optimizer": "model.optimizer:update"}


def read(run):
    ms = run.device_ms("train_optimizer")
    return None if ms is None or not run.steps else ms / run.steps
