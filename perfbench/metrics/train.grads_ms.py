"""CUDA-event ms a step around ``training.train_step.loss_and_grads`` (the
heads' forward in training mode, the matcher, the loss and the backward:
K4, K5)."""

SPANS = {"train_grads": "mickey_tpu_torch.training.train_step:loss_and_grads"}


def read(run):
    ms = run.device_ms("train_grads")
    return None if ms is None or not run.steps else ms / run.steps
