"""The whole training step's share of the card's peak, in %: the least time
the card could take for the window's steps (the backbone's forward at the
bf16 peak; the heads' forward and backward, three times the forward's
products, and the matcher's correlation forward and its two backward
products at the fp32-accurate peak; the loss's hypothesis scoring at the
fp32 peak) over the window's wall time less the tracer's own seconds in
it (its syncs and profiler switches)."""

from perfbench.harness import bounds


def read(run):
    cfg = run.cell.cfg
    spec = run.cell.traffic
    df = cfg["MICKEY"]["DINOV2"]["DOWN_FACTOR"]
    hw = (spec["frame_height"] // df) * (spec["frame_width"] // df)
    if not run.steps or run.work_s <= 0:
        return None
    return 100.0 * run.steps * bounds.train_least_s(cfg, spec["batch_size"], hw, run.vit()) / run.work_s
