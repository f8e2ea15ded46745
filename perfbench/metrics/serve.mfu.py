"""The whole served step's share of the card's peak, in %: the least time the
card could take for the window's work (each extraction's backbone at the bf16
peak and heads at the fp32-accurate peak, each pair's correlation at the
fp32-accurate peak and hypothesis scoring at the fp32 peak) over the
window's wall time less the tracer's own seconds in it (its syncs and
profiler switches)."""

from perfbench.harness import bounds


def read(run):
    cfg = run.cell.cfg
    spec = run.cell.traffic
    df = cfg["MICKEY"]["DINOV2"]["DOWN_FACTOR"]
    hw = (spec["frame_height"] // df) * (spec["frame_width"] // df)
    if not run.pairs or run.work_s <= 0:
        return None
    return 100.0 * bounds.serve_least_s(cfg, run.images, run.pairs, hw, run.vit()) / run.work_s
