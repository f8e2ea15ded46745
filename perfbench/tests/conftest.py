"""The harness's own tests: ``python -m pytest perfbench/tests -q`` from the
checkout's root, on the CPU. Tests marked ``cuda`` need a card and skip
without one (a fixture decides, never an import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; a fixture skips the test where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


DATA = Path(__file__).resolve().parent / "data"
TINY_LIMITS = {  # the tiny size's own limits (the cells' are in perfbench/limits/)
    "submit": {"feat_err": 8e-3, "maps_err": 1.2e-2, "table_err": 1e-4, "pose_err": 1e-5, "solve_err": 5e-6},
    "train": {"fmap_err": 3e-2, "loss_err": 1e-4, "grad_err": 1e-3, "delta_err": 5e-2, "delta_median_err": 3e-2},
}


def tiny_cell(kind: str):
    """A cell at a size the CPU runs in seconds: ViT-S/14 on 140 x 140
    frames, narrow heads, a small solver and loss budget (``data/``)."""
    import json

    from mickey_tpu_torch.config import default_config
    from perfbench.harness import core

    data = json.loads((DATA / "tiny.json").read_text())
    cfg = default_config()
    cfg.merge_from_other(data["config"])
    traffic = json.loads((DATA / f"tiny-{kind}.json").read_text())
    e2e = ("pairs_per_s", "batch_ms_p90", "peak_mem_gib", "setup_s") if kind == "submit" else (
        "train_step_ms", "peak_mem_gib", "setup_s")
    cell = core.Cell({"name": f"tiny.{kind}", "chips": 1}, cfg, data, traffic,
                     [{"name": n, "unit": "u"} for n in e2e], [])
    cell.limits = dict(TINY_LIMITS[kind])
    return cell


@pytest.fixture
def one_thread():
    """One intra-op thread: the tests run beside others."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
