"""The port's one-command quality run (``tools/quality_run_torch.py``) against
the JAX tool it ports (``tools/quality_run.py``), on the CPU.

The micro-dataset is the JAX tool's byte for byte. The port's dry run (random
weights, the JAX tool's cut configuration) goes through all four steps,
the demo leg included, and exits 0 with ``submission.zip`` and the
evaluator's metrics under the keys the JAX dry run's evaluation gives. The
real run waits for weights: it refuses to start without them, and the tool
serves on the card unless asked for the CPU.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import tools.quality_run as jax_tool
import tools.quality_run_torch as tool
from mickey_tpu.evaluation.mapfree import evaluate as jax_evaluate


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: under the tier-1 run's test workers torch's
    OpenMP threads spin against each other's (``tests/test_torch_submission.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_micro_dataset_is_the_jax_tools_byte_for_byte(tmp_path):
    tool.synthesize_micro_dataset(tmp_path / "ours")
    jax_tool.synthesize_micro_dataset(tmp_path / "ref")
    ours, ref = _files(tmp_path / "ours"), _files(tmp_path / "ref")
    assert len(ref) == 2 * (4 + 2) and list(ours) == list(ref)
    assert all(ours[k] == ref[k] for k in ref)


def test_dry_run_config_is_the_jax_tools():
    from mickey_tpu.config import default_config as jax_default_config
    from mickey_tpu_torch import default_config

    ours, ref = default_config(), jax_default_config()
    assert tool.dry_run_config(ours) == (112, 126)
    # the JAX tool's main cuts its config in place; the same assignments, read back from its source
    ref.MICKEY.DINOV2.VARIANT, ref.MICKEY.DINOV2.CHANNEL_DIM, ref.MICKEY.DINOV2.FLOAT16 = "vit_small", 384, False
    ref.MICKEY.KP_HEADS.BLOCKS_DIM, ref.MICKEY.DSC_HEAD.LAST_DIM = [32, 16, 128, 8], 16
    ref.PROCRUSTES.IT_MATCHES, ref.PROCRUSTES.IT_RANSAC, ref.PROCRUSTES.NUM_SAMPLED_MATCHES = 2, 8, 64
    ref.TPU.SAMPLING_PREFILTER = 0
    ref.DATASET.WIDTH, ref.DATASET.HEIGHT = 112, 126
    assert ours.to_dict() == ref.to_dict()
    assert tool.EXPECTED == jax_tool.EXPECTED and tool.TOLERANCE == jax_tool.TOLERANCE


def test_dry_run_on_the_cpu_matches_the_jax_dry_runs_metrics(tmp_path, monkeypatch, one_torch_thread, capsys):
    """The port's dry run on the CPU, its demo leg on two JPEGs, against the
    JAX tool's dry run (demo leg skipped, as its own test does): both exit
    0 and write the zip, and the port's metrics have the keys of the JAX
    evaluator's on the JAX run's zip."""
    import cv2

    toy = tmp_path / "toy"
    toy.mkdir()
    rng = np.random.default_rng(0)
    for name in ("im0.jpg", "im1.jpg"):
        assert cv2.imwrite(str(toy / name), rng.uniform(0, 255, (172, 200, 3)).astype(np.uint8))
    (toy / "intrinsics.txt").write_text("".join(f"{n} 590.0 590.0 100.0 86.0 200 172\n" for n in ("im0.jpg", "im1.jpg")))
    monkeypatch.setenv("MICKEY_TOY_EXAMPLE", str(toy))
    monkeypatch.setenv("MICKEY_ALLOW_RANDOM_BACKBONE", "0")  # the dry runs set it: restored after the test
    rc, metrics = tool.quality_run(tool.parser().parse_args(["--dry-run", "--out", str(tmp_path / "ours"),
                                                              "--device", "cpu"]))
    assert rc == 0 and (tmp_path / "ours" / "submission.zip").is_file()
    assert "[quality] demo pair OK" in capsys.readouterr().out
    assert all(np.isfinite(v) for v in metrics.values())

    monkeypatch.setenv("MICKEY_TOY_EXAMPLE", str(tmp_path / "missing"))
    assert jax_tool.main(["--dry-run", "--out", str(tmp_path / "ref")]) == 0
    ref, _ = jax_evaluate(tmp_path / "ref" / "submission.zip", tmp_path / "ref" / "dataset" / "val")
    assert list(metrics) == list(ref)
    assert tool.main(["--dry-run", "--out", str(tmp_path / "again"), "--device", "cpu"]) == 0


def test_real_run_waits_for_weights_and_the_card(tmp_path, monkeypatch):
    monkeypatch.setenv("MICKEY_ALLOW_RANDOM_BACKBONE", "0")
    with pytest.raises(SystemExit):  # no checkpoint, no dataset: refused
        tool.main([])
    assert tool.parser().parse_args(["--dry-run"]).device == "cuda"
    if not torch.cuda.is_available():  # on the card by default: no fallback to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            tool.main(["--dry-run", "--out", str(tmp_path / "q")])
