"""The result line's keys, and a run without a card."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import core


def test_result_line_keys_and_order():
    checks = core.Checks({"a": 1.0, "b": 2.0})
    checks.add("a", 0.5)
    checks.add("b", float("inf"))
    line = core.result_line(checks.correct, 8, 0, {"m": 1.5}, {"m": "ms"},
                            {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 3}, checks,
                            {"device_ops": [], "idle_gaps": []})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert d["correct"] is False and d["checks"]["b"] == {"value": 1e300, "limit": 2.0}
    assert d["metrics"] == {"m": {"value": 1.5, "unit": "ms"}}
    assert "breakdown" not in json.loads(core.result_line(True, 1, 0, {}, {}, {}, core.Checks({})))


def test_a_run_without_a_card_prints_no_result(card_absent):
    proc = subprocess.run([sys.executable, str(core.PERFBENCH / "run.py"), "--workload", "vitl14.submit.kf.b8",
                           "--seed", "2147483999", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          cwd=core.ROOT, timeout=300)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
