"""Every cell of BENCHMARK.json resolves by name to its files, and the file
keeps to the benchmark's rules where a test can read it."""

import json
import re

import pytest

from perfbench.harness import core

BENCH = core.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves_by_name(workload):
    cell = core.resolve(workload)
    assert (core.PERFBENCH / "configs" / f"{cell.workload['config']}.json").is_file()
    assert (core.PERFBENCH / "traffic" / f"{cell.workload['traffic']}.json").is_file()
    assert (core.PERFBENCH / "limits" / f"{workload}.json").is_file()
    assert core.runner(cell).run
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    for m in cell.per_layer:
        assert callable(cell.readers[m["name"]].read)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {workload} does not report"


def test_file_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1].startswith("perfbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(BENCH["end_to_end"]) + len(
        BENCH["per_layer"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and set(m["workloads"]) <= cells
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for c in BENCH["configs"]:
        data = json.loads((core.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        assert c["file"].startswith("perfbench/configs/")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_layers_named_alike():
    """Metrics of one layer give the same layer, letter for letter."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"serving loop", "backbone", "heads", "matcher", "solver", "training step", "kernels", "device",
                      "whole step"}


def test_share_metrics_are_percent_and_higher_is_better():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
