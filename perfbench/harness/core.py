"""What every cell shares: the benchmark's files found by name, the run's
arguments, the checks on the machine and on the loaded modules, the
comparison numbers and the result line.

Files are found by the names ``BENCHMARK.json`` gives, so a later change adds
a cell, a configuration, a traffic mix or a metric as new files:

- ``perfbench/configs/<config>.json``: the model configuration (overrides of
  the program's default config) with its source, ``reduced`` and ``assumed``;
- ``perfbench/traffic/<traffic>.json``: the mix's parameters, whose
  ``runner`` names the module of ``perfbench/harness`` that runs it;
- ``perfbench/metrics/<metric>.py``: a per-layer metric's reader;
- ``perfbench/limits/<workload>.json``: the limits of the cell's comparison
  numbers, with the readings each was set from.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent
# top-level modules that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mickey_tpu", "chip_smoke")
# the program's packages reach the harness through the checkout's root
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class BenchError(RuntimeError):
    """A run that cannot give a result (exit code 2)."""


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once and print its result line.")
    p.add_argument("--workload", required=True, help="a name from BENCHMARK.json's workloads")
    p.add_argument("--seed", type=int, required=True, help="inputs and weights are drawn from it")
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="0: the end-to-end metrics; 1: the per-layer ones, under the profiler")
    return p.parse_args(argv)


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    if not path.is_file():
        raise BenchError(f"no {path.name} beside perfbench/")
    return json.loads(path.read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_config(entry: dict):
    """(the program's config with the file's overrides, the file's JSON)."""
    from mickey_tpu_torch.config import default_config

    data = json.loads((ROOT / entry["file"]).read_text())
    cfg = default_config()
    cfg.merge_from_other(data["config"])
    return cfg, data


def load_traffic(name: str) -> dict:
    path = PERFBENCH / "traffic" / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no traffic file perfbench/traffic/{name}.json")
    return json.loads(path.read_text())


def load_limits(workload: str) -> dict:
    """The cell's limits file: ``limits``, number -> its limit and the
    readings it was set from."""
    path = PERFBENCH / "limits" / f"{workload}.json"
    if not path.is_file():
        raise BenchError(f"no limits file perfbench/limits/{workload}.json")
    return json.loads(path.read_text())


def load_reader(name: str):
    """The module of ``perfbench/metrics/<name>.py``: ``SPANS`` (span name ->
    "module:attribute" or "model:method") and ``read(run)`` -> a number or
    None."""
    path = PERFBENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader perfbench/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of BENCHMARK.json, resolved."""

    workload: dict
    cfg: object
    config_file: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    readers: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def resolve(name: str, bench: dict | None = None) -> Cell:
    bench = load_benchmark() if bench is None else bench
    wl = _by_name(bench["workloads"], name, "workload")
    cfg, data = load_config(_by_name(bench["configs"], wl["config"], "config"))
    cell = Cell(wl, cfg, data, load_traffic(wl["traffic"]),
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])
    cell.readers = {m["name"]: load_reader(m["name"]) for m in cell.per_layer}
    cell.limits = {k: float(v["limit"]) for k, v in load_limits(name)["limits"].items()}
    return cell


def span_specs(cell: Cell) -> dict:
    """The spans the cell's per-layer readers ask for."""
    return {k: v for r in cell.readers.values() for k, v in getattr(r, "SPANS", {}).items()}


def read_per_layer(cell: Cell, run) -> dict:
    """Each per-layer metric its reader finds something to read for."""
    values = {m["name"]: cell.readers[m["name"]].read(run) for m in cell.per_layer}
    return {k: v for k, v in values.items() if v is not None}


def runner(cell: Cell):
    return importlib.import_module(f"perfbench.harness.{cell.traffic['runner']}")


def require_cards(n: int):
    """The run's cards, or BenchError: a run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark measures the program on the card")
    if torch.cuda.device_count() < n:
        raise BenchError(f"the cell needs {n} cards, {torch.cuda.device_count()} visible")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}


def host_note() -> str:
    """What the host looked like at the window's close (read, never set): the
    cores the process may use and the one it last ran on, the load average,
    and the cores' clocks (min / mean / max MHz)."""
    try:
        cpu = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[36]
        load = " ".join(Path("/proc/loadavg").read_text().split()[:3])
        mhz = [float(line.split(":")[1]) for line in Path("/proc/cpuinfo").read_text().splitlines()
               if line.startswith("cpu MHz")]
        clock = f"{min(mhz):.0f} / {sum(mhz) / len(mhz):.0f} / {max(mhz):.0f} MHz" if mhz else "no clock"
        import os

        return f"cores {len(os.sched_getaffinity(0))}, last on {cpu}, load {load}, {clock}"
    except (OSError, IndexError, ValueError) as e:
        return f"not read ({e})"


def chunk_rates(times: list, start: float, end: float, seconds: float = 10.0) -> list:
    """Events a second in each ``seconds`` of [start, end] (the last part
    from its start to ``end``, half a part to one and a half long): how
    steady the rate was within the window."""
    n = max(1, int((end - start) / seconds + 0.5))
    edges = [start + i * seconds for i in range(n)] + [end]
    return [sum(a <= t < b for t in times) / (b - a) for a, b in zip(edges, edges[1:])]


@dataclass
class Checks:
    """Comparison numbers beside their limits; a number passes at or under
    its limit (a NaN never passes)."""

    limits: dict
    values: dict = field(default_factory=dict)
    notes: dict = field(default_factory=dict)  # readings beside the numbers, not compared

    def note(self, name: str, value: float):
        self.notes[name] = float(value)

    def add(self, name: str, value: float):
        if name not in self.limits:
            raise BenchError(f"no limit for {name!r}")
        self.values[name] = float(value)

    @property
    def correct(self) -> bool:
        return bool(self.values) and all(v <= self.limits[k] for k, v in self.values.items())

    def as_dict(self) -> dict:
        """JSON-safe: a number that is not finite (a fault) reads 1e300."""
        return {k: {"value": v if math.isfinite(v) else 1e300, "limit": self.limits[k]} for k, v in self.values.items()}

    def lines(self) -> list:
        return [f"reading {k} {v!r} (not compared)" for k, v in self.notes.items()] + [
            f"check {k} {v!r} limit {self.limits[k]!r} {'ok' if v <= self.limits[k] else 'FAILED'}"
            for k, v in self.values.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, units: dict, device: dict,
                checks: Checks, breakdown: dict | None = None) -> str:
    """The last line of standard output: correct, attempted, failed, the
    metrics, the device (and the traced run's breakdown), the comparison
    numbers last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": units[k]} for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks.as_dict()
    return json.dumps(out)
