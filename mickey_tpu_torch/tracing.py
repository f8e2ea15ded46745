"""The port's spans and counters: where a batch's or a step's time goes.

Stages of the port open spans at their boundaries (never inside a per-leaf,
per-block or per-iteration loop)::

    with tracing.span("predict.stage", request=step):
        ...
        tracing.count("kf_hits", 3)

Off, the default, ``span`` returns one shared no-op context and ``count``
returns at once: no allocation, no clock read, no CUDA call. ``enable()``
turns recording on for the process (the port's host path is one thread a
process); ``take()`` returns the records made since and clears them.

A record holds its name, an id, its parent's id (the innermost span open
when it opened), the request it served (a served batch, a training step:
given, else the parent's), its host start and end on
``time.perf_counter_ns``, its device time where the span asked for one
(``device=True``: a CUDA event pair, read by ``take``) and its counters.
Every record counts ``launches``: the hand-written kernels launched within
it (``ops._cuda.LAUNCHES``, summed over kernels).

While enabled, each span also enters ``torch.profiler.record_function``
under the name ``"span:" + name``, so that a profiler running at the same
time puts the program's stages on its host timeline, on the clock of the
device's kernels and the CUDA runtime's calls.

``write_chrome_trace(records, path)`` writes records as a Chrome trace
(JSON), which Perfetto (ui.perfetto.dev) opens: the CLIs' ``--trace_out``.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

from .ops import _cuda


@dataclass
class Record:
    """One span: host times in ns on ``time.perf_counter_ns``; ``device_ms``
    the CUDA events' elapsed time, or None; ``crossing``: made by ``record``."""

    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    start_ns: int
    end_ns: int = 0
    device_ms: Optional[float] = None
    counters: dict = field(default_factory=dict)
    crossing: bool = False


class _Tracer:
    """The process's recording state (module docstring)."""

    def __init__(self):
        self.on = False
        self.device_times = False
        self.next_id = 0
        self.records: list = []
        self.open: list = []  # the records of the spans open now, innermost last
        self.timed: list = []  # (record, start event, end event) of the spans timed on the device


_T = _Tracer()
_NOOP = contextlib.nullcontext()


def _launches() -> int:
    return sum(_cuda.LAUNCHES.values())


def _new(name: str, parent: Optional[Record], request, start_ns: int = 0) -> Record:
    rec = Record(name, _T.next_id, parent.id if parent else None,
                 request if request is not None or parent is None else parent.request, start_ns)
    _T.next_id += 1
    _T.records.append(rec)
    return rec


class _Span:
    __slots__ = ("name", "request", "device", "rec", "fn", "events", "launches0")

    def __init__(self, name: str, request, device: bool):
        self.name, self.request, self.device = name, request, device

    def __enter__(self):
        self.rec = rec = _new(self.name, _T.open[-1] if _T.open else None, self.request)
        _T.open.append(rec)
        self.fn = torch.profiler.record_function("span:" + self.name)
        self.fn.__enter__()
        self.events = None
        if self.device and _T.device_times:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            _T.timed.append((rec, *self.events))
            self.events[0].record()
        self.launches0 = _launches()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        rec.counters["launches"] = rec.counters.get("launches", 0) + _launches() - self.launches0
        if self.events:
            self.events[1].record()
        self.fn.__exit__(*exc)
        _T.open.pop()
        return False


def span(name: str, request: Optional[int] = None, device: bool = False):
    """A context for one stage: a record while tracing is on, else the shared
    no-op. ``request``: the batch or step it serves (default: the parent
    span's); ``device``: also time it on the device with CUDA events."""
    if not _T.on:
        return _NOOP
    return _Span(name, request, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span."""
    if _T.on and _T.open:
        c = _T.open[-1].counters
        c[name] = c.get(name, 0) + n


def clock() -> int:
    """``time.perf_counter_ns()`` while tracing is on, else 0 (no clock read):
    the start of a ``record`` made later."""
    return time.perf_counter_ns() if _T.on else 0


def record(name: str, start_ns: int, request: Optional[int] = None) -> None:
    """A finished span from ``start_ns`` (``clock()``) to now, with no parent:
    a stretch that crosses other spans' boundaries, such as a served batch
    from its hand-over to its poses on the host. Nothing while off, or where
    ``start_ns`` was taken while off."""
    if _T.on and start_ns:
        rec = _new(name, None, request, start_ns)
        rec.end_ns, rec.crossing = time.perf_counter_ns(), True


def enable() -> None:
    """Record from now on; spans that ask for it are also timed on the
    device, where CUDA is available."""
    _T.on = True
    _T.device_times = torch.cuda.is_available()


def disable() -> None:
    """Stop recording; the records made stay until ``take``."""
    _T.on = False


def enabled() -> bool:
    return _T.on


def take() -> list:
    """The records made since the last ``take``, in the order they opened,
    and clears them. Reads each closed span's device time, waiting for its
    events; a span still open finishes into the returned record, without
    one."""
    for rec, e0, e1 in _T.timed:
        if rec.end_ns:
            e1.synchronize()
            rec.device_ms = e0.elapsed_time(e1)
    out, _T.records, _T.timed = _T.records, [], []
    return out


@contextlib.contextmanager
def traced(path):
    """Record while the context runs, then write the records to ``path`` as a
    Chrome trace (``write_chrome_trace``), also when the run raised, so the
    trace shows where it stopped; with no ``path``, nothing."""
    if not path:
        yield
        return
    enable()
    try:
        yield
    finally:
        disable()
        write_chrome_trace(take(), path)


def write_chrome_trace(records, path) -> None:
    """``records`` (``take()``'s) as a Chrome trace at ``path``: one complete
    event a span, on the host's clock in microseconds, with its request,
    counters and device time as arguments. Spans made by ``record`` go on a
    track of their own, since they overlap the stages. Makes ``path``'s
    directory where it is missing."""
    events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid, "args": {"name": label}}
              for tid, label in ((0, "stages"), (1, "requests"))]
    for r in records:
        args = {"id": r.id, "parent": r.parent, "request": r.request, **r.counters}
        if r.device_ms is not None:
            args["device_ms"] = r.device_ms
        events.append({"ph": "X", "name": r.name, "cat": "span", "pid": 0, "tid": int(r.crossing),
                       "ts": r.start_ns / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
