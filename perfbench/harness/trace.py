"""The traced run's instruments, all from outside the program: spans around
calls into its layers (CUDA events and the host clock, the calls'
arguments), and the profiler's device timeline (busy time, kernel time by
name, idle gaps by what the host was running).
"""

from __future__ import annotations

import contextlib
import importlib
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Call:
    host0: float
    host1: float
    args: tuple  # the call's arguments as ``_summary`` keeps them
    profiled: bool
    events: tuple  # (start, end) CUDA events

    @property
    def host_ms(self) -> float:
        return (self.host1 - self.host0) * 1e3

    @property
    def device_ms(self) -> float:
        return self.events[0].elapsed_time(self.events[1])


def _summary(a):
    """What a span keeps of an argument, holding no tensor alive: a tensor as
    (shape, dtype), a number or string as it is, a list or tuple item by
    item, anything else by its type's name."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.dtype
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    if isinstance(a, (list, tuple)):
        return tuple(_summary(x) for x in a)
    return type(a).__name__


@dataclass
class Spans:
    """Span name -> its calls. ``install`` wraps "module:attribute" (a
    module-level function, looked up there by its callers), "model:method"
    (a method of the object under test) or "model.attr:method" (of one of its
    attributes) for the life of the context."""

    model: object
    calls: dict = field(default_factory=dict)
    profiling: bool = False  # calls are marked as within the device-profiled window
    annotate: bool = False  # calls are named on the host profiler's timeline

    def _wrap(self, name, fn):
        calls = self.calls.setdefault(name, [])

        def wrapper(*args, **kwargs):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            e0.record()
            if self.annotate:
                with torch.profiler.record_function(f"span:{name}"):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            e1.record()
            calls.append(Call(h0, time.perf_counter(), tuple(_summary(a) for a in args), self.profiling, (e0, e1)))
            return out

        return wrapper

    @contextlib.contextmanager
    def install(self, specs: dict):
        undo = []
        try:
            for name, target in specs.items():
                owner_name, attr = target.split(":")
                if owner_name.split(".")[0] == "model":  # "model" or "model.<attribute>..."
                    owner = self.model
                    for a in owner_name.split(".")[1:]:
                        owner = getattr(owner, a)
                else:
                    owner = importlib.import_module(owner_name)
                undo.append((owner, attr, vars(owner).get(attr)))
                setattr(owner, attr, self._wrap(name, getattr(owner, attr)))
            yield self
        finally:
            for owner, attr, old in reversed(undo):
                if old is None:  # a method of the class: drop the instance's wrapper
                    delattr(owner, attr)
                else:
                    setattr(owner, attr, old)


def device_intervals(events) -> list:
    """[(start_us, end_us, name)] of the profiled device activity (kernels,
    copies, sets); the spans' own ranges, which the profiler also puts on
    the device's timeline, are left out."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("span:"))


def busy_s(intervals) -> float:
    """Seconds in which the device ran at least one operation: the union of
    its intervals."""
    busy, end = 0.0, float("-inf")
    for a, b, _ in intervals:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def kernel_seconds(intervals) -> dict:
    out = {}
    for a, b, name in intervals:
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def idle_gaps(intervals, host_events, lo: float, hi: float) -> dict:
    """Idle seconds of the device within [lo, hi] (us), by what the host ran
    at each gap's middle: the innermost profiled host operation there, under
    the innermost span it ran in."""
    gaps, end = [], lo
    for a, b, _ in intervals:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in host_events)
    out, active, i = {}, [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        ops = [h for h in active if not h[2].startswith("span:")]
        spans = [h for h in active if h[2].startswith("span:")]
        inner = ops[-1][2] if ops else "host idle"
        key = f"{spans[-1][2][5:]} / {inner}" if spans else inner
        out[key] = out.get(key, 0.0) + (g1 - g0) / 1e6
    return out


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


@dataclass
class Profile:
    """What the traced window's profilers saw."""

    window_s: float
    busy_s: float
    kernels: dict  # kernel name -> device seconds
    gaps: dict  # host activity -> idle device seconds

    def breakdown(self) -> dict:
        return {"device_ops": top(self.kernels), "idle_gaps": top(self.gaps)}


class Tracer:
    """The traced run's two profiled stretches, from the window's start:
    ``device_s`` seconds with the device's activity alone (little cost on the
    host: busy time and kernel time by name, the spans' calls marked for the
    rooflines), then ``host_s`` seconds with the host's operations too (the
    spans named on its timeline), for the idle gaps by what the host ran.
    ``tick`` is called at each request of the loader."""

    def __init__(self, spans: Spans, device_s: float, host_s: float):
        self.spans, self.device_s, self.host_s = spans, device_s, host_s
        self.phase, self.t = 0, []
        self.profs = []
        self.cost_s = 0.0  # the window's seconds spent switching profilers (their syncs, stops and starts)

    def _start(self, activities):
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self.profs.append(prof)
        self.t.append(time.perf_counter())

    def start(self):
        self._start([torch.profiler.ProfilerActivity.CUDA])
        self.spans.profiling = True
        self.phase = 1

    def tick(self, elapsed: float):
        t = time.perf_counter()
        self._tick(elapsed)
        self.cost_s += time.perf_counter() - t

    def _tick(self, elapsed: float):
        if self.phase == 1 and elapsed >= self.device_s:
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())
            self.spans.profiling = False
            self.profs[0].stop()
            self._start([torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.spans.annotate = True
            self.phase = 2
        elif self.phase == 2 and elapsed >= self.device_s + self.host_s:
            self.spans.annotate = False
            self.profs[1].stop()
            self.phase = 3

    def finish(self) -> Profile:
        self._tick(float("inf"))
        self._tick(float("inf"))
        dev = self.profs[0].events()
        iv = device_intervals(dev)
        both = self.profs[1].events()
        host = [e for e in both if e.device_type == torch.autograd.DeviceType.CPU]
        iv2 = device_intervals(both)
        lo = min((e.time_range.start for e in host), default=0.0)
        hi = max((e.time_range.end for e in host), default=0.0)
        return Profile(self.t[1] - self.t[0], busy_s(iv), kernel_seconds(iv), idle_gaps(iv2, host, lo, hi))


@dataclass
class RunInfo:
    """What a per-layer reader reads (``perfbench/metrics/*.py``): the cell,
    the spans' calls, the window's work (``batches``, ``pairs`` and
    ``images`` extracted of a served cell; ``steps`` of a training cell),
    its wall time, the loader's wait, the tracer's own seconds within the
    window and the profile."""

    cell: object
    spans: dict
    window_s: float
    profile: Profile
    batches: int = 0
    pairs: int = 0
    images: int = 0
    steps: int = 0
    loader_wait_s: float = 0.0
    tracer_s: float = 0.0

    @property
    def work_s(self) -> float:
        """The window's seconds less the tracer's own."""
        return self.window_s - self.tracer_s

    def vit(self):
        """(width, depth, feed-forward hidden size, SwiGLU) of the backbone."""
        from .params import VIT, swiglu_hidden

        width, depth, _ = VIT[self.cell.cfg["MICKEY"]["DINOV2"]["VARIANT"]]
        swiglu = self.cell.config_file["backbone_ffn"] != "mlp"
        return width, depth, swiglu_hidden(width) if swiglu else 4 * width, swiglu

    def device_ms(self, span: str):
        calls = self.spans.get(span)
        return None if not calls else sum(c.device_ms for c in calls)

    def host_ms(self, span: str):
        calls = self.spans.get(span)
        return None if not calls else sum(c.host_ms for c in calls)
