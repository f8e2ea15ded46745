"""The window's arithmetic: rates and the tail over the whole window, the
union of device intervals, the idle gaps by host activity."""

import numpy as np
import pytest
import torch

from perfbench.harness import submit, trace


def test_latencies_over_the_whole_window():
    # 6 batches handed over 0.1 s apart; predict drains batch i at the request of batch i + 2
    requests = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6]  # the last one ends the loader
    handovers = [0.01, 0.11, 0.21, 0.31, 0.41, 0.51]
    window, lat = submit.window_latencies(requests, handovers, t_end=0.75)
    assert window == pytest.approx(0.75)
    expected = [0.2 - 0.01, 0.3 - 0.11, 0.4 - 0.21, 0.5 - 0.31, 0.6 - 0.41, 0.75 - 0.51]
    assert lat == pytest.approx([1e3 * e for e in expected])
    # the p90 is taken over every batch of the window, not over chunks of it
    assert np.percentile(lat, 90) == pytest.approx(np.percentile([1e3 * e for e in expected], 90))
    assert np.percentile(lat, 90) != pytest.approx(np.mean([np.percentile(lat[:3], 90), np.percentile(lat[3:], 90)]))


def test_busy_is_the_union_of_intervals():
    iv = [(0.0, 10.0, "a"), (5.0, 12.0, "b"), (20.0, 25.0, "c"), (21.0, 22.0, "d")]
    assert trace.busy_s(iv) == pytest.approx(17e-6)
    assert trace.kernel_seconds(iv) == pytest.approx({"a": 10e-6, "b": 7e-6, "c": 5e-6, "d": 1e-6})


class _E:
    def __init__(self, a, b, name):
        self.time_range = type("R", (), {"start": a, "end": b})()
        self.name = name


def test_idle_gaps_by_host_activity():
    iv = [(0.0, 10.0, "k"), (30.0, 40.0, "k")]
    host = [_E(0.0, 50.0, "span:solver"), _E(12.0, 28.0, "aten::argmax"), _E(40.0, 50.0, "aten::copy_")]
    gaps = trace.idle_gaps(iv, host, 0.0, 50.0)
    assert gaps == pytest.approx({"solver / aten::argmax": 20e-6, "solver / aten::copy_": 10e-6})


def test_spans_wrap_and_restore(card):
    class M:
        def f(self, x):
            return x + 1

    m = M()
    spans = trace.Spans(m)
    with spans.install({"f": "model:f"}):
        assert m.f(torch.ones(2, device="cuda")).sum() == 4
    assert "f" not in vars(m) and len(spans.calls["f"]) == 1


def test_rates_by_part_of_the_window():
    from perfbench.harness import core

    # 10 events a second over the first 10 s, 20 over the next 10, 5 over the last 5
    times = [i / 10 for i in range(100)] + [10 + i / 20 for i in range(200)] + [20 + i / 5 for i in range(25)]
    assert core.chunk_rates(times, 0.0, 25.0) == pytest.approx([10.0, 20.0, 5.0])


def test_the_feed_thread_makes_every_batch_in_order_and_stops():
    import threading

    from perfbench.harness import train

    class Traffic:
        def batch(self, i):
            return {"i": i, "_frames": None}

    feeder = train.Feeder(Traffic(), first=3)
    got = [feeder.next()["i"] for _ in range(5)]
    feeder.close()
    assert got == [3, 4, 5, 6, 7] and feeder.wait_s >= 0.0
    assert not feeder.thread.is_alive() and "perfbench-feed" not in [t.name for t in threading.enumerate()]


def test_the_tracers_own_seconds_leave_the_work_time():
    run = trace.RunInfo(cell=None, spans={}, window_s=30.0, profile=None, tracer_s=0.25)
    assert run.work_s == pytest.approx(29.75)


def test_a_span_keeps_no_tensor_of_its_calls_alive():
    import gc
    import weakref

    grads = [torch.ones(3), torch.zeros(2, 2)]
    ref = weakref.ref(grads[0])
    kept = trace._summary((torch.ones(4, 5, dtype=torch.bfloat16), 7, grads, {"state": grads}))
    assert kept[0] == ((4, 5), torch.bfloat16) and kept[1] == 7
    assert kept[2] == (((3,), torch.float32), ((2, 2), torch.float32)) and kept[3] == "dict"
    del grads
    gc.collect()
    assert ref() is None
