"""The generator's percentiles, arrivals, lateness and queueing; the trace
reduction's union of busy intervals, idle gaps and range attribution."""
import time

import numpy as np
import pytest

from benchmark import images, trace, traffic


def test_percentile_is_linear_between_order_statistics():
    assert traffic.percentile([1, 2, 3, 4], 50) == 2.5
    assert traffic.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert traffic.percentile([1.0, np.inf], 95) == np.inf  # a failed request


def test_arrivals_are_poisson_at_the_rate_and_the_same_for_every_seed():
    mix = {"rate_per_s": 200.0, "arrival_seed": 1}
    a, b = traffic.arrivals(mix, 30.0), traffic.arrivals(mix, 30.0)
    assert np.array_equal(a, b)
    assert np.all(np.diff(a) > 0) and a[-1] < 30.0
    assert len(a) / 30.0 == pytest.approx(200.0, rel=0.05)
    gaps = np.diff(a)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, rel=0.1)  # exponential


def test_open_loop_times_latency_from_due_and_reports_lateness():
    mix = {"rate_per_s": 50.0, "arrival_seed": 3}
    seen = []

    def slow(image):
        seen.append(image)
        time.sleep(0.03)  # slower than the arrivals: the queue grows
        return [1, 2], [0.5, 0.4]

    out = traffic.open_loop(slow, [0, 1], np.array([1, 0]), mix, 0.5, trace.Ranges(False))
    n = out["attempted"]
    assert n == len(traffic.arrivals(mix, 0.5)) and out["failed"] == 0
    assert seen[:2] == [1, 0]
    assert np.all(out["latency_s"] >= out["service_s"] - 1e-9)
    assert out["latency_s"][-1] > out["latency_s"][0] + 0.1  # the queue grew
    assert out["last_done_s"] > 0.5  # the drain after the window is served
    assert len(out["late_s"]) >= 1 and np.all(out["late_s"] >= 0)


def test_open_loop_counts_a_query_that_raises_as_failed():
    mix = {"rate_per_s": 40.0, "arrival_seed": 2}
    calls = []

    def flaky(image):
        calls.append(image)
        if len(calls) == 2:
            raise ValueError("boom")
        return [0], [1.0]

    out = traffic.open_loop(flaky, [7], np.array([0]), mix, 0.3, trace.Ranges(False))
    assert out["failed"] == 1 and out["answers"][1] is None
    assert np.isinf(out["latency_s"][1])


def test_closed_loop_counts_images_and_keeps_a_sample_from_the_seed():
    pool = [np.arange(8, dtype=np.float32).reshape(4, 2) + 10 * i for i in range(3)]
    mix = {"check_rows_per_batch": 2, "check_images": 5}
    out = traffic.closed(lambda b: b * 2.0, pool, mix, 5, 0.05, trace.Ranges(False))
    assert out["encoded"] == 4 * out["batches"] and out["failed"] == 0
    assert out["batches"] > 3 and len(out["kept"]) == 5
    for p, r, row in out["kept"]:
        assert np.array_equal(row, pool[p][r] * 2.0)
    assert len({(p, r) for p, r, _ in out["kept"]}) > 1


def test_union_and_gaps_of_device_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert trace.union_s(iv) == pytest.approx(25e-6)
    assert trace.gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert trace.gaps([], 0, 5) == [(0, 5)]


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_attributes_device_work_to_the_range_that_launched_it():
    events = [
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("user_annotation", "bench.encode", 10, 500),
        _ev("user_annotation", "bench.features", 20, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 2, corr=1),   # in features
        _ev("cuda_driver", "cuLaunchKernel", 200, 2, corr=2),     # in encode only
        _ev("cuda_runtime", "cudaMemcpyAsync", 300, 2, corr=3),
        _ev("kernel", "conv", 150, 100, corr=1),                  # runs after the range closed
        _ev("kernel", "vlad", 260, 40, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 400, 50, corr=3),
        _ev("kernel", "orphan", 600, 10, corr=99),
        _ev("cpu_op", "aten::add", 0, 5),
    ]
    red = trace.reduce(events)
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["device_s"]["features"] == pytest.approx(100e-6)
    assert red["device_s"]["encode"] == pytest.approx(140e-6)
    assert red["memcpy_s"]["DtoH"] == pytest.approx(50e-6)
    assert red["unattributed_s"] == pytest.approx(10e-6)
    assert red["busy_s"] == pytest.approx(200e-6)  # 150-300, 400-450, 600-610
    assert red["device_ops"][0] == ["conv", pytest.approx(100e-6)]
    longest = red["idle_gaps"][0]
    assert longest == ["window", pytest.approx(390e-6)]  # 610-1000, after every range
    assert ["encode", pytest.approx(100e-6)] in red["idle_gaps"]  # 300-400, inside encode


def test_reduce_refuses_a_trace_without_the_window():
    with pytest.raises(ValueError):
        trace.reduce([_ev("kernel", "k", 0, 1, corr=1)])


def test_images_repeat_from_the_seed_and_do_not_depend_on_the_batch():
    a = images.photo_batch(2 ** 31 + 9, "pool", 20, 40, 56)
    b = images.photo_batch(2 ** 31 + 9, "pool", 5, 40, 56, first=14)
    c = images.photo_batch(2 ** 31 + 10, "pool", 20, 40, 56)
    assert a.dtype == np.uint8 and a.shape == (20, 40, 56, 3)
    assert np.array_equal(a[14:19], b)
    assert not np.array_equal(a, c)
    assert 40 < a.mean() < 200 and a.std() > 20
