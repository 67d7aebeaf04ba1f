"""Ranges around the calls into the program, the traced window, and the
reduction of the profiler's trace to device times.

The benchmark opens ``torch.profiler.record_function`` ranges named
``bench.<layer>`` from its own files: around the calls it makes
(``encode``, ``query``) and around public methods of the instances it
built and handed in (``wrap``). In a traced run the window runs under
``torch.profiler``; its Chrome trace is written to a temporary file, read
back and deleted. Every kernel, memset and memcopy is attributed to each
range in which the host launched it (the launch found by the profiler's
correlation id), so a range's device time is the time of the work it
launched, wherever that ran on the card's timeline.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import tempfile

import numpy as np

PREFIX = "bench."
DEVICE_CATS = {"kernel", "gpu_memset", "gpu_memcpy"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


class Ranges:
    """Opens ``bench.<name>`` ranges when ``on``; costs nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(PREFIX + name)

    def wrap(self, obj, method: str, name: str) -> None:
        """Open the range ``name`` around every call of ``obj.method``, on
        this instance alone."""
        if not self.on:
            return
        inner = getattr(obj, method)

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            with self(name):
                return inner(*args, **kwargs)

        setattr(obj, method, wrapped)


@contextlib.contextmanager
def profiled(on: bool):
    """Run the body under ``torch.profiler`` when ``on``; yields a holder
    whose ``events`` are the trace's events once the body has ended."""
    holder = type("Trace", (), {"events": None})()
    if not on:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e6


def gaps(intervals, lo: float, hi: float):
    """The ``(start_us, end_us)`` stretches of ``[lo, hi]`` that no interval
    covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


class _RangeIndex:
    """The instances of one range name on the host, for point queries."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.ends = [e for _, e in spans]

    def contains(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def reduce(events: list, window: str = "window", top: int = 10) -> dict:
    """The device times a traced window gives.

    Returns ``window_s`` (the host range ``bench.<window>``), ``busy_s``
    (the union of kernel, memset and memcopy intervals inside it),
    ``device_s[name]`` (kernel and memset time launched inside each
    ``bench.<name>`` range), ``memcpy_s[kind]`` (memcopy time by direction,
    ``HtoD``, ``DtoH``, ``DtoD``), ``n_device_ops``, ``unattributed_s``
    (kernel and memset time whose launch the trace lacks), ``device_ops`` (the
    ``top`` operations by time, ``[name, seconds]``) and ``idle_gaps`` (the
    ``top`` longest idle stretches, ``[label, seconds]``, labelled with the
    innermost range the host was in when the stretch began).
    """
    ranges, launches, device = {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            ranges.setdefault(name[len(PREFIX):], []).append((ts, ts + dur))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            device.append((cat, name, ts, dur, corr))
    if window not in ranges:
        raise ValueError(f"the trace holds no range {PREFIX}{window}")
    lo, hi = ranges[window][0]
    index = {name: _RangeIndex(spans) for name, spans in ranges.items()}
    device_s = {name: 0.0 for name in ranges}
    memcpy_s = {"HtoD": 0.0, "DtoH": 0.0, "DtoD": 0.0}
    by_name, intervals, unattributed = {}, [], 0.0
    for cat, name, ts, dur, corr in device:
        end = ts + dur
        if end < lo or ts > hi:
            continue
        intervals.append((max(ts, lo), min(end, hi)))
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        if cat == "gpu_memcpy":
            for kind in memcpy_s:
                if kind in name:
                    memcpy_s[kind] += dur / 1e6
            continue
        t = launches.get(corr)
        if t is None:
            unattributed += dur / 1e6
            continue
        for rname, idx in index.items():
            if idx.contains(t):
                device_s[rname] += dur / 1e6
    idle = sorted(gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:top]

    def label(t: float) -> str:
        inner = None
        for rname, spans in ranges.items():
            if rname == window:
                continue
            for s, e in spans:
                if s <= t <= e and (inner is None or s >= inner[1]):
                    inner = (rname, s)
        return inner[0] if inner else window

    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": union_s(intervals),
        "device_s": device_s,
        "memcpy_s": memcpy_s,
        "n_device_ops": len(intervals),
        "unattributed_s": unattributed,
        "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[label(s), (e - s) / 1e6] for s, e in idle],
    }
