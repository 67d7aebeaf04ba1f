"""Tracing, profiling and throughput counters.

Port of ``pyvisim_tpu/profiling.py`` on ``torch.profiler``: ``trace``
writes a Chrome trace (viewable in TensorBoard's profiler plugin or
``chrome://tracing``) to ``log_dir``; ``timed`` logs a block's wall-clock
time; ``Throughput`` is an items/s meter.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch

from ._config import get_logger

logger = get_logger("profiling")

__all__ = ["trace", "timed", "Throughput"]


@contextlib.contextmanager
def trace(log_dir: str, *, host_profile: bool = False) -> Iterator[torch.profiler.profile]:
    """Record the host's and, where there is a card, the card's activity in
    the block; yields the profiler (``key_averages()`` gives the time by
    operator) and writes the trace to ``log_dir`` on exit. ``host_profile``
    also records Python stacks and tensor shapes.

    >>> with profiling.trace("/tmp/torch-trace"):
    ...     encoder.encode(images)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
                 record_shapes=host_profile, with_stack=host_profile) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    logger.info("profiler trace written to %s", log_dir)


@contextlib.contextmanager
def timed(label: str) -> Iterator[None]:
    """Log the wall-clock duration of a block. Device work is asynchronous:
    end the block with ``torch.cuda.synchronize()`` to time it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.info("%s: %.3fs", label, time.perf_counter() - t0)


@dataclass
class Throughput:
    """Streaming items/s meter.

    >>> meter = Throughput()
    >>> for batch in batches:
    ...     out = encode(batch)  # returns host arrays, so the device is done
    ...     meter.update(len(batch))
    >>> meter.rate
    """

    count: int = 0
    _start: float = field(default_factory=time.perf_counter)

    def update(self, n: int) -> None:
        self.count += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    @property
    def rate(self) -> float:
        return self.count / max(self.elapsed, 1e-9)

    def reset(self) -> None:
        self.count = 0
        self._start = time.perf_counter()

    def __repr__(self) -> str:
        return f"Throughput({self.count} items, {self.rate:.1f}/s)"
