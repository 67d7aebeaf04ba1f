"""Tracing, profiling, spans and counters of the program's own work.

Port of ``pyvisim_tpu/profiling.py`` on ``torch.profiler``: ``trace``
writes a Chrome trace (viewable in TensorBoard's profiler plugin or
``chrome://tracing``) to ``log_dir``; ``timed`` logs a block's wall-clock
time; ``Throughput`` is an items/s meter.

The program opens a ``span`` at each layer boundary of its encode and
search paths and adds to a ``count`` where work is done (bytes copied,
keypoint slots filled). Both do nothing until ``record()`` (or ``trace``)
switches recording on for the process: then each span is kept in memory
(name, batch or query id, parent, thread, start and end on
``time.perf_counter_ns``) and opens a ``torch.profiler.record_function``
named ``pyvisim.<name>``, so that a profiled window shows it on the
kernels' clock, and the counters add up.

Spans (the batch or query id is drawn by the outermost ``encode``,
``query`` or ``search`` span of a thread; the others carry their
parent's): ``encode``; ``ingest.gray``, ``ingest.letterbox`` and
``ingest.upload``, the images turned gray, letterboxed and copied to the
device (SIFT's uint8 images are copied raw and turned gray and
letterboxed by one kernel launch inside ``ingest.letterbox``, with no
``ingest.gray``); ``features``, the extractor's device work, and in it
a ResNet trunk's ``resnet.stem`` and ``resnet.layer1`` ... ``resnet.layer4``,
or a ViT trunk's ``vit.embed``, ``vit.blocks`` (in it each block's
``vit.attention`` and ``vit.ffn`` branch) and ``vit.facet``, or
``vit.norm`` for the final-norm facet (the last block and the final
LayerNorm);
``aggregate``, the encode core; ``readback``, the encodings' copy to the
host; ``query`` and ``search`` of ``RetrievalIndex``; and, outside any
batch, ``init`` of the extractors and encoders and ``load_kernels`` of
each CUDA library. Counters: ``h2d_bytes`` (the bytes of the images as
they were copied up: raw pixels where the device turns them gray,
letterboxed ones where the host did), ``d2h_bytes``, ``sift.keypoints``
(valid keypoints), ``sift.slots`` (keypoint slots), and
``ingest.on_card`` and ``ingest.on_host``, the SIFT images turned gray
and letterboxed on the device and on the host, and ``conv.cudnn``,
``conv.k7``, ``conv.int8_k8``, ``conv.int8_gemm`` and ``conv.int8_plain``,
the convs of an int8 trunk (``models.quant.RoutedConv``) by the route
each call took, and ``conv.int8_gemm_fused``, the gemm-route calls that
took their BatchNorm into the epilogue, and ``attn.cudnn`` and
``attn.math``, a ViT trunk's attention calls by the route each took
(``models.vit.attention_route``: cuDNN's fused kernel, or the plain math),
``vit.swiglu.<route>``, ``vit.add_norm.<route>`` and ``vit.rope.<route>``,
its float passes by route (``kernel`` or ``plain``; ``vit.rope`` one a
block's RoPE rotation), and ``vit.tokens``, the tokens a ViT forward
carries through its blocks (batch x (1 + registers + patches)), and ``copy.staged`` and
``copy.plain``, the host copies of ``io._staging.upload`` and
``readback`` by the route each call took.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch

from ._config import get_logger

logger = get_logger("profiling")

__all__ = ["trace", "timed", "Throughput", "record", "span", "count", "Record", "Span"]

PREFIX = "pyvisim."

# The one flag ``span`` and ``count`` read: off, they return at once.
_ON = False
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_ACTIVE: "Record | None" = None
_DEPTH = 0
_IDS = itertools.count()
_LOCAL = threading.local()


@dataclass(slots=True)
class Span:
    """One span: ``parent`` is the index of the enclosing span in
    ``Record.spans`` (None at a thread's outermost span), ``batch`` the id
    of the batch or query it belongs to (None outside one), ``end_ns``
    None while it is open."""

    name: str
    batch: int | None
    parent: int | None
    thread: int
    start_ns: int = 0
    end_ns: int | None = None


class Record:
    """The spans and counters recorded while recording was on."""

    def __init__(self):
        self.spans: list[Span] = []
        self._host: dict[str, int] = {}
        self._device: dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()

    def _append(self, s: Span) -> int:
        with self._lock:
            self.spans.append(s)
            return len(self.spans) - 1

    def add(self, name: str, n) -> None:
        """Add ``n`` to the counter ``name``: a number, or a tensor whose
        sum (a whole number) is added on its device, unsynchronised."""
        if torch.is_tensor(n):
            part = n.sum(dtype=torch.int64)
            with self._lock:
                acc = self._device.get(name)
                # Out of place: a sum taken under inference mode may not be
                # updated in place outside it.
                self._device[name] = part if acc is None else acc + part
            return
        with self._lock:
            self._host[name] = self._host.get(name, 0) + int(n)

    def counters(self) -> dict[str, int]:
        """A snapshot of every counter (waits for the device's sums)."""
        with self._lock:
            out, device = dict(self._host), dict(self._device)
        for name, acc in device.items():
            out[name] = out.get(name, 0) + int(acc.item())
        return out

    def dump(self, path) -> None:
        """Write the closed spans to ``path`` as Chrome-trace JSON events
        (``chrome://tracing``), in microseconds of ``perf_counter_ns``."""
        pid = os.getpid()
        with self._lock:
            spans = [s for s in self.spans if s.end_ns is not None]
        events = [{"ph": "X", "cat": "pyvisim", "name": PREFIX + s.name, "pid": pid,
                   "tid": s.thread, "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                   "args": {"batch": s.batch, "parent": s.parent}} for s in spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


@contextlib.contextmanager
def record() -> Iterator[Record]:
    """Switch spans and counters on, for the whole process, in the block;
    yields the ``Record`` that holds them. Blocks nest (and may overlap
    across threads): the outermost one owns the record, and recording
    ends with the last of them.

    >>> with profiling.record() as rec:
    ...     encoder.encode(images)
    >>> rec.counters()["d2h_bytes"], rec.dump("spans.json")
    """
    global _ON, _ACTIVE, _DEPTH
    with _LOCK:
        if _ACTIVE is None:
            _ACTIVE = Record()
        rec = _ACTIVE
        _DEPTH += 1
        _ON = True
    try:
        yield rec
    finally:
        with _LOCK:
            _DEPTH -= 1
            if _DEPTH == 0:
                _ON, _ACTIVE = False, None


class _Open:
    """An open span while recording is on."""

    __slots__ = ("name", "root", "span", "stack", "annotation")

    def __init__(self, name: str, root: bool):
        self.name, self.root, self.span = name, root, None

    def __enter__(self):
        rec = _ACTIVE
        if rec is None:  # recording ended since span() was called
            return self
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        if stack and stack[-1][0] is rec:
            _, parent, up = stack[-1]
            batch = up.batch
        else:
            parent, batch = None, (next(_IDS) if self.root else None)
        self.span = s = Span(self.name, batch, parent, threading.get_ident())
        stack.append((rec, rec._append(s), s))
        self.stack = stack
        self.annotation = torch.profiler.record_function(PREFIX + self.name)
        s.start_ns = time.perf_counter_ns()
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.span is None:
            return False
        self.annotation.__exit__(*exc)
        self.span.end_ns = time.perf_counter_ns()
        self.stack.pop()
        return False


def span(name: str, *, root: bool = False):
    """A context manager around one layer's work, named ``name`` (one
    dotted name per layer, no per-call text). Off, the one shared null
    context. ``root``: outside any other span of its thread, the span
    draws the next batch or query id."""
    if not _ON:
        return _NULL
    return _Open(name, root)


def count(name: str, n) -> None:
    """Add ``n`` (a number, or a tensor whose sum is taken on its device)
    to the counter ``name`` while recording is on; nothing otherwise."""
    if not _ON:
        return
    rec = _ACTIVE
    if rec is not None:
        rec.add(name, n)


@contextlib.contextmanager
def trace(log_dir: str, *, host_profile: bool = False) -> Iterator[torch.profiler.profile]:
    """Record the host's and, where there is a card, the card's activity in
    the block; yields the profiler (``key_averages()`` gives the time by
    operator) and writes the trace to ``log_dir`` on exit. ``host_profile``
    also records Python stacks and tensor shapes. Recording (``record``)
    is on in the block, so the trace holds the program's ``pyvisim.*``
    spans beside the operators and kernels they launched.

    >>> with profiling.trace("/tmp/torch-trace"):
    ...     encoder.encode(images)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with record(), profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
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
