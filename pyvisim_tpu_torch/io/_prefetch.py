"""Host-to-device prefetching for the input pipeline.

Port of ``pyvisim_tpu/io/_prefetch.py``: a background thread produces (and
decodes) the next batches while the device computes on the current one.
With ``to_device`` every array of a batch is copied to the iterator's
device on the producer thread: on CUDA through pinned host memory, with a
non-blocking copy on a side stream whose event the consumer's stream waits
on in ``__next__``, so the copy overlaps the consumer's kernels.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from .._config import get_logger, resolve_device

logger = get_logger("io.prefetch")

__all__ = ["prefetch_to_device", "PrefetchIterator"]

_SENTINEL = object()


def _map_arrays(fn, item):
    """Apply ``fn`` to every numpy array or tensor in a batch made of
    tuples, lists and dicts; other leaves pass through."""
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return fn(item)
    if isinstance(item, (tuple, list)):
        return type(item)(_map_arrays(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _map_arrays(fn, v) for k, v in item.items()}
    return item


class PrefetchIterator:
    """Iterate batches produced by ``source`` with ``depth`` batches
    produced ahead on a background thread and, with ``to_device``, already
    on ``device`` (None means CUDA; ``"cpu"`` makes tensors and copies
    nothing).

    Exceptions in the producer propagate to the consumer; the thread shuts
    down when the iterator is exhausted, closed, or garbage collected.
    """

    def __init__(
        self,
        source: Iterable,
        depth: int = 2,
        to_device: bool = True,
        transform: Callable | None = None,
        device=None,
    ):
        self._device = resolve_device(device) if to_device else None
        self._stream = (
            torch.cuda.Stream(self._device)
            if self._device is not None and self._device.type == "cuda" else None
        )
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._transform = transform
        self._closed = False
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),), daemon=True
        )
        self._thread.start()

    def _copy(self, item):
        """``(item on the device, the copy's event or None, the pinned
        sources)``. The sources travel with the batch until ``__next__``
        has made the consumer's stream wait on the event; past that, the
        caching host allocator keeps a pinned block from reuse until the
        copy that read it has ended."""
        if self._device is None:
            return item, None, []
        if self._stream is None:
            return _map_arrays(torch.as_tensor, item), None, []
        pinned = []

        def to_card(a):
            host = torch.as_tensor(a)
            if host.device.type == "cpu":
                host = host.pin_memory()
                pinned.append(host)
            return host.to(self._device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            item = _map_arrays(to_card, item)
        event = torch.cuda.Event()
        event.record(self._stream)
        return item, event, pinned

    def _produce(self, it: Iterator) -> None:
        try:
            for item in it:
                if self._closed:
                    return
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(self._copy(item)):
                    return
            self._put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
            self._put(e)

    def _put(self, item) -> bool:
        """Enqueue, waking periodically to recheck ``_closed`` so a producer
        blocked on a full queue cannot outlive close() (and keep its batches
        alive in device memory)."""
        while not self._closed:
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        got = self._queue.get()
        if got is _SENTINEL:
            raise StopIteration
        if isinstance(got, BaseException):
            raise got
        item, event, _pinned = got
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            # The batch was allocated on the side stream: tell the caching
            # allocator that the consumer's stream uses it too.
            _map_arrays(lambda t: t.record_stream(stream), item)
        return item

    def close(self) -> None:
        self._closed = True
        # Drain until the producer thread has exited: a single drain could
        # race a producer that re-enqueues and re-blocks.
        while self._thread.is_alive():
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):  # pragma: no cover - GC timing
        if hasattr(self, "_thread"):
            self.close()


def prefetch_to_device(source: Iterable, depth: int = 2, device=None) -> PrefetchIterator:
    """Wrap any batch iterable so that decoding and the host-to-device copy
    overlap the device's work (``device`` None means CUDA).

    >>> for images, labels in prefetch_to_device(batches):
    ...     encodings = encoder.encode(images)
    """
    return PrefetchIterator(source, depth=depth, to_device=True, device=device)
