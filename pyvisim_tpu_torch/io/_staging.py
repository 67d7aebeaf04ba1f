"""Host copies of the encode path staged through page-locked buffers:
images up, encodings down.

A plain copy between pageable host memory and the card
(``torch.as_tensor(a).to(device)``, ``t.cpu().numpy()``) goes through the
CUDA runtime's own staging buffers, copied by one host thread, and on the way
down into a fresh torch CPU tensor. ``upload`` and ``readback`` move a
large batch in chunks through a fixed ring of page-locked buffers instead:
the host copies one chunk (torch's CPU ``copy_``, on the intra-op thread
pool) while the card's DMA engine moves the one before it at the link's
rate. ``readback`` writes its fresh result once before the first chunk
arrives, so that the result's first-touch page faults overlap the card's
work on the tensor instead of following it.

Memory. Each CUDA device holds two rings, one a direction, of
``RING_BUFFERS`` page-locked buffers of ``CHUNK_BYTES`` each: 48 MiB a
device in all. A ring is allocated on the first staged copy in its
direction (a caller's warm-up) and kept for the life of the process.
Nothing page-locked reaches a caller: ``upload`` returns a device tensor,
and ``readback`` returns a fresh ``np.empty`` array of ordinary pageable
memory that the caller owns and that shares no memory with a ring.

Route. A copy is staged only between the host and a CUDA device, for a
C-contiguous numpy array (up) or a contiguous tensor (down) of at least
``MIN_BYTES``, of a dtype that numpy holds. Anything else (a query's one
image or encoding, a tensor batch from ``io.prefetch_to_device``, the CPU)
takes the plain copy. Either way the result is the plain copy's, bit for
bit. The counters ``copy.staged`` and ``copy.plain`` count the calls by
route.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .. import profiling

__all__ = ["upload", "readback", "RING_BUFFERS", "CHUNK_BYTES", "MIN_BYTES"]

RING_BUFFERS = 3  # buffers in each direction's ring
CHUNK_BYTES = 8 << 20  # bytes of one buffer, and of one DMA
MIN_BYTES = 1 << 20  # smaller copies take the plain route

_NUMPY = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8, torch.int16: np.int16,
    torch.int32: np.int32, torch.int64: np.int64, torch.float16: np.float16,
    torch.float32: np.float32, torch.float64: np.float64, torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}
_TORCH = {np.dtype(v): k for k, v in _NUMPY.items()}


class _Ring:
    """``RING_BUFFERS`` host buffers of ``CHUNK_BYTES`` for one device and
    direction, page-locked for a CUDA device, each with the event of the
    last DMA that used it; ``lock`` keeps two callers from interleaving in
    them."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        # Normal tensors, written to under inference mode and outside it.
        with torch.inference_mode(False):
            self.buffers = [torch.empty(CHUNK_BYTES, dtype=torch.uint8, pin_memory=self.cuda)
                            for _ in range(RING_BUFFERS)]
        self.events = [torch.cuda.Event() if self.cuda else None for _ in range(RING_BUFFERS)]
        self.lock = threading.Lock()

    def wait(self, i: int) -> None:
        """Block until buffer ``i``'s last DMA has ended."""
        if self.cuda:
            self.events[i].synchronize()

    def record(self, i: int) -> None:
        """Mark buffer ``i`` busy until the DMA just issued on the
        device's current stream has ended."""
        if self.cuda:
            self.events[i].record(torch.cuda.current_stream(self.device))


_RINGS: dict[tuple[torch.device, str], _Ring] = {}
_RINGS_LOCK = threading.Lock()


def _ring(device: torch.device, direction: str) -> _Ring:
    with _RINGS_LOCK:
        ring = _RINGS.get((device, direction))
        if ring is None:
            ring = _RINGS[device, direction] = _Ring(device)
    return ring


def _stages_on(device: torch.device) -> bool:
    """Whether copies between the host and ``device`` are staged."""
    return device.type == "cuda"


def _chunks(numel: int, itemsize: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of each buffer-sized chunk of ``numel`` items."""
    step = CHUNK_BYTES // itemsize
    return [(a, min(a + step, numel)) for a in range(0, numel, step)]


def upload(array: np.ndarray, device) -> torch.Tensor:
    """``array`` copied to ``device``, as ``torch.as_tensor(array).to(device)``
    gives it; staged through the device's ring where the route allows."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not (_stages_on(device) and isinstance(array, np.ndarray) and array.flags.c_contiguous
            and array.dtype in _TORCH and array.nbytes >= MIN_BYTES):
        profiling.count("copy.plain", 1)
        return torch.as_tensor(array).to(device)
    profiling.count("copy.staged", 1)
    dtype = _TORCH[array.dtype]
    out = torch.empty(array.shape, dtype=dtype, device=device)
    src, dst = torch.from_numpy(array.reshape(-1)), out.view(-1)
    ring = _ring(device, "up")
    with ring.lock:
        for k, (a, b) in enumerate(_chunks(array.size, array.itemsize)):
            i = k % RING_BUFFERS
            buf = ring.buffers[i].view(dtype)[: b - a]
            ring.wait(i)
            buf.copy_(src[a:b])
            dst[a:b].copy_(buf, non_blocking=True)
            ring.record(i)
    return out


def readback(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` copied to a new host array, as ``tensor.cpu().numpy()``
    gives it; staged through its device's ring where the route allows.
    The array is the caller's own: it shares memory with nothing."""
    if not (_stages_on(tensor.device) and tensor.is_contiguous() and tensor.dtype in _NUMPY
            and not tensor.requires_grad
            and tensor.numel() * tensor.element_size() >= MIN_BYTES):
        profiling.count("copy.plain", 1)
        return tensor.cpu().numpy()
    profiling.count("copy.staged", 1)
    out = np.empty(tensor.shape, _NUMPY[tensor.dtype])
    src, dst = tensor.view(-1), torch.from_numpy(out.reshape(-1))
    ring = _ring(tensor.device, "down")
    bufs = [buf.view(tensor.dtype) for buf in ring.buffers]
    spans = _chunks(tensor.numel(), tensor.element_size())

    def fetch(k: int) -> None:
        a, b = spans[k]
        bufs[k % RING_BUFFERS][: b - a].copy_(src[a:b], non_blocking=True)
        ring.record(k % RING_BUFFERS)

    with ring.lock:
        for k in range(min(RING_BUFFERS, len(spans))):
            fetch(k)
        # A fresh array's first touch is its costliest copy: touch it
        # while the DMAs wait for the card to finish the tensor.
        dst.zero_()
        for k, (a, b) in enumerate(spans):
            i = k % RING_BUFFERS
            ring.wait(i)
            dst[a:b].copy_(bufs[i][: b - a])
            if k + RING_BUFFERS < len(spans):
                fetch(k + RING_BUFFERS)
    return out
