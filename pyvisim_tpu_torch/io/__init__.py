"""Host-side image IO feeding the device (port of ``pyvisim_tpu/io``).

A native C++ JPEG decoder (``native/image_loader.cpp``, built on libjpeg)
with an OpenCV fallback, and a prefetch thread so that host decoding and
the host-to-device copy overlap device compute.
"""
from __future__ import annotations

from ._loader import imread_rgb, imread_rgb_batch, native_loader_available
from ._prefetch import PrefetchIterator, prefetch_to_device

__all__ = [
    "imread_rgb",
    "imread_rgb_batch",
    "native_loader_available",
    "PrefetchIterator",
    "prefetch_to_device",
]
