"""Image decoding: the native C++ loader with an OpenCV fallback.

Port of ``pyvisim_tpu/io/_loader.py``. The native loader is the
repository's ``native/image_loader.cpp`` (libjpeg on a thread pool, with an
optional bilinear resize). This module compiles it with g++ at first use
into ``pyvisim_tpu_torch/_build/``, under a name keyed by a hash of the
source, the flags and the host CPU's target (``-march=native``);
``ops/cuda/_build.py`` keys the CUDA kernels by source and flags likewise.
Where it cannot be built (no compiler, no libjpeg headers), and for files
that are not JPEGs, decoding goes through OpenCV, imported when needed.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import platform
import subprocess
from typing import Iterable, List, Optional

import numpy as np

from .._config import ROOT, get_logger

logger = get_logger("io.loader")

SOURCE = ROOT.parent / "native" / "image_loader.cpp"
BUILD_DIR = ROOT / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-ljpeg", "-lpthread")


@functools.cache
def _native_target() -> str:
    """The target options that ``-march=native`` selects on this host, as
    g++ reports them: a library built for one CPU is not loaded on another
    that may lack its instructions."""
    try:
        proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"g++ was not found: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ could not report the native target:\n{proc.stderr}")
    return f"{platform.machine()}\n{proc.stdout}"


def library_path() -> pathlib.Path:
    """Where the loader built from the current source and flags for this
    host's CPU lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS + LINK_FLAGS).encode())
    digest.update(_native_target().encode())
    return BUILD_DIR / f"libpyvisim_io-{digest.hexdigest()[:16]}.so"


def _build() -> pathlib.Path:
    """Compile the loader unless it is built; raises ``RuntimeError`` with
    the compiler's output when g++ fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A private name, then a rename: a concurrent build never loads a
    # half-written library.
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _load_native() -> ctypes.CDLL | None:
    """The native loader, built first if needed; None where it cannot be
    built, so decoding takes OpenCV."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (RuntimeError, OSError) as exc:  # no compiler, no libjpeg to build or load
        logger.warning("native JPEG loader unavailable, decoding with OpenCV: %s", exc)
        return None
    lib.pvs_decode_batch.restype = ctypes.c_int
    lib.pvs_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int,  # n
        ctypes.c_int,  # target_h (-1: probe the native size)
        ctypes.c_int,  # target_w
        ctypes.POINTER(ctypes.c_uint8),  # out buffer
        ctypes.POINTER(ctypes.c_int),  # out heights
        ctypes.POINTER(ctypes.c_int),  # out widths
        ctypes.c_int,  # n_threads
    ]
    return lib


def native_loader_available() -> bool:
    return _load_native() is not None


def _is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def _opencv_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"Could not read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imread_rgb(path: str) -> np.ndarray:
    """Decode one image file to an RGB uint8 (H, W, 3) array."""
    path = str(path)
    lib = _load_native() if _is_jpeg(path) else None
    if lib is not None:
        h, w = ctypes.c_int(0), ctypes.c_int(0)
        paths = (ctypes.c_char_p * 1)(path.encode())
        rc = lib.pvs_decode_batch(paths, 1, -1, -1, None, ctypes.byref(h), ctypes.byref(w), 1)
        if rc == 0 and h.value > 0:
            buf = np.empty((h.value, w.value, 3), np.uint8)
            rc = lib.pvs_decode_batch(
                paths, 1, h.value, w.value,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(h), ctypes.byref(w), 1,
            )
            if rc == 0:
                return buf
    return _opencv_rgb(path)


def imread_rgb_batch(
    paths: Iterable[str],
    target_size: Optional[tuple[int, int]] = None,
    n_threads: int | None = None,
) -> List[np.ndarray] | np.ndarray:
    """Decode a batch of images; with ``target_size=(H, W)`` the native
    loader decodes and bilinear-resizes on a thread pool and returns one
    (B, H, W, 3) uint8 array (OpenCV's INTER_AREA where it cannot)."""
    paths = [str(p) for p in paths]
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    if target_size is not None and all(_is_jpeg(p) for p in paths):
        lib = _load_native()
        if lib is not None:
            th, tw = target_size
            n = len(paths)
            buf = np.empty((n, th, tw, 3), np.uint8)
            hs, ws = (ctypes.c_int * n)(), (ctypes.c_int * n)()
            arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            rc = lib.pvs_decode_batch(
                arr, n, th, tw, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                hs, ws, n_threads,
            )
            if rc == 0:
                return buf
    imgs = [imread_rgb(p) for p in paths]
    if target_size is not None:
        import cv2

        th, tw = target_size
        return np.stack([cv2.resize(i, (tw, th), interpolation=cv2.INTER_AREA) for i in imgs])
    return imgs
