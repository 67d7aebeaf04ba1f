"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`. The
build happens at first use, into ``pyvisim_tpu_torch/_build/``, under a
file name keyed by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["build", "load_library"]

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (looked in $CUDA_HOME/bin and on PATH); the "
        "CUDA kernels of pyvisim_tpu_torch are built from source at first use."
    )


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, dict]:
    """Compile every named source that is not built yet, all at once.

    Returns ``{name: {"seconds": wall time, "log": compiler output}}`` for
    the sources compiled by this call; raises ``RuntimeError`` with the
    compiler's output if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        # Write to a private name and rename, so concurrent builders never
        # load a half-written library.
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, lib, time.perf_counter())
    report = {}
    for name, (proc, tmp, lib, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(log)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
