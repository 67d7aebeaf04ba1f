"""Configuration, paths, logging and device selection for pyvisim_tpu_torch.

Port of ``pyvisim_tpu/_config.py``. The shipped codebook files are read
in place from the JAX package's folder, located by path (never imported).
"""
from __future__ import annotations

import contextlib
import logging
import logging.handlers
import os
import pathlib

import torch

ROOT = pathlib.Path(__file__).parent
MODEL_FILES_PATH = ROOT.parent / "pyvisim_tpu" / "res" / "model_files"

_LOG_DIR_ENV = "PYVISIM_TPU_TORCH_LOG_DIR"
_CACHE_DIR_ENV = "PYVISIM_TPU_TORCH_CACHE_DIR"


def log_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(_LOG_DIR_ENV, str(ROOT.parent / "res" / "logs")))


def cache_dir() -> pathlib.Path:
    """Root cache directory for datasets: ``$PYVISIM_TPU_TORCH_CACHE_DIR``,
    else the JAX package's default (``platformdirs.user_cache_dir
    ("pyvisim_tpu")``, or ``~/.cache/pyvisim_tpu`` without platformdirs), so
    that one download serves both packages."""
    env = os.environ.get(_CACHE_DIR_ENV)
    if env:
        return pathlib.Path(env)
    try:
        from platformdirs import user_cache_dir
    except ImportError:
        return pathlib.Path.home() / ".cache" / "pyvisim_tpu"
    return pathlib.Path(user_cache_dir("pyvisim_tpu"))


_LOGGING_CONFIGURED = False


def setup_logging(level: int = logging.WARNING, log_to_file: bool = True) -> None:
    """Configure package logging: console plus an optional rotating file
    handler. Idempotent."""
    global _LOGGING_CONFIGURED
    if _LOGGING_CONFIGURED:
        return
    logger = logging.getLogger("pyvisim_tpu_torch")
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    if log_to_file:
        try:
            d = log_dir()
            d.mkdir(parents=True, exist_ok=True)
            fh = logging.handlers.RotatingFileHandler(
                d / "pyvisim_tpu_torch.log", maxBytes=256 * 1024, backupCount=1
            )
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        except OSError:
            pass
    _LOGGING_CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    setup_logging()
    return logging.getLogger(f"pyvisim_tpu_torch.{name}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises ``RuntimeError`` when CUDA is asked for and absent; the port
    never falls back to the CPU on its own. Pass ``device="cpu"`` to run
    the plain versions on the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyvisim_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU."
        )
    return device


@contextlib.contextmanager
def full_f32():
    """Float32 matmuls and convs in full float32 inside the block: cuBLAS's
    and cuDNN's TF32 off, restored after it. Other cuDNN flags (such as
    ``deterministic``) are left as they are."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
