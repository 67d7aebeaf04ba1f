"""Configuration, paths, logging and device selection for pyvisim_tpu_torch.

Port of ``pyvisim_tpu/_config.py``. The shipped codebook files are read
in place from the JAX package's folder, located by path (never imported).
"""
from __future__ import annotations

import logging
import logging.handlers
import os
import pathlib

import torch

ROOT = pathlib.Path(__file__).parent
MODEL_FILES_PATH = ROOT.parent / "pyvisim_tpu" / "res" / "model_files"

_LOG_DIR_ENV = "PYVISIM_TPU_TORCH_LOG_DIR"


def log_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(_LOG_DIR_ENV, str(ROOT.parent / "res" / "logs")))


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
