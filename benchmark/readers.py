"""What the per-layer metric readers share: the context of a traced run,
the device time of a range, and loading a reader by its metric's name.

A reader is ``benchmark/metrics/<metric name>.py`` with ``read(ctx)``,
returning the metric's value, or None where the run holds nothing for it
to read. ``ctx`` holds the configuration (``cfg``), the loop's ``kind``, the reduction of the trace (``trace``, see
``trace.reduce``), the images encoded or queries served in the traced
window (``items``), the weighted descriptor rows aggregated over them
(``valid_rows``), the descriptor rows they held (``rows``), and, in an
open loop, each query's ``service_s``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import numpy as np

DIR = pathlib.Path(__file__).resolve().parent / "metrics"


class Malformed(RuntimeError):
    """The trace lacks what a metric needs: the run prints no result."""


@dataclasses.dataclass
class Context:
    cfg: dict
    kind: str
    trace: dict
    items: int
    rows: int
    valid_rows: int
    service_s: np.ndarray | None = None


def device_s(ctx: Context, name: str) -> float:
    """Device time launched inside the range ``bench.<name>``; a range that
    saw none makes the run malformed."""
    t = ctx.trace["device_s"].get(name, 0.0)
    if t <= 0.0:
        raise Malformed(f"the range bench.{name} saw no device time")
    return t


def load(name: str):
    """The ``read`` function of the metric ``name``."""
    path = DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for the metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
