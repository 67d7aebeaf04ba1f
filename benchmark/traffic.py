"""The one generator of every traffic mix.

A mix is a data file, ``benchmark/traffic/<name>.json``, whose ``kind``
picks one of two loops and whose other keys are its parameters:

- ``closed``: one caller encodes batches of ``batch`` images back to back
  (``VLADEncoder.encode``), cycling through a pool of ``pool_batches``
  distinct batches held in host memory. ``check_rows_per_batch`` rows of
  each batch, chosen from the seed, are offered to a uniform sample of at
  most ``check_images`` encodings (a reservoir), kept for the check.
- ``open``: queries of one image each (``RetrievalIndex.query(encoder,
  [image], k)``) fall due at Poisson arrivals of ``rate_per_s``; one server
  takes them in arrival order. Latency runs from each query's due time to
  the return of its call, so the wait behind a slow query counts; the
  queries due in the window are all served, past its end if need be.
  Every seed gets the same arrival times (drawn from ``arrival_seed``);
  the seed draws the images, the weights, the vocabulary and the gallery.

A loop returns the end-to-end numbers of its window and what the check
and the per-layer readers need.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time
import traceback

import numpy as np

from benchmark import images

DIR = pathlib.Path(__file__).resolve().parent / "traffic"


def load(name: str) -> dict:
    """The mix ``benchmark/traffic/<name>.json``."""
    path = DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values``, linear between order
    statistics (numpy's default); a failed request counts as infinite."""
    x = np.sort(np.asarray(values, np.float64))
    h = (len(x) - 1) * q / 100.0
    lo = int(np.floor(h))
    hi = min(lo + 1, len(x) - 1)
    if h == lo or x[lo] == x[hi]:
        return float(x[lo])
    return float(x[lo] + (h - lo) * (x[hi] - x[lo]))


def arrivals(mix: dict, seconds: float) -> np.ndarray:
    """Due times in seconds from the window's start of a Poisson stream at
    ``rate_per_s``, the same for every seed, up to ``seconds``."""
    rng = np.random.default_rng([int(mix["arrival_seed"]), images.STREAMS["arrivals"]])
    n = int(mix["rate_per_s"] * seconds * 1.5) + 64
    t = np.cumsum(rng.exponential(1.0 / mix["rate_per_s"], n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(rng.exponential(1.0 / mix["rate_per_s"], n))])
    return t[t < seconds]


def _wait_until(t: float) -> None:
    """Sleep to within 2 ms of ``t`` on the ``perf_counter`` clock, then spin:
    a sleep alone wakes up to a millisecond late, which would count in
    every query's latency."""
    left = t - time.perf_counter()
    if left > 0.002:
        time.sleep(left - 0.002)
    while time.perf_counter() < t:
        pass


def _report_failure(what: str) -> None:
    print(f"{what} raised:", file=sys.stderr)
    traceback.print_exc(file=sys.stderr)


def closed(encode, pool: list, mix: dict, seed: int, seconds: float, ranges) -> dict:
    """Encode ``pool``'s batches back to back for ``seconds``.

    ``encode(batch)`` returns host float32 encodings. Returns the images
    encoded and failed, the window from its start to the return of its
    last batch, and the kept rows ``[(pool_batch, row, encoding)]``."""
    rng = images.numpy_rng(seed, "check")
    keep, size = int(mix["check_rows_per_batch"]), int(mix["check_images"])
    kept, offered, done, failed, j = [], 0, 0, 0, 0
    t0 = time.perf_counter()
    t_last = t0
    with ranges("window"):
        while time.perf_counter() - t0 < seconds:
            p = j % len(pool)
            batch = pool[p]
            rows = rng.choice(len(batch), size=keep, replace=False)
            try:
                with ranges("encode"):
                    out = encode(batch)
            except Exception:  # noqa: BLE001 - a batch that raises is counted as failed
                failed += len(batch)
                if failed == len(batch):
                    _report_failure("encode")
            else:
                done += len(out)
                for r in rows:
                    slot = offered if offered < size else int(rng.integers(offered + 1))
                    if slot < size:
                        entry = (p, int(r), np.array(out[r], copy=True))
                        if slot == len(kept):
                            kept.append(entry)
                        else:
                            kept[slot] = entry
                    offered += 1
            t_last = time.perf_counter()
            j += 1
    return {"attempted": done + failed, "failed": failed, "encoded": done, "batches": j,
            "window_s": t_last - t0, "kept": kept}


def open_loop(query, pool: list, order: np.ndarray, mix: dict, seconds: float,
              ranges) -> dict:
    """Serve the queries due in ``seconds`` of arrivals at ``rate_per_s``.

    Query ``i`` is ``pool[order[i % len(order)]]``; ``query(image)`` returns
    ``(ids, scores)`` of the top ``k``. Returns each query's latency from
    its due time, its service time, the generator's lateness (how late a
    query that found the server idle was taken up), and the answers."""
    due = arrivals(mix, seconds)
    n = len(due)
    latency = np.full(n, np.inf)
    service = np.full(n, np.nan)
    late, answers, failed = [], [], 0
    t0 = time.perf_counter()
    free_at = 0.0
    with ranges("window"):
        for i, d in enumerate(due):
            if d > time.perf_counter() - t0:
                with ranges("wait"):
                    _wait_until(t0 + d)
            start = time.perf_counter() - t0
            if free_at <= d:
                late.append(start - d)
            try:
                with ranges("query"):
                    ids, scores = query(pool[order[i % len(order)]])
            except Exception:  # noqa: BLE001 - a query that raises is counted as failed
                failed += 1
                answers.append(None)
                if failed == 1:
                    _report_failure("query")
            else:
                answers.append((ids, scores))
            end = time.perf_counter() - t0
            free_at = end
            if answers[-1] is not None:
                latency[i] = end - d
                service[i] = end - start
    half = due < seconds / 2
    return {"attempted": n, "failed": failed, "latency_s": latency, "service_s": service,
            "due_s": due, "last_done_s": free_at, "late_s": np.asarray(late),
            "answers": answers, "first_half": half}
