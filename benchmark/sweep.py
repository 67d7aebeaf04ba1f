"""Find the highest rate an open-loop cell sustains: one set-up, then the
cell's window at each of several offered rates, on the card.

    python3 benchmark/sweep.py --workload <query cell> --seed <n> --seconds <s> --rates 50,100,200

Prints one JSON line a rate: the rate offered and served, the median and
95th-percentile latency over the window and over each of its halves, and
the mean service time. The knee is the highest rate whose served rate
keeps up with the offered one and whose second half's p95 does not rise
above its first half's; a cell is set at four fifths of it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

if str(pathlib.Path(__file__).resolve().parents[1]) not in sys.path:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.run import Cell, find, log, manifest  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: no result")
        return 3
    from benchmark.traffic import percentile

    cell = Cell(find(manifest()["workloads"], args.workload, "workload"), args.seed, "cuda")
    cell.warm_up()
    base = dict(cell.mix)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.mix = {**base, "rate_per_s": rate}
        loop = cell.window(args.seconds)
        lat = loop["latency_s"] * 1e3
        first = loop["first_half"]
        served = int(np.isfinite(lat).sum())
        print(json.dumps({
            "workload": args.workload, "offered_per_s": rate, "queries": int(lat.size),
            "served_per_s": served / loop["last_done_s"], "p50_ms": percentile(lat, 50),
            "p95_ms": percentile(lat, 95), "p95_first_half_ms": percentile(lat[first], 95),
            "p95_second_half_ms": percentile(lat[~first], 95),
            "mean_service_ms": float(np.nanmean(loop["service_s"]) * 1e3),
            "failed": loop["failed"], "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
