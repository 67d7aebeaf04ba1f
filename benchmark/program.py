"""The program's own spans and counters in a cell's run, and the readers'
view of them.

    python3 benchmark/program.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs a cell as ``run.py`` does, with the program's recording on
(``pyvisim_tpu_torch.profiling.record()``) from before the cell is built:
each span the program opens is kept in memory and, under the profiler, is
a ``pyvisim.<span>`` range of the trace, on the kernels' clock; its
counters are read at the window's edges. ``--trace 1`` prints the cell's
per-layer metrics with those of ``PROGRAM_METRICS``, which read the
program's spans and counters, the idle gaps labelled with the program's
spans, and the reduction's ``program`` table; ``--trace 0`` prints
``encode_img_per_s`` with recording on and the profiler off, whose
difference from ``run.py --trace 0`` is what recording costs.

``reduce`` is ``trace.reduce`` with the key ``program`` added, per span
name: ``host_s`` (the summed durations of its instances), ``self_s``
(less the time that the program's spans nested in them cover, on the
same thread), ``instances``, ``device_s`` (kernel and memset time
launched inside it), ``memcpy_s`` (memcopy time launched inside it, by
direction), ``launches`` (kernels launched inside it) and ``idle_s``
(seconds of the window in which the card was idle while the host was
inside it). Its ``idle_gaps`` are labelled with the innermost ``bench.*``
or ``pyvisim.*`` range (the latter keeping its prefix) in which the
stretch began; ``idle_gaps_spent`` gives each of those stretches with the
seconds of it that the host spent in each innermost range, most first,
which puts the card's wait down to the host's work. Every other key is
``trace.reduce``'s, and without program spans so is ``idle_gaps``.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

if str(pathlib.Path(__file__).resolve().parents[1]) not in sys.path:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import readers, trace  # noqa: E402

PREFIX = "pyvisim."

# The metrics that read the program's spans and counters: name -> unit.
PROGRAM_METRICS = {
    "ingest_host_ms.gallery": "ms",
    "ingest_idle.gallery": "%",
    "h2d_gbps.gallery": "GB/s",
    "d2h_gbps.gallery": "GB/s",
    "sift_launches_per_image.gallery": "launches",
    "keypoint_fill.gallery": "%",
    "setup_program_s.gallery": "s",
}


@dataclasses.dataclass
class Context(readers.Context):
    """A reader's context with the program's recording: ``counters``, the
    change of each counter over the window; ``spans``, the record's spans
    (``profiling.Span``, on ``time.perf_counter_ns``); ``window_ns``, the
    window's start and end on that clock. None where recording was off."""

    counters: dict | None = None
    spans: list | None = None
    window_ns: tuple[int, int] | None = None


def program(ctx, name: str) -> dict | None:
    """The reduction's entry of the program span ``name``: None where the
    run recorded no program spans; a run that recorded them but lacks this
    one is malformed."""
    table = ctx.trace.get("program")
    if not table:
        return None
    if name not in table:
        raise readers.Malformed(f"the trace holds no program span {PREFIX}{name}")
    return table[name]


def _self_s(spans: list) -> list[float]:
    """Each ``(start, end, tid)`` span's duration less the union of the
    spans of its thread that lie inside it, in seconds."""
    out = [0.0] * len(spans)
    order = sorted(range(len(spans)), key=lambda i: (spans[i][2], spans[i][0], -spans[i][1]))
    for pos, i in enumerate(order):
        s, e, tid = spans[i]
        inner = []
        for k in range(pos + 1, len(order)):
            s2, e2, tid2 = spans[order[k]]
            if tid2 != tid or s2 > e:
                break
            if e2 <= e:
                inner.append((s2, e2))
        out[i] = (e - s) / 1e6 - trace.union_s(inner)
    return out


def _overlap_s(a: list, b: list) -> float:
    """Seconds in which the union of intervals ``a`` meets the union of
    intervals ``b`` (both ``(start_us, end_us)``)."""
    def merged(iv):
        out = []
        for s, e in sorted(iv):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    a, b = merged(a), merged(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e6


def reduce(events: list, window: str = "window", top: int = 10) -> dict:
    """``trace.reduce`` and the program's spans (see the module's text)."""
    red = trace.reduce(events, window, top)
    prog, bench, launches, device = {}, {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            prog.setdefault(name[len(PREFIX):], []).append((ts, ts + dur, e.get("tid")))
        elif cat == "user_annotation" and name.startswith(trace.PREFIX):
            bench.setdefault(name[len(trace.PREFIX):], []).append((ts, ts + dur))
        elif cat in trace.LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in trace.DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            device.append((cat, name, ts, dur, corr))
    lo, hi = bench[window][0]
    intervals = [(max(ts, lo), min(ts + dur, hi)) for _, _, ts, dur, _ in device
                 if ts + dur >= lo and ts <= hi]
    idle = trace.gaps(intervals, lo, hi)

    flat = [(name, sp) for name, spans in prog.items() for sp in spans]
    self_s = dict.fromkeys(prog, 0.0)
    for (name, _), t in zip(flat, _self_s([sp for _, sp in flat])):
        self_s[name] += t
    table = {}
    for name, spans in prog.items():
        table[name] = {
            "host_s": sum(e - s for s, e, _ in spans) / 1e6,
            "self_s": self_s[name],
            "instances": len(spans),
            "device_s": 0.0,
            "memcpy_s": {"HtoD": 0.0, "DtoH": 0.0, "DtoD": 0.0},
            "launches": 0,
            "idle_s": _overlap_s(idle, [(s, e) for s, e, _ in spans]),
        }
    index = {name: trace._RangeIndex([(s, e) for s, e, _ in spans])
             for name, spans in prog.items()}
    for cat, dname, ts, dur, corr in device:
        t = launches.get(corr)
        if t is None or ts + dur < lo or ts > hi:
            continue
        for name, idx in index.items():
            if not idx.contains(t):
                continue
            row = table[name]
            if cat == "gpu_memcpy":
                for kind in row["memcpy_s"]:
                    if kind in dname:
                        row["memcpy_s"][kind] += dur / 1e6
            else:
                row["device_s"] += dur / 1e6
                row["launches"] += cat == "kernel"
    red["program"] = table

    labelled = [(n, s, e) for n, spans in bench.items() if n != window for s, e in spans]
    labelled += [(PREFIX + n, s, e) for n, spans in prog.items() for s, e, _ in spans]

    def label(t: float) -> str:
        inner = None
        for name, s, e in labelled:
            if s <= t <= e and (inner is None or s >= inner[1]):
                inner = (name, s)
        return inner[0] if inner else window

    def spent(a: float, b: float) -> list:
        """Seconds of the stretch ``[a, b]`` that the host spent in each
        innermost range, most first."""
        inside = [(n, s, e) for n, s, e in labelled if s < b and e > a]
        cuts = sorted({a, b} | {t for _, s, e in inside for t in (s, e) if a < t < b})
        out = {}
        for t0, t1 in zip(cuts, cuts[1:]):
            mid, inner = (t0 + t1) / 2, None
            for n, s, e in inside:
                if s <= mid <= e and (inner is None or s >= inner[1]):
                    inner = (n, s)
            name = inner[0] if inner else window
            out[name] = out.get(name, 0.0) + (t1 - t0) / 1e6
        return [[n, t] for n, t in sorted(out.items(), key=lambda kv: -kv[1])]

    longest = sorted(idle, key=lambda g: g[0] - g[1])[:top]
    red["idle_gaps"] = [[label(s), (e - s) / 1e6] for s, e in longest]
    red["idle_gaps_spent"] = [[(e - s) / 1e6, spent(s, e)] for s, e in longest]
    return red


def run_recorded(workload_name: str, seed: int, seconds: float, traced: bool,
                 device="cuda", cfg: dict | None = None, mix: dict | None = None) -> dict:
    """One run of a cell with the program's recording on; the result line
    as a dict. ``cfg`` and ``mix`` replace the cell's, as in ``run.Cell``."""
    import numpy as np
    import torch

    from benchmark import run
    from pyvisim_tpu_torch import profiling

    man = run.manifest()
    workload = run.find(man["workloads"], workload_name, "workload")
    run.log(f"gpu {run.gpu_state()}")
    with profiling.record() as rec:
        cell = run.Cell(workload, seed, device, trace=traced, cfg=cfg, mix=mix)
        cell.warm_up()
        setup_s = time.perf_counter() - _T0
        start_ns, before = time.perf_counter_ns(), rec.counters()
        loop = cell.window(seconds, traced)
        after, end_ns = rec.counters(), time.perf_counter_ns()
    counters = {k: v - before.get(k, 0) for k, v in after.items()}
    cuda = cell.device.type == "cuda"
    setup_spans = {}
    for sp in rec.spans:
        if sp.end_ns is not None and sp.end_ns <= start_ns:
            setup_spans[sp.name] = setup_spans.get(sp.name, 0.0) + (sp.end_ns - sp.start_ns) / 1e9
    result = {"device": {"kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "state": run.gpu_state() if cuda else None},
              "counters": counters, "setup_s": setup_s, "setup_spans": setup_spans}
    if not traced:
        result["metrics"] = run.end_to_end(cell, loop)
        return result
    red = reduce(loop.pop("events"))
    if cell.mix["kind"] == "closed":
        items, service = loop["encoded"], None
    else:
        items, service = int(np.isfinite(loop["latency_s"]).sum()), loop["service_s"]
    ctx = Context(cfg=cell.cfg, kind=cell.mix["kind"], trace=red, items=items,
                  rows=int(sum(cell.rows)), valid_rows=int(sum(int(v) for v in cell.valid)),
                  service_s=service, counters=counters, spans=list(rec.spans),
                  window_ns=(start_ns, end_ns))
    units = {m["name"]: m["unit"] for m in man["per_layer"]}
    # The cell's own metrics read device time: none in a trace without any.
    names = [m["name"] for m in man["per_layer"]
             if workload_name in m.get("workloads", [workload_name]) and red["n_device_ops"]]
    units.update(PROGRAM_METRICS)
    metrics = {}
    for name in names + list(PROGRAM_METRICS):
        value = readers.load(name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    result.update(metrics=metrics, images=items, window_s=red["window_s"],
                  busy_s=red["busy_s"], idle_gaps=red["idle_gaps"],
                  idle_gaps_spent=red["idle_gaps_spent"],
                  device_ops=red["device_ops"], program=red["program"])
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card: no result", file=sys.stderr)
        return 3
    print(json.dumps(run_recorded(args.workload, args.seed, args.seconds, bool(args.trace))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
