"""Run one cell of the port's benchmark once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; it names a
configuration (``benchmark/configs/<config>.json``, whose ``system``
names the module of ``benchmark/systems/`` that builds the program's
encoder and the plain reference in ``benchmark/reference/``) and a traffic mix (``benchmark/traffic/<mix>.json``).
Set-up draws the weights, the vocabulary, the images and the gallery from
the seed on the card and warms up the cell's shapes; then the window runs
for ``--seconds``; then the outputs of the window are held against the
reference, and the run prints its numbers. With ``--trace 1`` the window
runs under ``torch.profiler`` and the run reports the cell's per-layer
metrics (``benchmark/metrics/<name>.py``) instead of its end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` in a
traced run, and last ``checks``: each number compared with its limit); the
last lines of standard error give the same numbers. A run exits non-zero
without a result when the card is missing, when the trace lacks what a
metric needs, or when the process holds JAX or the JAX package.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# Build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a cell there builds.
CACHE = ROOT / ".bench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, images, readers, trace as tracing, traffic  # noqa: E402
from benchmark.reference import index as ref_index  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pyvisim_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that a run must not hold, compared
    whole: ``pyvisim_tpu_torch`` is not ``pyvisim_tpu``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_config(name: str) -> dict:
    path = BENCH / "configs" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def gpu_state() -> str:
    """The card's name, clocks, power and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


class Cell:
    """One cell set up for runs: the program built from the seed's inputs,
    the pool of images, and for an open loop the served index.

    ``device`` is the card in a run; the benchmark's own tests pass the CPU,
    where the program takes its plain versions."""

    def __init__(self, workload: dict, seed: int, device, trace: bool = False,
                 cfg: dict | None = None, mix: dict | None = None):
        self.seed, self.device = int(seed), torch.device(device)
        self.cfg = cfg or load_config(workload["config"])
        self.mix = mix or traffic.load(workload["traffic"])
        self.system = importlib.import_module(f"benchmark.systems.{self.cfg['system']}")
        self.ref = importlib.import_module(f"benchmark.reference.{self.cfg['system']}")
        self.ranges = tracing.Ranges(trace)
        self.weights = self.system.make_weights(self.cfg, self.seed, self.device)
        self.centers, self.vocab_rows = self._vocabulary()
        self.encoder = self.system.build(self.cfg, self.weights, self.centers, self.device)
        self.ranges.wrap(self.encoder.feature_extractor, self.system.FEATURES, "features")
        self.rows, self.valid = [], []
        self._count_rows()
        h, w = self.cfg["image"]["height"], self.cfg["image"]["width"]
        self.index = None
        if self.mix["kind"] == "closed":
            b = self.mix["batch"]
            self.pool_images = images.photo_batch(self.seed, "pool", b * self.mix["pool_batches"],
                                                  h, w, self.device)
            self.pool = [self.pool_images[i * b:(i + 1) * b]
                         for i in range(self.mix["pool_batches"])]
        else:
            from pyvisim_tpu_torch.index import RetrievalIndex

            self.pool_images = images.photo_batch(self.seed, "pool", self.mix["pool_images"],
                                                  h, w, self.device)
            self.pool = list(self.pool_images)
            self.order = images.numpy_rng(self.seed, "order").permutation(len(self.pool))
            # The reference's encodings of the query images: the gallery holds
            # near copies of them, and the check scores against them.
            enc, self.clusters, self.per_image = check.reference_encodings(
                self.cfg, self.ref, self.weights, self.pool_images, self.centers, self.device)
            self.pool_enc = enc.cpu()
            rows = check.gallery_rows(self.cfg, self.mix, self.seed, self.device, self.pool_enc)
            opts = self.cfg["index"]
            self.index = RetrievalIndex(rows, [str(i) for i in range(rows.shape[0])],
                                        quantize=opts["quantize"], screen_dim=opts["screen_dim"],
                                        device=self.device)
            del rows, enc
            self.ranges.wrap(self.index, "query_vectors", "search")
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _vocabulary(self):
        """K centres sampled without replacement from the weighted
        descriptors that the reference extracts from the seed's vocabulary
        images: an input, handed to the program and the reference alike."""
        h, w = self.cfg["image"]["height"], self.cfg["image"]["width"]
        imgs = images.photo_batch(self.seed, "vocabulary", self.cfg["vocabulary_images"],
                                       h, w, self.device)
        desc, mask = self.ref.descriptors(self.cfg, self.weights, imgs, self.device)
        rows = desc[mask > 0]
        k = self.cfg["vlad"]["k"]
        if rows.shape[0] < k:
            raise RuntimeError(f"the vocabulary images give {rows.shape[0]} descriptors, "
                               f"fewer than K = {k}")
        gen = images.generator(self.seed, "vocabulary", self.device)
        pick = torch.randperm(rows.shape[0], generator=gen, device=self.device)[:k]
        return rows[pick].to(torch.float32).contiguous(), int(rows.shape[0])

    def _count_rows(self) -> None:
        """In a traced run, count the descriptor rows, and the weighted ones,
        that each aggregation takes (the sums stay on the device until the
        window has closed)."""
        if not self.ranges.on:
            return
        inner = self.encoder._encode_core

        def counted(desc, mask, *args):
            out = inner(desc, mask, *args)
            self.rows.append(mask.numel())
            self.valid.append((mask > 0).sum())
            return out

        self.encoder._encode_core = counted

    def query(self, image):
        """One query of one image: the ids and scores of its top k."""
        answer = self.index.query(self.encoder, [image], k=self.mix["k"])[0]
        ids = [int(path) for path, _ in answer]
        return ids, [score for _, score in answer]

    def warm_up(self) -> None:
        """Run the cell's own shapes until nothing is left to build."""
        if self.mix["kind"] == "closed":
            for batch in self.pool[:self.mix.get("warmup_batches", 2)]:
                self.encoder.encode(batch)
        else:
            for i in range(self.mix["warmup_queries"]):
                self.query(self.pool[self.order[i % len(self.pool)]])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, traced: bool = False) -> dict:
        """The measured window, under the profiler when ``traced``."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with tracing.profiled(traced) as tr:
            if self.mix["kind"] == "closed":
                loop = traffic.closed(self.encoder.encode, self.pool, self.mix, self.seed, seconds,
                                           self.ranges)
            else:
                loop = traffic.open_loop(self.query, self.pool, self.order, self.mix,
                                              seconds, self.ranges)
        loop["peak_bytes"] = (torch.cuda.max_memory_allocated()
                              if self.device.type == "cuda" else 0)
        loop["events"] = tr.events
        return loop

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.encoder = self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    def check_numbers(self, loop: dict, precision=None) -> tuple[dict, dict]:
        """The numbers compared, and what the reference saw (mean weighted
        descriptors per image, clusters reached), for a window's outputs.
        ``precision`` lowers the reference's parts for the control, which
        then stands in the program's place on the same sample."""
        rng = images.numpy_rng(self.seed, "check")
        if self.mix["kind"] == "closed":
            kept = loop["kept"]
            pick = range(len(kept))
            b = self.mix["batch"]
            imgs = self.pool_images[[kept[i][0] * b + kept[i][1] for i in pick]]
            want, clusters, per_image = check.reference_encodings(
                self.cfg, self.ref, self.weights, imgs, self.centers, self.device)
            if precision is None:
                got = torch.as_tensor(np.stack([kept[i][2] for i in pick]))
            else:
                got, _, _ = check.reference_encodings(self.cfg, self.ref, self.weights, imgs,
                                                      self.centers, self.device, precision)
            numbers = check.encoding_numbers(got.to(want.device), want)
            return numbers, {"checked": len(pick), "clusters": clusters,
                             "descriptors_per_image": per_image}
        answered = [i for i, a in enumerate(loop["answers"]) if a is not None]
        pick = sorted(rng.choice(len(answered), size=min(self.mix["check_queries"],
                                                         len(answered)), replace=False))
        qi = [answered[i] for i in pick]
        which = [int(self.order[i % len(self.pool)]) for i in qi]
        imgs = self.pool_images[which]
        want = self.pool_enc[which].to(self.device)
        rows = check.gallery_rows(self.cfg, self.mix, self.seed, self.device, self.pool_enc)
        ref_scores = ref_index.scores(want, rows)
        if precision is None:
            ids = np.array([loop["answers"][i][0] for i in qi])
            scores = np.array([loop["answers"][i][1] for i in qi])
        else:
            low = dict(precision)
            enc, _, _ = check.reference_encodings(self.cfg, self.ref, self.weights, imgs,
                                                  self.centers, self.device, low)
            s = ref_index.scores(enc, rows, low.get("vlad", "float64"))
            top = torch.sort(s, dim=1, descending=True, stable=True)
            ids = top.indices[:, :self.mix["k"]].cpu().numpy()
            scores = top.values[:, :self.mix["k"]].cpu().numpy()
        del rows
        numbers = check.search_numbers(ids, scores, ref_scores)
        return numbers, {"checked": len(qi), "clusters": self.clusters,
                         "descriptors_per_image": self.per_image}


def end_to_end(cell: Cell, loop: dict) -> dict:
    """The end-to-end metrics of an untraced window."""
    gib = loop["peak_bytes"] / 2 ** 30
    if cell.mix["kind"] == "closed":
        return {"encode_img_per_s": {"value": loop["encoded"] / loop["window_s"],
                                     "unit": "img/s"},
                "peak_device_gib": {"value": gib, "unit": "GiB"}}
    lat_ms = loop["latency_s"] * 1e3
    return {"query_p50_ms": {"value": traffic.percentile(lat_ms, 50), "unit": "ms"},
            "query_p95_ms": {"value": traffic.percentile(lat_ms, 95), "unit": "ms"},
            "peak_device_gib": {"value": gib, "unit": "GiB"}}


def per_layer(cell: Cell, loop: dict, names: list[str], units: dict) -> tuple[dict, dict]:
    """The per-layer metrics of a traced window, and the trace's reduction."""
    red = tracing.reduce(loop["events"])
    if red["n_device_ops"] == 0 and cell.device.type == "cuda":
        raise readers.Malformed("the traced window holds no device operation")
    if cell.mix["kind"] == "closed":
        items = loop["encoded"]
        service = None
    else:
        items = int(np.isfinite(loop["latency_s"]).sum())
        service = loop["service_s"]
    ctx = readers.Context(cfg=cell.cfg, kind=cell.mix["kind"], trace=red,
                          items=items, rows=int(sum(cell.rows)),
                          valid_rows=int(sum(int(v) for v in cell.valid)), service_s=service)
    out = {}
    for name in names:
        value = readers.load(name)(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": units[name]}
    return out, red


def run(workload_name: str, seed: int, seconds: float, traced: bool, device="cuda") -> dict:
    """One run of a cell; the result line as a dict."""
    man = manifest()
    workload = find(man["workloads"], workload_name, "workload")
    log(f"gpu {gpu_state()}")
    cell = Cell(workload, seed, device, trace=traced)
    cell.warm_up()
    setup_s = time.perf_counter() - _T0
    loop = cell.window(seconds, traced)
    gpu_after = gpu_state()
    peak_bytes = torch.cuda.max_memory_allocated() if cell.device.type == "cuda" else 0
    if traced:
        names = [m["name"] for m in man["per_layer"]
                 if workload_name in m.get("workloads", [workload_name])]
        units = {m["name"]: m["unit"] for m in man["per_layer"]}
        metrics, red = per_layer(cell, loop, names, units)
        missing = [n for n in names if n not in metrics]
        if missing:
            raise readers.Malformed(f"the traced run read nothing for {missing}")
    else:
        metrics = end_to_end(cell, loop)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        wanted = [m["name"] for m in man["end_to_end"]
                  if workload_name in m.get("workloads", [workload_name])]
        metrics = {n: metrics[n] for n in wanted}
    loop.pop("events", None)
    cell.free()
    numbers, seen = cell.check_numbers(loop)
    correct, checks = check.judge(numbers, check.limits(workload_name))
    log(f"readings {numbers}")
    correct = correct and loop["failed"] == 0
    log(f"setup_s {setup_s}")
    log(f"gpu after the window {gpu_after}")
    if cell.mix["kind"] == "closed":
        log(f"window {loop['window_s']} s, {loop['encoded']} images in {loop['batches']} batches,"
            f" {loop['encoded'] / loop['window_s']} img/s")
    else:
        late = loop["late_s"] * 1e3 if len(loop["late_s"]) else np.zeros(1)
        served = int(np.isfinite(loop["latency_s"]).sum())
        log(f"window: {loop['attempted']} queries due, {served} served by "
            f"{loop['last_done_s']} s, {served / loop['last_done_s']} q/s; mean service "
            f"{np.nanmean(loop['service_s']) * 1e3} ms; generator lateness ms mean "
            f"{late.mean()} p95 {np.percentile(late, 95)} max {late.max()}")
    log(f"reference: {seen['checked']} outputs checked, {seen['descriptors_per_image']} weighted "
        f"descriptors an image, {seen['clusters']} of {cell.cfg['vlad']['k']} clusters non-empty;"
        f" vocabulary drawn from {cell.vocab_rows} descriptors")
    result = {
        "correct": correct,
        "attempted": loop["attempted"],
        "failed": loop["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
                   "kind": (torch.cuda.get_device_name(0) if cell.device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak_bytes)},
    }
    if traced:
        result["device"]["busy_s"] = red["busy_s"]
        result["device"]["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        log(f"trace: {red['n_device_ops']} device operations, unattributed "
            f"{red['unattributed_s']} s, device time by range {red['device_s']}, "
            f"copies {red['memcpy_s']}")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        workload = find(manifest()["workloads"], args.workload, "workload")
    except (OSError, KeyError, json.JSONDecodeError) as e:
        log(f"cannot run {args.workload!r}: {e}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        log(f"the cell needs {workload['chips']} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 3
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except readers.Malformed as e:
        log(f"malformed: {e}")
        return 4
    held = forbidden_modules()
    if held:
        log(f"the process holds {held}: no result")
        return 5
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
