"""The reduction of the program's ``pyvisim.*`` spans (``program.reduce``),
the readers of ``program.PROGRAM_METRICS``, and a recorded run of a tiny
cell on the CPU."""
import pytest

from benchmark import program, readers, trace
from benchmark.tests.conftest import GALLERY, tiny_sift, tiny_vgg


def _ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _encode_trace():
    """One encode: the host turns the batch gray while the card ends the
    last batch's kernel, uploads it, launches two feature kernels,
    aggregates and reads back."""
    return [
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("user_annotation", "bench.encode", 0, 900),
        _ev("cuda_runtime", "cudaLaunchKernel", 0, 2, corr=6),
        _ev("kernel", "last", 0, 25, corr=6),
        _ev("user_annotation", "pyvisim.encode", 10, 880),
        _ev("user_annotation", "pyvisim.ingest.gray", 20, 200),
        _ev("user_annotation", "pyvisim.ingest.upload", 230, 20),
        _ev("cuda_runtime", "cudaMemcpyAsync", 235, 5, corr=1),
        _ev("user_annotation", "pyvisim.features", 260, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 270, 2, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 280, 2, corr=3),
        _ev("cuda_runtime", "cudaMemsetAsync", 290, 2, corr=4),
        _ev("user_annotation", "pyvisim.readback", 400, 450),
        _ev("cuda_runtime", "cudaMemcpyAsync", 410, 5, corr=5),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 240, 30, corr=1),
        _ev("kernel", "blur", 300, 100, corr=2),
        _ev("kernel", "sort", 400, 100, corr=3),
        _ev("gpu_memset", "Memset (Device)", 500, 10, corr=4),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 520, 300, corr=5),
    ]


def test_program_table_self_time_launches_copies_and_idle():
    red = program.reduce(_encode_trace())
    t = red["program"]
    assert set(t) == {"encode", "ingest.gray", "ingest.upload", "features", "readback"}
    enc = t["encode"]
    assert enc["instances"] == 1 and enc["host_s"] == pytest.approx(880e-6)
    assert enc["self_s"] == pytest.approx((880 - 200 - 20 - 100 - 450) * 1e-6)
    assert t["features"]["self_s"] == pytest.approx(100e-6)
    assert t["features"]["launches"] == 2  # the memset is device time, not a launch
    assert t["features"]["device_s"] == pytest.approx(210e-6)
    assert t["encode"]["launches"] == 2 and t["encode"]["device_s"] == pytest.approx(210e-6)
    assert t["ingest.upload"]["memcpy_s"]["HtoD"] == pytest.approx(30e-6)
    assert t["ingest.upload"]["device_s"] == 0.0
    assert t["readback"]["memcpy_s"]["DtoH"] == pytest.approx(300e-6)
    assert t["features"]["memcpy_s"] == {"HtoD": 0.0, "DtoH": 0.0, "DtoD": 0.0}
    # Idle: 25-240, 270-300, 510-520 and 820-1000. Gray (20-220) idles
    # from 25, upload (230-250) for 10 us, features (260-360) for 30.
    assert t["ingest.gray"]["idle_s"] == pytest.approx(195e-6)
    assert t["ingest.upload"]["idle_s"] == pytest.approx(10e-6)
    assert t["features"]["idle_s"] == pytest.approx(30e-6)
    assert t["readback"]["idle_s"] == pytest.approx(40e-6)  # 510-520, 820-850
    assert t["encode"]["idle_s"] == pytest.approx((215 + 30 + 10 + 70) * 1e-6)


def test_idle_gaps_take_the_innermost_range_of_either_prefix():
    red = program.reduce(_encode_trace())
    labels = {round(s * 1e6): name for name, s in red["idle_gaps"]}
    assert labels == {215: "pyvisim.ingest.gray", 180: "pyvisim.readback",
                      30: "pyvisim.features", 10: "pyvisim.readback"}
    # Outside every range: the window.
    events = _encode_trace() + [_ev("kernel", "late", 850, 55, corr=7),
                                _ev("cuda_runtime", "cudaLaunchKernel", 850, 2, corr=7)]
    gaps = [[name, round(s * 1e6)] for name, s in program.reduce(events)["idle_gaps"]]
    assert ["window", 95] in gaps and ["pyvisim.readback", 30] in gaps  # 905-, 820-850


def test_each_long_gap_is_put_down_to_the_spans_the_host_spent_it_in():
    red = program.reduce(_encode_trace())
    first = red["idle_gaps_spent"][0]  # 25-240: gray, the encode between, the upload
    assert first[0] == pytest.approx(215e-6)
    assert [n for n, _ in first[1]] == ["pyvisim.ingest.gray", "pyvisim.encode",
                                        "pyvisim.ingest.upload"]
    assert [t for _, t in first[1]] == pytest.approx([195e-6, 10e-6, 10e-6])
    last = red["idle_gaps_spent"][1]  # 820-1000: readback, encode, bench.encode, window
    assert dict(last[1]) == pytest.approx({"pyvisim.readback": 30e-6, "pyvisim.encode": 40e-6,
                                           "encode": 10e-6, "window": 100e-6})


def test_without_program_spans_every_key_is_trace_reduce_s():
    events = [e for e in _encode_trace() if not e["name"].startswith("pyvisim.")]
    red = program.reduce(events)
    assert red.pop("program") == {} and red.pop("idle_gaps_spent")
    assert red == trace.reduce(events)
    # The trace of the reduction's own test, as the parent's reduction sees it.
    from benchmark.tests.test_bench_traffic import _ev as old_ev

    old = [old_ev("user_annotation", "bench.window", 0, 1000),
           old_ev("user_annotation", "bench.encode", 10, 500),
           old_ev("cuda_runtime", "cudaLaunchKernel", 30, 2, corr=1),
           old_ev("kernel", "conv", 150, 100, corr=1),
           old_ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 400, 50, corr=3)]
    red = program.reduce(old)
    assert red.pop("program") == {} and red.pop("idle_gaps_spent")
    assert red == trace.reduce(old)


def test_with_program_spans_the_old_keys_keep_their_values():
    events = _encode_trace()
    red, old = program.reduce(events), trace.reduce(events)
    assert set(red) == set(old) | {"program", "idle_gaps_spent"}
    for key in old:
        if key != "idle_gaps":
            assert red[key] == old[key], key
    assert [s for _, s in red["idle_gaps"]] == [s for _, s in old["idle_gaps"]]


def _ctx(cfg, red, **kw):
    return program.Context(cfg=cfg, kind="closed", trace=red, items=4, rows=0, valid_rows=0,
                           **kw)


def test_readers_read_the_program_table_and_counters():
    red = program.reduce(_encode_trace())
    spans = []
    ctx = _ctx(tiny_sift(), red, counters={"h2d_bytes": 3000, "d2h_bytes": 6000,
                                          "sift.keypoints": 30, "sift.slots": 120},
               spans=spans, window_ns=(0, 1))
    read = {name: readers.load(name)(ctx) for name in program.PROGRAM_METRICS}
    assert read["ingest_host_ms.gallery"] == pytest.approx(1e3 * 220e-6 / 4)
    assert read["ingest_idle.gallery"] == pytest.approx(100.0 * 205e-6 / 1e-3)
    assert read["h2d_gbps.gallery"] == pytest.approx(3000 / 30e-6 / 1e9)
    assert read["d2h_gbps.gallery"] == pytest.approx(6000 / 300e-6 / 1e9)
    assert read["sift_launches_per_image.gallery"] == pytest.approx(0.5)
    assert read["keypoint_fill.gallery"] == pytest.approx(25.0)
    assert read["setup_program_s.gallery"] is None  # no span closed before the window


def test_readers_are_silent_where_their_inputs_are_absent():
    red = trace.reduce([e for e in _encode_trace() if not e["name"].startswith("pyvisim.")])
    plain = readers.Context(cfg=tiny_sift(), kind="closed", trace=red, items=4, rows=8,
                            valid_rows=4)
    for name in program.PROGRAM_METRICS:
        assert readers.load(name)(plain) is None, name
    # The other cell's kind: no SIFT in the VGG cell; a CPU trace has no copies.
    red = program.reduce(_encode_trace())
    vgg = _ctx(tiny_vgg(), red, counters={"h2d_bytes": 1, "d2h_bytes": 1})
    assert readers.load("sift_launches_per_image.gallery")(vgg) is None
    assert readers.load("keypoint_fill.gallery")(vgg) is None
    cpu = program.reduce([e for e in _encode_trace() if e["cat"] not in trace.DEVICE_CATS])
    ctx = _ctx(tiny_vgg(), cpu, counters={"h2d_bytes": 1, "d2h_bytes": 1})
    assert readers.load("h2d_gbps.gallery")(ctx) is None
    assert readers.load("d2h_gbps.gallery")(ctx) is None


def test_a_needed_span_missing_from_a_recorded_trace_is_malformed():
    events = [e for e in _encode_trace() if e["name"] != "pyvisim.readback"]
    ctx = _ctx(tiny_vgg(), program.reduce(events), counters={"d2h_bytes": 1})
    with pytest.raises(readers.Malformed):
        readers.load("d2h_gbps.gallery")(ctx)


@pytest.mark.parametrize("cfg", [tiny_sift, tiny_vgg], ids=["sift", "vgg"])
def test_a_recorded_run_of_a_tiny_cell_reads_the_program_metrics(cfg):
    """On the CPU: no device work, so no rates; the spans, counters and
    set-up are there."""
    name = "rootsift-vlad256.gallery" if cfg is tiny_sift else "vgg16-int8-vlad256.gallery"
    out = program.run_recorded(name, 2 ** 31 + 5, 0.4, True, device="cpu", cfg=cfg(),
                               mix=GALLERY)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["ingest_host_ms.gallery"] > 0
    assert 0 < m["ingest_idle.gallery"] <= 100
    assert m["setup_program_s.gallery"] > 0
    assert "h2d_gbps.gallery" not in m and "d2h_gbps.gallery" not in m
    assert out["counters"]["d2h_bytes"] == out["images"] * cfg()["encoding_dim"] * 4
    if cfg is tiny_sift:
        assert 0 < m["keypoint_fill.gallery"] <= 100
        assert out["counters"]["sift.slots"] == out["images"] * 64
        assert {"ingest.gray", "ingest.letterbox"} <= set(out["program"])
    else:
        assert "keypoint_fill.gallery" not in m
        assert out["counters"]["h2d_bytes"] == out["images"] * 48 * 64 * 3
