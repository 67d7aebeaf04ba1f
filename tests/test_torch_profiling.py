"""The port's spans and counters (``pyvisim_tpu_torch.profiling``): off,
nothing is recorded; on, an encode records the span tree of its layers
with one batch id a call, and the counters equal the rows and bytes the
encode handled. Tiny shapes on the CPU, where the program takes its plain
versions."""
import contextlib
import json
import threading

import numpy as np
import pytest
import torch

from pyvisim_tpu_torch import index as tindex
from pyvisim_tpu_torch import profiling
from pyvisim_tpu_torch.encoders import Pipeline, VLADEncoder
from pyvisim_tpu_torch.features import DeepConvFeature, RootSIFT
from pyvisim_tpu_torch.models.resnet import ResNetTrunk
from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook
from pyvisim_tpu_torch.ops.cuda import _build

# The spans of one encode, each with its parent's name (None: the root).
# SIFT's uint8 images are turned gray inside the letterbox kernel's launch.
SIFT_TREE = {"encode": None, "ingest.letterbox": "encode",
             "ingest.upload": "encode", "features": "encode", "aggregate": "encode",
             "readback": "encode"}
DEEP_TREE = {"encode": None, "ingest.upload": "encode", "features": "encode",
             "aggregate": "encode", "readback": "encode"}
RESNET_STAGES = ["resnet.stem", "resnet.layer1", "resnet.layer2", "resnet.layer3",
                 "resnet.layer4"]
# The int8 ResNet50's block convs at 96^2 by route, per image batch: the
# stem leaves 24^2, so layer1 (24), layer2 (24 -> 12) and layer3's first
# block's convs at 12 run int8 (the 3x3 stride-1 convs through kernel 8:
# 3 + 3; the rest through the gemm route: 7 + 10 + 3, each with its
# BatchNorm in the epilogue), and the 26 convs at 6 and 3, below the
# window, run float.
RESNET96_ROUTES = {"conv.cudnn": 26, "conv.int8_k8": 6, "conv.int8_gemm": 20,
                   "conv.int8_gemm_fused": 20}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(n=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 48, 64, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def sift_encoder():
    ext = RootSIFT(max_keypoints=64, process_size=64, device="cpu")
    centers = torch.from_numpy(np.random.default_rng(1).random((8, 128), np.float32))
    return VLADEncoder(ext, kmeans_model=KMeansCodebook(centers=centers), device="cpu")


@pytest.fixture(scope="module")
def deep_encoder():
    ext = DeepConvFeature("vgg16", int8=True, dtype=torch.bfloat16, image_size=32, device="cpu")
    centers = torch.from_numpy(np.random.default_rng(2).random((8, 514), np.float32))
    return VLADEncoder(ext, kmeans_model=KMeansCodebook(centers=centers), device="cpu")


@pytest.fixture(scope="module")
def resnet_extractor():
    return DeepConvFeature(module=ResNetTrunk("resnet50", int8=True), dtype=torch.bfloat16,
                           image_size=96, device="cpu")


def _tree(rec, root: int) -> dict:
    """``{name: parent name}`` of the spans under the span ``root``."""
    spans = rec.spans
    out = {spans[root].name: None}
    for s in spans[root + 1:]:
        p = s.parent
        while p is not None and p != root:
            p = spans[p].parent
        if p == root:
            out[s.name] = spans[s.parent].name
    return out


def _inside(child, parent) -> bool:
    return parent.start_ns <= child.start_ns and child.end_ns <= parent.end_ns


def test_off_span_is_the_one_null_context_and_nothing_is_kept(sift_encoder):
    a, b = profiling.span("encode", root=True), profiling.span("features")
    assert a is b and isinstance(a, contextlib.nullcontext)
    profiling.count("h2d_bytes", 5)
    profiling.count("sift.keypoints", torch.ones(3))
    sift_encoder.encode(_images(2))
    with profiling.record() as rec:
        pass
    assert rec.spans == [] and rec.counters() == {}
    assert profiling.span("encode") is a  # off again after the block


@pytest.mark.parametrize("which,tree", [("sift", SIFT_TREE), ("deep", DEEP_TREE)])
def test_an_encode_records_the_span_tree_with_one_batch_id(request, which, tree):
    encoder = request.getfixturevalue(f"{which}_encoder")
    with profiling.record() as rec:
        encoder.encode(_images(3))
        encoder.encode(_images(2, seed=5))
    roots = [i for i, s in enumerate(rec.spans) if s.name == "encode"]
    assert len(roots) == 2
    assert all(rec.spans[i].parent is None for i in roots)
    ids = [rec.spans[i].batch for i in roots]
    assert ids[0] is not None and ids[0] != ids[1]
    for i, batch in zip(roots, ids):
        assert _tree(rec, i) == tree
        under = [s for s in rec.spans if s.batch == batch]
        assert {s.name for s in under} == set(tree)
        for s in under:
            assert s.end_ns is not None and s.end_ns >= s.start_ns
            if s.parent is not None:
                assert _inside(s, rec.spans[s.parent])


def test_a_pipeline_encode_is_one_root_over_its_members(sift_encoder):
    second = VLADEncoder(sift_encoder.feature_extractor,
                         kmeans_model=KMeansCodebook(centers=torch.rand(4, 128)), device="cpu")
    with profiling.record() as rec:
        Pipeline([sift_encoder, second]).encode(_images(2))
    (root,) = [i for i, s in enumerate(rec.spans) if s.parent is None]
    assert rec.spans[root].name == "encode"
    assert _tree(rec, root) == SIFT_TREE
    assert [s.name for s in rec.spans].count("aggregate") == 2
    assert {s.batch for s in rec.spans} == {rec.spans[root].batch}


def test_sift_counters_equal_the_rows_the_encode_core_aggregates(sift_encoder, monkeypatch):
    rows, valid = [], []
    inner = sift_encoder._encode_core

    def counted(desc, mask, *args):  # as the benchmark counts rows in a traced run
        rows.append(mask.numel())
        valid.append(int((mask > 0).sum()))
        return inner(desc, mask, *args)

    monkeypatch.setattr(sift_encoder, "_encode_core", counted)
    with profiling.record() as rec:
        sift_encoder.encode(_images(3))
    c = rec.counters()
    assert c["sift.slots"] == sum(rows) == 3 * 64
    assert c["sift.keypoints"] == sum(valid) > 0


@pytest.mark.parametrize("which", ["sift", "deep"])
def test_byte_counters_equal_the_tensors_nbytes(request, which):
    encoder = request.getfixturevalue(f"{which}_encoder")
    images = _images(3)
    with profiling.record() as rec:
        out = encoder.encode(images)
    c = rec.counters()
    assert c["d2h_bytes"] == out.nbytes
    # SIFT and the trunk both upload the uint8 RGB batch as it is (SIFT
    # turns it gray and letterboxes it on the device).
    assert c["h2d_bytes"] == images.nbytes
    if which == "sift":
        assert c["ingest.on_card"] == 3 and "ingest.on_host" not in c


def test_the_profiler_trace_holds_one_annotation_per_span(sift_encoder, tmp_path):
    with profiling.record() as rec:
        with profiling.trace(str(tmp_path)):
            sift_encoder.encode(_images(2))
    (path,) = tmp_path.glob("*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"].startswith(profiling.PREFIX)]
    events.sort(key=lambda e: e["ts"])
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    assert [e["name"] for e in events] == [profiling.PREFIX + s.name for s in spans]

    def parent_names(items, start, end, name):
        out = []
        for i, x in enumerate(items):
            inside = [j for j, y in enumerate(items)
                      if j != i and start(y) <= start(x) and end(x) <= end(y)]
            out.append(name(items[max(inside, key=lambda j: start(items[j]))]) if inside
                       else None)
        return out

    traced = parent_names(events, lambda e: e["ts"], lambda e: e["ts"] + e["dur"],
                          lambda e: e["name"][len(profiling.PREFIX):])
    recorded = [None if s.parent is None else rec.spans[s.parent].name for s in spans]
    assert traced == recorded


def test_a_query_is_one_root_with_a_search_child(sift_encoder):
    gallery = sift_encoder.encode(_images(4, seed=3))
    idx = tindex.RetrievalIndex(gallery, [str(i) for i in range(4)], device="cpu")
    with profiling.record() as rec:
        idx.query(sift_encoder, _images(1, seed=4), k=2)
    roots = [i for i, s in enumerate(rec.spans) if s.parent is None]
    assert [rec.spans[i].name for i in roots] == ["query"]
    tree = _tree(rec, roots[0])
    assert tree["search"] == "query" and tree["encode"] == "query"
    assert {s.batch for s in rec.spans} == {rec.spans[roots[0]].batch}


def test_records_nest_and_threads_keep_their_own_parents():
    with profiling.record() as outer:
        with profiling.record() as inner:
            assert inner is outer
        with profiling.span("encode", root=True):
            seen = []

            def work():
                with profiling.span("ingest.upload"):
                    profiling.count("h2d_bytes", 7)
                seen.append(True)

            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert seen and not t.is_alive()
        profiling.count("h2d_bytes", torch.tensor(5))
        with torch.inference_mode():  # a sum under inference mode, then one outside
            profiling.count("sift.keypoints", torch.ones(3))
        profiling.count("sift.keypoints", torch.ones(2, 2))
    assert profiling.span("x") is profiling.span("y")
    upload = next(s for s in outer.spans if s.name == "ingest.upload")
    assert upload.parent is None and upload.batch is None
    assert upload.thread != outer.spans[0].thread
    assert outer.counters() == {"h2d_bytes": 12, "sift.keypoints": 7}


def test_dump_writes_the_spans_as_chrome_events(tmp_path):
    with profiling.record() as rec:
        with profiling.span("encode", root=True):
            with profiling.span("features"):
                pass
    rec.dump(tmp_path / "spans.json")
    events = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    assert [e["name"] for e in events] == ["pyvisim.encode", "pyvisim.features"]
    assert events[1]["args"] == {"batch": rec.spans[0].batch, "parent": 0}
    assert events[0]["ts"] <= events[1]["ts"] and events[0]["ph"] == "X"


def test_loading_a_library_is_a_span(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda names: {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    with profiling.record() as rec:
        _build.load_library.__wrapped__("aggregate")
    assert [s.name for s in rec.spans] == ["load_kernels"]


def test_off_the_resnet_trunk_reads_the_flag_and_records_nothing(resnet_extractor, monkeypatch):
    def called(*args, **kwargs):
        raise AssertionError("recording work while recording is off")

    monkeypatch.setattr(profiling._Open, "__init__", called)
    monkeypatch.setattr(profiling.Record, "add", called)
    assert profiling.span("resnet.stem") is profiling.span("resnet.layer4")
    desc, _ = resnet_extractor.extract_batch(_images(2))
    assert desc.shape == (2, 9, 2050)


def test_the_resnet_trunk_records_its_stages_in_features_and_counts_routes(resnet_extractor):
    with profiling.record() as rec:
        resnet_extractor.extract_batch(_images(2))
        resnet_extractor.extract_batch(_images(1, seed=7))
    feats = [i for i, s in enumerate(rec.spans) if s.name == "features"]
    assert len(feats) == 2
    for f in feats:
        under = [s for s in rec.spans if s.parent == f]
        assert [s.name for s in under] == RESNET_STAGES
        assert all(_inside(s, rec.spans[f]) for s in under)
        assert all(a.end_ns <= b.start_ns for a, b in zip(under, under[1:]))
    c = rec.counters()
    assert {k: c[k] for k in RESNET96_ROUTES} == {k: 2 * v for k, v in RESNET96_ROUTES.items()}
