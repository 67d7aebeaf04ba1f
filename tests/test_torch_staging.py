"""The staged host copies (``pyvisim_tpu_torch.io._staging``): ``upload``
and ``readback`` give what the plain ``.to()`` and ``.cpu().numpy()``
give, bit for bit, route by device, size, layout and dtype, count each
call by route, and hand the caller nothing that shares memory with the
ring. On the CPU the ring's chunk loop runs with ordinary CPU buffers
standing in for page-locked ones, and small chunks, so that a few hundred
bytes cross several chunk boundaries."""
import sys
import threading

import numpy as np
import pytest
import torch

from pyvisim_tpu_torch import profiling
from pyvisim_tpu_torch.encoders import VLADEncoder
from pyvisim_tpu_torch.features import DeepConvFeature, RootSIFT
from pyvisim_tpu_torch.io import _staging
from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook

CHUNK = 64  # bytes of one stand-in buffer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def staged_cpu(monkeypatch):
    """The CPU standing in for a card: its copies staged through fresh
    rings of ``CHUNK``-byte buffers, from the smallest size up."""
    monkeypatch.setattr(_staging, "_stages_on", lambda device: True)
    monkeypatch.setattr(_staging, "CHUNK_BYTES", CHUNK)
    monkeypatch.setattr(_staging, "MIN_BYTES", 0)
    monkeypatch.setattr(_staging, "_RINGS", {})
    return _staging._RINGS


def _array(nbytes: int, dtype, seed=0) -> np.ndarray:
    n = nbytes // np.dtype(dtype).itemsize
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == np.uint8:
        return rng.integers(0, 256, n, dtype=np.uint8)
    return rng.standard_normal(n).astype(dtype)


def _counts(fn) -> dict:
    with profiling.record() as rec:
        fn()
    c = rec.counters()
    return {k: c.get(k, 0) for k in ("copy.staged", "copy.plain")}


# Sizes in chunks: none, under one, exactly three, three and a remainder.
SIZES = {"empty": 0, "under_a_chunk": CHUNK // 2, "chunks": 3 * CHUNK,
         "chunks_and_a_rest": 5 * CHUNK + 24}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_staged_copies_equal_the_plain_ones_bit_for_bit(staged_cpu, size, dtype):
    host = _array(SIZES[size], dtype, seed=len(size)).reshape(-1, 1)
    up = []
    counts = _counts(lambda: up.append(_staging.upload(host, "cpu")))
    assert counts == {"copy.staged": 1, "copy.plain": 0}
    (got,) = up
    want = torch.from_numpy(host)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    assert host.size == 0 or got.data_ptr() != want.data_ptr()
    tensor = torch.tensor(_array(SIZES[size], dtype, seed=7))
    down = []
    counts = _counts(lambda: down.append(_staging.readback(tensor)))
    assert counts == {"copy.staged": 1, "copy.plain": 0}
    (back,) = down
    assert back.dtype == np.dtype(dtype) and back.shape == tuple(tensor.shape)
    np.testing.assert_array_equal(back, tensor.numpy())
    assert not np.shares_memory(back, tensor.numpy())


def test_shapes_and_dtypes_survive_the_byte_view(staged_cpu):
    values = 100 * _array(6 * CHUNK, np.float32, seed=3).reshape(4, -1)
    for dtype in (np.bool_, np.int8, np.int16, np.int64, np.float16, np.float64, np.complex64):
        host = values.astype(dtype)
        got = _staging.upload(host, "cpu")
        assert torch.equal(got, torch.from_numpy(host)), dtype
        back = _staging.readback(got)
        assert back.dtype == host.dtype and back.shape == host.shape
        assert back.tobytes() == host.tobytes()
    scalar = np.array(3.5, np.float32)
    assert _staging.upload(scalar, "cpu").shape == () and _staging.readback(
        torch.tensor(2.5)).shape == ()


def test_routes_by_device_size_layout_and_dtype(monkeypatch):
    monkeypatch.setattr(_staging, "_RINGS", {})
    assert _staging._stages_on(torch.device("cuda", 0))
    assert not _staging._stages_on(torch.device("cpu"))
    big = np.zeros((2, _staging.MIN_BYTES), np.uint8)
    # The CPU takes the plain copies, whatever the size.
    assert _counts(lambda: _staging.upload(big, "cpu")) == {"copy.staged": 0, "copy.plain": 1}
    assert _counts(lambda: _staging.readback(torch.zeros(2, _staging.MIN_BYTES))) == {
        "copy.staged": 0, "copy.plain": 1}
    monkeypatch.setattr(_staging, "_stages_on", lambda device: True)
    small = np.zeros(_staging.MIN_BYTES - 1, np.uint8)
    cases = {
        "at_the_threshold": (np.zeros(_staging.MIN_BYTES, np.uint8), 1),
        "under_it": (small, 0),
        "strided": (big[:, ::2], 0),
        "fortran_order": (np.asfortranarray(big.reshape(4, -1)), 0),
        "a_list": ([1.0] * (_staging.MIN_BYTES // 4), 0),
    }
    for name, (array, staged) in cases.items():
        out = []
        assert _counts(lambda: out.append(_staging.upload(array, "cpu"))) == {
            "copy.staged": staged, "copy.plain": 1 - staged}, name
        assert torch.equal(out[0], torch.as_tensor(array)), name
    swapped = big.view(np.float32).astype(">f4")  # torch refuses it, as before
    assert _counts(lambda: pytest.raises(ValueError, _staging.upload, swapped, "cpu")) == {
        "copy.staged": 0, "copy.plain": 1}
    tensor = torch.arange(2 * _staging.MIN_BYTES // 4, dtype=torch.float32).reshape(2, -1)
    grad = tensor.clone().requires_grad_()
    cases = {
        "at_the_threshold": (tensor, 1),
        "under_it": (tensor.flatten()[: _staging.MIN_BYTES // 4 - 1], 0),
        "transposed": (tensor.T, 0),
        "bfloat16": (tensor.to(torch.bfloat16), 0),
        "needs_grad": (grad, 0),
    }
    for name, (t, staged) in cases.items():
        def run(t=t):
            try:
                _staging.readback(t)
            except (TypeError, RuntimeError):  # .cpu().numpy() refuses these two
                assert t.dtype == torch.bfloat16 or t.requires_grad

        assert _counts(run) == {"copy.staged": staged, "copy.plain": 1 - staged}, name
    np.testing.assert_array_equal(_staging.readback(tensor.T), tensor.T.numpy())


def test_non_contiguous_input_takes_the_plain_copy_unchanged(staged_cpu):
    host = _array(12 * CHUNK, np.float32).reshape(24, -1)
    view = host[:, 1::3]
    assert not view.flags.c_contiguous
    out = []
    assert _counts(lambda: out.append(_staging.upload(view, "cpu"))) == {
        "copy.staged": 0, "copy.plain": 1}
    assert torch.equal(out[0], torch.from_numpy(view))
    assert staged_cpu == {}  # no ring was made for it


def test_results_share_no_memory_with_the_ring_or_each_other(staged_cpu):
    first_t = torch.from_numpy(_array(5 * CHUNK + 8, np.float32, seed=1))
    first = _staging.readback(first_t)
    kept = first.copy()
    up_host = _array(4 * CHUNK + 3, np.uint8, seed=2)
    up_first = _staging.upload(up_host, "cpu")
    up_kept = up_first.clone()
    # A second call of each with other data rewrites every ring buffer.
    second = _staging.readback(torch.from_numpy(_array(5 * CHUNK + 8, np.float32, seed=9)))
    _staging.upload(_array(4 * CHUNK + 3, np.uint8, seed=8), "cpu")
    np.testing.assert_array_equal(first, kept)
    assert torch.equal(up_first, up_kept)
    assert not np.shares_memory(first, second)
    assert set(staged_cpu) == {(torch.device("cpu"), "up"), (torch.device("cpu"), "down")}
    for ring in staged_cpu.values():
        for buf in ring.buffers:
            for arr in (first, second):
                assert not np.shares_memory(arr, buf.numpy())
            lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
            assert not lo <= up_first.data_ptr() < hi


def test_the_ring_is_allocated_once_per_device_and_direction(staged_cpu):
    for seed in range(3):
        _staging.upload(_array(7 * CHUNK, np.uint8, seed=seed), "cpu")
        _staging.readback(torch.from_numpy(_array(7 * CHUNK, np.uint8, seed=seed)))
    assert len(staged_cpu) == 2
    ring = staged_cpu[torch.device("cpu"), "up"]
    buffers = [b.data_ptr() for b in ring.buffers]
    _staging.upload(_array(9 * CHUNK, np.uint8), "cpu")
    assert [b.data_ptr() for b in ring.buffers] == buffers
    assert all(b.numel() == CHUNK for b in ring.buffers)
    # What a card holds: two rings of RING_BUFFERS buffers, at most 48 MiB.
    assert 2 * _staging.RING_BUFFERS * _staging.CHUNK_BYTES <= 48 << 20


def test_threads_sharing_a_ring_each_get_their_own_data(staged_cpu):
    """More threads than cores, switching often: the ring's lock keeps
    each call's chunks apart."""
    errors, interval = [], sys.getswitchinterval()

    def work(seed):
        try:
            for i in range(20):
                host = _array(6 * CHUNK + 4 * seed, np.float32, seed=seed * 100 + i)
                got = _staging.upload(host, "cpu")
                back = _staging.readback(got)
                if not (torch.equal(got, torch.from_numpy(host))
                        and np.array_equal(back, host)):
                    errors.append(seed)
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def _images(n=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 48, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("which", ["sift", "deep"])
def test_an_encode_through_the_staged_route_equals_the_plain_one(monkeypatch, which):
    """The call sites: an encode's upload and readback take the staged
    route, and its encodings equal the plain route's bit for bit."""
    if which == "sift":
        ext = RootSIFT(max_keypoints=64, process_size=64, device="cpu")
        d = 128
    else:
        ext = DeepConvFeature("vgg16", int8=True, dtype=torch.bfloat16, image_size=32,
                              device="cpu")
        d = 514
    centers = torch.from_numpy(np.random.default_rng(1).random((8, d), np.float32))
    encoder = VLADEncoder(ext, kmeans_model=KMeansCodebook(centers=centers), device="cpu")
    images = _images()
    plain = []
    assert _counts(lambda: plain.append(encoder.encode(images))) == {
        "copy.staged": 0, "copy.plain": 2}
    monkeypatch.setattr(_staging, "_stages_on", lambda device: True)
    monkeypatch.setattr(_staging, "CHUNK_BYTES", 4096)
    monkeypatch.setattr(_staging, "MIN_BYTES", 0)
    monkeypatch.setattr(_staging, "_RINGS", {})
    staged = []
    assert _counts(lambda: staged.append(encoder.encode(images))) == {
        "copy.staged": 2, "copy.plain": 0}
    assert staged[0].dtype == plain[0].dtype and np.array_equal(staged[0], plain[0])
