"""The port's gallery I/O against the JAX package's: the native JPEG loader
(both stacks build the same ``native/image_loader.cpp``), the OpenCV
fallback, the prefetch thread, the encoding maps in dict and HDF5 form, and
SIFT's OpenCV backend.

Decoded pixels, descriptors and map keys are compared bit for bit;
encodings to 1e-4, the VLAD tolerance of ``tests/test_torch_slice.py``
(the trunks add their products in other orders).
"""
import itertools
import time

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from pyvisim_tpu import eval as jeval
from pyvisim_tpu import io as jio
from pyvisim_tpu.encoders import Pipeline as JPipeline
from pyvisim_tpu.encoders import VLADEncoder as JVLADEncoder
from pyvisim_tpu.encoders import load_encoding_map as jload_encoding_map
from pyvisim_tpu.features import SIFT as JSIFT
from pyvisim_tpu.features import DeepConvFeature as JDeepConvFeature
from pyvisim_tpu.features import RootSIFT as JRootSIFT
from pyvisim_tpu.models import vgg as jvgg
from pyvisim_tpu.ops.codebooks import KMeansCodebook as JKMeansCodebook
from pyvisim_tpu_torch import eval as teval
from pyvisim_tpu_torch import io as tio
from pyvisim_tpu_torch.encoders import Pipeline, VLADEncoder, load_encoding_map
from pyvisim_tpu_torch.features import SIFT, DeepConvFeature, RootSIFT
from pyvisim_tpu_torch.io import _loader
from pyvisim_tpu_torch.models.vgg import params_from_jax
from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook

K = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    rng = np.random.default_rng(42)
    root = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i in range(6):
        grid = rng.integers(0, 256, size=(6, 6, 3))
        img = np.repeat(np.repeat(grid, 8 + i, axis=0), 9, axis=1)
        img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)
        p = str(root / f"im{i}.jpg")
        cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        paths.append(p)
    return paths


def test_native_loader_builds_from_the_repository_source():
    assert tio.native_loader_available()
    lib = _loader.library_path()
    assert lib.exists() and lib.parent == _loader.BUILD_DIR
    assert _loader.SOURCE.name == "image_loader.cpp"


def test_single_decode_matches_jax_bit_for_bit(jpegs):
    for p in jpegs:
        got, want = tio.imread_rgb(p), jio.imread_rgb(p)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("target", [(32, 48), (64, 64)])
def test_batch_decode_resize_matches_jax_bit_for_bit(jpegs, target):
    got = tio.imread_rgb_batch(jpegs, target_size=target)
    want = jio.imread_rgb_batch(jpegs, target_size=target)
    assert isinstance(got, np.ndarray) and got.shape == (6, *target, 3)
    np.testing.assert_array_equal(got, want)
    listed = tio.imread_rgb_batch(jpegs)
    assert isinstance(listed, list) and [i.shape for i in listed] == [
        i.shape for i in jio.imread_rgb_batch(jpegs)]


def test_non_jpeg_fallback_and_missing_file(tmp_path):
    img = (np.random.default_rng(0).random((20, 24, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "x.png")
    cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(tio.imread_rgb(p), img)
    batch = tio.imread_rgb_batch([p, p], target_size=(10, 12))
    np.testing.assert_array_equal(batch, jio.imread_rgb_batch([p, p], target_size=(10, 12)))
    with pytest.raises(FileNotFoundError):
        tio.imread_rgb("/nonexistent/path.png")
    with pytest.raises(FileNotFoundError):
        tio.imread_rgb(str(tmp_path / "missing.jpg"))


def test_prefetch_order_and_completion_on_cpu():
    batches = [(np.full((2, 4, 4, 3), i, np.uint8), np.array([i, i]), f"b{i}") for i in range(6)]
    out = list(tio.prefetch_to_device(iter(batches), depth=3, device="cpu"))
    assert len(out) == 6
    for i, (imgs, labels, name) in enumerate(out):
        assert torch.is_tensor(imgs) and imgs.device.type == "cpu" and name == f"b{i}"
        assert int(labels[0]) == i and imgs.dtype == torch.uint8


def test_prefetch_propagates_producer_error():
    def bad_source():
        yield np.zeros((1,))
        raise RuntimeError("decode failed")

    it = tio.PrefetchIterator(bad_source(), to_device=False)
    assert isinstance(next(it), np.ndarray)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetch_close_joins_blocked_producer():
    it = tio.prefetch_to_device(itertools.count(), depth=1, device="cpu")
    next(it)  # the producer now blocks refilling the depth-1 queue
    time.sleep(0.05)
    it.close()
    it._thread.join(timeout=2.0)
    assert not it._thread.is_alive()
    assert it._queue.empty()


@pytest.fixture(scope="module")
def encoders():
    """VLAD-4 over VGG11's second conv at 32^2 in both stacks, the weights
    and the codebooks carried across; and a Pipeline of two VLADs."""
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        np.asarray, jvgg.init_params("vgg11", 1, seed=0, image_size=32))
    jext = JDeepConvFeature("vgg11", params=params, layer_index=1, image_size=32)
    text = DeepConvFeature("vgg11", params=params_from_jax(params, "vgg11"), layer_index=1,
                           image_size=32, device="cpu")
    probe = rng.integers(0, 256, size=(2, 32, 32, 3)).astype(np.uint8)
    flat = np.asarray(jext.extract_batch(probe)[0]).reshape(-1, jext.output_dim)
    books = [flat[rng.choice(len(flat), K, replace=False)].astype(np.float32) for _ in range(2)]
    jv = [JVLADEncoder(jext, kmeans_model=JKMeansCodebook(c)) for c in books]
    tv = [VLADEncoder(text, kmeans_model=KMeansCodebook(c)) for c in books]
    return {"vlad": (jv[0], tv[0]), "pipeline": (JPipeline(jv), Pipeline(tv))}


@pytest.mark.parametrize("kind", ["vlad", "pipeline"])
def test_encoding_map_dict_matches_jax(encoders, jpegs, kind):
    jenc, tenc = encoders[kind]
    want = jenc.generate_encoding_map(jpegs, batch_size=4)
    got = tenc.generate_encoding_map(iter(jpegs), batch_size=4)
    assert list(got) == list(want) == jpegs
    for p in jpegs:
        assert got[p].shape == want[p].shape and got[p].dtype == np.float32
        np.testing.assert_allclose(got[p], want[p], atol=1e-4)


@pytest.mark.parametrize("kind", ["vlad", "pipeline"])
def test_encoding_map_hdf5_loads_in_either_stack(encoders, jpegs, tmp_path, kind):
    jenc, tenc = encoders[kind]
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "torch.h5")
    assert jenc.generate_encoding_map(jpegs, batch_size=4, save_path=jpath) is None
    assert tenc.generate_encoding_map(jpegs, batch_size=4, save_path=tpath) is None
    for path in (jpath, tpath):
        tmap, jmap = load_encoding_map(path), jload_encoding_map(path)
        assert list(tmap) == list(jmap) == jpegs
        for p in jpegs:
            np.testing.assert_array_equal(tmap[p], jmap[p])
        (tp, tv), (jp, jv) = teval._gallery(path), jeval._gallery(path)
        assert tp == jp == jpegs
        np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(load_encoding_map(tpath)[jpegs[0]],
                               load_encoding_map(jpath)[jpegs[0]], atol=1e-4)
    with pytest.raises(ValueError, match="at least one"):
        tenc.generate_encoding_map([], save_path=str(tmp_path / "empty.h5"))


@pytest.mark.parametrize("make, jmake", [(SIFT, JSIFT), (RootSIFT, JRootSIFT)],
                         ids=["sift", "rootsift"])
def test_sift_opencv_backend_matches_jax(make, jmake):
    rng = np.random.default_rng(1)
    grid = rng.integers(0, 256, size=(2, 10, 12, 3))
    images = np.clip(np.repeat(np.repeat(grid, 12, axis=1), 12, axis=2)
                     + rng.normal(0, 8, (2, 120, 144, 3)), 0, 255).astype(np.uint8)
    ext, jext = make(backend="opencv", device="cpu"), jmake(backend="opencv")
    assert ext.descriptor_budget is None
    got, want = ext(images[0]), jext(images[0])
    assert got.shape[1] == 128 and len(got) > 0
    np.testing.assert_array_equal(got, want)
    (gd, gm), (wd, wm) = ext.extract_batch(images), jext.extract_batch(images)
    np.testing.assert_array_equal(gd, np.asarray(wd))
    np.testing.assert_array_equal(gm, np.asarray(wm))
