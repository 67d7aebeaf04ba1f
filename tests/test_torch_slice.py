"""The first slice end to end in both stacks: VGG16 deep features -> VLAD ->
retrieval, with the JAX package's weights and codebook carried across."""
import jax
import numpy as np
import pytest
import torch

from pyvisim_tpu import _errors as jerrors
from pyvisim_tpu import _validation as jvalidation
from pyvisim_tpu import eval as jeval
from pyvisim_tpu.encoders import VLADEncoder as JVLADEncoder
from pyvisim_tpu.features import DeepConvFeature as JDeepConvFeature
from pyvisim_tpu.models import vgg as jvgg
from pyvisim_tpu.ops.codebooks import KMeansCodebook as JKMeansCodebook
from pyvisim_tpu_torch import _errors as terrors
from pyvisim_tpu_torch import _validation as tvalidation
from pyvisim_tpu_torch import eval as teval
from pyvisim_tpu_torch.encoders import VLADEncoder
from pyvisim_tpu_torch.features import DeepConvFeature
from pyvisim_tpu_torch.models.vgg import params_from_jax
from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook

K = 8


def _images(rng, n, shape=(72, 80, 3)):
    grid = rng.integers(0, 256, size=(n, 4, 4, 3))
    up = np.repeat(np.repeat(grid, shape[0] // 4, axis=1), shape[1] // 4, axis=2)
    return np.clip(up + rng.normal(0, 12, size=up.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def stacks():
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        np.asarray, jvgg.init_params("vgg16", -1, seed=0, image_size=64)
    )
    jext = JDeepConvFeature("vgg16", params=params, image_size=64)
    images = _images(rng, 6)
    desc, _ = jext.extract_batch(images[:2])
    flat = np.asarray(desc).reshape(-1, 514)
    centers = flat[rng.choice(len(flat), K, replace=False)]
    centers = (centers + 0.01 * rng.normal(size=centers.shape)).astype(np.float32)
    jenc = JVLADEncoder(jext, kmeans_model=JKMeansCodebook(centers))
    text = DeepConvFeature("vgg16", params=params_from_jax(params), image_size=64, device="cpu")
    tenc = VLADEncoder(text, kmeans_model=KMeansCodebook(centers))
    return jenc, tenc, images


def test_encode_matches_jax(stacks):
    jenc, tenc, images = stacks
    want = np.asarray(jenc.encode(images[:4]))
    got = tenc.encode(images[:4])
    assert got.shape == (4, K * 514) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_unflattened_encode_stacks_blocks(stacks):
    jenc, tenc, images = stacks
    tenc.flatten = jenc.flatten = False
    try:
        got, want = tenc.encode(images[:2]), np.asarray(jenc.encode(images[:2]))
    finally:
        tenc.flatten = jenc.flatten = True
    assert got.shape == want.shape == (2 * K, 514)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_similarity_score_matches_jax(stacks):
    jenc, tenc, images = stacks
    want = jenc.similarity_score(images[:2], images[2:5])
    got = tenc.similarity_score(images[:2], images[2:5])
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def galleries(stacks):
    jenc, tenc, images = stacks
    paths = [f"img_{i}.png" for i in range(len(images))]
    labels = {p: i % 3 for i, p in enumerate(paths)}
    jgal = dict(zip(paths, np.asarray(jenc.encode(images))))
    tgal = dict(zip(paths, tenc.encode(images)))
    return jgal, tgal, labels


@pytest.mark.parametrize("k", [None, 2])
def test_top_k_map_matches_jax(stacks, galleries, k):
    jenc, tenc, images = stacks
    jgal, tgal, labels = galleries
    queries, qlabels = images[1:4], [1, 2, 0]
    want = jeval.top_k_map(queries, qlabels, jgal, labels, jenc, k=k)
    got = teval.top_k_map(queries, qlabels, tgal, labels, tenc, k=k, device="cpu")
    assert got == want


def test_top_k_accuracy_matches_jax(stacks, galleries):
    jenc, tenc, images = stacks
    jgal, tgal, labels = galleries
    queries, qlabels = images[:3], [0, 1, 2]
    want = jeval.top_k_accuracy(queries, qlabels, jgal, labels, jenc, k=1)
    got = teval.top_k_accuracy(queries, qlabels, tgal, labels, tenc, k=1, device="cpu")
    assert got == want == 1.0


def test_retrieve_top_k_similar_matches_jax(stacks, galleries):
    jenc, tenc, images = stacks
    jgal, tgal, _ = galleries
    want = jeval.retrieve_top_k_similar(images[4], jgal, jenc, k=3)
    got = teval.retrieve_top_k_similar(images[4], tgal, tenc, k=3, device="cpu")
    assert [p for p, _ in got] == [p for p, _ in want]
    assert got[0][0] == "img_4.png"
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-5)


def test_average_precision_matches_jax():
    rel = np.random.default_rng(1).random((5, 9)) > 0.6
    np.testing.assert_array_equal(teval.average_precision(rel), jeval.average_precision(rel))


_IMAGES = {
    "uint8_hwc": np.zeros((5, 6, 3), np.uint8),
    "int_mask": np.ones((5, 6)),
    "fractional_mask": np.full((5, 6), 0.5),
    "four_channels": np.zeros((5, 6, 4)),
    "above_255": np.full((5, 6, 3), 256.0),
    "four_dims": np.zeros((1, 5, 6, 3)),
    "torch_chw": torch.full((3, 5, 6), 0.5),
    "torch_above_1": torch.full((3, 5, 6), 1.5),
    "list": [[0, 1], [2, 3]],
}


@pytest.mark.parametrize("name", sorted(_IMAGES))
def test_validate_image_accepts_and_refuses_as_jax(name):
    def verdict(validate, error):
        try:
            validate(_IMAGES[name])
        except error:
            return "refused"
        return "accepted"

    want = verdict(jvalidation.validate_image, jerrors.InvalidImageError)
    assert verdict(tvalidation.validate_image, terrors.InvalidImageError) == want
