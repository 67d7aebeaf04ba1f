"""Vocabulary learning in both stacks: single Lloyd and EM steps, the GMM
initialisation and PCA exactly from the same state; whole K-Means/GMM fits
and ``learn()`` at quality level (the seeding draws differ); and a GMM + PCA
learned by the port, saved, loaded and used by the JAX package."""
import jax
import numpy as np
import pytest
import torch

from pyvisim_tpu import eval as jeval
from pyvisim_tpu.encoders import FisherVectorEncoder as JFisherVectorEncoder
from pyvisim_tpu.encoders import VLADEncoder as JVLADEncoder
from pyvisim_tpu.features import DeepConvFeature as JDeepConvFeature
from pyvisim_tpu.models import vgg as jvgg
from pyvisim_tpu.ops import gmm as jgmm
from pyvisim_tpu.ops import kmeans as jkmeans
from pyvisim_tpu.ops import nearest_centroid as jnearest_centroid
from pyvisim_tpu.ops import pca as jpca
from pyvisim_tpu.ops.codebooks import GmmCodebook as JGmmCodebook
from pyvisim_tpu.ops.codebooks import KMeansCodebook as JKMeansCodebook
from pyvisim_tpu.ops.codebooks import load_codebook as jload_codebook
from pyvisim_tpu.ops.pallas import lloyd_stats_pallas
from pyvisim_tpu_torch import eval as teval
from pyvisim_tpu_torch.encoders import FisherVectorEncoder, VLADEncoder
from pyvisim_tpu_torch.features import DeepConvFeature
from pyvisim_tpu_torch.models.vgg import params_from_jax
from pyvisim_tpu_torch.ops import gmm as tgmm
from pyvisim_tpu_torch.ops import kmeans as tkmeans
from pyvisim_tpu_torch.ops import pca as tpca
from pyvisim_tpu_torch.ops.codebooks import GmmCodebook, KMeansCodebook, save_codebook
from pyvisim_tpu_torch.ops.cuda.lloyd_stats import lloyd_stats

T = torch.from_numpy


@pytest.fixture
def blobs():
    """The blobs of the JAX package's training tests."""
    rng = np.random.default_rng(42)
    centers = rng.normal(scale=8.0, size=(5, 12)).astype(np.float32)
    labels = rng.integers(0, 5, size=600)
    x = centers[labels] + rng.normal(scale=0.3, size=(600, 12)).astype(np.float32)
    return x.astype(np.float32), labels, centers


def _margin_set(seed=0, n=300, d=24, k=8):
    """Rows near known prototypes, so no nearest center is a near tie."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(k, d)).astype(np.float32)
    x = (protos[rng.integers(0, k, n)] + 0.1 * rng.normal(size=(n, d))).astype(np.float32)
    mask = (rng.random(n) > 0.1).astype(np.float32)
    mask[0] = 0.37
    centers = (protos + 0.01 * rng.normal(size=(k, d))).astype(np.float32)
    return x, mask, centers


@pytest.mark.parametrize("chunk_size", [None, 128])
def test_lloyd_step_matches_jax(chunk_size):
    x, mask, centers = _margin_set()
    got_c, got_i = tkmeans.lloyd_step(T(x), T(mask), T(centers), chunk_size)
    want_c, want_i = jkmeans.lloyd_step(x, mask, centers, chunk_size)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4, atol=1e-4)
    assert float(got_i) == pytest.approx(float(want_i), rel=1e-4)


def test_lloyd_stats_plain_version_matches_pallas_kernel():
    from jax.experimental.pallas import tpu as pltpu

    x, mask, centers = _margin_set(seed=1)
    sums, counts, inertia, labels = lloyd_stats(T(x), T(mask), T(centers), return_labels=True)
    assert lloyd_stats.launches == 0  # CPU tensors take the plain version
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jnearest_centroid(x, centers)))
    with pltpu.force_tpu_interpret_mode():
        w_sums, w_counts, w_inertia = lloyd_stats_pallas(x, mask, centers, block_n=128)
    np.testing.assert_allclose(sums.numpy(), np.asarray(w_sums), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(counts.numpy(), np.asarray(w_counts), rtol=1e-6)
    assert float(inertia) == pytest.approx(float(w_inertia), rel=1e-4)


@pytest.mark.parametrize("case", ["nan_weighted", "nan_weightless", "inf_weightless",
                                  "inf_weighted"])
def test_lloyd_stats_plain_version_carries_nan_and_inf_as_pallas_kernel(case):
    """One NaN or inf in a row of nonzero or zero weight: sums NaN in
    column 5 of every cluster (but the inf's own, which is +-inf) and the
    inertia NaN, in the Pallas kernel and the plain version alike (the rule
    the CUDA kernel is held to on the card); counts and the finite sums as
    in the clean test."""
    from jax.experimental.pallas import tpu as pltpu

    x, mask, centers = _margin_set(seed=1)
    row = int(np.flatnonzero((mask != 0) == case.endswith("_weighted"))[3])
    x[row, 5] = np.inf if case.startswith("inf") else np.nan
    sums, counts, inertia = lloyd_stats(T(x), T(mask), T(centers))
    with pltpu.force_tpu_interpret_mode():
        w_sums, w_counts, w_inertia = (np.asarray(t) for t in
                                       lloyd_stats_pallas(x, mask, centers, block_n=128))
    assert np.isnan(w_sums[:, 5]).sum() == len(centers) - (case == "inf_weighted")
    assert np.isnan(w_inertia)
    np.testing.assert_array_equal(np.isnan(sums.numpy()), np.isnan(w_sums))
    np.testing.assert_array_equal(np.isinf(sums.numpy()), np.isinf(w_sums))
    finite = np.isfinite(w_sums)
    np.testing.assert_allclose(sums.numpy()[finite], w_sums[finite], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(counts.numpy(), w_counts, rtol=1e-6)
    assert np.isnan(float(inertia))


def _gmm_state():
    """Clusters whose |mean| / std stays near 4: the covariances are
    ``s2/nk - mean^2``, and a larger ratio leaves them to the summation
    order of either stack (1e-4 relative at the blobs' ratio of ~27)."""
    rng = np.random.default_rng(5)
    centers = rng.normal(scale=2.0, size=(5, 12)).astype(np.float32)
    x = (centers[rng.integers(0, 5, 600)] + rng.normal(scale=0.5, size=(600, 12)))
    mask = (rng.random(600) > 0.1).astype(np.float32)
    km = (centers + rng.normal(scale=0.3, size=centers.shape)).astype(np.float32)
    return x.astype(np.float32), mask, km


@pytest.mark.parametrize("chunk_size", [None, 128])
def test_em_step_matches_jax(chunk_size):
    x, mask, km = _gmm_state()
    init = jgmm._init_from_kmeans(x, mask, JKMeansCodebook(km), 1e-6)
    start = {f: np.array(getattr(init, f)) for f in ("weights", "means", "covariances")}
    want, want_ll = jgmm.em_step(x, mask, JGmmCodebook(**start), 1e-6, chunk_size)
    got, got_ll = tgmm.em_step(T(x), T(mask), GmmCodebook(**start), 1e-6, chunk_size)
    for f in ("weights", "means", "covariances"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-5)
    assert float(got_ll) == pytest.approx(float(want_ll), rel=1e-5)
    resp, mean_ll = tgmm._e_step(T(x), T(mask), GmmCodebook(**start))
    want_resp, want_mean_ll = jgmm._e_step(x, mask, JGmmCodebook(**start))
    np.testing.assert_allclose(resp.numpy(), np.asarray(want_resp), atol=1e-5)
    assert float(mean_ll) == pytest.approx(float(want_mean_ll), rel=1e-5)


def test_init_from_kmeans_matches_jax():
    x, mask, km = _gmm_state()
    want = jgmm._init_from_kmeans(x, mask, JKMeansCodebook(km), 1e-6)
    got = tgmm._init_from_kmeans(T(x), T(mask), KMeansCodebook(km), 1e-6)
    for f in ("weights", "means", "covariances"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6)


def test_pca_fit_matches_jax():
    rng = np.random.default_rng(6)
    rotation = np.linalg.qr(rng.normal(size=(12, 12)))[0]
    scales = 2.0 ** (6 - np.arange(12))  # well-separated variances
    x = ((rng.normal(size=(400, 12)) * scales) @ rotation + 3.0).astype(np.float32)
    mask = (rng.random(400) > 0.2).astype(np.float32)
    want = jpca.pca_fit(x, 4, mask=mask)
    got = tpca.pca_fit(x, 4, mask=mask, device="cpu")
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.components.numpy(), np.asarray(want.components), atol=1e-4)
    np.testing.assert_allclose(got.explained_variance.numpy(),
                               np.asarray(want.explained_variance), rtol=1e-4)
    np.testing.assert_allclose(got(T(x[:5])).numpy(), np.asarray(want(x[:5])),
                               rtol=1e-4, atol=1e-3)


def test_kmeans_fit_recovers_blobs_as_jax(blobs):
    x, _, centers = blobs
    history = {}
    got, got_inertia = tkmeans.kmeans_fit(x, 5, seed=1, n_init=3, device="cpu", history=history)
    _, want_inertia = jkmeans.kmeans_fit(x, 5, seed=1, n_init=3)
    np.testing.assert_allclose(np.sort(got.centers.numpy(), axis=0), np.sort(centers, axis=0),
                               atol=0.3)
    assert got_inertia == pytest.approx(want_inertia, rel=0.01)
    assert len(history["lloyd_inertia"]) == 3
    assert min(steps[-1] for steps in history["lloyd_inertia"]) == got_inertia


def test_gmm_fit_log_likelihood_as_jax(blobs):
    x, _, centers = blobs
    history = {}
    got, got_ll = tgmm.gmm_fit(x, 5, seed=0, device="cpu", history=history)
    _, want_ll = jgmm.gmm_fit(x, 5, seed=0)
    assert got_ll == pytest.approx(want_ll, rel=0.01)
    assert history["em_mean_ll"][-1] == got_ll
    assert got.weights.sum().item() == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(np.sort(got.means.numpy(), axis=0), np.sort(centers, axis=0),
                               atol=0.3)


def _vgg_params(seed=0):
    """He-uniform VGG16 params from numpy, in the JAX package's tree (whose
    shapes ``eval_shape`` gives without running its initialiser)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jvgg.init_params("vgg16", -1, seed=0, image_size=64))

    def fill(s):
        if len(s.shape) == 1:
            return np.zeros(s.shape, np.float32)
        limit = np.sqrt(6.0 / np.prod(s.shape[:3]))
        return rng.uniform(-limit, limit, size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


@pytest.fixture(scope="module")
def extractors():
    params = _vgg_params()
    jext = JDeepConvFeature("vgg16", params=params, image_size=64)
    text = DeepConvFeature("vgg16", params=params_from_jax(params), image_size=64, device="cpu")
    return jext, text


def _classes(rng, n_classes=4, per_class=3, shape=(64, 64, 3)):
    """Images of ``n_classes`` block patterns, each repeated with noise."""
    grid = rng.integers(0, 256, size=(n_classes, 4, 4, 3))
    base = np.repeat(np.repeat(grid, shape[0] // 4, axis=1), shape[1] // 4, axis=2)
    images = np.concatenate([base] * per_class)
    images = np.clip(images + rng.normal(0, 20, size=images.shape), 0, 255).astype(np.uint8)
    return images, [i % n_classes for i in range(len(images))]


@pytest.mark.parametrize("kind", ["vlad", "fisher"])
def test_learn_retrieval_accuracy_as_jax(extractors, kind):
    jext, text = extractors
    images, labels = _classes(np.random.default_rng(7))
    kw = dict(n_clusters=4, batch_size=5, max_descriptors=150, seed=3)
    if kind == "vlad":
        jenc, tenc = JVLADEncoder(jext), VLADEncoder(text)
    else:
        jenc, tenc = JFisherVectorEncoder(jext), FisherVectorEncoder(text)
        kw["dim_reduction_factor"] = 16
    jenc.learn(images, **kw)
    tenc.learn(images, **kw)
    if kind == "fisher":
        assert tenc.pca.n_components == 514 // 16
    paths = [f"img_{i}.png" for i in range(len(images))]
    gallery_labels = dict(zip(paths, labels))
    queries = images[:4]
    accuracy = {}
    for name, enc, ev in (("jax", jenc, jeval), ("torch", tenc, teval)):
        gallery = dict(zip(paths, np.asarray(enc.encode(images))))
        extra = {} if name == "jax" else {"device": "cpu"}
        accuracy[name] = ev.top_k_accuracy(queries, labels[:4], gallery, gallery_labels, enc,
                                           k=1, **extra)
    assert abs(accuracy["torch"] - accuracy["jax"]) <= 0.05, accuracy


def test_port_learned_vocabulary_encodes_the_same_in_jax(extractors, tmp_path):
    jext, text = extractors
    images, _ = _classes(np.random.default_rng(8), per_class=2)
    tenc = FisherVectorEncoder(text)
    tenc.learn(images, n_clusters=3, dim_reduction_factor=16, max_iters=5)
    save_codebook(tmp_path / "gmm.npz", tenc.clustering_model)
    save_codebook(tmp_path / "pca.npz", tenc.pca)
    jenc = JFisherVectorEncoder(jext, gmm_model=jload_codebook(tmp_path / "gmm.npz"),
                                pca=jload_codebook(tmp_path / "pca.npz"))
    np.testing.assert_allclose(tenc.encode(images[:3]), np.asarray(jenc.encode(images[:3])),
                               atol=1e-4)
