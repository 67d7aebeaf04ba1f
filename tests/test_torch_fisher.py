"""The Fisher-vector slice in both stacks: GMM posteriors, the GMM statistics
kernel's plain version against the Pallas kernel, Fisher vectors, the
FisherVectorEncoder and Pipeline end to end, and the shipped GMM-k256 /
PCA-257 VGG16 configuration."""
import jax
import numpy as np
import pytest
import torch

from pyvisim_tpu.encoders import FisherVectorEncoder as JFisherVectorEncoder
from pyvisim_tpu.encoders import GMMWeights as JGMMWeights
from pyvisim_tpu.encoders import Pipeline as JPipeline
from pyvisim_tpu.encoders import VLADEncoder as JVLADEncoder
from pyvisim_tpu.features import DeepConvFeature as JDeepConvFeature
from pyvisim_tpu.models import vgg as jvgg
from pyvisim_tpu.ops import assign as jassign
from pyvisim_tpu.ops import fisher as jfisher
from pyvisim_tpu.ops.codebooks import GmmCodebook as JGmmCodebook
from pyvisim_tpu.ops.codebooks import KMeansCodebook as JKMeansCodebook
from pyvisim_tpu.ops.codebooks import PcaProjector as JPcaProjector
from pyvisim_tpu.ops.pallas import fisher_stats_pallas, gmm_em_stats_pallas
from pyvisim_tpu_torch.encoders import FisherVectorEncoder, GMMWeights, Pipeline, VLADEncoder
from pyvisim_tpu_torch.features import DeepConvFeature
from pyvisim_tpu_torch.models.vgg import params_from_jax
from pyvisim_tpu_torch.ops import assign as tassign
from pyvisim_tpu_torch.ops import fisher as tfisher
from pyvisim_tpu_torch.ops.codebooks import GmmCodebook, KMeansCodebook, PcaProjector
from pyvisim_tpu_torch.ops.cuda.gmm_stats import gmm_stats_batched, gmm_stats_reference


def _gmm(rng, k, d):
    w = rng.random(k) + 0.1
    return (
        (w / w.sum()).astype(np.float32),
        rng.normal(size=(k, d)).astype(np.float32),
        (rng.random((k, d)) + 0.5).astype(np.float32),
    )


def _sets(rng, b, n, d):
    desc = rng.normal(size=(b, n, d)).astype(np.float32)
    mask = (rng.random((b, n)) > 0.1).astype(np.float32)
    mask[0, 0] = 0.37  # one fractional weight
    mask[1] = 0.0  # one fully masked set
    return desc, mask


def test_gmm_log_prob_and_posteriors_match_jax():
    rng = np.random.default_rng(0)
    w, mu, cov = _gmm(rng, 6, 12)
    x = rng.normal(size=(40, 12)).astype(np.float32)
    jg = JGmmCodebook(weights=w, means=mu, covariances=cov)
    tg = GmmCodebook(weights=w, means=mu, covariances=cov)
    got = tassign.gmm_log_prob(torch.from_numpy(x), tg).numpy()
    np.testing.assert_allclose(got, np.asarray(jassign.gmm_log_prob(x, jg)), rtol=1e-5, atol=1e-4)
    got = tassign.gmm_posteriors(torch.from_numpy(x), tg).numpy()
    np.testing.assert_allclose(got, np.asarray(jassign.gmm_posteriors(x, jg)), atol=1e-5)


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("form", ["em", "fisher"])
def test_gmm_stats_plain_version_matches_pallas_kernel(interpret_mode, form):
    rng = np.random.default_rng(1)
    k, d = 8, 16
    w, mu, cov = _gmm(rng, k, d)
    desc, mask = _sets(rng, 3, 64, d)
    got = gmm_stats_batched(
        *(torch.from_numpy(a) for a in (desc, mask, w, mu, cov)), with_ll=True
    )
    assert gmm_stats_batched.launches == 0  # CPU tensors take the plain version
    want_ref = gmm_stats_reference(
        *(torch.from_numpy(a) for a in (desc, mask, w, mu, cov)), with_ll=True
    )
    for a, b in zip(got, want_ref):
        assert torch.equal(a, b)
    s0, s1, s2, ll = (t.numpy() for t in got)
    assert not (s0[1].any() or s1[1].any() or s2[1].any() or ll[1])
    for b in range(desc.shape[0]):
        if form == "em":
            w0, w1, w2, wll = gmm_em_stats_pallas(desc[b], mask[b], w, mu, cov, block_n=32)
            np.testing.assert_allclose(ll[b], np.asarray(wll), rtol=1e-5, atol=1e-5)
            g0, g1, g2 = s0[b], s1[b], s2[b]
        else:
            w0, w1, w2 = fisher_stats_pallas(desc[b], mask[b], w, mu, cov, block_n=32)
            g0, g1, g2 = (t.numpy() for t in tfisher.fisher_stats(
                torch.from_numpy(desc[b]), torch.from_numpy(mask[b]),
                GmmCodebook(weights=w, means=mu, covariances=cov),
            ))
        np.testing.assert_allclose(g0, np.asarray(w0), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g1, np.asarray(w1), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g2, np.asarray(w2), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["nan_in_a_masked_row", "masked_zero_rows"])
def test_gmm_stats_plain_version_carries_masked_rows_as_pallas_kernel(interpret_mode, case):
    """A NaN in a row of weight 0 makes every statistic of its set NaN in
    both (softmax * 0 is NaN there); rows of zeros that all weigh 0 give
    zeros in both. The CUDA kernel is held to the plain version on the
    card (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(3)
    w, mu, cov = _gmm(rng, 8, 16)
    desc = rng.normal(size=(64, 16)).astype(np.float32)
    mask = (rng.random(64) > 0.5).astype(np.float32)
    if case == "nan_in_a_masked_row":
        desc[np.flatnonzero(mask == 0)[0], 3] = np.nan
    else:
        desc[:] = 0.0
        mask[:] = 0.0
    got = gmm_stats_reference(
        *(torch.from_numpy(a) for a in (desc[None], mask[None], w, mu, cov)), with_ll=True
    )
    want = gmm_em_stats_pallas(desc, mask, w, mu, cov, block_n=32)
    for a, b in zip(got, want):
        a, b = a[0].numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        if case == "nan_in_a_masked_row":
            assert np.isnan(a).all()
        else:
            assert not a.any() and not b.any()


@pytest.mark.parametrize("chunk_size", [None, 24])
def test_fisher_encode_batch_matches_jax(chunk_size):
    rng = np.random.default_rng(2)
    w, mu, cov = _gmm(rng, 5, 10)
    desc, mask = _sets(rng, 4, 50, 10)
    kw = dict(power_norm_weight=0.5, chunk_size=chunk_size)
    want = np.asarray(jfisher.fisher_encode_batch(
        desc, mask, JGmmCodebook(weights=w, means=mu, covariances=cov), **kw
    ))
    tg = GmmCodebook(weights=w, means=mu, covariances=cov)
    got = tfisher.fisher_encode_batch(torch.from_numpy(desc), torch.from_numpy(mask), tg, **kw)
    assert got.shape == (4, 2 * 5 * 10 + 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    one = tfisher.fisher_encode(torch.from_numpy(desc[2]), None, tg, flatten=False)
    want_one = jfisher.fisher_encode(desc[2], None, JGmmCodebook(weights=w, means=mu, covariances=cov),
                                     flatten=False)
    assert one.shape == (1, 105)
    np.testing.assert_allclose(one.numpy(), np.asarray(want_one), atol=1e-4)


def _images(rng, n, shape=(72, 80, 3)):
    grid = rng.integers(0, 256, size=(n, 4, 4, 3))
    up = np.repeat(np.repeat(grid, shape[0] // 4, axis=1), shape[1] // 4, axis=2)
    return np.clip(up + rng.normal(0, 12, size=up.shape), 0, 255).astype(np.uint8)


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


@pytest.fixture(scope="module")
def stacks(extractors):
    """A VLAD-k6 and a PCA-32 + GMM-k4 vocabulary built from the JAX
    extractor's descriptors, held by encoders of both stacks."""
    jext, text = extractors
    rng = np.random.default_rng(3)
    images = _images(rng, 6)
    desc, _ = jext.extract_batch(images[:3])
    flat = np.asarray(desc).reshape(-1, 514)
    mean = flat.mean(0)
    comps = np.linalg.svd(flat - mean, full_matrices=False)[2][:32].astype(np.float32)
    proj = (flat - mean) @ comps.T
    centers = (flat[rng.choice(len(flat), 6, replace=False)]
               + 0.01 * rng.normal(size=(6, 514))).astype(np.float32)
    means = proj[rng.choice(len(proj), 4, replace=False)].astype(np.float32)
    covs = np.tile(proj.var(0), (4, 1)).astype(np.float32) + 0.1
    w = np.full(4, 0.25, np.float32)
    jenc_v = JVLADEncoder(jext, kmeans_model=JKMeansCodebook(centers))
    tenc_v = VLADEncoder(text, kmeans_model=KMeansCodebook(centers))
    jenc_f = JFisherVectorEncoder(
        jext, gmm_model=JGmmCodebook(weights=w, means=means, covariances=covs),
        pca=JPcaProjector(mean=mean.astype(np.float32), components=comps),
    )
    tenc_f = FisherVectorEncoder(
        text, gmm_model=GmmCodebook(weights=w, means=means, covariances=covs),
        pca=PcaProjector(mean=mean.astype(np.float32), components=comps),
    )
    return jenc_v, tenc_v, jenc_f, tenc_f, images


def test_fisher_vector_encoder_matches_jax(stacks):
    _, _, jenc, tenc, images = stacks
    got = tenc.encode(images[:4])
    assert got.shape == (4, 2 * 4 * 32 + 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jenc.encode(images[:4])), atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    tenc.flatten = jenc.flatten = False
    try:
        got, want = tenc.encode(images[:2]), np.asarray(jenc.encode(images[:2]))
    finally:
        tenc.flatten = jenc.flatten = True
    assert got.shape == want.shape == (2, 260)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_pipeline_matches_jax_with_one_extraction(stacks, extractors, monkeypatch):
    jenc_v, tenc_v, jenc_f, tenc_f, images = stacks
    calls = []
    original = type(extractors[1]).extract_batch
    monkeypatch.setattr(type(extractors[1]), "extract_batch",
                        lambda self, imgs: calls.append(1) or original(self, imgs))
    pipe = Pipeline([tenc_v, tenc_f])
    got = pipe.encode(images[:4])
    assert len(calls) == 1
    assert got.shape == (4, 6 * 514 + 260)
    want = JPipeline([jenc_v, jenc_f]).encode(images[:4])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    sims = Pipeline([tenc_v, tenc_f]).similarity_score(images[:2], images[2:5])
    want = JPipeline([jenc_v, jenc_f]).similarity_score(images[:2], images[2:5])
    assert sims.shape == (2, 3)
    np.testing.assert_allclose(sims, want, atol=1e-5)


def test_shipped_gmm_k256_pca257_configuration_matches_jax(extractors):
    jext, text = extractors
    images = _images(np.random.default_rng(4), 2)
    jenc = JFisherVectorEncoder(jext, weights=JGMMWeights.OXFORD102_K256_VGG16_PCA)
    tenc = FisherVectorEncoder(text, weights=GMMWeights.OXFORD102_K256_VGG16_PCA)
    assert tenc.pca.n_components == 257 and tenc.clustering_model.n_components == 256
    got = tenc.encode(images)
    assert got.shape == (2, 131_840)
    np.testing.assert_allclose(got, np.asarray(jenc.encode(images)), atol=1e-4)
