"""pyvisim_tpu_torch.ops against pyvisim_tpu.ops on the same numpy inputs.

The JAX functions run on the CPU, the Pallas kernel in interpret mode as
tests/test_pallas.py runs it; the port runs its plain versions on CPU
tensors. The CUDA kernel is held against its plain version on the card
in tests/test_torch_cuda.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvisim_tpu.ops import codebooks as jcb
from pyvisim_tpu.ops import norms as jnorms
from pyvisim_tpu.ops import resize as jresize
from pyvisim_tpu.ops import similarity as jsim
from pyvisim_tpu.ops import vlad as jvlad
from pyvisim_tpu.ops.assign import nearest_centroid as j_nearest_centroid
from pyvisim_tpu_torch.ops import codebooks as tcb
from pyvisim_tpu_torch.ops import norms as tnorms
from pyvisim_tpu_torch.ops import resize as tresize
from pyvisim_tpu_torch.ops import similarity as tsim
from pyvisim_tpu_torch.ops import vlad as tvlad
from pyvisim_tpu_torch.ops.assign import nearest_centroid as t_nearest_centroid
from pyvisim_tpu_torch.ops.cuda import aggregate as tagg

MODEL_FILES = jcb.__file__.rsplit("/ops/", 1)[0] + "/res/model_files"


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("power", [1.0, 0.5, 0.3])
def test_power_normalize_matches_jax(power):
    x = np.random.default_rng(0).normal(size=(6, 33)).astype(np.float32)
    want = np.asarray(jnorms.power_normalize(jnp.asarray(x), power))
    got = tnorms.power_normalize(_t(x), power).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("order", [1.0, 2.0, math.inf])
def test_lp_normalize_matches_jax_and_keeps_zero_rows(order):
    x = np.random.default_rng(1).normal(size=(5, 17)).astype(np.float32)
    x[2] = 0.0
    want = np.asarray(jnorms.lp_normalize(jnp.asarray(x), ord=order))
    got = tnorms.lp_normalize(_t(x), ord=order).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert not got[2].any()


def test_nearest_centroid_labels_equal_jax_on_margin_data():
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(24, 40)).astype(np.float32)
    true = rng.integers(0, 24, size=500)
    x = (centers[true] + 0.01 * rng.normal(size=(500, 40))).astype(np.float32)
    want = np.asarray(j_nearest_centroid(jnp.asarray(x), jnp.asarray(centers)))
    got = t_nearest_centroid(_t(x), _t(centers)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, true)


def _set(rng, n=120, d=24, k=7):
    desc = rng.normal(size=(n, d)).astype(np.float32)
    centers = rng.normal(size=(k, d)).astype(np.float32)
    return desc, centers


@pytest.mark.parametrize("case", ["zero_mask_rows", "fractional_mask", "chunked", "all_masked"])
def test_vlad_aggregate_matches_jax(case):
    rng = np.random.default_rng(3)
    desc, centers = _set(rng)
    mask = (rng.random(len(desc)) > 0.2).astype(np.float32)
    chunk = None
    if case == "fractional_mask":
        mask = rng.random(len(desc)).astype(np.float32)
    elif case == "chunked":
        chunk = 32  # 120 = 3 * 32 + 24: the last chunk is padded
    elif case == "all_masked":
        mask[:] = 0.0
    want = np.asarray(jvlad.vlad_aggregate(desc, mask, centers, chunk_size=chunk))
    got = tvlad.vlad_aggregate(_t(desc), _t(mask), _t(centers), chunk_size=chunk).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    if case == "all_masked":
        assert not got.any()
        enc = tvlad.vlad_encode(_t(desc), _t(mask), _t(centers)).numpy()
        assert enc.shape == (centers.size,) and not enc.any()


def test_vlad_encode_batch_matches_jax():
    rng = np.random.default_rng(4)
    desc = rng.normal(size=(3, 16, 514)).astype(np.float32)
    mask = (rng.random((3, 16)) > 0.25).astype(np.float32)
    centers = rng.normal(size=(8, 514)).astype(np.float32)
    kw = dict(power_norm_weight=0.5, norm_order=2.0, epsilon=1e-9)
    want = np.asarray(jvlad.vlad_encode_batch(desc, mask, centers, **kw))
    got = tvlad.vlad_encode_batch(_t(desc), _t(mask), _t(centers), **kw).numpy()
    assert got.shape == (3, 8 * 514)
    np.testing.assert_allclose(got, want, atol=1e-5)
    unflat = tvlad.vlad_encode_batch(_t(desc), None, _t(centers), flatten=False)
    assert tuple(unflat.shape) == (3, 8, 514)


def test_plain_aggregate_matches_the_pallas_kernel():
    from jax.experimental.pallas import tpu as pltpu

    from pyvisim_tpu.ops.pallas import vlad_aggregate_pallas

    rng = np.random.default_rng(5)
    desc = rng.normal(size=(196, 514)).astype(np.float32)
    mask = (rng.random(196) > 0.1).astype(np.float32)
    centers = rng.normal(size=(8, 514)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(vlad_aggregate_pallas(desc, mask, centers, block_n=64))
    got = tagg.vlad_aggregate_reference(_t(desc)[None], _t(mask)[None], _t(centers))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_batched_wrapper_checks_its_inputs():
    desc = torch.zeros(2, 5, 4)
    mask = torch.ones(2, 5)
    centers = torch.zeros(3, 4)
    with pytest.raises(TypeError):
        tagg.vlad_aggregate_batched(desc.double(), mask, centers)
    with pytest.raises(ValueError):
        tagg.vlad_aggregate_batched(desc, mask[:, :4], centers)
    with pytest.raises(ValueError):
        tagg.vlad_aggregate_batched(desc, mask, torch.zeros(3, 5))
    with pytest.raises(ValueError):
        strided = desc.transpose(1, 2).contiguous().transpose(1, 2)
        tagg.vlad_aggregate_batched(strided, mask, centers)


def test_cosine_similarity_matrix_matches_jax_with_zero_row():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 30)).astype(np.float32)
    y = rng.normal(size=(7, 30)).astype(np.float32)
    x[1] = 0.0
    want = np.asarray(jsim.cosine_similarity_matrix(x, y))
    got = tsim.cosine_similarity_matrix(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert not got[1].any()
    np.testing.assert_allclose(
        tsim.pairwise_euclidean(_t(x), _t(y)).numpy(),
        np.asarray(jsim.pairwise_euclidean(x, y)), atol=1e-4,
    )


@pytest.mark.parametrize("name", ["k_means_k256_sift_no_pca.npz", "pca_k256_sift_f2.npz"])
def test_load_codebook_matches_jax(name):
    path = f"{MODEL_FILES}/{name}"
    want = jcb.load_codebook(path)
    got = tcb.load_codebook(path)
    assert type(got).__name__ == type(want).__name__
    for field, value in vars(want).items():
        mine = getattr(got, field)
        if isinstance(value, bool) or value is None:
            assert mine == value
        else:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(value))
    tcb.validate_codebook(got)


def test_codebook_saved_by_the_port_loads_in_jax(tmp_path):
    rng = np.random.default_rng(7)
    pca = tcb.PcaProjector(
        mean=rng.normal(size=6).astype(np.float32),
        components=rng.normal(size=(3, 6)).astype(np.float32),
        explained_variance=rng.random(3).astype(np.float32) + 0.1,
        whiten=True,
    )
    tcb.save_codebook(tmp_path / "pca.npz", pca)
    back = jcb.load_codebook(tmp_path / "pca.npz")
    assert back.whiten is True
    np.testing.assert_array_equal(np.asarray(back.components), pca.components.numpy())


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_projector_matches_jax(whiten):
    rng = np.random.default_rng(8)
    fields = dict(
        mean=rng.normal(size=20).astype(np.float32),
        components=rng.normal(size=(6, 20)).astype(np.float32),
        explained_variance=(rng.random(6) + 0.5).astype(np.float32),
    )
    x = rng.normal(size=(3, 11, 20)).astype(np.float32)
    jfields = {k: jnp.asarray(v) for k, v in fields.items()}
    want = np.asarray(jcb.PcaProjector(whiten=whiten, **jfields)(x))
    got = tcb.PcaProjector(whiten=whiten, **fields)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", [(50, 70), (20, 40)])
def test_masked_linear_resize_matches_jax(shape):
    rng = np.random.default_rng(9)
    x = rng.random((2,) + shape + (3,)).astype(np.float32)
    want = np.asarray(jresize.masked_linear_resize(jnp.asarray(x), 64, shape[0], shape[1]))
    got = tresize.masked_linear_resize(_t(x), 64).numpy()
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_kmeans_codebook_sklearn_round_trip():
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(10)
    cb = tcb.KMeansCodebook(rng.normal(size=(5, 12)).astype(np.float32))
    q = rng.normal(size=(40, 12)).astype(np.float32)
    back = tcb.KMeansCodebook.from_sklearn(cb.to_sklearn())
    np.testing.assert_array_equal(
        cb.to_sklearn().predict(q), t_nearest_centroid(_t(q), back.centers).numpy()
    )
