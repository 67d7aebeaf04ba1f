"""The port's spectral clustering against the JAX package's, on the CPU.

Tolerances: the kNN affinity bit for bit on data whose 11th and 12th
nearest distances (the last kept and the first dropped) differ by more
than 1e-4 in every row; the embedding's columns to 1e-4 after the sign
rule where the first ``n_components`` eigenvalues lie more than 1e-2
apart; where the graph has several components, eigenvalue 0 repeats and
only the projector ``E E^T`` of those columns is unique, held to 1e-4;
cluster labels at ARI >= 0.99 (the stacks seed K-Means differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from pyvisim_tpu.ops import spectral as jspectral
from pyvisim_tpu_torch.ops import spectral as tspectral


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(seed, n=90, d=6, k=3, spread=10.0, noise=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=spread, size=(k, d))
    labels = np.arange(n) % k
    return (centers[labels] + rng.normal(scale=noise, size=(n, d))).astype(np.float32), labels


def _margins(x, n_neighbors):
    """Each row's gap between its (n_neighbors + 1)-th and next smallest
    squared distance, relative to the larger, in float64."""
    x = x.astype(np.float64)
    d2 = np.sort(((x[:, None] - x[None]) ** 2).sum(-1), axis=1)
    kept, dropped = d2[:, n_neighbors], d2[:, n_neighbors + 1]
    return (dropped - kept) / dropped


def _rows(seed, n=64, d=8):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_neighbors", [5, 10])
def test_knn_affinity_equals_jax(seed, n_neighbors):
    x = _rows(seed)
    assert _margins(x, n_neighbors).min() > 1e-4
    want = np.asarray(jspectral.knn_affinity(jnp.asarray(x), n_neighbors))
    got = tspectral.knn_affinity(torch.from_numpy(x), n_neighbors)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_affinity_with_a_duplicated_row_equals_jax():
    x = _rows(3)
    x[17] = x[5]
    want = np.asarray(jspectral.knn_affinity(jnp.asarray(x), 10))
    got = tspectral.knn_affinity(torch.from_numpy(x), 10).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[5, 17] == got[17, 5] == 1.0


def test_knn_affinity_keeps_the_diagonal_where_duplicates_crowd_out_self():
    """Thirteen copies of one row: each copy's 11 nearest are copies, and
    may not include itself; the diagonal is 1 all the same."""
    x = _rows(4, n=40)
    x[:13] = x[0]
    a = tspectral.knn_affinity(torch.from_numpy(x), 10)
    assert torch.equal(a, a.T)
    assert set(torch.unique(a).tolist()) <= {0.0, 0.5, 1.0}
    assert bool((a.diagonal() == 1.0).all())
    assert bool(((a > 0).sum(dim=1) >= 11).all())


def _cloud(seed, n=48):
    """An anisotropic Gaussian cloud: one connected kNN graph whose
    smallest eigenvalues lie apart."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * np.array([3.0, 1.7, 0.8])).astype(np.float32)


def _laplacian_eigenvalues(a):
    deg = a.sum(1)
    d = 1.0 / np.sqrt(deg)
    return np.linalg.eigvalsh(np.eye(len(a)) - a * d[:, None] * d[None, :])


@pytest.mark.parametrize("seed, n_components", [(0, 8), (3, 8), (5, 4)])
def test_spectral_embedding_equals_jax_on_a_connected_graph(seed, n_components):
    x = _cloud(seed)
    a = np.asarray(jspectral.knn_affinity(jnp.asarray(x), 10), np.float64)
    lam = _laplacian_eigenvalues(a)
    assert np.diff(lam[: n_components + 1]).min() > 1e-2
    want = np.asarray(jspectral.spectral_embedding(jnp.asarray(x), n_components))
    got = tspectral.spectral_embedding(torch.from_numpy(x), n_components).numpy()
    assert got.shape == (len(x), n_components)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_spectral_embedding_projector_equals_jax_on_separate_components():
    x, _ = _blobs(5, n=60, spread=50.0)
    a = np.asarray(jspectral.knn_affinity(jnp.asarray(x), 10), np.float64)
    lam = _laplacian_eigenvalues(a)
    assert lam[2] < 1e-5 and lam[3] > 1e-2  # three components
    want = np.asarray(jspectral.spectral_embedding(jnp.asarray(x), 3), np.float64)
    got = tspectral.spectral_embedding(torch.from_numpy(x), 3).numpy().astype(np.float64)
    np.testing.assert_allclose(got @ got.T, want @ want.T, rtol=0, atol=1e-4)


def test_spectral_cluster_labels_agree_with_jax():
    x, truth = _blobs(6, n=120, k=4)
    want = np.asarray(jspectral.spectral_cluster(jnp.asarray(x), 4))
    got = tspectral.spectral_cluster(x, 4, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (120,)
    assert adjusted_rand_score(want, got.numpy()) >= 0.99
    assert adjusted_rand_score(truth, got.numpy()) >= 0.99
