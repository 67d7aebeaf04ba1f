"""The port's mesh paths (``pyvisim_tpu_torch.parallel``): meshes, planning,
the sharded ops and the distributed fits, in a gloo world of four CPU
ranks, against the single-process port and against the JAX package on a
mesh of the same shape (the first four of conftest's eight virtual
devices).

The world is spawned once for the file; each case runs as a job on every
rank (the module-level ``job_*`` functions, which the ranks import from
this file: it imports JAX only inside fixtures, so no rank loads it). Every
rank must return the same global result.

Tolerances: the sharded sums add the ranks' partial sums in another order
than one process does, so results agree to float32 rounding, stated in
each test; labels, SIFT masks and arg-min assignments are equal.
"""
import numpy as np
import pytest
import torch

from pyvisim_tpu_torch.ops import GmmCodebook, KMeansCodebook
from pyvisim_tpu_torch.parallel.local import LocalWorld

N_RANKS = 4
_MESHES = {}


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------
def _mesh(names=("data",), shape=None):
    """The rank's mesh of these axes (built once per world: every rank
    builds the same meshes in the same order)."""
    from pyvisim_tpu_torch.parallel import make_mesh

    key = (names, shape)
    if key not in _MESHES:
        _MESHES[key] = make_mesh(N_RANKS, names, shape, device_type="cpu")
    return _MESHES[key]


def _dc():
    return _mesh(("data", "cluster"), (2, 2))


def _np(t):
    return t.detach().cpu().numpy()


def job_cosine(x, y):
    from pyvisim_tpu_torch.parallel import sharded_cosine_similarity

    return _np(sharded_cosine_similarity(x, y, _mesh()))


def job_sharded_encode(desc, mask, centers):
    from pyvisim_tpu_torch.ops.vlad import vlad_encode_batch
    from pyvisim_tpu_torch.parallel import sharded_encode

    def core(d, m, model, pca):
        return vlad_encode_batch(d, m, model.centers)

    return _np(sharded_encode(core, desc, mask, KMeansCodebook(centers=centers), None, _mesh()))


def job_kmeans(x, k, kwargs):
    from pyvisim_tpu_torch.parallel import distributed_kmeans_fit

    history = {}
    cb, inertia = distributed_kmeans_fit(x, k, _mesh(), history=history, **kwargs)
    return _np(cb.centers), inertia, history["lloyd_inertia"]


def job_gmm(x, k, kwargs):
    from pyvisim_tpu_torch.parallel import distributed_gmm_fit

    if "init_kmeans" in kwargs:
        kwargs = dict(kwargs, init_kmeans=KMeansCodebook(centers=kwargs["init_kmeans"]))
    gmm, ll = distributed_gmm_fit(x, k, _mesh(), **kwargs)
    return _np(gmm.weights), _np(gmm.means), _np(gmm.covariances), ll


def job_pca(x, n, mask):
    from pyvisim_tpu_torch.parallel import distributed_pca_fit

    p = distributed_pca_fit(x, n, _mesh(), mask=mask)
    return _np(p.mean), _np(p.components), _np(p.explained_variance)


def job_cluster_vlad(desc, mask, centers, kwargs):
    from pyvisim_tpu_torch.parallel import cluster_sharded_vlad_encode

    return _np(cluster_sharded_vlad_encode(desc, mask, centers, _dc(), **kwargs))


def job_cluster_vlad_errors(desc, centers):
    from pyvisim_tpu_torch.parallel import cluster_sharded_vlad_encode

    errors = []
    for mesh, c in ((_mesh(), centers), (_dc(), centers[:5])):
        try:
            cluster_sharded_vlad_encode(desc, None, c, mesh)
        except ValueError as exc:
            errors.append(str(exc))
    return errors


def job_cluster_fisher(desc, mask, gmm):
    from pyvisim_tpu_torch.parallel import cluster_sharded_fisher_encode

    return _np(cluster_sharded_fisher_encode(desc, mask, GmmCodebook(*gmm), _dc()))


def job_meshes():
    import os

    import torch.distributed as dist

    from pyvisim_tpu_torch.parallel import NamedSharding, P, data_sharding, make_hybrid_mesh
    from pyvisim_tpu_torch.parallel import make_mesh
    from pyvisim_tpu_torch.parallel.mesh import axis_index

    def mesh_shape(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))

    errors = []
    for kwargs in ({"n_devices": 2}, {"shape": (3,)}):
        try:
            make_mesh(device_type="cpu", **kwargs)
        except ValueError as exc:
            errors.append(str(exc))
    collapsed = make_hybrid_mesh(("data", "cluster"), (2,), device_type="cpu")
    data_only = make_hybrid_mesh(("data",), device_type="cpu")
    os.environ["LOCAL_WORLD_SIZE"] = "2"  # two hosts of two ranks, as torchrun would say
    try:
        hosts = make_hybrid_mesh(("data", "model"), (2,), device_type="cpu")
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    rows = data_sharding(hosts, 2)
    return (dist.get_rank(), errors, mesh_shape(collapsed), mesh_shape(data_only),
            mesh_shape(hosts), axis_index(hosts, "data"), axis_index(hosts, "model"),
            [str(p) for p in rows.placements()], rows.local_slices((6, 3)),
            [str(p) for p in NamedSharding(hosts, P(None, "model")).placements()])


def job_loaded_modules():
    import sys

    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "pyvisim_tpu"))


def job_sift(grays, cfg_kw, root_sift, device_batch):
    import os

    from pyvisim_tpu_torch.ops.sift import SiftConfig
    from pyvisim_tpu_torch.parallel import sharded_sift_batch

    os.environ["PYVISIM_SIFT_DEVICE_BATCH"] = str(device_batch)
    try:
        return sharded_sift_batch(grays, _mesh(), cfg=SiftConfig(**cfg_kw), root_sift=root_sift)
    finally:
        del os.environ["PYVISIM_SIFT_DEVICE_BATCH"]


# ---------------------------------------------------------------------------
# Test side
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    w = LocalWorld(N_RANKS, "gloo", "cpu", threads=1, timeout_s=120)
    yield w
    w.close()


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _same(a[key], b[key])
    else:
        np.testing.assert_array_equal(a, b)


def run(world, job, *args):
    """``job(*args)`` on every rank; every rank's result equal; rank 0's."""
    out = world.run(job, *args)
    for other in out[1:]:
        _same(other, out[0])
    return out[0]


@pytest.fixture(scope="module")
def jax_meshes():
    from pyvisim_tpu import parallel as jpar

    return {"data": jpar.make_mesh(N_RANKS, ("data",)),
            "dc": jpar.make_mesh(N_RANKS, ("data", "cluster"), (2, 2))}


def _blobs(rng, k, d, n, scale, noise):
    centers = rng.normal(scale=scale, size=(k, d)).astype(np.float32)
    labels = rng.integers(0, k, size=n)
    return centers, (centers[labels] + rng.normal(scale=noise, size=(n, d))).astype(np.float32)


def _small_gmm(rng, k, d):
    w = rng.random(k).astype(np.float32) + 0.1
    return (w / w.sum(), rng.normal(size=(k, d)).astype(np.float32),
            (rng.random((k, d)) * 0.5 + 0.5).astype(np.float32))


def test_sharded_cosine_matches_single(world, rng):
    from pyvisim_tpu_torch.ops import cosine_similarity_matrix

    x = rng.normal(size=(19, 32)).astype(np.float32)  # Q does not divide over 4
    y = rng.normal(size=(40, 32)).astype(np.float32)
    got = run(world, job_cosine, x, y)
    want = cosine_similarity_matrix(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (19, 40)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sharded_encode_matches_single(world, rng):
    from pyvisim_tpu_torch.ops.vlad import vlad_encode

    centers = rng.normal(size=(8, 16)).astype(np.float32)
    desc = rng.normal(size=(13, 100, 16)).astype(np.float32)
    mask = np.ones((13, 100), np.float32)
    got = run(world, job_sharded_encode, desc, mask, centers)
    want = np.stack([vlad_encode(torch.from_numpy(desc[i]), None, torch.from_numpy(centers))
                     .numpy() for i in range(13)])
    assert got.shape == (13, 8 * 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_distributed_kmeans_matches_quality(world, rng):
    from pyvisim_tpu_torch.ops.kmeans import kmeans_fit

    centers, x = _blobs(rng, 4, 8, 400, 8.0, 0.2)
    got, inertia, _ = run(world, job_kmeans, x, 4, {"n_iters": 30, "seed": 0})
    _, single_inertia = kmeans_fit(x, 4, seed=0, n_init=2, device="cpu")
    assert inertia <= single_inertia * 1.05
    np.testing.assert_allclose(np.sort(got, axis=0), np.sort(centers, axis=0), atol=0.3)


def test_distributed_kmeans_matches_jax_from_the_same_seeding(world, jax_meshes, rng):
    """Margin data (K well-separated blobs), the same ``init_centers``: the
    same assignments in every step, so centers agree to float32 rounding of
    the sums (1e-5 * max|x|) and the inertia to rel 1e-5. Kernel 3's
    plain version clamps the inertia at 0 where JAX's does not; no term is
    negative here."""
    from pyvisim_tpu import parallel as jpar

    # Blobs near the origin, so that the distances' matmul form cancels
    # little; 403 rows: padding on the last rank.
    centers, x = _blobs(rng, 6, 12, 403, 3.0, 1.0)
    init = centers + rng.normal(scale=0.5, size=centers.shape).astype(np.float32)
    got, inertia, steps = run(world, job_kmeans, x, 6, {"n_iters": 8, "init_centers": init})
    want, want_inertia = jpar.distributed_kmeans_fit(x, 6, jax_meshes["data"], n_iters=8,
                                                     init_centers=init)
    np.testing.assert_allclose(got, np.asarray(want.centers), rtol=0,
                               atol=1e-5 * np.abs(x).max())
    assert inertia == pytest.approx(want_inertia, rel=1e-5)
    assert len(steps) == 1 and len(steps[0]) == 8 and steps[0][-1] == inertia


def test_distributed_kmeans_relocates_empty_clusters(world, rng):
    """A degenerate init (one center far from all data) must not pin that
    center: the empty cluster is relocated to a high-cost point."""
    true_centers = np.array([[0.0] * 8, [10.0] * 8, [20.0] * 8, [30.0] * 8], np.float32)
    x = (true_centers[rng.integers(0, 4, size=400)]
         + rng.normal(scale=0.3, size=(400, 8))).astype(np.float32)
    bad_init = np.array([[0.0] * 8, [10.0] * 8, [15.0] * 8, [1e6] * 8], np.float32)
    got, _, _ = run(world, job_kmeans, x, 4, {"n_iters": 30, "init_centers": bad_init})
    assert np.abs(got).max() < 1e3, "degenerate center was never relocated"
    np.testing.assert_allclose(np.sort(got, axis=0), np.sort(true_centers, axis=0), atol=0.5)


def test_degenerate_relocation_matches_jax(world, jax_meshes, rng):
    """The relocation pool has one candidate per rank of 'data', drawn from
    each rank's contiguous block: with JAX on a mesh of the same size the
    relocated centers and the final centers agree within 1e-5."""
    from pyvisim_tpu import parallel as jpar

    true_centers = np.array([[0.0] * 8, [10.0] * 8, [20.0] * 8, [30.0] * 8], np.float32)
    x = (true_centers[rng.integers(0, 4, size=402)]
         + rng.normal(scale=0.3, size=(402, 8))).astype(np.float32)
    bad_init = np.array([[0.0] * 8, [10.0] * 8, [15.0] * 8, [1e6] * 8], np.float32)
    for n_iters in (1, 12):
        got, _, _ = run(world, job_kmeans, x, 4, {"n_iters": n_iters, "init_centers": bad_init})
        want, _ = jpar.distributed_kmeans_fit(x, 4, jax_meshes["data"], n_iters=n_iters,
                                              init_centers=bad_init)
        np.testing.assert_allclose(got, np.asarray(want.centers), rtol=0, atol=1e-5)


def test_distributed_kmeans_n_init_picks_best(world, rng):
    x = rng.normal(size=(320, 8)).astype(np.float32)
    _, single, _ = run(world, job_kmeans, x, 6, {"n_iters": 15, "seed": 3})
    _, multi, history = run(world, job_kmeans, x, 6, {"n_iters": 15, "seed": 3, "n_init": 4})
    assert multi <= single + 1e-3
    assert len(history) == 4 and history[0][-1] == single


def test_distributed_gmm_quality(world, rng):
    centers, x = _blobs(rng, 3, 6, 300, 8.0, 0.2)
    _, means, _, ll = run(world, job_gmm, x, 3, {"n_iters": 20, "seed": 0})
    assert np.isfinite(ll)
    np.testing.assert_allclose(np.sort(means, axis=0), np.sort(centers, axis=0), atol=0.3)


def test_distributed_gmm_matches_jax_from_the_same_warm_start(world, jax_meshes, rng):
    """The same K-Means warm start and n_init=1: parameters within rel 1e-4
    and the mean log-likelihood within rel 1e-5 after 10 EM steps, on
    blobs with |mean|/std of about 4 (EM's s2/nk - mean^2 cancels; see
    ROADMAP's limits of the arithmetic)."""
    from pyvisim_tpu import parallel as jpar
    from pyvisim_tpu.ops import KMeansCodebook as JKMeans

    centers, x = _blobs(rng, 4, 6, 401, 2.0, 0.5)
    init = centers + rng.normal(scale=0.1, size=centers.shape).astype(np.float32)
    w, mu, cov, ll = run(world, job_gmm, x, 4, {"n_iters": 10, "init_kmeans": init})
    want, want_ll = jpar.distributed_gmm_fit(x, 4, jax_meshes["data"], n_iters=10,
                                             init_kmeans=JKMeans(centers=init))
    np.testing.assert_allclose(w, np.asarray(want.weights), rtol=1e-4)
    np.testing.assert_allclose(mu, np.asarray(want.means), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cov, np.asarray(want.covariances), rtol=1e-4)
    assert ll == pytest.approx(want_ll, rel=1e-5)


def test_distributed_gmm_rescues_degenerate_seed(world, rng):
    """A pathological warm start must not pin the distributed GMM: n_init
    re-seedings keep the best log-likelihood."""
    true_centers = np.array([[0.0] * 8, [10.0] * 8, [20.0] * 8, [30.0] * 8], np.float32)
    x = (true_centers[rng.integers(0, 4, size=400)]
         + rng.normal(scale=0.3, size=(400, 8))).astype(np.float32)
    *_, ll_good = run(world, job_gmm, x, 4, {"n_iters": 20, "seed": 0})
    bad_init = np.array([[0.0] * 8, [10.0] * 8, [15.0] * 8, [1e6] * 8], np.float32)
    _, means, _, ll_rescued = run(world, job_gmm, x, 4, {"n_iters": 20, "seed": 0, "n_init": 3,
                                                         "init_kmeans": bad_init})
    assert ll_rescued >= ll_good - 0.05 * abs(ll_good)
    np.testing.assert_allclose(np.sort(means, axis=0), np.sort(true_centers, axis=0), atol=0.5)


def test_gmm_large_mean_covariance_precision(world, rng):
    """Covariance as s2/nk - mean^2 must survive |mean| >> std data, on one
    process and on the mesh."""
    from pyvisim_tpu_torch.ops.gmm import gmm_fit

    tc = np.array([[0.0] * 8, [30.0] * 8], np.float32)
    x = (tc[rng.integers(0, 2, 2000)] + rng.normal(scale=0.3, size=(2000, 8))).astype(np.float32)
    g, ll = gmm_fit(x, 2, seed=0, device="cpu")
    covs = g.covariances.numpy()
    assert covs.min() > 0.05 and covs.max() < 0.2, covs
    assert -4.0 < ll < -2.0, ll
    _, _, covs_d, _ = run(world, job_gmm, x, 2, {"n_iters": 20, "seed": 0})
    assert covs_d.min() > 0.05 and covs_d.max() < 0.2, covs_d


def test_distributed_pca_matches_single_and_jax(world, jax_meshes, rng):
    """Against the port's pca_fit (centered moments on one process) and
    JAX's distributed_pca_fit (raw moments on a mesh of four): mean and
    explained variance to 1e-5 relative, components within 1e-5 (both
    stacks sign each component so that its largest loading is positive)."""
    from pyvisim_tpu import parallel as jpar
    from pyvisim_tpu_torch.ops.pca import pca_fit

    x = rng.normal(size=(203, 24)).astype(np.float32)  # N does not divide over 4
    x[:, :6] *= np.arange(6, 0, -1, dtype=np.float32) * 3.0  # a spectrum with gaps
    mask = (rng.random(203) > 0.1).astype(np.float32)
    mean, comps, var = run(world, job_pca, x, 6, mask)
    single = pca_fit(x, 6, mask=mask, device="cpu")
    np.testing.assert_allclose(mean, single.mean.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(comps, single.components.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(var, single.explained_variance.numpy(), rtol=1e-3, atol=1e-4)
    want = jpar.distributed_pca_fit(x, 6, jax_meshes["data"], mask=mask)
    np.testing.assert_allclose(mean, np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(comps, np.asarray(want.components), rtol=0, atol=1e-5)
    np.testing.assert_allclose(var, np.asarray(want.explained_variance), rtol=1e-5)


def test_cluster_sharded_vlad_matches_replicated_and_jax(world, jax_meshes, rng):
    from pyvisim_tpu import parallel as jpar
    from pyvisim_tpu_torch.ops.vlad import vlad_encode_batch

    k, d = 16, 12
    centers = rng.normal(size=(k, d)).astype(np.float32)
    desc = rng.normal(size=(5, 60, d)).astype(np.float32)  # B=5: the padding path
    mask = (rng.random((5, 60)) > 0.2).astype(np.float32)
    mask[3] = 0.0  # an all-masked image encodes to zeros on both paths
    got = run(world, job_cluster_vlad, desc, mask, centers, {})
    want = vlad_encode_batch(torch.from_numpy(desc), torch.from_numpy(mask),
                             torch.from_numpy(centers)).numpy()
    assert got.shape == want.shape == (5, k * d)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(got[3] == 0.0)
    jax_got = np.asarray(jpar.cluster_sharded_vlad_encode(desc, mask, centers, jax_meshes["dc"]))
    np.testing.assert_allclose(got, jax_got, rtol=1e-5, atol=1e-6)


def test_cluster_sharded_vlad_unflattened_and_bad_mesh(world, rng):
    centers = rng.normal(size=(8, 4)).astype(np.float32)
    desc = rng.normal(size=(2, 10, 4)).astype(np.float32)
    out = run(world, job_cluster_vlad, desc, None, centers, {"flatten": False})
    assert out.shape == (2, 8, 4)
    errors = run(world, job_cluster_vlad_errors, desc, centers)
    assert len(errors) == 2
    assert "cluster" in errors[0] and "divisible" in errors[1]


def test_cluster_sharded_vlad_carries_nan_as_jax(world, jax_meshes, rng):
    """One NaN descriptor: the dense one-hot product makes its image's
    encoding NaN on both stacks, whatever either MIN all-reduce makes of
    the NaN distance; the other images are unchanged."""
    from pyvisim_tpu import parallel as jpar

    centers = rng.normal(size=(8, 6)).astype(np.float32)
    desc = rng.normal(size=(4, 20, 6)).astype(np.float32)
    desc[2, 5, 3] = np.nan
    got = run(world, job_cluster_vlad, desc, None, centers, {})
    want = np.asarray(jpar.cluster_sharded_vlad_encode(desc, None, centers, jax_meshes["dc"]))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).all() and not np.isnan(got[[0, 1, 3]]).any()
    np.testing.assert_allclose(got[[0, 1, 3]], want[[0, 1, 3]], rtol=1e-5, atol=1e-6)


def test_cluster_sharded_fisher_matches_replicated_and_jax(world, jax_meshes, rng):
    from pyvisim_tpu import parallel as jpar
    from pyvisim_tpu.ops import GmmCodebook as JGmm
    from pyvisim_tpu_torch.ops.fisher import fisher_encode_batch

    k, d = 8, 6
    gmm = _small_gmm(rng, k, d)
    desc = rng.normal(size=(3, 40, d)).astype(np.float32)
    mask = (rng.random((3, 40)) > 0.3).astype(np.float32)
    got = run(world, job_cluster_fisher, desc, mask, gmm)
    want = fisher_encode_batch(torch.from_numpy(desc), torch.from_numpy(mask),
                               GmmCodebook(*gmm)).numpy()
    assert got.shape == want.shape == (3, 2 * k * d + k)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    jax_got = np.asarray(jpar.cluster_sharded_fisher_encode(desc, mask, JGmm(*gmm),
                                                            jax_meshes["dc"]))
    np.testing.assert_allclose(got, jax_got, rtol=2e-4, atol=1e-5)


def test_rank_processes_load_no_jax(world, jax_meshes):
    """The ranks import this file for its jobs; the JAX package stays out
    of them (the test process itself has JAX loaded by now)."""
    import sys

    assert "jax" in sys.modules
    assert run(world, job_loaded_modules) == []


def test_plan_hybrid_mesh_shapes():
    from pyvisim_tpu_torch.parallel import plan_hybrid_mesh

    # 4 hosts x 8 devices, TP=4 within a host: data = 4 hosts * 2 leftover devices
    ici, dcn = plan_hybrid_mesh(4, 8, ("data", "model"), (4,))
    assert ici == (2, 4) and dcn == (4, 1)
    ici, dcn = plan_hybrid_mesh(2, 8, ("data", "cluster"))
    assert ici == (1, 8) and dcn == (2, 1)
    ici, dcn = plan_hybrid_mesh(16, 4, ("data",))
    assert ici == (4,) and dcn == (16,)
    with pytest.raises(ValueError, match="chips"):
        plan_hybrid_mesh(2, 8, ("data", "model"), (3,))
    with pytest.raises(ValueError, match="must size"):
        plan_hybrid_mesh(2, 8, ("data", "model", "cluster"), (2,))


def test_make_mesh_and_hybrid_mesh_on_the_world(world):
    """A mesh spans the whole world (another size raises, unlike JAX's
    ``devices[:n]``); a hybrid mesh on one host collapses to a local mesh of
    the same logical shape, and over two hosts of two ranks puts 'data'
    across them."""
    out = world.run(job_meshes)
    for rank, errors, collapsed, data_only, hosts, d_idx, m_idx, rows, block, cols in out:
        assert len(errors) == 2 and "whole world" in errors[0] and "cover" in errors[1]
        assert collapsed == {"data": 2, "cluster": 2}
        assert data_only == {"data": 4}
        assert hosts == {"data": 2, "model": 2}
        assert (d_idx, m_idx) == divmod(rank, 2)  # ranks host-major
        # the shardings as DTensor placements, and the block each rank holds
        assert rows == ["S(0)", "R"] and cols == ["R", "S(1)"]
        assert block == (slice(3 * d_idx, 3 * d_idx + 3), slice(None))


def test_init_distributed_single_process_noop(monkeypatch):
    from pyvisim_tpu_torch.parallel import init_distributed

    for name in ("PYVISIM_COORDINATOR", "PYVISIM_NUM_PROCESSES", "PYVISIM_PROCESS_ID",
                 "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    monkeypatch.setenv("PYVISIM_COORDINATOR", "localhost:1")  # stray
    assert init_distributed(num_processes=1) is False


def test_pad_to_multiple():
    from pyvisim_tpu_torch.parallel import pad_to_multiple

    x = torch.arange(10.0).reshape(5, 2)
    padded, n = pad_to_multiple(x, 4)
    assert n == 5 and padded.shape == (8, 2) and torch.equal(padded[:5], x)
    assert not padded[5:].any()
    same, n = pad_to_multiple(x, 5)
    assert n == 5 and same is x
    cols, n = pad_to_multiple(np.ones((2, 3), np.float32), 2, axis=1, pad_value=-1)
    assert n == 3 and cols.shape == (2, 4) and (cols[:, 3] == -1).all()


SIFT_CFG = {"process_size": 128, "max_keypoints": 256}


def test_sharded_sift_matches_single(world, rng, monkeypatch):
    """Each rank describes its block of the images (6 images: two a rank,
    and two padding images on the last): the single-card path in calls of
    two images gives the same calls, and the same masks and descriptors
    bit for bit."""
    from pyvisim_tpu_torch.ops import sift as sift_ops

    cfg = sift_ops.SiftConfig(**SIFT_CFG)
    grays = [(rng.random((100 + 7 * i, 120)) * 255).astype(np.uint8) for i in range(6)]
    d_sh, m_sh = run(world, job_sift, grays, SIFT_CFG, False, 16)
    monkeypatch.setenv("PYVISIM_SIFT_DEVICE_BATCH", "2")
    d_ref, m_ref = sift_ops.sift_batch(grays, max_keypoints=256, cfg=cfg, run_on="cpu")
    assert d_sh.shape == d_ref.shape == (6, 256, 128)
    np.testing.assert_array_equal(m_sh, m_ref)
    np.testing.assert_array_equal(d_sh, d_ref)
    d_r, m_r = run(world, job_sift, grays[:2], SIFT_CFG, True, 16)
    valid = m_r[0] > 0.5
    norms = np.linalg.norm(d_r[0][valid], axis=1)
    assert norms.size and np.allclose(norms, 1.0, atol=1e-3)


def test_sharded_sift_overcap_chunks_match_single(world, rng, monkeypatch):
    """Over the cap (PYVISIM_SIFT_DEVICE_BATCH images per rank) the images
    go in chunks, each split over the ranks: 10 images at one per rank are
    three chunks, the last ragged, equal bit for bit to the single-card
    path in calls of one image. One chunk of 10 (three images a rank) runs
    other batches, whose float sums may round a descriptor entry to the
    next integer: within 1 unit, and exact on >= 99.9 % of entries."""
    from pyvisim_tpu_torch.ops import sift as sift_ops

    cfg = sift_ops.SiftConfig(**SIFT_CFG)
    grays = [(rng.random((90 + 5 * (i % 4), 110)) * 255).astype(np.uint8) for i in range(10)]
    d_chunks, m_chunks = run(world, job_sift, grays, SIFT_CFG, False, 1)
    d_one, m_one = run(world, job_sift, grays, SIFT_CFG, False, 16)
    monkeypatch.setenv("PYVISIM_SIFT_DEVICE_BATCH", "1")
    d_ref, m_ref = sift_ops.sift_batch(grays, max_keypoints=256, cfg=cfg, run_on="cpu")
    assert d_chunks.shape == d_one.shape == (10, 256, 128)
    np.testing.assert_array_equal(m_chunks, m_ref)
    np.testing.assert_array_equal(d_chunks, d_ref)
    np.testing.assert_array_equal(m_one, m_ref)
    diff = np.abs(d_one - d_ref)
    assert diff.max() <= 1.0 and np.mean(diff == 0) >= 0.999
