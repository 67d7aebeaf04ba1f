"""The port's ``mesh=`` branches: ``SIFT``/``DeepConvFeature(mesh=)``, the
encoders' mesh (inherited from the extractor or assigned) with the data-
and cluster-sharded encodes, ``Pipeline`` members on a mesh, ``learn()`` on
a mesh, ``eval``'s ``mesh=`` and ``RetrievalIndex(mesh=)``, in a gloo world
of four CPU ranks, against the same calls without a mesh and, for the
index, against the JAX package's index on a mesh of four.

The ranks import this file for its ``job_*`` functions; it imports JAX only
inside fixtures. Batches of 5 images do not divide over the 4 ranks, so
each path pads and slices back.

Tolerances: the mesh paths run each rank's block through the same
single-process code, so extractors and data-sharded encodes agree to
float32 rounding (1e-5), the cluster-sharded encodes to the JAX package's
own test tolerances (VLAD 1e-4/1e-5, FV 2e-4/1e-5), index ids exactly in
order, ties included, and scores to 1e-6.
"""
import numpy as np
import pytest
import torch

from pyvisim_tpu_torch.parallel.local import LocalWorld

N_RANKS = 4
_MESHES = {}


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------
def _mesh(kind="data"):
    from pyvisim_tpu_torch.parallel import make_mesh

    if kind not in _MESHES:
        if kind == "data":
            _MESHES[kind] = make_mesh(N_RANKS, ("data",), device_type="cpu")
        else:
            _MESHES[kind] = make_mesh(N_RANKS, ("data", "cluster"), (2, 2), device_type="cpu")
    return _MESHES[kind]


def _sift(mesh=None):
    from pyvisim_tpu_torch.features import SIFT

    return SIFT(process_size=128, max_keypoints=64, device="cpu", mesh=mesh)


def job_extractors(imgs, u):
    from pyvisim_tpu_torch.features import SIFT, DeepConvFeature

    mesh = _mesh()
    d, m = SIFT(process_size=128, max_keypoints=128, mesh=mesh).extract_batch(imgs)
    deep = DeepConvFeature(image_size=32, spatial_encoding=False, mesh=mesh)
    f = deep.extract_batch(u)[0]
    f_tensor = deep.extract_batch(torch.from_numpy(u))[0]
    r = deep.extract_batch(imgs)[0]
    return (d, m, f.numpy(), f_tensor.numpy(), r.numpy(), str(deep.device))


def job_vlad(centers, imgs, kind, where):
    """A VLADEncoder on SIFT whose mesh sits on the extractor or on the
    encoder."""
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.ops import KMeansCodebook

    mesh = _mesh(kind)
    enc = VLADEncoder(feature_extractor=_sift(mesh if where == "extractor" else None),
                      kmeans_model=KMeansCodebook(centers=centers))
    if where == "encoder":
        enc.mesh = mesh
    return enc.encode(imgs), enc.mesh is mesh


def job_encode_gathers(centers, imgs, kind):
    """A VLADEncoder on its extractor's mesh, and the shapes of every
    all-gather of its encode."""
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.ops import KMeansCodebook
    from pyvisim_tpu_torch.parallel import _collectives, sharded

    ext = (_sift(_mesh()) if kind == "sift"
           else DeepConvFeature(image_size=32, spatial_encoding=False, mesh=_mesh()))
    enc = VLADEncoder(feature_extractor=ext, kmeans_model=KMeansCodebook(centers))
    shapes, saved = [], _collectives.all_gather

    def recording(t, *args, **kwargs):
        shapes.append(tuple(t.shape))
        return saved(t, *args, **kwargs)

    _collectives.all_gather = sharded.all_gather = recording
    try:
        return enc.encode(imgs), shapes
    finally:
        _collectives.all_gather = sharded.all_gather = saved


def job_pipeline(centers, imgs):
    from pyvisim_tpu_torch.encoders import Pipeline, VLADEncoder
    from pyvisim_tpu_torch.ops import KMeansCodebook

    enc = VLADEncoder(feature_extractor=_sift(_mesh()), kmeans_model=KMeansCodebook(centers))
    return Pipeline([enc]).encode(imgs)


def job_pipeline_mixed(centers, gmm, imgs):
    """One member with a mesh of its own, one without, sharing one
    extractor."""
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder, Pipeline, VLADEncoder
    from pyvisim_tpu_torch.ops import GmmCodebook, KMeansCodebook

    ext = _sift()
    e1 = VLADEncoder(feature_extractor=ext, kmeans_model=KMeansCodebook(centers))
    e2 = FisherVectorEncoder(feature_extractor=ext, gmm_model=GmmCodebook(*gmm))
    e1.mesh = _mesh()
    return Pipeline([e1, e2]).encode(imgs), np.hstack([e1.encode(imgs), e2.encode(imgs)])


def _flat_extractor(d_in):
    from pyvisim_tpu_torch.features import Lambda

    return Lambda(lambda im: im.reshape(-1, d_in)[:48].astype(np.float32), output_dim=d_in)


def job_fisher_cluster(pca, gmm, imgs, flatten):
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder
    from pyvisim_tpu_torch.ops import GmmCodebook, PcaProjector

    enc = FisherVectorEncoder(feature_extractor=_flat_extractor(pca[0].shape[0]),
                              gmm_model=GmmCodebook(*gmm),
                              pca=PcaProjector(mean=pca[0], components=pca[1]), flatten=flatten,
                              device="cpu")
    enc.mesh = _mesh("dc")
    return enc.encode(imgs)


def _blob_lambda(centers, noise=0.1):
    from pyvisim_tpu_torch.features import Lambda

    k, d = centers.shape

    def fn(image):
        r = np.random.default_rng(int(image.sum()) % 2**31)
        lab = r.integers(0, k, size=40)
        return (centers[lab] + r.normal(scale=noise, size=(40, d))).astype(np.float32)

    return Lambda(fn, output_dim=d)


def job_learn(kind, centers, imgs, kwargs):
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder, VLADEncoder

    cls = VLADEncoder if kind == "vlad" else FisherVectorEncoder
    enc = cls(feature_extractor=_blob_lambda(centers), device="cpu")
    enc.mesh = _mesh()
    enc.learn(imgs, **kwargs)
    model = enc.clustering_model
    vocab = model.centers if kind == "vlad" else model.means
    n_pca = None if enc.pca is None else enc.pca.n_components
    return vocab.numpy(), n_pca, enc.encode(imgs[:3])


class _Rows:
    """An encoder whose encodings are the images' pixels, flattened."""

    def encode(self, images):
        return np.stack([np.asarray(i, np.float32).ravel() for i in images])


def job_eval(queries, query_labels, gallery, gallery_labels):
    from pyvisim_tpu_torch import eval as teval

    enc = _Rows()
    paths = [f"/g/{i}.jpg" for i in range(len(gallery))]
    emap = dict(zip(paths, gallery))
    plabels = dict(zip(paths, gallery_labels))
    out = {}
    for name, mesh in (("plain", None), ("mesh", _mesh())):
        kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
        out[name] = (
            teval.top_k_map(queries, query_labels, emap, plabels, enc, k=5, **kw),
            teval.top_k_accuracy(queries, query_labels, emap, plabels, enc, k=3, **kw),
            teval.retrieve_top_k_similar(queries[0], emap, enc, k=4, **kw),
        )
    return out


def job_index(gallery, more, queries, kwargs, proj):
    """A mesh index and an unsharded one through build, queries, add (across
    a capacity growth and within capacity) and save/load(mesh=)."""
    import tempfile

    from pyvisim_tpu_torch import index as tindex

    if proj is not None:
        saved = tindex._jl_projection
        tindex._jl_projection = lambda d, s: torch.from_numpy(proj)
    mesh = _mesh()
    try:
        paths = [f"/g/{i}.jpg" for i in range(len(gallery))]
        sharded = tindex.RetrievalIndex(gallery, paths, mesh=mesh, **kwargs)
        single = tindex.RetrievalIndex(gallery, paths, device="cpu", **kwargs)
        answers = []

        def ask(tag):
            for q in (queries[:1], queries):
                answers.append((tag, sharded.query_vectors(q, 5), single.query_vectors(q, 5)))

        ask("build")
        cap0 = sharded.vectors.shape[0]
        for rows in (more[:5], more[5:]):  # past the capacity of 32, then within 64
            new_paths = [f"/m/{len(sharded) + i}.jpg" for i in range(len(rows))]
            sharded.add(rows, new_paths)
            single.add(rows, new_paths)
            ask(f"add{len(sharded)}")
        with tempfile.TemporaryDirectory() as tmp:
            import torch.distributed as dist

            # Rank 0's file: rank 0 writes it, every rank reads it back.
            path = f"{tmp}/index.npz"
            files = [None] * dist.get_world_size()
            dist.all_gather_object(files, path)
            sharded.save(files[0])
            back = tindex.RetrievalIndex.load(files[0], mesh=mesh)
            answers.append(("load", back.query_vectors(queries, 5), single.query_vectors(queries, 5)))
            dist.barrier()
        return answers, (cap0, sharded.vectors.shape[0], len(sharded))
    finally:
        if proj is not None:
            tindex._jl_projection = saved


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
    elif isinstance(a, (np.ndarray, float, int, bool, str)) or a is None:
        np.testing.assert_array_equal(a, b)


def run(world, job, *args):
    """``job(*args)`` on every rank; every rank's result equal; rank 0's."""
    out = world.run(job, *args)
    for other in out[1:]:
        _same(other, out[0])
    return out[0]


def _images(rng, n, shapes=((90, 100),)):
    return [(rng.random((*shapes[i % len(shapes)], 3)) * 255).astype(np.uint8)
            for i in range(n)]


def _gmm(rng, k, d):
    w = rng.random(k).astype(np.float32) + 0.1
    return (w / w.sum(), rng.normal(size=(k, d)).astype(np.float32),
            (0.5 + rng.random((k, d))).astype(np.float32))


def test_mesh_aware_feature_extractors(world, rng):
    """SIFT(mesh=) and DeepConvFeature(mesh=) split extract_batch over
    'data' (5 images: padded) with the single-process extractors' results,
    the extractor's device being the mesh's."""
    from pyvisim_tpu_torch.features import SIFT, DeepConvFeature

    imgs = [(rng.random((80, 90, 3)) * 255).astype(np.uint8) for _ in range(5)]
    u = np.stack([(rng.random((32, 32, 3)) * 255).astype(np.uint8) for _ in range(6)])
    d1, m1, f1, f1_tensor, r1, device = run(world, job_extractors, imgs, u)
    assert device == "cpu"
    d0, m0 = SIFT(process_size=128, max_keypoints=128, device="cpu").extract_batch(imgs)
    np.testing.assert_array_equal(m0, m1)
    np.testing.assert_allclose(d0, d1, atol=1e-4)
    plain = DeepConvFeature(image_size=32, spatial_encoding=False, device="cpu")
    f0 = plain.extract_batch(u)[0].numpy()
    np.testing.assert_allclose(f1, f0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f1_tensor, f0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r1, plain.extract_batch(imgs)[0].numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def sift_vlad(rng_module):
    """Centers and 5 images, and the single-process VLAD encodings."""
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.ops import KMeansCodebook

    centers = rng_module.normal(size=(16, 128)).astype(np.float32)
    imgs = _images(rng_module, 5)
    want = VLADEncoder(feature_extractor=_sift(), kmeans_model=KMeansCodebook(centers)).encode(imgs)
    return centers, imgs, want


@pytest.fixture(scope="module")
def rng_module():
    return np.random.default_rng(11)


def test_encoder_inherits_extractor_mesh(world, sift_vlad):
    centers, imgs, want = sift_vlad
    got, inherited = run(world, job_vlad, centers, imgs, "data", "extractor")
    assert inherited
    assert got.shape == want.shape == (5, 16 * 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["sift", "deep"])
def test_encoder_on_extractor_mesh_gathers_encodings_only(world, rng, kind):
    """On its extractor's own mesh, an encode extracts and encodes each
    rank's block of the 5 images where it is: the one all-gather is of the
    encodings, a block of 2 rows per rank, and the result is the
    single-process encode's."""
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.ops import KMeansCodebook

    d = 128 if kind == "sift" else 512
    centers = rng.normal(size=(8, d)).astype(np.float32)
    imgs = _images(rng, 5)
    got, shapes = run(world, job_encode_gathers, centers, imgs, kind)
    ext = (_sift() if kind == "sift"
           else DeepConvFeature(image_size=32, spatial_encoding=False, device="cpu"))
    want = VLADEncoder(feature_extractor=ext, kmeans_model=KMeansCodebook(centers)).encode(imgs)
    assert shapes == [(2, 8 * d)]
    assert got.shape == want.shape == (5, 8 * d)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pipeline_with_mesh_extractor_non_divisible_batch(world, sift_vlad):
    centers, imgs, want = sift_vlad
    got = run(world, job_pipeline, centers, imgs)
    assert got.shape == (5, 16 * 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_vlad_encoder_on_cluster_mesh_matches_replicated(world, sift_vlad):
    """An assigned ('data', 'cluster') mesh dispatches encode() to the
    cluster-sharded VLAD."""
    centers, imgs, want = sift_vlad
    got, assigned = run(world, job_vlad, centers, imgs, "dc", "encoder")
    assert assigned
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_encoder_inherits_cluster_mesh_from_extractor(world, sift_vlad):
    centers, imgs, want = sift_vlad
    got, inherited = run(world, job_vlad, centers, imgs, "dc", "extractor")
    assert inherited
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("flatten", [True, False])
def test_fisher_encoder_on_cluster_mesh_with_pca(world, rng, flatten):
    """The cluster-sharded FV through the public API, PCA ahead of it."""
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder
    from pyvisim_tpu_torch.ops import GmmCodebook, PcaProjector

    k, d_in, d = 8, 16, 8
    comps = np.linalg.qr(rng.normal(size=(d_in, d_in)))[0][:d].astype(np.float32)
    pca = (rng.normal(size=(d_in,)).astype(np.float32), comps)
    gmm = _gmm(rng, k, d)
    imgs = [np.clip((rng.random((16, 16, 3)) * 2 - 1) * 100 + 120, 0, 255).astype(np.uint8)
            for _ in range(3)]
    got = run(world, job_fisher_cluster, pca, gmm, imgs, flatten)
    want = FisherVectorEncoder(feature_extractor=_flat_extractor(d_in),
                               gmm_model=GmmCodebook(*gmm),
                               pca=PcaProjector(mean=pca[0], components=pca[1]),
                               flatten=flatten, device="cpu").encode(imgs)
    assert got.shape == want.shape == (3, 2 * k * d + k)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_pipeline_mixed_mesh_members_share_extractor(world, rng):
    """One member with an assigned mesh, one without, sharing one extractor,
    on a ragged batch: the Pipeline equals its members run alone."""
    centers = rng.normal(size=(8, 128)).astype(np.float32)
    gmm = _gmm(rng, 4, 128)
    imgs = _images(rng, 3, ((90, 100), (80, 112), (100, 90)))
    got, want = run(world, job_pipeline_mixed, centers, gmm, imgs)
    assert got.shape == want.shape == (3, 8 * 128 + 2 * 4 * 128 + 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_learn_vlad_on_mesh_matches_single_card(world, rng):
    """learn() on a mesh fits through the distributed fitters and recovers
    the single-process vocabulary; the learned encoder encodes on the
    mesh."""
    from pyvisim_tpu_torch.encoders import VLADEncoder

    centers = rng.normal(scale=10.0, size=(4, 8)).astype(np.float32)
    imgs = [np.full((4, 4, 3), v, np.uint8) for v in range(6)]
    got, _, out = run(world, job_learn, "vlad", centers, imgs, {"n_clusters": 4})
    np.testing.assert_allclose(np.sort(got, axis=0), np.sort(centers, axis=0), atol=0.2)
    single = VLADEncoder(feature_extractor=_blob_lambda(centers), device="cpu")
    single.learn(imgs, n_clusters=4)
    want = np.sort(single.clustering_model.centers.numpy(), axis=0)
    np.testing.assert_allclose(np.sort(got, axis=0), want, atol=0.2)
    assert out.shape == (3, 4 * 8) and np.isfinite(out).all()


def test_learn_fisher_on_mesh_with_pca(world, rng):
    """learn() on a mesh covers the distributed PCA and GMM, and single-card
    kwargs are translated (max_iters) or dropped (chunk_size)."""
    centers = rng.normal(scale=8.0, size=(3, 16)).astype(np.float32)
    imgs = [np.full((4, 4, 3), v, np.uint8) for v in range(5)]
    _, n_pca, out = run(world, job_learn, "fisher", centers, imgs,
                        {"n_clusters": 3, "dim_reduction_factor": 2, "max_iters": 20,
                         "chunk_size": 1024})
    assert n_pca == 8
    assert out.shape == (3, 2 * 3 * 8 + 3) and np.isfinite(out).all()


def test_eval_on_mesh_matches_single(world, rng):
    """top_k_map, top_k_accuracy and retrieve_top_k_similar with mesh= (the
    similarity product split by query rows) equal their answers without."""
    gallery = rng.normal(size=(30, 12)).astype(np.float32)
    gallery_labels = [i % 4 for i in range(30)]
    noise = 0.05 * rng.normal(size=(7, 2, 2, 3)).astype(np.float32)
    queries = [gallery[i].reshape(2, 2, 3) + noise[i] for i in range(7)]
    out = run(world, job_eval, queries, [i % 4 for i in range(7)], gallery, gallery_labels)
    (map0, acc0, top0), (map1, acc1, top1) = out["plain"], out["mesh"]
    assert map1 == pytest.approx(map0, abs=1e-12) and acc1 == acc0
    assert [p for p, _ in top1] == [p for p, _ in top0]
    np.testing.assert_allclose([s for _, s in top1], [s for _, s in top0], rtol=1e-6)


def _index_gallery(rng):
    """30 rows (over 4 ranks: 8 a rank, the last 6) with row 3 repeated at
    rows 12 and 27, so a query of row 3 ties across three ranks; 13 rows to
    add."""
    gallery = rng.normal(size=(30, 16)).astype(np.float32)
    gallery[12] = gallery[27] = gallery[3]
    more = rng.normal(size=(13, 16)).astype(np.float32)
    more[2] = gallery[3]  # another tie, added past the capacity growth
    queries = np.concatenate([gallery[3:4], rng.normal(size=(4, 16)).astype(np.float32)])
    return gallery, more, queries


@pytest.fixture(scope="module")
def jax_projection():
    import jax
    import jax.numpy as jnp

    m = jax.random.normal(jax.random.PRNGKey(0), (16, 8), jnp.float32)
    return np.asarray(m / np.sqrt(8))


INDEX_MODES = {"f32": {}, "int8": {"quantize": "int8"},
               "screened": {"screen_dim": 8, "rerank": 12, "auto_exact": False},
               "int8_screened": {"quantize": "int8", "screen_dim": 8, "rerank": 12,
                                 "auto_exact": False}}


@pytest.mark.parametrize("mode", sorted(INDEX_MODES))
def test_retrieval_index_on_mesh(world, rng, jax_projection, mode):
    """RetrievalIndex(mesh=) against the unsharded port index and JAX's
    index on a mesh of four: the same ids in the same order, ties across
    ranks included, at Q=1 and Q=5, after build, after add() across the
    capacity growth (32 -> 64, the blocks laid out again) and within it,
    and after save/load(mesh=)."""
    from pyvisim_tpu import index as jindex
    from pyvisim_tpu import parallel as jpar

    gallery, more, queries = _index_gallery(rng)
    kwargs = INDEX_MODES[mode]
    proj = jax_projection if "screen_dim" in kwargs else None
    answers, (cap0, cap1, n) = run(world, job_index, gallery, more, queries, kwargs, proj)
    assert (cap0, cap1, n) == (8, 16, 43)  # rows per rank, before and after the growth
    for tag, (s_sh, i_sh), (s_one, i_one) in answers:
        np.testing.assert_array_equal(i_sh, i_one, err_msg=tag)
        np.testing.assert_allclose(s_sh, s_one, rtol=0, atol=1e-6, err_msg=tag)
    # the tie of row 3 in lax.top_k's order
    _, (_, ties), _ = answers[0]
    np.testing.assert_array_equal(ties[0, :3], [3, 12, 27])

    jmesh = jpar.make_mesh(N_RANKS, ("data",))
    paths = [f"/g/{i}.jpg" for i in range(30)]
    j = jindex.RetrievalIndex(gallery, paths, mesh=jmesh, **kwargs)
    build = [a for a in answers if a[0] == "build"]
    for (_, (s_sh, i_sh), _), q in zip(build, (queries[:1], queries)):
        js, ji = j.query_vectors(q, 5)
        np.testing.assert_array_equal(i_sh, ji)
        np.testing.assert_allclose(s_sh, js, rtol=0, atol=1e-6)
    for rows in (more[:5], more[5:]):
        j.add(rows, [f"/m/{len(j) + i}.jpg" for i in range(len(rows))])
    _, (s_sh, i_sh), _ = [a for a in answers if a[0] == "add43"][1]
    js, ji = j.query_vectors(queries, 5)
    np.testing.assert_array_equal(i_sh, ji)
    np.testing.assert_allclose(s_sh, js, rtol=0, atol=1e-6)
