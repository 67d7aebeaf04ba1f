"""The port's RetrievalIndex against the JAX package's, on the same vectors.

Tolerances: float32 scores to 1e-6 (the two stacks add a row's products
in other orders); int8 codes, int32 accumulators and top-k indices equal.
Row norms are summed in other orders by XLA and torch, so a normalised
row, and with it an int8 scale, can differ in its last bit: the
bit-for-bit checks of scales use rows whose squared norms are exact
integers, where both stacks agree exactly; on Gaussian rows scales are
held to 5e-7 relative and codes stay equal. The screened
modes take the JAX package's JL matrix (``_jl_projection`` patched), since
torch cannot draw ``jax.random``'s numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvisim_tpu import index as jindex
from pyvisim_tpu.datasets import synthetic as jsyn
from pyvisim_tpu.encoders import VLADEncoder as JVLADEncoder
from pyvisim_tpu.features import Lambda as JLambda
from pyvisim_tpu.ops.codebooks import KMeansCodebook as JKMeansCodebook
from pyvisim_tpu_torch import index as tindex
from pyvisim_tpu_torch.datasets import synthetic as tsyn
from pyvisim_tpu_torch.encoders import VLADEncoder
from pyvisim_tpu_torch.features import Lambda
from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook

JIndex, TIndex = jindex.RetrievalIndex, tindex.RetrievalIndex


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_projection(monkeypatch):
    """The port's screen draws JAX's matrix."""

    def proj(d, screen_dim):
        m = jax.random.normal(jax.random.PRNGKey(0), (d, screen_dim), jnp.float32)
        return torch.from_numpy(np.asarray(m / np.sqrt(screen_dim)))

    monkeypatch.setattr(tindex, "_jl_projection", proj)


def _gallery(n=30, d=16, seed=42):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    return vecs, [f"/g/{i}.jpg" for i in range(n)], [i % 3 for i in range(n)]


def _queries(q, d, seed=7):
    return np.random.default_rng(seed).normal(size=(q, d)).astype(np.float32)


def _both(vecs, paths, labels=None, **kw):
    return JIndex(vecs, paths, labels, **kw), TIndex(vecs, paths, labels, device="cpu", **kw)


def _same_answers(j, t, q, k, atol=1e-6):
    js, ji = j.query_vectors(q, k)
    ts, ti = t.query_vectors(q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=atol)
    return ts, ti


@pytest.mark.parametrize("n, d, q", [(30, 16, 5), (100, 64, 1), (257, 40, 9)])
def test_exact_f32_matches_jax(n, d, q):
    vecs, paths, labels = _gallery(n, d)
    j, t = _both(vecs, paths, labels)
    assert len(t) == n and t.vectors.shape[0] == j.vectors.shape[0]
    np.testing.assert_allclose(t.vectors[:n].numpy(), np.asarray(j.vectors)[:n], atol=1e-7)
    _same_answers(j, t, _queries(q, d), k=5)


def _integer_rows(n, d, seed=3):
    """Rows of small integers: each squared norm is an exact integer, so
    both stacks normalise them to the same bits."""
    return np.random.default_rng(seed).integers(-9, 10, size=(n, d)).astype(np.float32)


def test_int8_codes_scales_and_accumulators_bit_for_bit():
    vecs = _integer_rows(37, 24)
    paths = [str(i) for i in range(37)]
    j, t = _both(vecs, paths, quantize="int8")
    assert t.vectors.dtype == torch.int8
    np.testing.assert_array_equal(t.vectors[:37].numpy(), np.asarray(j.vectors)[:37])
    np.testing.assert_array_equal(t.scales[:37].numpy(), np.asarray(j.scales)[:37])
    # The quantiser itself on the same rows, and the query's int32 sums.
    x = np.array(jindex._normalize_rows(jnp.asarray(_queries(6, 24))))
    jc, js = jindex._quantize_rows(jnp.asarray(x))
    tc, ts = tindex._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    g8 = np.asarray(j.vectors)[:37]
    want = np.asarray(jnp.dot(jc, jnp.asarray(g8).T, preferred_element_type=jnp.int32))
    got = tindex.int8_accumulators(tc, torch.from_numpy(g8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    _same_answers(j, t, _queries(6, 24), k=5)


def test_int8_on_gaussian_rows_codes_equal_scales_within_the_norms_rounding():
    """A row norm summed in another order moves by an ulp or two, and the
    scale (its max element times 1/127) with it: 5e-7 relative."""
    vecs, paths, _ = _gallery(64, 32)
    j, t = _both(vecs, paths, quantize="int8")
    np.testing.assert_array_equal(t.vectors[:64].numpy(), np.asarray(j.vectors)[:64])
    np.testing.assert_allclose(t.scales[:64].numpy(), np.asarray(j.scales)[:64], rtol=5e-7, atol=0)
    _same_answers(j, t, _queries(4, 32), k=5)


def _jax_candidates(j, q, r):
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    sims = (jnp.asarray(qn) @ j._proj) @ j._screen[: len(j)].T
    return np.asarray(jax.lax.top_k(sims, r)[1])


def _torch_candidates(t, q, r):
    qn = torch.from_numpy(q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12))
    sims = (qn @ t._proj) @ t._screen[: len(t)].T
    return tindex._top_k(sims, r)[1].numpy()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_screened_candidates_and_results_match_jax(jax_projection, quantize):
    vecs, paths, labels = _gallery(200, 48)
    kw = dict(quantize=quantize, screen_dim=12, rerank=20, auto_exact=False)
    j, t = _both(vecs, paths, labels, **kw)
    np.testing.assert_array_equal(t._proj.numpy(), np.asarray(j._proj))
    q = _queries(3, 48)
    np.testing.assert_array_equal(_torch_candidates(t, q, 20), _jax_candidates(j, q, 20))
    _same_answers(j, t, q, k=5)


def test_screened_full_rerank_equals_exact(jax_projection):
    vecs, paths, labels = _gallery()
    q = _queries(5, 16)
    exact = TIndex(vecs, paths, labels, device="cpu")
    j, t = _both(vecs, paths, labels, screen_dim=8, rerank=64, auto_exact=False)
    s0, i0 = exact.query_vectors(q, 4)
    s1, i1 = _same_answers(j, t, q, k=4)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1, s0, rtol=1e-5, atol=1e-6)


def test_auto_exact_routes_as_jax(jax_projection):
    """Q * r * 15 >= n takes the exact scan, smaller batches the screen
    (tests/test_index.py's routing test, held against JAX)."""
    rng = np.random.default_rng(42)
    gal = rng.normal(size=(2048, 32)).astype(np.float32)
    paths = [f"p{i}" for i in range(2048)]
    exact = TIndex(gal, paths, device="cpu")
    ja, ta = _both(gal, paths, screen_dim=4, rerank=8)
    pinned = TIndex(gal, paths, screen_dim=4, rerank=8, auto_exact=False, device="cpu")
    qb = rng.normal(size=(64, 32)).astype(np.float32)  # 64 * 8 * 15 >= 2048
    assert ta._route(64, 5) is None and ta._route(1, 5) == 8
    sa, ia = _same_answers(ja, ta, qb, k=5)
    se, ie = exact.query_vectors(qb, 5)
    np.testing.assert_array_equal(ia, ie)
    np.testing.assert_array_equal(sa, se)
    assert not np.array_equal(pinned.query_vectors(qb, 5)[1], ie)
    q1 = rng.normal(size=(1, 32)).astype(np.float32)
    s1, i1 = _same_answers(ja, ta, q1, k=5)
    np.testing.assert_array_equal(i1, pinned.query_vectors(q1, 5)[1])


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"},
                                {"quantize": "int8", "screen_dim": 8, "rerank": 30,
                                 "auto_exact": False}],
                         ids=["f32", "int8", "int8_screened"])
@pytest.mark.parametrize("n0", [20, 5], ids=["within_capacity", "past_doubling"])
def test_add_matches_jax_and_a_whole_build(jax_projection, kw, n0):
    vecs, paths, labels = _gallery()
    j, t = _both(vecs[:n0], paths[:n0], labels[:n0], **kw)
    cap = t.vectors.shape[0]
    j.add(vecs[n0:], paths[n0:], labels[n0:])
    t.add(vecs[n0:], paths[n0:], labels[n0:])
    assert t.vectors.shape[0] == j.vectors.shape[0] == (cap if n0 == 20 else 32)
    assert len(t) == 30 and t.paths == paths
    np.testing.assert_array_equal(t.labels, np.asarray(labels))
    q = _queries(4, 16)
    s, i = _same_answers(j, t, q, k=5)
    whole = TIndex(vecs, paths, labels, device="cpu", **kw)
    np.testing.assert_array_equal(whole.query_vectors(q, 5)[1], i)
    if kw.get("quantize"):
        np.testing.assert_array_equal(t.vectors[:30].numpy(), np.asarray(j.vectors)[:30])


def test_add_label_consistency_and_dim_mismatch_leave_the_index_as_it_was():
    vecs, paths, labels = _gallery()
    unlabelled = TIndex(vecs[:4], paths[:4], device="cpu")
    with pytest.raises(ValueError, match="labels"):
        unlabelled.add(vecs[4:6], paths[4:6], labels[4:6])
    t = TIndex(vecs[:20], paths[:20], labels[:20], device="cpu")
    q = _queries(2, 16)
    s0, i0 = t.query_vectors(q, 3)
    bad = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="feature dim"):
        t.add(bad, [f"bad{i}" for i in range(4)], labels=np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="N == len"):
        t.add(vecs[20:23], paths[20:22], labels[20:22])
    assert len(t) == 20 and len(t.paths) == 20 and len(t.labels) == 20
    s1, i1 = t.query_vectors(q, 3)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)


def test_constructor_checks_as_jax():
    vecs, paths, _ = _gallery()
    for kw, match in [({"quantize": "fp8"}, "quantize"), ({"rerank": 8}, "screen_dim"),
                      ({"screen_dim": 16}, "screen_dim")]:
        with pytest.raises(ValueError, match=match):
            JIndex(vecs, paths, **kw)
        with pytest.raises(ValueError, match=match):
            TIndex(vecs, paths, device="cpu", **kw)
    with pytest.raises(ValueError, match="N == len"):
        TIndex(vecs, paths[:-1], device="cpu")


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"},
                                {"quantize": "int8", "screen_dim": 8, "rerank": 12}],
                         ids=["f32", "int8", "int8_screened"])
def test_save_load_across_stacks(tmp_path, jax_projection, kw):
    vecs, paths, labels = _gallery()
    j, t = _both(vecs, paths, labels, **kw)
    j.save(str(tmp_path / "jax.npz"))
    t.save(str(tmp_path / "torch.npz"))
    t_from_j = TIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    j_from_t = JIndex.load(str(tmp_path / "torch.npz"))
    for a, b in ((t_from_j, j), (j_from_t, t)):
        assert a.paths == paths and a.quantize == kw.get("quantize")
        assert a.screen_dim == kw.get("screen_dim") and a.rerank == kw.get("rerank")
        np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(labels))
    if kw.get("quantize"):
        # The port's int8 reload gives back the saved codes and scales
        # exactly, from either stack's file; JAX's quantises again, which
        # keeps the codes and can move a scale by one unit in the last place.
        np.testing.assert_array_equal(t_from_j.vectors[:30].numpy(), np.asarray(j.vectors)[:30])
        np.testing.assert_array_equal(t_from_j.scales[:30].numpy(), np.asarray(j.scales)[:30])
        t_from_t = TIndex.load(str(tmp_path / "torch.npz"), device="cpu")
        np.testing.assert_array_equal(t_from_t.vectors.numpy(), t.vectors.numpy())
        np.testing.assert_array_equal(t_from_t.scales.numpy(), t.scales.numpy())
        np.testing.assert_array_equal(np.asarray(j_from_t.vectors)[:30], t.vectors[:30].numpy())
        np.testing.assert_array_max_ulp(np.asarray(j_from_t.scales)[:30], t.scales[:30].numpy(),
                                        maxulp=1)
    q = _queries(3, 16)
    _same_answers(j, t_from_j, q, k=4)
    _same_answers(j_from_t, t, q, k=4)


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"},
                                {"screen_dim": 8, "rerank": 40, "auto_exact": False},
                                {"quantize": "int8", "screen_dim": 8, "rerank": 40,
                                 "auto_exact": False}],
                         ids=["f32", "int8", "screened", "int8_screened"])
def test_ties_in_lax_top_k_order(jax_projection, kw):
    """Duplicated rows score alike; lax.top_k puts the lower index first."""
    base = _integer_rows(8, 16, seed=5)
    vecs = np.concatenate([base, base[[2, 2, 5]], base[[2]] * 2.0, base])  # 20 rows
    paths = [str(i) for i in range(len(vecs))]
    j, t = _both(vecs, paths, **kw)
    q = np.concatenate([base[[2, 5, 0]], np.zeros((1, 16), np.float32)])
    s, i = _same_answers(j, t, q, k=6)
    assert list(i[0, :5]) == [2, 8, 9, 11, 14]
    assert list(i[3]) == [0, 1, 2, 3, 4, 5]  # a zero query ties everywhere


def test_recall_on_a_clustered_gallery_equals_jax(jax_projection):
    rng = np.random.default_rng(42)
    base = rng.normal(size=(40, 4, 64)).astype(np.float32)
    gal = (base + 0.05 * rng.normal(size=base.shape)).reshape(160, 64).astype(np.float32)
    paths = [f"p{i}" for i in range(160)]
    q = (gal[::4] + 0.01 * rng.normal(size=(40, 64))).astype(np.float32)
    je, te = _both(gal, paths, quantize="int8")
    _, want = _same_answers(je, te, q, k=5)
    recalls = []
    for rerank in (5, 8, 16, 32):
        j, t = _both(gal, paths, quantize="int8", screen_dim=16, rerank=rerank,
                     auto_exact=False)
        _, i = _same_answers(j, t, q, k=5)
        recalls.append(np.mean([len(set(a) & set(b)) / 5 for a, b in zip(i, want)]))
        assert np.mean(i[:, 0] // 4 == np.arange(40)) >= 0.9  # tests/test_index.py's gate
    assert recalls == sorted(recalls), recalls


def test_int8_modes_rank_near_duplicates_as_jax_does(jax_projection):
    """Rows within the quantisation error of each other: the int8 routes can
    put a near-duplicate above the row itself, and both stacks pick the same
    one (the int8 screen rescores against dequantised rows, whose norms are
    1 only up to that error)."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(8, 512)).astype(np.float32)
    near = np.repeat(base, 16, axis=0) + 2e-2 * rng.normal(size=(128, 512))
    gal = np.concatenate([base, near.astype(np.float32)])
    paths = [str(i) for i in range(len(gal))]
    j, t = _both(gal, paths, quantize="int8", screen_dim=32, rerank=16, auto_exact=False)
    _, i = _same_answers(j, t, gal[:8], k=2)
    assert (i[:, 0] != np.arange(8)).sum() >= 6
    je, te = _both(gal, paths, quantize="int8")
    _same_answers(je, te, gal[:8], k=2)


def test_query_with_a_carried_encoder_and_from_encoding_map():
    """VLAD over a Lambda extractor with one codebook in both stacks."""

    def patches(image):
        return (np.asarray(image, np.float32).reshape(-1, 12)[:40] / 255.0).astype(np.float32)

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(10, 8, 10, 3)).astype(np.uint8)
    centers = rng.uniform(0, 1, size=(4, 12)).astype(np.float32)
    jenc = JVLADEncoder(JLambda(patches, 12), kmeans_model=JKMeansCodebook(centers))
    tenc = VLADEncoder(Lambda(patches, 12), kmeans_model=KMeansCodebook(centers), device="cpu")
    paths = [f"img{i}.png" for i in range(10)]
    jmap = dict(zip(paths, np.asarray(jenc.encode(list(images)))))
    tmap = dict(zip(paths, tenc.encode(list(images))))
    j = JIndex.from_encoding_map(jmap)
    t = TIndex.from_encoding_map(tmap, device="cpu")
    want = j.query(jenc, [images[3], images[7]], k=3)
    got = t.query(tenc, [images[3], images[7]], k=3)
    assert [p for p, _ in got[0]][0] == paths[3] and got[1][0][0] == paths[7]
    assert [[p for p, _ in row] for row in got] == [[p for p, _ in row] for row in want]
    np.testing.assert_allclose([[s for _, s in row] for row in got],
                               [[s for _, s in row] for row in want], atol=1e-5)


def test_synthetic_corpora_bit_for_bit_with_jax():
    for a, b in zip(tsyn.make_class_images(0, 3, h=96, w=120),
                    jsyn.make_class_images(0, 3, h=96, w=120)):
        np.testing.assert_array_equal(a, b)
    (ti, tl), (ji, jl) = (mod.make_retrieval_corpus(3, 2, h=96, w=120) for mod in (tsyn, jsyn))
    np.testing.assert_array_equal(np.stack(ti), np.stack(ji))
    np.testing.assert_array_equal(tl, jl)
    enc = np.random.default_rng(0).normal(size=(6, 40)).astype(np.float32)
    tg, tlab = tsyn.expand_encodings(enc, tl, 50, seed=0)
    jg, jlab = jsyn.expand_encodings(enc, jl, 50, seed=0)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tlab, jlab)
