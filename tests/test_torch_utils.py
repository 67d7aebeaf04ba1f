"""The port's ``_utils`` against the JAX package's, on the CPU: clustering
evaluation, persistence in both directions between the stacks, blur,
soft dice, statistics, plots, helpers, ``models.init_params`` and
``_config.cache_dir``.

Tolerances: cluster labels at ARI >= 0.99 against JAX's (the stacks seed
K-Means differently, so labels are not compared one by one); the scores
within 1e-9 of scikit-learn's; arrays that cross between the stacks bit
for bit; the blur within 1e-5 in float32 and 1 in uint8; soft dice to rel
1e-6; ``init_params``'s kernel stds within 10 % of JAX's draws.
"""
import jax
import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_mutual_info_score, adjusted_rand_score, rand_score

from pyvisim_tpu import _utils as J
from pyvisim_tpu.ops import codebooks as jcb
from pyvisim_tpu_torch import _utils as U
from pyvisim_tpu_torch._errors import InvalidImageError
from pyvisim_tpu_torch.ops import codebooks as tcb


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _blobs(seed, n, k, d=6):
    """k blobs of unit spread whose centers lie at least 10 sigma apart."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=10.0, size=(k, d))
    while min(np.linalg.norm(centers[i] - centers[j])
              for i in range(k) for j in range(i)) < 10.0:
        centers = rng.normal(scale=10.0, size=(k, d))
    labels = rng.integers(0, k, size=n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32), labels


@pytest.mark.parametrize("method", ["kmeans", "spectral"])
def test_cluster_labels_agree_with_jax(method):
    x, truth = _blobs(0, 150, 3)
    want = J.cluster_and_return_labels(x, method=method, n_clusters=3)
    got = U.cluster_and_return_labels(x, method=method, n_clusters=3, device="cpu")
    assert got.shape == (150,) and got.dtype == np.int32
    assert adjusted_rand_score(want, got) >= 0.99
    stats = U.cluster_images_and_generate_statistics(x, truth, 3, method=method, device="cpu")
    assert stats["ari"] >= 0.99 and stats["ri"] >= 0.99 and stats["nmi"] >= 0.95


def test_cluster_and_return_labels_dbscan_and_refusals():
    x, _ = _blobs(1, 60, 2)
    labels = U.cluster_and_return_labels(x, method="dbscan", eps=3.0, min_samples=3)
    np.testing.assert_array_equal(labels, J.cluster_and_return_labels(
        x, method="dbscan", eps=3.0, min_samples=3))
    for method in ("kmeans", "spectral"):
        with pytest.raises(ValueError, match="n_clusters must be specified"):
            U.cluster_and_return_labels(x, method=method, device="cpu")
    with pytest.raises(ValueError, match="Unknown method"):
        U.cluster_and_return_labels(x, method="banana", n_clusters=2, device="cpu")


def _score_cases():
    rng = np.random.default_rng(7)
    truth = np.repeat(np.arange(102), 61)[:6149]
    noisy = np.where(rng.random(6149) < 0.6, truth, rng.integers(0, 102, 6149))
    return {
        "flowers_102x102_random": (truth, rng.permutation(truth)),
        "flowers_102x102_noisy": (truth, noisy),
        "identical": (np.arange(30) % 4, np.arange(30) % 4),
        "relabelled": (np.arange(30) % 4, (np.arange(30) % 4) * 7 - 3),
        "one_cluster": (np.arange(20) % 3, np.zeros(20, int)),
        "both_one": (np.zeros(9, int), np.zeros(9, int)),
        "singletons": (np.arange(25), rng.integers(0, 3, 25)),
        "dbscan_noise": (rng.integers(0, 4, 80), rng.integers(-1, 3, 80)),
    }


SCORE_CASES = _score_cases()


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_clustering_scores_match_sklearn(case):
    a, b = SCORE_CASES[case]
    got = U.clustering_scores(a, b)
    want = {"ri": rand_score(a, b), "ari": adjusted_rand_score(a, b),
            "nmi": adjusted_mutual_info_score(a, b)}
    assert set(got) == set(want)
    for key in want:
        assert isinstance(got[key], float)
        assert abs(got[key] - want[key]) <= 1e-9, (key, got[key], want[key])


def test_clustering_scores_refuse_mismatched_labellings():
    with pytest.raises(ValueError, match="one length"):
        U.clustering_scores(np.zeros(4, int), np.zeros(5, int))


def _hdf5_data(rng):
    return {
        "scalar_int": 3,
        "scalar_float": 2.5,
        "arr": rng.normal(size=(4, 5)).astype(np.float32),
        "tensor": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "strings": ["a", "bc"],
        "nested": {"x": np.arange(3), "s": "hello", "deeper": {"y": np.ones(2, np.float64)}},
    }


def _check_hdf5(back, data):
    assert back["scalar_int"] == 3 and back["scalar_float"] == 2.5
    np.testing.assert_array_equal(back["arr"], data["arr"])
    np.testing.assert_array_equal(back["tensor"], data["tensor"].numpy())
    assert list(back["strings"]) == ["a", "bc"]
    np.testing.assert_array_equal(back["nested"]["x"], np.arange(3))
    assert back["nested"]["s"][0] == "hello"
    np.testing.assert_array_equal(back["nested"]["deeper"]["y"], np.ones(2))


def test_hdf5_round_trip(tmp_path, rng):
    data = _hdf5_data(rng)
    p = str(tmp_path / "t.h5")
    U.save_to_hdf5(p, data)
    _check_hdf5(U.load_hdf5(p), data)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hdf5_files_cross_between_the_stacks(tmp_path, rng, writer):
    data = _hdf5_data(rng)
    p = str(tmp_path / "t.h5")
    if writer == "jax":
        J.save_to_hdf5(p, data)
        _check_hdf5(U.load_hdf5(p), data)
    else:
        U.save_to_hdf5(p, data)
        _check_hdf5(J.load_hdf5(p), data)


def _codebooks(rng):
    d, k = 8, 4
    return {
        "kmeans": (tcb.KMeansCodebook, jcb.KMeansCodebook,
                   {"centers": rng.normal(size=(k, d)).astype(np.float32)}),
        "gmm": (tcb.GmmCodebook, jcb.GmmCodebook,
                {"weights": np.full(k, 1 / k, np.float32),
                 "means": rng.normal(size=(k, d)).astype(np.float32),
                 "covariances": rng.uniform(0.5, 2.0, (k, d)).astype(np.float32)}),
        "pca": (tcb.PcaProjector, jcb.PcaProjector,
                {"mean": rng.normal(size=d).astype(np.float32),
                 "components": rng.normal(size=(3, d)).astype(np.float32),
                 "explained_variance": rng.uniform(1, 2, 3).astype(np.float32)}),
    }


@pytest.mark.parametrize("kind", ["kmeans", "gmm", "pca"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_codebooks_cross_between_the_stacks(tmp_path, rng, kind, writer):
    tcls, jcls, arrays = _codebooks(rng)[kind]
    p = str(tmp_path / f"{kind}.npz")
    if writer == "jax":
        J.save_model(jcls(**arrays), p)
        back = U.load_model(p)
        assert isinstance(back, tcls)
        got = {k: getattr(back, k).numpy() for k in arrays}
    else:
        U.save_model(tcls(**arrays), p)
        back = J.load_model(p)
        assert isinstance(back, jcls)
        got = {k: np.asarray(getattr(back, k)) for k in arrays}
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)


def test_model_save_load_npz_and_joblib(tmp_path, rng):
    from sklearn.cluster import KMeans

    cb = tcb.KMeansCodebook(centers=rng.normal(size=(4, 8)).astype(np.float32))
    p = str(tmp_path / "cb.npz")
    U.save_model(cb, p)
    np.testing.assert_array_equal(U.load_model(p).centers.numpy(), cb.centers.numpy())
    km = KMeans(n_clusters=3, n_init=2, random_state=0).fit(
        rng.normal(size=(50, 8)).astype(np.float32))
    p2 = str(tmp_path / "km.pkl")
    U.save_model(km, p2)
    back = U.load_model(p2)
    assert isinstance(back, tcb.KMeansCodebook)
    np.testing.assert_array_equal(back.centers.numpy(), km.cluster_centers_.astype(np.float32))
    # anything else goes through joblib and comes back as it was
    p3 = str(tmp_path / "other.pkl")
    U.save_model({"a": [1, 2]}, p3)
    assert U.load_model(p3) == {"a": [1, 2]}


def test_load_sklearn_pickle_version_skew_gate(tmp_path, rng):
    import joblib
    import sklearn.base as skbase
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=3, n_init=2, random_state=0).fit(
        rng.normal(size=(50, 8)).astype(np.float32))
    p = str(tmp_path / "km.pkl")
    joblib.dump(km, p)
    assert U.load_sklearn_pickle(p).n_clusters == 3
    orig = skbase.__version__
    p2 = str(tmp_path / "km_skew.pkl")
    try:
        skbase.__version__ = "0.0.1"
        joblib.dump(km, p2)
    finally:
        skbase.__version__ = orig
    with pytest.raises(RuntimeError, match="different sklearn version"):
        U.load_sklearn_pickle(p2)
    got = U.load_sklearn_pickle(p2, allow_version_skew=True)
    np.testing.assert_allclose(got.cluster_centers_, km.cluster_centers_)
    assert isinstance(U.load_model(p2), tcb.KMeansCodebook)


def test_load_model_validates_converted_codebook(tmp_path):
    import joblib
    from sklearn.mixture import GaussianMixture

    gmm = GaussianMixture(n_components=2, covariance_type="diag")
    gmm.weights_ = np.array([0.7, 0.7])  # does not sum to 1
    gmm.means_ = np.zeros((2, 4))
    gmm.covariances_ = np.ones((2, 4))
    p = str(tmp_path / "bad_gmm.pkl")
    joblib.dump(gmm, p)
    with pytest.raises(ValueError, match="sum to 1"):
        U.load_model(p)


def test_save_json(tmp_path):
    import json

    p = tmp_path / "d.json"
    U.save_json(str(p), {"a": 1, "b": [1.5, "x"]})
    assert json.loads(p.read_text()) == {"a": 1, "b": [1.5, "x"]}


def test_standardize_and_misc(rng, tmp_path):
    x = rng.normal(size=(10, 4))
    np.testing.assert_array_equal(U.standardize_data(x, axis=0), J.standardize_data(x, axis=0))
    m = np.array([[1.0, 0.2, 0.3], [0.4, 1.0, 0.6], [0.7, 0.8, 1.0]])
    assert U.mean_below_diagonal(m) == pytest.approx(np.mean([0.4, 0.7, 0.8]))
    assert U.is_subset([1, 2], [1, 2, 3]) and not U.is_subset([1, 4], [1, 2, 3])
    with pytest.raises(ValueError, match="smaller or equal length"):
        U.is_subset([1, 2, 3], [1])
    assert U.list_is_unique([1, 2, 3]) and not U.list_is_unique([1, 1])
    assert U.convert_to_integers([(1.7, 2.2)]) == [(1, 2)]
    assert U.average(np.ones((2, 2))) == 1.0 and U.average(torch.full((2, 2), 3.0)) == 3.0
    src = [tmp_path / f"{i}.png" for i in range(2)]
    for p in src:
        p.write_bytes(b"x")
    U.copy_or_move_images([str(p) for p in src], str(tmp_path / "copied"))
    U.copy_or_move_images([str(src[0])], str(tmp_path / "moved"), operation="cut")
    assert (tmp_path / "copied" / "1.png").exists() and (tmp_path / "moved" / "0.png").exists()
    assert not src[0].exists() and src[1].exists()
    with pytest.raises(ValueError, match="Invalid operation"):
        U.copy_or_move_images([str(src[1])], str(tmp_path / "x"), operation="paste")


def test_cosine_similarity_shapes(rng):
    x = rng.normal(size=(64,)).astype(np.float32)
    y = rng.normal(size=(3, 64)).astype(np.float32)
    out = U.cosine_similarity(x, y, device="cpu")
    assert out.shape == (1, 3)
    np.testing.assert_allclose(out, J.cosine_similarity(x, y), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match=">= 2 features"):
        U.cosine_similarity(np.ones((3, 1)), np.ones((3, 1)), device="cpu")


@pytest.mark.parametrize("case", ["float_hwc", "uint8_hwc", "chw_tensor"])
def test_gaussian_blur_matches_jax(rng, case):
    if case == "uint8_hwc":
        img = (rng.random((32, 30, 3)) * 255).astype(np.uint8)
    elif case == "float_hwc":
        img = (rng.random((32, 30, 3)) * 255).astype(np.float32)
    else:
        img = torch.from_numpy(rng.random((3, 20, 24)).astype(np.float32))
    want = J.gaussian_blur(img, sigma=1.5)
    got = U.gaussian_blur(img, sigma=1.5, device="cpu")
    assert got.shape == want.shape and got.dtype == want.dtype
    if case == "uint8_hwc":
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    if case == "chw_tensor":
        assert got.min() >= 0.0 and got.max() <= 1.0


def test_gaussian_blur_kernel_size_window_and_image_check(rng):
    img = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
    with pytest.raises(ValueError, match="outside the supported"):
        U.gaussian_blur(img, kernel_size=3, sigma=2.0, device="cpu")
    assert U.gaussian_blur(img, kernel_size=9, sigma=1.0, device="cpu").shape == img.shape
    with pytest.raises(InvalidImageError):
        U.gaussian_blur(np.full((4, 4, 3), 300.0), device="cpu")


def test_validation_rejects_bad_images():
    with pytest.raises(InvalidImageError):
        U.is_numpy_image(np.zeros((4, 4, 4)), 0)
    with pytest.raises(InvalidImageError):
        U.is_numpy_image(np.full((4, 4, 3), 300.0), 0)
    with pytest.raises(InvalidImageError):
        U.is_torch_image(torch.full((3, 4, 4), 2.0), 0)


@pytest.mark.parametrize("dims", [None, (1, 2)])
def test_soft_dice_score_matches_jax(rng, dims):
    a = rng.random((2, 3, 4)).astype(np.float32)
    b = rng.random((2, 3, 4)).astype(np.float32)
    want = np.asarray(J.soft_dice_score(a, b, smooth=0.5, dims=dims))
    got = U.soft_dice_score(a, b, smooth=0.5, dims=dims, device="cpu")
    assert torch.is_tensor(got)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    ones = np.ones((2, 3, 4), np.float32)
    assert float(U.soft_dice_score(ones, ones, device="cpu")) == pytest.approx(1.0)
    assert float(U.soft_dice_score(ones, 0 * ones, device="cpu")) == pytest.approx(0.0)
    with pytest.raises(ValueError, match="one shape"):
        U.soft_dice_score(ones, ones[0], device="cpu")


def test_statistics_match_jax(rng):
    x = rng.random(200)
    y = 0.5 * x + rng.normal(scale=0.05, size=200)
    for deg in (1, 2):
        got, want = U.fit_regression_line(x, y, deg), J.fit_regression_line(x, y, deg)
        np.testing.assert_array_equal(got.coefficients, want.coefficients)
        assert got.intercept == want.intercept and got.mse == want.mse
    assert vars(U.get_statistics(x, y)) == vars(J.get_statistics(x, y))


def test_plots_write_files(tmp_path, rng):
    import matplotlib

    matplotlib.use("Agg")
    m = rng.random((4, 4))
    U.plot_and_save_heatmap(m, show=False, save_fig_path=str(tmp_path / "h.png"))
    U.plot_and_save_barplot({"a": [1.0, 2.0], "b": [2.0, 3.0]}, ["x", "y"], show=False,
                            save_path=str(tmp_path / "b.png"))
    U.plot_and_save_lineplot(rng.random(30), show=False, save_path=str(tmp_path / "l.png"))
    U.plot_and_save_histogram(rng.random(100), show=False, save_path=str(tmp_path / "hist.png"))
    x = rng.random(200)
    y = 0.5 * x + rng.normal(scale=0.05, size=200)
    res = U.plot_boxplot_with_regression(x, y, show=False, save_fig_path=str(tmp_path / "box.png"),
                                         return_results=True)
    assert res["overall_statistics"].pearson > 0.9
    assert res["regression_result"].coefficients[1] == pytest.approx(0.5, abs=0.1)
    U.plot_scatter_with_regression(x, y, show=False, save_fig_path=str(tmp_path / "sc.png"))
    for f in ["h.png", "b.png", "l.png", "hist.png", "box.png", "sc.png"]:
        assert (tmp_path / f).exists()
    with pytest.raises(ValueError, match="same length"):
        U.plot_and_save_barplot({"a": [1.0]}, ["x", "y"], show=False)


def test_init_params_matches_jax_tree():
    """Names, shapes and dtypes as JAX's ``init_params`` carried through
    ``params_from_jax``; each kernel's std within 10 % of JAX's draw."""
    from pyvisim_tpu.models import vgg as jvgg
    from pyvisim_tpu_torch import models
    from pyvisim_tpu_torch.models import vgg as tvgg

    jtree = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda: jvgg.init_params("vgg16", image_size=32))())
    want = tvgg.params_from_jax(jtree, "vgg16")
    got = models.init_params("vgg16")
    assert models.init_params is tvgg.init_params
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype == torch.float32
        if name.endswith(".weight"):
            ratio = float(got[name].std() / w.std())
            assert 0.9 <= ratio <= 1.1, (name, ratio)
        else:
            assert not got[name].any() and not w.any()
    again = models.init_params("vgg16", seed=0, image_size=64, dtype=torch.bfloat16)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["features.0.weight"], models.init_params(seed=1)["features.0.weight"])
    model = tvgg.VGGConvFeatures("vgg16", 3)
    model.load_params(models.init_params("vgg16", 3, seed=5))


def test_cache_dir_follows_its_variable_or_the_jax_default(monkeypatch, tmp_path):
    from pyvisim_tpu import _config as jconfig
    from pyvisim_tpu_torch import _config as tconfig

    monkeypatch.setenv("PYVISIM_TPU_TORCH_CACHE_DIR", str(tmp_path))
    assert tconfig.cache_dir() == tmp_path
    monkeypatch.delenv("PYVISIM_TPU_TORCH_CACHE_DIR")
    monkeypatch.delenv("PYVISIM_TPU_CACHE_DIR", raising=False)
    assert tconfig.cache_dir() == jconfig.cache_dir()
