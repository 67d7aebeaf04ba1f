"""Utilities: math and similarity, clustering evaluation, persistence,
statistics and plots, and small helpers.

Port of ``pyvisim_tpu/_utils.py``, the same names and signatures. The
compute-heavy helpers (cosine similarity, K-Means and spectral clustering,
Gaussian blur, soft dice) run on ``device`` (None means CUDA) through the
port's ``ops``; the scores, persistence, statistics and plots are host
code. ``sklearn``, ``joblib``, ``h5py`` and ``matplotlib`` are imported
only by the functions that need them: the clustering scores need scipy
alone.
"""
from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import Any, Literal, Optional

import numpy as np
import torch

from ._config import get_logger, resolve_device
from ._validation import check_is_image, is_numpy_image, is_torch_image
from .ops.similarity import cosine_similarity_matrix

logger = get_logger("utils")

__all__ = [
    "is_numpy_image",
    "is_torch_image",
    "check_is_image",
    "cosine_similarity",
    "cluster_and_return_labels",
    "cluster_images_and_generate_statistics",
    "clustering_scores",
    "mean_below_diagonal",
    "soft_dice_score",
    "standardize_data",
    "save_json",
    "save_to_hdf5",
    "load_hdf5",
    "save_model",
    "load_model",
    "load_sklearn_pickle",
    "fit_regression_line",
    "get_statistics",
    "plot_and_save_heatmap",
    "plot_and_save_barplot",
    "plot_and_save_lineplot",
    "plot_and_save_histogram",
    "plot_boxplot_with_regression",
    "plot_scatter_with_regression",
    "plot_image",
    "gaussian_blur",
    "copy_or_move_images",
    "is_subset",
    "list_is_unique",
    "convert_to_integers",
    "average",
]


# ---------------------------------------------------------------------------
# Math / similarity
# ---------------------------------------------------------------------------
def cosine_similarity(x, y, device=None) -> np.ndarray:
    """Cosine similarity matrix between two batches of vectors, computed on
    ``device`` (``None`` means CUDA) and returned as numpy.

    1-D inputs are reshaped to (1, D); inputs with D <= 1 are rejected;
    numpy arrays and torch tensors are accepted.
    """
    x = _to_numpy(x)
    y = _to_numpy(y)
    x = x.reshape(1, -1) if x.ndim == 1 else x
    y = y.reshape(1, -1) if y.ndim == 1 else y
    if x.shape[-1] <= 1 or y.shape[-1] <= 1:
        raise ValueError(
            "cosine_similarity needs vectors with >= 2 features; received "
            f"feature dims x={x.shape[-1]}, y={y.shape[-1]}."
        )
    dev = resolve_device(device)
    sims = cosine_similarity_matrix(
        torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    )
    return sims.cpu().numpy()


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, np.ndarray):
        return a
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _to_tensor(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``a`` (an array or a tensor anywhere) as a ``dtype`` tensor on
    ``device``."""
    a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    return a.to(device=device, dtype=dtype)


def mean_below_diagonal(matrix: np.ndarray) -> float:
    """Mean of the elements strictly below the diagonal."""
    below = matrix[np.tril_indices_from(matrix, k=-1)]
    return float(below.mean())


def standardize_data(data: np.ndarray, axis: int = 0) -> np.ndarray:
    """(x - mean) / std along ``axis``."""
    return (data - np.mean(data, axis=axis, keepdims=True)) / np.std(
        data, axis=axis, keepdims=True
    )


def soft_dice_score(output, target, smooth: float = 0.0, eps: float = 1e-7, dims=None,
                    device=None) -> torch.Tensor:
    """Soft Dice score ``(2 |a.b| + smooth) / max(|a| + |b| + smooth, eps)``
    of two arrays or tensors of one shape, summed over ``dims`` (all when
    None), as a float32 tensor on ``device`` (None means CUDA)."""
    from .losses._losses import soft_dice_score as _soft_dice

    dev = resolve_device(device)
    output, target = _to_tensor(output, dev), _to_tensor(target, dev)
    if output.shape != target.shape:
        raise ValueError(
            f"soft_dice_score needs two arrays of one shape, got {tuple(output.shape)} "
            f"and {tuple(target.shape)}"
        )
    return _soft_dice(output, target, smooth=smooth, eps=eps, dims=dims)


def average(matrix) -> float:
    """Mean of a matrix of any supported array type."""
    return float(np.mean(_to_numpy(matrix)))


# ---------------------------------------------------------------------------
# Clustering evaluation
# ---------------------------------------------------------------------------
def cluster_and_return_labels(
    data,
    method: Literal["kmeans", "dbscan", "spectral"] = "kmeans",
    n_clusters: Optional[int] = None,
    device=None,
    **kwargs,
) -> np.ndarray:
    """Cluster ``data (N, D)`` and return integer labels ``(N,)``.

    'kmeans' fits the port's K-Means (seed 42 and 3 seedings unless
    ``seed``/``n_init`` say otherwise; further keywords go to
    :func:`~.ops.kmeans.kmeans_fit`) and labels each row by its nearest
    center; 'spectral' runs :func:`~.ops.spectral.spectral_cluster`; both
    on ``device`` (None means CUDA). 'dbscan' runs sklearn's ``DBSCAN`` on
    the host with ``kwargs``.
    """
    if method == "kmeans":
        if n_clusters is None:
            raise ValueError("n_clusters must be specified for KMeans.")
        from .ops.assign import nearest_centroid
        from .ops.kmeans import kmeans_fit

        dev = resolve_device(device)
        x = _to_tensor(data, dev)
        seed = kwargs.pop("seed", 42)
        n_init = kwargs.pop("n_init", 3)
        cb, _ = kmeans_fit(x, n_clusters, seed=seed, n_init=n_init, device=dev, **kwargs)
        return nearest_centroid(x, cb.centers).cpu().numpy()

    if method == "dbscan":
        from sklearn.cluster import DBSCAN

        return DBSCAN(**kwargs).fit_predict(_to_numpy(data))

    if method == "spectral":
        if n_clusters is None:
            raise ValueError("n_clusters must be specified for Spectral Clustering.")
        from .ops.spectral import spectral_cluster

        dev = resolve_device(device)
        seed = kwargs.pop("seed", 42)
        labels = spectral_cluster(_to_tensor(data, dev), n_clusters, seed=seed, device=dev,
                                  **kwargs)
        return labels.cpu().numpy()

    raise ValueError(f"Unknown method: {method}")


def _contingency(true_labels, cluster_labels) -> np.ndarray:
    """(classes, clusters) int64 counts of the two labellings."""
    true_labels, cluster_labels = np.asarray(true_labels), np.asarray(cluster_labels)
    if true_labels.shape != cluster_labels.shape or true_labels.ndim != 1:
        raise ValueError(
            "clustering_scores needs two 1-D labellings of one length, got "
            f"{true_labels.shape} and {cluster_labels.shape}"
        )
    _, rows = np.unique(true_labels, return_inverse=True)
    _, cols = np.unique(cluster_labels, return_inverse=True)
    table = np.zeros((rows.max(initial=-1) + 1, cols.max(initial=-1) + 1), np.int64)
    np.add.at(table, (rows.ravel(), cols.ravel()), 1)
    return table


def _pair_counts(table: np.ndarray) -> tuple[int, int, int, int]:
    """sklearn's ``pair_confusion_matrix`` as Python ints: (tn, fp, fn, tp)."""
    n = int(table.sum())
    sum_squares = int((table**2).sum())
    a, b = table.sum(axis=1), table.sum(axis=0)
    fp = int((table @ b).sum()) - sum_squares
    fn = int((table.T @ a).sum()) - sum_squares
    tp = sum_squares - n
    return n * n - fp - fn - sum_squares, fp, fn, tp


def _entropy(counts: np.ndarray) -> float:
    counts = counts[counts > 0].astype(np.float64)
    if counts.size <= 1:
        return 0.0
    total = counts.sum()
    return float(-np.sum((counts / total) * (np.log(counts) - np.log(total))))


def _mutual_info(table: np.ndarray) -> float:
    """sklearn's ``mutual_info_score`` of a contingency table."""
    a, b = table.sum(axis=1), table.sum(axis=0)
    if a.size == 1 or b.size == 1:
        return 0.0
    nzx, nzy = np.nonzero(table)
    nz = table[nzx, nzy].astype(np.float64)
    total = float(table.sum())
    p = nz / total
    outer = a[nzx].astype(np.int64) * b[nzy].astype(np.int64)
    log_outer = -np.log(outer) + np.log(a.sum()) + np.log(b.sum())
    mi = p * (np.log(nz) - np.log(total)) + p * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def _expected_mutual_info(table: np.ndarray) -> float:
    """The expected mutual information of two labellings with the table's
    class and cluster sizes under the hypergeometric model (sklearn's
    ``expected_mutual_information``), summed over every cell (i, j) and
    every n_ij in [max(1, a_i + b_j - N), min(a_i, b_j)] at once."""
    from scipy.special import gammaln

    n = int(table.sum())
    a, b = table.sum(axis=1), table.sum(axis=0)
    if a.size == 1 or b.size == 1:
        return 0.0
    ai, bj = np.meshgrid(a, b, indexing="ij")
    ai, bj = ai.ravel(), bj.ravel()
    start = np.maximum(ai + bj - n, 1)
    stop = np.minimum(ai, bj) + 1
    length = np.maximum(stop - start, 0)
    cell = np.repeat(np.arange(ai.size), length)
    nij = (np.arange(length.sum()) - np.repeat(np.cumsum(length) - length, length)
           + np.repeat(start, length)).astype(np.float64)
    ai, bj = ai[cell].astype(np.float64), bj[cell].astype(np.float64)
    term2 = np.log(n) + np.log(nij) - np.log(ai) - np.log(bj)
    gln = (gammaln(ai + 1) + gammaln(bj + 1) + gammaln(n - ai + 1) + gammaln(n - bj + 1)
           - gammaln(nij + 1) - gammaln(n + 1) - gammaln(ai - nij + 1)
           - gammaln(bj - nij + 1) - gammaln(n - ai - bj + nij + 1))
    return float(np.sum(nij / n * term2 * np.exp(gln)))


def clustering_scores(true_labels, cluster_labels) -> dict[str, float]:
    """Rand index, adjusted Rand index and, under the key ``'nmi'``, the
    *adjusted* mutual information (arithmetic mean), which is what the JAX
    package reports there; each equal to sklearn's (``rand_score``,
    ``adjusted_rand_score``, ``adjusted_mutual_info_score``), computed with
    numpy and scipy from the contingency table."""
    table = _contingency(true_labels, cluster_labels)
    tn, fp, fn, tp = _pair_counts(table)
    pairs = tn + fp + fn + tp
    ri = 1.0 if tp + tn == pairs or pairs == 0 else (tp + tn) / pairs
    if fn == 0 and fp == 0:
        ari = 1.0
    else:
        ari = 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))
    n_classes, n_clusters = table.shape
    if n_classes == n_clusters and n_classes <= 1:
        ami = 1.0
    else:
        mi, emi = _mutual_info(table), _expected_mutual_info(table)
        normalizer = 0.5 * (_entropy(table.sum(axis=1)) + _entropy(table.sum(axis=0)))
        denominator = normalizer - emi
        eps = np.finfo(np.float64).eps
        denominator = min(denominator, -eps) if denominator < 0 else max(denominator, eps)
        ami = (mi - emi) / denominator
    return {"ri": float(ri), "ari": float(ari), "nmi": float(ami)}


def cluster_images_and_generate_statistics(
    features,
    true_labels: np.ndarray,
    n_clusters: int,
    method: str = "kmeans",
    device=None,
    **kwargs,
) -> dict[str, float]:
    """Cluster ``features`` (on ``device``, None meaning CUDA) and score the
    labels against ``true_labels`` (:func:`clustering_scores`)."""
    cluster_labels = cluster_and_return_labels(
        data=features,
        method=method,
        n_clusters=n_clusters if method != "dbscan" else None,
        device=device,
        **kwargs,
    )
    return clustering_scores(true_labels, cluster_labels)


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------
def save_json(file_path: str, data: dict) -> None:
    """Save a dict as JSON."""
    with open(file_path, "w") as f:
        json.dump(data, f, indent=4)


def save_model(model, file_path: str) -> None:
    """Persist a model: a codebook (``KMeansCodebook``, ``GmmCodebook``,
    ``PcaProjector``) to the ``.npz`` format that both packages read,
    anything else through joblib."""
    from .ops.codebooks import GmmCodebook, KMeansCodebook, PcaProjector, save_codebook

    if isinstance(model, (GmmCodebook, KMeansCodebook, PcaProjector)):
        save_codebook(file_path, model)
        return
    import joblib

    with open(file_path, "wb") as f:
        joblib.dump(model, f)


def load_model(file_path: str):
    """Load what :func:`save_model` saved (by either package): an ``.npz``
    codebook as CPU tensors, or a joblib pickle, converted to a codebook
    where it holds a fitted sklearn KMeans, GaussianMixture or PCA.

    A pickle written by another sklearn version still loads, with the skew
    logged and the converted codebook checked by ``validate_codebook``;
    :func:`load_sklearn_pickle` is the strict variant."""
    if str(file_path).endswith(".npz"):
        from .ops.codebooks import load_codebook

        return load_codebook(file_path)
    obj = load_sklearn_pickle(file_path, allow_version_skew=True)
    return _maybe_convert_sklearn(obj)


def load_sklearn_pickle(file_path: str, *, allow_version_skew: bool = False):
    """joblib-load an sklearn estimator pickle, surfacing version skew.

    sklearn warns with ``InconsistentVersionWarning`` when it unpickles an
    estimator written by another release, whose attribute layout may
    differ. By default that raises; with ``allow_version_skew=True`` the
    object is returned and the skew logged (check what is taken from it,
    e.g. with ``ops.codebooks.validate_codebook``). Unpickling runs code
    from the file: load only files you trust.
    """
    import warnings

    import joblib

    try:
        from sklearn.exceptions import InconsistentVersionWarning
    except ImportError:  # an sklearn without the warning class
        InconsistentVersionWarning = ()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with open(file_path, "rb") as f:
            obj = joblib.load(f)
    skew = [w for w in caught if isinstance(w.message, InconsistentVersionWarning)]
    for w in caught:  # re-emit every other warning
        if w not in skew:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    if skew:
        detail = "; ".join(str(w.message) for w in skew)
        if not allow_version_skew:
            raise RuntimeError(
                f"Refusing to convert {file_path}: it was pickled by a "
                f"different sklearn version ({detail}). Pass "
                "allow_version_skew=True to proceed with invariant-checked extraction."
            )
        logger.warning(
            "Loaded %s across an sklearn version skew (%s); extracted arrays "
            "will be invariant-checked.",
            file_path,
            detail,
        )
    return obj


def _maybe_convert_sklearn(obj):
    from .ops.codebooks import GmmCodebook, KMeansCodebook, PcaProjector, validate_codebook

    if hasattr(obj, "cluster_centers_"):
        converted = KMeansCodebook.from_sklearn(obj)
    elif hasattr(obj, "covariances_"):
        converted = GmmCodebook.from_sklearn(obj)
    elif hasattr(obj, "components_"):
        converted = PcaProjector.from_sklearn(obj)
    else:
        return obj
    validate_codebook(converted)
    return converted


def save_to_hdf5(file_path: str, dataset_dict: dict[str, Any]) -> None:
    """Save a dict to HDF5, nested dicts as groups. Values may be ints,
    floats, numpy arrays, torch tensors, strings, bytes and lists; strings
    are stored UTF-8."""
    import h5py

    def _save(d: dict, f) -> None:
        for name, data in d.items():
            if isinstance(data, dict):
                _save(data, f.create_group(name))
                continue
            if isinstance(data, (int, float)):
                f.create_dataset(name, data=data)
                continue
            data = _to_numpy(data) if not isinstance(data, (str, bytes, list)) else data
            if isinstance(data, np.ndarray):
                if data.dtype.kind in {"U", "S"}:
                    dt = h5py.string_dtype(encoding="utf-8")
                    f.create_dataset(name, data=data.astype(dt))
                else:
                    f.create_dataset(name, data=data)
            elif isinstance(data, list):
                arr = np.array(data)
                if arr.dtype.kind in {"U", "S"}:
                    dt = h5py.string_dtype(encoding="utf-8")
                    arr = arr.astype(dt)
                f.create_dataset(name, data=arr)
            elif isinstance(data, (str, bytes)):
                dt = h5py.string_dtype(encoding="utf-8")
                f.create_dataset(name, data=np.array([data], dtype=dt))
            else:
                raise TypeError(
                    f"Unsupported data type for dataset '{name}': {type(data)}"
                )

    with h5py.File(file_path, "w") as f:
        _save(dataset_dict, f)


def load_hdf5(file_path: str) -> dict[str, Any]:
    """Load an HDF5 file into a dict, groups as nested dicts, strings as
    ``str`` arrays and scalars as numpy scalars."""
    import h5py

    def _load(f) -> dict:
        out: dict[str, Any] = {}
        for key, val in f.items():
            if isinstance(val, h5py.Group):
                out[key] = _load(val)
            else:
                if val.dtype.kind in {"U", "S"} or h5py.check_string_dtype(val.dtype):
                    out[key] = val.asstr()[...]
                elif val.shape == ():
                    out[key] = val[()]
                else:
                    out[key] = val[...]
        for k, v in f.attrs.items():
            out[k] = v
        return out

    with h5py.File(file_path, "r") as f:
        return _load(f)


# ---------------------------------------------------------------------------
# Regression / statistics helpers
# ---------------------------------------------------------------------------
@dataclass
class RegressionResult:
    predictions: np.ndarray
    coefficients: np.ndarray
    intercept: float
    mse: float


@dataclass
class Statistics:
    pearson: float
    spearman: float
    std: float
    mean: float
    median: float
    n_points: int


def fit_regression_line(x: np.ndarray, y: np.ndarray, poly_degree: int) -> RegressionResult:
    """Polynomial least-squares fit by numpy ``lstsq``, in sklearn
    ``LinearRegression``'s form (the constant split off as ``intercept``)."""
    features = np.vander(np.asarray(x, np.float64), N=poly_degree + 1, increasing=True)
    coef, *_ = np.linalg.lstsq(features, np.asarray(y, np.float64), rcond=None)
    predictions = features @ coef
    mse = float(np.mean((np.asarray(y) - predictions) ** 2))
    # sklearn convention: intercept separated, coef[0] (the constant) zeroed out
    return RegressionResult(predictions, np.r_[0.0, coef[1:]], float(coef[0]), mse)


def get_statistics(x: np.ndarray, y: np.ndarray) -> Statistics:
    """Pearson/Spearman + moments."""
    from scipy.stats import pearsonr, spearmanr

    pearson, _ = pearsonr(x, y)
    spearman, _ = spearmanr(x, y)
    return Statistics(
        float(pearson),
        float(spearman),
        float(np.std(y)),
        float(np.mean(y)),
        float(np.median(y)),
        int(len(y)),
    )


# ---------------------------------------------------------------------------
# Plotting: host code on matplotlib's object-oriented interface, imported
# lazily; the same signatures and results as the JAX package's helpers.
# ---------------------------------------------------------------------------
def _fig_axes(figsize):
    """One (fig, ax) pair per plot call; never touches pyplot global state
    beyond figure creation."""
    import matplotlib.pyplot as plt

    return plt.subplots(figsize=figsize)


def _finalize_plot(fig, ax, *, title, x_label, y_label, save, show,
                   legend=False):
    """Shared tail of every plot helper: labels, optional legend, save
    (before show, so the file exists even under non-interactive backends),
    then close to keep long-running processes leak-free."""
    import matplotlib.pyplot as plt

    ax.set_title(title)
    if x_label is not None:
        ax.set_xlabel(x_label)
    if y_label is not None:
        ax.set_ylabel(y_label)
    if legend:
        ax.legend(loc="best")
    fig.tight_layout()
    if save:
        fig.savefig(save)
    if show:
        plt.show()
    plt.close(fig)


def _stat_box(ax, lines: list[str]):
    """Stack annotation lines in the top-left corner in axes coordinates."""
    for row, text in enumerate(lines):
        ax.annotate(
            text,
            xy=(0.04, 0.96 - 0.05 * row),
            xycoords="axes fraction",
            va="top",
            bbox={"boxstyle": "round", "fc": "0.9", "alpha": 0.6},
        )


def plot_and_save_heatmap(
    matrix,
    figsize=None,
    x_tick_labels=None,
    y_tick_labels=None,
    cbar_kws=None,
    title="Heatmap",
    x_label="X Axis",
    y_label="Y Axis",
    show=True,
    save_fig_path=None,
) -> None:
    """Cell-annotated heatmap with a labeled colorbar. Rendered with
    ``imshow`` + per-cell text (no seaborn dependency)."""
    matrix = np.atleast_2d(_to_numpy(matrix))
    n_rows, n_cols = matrix.shape
    if figsize is None:
        # scale with the grid but keep tiny matrices readable
        figsize = (max(4.0, 0.6 * n_cols + 1.5), max(3.5, 0.6 * n_rows + 1.0))
    fig, ax = _fig_axes(figsize)
    im = ax.imshow(matrix, cmap="viridis", aspect="auto")
    cbar_label = (cbar_kws or {}).get("label", "value")
    fig.colorbar(im, ax=ax, label=cbar_label)

    lo, hi = float(matrix.min()), float(matrix.max())
    midpoint = lo + 0.5 * (hi - lo)
    for (r, c), val in np.ndenumerate(matrix):
        ax.text(
            c, r, format(val, ".2f"),
            ha="center", va="center",
            color="black" if val > midpoint else "white",
        )
    ax.set_xticks(range(n_cols), x_tick_labels or range(n_cols))
    ax.set_yticks(range(n_rows), y_tick_labels or range(n_rows))
    _finalize_plot(fig, ax, title=title, x_label=x_label, y_label=y_label,
                   save=save_fig_path, show=show)


def plot_and_save_barplot(
    data: dict[str, list[float]],
    bar_labels: list[str],
    title="Barplot",
    xlabel="X-axis",
    ylabel="Y-axis",
    save_path=None,
    show=True,
) -> None:
    """Grouped barplot: one x position per dict key, one bar per series."""
    n_series = len(bar_labels)
    if any(len(v) != n_series for v in data.values()):
        raise ValueError(
            "All lists in data must have the same length as the number of bar labels."
        )
    positions = np.arange(len(data))
    bar_w = 0.8 / max(n_series, 1)
    # offsets centered on each group position
    offsets = (np.arange(n_series) - (n_series - 1) / 2) * bar_w

    fig, ax = _fig_axes((10, 6))
    for s, (off, label) in enumerate(zip(offsets, bar_labels)):
        heights = [series[s] for series in data.values()]
        ax.bar(positions + off, heights, width=bar_w, label=label)
    ax.set_xticks(positions, list(data))
    ax.yaxis.grid(True, linestyle=":", alpha=0.5)
    _finalize_plot(fig, ax, title=title, x_label=xlabel, y_label=ylabel,
                   save=save_path, show=show, legend=True)


def _thin_ticks(ax, x, max_ticks=20):
    """Keep at most ``max_ticks`` evenly spaced x tick labels."""
    if len(x) <= max_ticks:
        return
    keep = np.unique(np.linspace(0, len(x) - 1, max_ticks).astype(int))
    ax.set_xticks(keep, np.asarray(x)[keep], rotation=90)


def plot_and_save_lineplot(
    y: np.ndarray,
    x: np.ndarray | None = None,
    y_lim=None,
    x_lim=None,
    save_path=None,
    sort_y=False,
    title="Lineplot",
    xlabel="x-axis",
    ylabel="y-axis",
    show=True,
) -> None:
    """Markered lineplot; x tick labels are thinned to at most 20."""
    y = _to_numpy(y)
    if sort_y:
        y = np.sort(y)
    x = np.arange(y.shape[0]) if x is None else x

    fig, ax = _fig_axes((10, 6))
    ax.plot(x, y, "o-")
    ax.grid(True, alpha=0.7)
    _thin_ticks(ax, x)
    if y_lim:
        ax.set_ylim(y_lim)
    if x_lim:
        ax.set_xlim(x_lim)
    _finalize_plot(fig, ax, title=title, x_label=xlabel, y_label=ylabel,
                   save=save_path, show=show)


def plot_and_save_histogram(
    data: np.ndarray,
    num_bins: int = 10,
    title="Histogram",
    x_label="Value",
    y_label="Frequency",
    save_path=None,
    x_lim=(0, 1),
    show=True,
) -> None:
    """Frequency histogram over ``num_bins`` bins."""
    fig, ax = _fig_axes((10, 6))
    ax.hist(_to_numpy(data), bins=num_bins, edgecolor="0.2", alpha=0.75)
    ax.yaxis.grid(True, linestyle=":", alpha=0.5)
    if x_lim:
        ax.set_xlim(x_lim)
    _finalize_plot(fig, ax, title=title, x_label=x_label, y_label=y_label,
                   save=save_path, show=show)


def _drop_nan_pairs(x, y):
    keep = np.isfinite(x) & np.isfinite(y)
    return x[keep], y[keep]


def _eval_regression(reg: RegressionResult, xs: np.ndarray) -> np.ndarray:
    """Evaluate a fitted polynomial at ``xs`` (coefficients are
    lowest-degree-first with the constant split into ``intercept``)."""
    powers = np.arange(len(reg.coefficients))
    return reg.intercept + (xs[:, None] ** powers) @ reg.coefficients


def plot_boxplot_with_regression(
    x: np.ndarray,
    y: np.ndarray,
    poly_degree: int = 1,
    x_lim=(0, 1),
    y_lim=(0, 1),
    num_bins: int = 20,
    title="Boxplot with Regression",
    x_label="IoU Difference",
    y_label="Similarity Score",
    save_fig_path=None,
    plot_bin_regression=False,
    verbose=False,
    return_results=False,
    show=True,
):
    """Per-bin boxplots of y over x with a polynomial regression overlay.

    Returns (when ``return_results``) a dict with ``overall_statistics``,
    ``regression_result``, and ``per_bin_statistics``.
    """
    x = _to_numpy(x)
    y = _to_numpy(y)
    lower, upper = x_lim
    edges = np.linspace(lower, upper, num_bins + 1)
    centers = edges[:-1] + np.diff(edges) / 2
    box_w = (upper - lower) / (2 * num_bins)

    x_valid, y_valid = _drop_nan_pairs(x, y)
    if x_valid.size < 2:
        raise ValueError(
            "Less than two data points are valid. Data is invalid for plotting."
        )

    fig, ax = _fig_axes((12, 8))
    which_bin = np.clip(np.searchsorted(edges, x, side="right") - 1, 0, num_bins - 1)
    groups = []
    for b in range(num_bins):
        members = y[(which_bin == b) & np.isfinite(y) & (x >= lower) & (x <= upper)]
        groups.append(members if members.size else np.array([np.nan]))
    ax.boxplot(groups, positions=centers, widths=box_w, patch_artist=True)

    reg = fit_regression_line(x_valid, y_valid, poly_degree)
    xs = np.linspace(lower, upper, 128)
    ax.plot(xs, _eval_regression(reg, xs), "r-", lw=2,
            label=f"Regression line (Degree {poly_degree})")
    overall = get_statistics(x_valid, y_valid)
    _stat_box(ax, [
        f"Pearson Correlation: {overall.pearson:.2f}",
        f"MSE: {reg.mse:.4f}",
    ])

    per_bin_stats = []
    if plot_bin_regression or return_results:
        for b, center in enumerate(centers):
            inside = (x_valid > center - box_w) & (x_valid <= center + box_w)
            if inside.sum() < 2:
                continue
            bin_reg = fit_regression_line(x_valid[inside], y_valid[inside], 1)
            bin_stats = get_statistics(x_valid[inside], y_valid[inside])
            per_bin_stats.append({
                "bin_index": b + 1,
                "bin_center": center,
                "bin_stats": bin_stats,
                "regression": bin_reg,
            })
            if plot_bin_regression:
                ax.plot(x_valid[inside], bin_reg.predictions,
                        label=f"Bin {b + 1} coeff: {bin_reg.coefficients[1]:.2f}")
            if verbose:
                logger.info("bin %d: %s", b + 1, bin_stats)

    ax.set_xticks(centers, np.round(centers, 2))
    ax.set_xlim(lower, upper)
    ax.set_ylim(y_lim)
    _finalize_plot(fig, ax, title=title, x_label=x_label, y_label=y_label,
                   save=save_fig_path, show=show, legend=True)
    if return_results:
        return {
            "overall_statistics": overall,
            "regression_result": reg,
            "per_bin_statistics": per_bin_stats,
        }


def plot_scatter_with_regression(
    x: np.ndarray,
    y: np.ndarray,
    x_lim=(0, 1),
    y_lim=(0, 1),
    title="Scatterplot with Regression",
    x_label="IoU Difference",
    y_label="Similarity Score",
    save_fig_path=None,
    show=True,
) -> None:
    """Scatter of (x, y) with a degree-1 least-squares overlay."""
    x_valid, y_valid = _drop_nan_pairs(_to_numpy(x), _to_numpy(y))
    fig, ax = _fig_axes((10, 6))
    ax.scatter(x_valid, y_valid, alpha=0.6, label="Data points")
    if x_valid.size >= 2:
        reg = fit_regression_line(x_valid, y_valid, 1)
        xs = np.linspace(*x_lim, 128)
        ax.plot(xs, _eval_regression(reg, xs), "r-", lw=2,
                label=f"Regression line, Coefficient: {reg.coefficients[1]:.2f}")
    else:
        logger.warning("Insufficient data points for regression.")
    ax.set_xlim(x_lim)
    ax.set_ylim(y_lim)
    _finalize_plot(fig, ax, title=title, x_label=x_label, y_label=y_label,
                   save=save_fig_path, show=show, legend=True)


@check_is_image()
def plot_image(image, title: str | None = None) -> None:
    """Display an image; CHW torch-layout arrays are transposed to HWC."""
    import matplotlib.pyplot as plt

    image = _to_numpy(image)
    if image.ndim == 3 and image.shape[0] == 3:
        image = np.transpose(image, (1, 2, 0))
    fig, ax = _fig_axes(None)
    ax.imshow(image)
    ax.set_axis_off()
    ax.set_title(title)
    fig.tight_layout()
    plt.show()
    plt.close(fig)


# ---------------------------------------------------------------------------
# Image ops / misc
# ---------------------------------------------------------------------------
@check_is_image()
def gaussian_blur(image, kernel_size: int | None = None, sigma: float = 1.0, device=None):
    """Gaussian blur of one image on ``device`` (None means CUDA), through
    ``ops.gaussian``; returns numpy.

    ``kernel_size`` (default ``2 * int(3 * sigma) + 1``) must lie in
    [2 * int(3 * sigma) + 1, 2 * int(5 * sigma) + 1]. A (3, H, W) image (a
    torch tensor in [0, 1]) comes back (3, H, W) clipped to [0, 1]; a uint8
    numpy image comes back rounded to uint8; anything else as float32.
    """
    if not kernel_size:
        kernel_size = 2 * int(3 * sigma) + 1
    min_k = 2 * int(3 * sigma) + 1
    max_k = 2 * int(5 * sigma) + 1
    if not min_k <= kernel_size <= max_k:
        raise ValueError(
            f"gaussian_blur kernel_size={kernel_size} is outside the supported "
            f"window [{min_k}, {max_k}] (i.e. 2*(3..5)*sigma + 1 for sigma={sigma})."
        )
    from .ops.gaussian import gaussian_blur as _blur

    arr = _to_numpy(image)
    is_chw = arr.ndim == 3 and arr.shape[0] == 3
    if is_chw:
        arr = arr.transpose(1, 2, 0)
    dev = resolve_device(device)
    out = _blur(_to_tensor(np.ascontiguousarray(arr), dev), sigma, kernel_size).cpu().numpy()
    if is_chw:
        out = out.transpose(2, 0, 1).clip(0.0, 1.0)
    elif isinstance(image, np.ndarray) and image.dtype == np.uint8:
        out = np.round(out).clip(0, 255).astype(np.uint8)
    return out


def copy_or_move_images(image_paths: list[str], directory: str, operation: str = "copy") -> None:
    """Copy (``"copy"``) or move (``"cut"``) images into a directory."""
    if operation not in ("copy", "cut"):
        raise ValueError("Invalid operation. Choose from ['copy', 'cut']")
    os.makedirs(directory, exist_ok=True)
    for image in image_paths:
        if operation == "copy":
            shutil.copy(image, directory)
        else:
            shutil.move(image, directory)


def is_subset(list1: list, list2: list) -> bool:
    """Is list1 a subset of list2."""
    if len(list1) > len(list2):
        raise ValueError("List1 must be have smaller or equal length than list2")
    return set(list1).issubset(list2)


def list_is_unique(lst: list) -> bool:
    """Are all elements unique."""
    return len(set(lst)) == len(lst)


def convert_to_integers(list_of_tuples) -> list[tuple[int, int]]:
    """Float tuple list -> int tuple list."""
    return [(int(a), int(b)) for a, b in list_of_tuples]
