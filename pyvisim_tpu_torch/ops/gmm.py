"""Diagonal-covariance GMM training on the device (EM).

Port of ``pyvisim_tpu/ops/gmm.py``. Each E-step's statistics come from
:func:`~pyvisim_tpu_torch.ops.cuda.gmm_stats.gmm_stats_batched`, which on
CUDA tensors is one kernel launch in full f32 (the plain version on the
CPU); the M-step is plain torch. The loop runs on the host and reads the
mean log-likelihood back once per iteration to test convergence.
"""
from __future__ import annotations

import torch

from .._config import resolve_device
from .assign import gmm_log_prob, pairwise_sqdist
from .codebooks import GmmCodebook, KMeansCodebook
from .fisher import gmm_stats_chunked
from .kmeans import kmeans_fit

__all__ = ["gmm_fit", "em_step"]

_EPS = torch.finfo(torch.float32).eps


def _e_step(x: torch.Tensor, mask: torch.Tensor, gmm: GmmCodebook):
    """Masked responsibilities ``(N, K)`` and the mean log-likelihood."""
    wlp = gmm_log_prob(x, gmm)
    log_norm = torch.logsumexp(wlp, dim=1)
    resp = torch.exp(wlp - log_norm[:, None]) * mask[:, None]
    mean_ll = (log_norm * mask).sum() / mask.sum().clamp_min(1.0)
    return resp, mean_ll


def em_step(
    x: torch.Tensor,
    mask: torch.Tensor,
    gmm: GmmCodebook,
    reg_covar: float,
    chunk_size: int | None = None,
):
    """One EM iteration -> ``(new GmmCodebook, mean log-likelihood)``, the
    likelihood being that of ``gmm``.

    Counts get a ``10*eps`` floor and covariances ``reg_covar`` added and a
    ``reg_covar`` floor, as in the JAX package. With ``chunk_size`` the
    rows go through in slices of that many (one kernel call each on CUDA).
    """
    params = tuple(t.contiguous() for t in (gmm.weights, gmm.means, gmm.covariances))
    s0, s1, s2, ll = (
        t[0] for t in gmm_stats_chunked(x[None], mask[None], params, chunk_size, with_ll=True)
    )
    n_valid = mask.sum().clamp_min(1.0)
    mean_ll = ll / n_valid
    nk = s0 + 10.0 * _EPS
    means = s1 / nk[:, None]
    covs = s2 / nk[:, None] - means**2 + reg_covar
    covs = covs.clamp_min(reg_covar)
    weights = nk / n_valid
    weights = weights / weights.sum()
    return GmmCodebook(weights=weights, means=means, covariances=covs), mean_ll


def _init_from_kmeans(x, mask, km: KMeansCodebook, reg_covar: float) -> GmmCodebook:
    """Weights, means and covariances of the k-means clusters."""
    labels = torch.argmin(pairwise_sqdist(x, km.centers), dim=1)
    one_hot = torch.nn.functional.one_hot(labels, km.n_clusters).to(x.dtype) * mask[:, None]
    nk = one_hot.sum(dim=0) + 10.0 * _EPS
    means = (one_hot.T @ x) / nk[:, None]
    sq = (one_hot.T @ (x * x)) / nk[:, None]
    covs = (sq - means**2).clamp_min(reg_covar) + reg_covar
    weights = nk / mask.sum().clamp_min(1.0)
    weights = weights / weights.sum()
    return GmmCodebook(weights=weights, means=means, covariances=covs)


def gmm_fit(
    x,
    n_components: int,
    *,
    mask=None,
    max_iters: int = 100,
    tol: float = 1e-3,
    reg_covar: float = 1e-6,
    seed: int = 0,
    kmeans_iters: int = 25,
    chunk_size: int | None = None,
    device=None,
    history: dict | None = None,
):
    """Fit a diag-covariance GMM on ``x (N, D)``; returns ``(GmmCodebook,
    final mean log-likelihood)``.

    A K-Means fit (``kmeans_iters`` Lloyd steps) seeds the means, weights
    and covariances; EM runs until the mean log-likelihood moves by at most
    ``tol`` or ``max_iters`` steps. For large N a ``chunk_size`` is chosen
    as in the JAX package. ``device``: where the fit runs; None means CUDA.
    ``history``: a dict that receives the K-Means fit's entries and, under
    ``"em_mean_ll"``, each EM step's mean log-likelihood (the first is the
    K-Means initialisation's).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(device=dev, dtype=torch.float32).contiguous()
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask).to(device=dev, dtype=torch.float32).contiguous()
    if chunk_size is None and x.shape[0] * n_components > 64_000_000:
        chunk_size = 65536

    km, _ = kmeans_fit(
        x, n_components, mask=mask, max_iters=kmeans_iters, seed=seed,
        chunk_size=chunk_size, device=dev, history=history,
    )
    gmm = _init_from_kmeans(x, mask, km, reg_covar)
    prev_ll, ll, lls = float("-inf"), float("inf"), []
    while len(lls) < max_iters and abs(ll - prev_ll) > tol:
        gmm, mean_ll = em_step(x, mask, gmm, reg_covar, chunk_size)
        prev_ll, ll = ll, mean_ll.item()  # one read-back per iteration
        lls.append(ll)
    if history is not None:
        history["em_mean_ll"] = lls
    return gmm, ll
