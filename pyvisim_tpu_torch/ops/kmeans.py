"""K-Means training on the device (k-means++ seeding, Lloyd iterations).

Port of ``pyvisim_tpu/ops/kmeans.py``. Each Lloyd step's statistics come
from :func:`~pyvisim_tpu_torch.ops.cuda.lloyd_stats.lloyd_stats`, which on
CUDA tensors is one kernel launch (the plain version on the CPU). The loop
runs on the host and reads the center shift back once per iteration to
test convergence.

Seeding draws from a ``torch.Generator`` on the data's device, seeded
``seed + i`` for seeding ``i``; it cannot reproduce ``jax.random``, so fits
agree with the JAX package's in quality, not center for center.
"""
from __future__ import annotations

import torch

from .._config import resolve_device
from .codebooks import KMeansCodebook
from .cuda.lloyd_stats import lloyd_stats

__all__ = ["kmeans_fit", "kmeans_plus_plus_init", "lloyd_step"]


def kmeans_plus_plus_init(
    generator: torch.Generator, x: torch.Tensor, n_clusters: int, mask: torch.Tensor
) -> torch.Tensor:
    """k-means++ seeding: each center is drawn with probability
    proportional to its squared distance to the nearest center so far.
    Masked rows are never drawn."""
    valid = mask > 0
    first = torch.multinomial(valid.to(torch.float32), 1, generator=generator)
    centers = torch.empty((n_clusters, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first[0]]
    d2 = ((x - centers[0]) ** 2).sum(dim=1)
    for i in range(1, n_clusters):
        p = torch.where(valid, d2.clamp_min(1e-30), torch.zeros_like(d2))
        c = x[torch.multinomial(p, 1, generator=generator)[0]]
        centers[i] = c
        d2 = torch.minimum(d2, ((x - c) ** 2).sum(dim=1))
    return centers


def lloyd_step(
    x: torch.Tensor,
    mask: torch.Tensor,
    centers: torch.Tensor,
    chunk_size: int | None = None,
):
    """One Lloyd iteration -> ``(new_centers, inertia)``, the inertia being
    that of ``centers``.

    Empty clusters keep their previous center. With ``chunk_size`` the rows
    go through in slices of that many (one kernel call each on CUDA), so
    the plain version's ``(chunk, K)`` distance block bounds memory.
    """
    n = x.shape[0]
    step = max(1, n if chunk_size is None or chunk_size >= n else chunk_size)
    sums = counts = inertia = None
    for start in range(0, max(n, 1), step):
        s, c, i = lloyd_stats(
            x[start : start + step].contiguous(), mask[start : start + step].contiguous(),
            centers,
        )
        if sums is None:
            sums, counts, inertia = s, c, i
        else:
            sums, counts, inertia = sums + s, counts + c, inertia + i
    new_centers = torch.where(
        counts[:, None] > 0, sums / counts[:, None].clamp_min(1.0), centers
    )
    return new_centers, inertia


def _seed_centers(generator, x, mask, n_clusters, init_subsample):
    if init_subsample and x.shape[0] > init_subsample:
        # k-means++ is O(N*K): seed from a subsample of the valid rows.
        take = min(init_subsample, int((mask > 0).sum()))
        idx = torch.multinomial(mask / mask.sum().clamp_min(1.0), take, replacement=False,
                                generator=generator)
        ones = torch.ones((take,), dtype=x.dtype, device=x.device)
        return kmeans_plus_plus_init(generator, x[idx], n_clusters, ones)
    return kmeans_plus_plus_init(generator, x, n_clusters, mask)


def kmeans_fit(
    x,
    n_clusters: int,
    *,
    mask=None,
    max_iters: int = 300,
    tol: float = 1e-6,
    seed: int = 0,
    n_init: int = 1,
    chunk_size: int | None = None,
    init_subsample: int = 65536,
    device=None,
    history: dict | None = None,
):
    """Fit K-Means on descriptors ``x (N, D)``; returns
    ``(KMeansCodebook, inertia)`` of the best of ``n_init`` seedings.

    Defaults mirror sklearn's (``max_iter=300``); ``tol`` is an absolute
    squared center shift, and iteration stops once the shift is at most
    ``tol``. The inertia is the one of the last step's starting centers, as
    in the JAX package. For large N a ``chunk_size`` is chosen as there,
    and k-means++ seeds from an ``init_subsample`` of the rows.

    ``device``: where the fit runs; None means CUDA. ``history``: a dict
    that receives, under ``"lloyd_inertia"``, one list per seeding of each
    Lloyd step's inertia (the first is the seeding's own).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(device=dev, dtype=torch.float32).contiguous()
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask).to(device=dev, dtype=torch.float32).contiguous()
    if chunk_size is None and x.shape[0] * n_clusters > 64_000_000:
        chunk_size = 65536

    best = None
    for i in range(n_init):
        generator = torch.Generator(device=dev).manual_seed(seed + i)
        centers = _seed_centers(generator, x, mask, n_clusters, init_subsample)
        inertia, steps = 0.0, []
        for _ in range(max_iters):
            new_centers, step_inertia = lloyd_step(x, mask, centers, chunk_size)
            shift = ((new_centers - centers) ** 2).sum()
            # One read-back per iteration, for the convergence test.
            shift, inertia = torch.stack([shift, step_inertia]).tolist()
            steps.append(inertia)
            centers = new_centers
            if not shift > tol:
                break
        if history is not None:
            history.setdefault("lloyd_inertia", []).append(steps)
        if best is None or inertia < best[1]:
            best = (centers, inertia)
    return KMeansCodebook(centers=best[0]), best[1]
