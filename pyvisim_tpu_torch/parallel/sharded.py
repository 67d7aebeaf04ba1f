"""Sharded (multi-rank) compute paths: encode, similarity, SIFT, and
vocabulary training.

Port of ``pyvisim_tpu/parallel/sharded.py``. JAX derives the encode and
similarity collectives with GSPMD and states the training statistics'
``psum`` with ``shard_map``; here every path states its collectives, over
one axis of the mesh each (``_collectives``). Every rank is called with the
same global inputs; after ``pad_to_multiple``, the rank at position ``r`` of
the ``data`` axis of size ``d`` works on rows ``[r*n/d, (r+1)*n/d)`` (the
block JAX's data sharding gives its device) and every rank returns the same
global result.

On each rank the single-card path's kernels do the work: kernel 1 (VLAD)
or 2 (GMM statistics) in :func:`sharded_encode`, kernels 4-6 in
:func:`sharded_sift_batch`, kernel 3 (Lloyd) in
:func:`distributed_kmeans_fit` and kernel 2 (EM) in
:func:`distributed_gmm_fit`. The cluster-sharded encodes' per-cluster
blocks are plain torch, as they are XLA work in JAX.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .._config import full_f32
from ..ops.assign import gmm_log_prob, pairwise_sqdist
from ..ops.codebooks import GmmCodebook, KMeansCodebook
from ..ops.cuda.gmm_stats import gmm_stats_batched
from ..ops.cuda.lloyd_stats import lloyd_stats
from ..ops.norms import lp_normalize, power_normalize
from ._collectives import all_gather, all_reduce, broadcast
from .mesh import axis_index, axis_names, axis_size, data_sharding, mesh_device

__all__ = [
    "pad_to_multiple",
    "sharded_cosine_similarity",
    "sharded_encode",
    "sharded_sift_batch",
    "cluster_sharded_vlad_encode",
    "cluster_sharded_fisher_encode",
    "distributed_kmeans_fit",
    "distributed_pca_fit",
    "distributed_gmm_fit",
]

_EPS = torch.finfo(torch.float32).eps


def pad_to_multiple(arr, multiple: int, axis: int = 0, pad_value=0):
    """Pad ``axis`` up to a multiple (sharding needs divisible sizes).
    Returns (padded tensor, original size)."""
    arr = torch.as_tensor(arr)
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    shape = list(arr.shape)
    shape[axis] = pad
    fill = torch.full(shape, pad_value, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, fill], dim=axis), n


def _on(mesh, x, dtype=None) -> torch.Tensor:
    """``x`` (numpy or a tensor) as a contiguous tensor on the rank's device."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device=mesh_device(mesh), dtype=dtype).contiguous()


def _local_rows(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous block of dim 0 (already padded to divide)."""
    return data_sharding(mesh, t.dim(), axis).shard(t)


def _padded_rows(mesh, *tensors):
    """Pad each tensor's dim 0 to a multiple of the ``data`` axis; returns
    this rank's blocks and the original row count."""
    n_data = axis_size(mesh, "data")
    blocks, n = [], None
    for t in tensors:
        t, n = pad_to_multiple(t, n_data)
        blocks.append(_local_rows(t, mesh))
    return blocks, n


def sharded_cosine_similarity(x, y, mesh) -> torch.Tensor:
    """All-pairs cosine similarity with query rows sharded over 'data'.

    Each rank scores its block of query rows against the whole gallery in
    full float32; the row blocks are gathered over 'data'."""
    from ..ops.similarity import cosine_similarity_matrix

    y = _on(mesh, y, torch.float32)
    (xq,), n = _padded_rows(mesh, _on(mesh, x, torch.float32))
    with torch.no_grad(), full_f32():
        local = cosine_similarity_matrix(xq, y)
    return all_gather(local, mesh, "data")[:n]


def _list_block(items: list, mesh) -> tuple[list, int]:
    """This rank's block of a list as ``_padded_rows`` cuts a tensor: items
    ``[r*s, (r+1)*s)`` with ``s = ceil(n / d)``, padded with zero arrays
    shaped as the last item; and ``n``."""
    n = len(items)
    s = -(-n // axis_size(mesh, "data"))
    start = axis_index(mesh, "data") * s
    mine = list(items[start : start + s])
    blank = np.zeros_like(np.asarray(items[-1]))
    return mine + [blank] * (s - len(mine)), n


def sharded_encode(encode_fn, desc, mask, clustering_model, pca, mesh) -> torch.Tensor:
    """Run a batched encode core with the image batch sharded over 'data'
    and the codebook replicated. ``encode_fn(desc, mask, model, pca)``."""
    (d, m), b = _padded_rows(mesh, _on(mesh, desc), _on(mesh, mask))
    return _encode_block(encode_fn, d, m, clustering_model, pca, mesh, b)


def _encode_block(encode_fn, desc, mask, clustering_model, pca, mesh, n: int) -> torch.Tensor:
    """``sharded_encode`` from this rank's block of the padded batch of
    ``n`` images (``desc``, ``mask``), as an extractor's ``extract_block``
    leaves it: the block is encoded where it is and only the encodings are
    gathered over 'data'."""
    dev = mesh_device(mesh)
    out = encode_fn(_on(mesh, desc), _on(mesh, mask), clustering_model.to(dev),
                    None if pca is None else pca.to(dev))
    return all_gather(out, mesh, "data")[:n]


def sharded_sift_batch(grays, mesh, cfg=None, root_sift: bool = False):
    """Data-parallel SIFT detect+describe: each rank letterboxes its block
    of each chunk's images and runs the SIFT core (kernels 4-6) on it; the
    descriptors and masks are gathered over 'data'. A chunk holds
    ``PYVISIM_SIFT_DEVICE_BATCH`` (default 16) images per rank of the
    'data' axis; each chunk's results come to the host, as the single-card
    ``ops.sift.sift_batch`` copies each of its calls'.

    :param grays: list of (H, W) uint8/float grayscale images (any sizes).
    :return: (desc (B, N, 128), mask (B, N)) numpy arrays.
    """
    from ..ops import sift as sift_ops

    cfg = cfg or sift_ops.SiftConfig()
    if isinstance(grays, np.ndarray) and grays.ndim == 2:
        grays = [grays]
    grays = list(grays)
    n_data = axis_size(mesh, "data")
    rank = axis_index(mesh, "data")
    cap = int(os.environ.get("PYVISIM_SIFT_DEVICE_BATCH", "16")) * n_data
    dev = mesh_device(mesh)
    descs, masks = [], []
    for start in range(0, len(grays), cap):
        chunk = grays[start : start + cap]
        per = -(-len(chunk) // n_data)
        mine = [sift_ops._letterbox(np.asarray(g), cfg.process_size)
                for g in chunk[rank * per : (rank + 1) * per]]
        dtype = np.result_type(*mine) if mine else np.uint8
        base = np.zeros((per, cfg.process_size, cfg.process_size), dtype)
        if mine:
            base[: len(mine)] = np.stack(mine)
        with torch.inference_mode():
            out = sift_ops._sift_core(torch.from_numpy(base).to(dev), cfg)
            desc, mask = out["desc"], out["mask"]
            if root_sift:
                desc = sift_ops._apply_root_sift(desc) * mask[..., None]
            desc = all_gather(desc, mesh, "data")[: len(chunk)]
            mask = all_gather(mask, mesh, "data")[: len(chunk)]
        descs.append(desc.cpu().numpy())
        masks.append(mask.cpu().numpy())
    if not descs:
        n = cfg.max_keypoints
        return np.zeros((0, n, 128), np.float32), np.zeros((0, n), np.float32)
    return np.concatenate(descs), np.concatenate(masks)


# ---------------------------------------------------------------------------
# Cluster-axis sharded encode: each rank owns K/ranks centroids or mixture
# components and computes the (K_local, D) residual / posterior-statistic
# blocks for its clusters only. What the K axis cannot compute locally - the
# hard assignment's arg-min (VLAD) and the posterior's normaliser (FV) - comes
# from O(B*N) min/max/sum all-reduces over 'cluster'.
# ---------------------------------------------------------------------------
def _require_axes(mesh) -> None:
    names = axis_names(mesh)
    if "data" not in names or "cluster" not in names:
        raise ValueError(
            f"mesh axes {names} must include 'data' and 'cluster' "
            "(use make_mesh(n, axis_names=('data', 'cluster'), shape=(a, b)))"
        )


def _cluster_block(mesh, k: int) -> tuple[slice, int]:
    """This rank's slice of the K axis and its size."""
    n_clu = axis_size(mesh, "cluster")
    if k % n_clu != 0:
        raise ValueError(f"K={k} not divisible by cluster axis size {n_clu}")
    k_local = k // n_clu
    start = axis_index(mesh, "cluster") * k_local
    return slice(start, start + k_local), k_local


def _gather_blocks(t: torch.Tensor, mesh, b: int) -> torch.Tensor:
    """(B_local, K_local, ...) blocks -> the global (B, K, ...)."""
    return all_gather(all_gather(t, mesh, "cluster", dim=1), mesh, "data")[:b]


def _set_blocks(mesh, desc, mask):
    desc = _on(mesh, desc, torch.float32)
    mask = (torch.ones(desc.shape[:2], device=desc.device) if mask is None
            else _on(mesh, mask, torch.float32))
    return _padded_rows(mesh, desc, mask)


def cluster_sharded_vlad_encode(
    desc,
    mask,
    centers,
    mesh,
    *,
    power_norm_weight: float = 1.0,
    norm_order: float = 2.0,
    epsilon: float = 1e-9,
    flatten: bool = True,
) -> torch.Tensor:
    """VLAD encode with images sharded over 'data' AND the K centroid axis
    sharded over 'cluster'.

    Each rank scores its batch block against its K/ranks centroids only;
    the global hard assignment comes from two min all-reduces over
    'cluster' (the distance, then the lowest global index among the ranks
    that reach it: exactly ``argmin``, the lowest index winning ties),
    after which the (K_local, D) residual block is a local product.

    :param desc: ``(B, N, D)`` descriptor sets.
    :param mask: ``(B, N)`` validity mask (or None).
    :param centers: ``(K, D)`` codebook; K must divide by the 'cluster' size.
    """
    _require_axes(mesh)
    centers = _on(mesh, centers, torch.float32)
    k = centers.shape[0]
    block, k_local = _cluster_block(mesh, k)
    offset = block.start
    c_local = centers[block]
    (d, m), b = _set_blocks(mesh, desc, mask)
    with torch.no_grad(), full_f32():
        bl, n, dim = d.shape
        d2 = pairwise_sqdist(d.reshape(bl * n, dim), c_local).reshape(bl, n, k_local)
        local_min = d2.amin(dim=-1)
        local_arg = d2.argmin(dim=-1).to(torch.int32)
        global_min = all_reduce(local_min, mesh, "cluster", "min")
        cand = torch.where(local_min == global_min, local_arg + offset,
                           torch.full_like(local_arg, k))
        local_idx = all_reduce(cand, mesh, "cluster", "min") - offset
        mine = (local_idx >= 0) & (local_idx < k_local)
        a = F.one_hot(torch.where(mine, local_idx, 0).long(), k_local).to(d.dtype)
        a = a * (mine.to(d.dtype) * m)[..., None]
        sums = torch.bmm(a.transpose(1, 2), d)
        v = sums - a.sum(dim=1)[..., None] * c_local
    v = _gather_blocks(v, mesh, b)
    v = power_normalize(v, power_norm_weight)
    v = lp_normalize(v, ord=norm_order, dim=-1, epsilon=epsilon)
    return v.reshape(v.shape[0], -1) if flatten else v


def cluster_sharded_fisher_encode(
    desc,
    mask,
    gmm: GmmCodebook,
    mesh,
    *,
    power_norm_weight: float = 0.5,
    norm_order: float = 2.0,
    epsilon: float = 1e-9,
) -> torch.Tensor:
    """Fisher Vector encode with images sharded over 'data' AND the K
    component axis sharded over 'cluster'.

    The posterior softmax's normaliser over all K components comes from a
    max (the stable shift) and then a sum over 'cluster'; the statistics
    and the gradient algebra are then local to each rank's (K_local, D)
    block. The power and global L2 norms run on the gathered vector."""
    _require_axes(mesh)
    w, mu, cov = (_on(mesh, t, torch.float32) for t in (gmm.weights, gmm.means,
                                                         gmm.covariances))
    block, k_local = _cluster_block(mesh, mu.shape[0])
    w_l, mu_l, cov_l = w[block], mu[block], cov[block]
    (d, m), b = _set_blocks(mesh, desc, mask)
    with torch.no_grad(), full_f32():
        bl, n, dim = d.shape
        gmm_l = GmmCodebook(weights=w_l, means=mu_l, covariances=cov_l)
        wlp = gmm_log_prob(d.reshape(bl * n, dim), gmm_l).reshape(bl, n, k_local)
        gmax = all_reduce(wlp.amax(dim=-1), mesh, "cluster", "max")
        ex = torch.exp(wlp - gmax[..., None])
        denom = all_reduce(ex.sum(dim=-1), mesh, "cluster", "sum")
        resp = ex / denom[..., None] * m[..., None]
        n_valid = m.sum(dim=1).clamp_min(1.0)
        rt = resp.transpose(1, 2)
        s0 = resp.sum(dim=1) / n_valid[:, None]
        s1 = torch.bmm(rt, d) / n_valid[:, None, None]
        s2 = torch.bmm(rt, d * d) / n_valid[:, None, None]
        s = s0[..., None]
        d_pi = s0 - w_l
        d_mu = s1 - s * mu_l
        d_sigma = -s2 - s * mu_l**2 + s * cov_l + 2.0 * s1 * mu_l
        sqrt_w = torch.sqrt(w_l)
        d_pi = d_pi / sqrt_w
        d_mu = d_mu / (sqrt_w[:, None] * torch.sqrt(cov_l))
        d_sigma = d_sigma / (math.sqrt(2.0) * sqrt_w[:, None] * cov_l)
    d_pi = _gather_blocks(d_pi, mesh, b)
    d_mu = _gather_blocks(d_mu, mesh, b)
    d_sigma = _gather_blocks(d_sigma, mesh, b)
    v = torch.cat([d_pi, d_mu.reshape(b, -1), d_sigma.reshape(b, -1)], dim=1)
    v = power_normalize(v, power_norm_weight)
    return lp_normalize(v, ord=norm_order, dim=-1, epsilon=epsilon)


# ---------------------------------------------------------------------------
# Distributed vocabulary training: per-rank sufficient statistics, summed
# over 'data'; the (replicated) M-step on every rank.
# ---------------------------------------------------------------------------
def _training_rows(x, mask, mesh):
    x = _on(mesh, x, torch.float32)
    mask = (torch.ones((x.shape[0],), device=x.device) if mask is None
            else _on(mesh, mask, torch.float32))
    n_data = axis_size(mesh, "data")
    x, _ = pad_to_multiple(x, n_data)
    mask, _ = pad_to_multiple(mask, n_data)
    return x, mask, _local_rows(x, mesh), _local_rows(mask, mesh)


def _split(packed: torch.Tensor, *shapes):
    """Cut a flat tensor into consecutive pieces of the given shapes."""
    out, start = [], 0
    for shape in shapes:
        size = math.prod(shape)
        out.append(packed[start : start + size].view(shape))
        start += size
    return out


def _far_candidates(x_l, m_l, centers, mesh):
    """Each rank's highest-cost row (its distance to its nearest center,
    weighted), gathered over 'data': an (n_data, D) pool of relocation
    candidates and their (n_data,) costs."""
    with full_f32():
        cost = pairwise_sqdist(x_l, centers).amin(dim=1) * m_l
    far = cost.argmax()
    return (all_gather(x_l[far][None], mesh, "data"),
            all_gather(cost[far].reshape(1), mesh, "data"))


def _relocate_empty(means, counts, cand_pts, cand_vals):
    """sklearn-style empty-cluster handling: send empty clusters to the
    highest-cost candidates (one per rank of 'data' per iteration; deeper
    degeneracies resolve over the next iterations). ``means`` already
    keeps the old center of a cluster that takes none."""
    empty = counts <= 0
    order = torch.argsort(-cand_vals, stable=True)
    cand_sorted, vals_sorted = cand_pts[order], cand_vals[order]
    rank = torch.cumsum(empty.to(torch.int64), dim=0) - 1
    n_cand = cand_pts.shape[0]
    rank_c = rank.clamp(0, n_cand - 1)
    # A block holding only pad_to_multiple's padding offers a zero-cost
    # candidate (the all-zeros row): never relocate onto it.
    take = empty & (rank < n_cand) & (vals_sorted[rank_c] > 0)
    return torch.where(take[:, None], cand_sorted[rank_c], means)


def distributed_kmeans_fit(
    x,
    n_clusters: int,
    mesh,
    *,
    mask=None,
    n_iters: int = 50,
    seed: int = 0,
    n_init: int = 1,
    init_centers=None,
    history: dict | None = None,
) -> tuple[KMeansCodebook, float]:
    """K-Means with descriptor rows sharded over the mesh's 'data' axis.

    Each rank launches the Lloyd kernel (3) on its block; the sums, counts
    and inertia are summed over 'data' and every rank takes the same
    M-step. Empty clusters are relocated sklearn-style to the highest-cost
    rows (one candidate per rank of 'data'), whose distances are computed
    with a plain pass only in a step that leaves a cluster empty (kernel 3
    returns no per-row distances). ``n_init`` seedings keep the best
    inertia, the inertia of the last step's starting centers, as in JAX.

    Seeding is k-means++ on up to 4,096 valid rows drawn by a
    ``torch.Generator`` seeded ``seed + i``, computed alike on every rank
    and broadcast over 'data'.

    :param init_centers: optional explicit ``(K, D)`` seeding (overrides
        k-means++ and forces ``n_init=1``).
    :param history: a dict that receives, under ``"lloyd_inertia"``, one
        list per seeding of each step's inertia.
    """
    from ..ops.kmeans import _seed_centers

    x, mask, x_l, m_l = _training_rows(x, mask, mesh)
    k, dim = n_clusters, x.shape[1]

    def run(centers):
        steps = []
        for _ in range(n_iters):
            sums, counts, inertia = lloyd_stats(x_l, m_l, centers)
            packed = all_reduce(torch.cat([sums.reshape(-1), counts, inertia.reshape(1)]),
                                mesh, "data")
            sums, counts, inertia = _split(packed, (k, dim), (k,), ())
            means = torch.where(counts[:, None] > 0, sums / counts[:, None].clamp_min(1.0),
                                centers)
            if bool((counts <= 0).any()):
                means = _relocate_empty(means, counts, *_far_candidates(x_l, m_l, centers, mesh))
            centers = means
            steps.append(inertia)
        return centers, (torch.stack(steps).tolist() if steps else [])

    if init_centers is not None:
        n_init = 1
    best = None
    for i in range(n_init):
        if init_centers is not None:
            centers0 = _on(mesh, init_centers, torch.float32)
        else:
            gen = torch.Generator(device=x.device).manual_seed(seed + i)
            centers0 = broadcast(_seed_centers(gen, x, mask, k, 4096), mesh, "data")
        centers, steps = run(centers0)
        if history is not None:
            history.setdefault("lloyd_inertia", []).append(steps)
        inertia = steps[-1] if steps else 0.0
        if best is None or inertia < best[1]:
            best = (centers, inertia)
    return KMeansCodebook(centers=best[0]), best[1]


def distributed_pca_fit(x, n_components: int, mesh, *, mask=None, whiten: bool = False):
    """PCA fit with descriptor rows sharded over the mesh's 'data' axis.

    Each rank accumulates its block's raw moments in full float32 (the
    masked count, coordinate sum and ``(D, D)`` second moment); one sum
    over 'data' gives the global mean and covariance, whose
    eigendecomposition is the single-card path's
    :func:`~pyvisim_tpu_torch.ops.pca.projector_from_moments`.
    """
    from ..ops.pca import projector_from_moments

    x, _, x_l, m_l = _training_rows(x, mask, mesh)
    dim = x.shape[1]
    with torch.no_grad(), full_f32():
        xm = x_l * m_l[:, None]
        packed = torch.cat([m_l.sum().reshape(1), xm.sum(dim=0), (xm.T @ x_l).reshape(-1)])
        n, s1, s2 = _split(all_reduce(packed, mesh, "data"), (), (dim,), (dim, dim))
        n = n.clamp_min(1.0)
        mean = s1 / n
        cov = (s2 - n * torch.outer(mean, mean)) / (n - 1.0).clamp_min(1.0)
        return projector_from_moments(mean, cov, n_components, whiten=whiten)


def distributed_gmm_fit(
    x,
    n_components: int,
    mesh,
    *,
    mask=None,
    n_iters: int = 50,
    reg_covar: float = 1e-6,
    seed: int = 0,
    n_init: int = 1,
    init_kmeans: KMeansCodebook | None = None,
    history: dict | None = None,
) -> tuple[GmmCodebook, float]:
    """Diag-GMM EM with descriptor rows sharded over 'data': each rank
    launches kernel 2 in its EM form on its block, and s0, s1, s2, the
    log-likelihood and the row count are summed over 'data'; the (K, D)
    mixture is replicated. Returns the mixture and the mean log-likelihood
    of the last step's starting mixture, as in JAX.

    ``n_init`` seedings (each a distributed K-Means warm start of 10 steps,
    seeded ``seed + i``) keep the best log-likelihood.

    :param init_kmeans: optional explicit K-Means warm start for the FIRST
        init; the others seed normally.
    :param history: a dict that receives, under ``"em_mean_ll"``, one list
        per init of each step's mean log-likelihood.
    """
    from ..ops.gmm import _init_from_kmeans

    x, mask, x_l, m_l = _training_rows(x, mask, mesh)
    k, dim = n_components, x.shape[1]

    def run(gmm):
        lls = []
        for _ in range(n_iters):
            params = tuple(t.contiguous() for t in (gmm.weights, gmm.means, gmm.covariances))
            s0, s1, s2, ll = (t[0] for t in gmm_stats_batched(x_l[None], m_l[None], *params,
                                                              with_ll=True))
            packed = torch.cat([s0, s1.reshape(-1), s2.reshape(-1), ll.reshape(1),
                                m_l.sum().reshape(1)])
            s0, s1, s2, ll, n = _split(all_reduce(packed, mesh, "data"),
                                       (k,), (k, dim), (k, dim), (), ())
            n_valid = n.clamp_min(1.0)
            nk = s0 + 10.0 * _EPS
            means = s1 / nk[:, None]
            covs = s2 / nk[:, None] - means**2 + reg_covar
            covs = covs.clamp_min(reg_covar)
            weights = nk / n_valid
            weights = weights / weights.sum()
            gmm = GmmCodebook(weights=weights, means=means, covariances=covs)
            lls.append(ll / n_valid)
        return gmm, (torch.stack(lls).tolist() if lls else [])

    best = None
    for i in range(n_init):
        if i == 0 and init_kmeans is not None:
            km = init_kmeans.to(x.device)
        else:
            km, _ = distributed_kmeans_fit(x, n_components, mesh, mask=mask, n_iters=10,
                                           seed=seed + i)
        with torch.no_grad(), full_f32():
            init = _init_from_kmeans(x, mask, km, reg_covar)
        gmm, lls = run(init)
        if history is not None:
            history.setdefault("em_mean_ll", []).append(lls)
        ll = lls[-1] if lls else float("-inf")
        if best is None or ll > best[1]:
            best = (gmm, ll)
    return best
