"""RetrievalIndex: a device-resident gallery index for serving.

Port of ``pyvisim_tpu/index.py``. The encoded gallery is kept
L2-normalised (optionally int8-quantised per row, optionally beside a
Johnson-Lindenstrauss screen) in device memory, so a query is normalise,
one scan and a top-k.

Differences from the JAX package, none of which changes a result:

* Capacity grows in powers of two as in JAX, and ``add`` appends in place
  within it; a query scans only the live rows (rounded up to a multiple
  of 8 for the int8 product, whose padding rows are dropped), so the
  capacity mask is not needed. The TPU's small-query row padding and the
  scan-based row gather that works around XLA's gather on the TPU are not
  ported: the gather is one ``index_select``.
* The int8 scan runs ``torch._int_mm`` on CUDA where its shape rules hold
  (a multiple of 8 for the feature dim and the scanned rows), and
  otherwise an exact product in float64, whose sums of int8 products are
  integers below 2**53; both give JAX's int32 accumulators bit for bit.
* The JL projection is drawn by ``_jl_projection`` from a CPU
  ``torch.Generator`` seeded 0, not from ``jax.random.PRNGKey(0)``, then
  moved to the device, so the CPU and the card hold the same matrix.
  ``save`` stores no projection, in either stack, so a file written by one
  loads in the other: the exact modes (float32, int8) give the same
  results, and the screened modes regenerate their own screen, which may
  rank other candidates.
* ``device=`` (None means CUDA) says where the gallery lives. With
  ``mesh=`` (a ``parallel.make_mesh`` mesh with a 'data' axis) its rows
  are split over the ranks of 'data' in contiguous blocks, the capacity
  rounded up to a multiple of the axis size, with each block's int8 scales
  and JL screen rows beside it on its rank. A query scores each rank's
  rows, takes a local top-k, and merges the candidates by (score
  descending, global row ascending), ``lax.top_k``'s order, which is what
  the unsharded index answers; a screened query merges the local screens'
  top-r into the global top-r and rescores each candidate on the rank that
  holds it. Every rank calls every method with the same global arguments
  and gets the same global answer; ``save`` writes from the world's rank 0.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np
import torch

from . import profiling
from ._config import full_f32, get_logger, resolve_device

logger = get_logger("index")

__all__ = ["RetrievalIndex"]


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(norms == 0, torch.ones_like(norms), norms)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 codes and their (n, 1) float32 scales;
    ``torch.round`` rounds half to even, as ``jnp.round`` does. XLA
    compiles the JAX package's ``max_abs / 127.0`` into a product with the
    float32 reciprocal, so the scales are formed that way too."""
    max_abs = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-12)
    scales = max_abs * (1.0 / 127.0)
    return torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8), scales


def _jl_projection(d: int, screen_dim: int) -> torch.Tensor:
    """The (d, screen_dim) JL screen, on the CPU: a fixed-seed Gaussian
    scaled so that projected inner products estimate the originals without
    bias. Seed-fixed, so regenerable from (d, screen_dim) alone."""
    gen = torch.Generator().manual_seed(0)
    return torch.randn((d, screen_dim), generator=gen) / math.sqrt(screen_dim)


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, descending, equal values in index order
    (``lax.top_k``'s order; ``torch.topk`` promises none among ties)."""
    values, index = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


def int8_accumulators_plain(q8: torch.Tensor, g8: torch.Tensor) -> torch.Tensor:
    """(Q, n) int32 sums of ``q8 (Q, D) @ g8 (n, D).T`` in float64, which
    adds these integers exactly (|sum| <= 127**2 * D < 2**53); in chunks of
    rows holding at most 1 GiB of float64."""
    out = torch.empty((q8.shape[0], g8.shape[0]), dtype=torch.int32, device=q8.device)
    qd = q8.to(torch.float64)
    step = max(1, (1 << 27) // max(1, g8.shape[1]))
    for s in range(0, g8.shape[0], step):
        out[:, s : s + step] = (qd @ g8[s : s + step].to(torch.float64).T).to(torch.int32)
    return out


def int8_accumulators(q8: torch.Tensor, g8: torch.Tensor) -> torch.Tensor:
    """(Q, n) int32 sums of ``q8 @ g8.T``: ``torch._int_mm`` on CUDA where
    the feature dim and ``n`` are multiples of 8 (the query padded with
    zero rows past the 16 rows it needs), else the exact float64 route."""
    (q, d), n = q8.shape, g8.shape[0]
    if not (q8.is_cuda and d % 8 == 0 and n % 8 == 0):
        return int8_accumulators_plain(q8, g8)
    rows = -(-max(q, 17) // 8) * 8
    padded = torch.zeros((rows, d), dtype=torch.int8, device=q8.device)
    padded[:q] = q8
    return torch._int_mm(padded, g8.T)[:q]


def _capacity(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


def _with_capacity(rows: torch.Tensor | None, cap: int) -> torch.Tensor | None:
    """``rows`` at the head of a zero buffer of ``cap`` rows."""
    if rows is None:
        return None
    out = torch.zeros((cap,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    out[: rows.shape[0]] = rows
    return out


def _as_rows(vectors, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(vectors):
        return vectors.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(vectors, np.float32)).to(device)


def _merge_top_k(scores: torch.Tensor, ids: torch.Tensor, k: int, mesh):
    """The global top ``k`` of the ranks' local (Q, k) lists, each in
    ``_top_k``'s order with global row ids. Gathered in rank order, equal
    scores stand in ascending row order (rank blocks are ascending), so
    one stable sort gives ``lax.top_k``'s order."""
    from .parallel._collectives import all_gather

    scores = all_gather(scores, mesh, "data", dim=1)
    ids = all_gather(ids, mesh, "data", dim=1)
    top, pos = _top_k(scores, k)
    return top, torch.gather(ids, 1, pos)


def _padded_top_k(scores: torch.Tensor, k: int, offset: int):
    """A rank's local top ``k`` with global ids, padded with -inf scores
    (and id -1) to ``k`` columns when it holds fewer rows."""
    top, idx = _top_k(scores, k)
    idx = idx + offset
    short = k - top.shape[1]
    if short:
        q = scores.shape[0]
        top = torch.cat([top, top.new_full((q, short), -torch.inf)], dim=1)
        idx = torch.cat([idx, idx.new_full((q, short), -1)], dim=1)
    return top, idx


class RetrievalIndex:
    """Normalised gallery matrix + paths/labels with a top-k query.

    :param vectors: (N, D) gallery encodings (numpy or a tensor).
    :param paths: N identifiers (file paths or ids).
    :param labels: optional N integer labels.
    :param quantize: None (float32 gallery) or "int8": symmetric per-row
        int8 quantisation of the normalised gallery (a quarter of the
        memory); the query is quantised alike, the product summed in int32
        and rescaled by both sides' scales.
    :param screen_dim: optional coarse-to-fine mode. The gallery is also
        stored under a JL random projection to ``screen_dim`` dims; a query
        scans that screen, keeps the top ``rerank`` candidates, gathers only
        their full rows and rescores them exactly.
    :param rerank: candidates rescored per query in screen mode (default
        ``max(4*k, 128)`` at query time); ``rerank >= len(index)`` gives
        the exact scan's results.
    :param auto_exact: (default True) queries on a screened index take the
        exact full scan whenever ``Q * rerank * 15 >= n``, the JAX
        package's crossover; False forces the screened route.
    :param device: where the gallery lives and queries run; None means
        CUDA (the mesh's device with ``mesh``).
    :param mesh: optional mesh; the gallery's rows are then split over its
        'data' axis.
    """

    def __init__(
        self,
        vectors,
        paths: Sequence[str],
        labels: Sequence[int] | None = None,
        quantize: str | None = None,
        screen_dim: int | None = None,
        rerank: int | None = None,
        auto_exact: bool = True,
        device=None,
        mesh=None,
        _scales=None,
    ):
        self.mesh = mesh
        if device is None and mesh is not None:
            from .parallel.mesh import mesh_device

            device = mesh_device(mesh)
        self.device = resolve_device(device)
        shape = tuple(vectors.shape) if hasattr(vectors, "shape") else np.shape(vectors)
        if len(shape) != 2 or len(paths) != shape[0]:
            raise ValueError(
                f"vectors must be (N, D) with N == len(paths); got "
                f"{shape} and {len(paths)} paths"
            )
        # This rank's rows of the initial layout (all of them unsharded).
        cap = self._capacity(shape[0])
        start, stop = self._owned(shape[0], cap)
        if _scales is None:
            vectors = _as_rows(vectors[start:stop], self.device)
        else:
            # An int8 reload (``load``): the saved codes and scales are kept
            # as they are, and the float rows, for the screen, are their
            # product.
            codes = torch.as_tensor(np.asarray(vectors[start:stop], np.int8)).to(self.device)
            scales = torch.as_tensor(np.asarray(_scales[start:stop], np.float32)).to(self.device)
            vectors = codes.to(torch.float32) * scales
        if quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode: {quantize!r}")
        if rerank is not None and screen_dim is None:
            raise ValueError("rerank= requires screen_dim=")
        if screen_dim is not None and screen_dim >= shape[1]:
            raise ValueError(
                f"screen_dim={screen_dim} must be < vector dim "
                f"{shape[1]} (screening only pays below full rank)"
            )
        with torch.no_grad(), full_f32():
            if _scales is None:
                vectors = _normalize_rows(vectors)
            self.screen_dim = screen_dim
            self.rerank = rerank
            self.auto_exact = auto_exact
            self._proj = None
            screen = None
            if screen_dim is not None:
                self._proj = _jl_projection(shape[1], screen_dim).to(self.device)
                screen = vectors @ self._proj
            if quantize != "int8":
                scales = None
            elif _scales is None:
                vectors, scales = _quantize_rows(vectors)
            else:
                vectors = codes
            per = cap // self._parts()
            self.vectors = _with_capacity(vectors, per)
            self.scales = _with_capacity(scales, per)
            self._screen = _with_capacity(screen, per)
        self._n = shape[0]
        self.quantize = quantize
        self.paths = list(paths)
        self.labels = None if labels is None else np.asarray(labels)

    def _parts(self) -> int:
        """The number of row blocks: the size of the mesh's 'data' axis."""
        if self.mesh is None:
            return 1
        from .parallel.mesh import axis_size

        return axis_size(self.mesh, "data")

    def _capacity(self, n: int) -> int:
        """Global capacity for ``n`` rows: a power of two, rounded up to a
        multiple of the block count."""
        parts = self._parts()
        return -(-_capacity(n) // parts) * parts

    def _owned(self, n: int, cap: int) -> tuple[int, int]:
        """The global rows ``[start, stop)`` of ``n`` live ones that this
        rank holds at capacity ``cap``."""
        per = cap // self._parts()
        start = 0
        if self.mesh is not None:
            from .parallel.mesh import axis_index

            start = axis_index(self.mesh, "data") * per
        return start, max(start, min(n, start + per))

    def _local(self) -> tuple[int, int]:
        """This rank's first global row and its number of live rows."""
        start, stop = self._owned(self._n, self.vectors.shape[0] * self._parts())
        return start, stop - start

    def _global_rows(self, buf: torch.Tensor) -> torch.Tensor:
        """The first ``len(self)`` global rows of a per-rank buffer."""
        if self.mesh is not None:
            from .parallel._collectives import all_gather

            buf = all_gather(buf, self.mesh, "data")
        return buf[: self._n]

    def add(
        self,
        vectors,
        paths: Sequence[str],
        labels: Sequence[int] | None = None,
    ) -> None:
        """Append gallery rows to a live index (streaming ingest).

        New rows are normalised (and quantised in int8 mode; existing rows
        keep their codes and scales) on the device. Within capacity they
        are written in place; past it, every buffer moves to one of twice
        the capacity. Device state changes first and the host bookkeeping
        (paths, labels, length) last, so a failure leaves no row counted
        that is not stored.
        """
        new = _as_rows(vectors, self.device)
        if new.ndim != 2 or new.shape[0] != len(paths):
            raise ValueError(
                f"vectors must be (N, D) with N == len(paths); got "
                f"{tuple(new.shape)} and {len(paths)} paths"
            )
        if new.shape[1] != self.vectors.shape[1]:
            raise ValueError(
                f"vectors must match the index feature dim "
                f"{self.vectors.shape[1]}; got {new.shape[1]}"
            )
        if (self.labels is None) != (labels is None):
            raise ValueError(
                "labels must be provided iff the index was built with labels"
            )
        with torch.no_grad(), full_f32():
            new = _normalize_rows(new)
            new_screen = None if self._proj is None else new @ self._proj
            new_scales = None
            if self.quantize == "int8":
                new, new_scales = _quantize_rows(new)
            n0 = self._n
            total = n0 + new.shape[0]
            parts = [(self.vectors, new), (self.scales, new_scales), (self._screen, new_screen)]
            if total > self.vectors.shape[0] * self._parts():
                # Past capacity: every block moves to the new layout.
                cap = self._capacity(total)
                start, stop = self._owned(total, cap)
                bufs = [None if buf is None else _with_capacity(
                    torch.cat([self._global_rows(buf), rows])[start:stop],
                    cap // self._parts()) for buf, rows in parts]
            else:
                start, _ = self._local()
                bufs = []
                for buf, rows in parts:
                    if buf is not None:
                        lo, hi = max(n0, start), min(total, start + buf.shape[0])
                        if lo < hi:
                            buf[lo - start : hi - start] = rows[lo - n0 : hi - n0]
                    bufs.append(buf)
            self.vectors, self.scales, self._screen = bufs
        self.paths.extend(paths)
        if labels is not None:
            self.labels = np.concatenate([self.labels, np.asarray(labels)])
        self._n = total

    @classmethod
    def build(
        cls,
        encoder,
        image_paths: Iterable[str],
        labels: Sequence[int] | None = None,
        batch_size: int = 64,
        mesh=None,
        **index_kwargs,
    ) -> "RetrievalIndex":
        """Encode a gallery from image files (decoded by ``io.imread_rgb``)
        into an index; ``index_kwargs`` (``quantize``, ``screen_dim``,
        ``rerank``, ``device``, ...) pass through to the constructor."""
        from .io import imread_rgb

        paths = list(image_paths)
        chunks = []
        for start in range(0, len(paths), batch_size):
            imgs = [imread_rgb(p) for p in paths[start : start + batch_size]]
            chunks.append(np.asarray(encoder.encode(imgs)))
        vectors = np.vstack(chunks)
        logger.info("indexed %d images (%d-D)", len(paths), vectors.shape[1])
        return cls(vectors, paths, labels, mesh=mesh, **index_kwargs)

    @classmethod
    def from_encoding_map(
        cls, encoding_map, labels=None, quantize=None, screen_dim=None,
        rerank=None, auto_exact=True, device=None, mesh=None,
    ) -> "RetrievalIndex":
        """From a ``{path: vector}`` dict, or from the HDF5 path written by
        ``generate_encoding_map(save_path=...)``."""
        from .eval import _gallery

        paths, vectors = _gallery(encoding_map)
        return cls(vectors, paths, labels, quantize=quantize, screen_dim=screen_dim,
                   rerank=rerank, auto_exact=auto_exact, device=device, mesh=mesh)

    def __len__(self) -> int:
        return self._n

    def _route(self, n_queries: int, k: int) -> int | None:
        """The rerank depth of a screened query, or None for the full scan."""
        if self.screen_dim is None:
            return None
        r = self.rerank if self.rerank is not None else max(4 * k, 128)
        r = max(min(r, self._n), k)
        # The JAX package's measured crossover on the TPU: past it the exact
        # scan was faster, and it is never lower recall.
        if self.auto_exact and n_queries * r * 15 >= self._n:
            return None
        return r

    def _query(self, q: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(Q, D) float32 queries on the device -> (scores, indices) (Q, k)."""
        start, n = self._local()
        r = self._route(q.shape[0], k)
        with torch.no_grad(), full_f32():
            qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12)
            if r is not None:
                return self._screened(qn, k, r)
            if self.quantize == "int8" and n == 0:  # a rank that holds no live row yet
                sims = qn.new_zeros((qn.shape[0], 0))
            elif self.quantize == "int8":
                q8, q_scale = _quantize_rows(qn)
                acc = int8_accumulators(q8, self._scanned_codes())[:, :n]
                sims = acc.to(torch.float32) * q_scale * self.scales[:n].T
            else:
                sims = qn @ self.vectors[:n].T
            if self.mesh is None:
                return _top_k(sims, k)
            return _merge_top_k(*_padded_top_k(sims, k, start), k, self.mesh)

    def _scanned_codes(self) -> torch.Tensor:
        """The int8 rows an int8 scan reads: this rank's live rows, rounded
        up to a multiple of 8 where the capacity holds them
        (``torch._int_mm``'s rule; the padding rows' sums are dropped)."""
        _, n = self._local()
        n8 = -(-n // 8) * 8
        return self.vectors[: n8 if n8 <= self.vectors.shape[0] else n]

    def _screened(self, qn: torch.Tensor, k: int, r: int):
        """Scan the JL screen, gather the top-r candidates' full rows and
        rescore them exactly (on a mesh: each candidate on the rank that
        holds it)."""
        start, n = self._local()
        sims_s = (qn @ self._proj) @ self._screen[:n].T
        if self.mesh is None:
            _, cand = _top_k(sims_s, r)  # (Q, r)
        else:
            _, cand = _merge_top_k(*_padded_top_k(sims_s, r, start), r, self.mesh)
            # Rows screened on different ranks may score an ulp apart where
            # one product scores them alike: in row order, exact ties rank
            # as the unsharded index ranks them.
            cand, _ = torch.sort(cand, dim=1)
        local = cand - start
        owned = (local >= 0) & (local < n)
        local = torch.where(owned, local, 0)
        rows = self.vectors.index_select(0, local.reshape(-1)).view(*cand.shape, -1)
        if self.quantize == "int8":
            rows = rows.to(torch.float32) * self.scales[local]
        exact = torch.einsum("qd,qrd->qr", qn, rows)
        if self.mesh is not None:
            from .parallel._collectives import all_reduce

            exact = all_reduce(torch.where(owned, exact, 0.0), self.mesh, "data")
        scores, pos = _top_k(exact, k)
        return scores, torch.gather(cand, 1, pos)

    def query_vectors(self, query_vecs, k: int = 5):
        """(Q, D) query encodings -> (scores (Q, k), indices (Q, k)) numpy."""
        with profiling.span("search", root=True):
            q = _as_rows(query_vecs, self.device)
            q = q[None] if q.ndim == 1 else q
            scores, idx = self._query(q, min(k, self._n))
            return scores.cpu().numpy(), idx.cpu().numpy()

    def query(self, encoder, images, k: int = 5):
        """Encode query images and search -> list (per query) of
        ``[(path, score), ...]`` descending."""
        with profiling.span("query", root=True):
            vecs = np.asarray(encoder.encode(images))
            if vecs.ndim == 1:
                vecs = vecs[None]
            scores, idx = self.query_vectors(vecs, k)
        return [
            [(self.paths[j], float(s)) for j, s in zip(row_i, row_s)]
            for row_i, row_s in zip(idx, scores)
        ]

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist vectors/paths/labels (and int8 scales) to .npz, in the
        JAX package's layout. Screen mode stores only ``(screen_dim, rerank,
        auto_exact)``: the seed-fixed projection and the screen gallery are
        regenerated at load. On a mesh every rank calls it, the rows are
        gathered, the world's rank 0 writes, and all ranks wait for the
        file."""
        vectors = self._global_rows(self.vectors).cpu().numpy()
        extra = {}
        if self.quantize == "int8":
            extra["scales"] = self._global_rows(self.scales).cpu().numpy()
        if self.screen_dim is not None:
            extra["screen"] = np.array(
                [self.screen_dim, self.rerank if self.rerank else 0, int(self.auto_exact)],
                np.int64,
            )
        if self.mesh is not None:
            import torch.distributed as dist

            from .parallel._collectives import barrier

            if dist.get_rank() != 0:
                barrier()
                return
        np.savez(
            path,
            vectors=vectors,
            paths=np.array(self.paths),
            labels=np.array([], np.int64) if self.labels is None else self.labels,
            **extra,
        )
        if self.mesh is not None:
            barrier()

    @classmethod
    def load(cls, path: str, device=None, mesh=None) -> "RetrievalIndex":
        """An index from a ``save`` file of either stack; with ``mesh``
        its rows are split over the mesh's 'data' axis again."""
        with np.load(path, allow_pickle=False) as data:
            labels = data["labels"] if data["labels"].size else None
            vectors = data["vectors"]
            paths = [str(p) for p in data["paths"]]
            kw = {}
            if "screen" in data:
                kw["screen_dim"] = int(data["screen"][0])
                kw["rerank"] = int(data["screen"][1]) or None
                if data["screen"].size > 2:  # older files lack the flag
                    kw["auto_exact"] = bool(data["screen"][2])
            if vectors.dtype == np.int8:
                # The codes and scales are restored as saved. (The JAX
                # package dequantises and quantises again, which gives back
                # the codes, but a scale can move by one unit in the last
                # place: 127 * scale / 127 is not always the scale.)
                return cls(vectors, paths, labels, quantize="int8", device=device, mesh=mesh,
                           _scales=data["scales"], **kw)
            return cls(vectors, paths, labels, device=device, mesh=mesh, **kw)
