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
* There is no ``mesh=``; ``device=`` (None means CUDA) says where the
  gallery lives.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np
import torch

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
        CUDA.
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
        _scales=None,
    ):
        self.device = resolve_device(device)
        if _scales is None:
            vectors = _as_rows(vectors, self.device)
        else:
            # An int8 reload (``load``): the saved codes and scales are kept
            # as they are, and the float rows, for the screen, are their
            # product.
            codes = torch.as_tensor(np.asarray(vectors, np.int8)).to(self.device)
            scales = torch.as_tensor(np.asarray(_scales, np.float32)).to(self.device)
            vectors = codes.to(torch.float32) * scales
        if vectors.ndim != 2 or len(paths) != vectors.shape[0]:
            raise ValueError(
                f"vectors must be (N, D) with N == len(paths); got "
                f"{tuple(vectors.shape)} and {len(paths)} paths"
            )
        if quantize not in (None, "int8"):
            raise ValueError(f"Unknown quantize mode: {quantize!r}")
        if rerank is not None and screen_dim is None:
            raise ValueError("rerank= requires screen_dim=")
        if screen_dim is not None and screen_dim >= vectors.shape[1]:
            raise ValueError(
                f"screen_dim={screen_dim} must be < vector dim "
                f"{vectors.shape[1]} (screening only pays below full rank)"
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
                self._proj = _jl_projection(vectors.shape[1], screen_dim).to(self.device)
                screen = vectors @ self._proj
            if quantize != "int8":
                scales = None
            elif _scales is None:
                vectors, scales = _quantize_rows(vectors)
            else:
                vectors = codes
            cap = _capacity(vectors.shape[0])
            self.vectors = _with_capacity(vectors, cap)
            self.scales = _with_capacity(scales, cap)
            self._screen = _with_capacity(screen, cap)
        self._n = vectors.shape[0]
        self.quantize = quantize
        self.paths = list(paths)
        self.labels = None if labels is None else np.asarray(labels)

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
            if total > self.vectors.shape[0]:
                cap = _capacity(total)
                parts = [(_with_capacity(None if buf is None else buf[:n0], cap), rows)
                         for buf, rows in parts]
            for buf, rows in parts:
                if buf is not None:
                    buf[n0:total] = rows
            self.vectors, self.scales, self._screen = (buf for buf, _ in parts)
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
        return cls(vectors, paths, labels, **index_kwargs)

    @classmethod
    def from_encoding_map(
        cls, encoding_map, labels=None, quantize=None, screen_dim=None,
        rerank=None, auto_exact=True, device=None,
    ) -> "RetrievalIndex":
        """From a ``{path: vector}`` dict, or from the HDF5 path written by
        ``generate_encoding_map(save_path=...)``."""
        from .eval import _gallery

        paths, vectors = _gallery(encoding_map)
        return cls(vectors, paths, labels, quantize=quantize, screen_dim=screen_dim,
                   rerank=rerank, auto_exact=auto_exact, device=device)

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
        n = self._n
        r = self._route(q.shape[0], k)
        with torch.no_grad(), full_f32():
            qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12)
            if r is not None:
                return self._screened(qn, k, r)
            if self.quantize == "int8":
                q8, q_scale = _quantize_rows(qn)
                acc = int8_accumulators(q8, self._scanned_codes())[:, :n]
                sims = acc.to(torch.float32) * q_scale * self.scales[:n].T
            else:
                sims = qn @ self.vectors[:n].T
            return _top_k(sims, k)

    def _scanned_codes(self) -> torch.Tensor:
        """The int8 rows an int8 scan reads: the live rows, rounded up to a
        multiple of 8 where the capacity holds them (``torch._int_mm``'s
        rule; the padding rows' sums are dropped)."""
        n8 = -(-self._n // 8) * 8
        return self.vectors[: n8 if n8 <= self.vectors.shape[0] else self._n]

    def _screened(self, qn: torch.Tensor, k: int, r: int):
        """Scan the JL screen, gather the top-r candidates' full rows and
        rescore them exactly."""
        n = self._n
        sims_s = (qn @ self._proj) @ self._screen[:n].T
        _, cand = _top_k(sims_s, r)  # (Q, r)
        rows = self.vectors.index_select(0, cand.reshape(-1)).view(*cand.shape, -1)
        if self.quantize == "int8":
            rows = rows.to(torch.float32) * self.scales[cand]
        exact = torch.einsum("qd,qrd->qr", qn, rows)
        scores, pos = _top_k(exact, k)
        return scores, torch.gather(cand, 1, pos)

    def query_vectors(self, query_vecs, k: int = 5):
        """(Q, D) query encodings -> (scores (Q, k), indices (Q, k)) numpy."""
        q = _as_rows(query_vecs, self.device)
        q = q[None] if q.ndim == 1 else q
        scores, idx = self._query(q, min(k, self._n))
        return scores.cpu().numpy(), idx.cpu().numpy()

    def query(self, encoder, images, k: int = 5):
        """Encode query images and search -> list (per query) of
        ``[(path, score), ...]`` descending."""
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
        regenerated at load."""
        n = self._n
        extra = {}
        if self.quantize == "int8":
            extra["scales"] = self.scales[:n].cpu().numpy()
        if self.screen_dim is not None:
            extra["screen"] = np.array(
                [self.screen_dim, self.rerank if self.rerank else 0, int(self.auto_exact)],
                np.int64,
            )
        np.savez(
            path,
            vectors=self.vectors[:n].cpu().numpy(),
            paths=np.array(self.paths),
            labels=np.array([], np.int64) if self.labels is None else self.labels,
            **extra,
        )

    @classmethod
    def load(cls, path: str, device=None) -> "RetrievalIndex":
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
                return cls(vectors, paths, labels, quantize="int8", device=device,
                           _scales=data["scales"], **kw)
            return cls(vectors, paths, labels, device=device, **kw)
