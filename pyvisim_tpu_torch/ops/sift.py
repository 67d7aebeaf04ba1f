"""SIFT / RootSIFT detect-and-describe in PyTorch.

Port of ``pyvisim_tpu/ops/sift.py``: Lowe's SIFT with OpenCV's constants
and formulas (Gaussian pyramid with the 2x upscale, 3x3x3 DoG extrema
over the 8-bit prelim threshold, iterative subpixel refinement with the
contrast and edge tests, a smoothed 36-bin orientation histogram with a
secondary-orientation duplicate, the 4x4x8 descriptor with the 0.2 clip
and the 512/255 scaling), with the JAX package's fixed-size design:
images letterboxed to ``process_size``, a per-octave candidate budget
ranked by |DoG|, the global top ``max_keypoints`` by |contrast| with a
validity mask.

The three per-candidate stages run in the hand-written CUDA kernels of
``ops/cuda/sift_window.py`` (refinement, orientation, descriptor); the
pyramid, detection, ranking and the gradient atlas are plain PyTorch, as
they are XLA work in the JAX package. Raw uint8 images are turned gray and
letterboxed on the device by the kernel of ``ops/cuda/ingest.py``, where
the JAX package does both on the host. The JAX package's TPU layouts (the
row-folded DoG and atlas, lane alignment, chunked vmaps with skips, the
uint8 host wire) have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .. import profiling
from .._config import resolve_device
from ..io._staging import upload
from .cuda import ingest
from .cuda import sift_window as kernels
from .gaussian import gaussian_blur_batch

__all__ = ["SiftConfig", "sift_single", "sift_batch", "sift_descriptors"]

_ATLAS_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """The JAX package's ``SiftConfig`` without its TPU scheduling knobs
    (``patch_backend``, ``pallas_chunk``, ``ori_chunk``, ``desc_chunk``,
    ``refine_chunk``, ``refine_dtype``), which change no result."""

    n_octave_layers: int = 3
    sigma: float = 1.6
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    process_size: int = 512
    upscale: bool = True  # OpenCV firstOctave = -1
    max_keypoints: int = 2048
    ori_patch_radius: int = 16  # >= round(4.5 * sigma * 2^(3.5/3)) = 16
    desc_patch_radius: int = 40  # >= hist_width * sqrt(2) * 2.5 at max scale
    # Keypoints are binned by the patch radius their scale needs (ori:
    # round(4.5*scl); desc: round(10.607*scl)); the last class must equal
    # the *_patch_radius.
    ori_radius_classes: tuple[int, ...] = (12, 16)
    desc_radius_classes: tuple[int, ...] = (24, 32, 40)
    # Storage type of the gradient magnitude/angle atlas and of the
    # descriptor's histogram weights ("bfloat16" or "float32").
    atlas_dtype: str = "bfloat16"
    refine_steps: int = 5
    # Largest move of the refinement from the detected extremum, in pixels.
    refine_reach: int = 3
    # Add a keypoint for the strongest secondary orientation peak >= 0.8 max.
    multi_orientation: bool = True

    def __post_init__(self):
        if max(self.desc_radius_classes) > self.desc_patch_radius:
            raise ValueError(
                "desc_radius_classes must fit inside desc_patch_radius (the atlas padding)"
            )
        if max(self.ori_radius_classes) > self.desc_patch_radius:
            raise ValueError(
                "ori_radius_classes must fit inside desc_patch_radius (the atlas padding)"
            )
        if max(self.ori_radius_classes) < self.ori_patch_radius:
            raise ValueError(
                f"max(ori_radius_classes)={max(self.ori_radius_classes)} "
                f"must cover ori_patch_radius={self.ori_patch_radius} "
                "(max-scale keypoints clamp to the last class)"
            )
        if max(self.desc_radius_classes) < self.desc_patch_radius:
            raise ValueError(
                f"max(desc_radius_classes)={max(self.desc_radius_classes)} "
                f"must cover desc_patch_radius={self.desc_patch_radius} "
                "(max-scale keypoints clamp to the last class)"
            )
        if self.atlas_dtype not in _ATLAS_DTYPES:
            raise ValueError(f"atlas_dtype must be one of {sorted(_ATLAS_DTYPES)}")

    @property
    def base_size(self) -> int:
        return self.process_size * 2 if self.upscale else self.process_size

    @property
    def n_octaves(self) -> int:
        # smallest octave kept at >= 16 px
        return max(1, int(math.log2(self.base_size)) - 3)

    def octave_budget(self, o: int) -> int:
        # geometric decay; octave 0 carries the full budget
        return max(16, self.max_keypoints >> o)


def _stable_top(x: torch.Tensor, k: int):
    """The ``k`` largest along the last axis, equal values lower index
    first (XLA's ``top_k`` order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------
def _pyramid_sigmas(cfg: SiftConfig) -> list[float]:
    """Per-level *incremental* blur sigmas within an octave (OpenCV)."""
    k = 2.0 ** (1.0 / cfg.n_octave_layers)
    sig = [cfg.sigma]
    for i in range(1, cfg.n_octave_layers + 3):
        sig_prev = cfg.sigma * k ** (i - 1)
        sig_total = sig_prev * k
        sig.append(math.sqrt(sig_total**2 - sig_prev**2))
    return sig


def _upscale2x(x: torch.Tensor) -> torch.Tensor:
    """(B, S, S) -> (B, 2S, 2S) bilinear, half-pixel centres; for a pure 2x
    upsample the same values as ``jax.image.resize(..., "bilinear")``
    (both give the edge pixel at the border)."""
    return F.interpolate(x[:, None], scale_factor=2, mode="bilinear", align_corners=False)[:, 0]


def _build_pyramids(base: torch.Tensor, cfg: SiftConfig):
    """base: (B, S, S) float 0..255 already blurred to cfg.sigma.

    Returns per-octave lists: gauss[o] (B, L+3, H, W), dog[o] (B, L+2, H, W).
    """
    sigs = _pyramid_sigmas(cfg)
    gauss_octaves, dog_octaves = [], []
    current = base
    for _ in range(cfg.n_octaves):
        levels = [current]
        for i in range(1, cfg.n_octave_layers + 3):
            levels.append(gaussian_blur_batch(levels[-1], sigs[i]))
        g = torch.stack(levels, dim=1)
        gauss_octaves.append(g)
        dog_octaves.append(g[:, 1:] - g[:, :-1])
        # next octave base: level n_octave_layers, every second pixel
        current = levels[cfg.n_octave_layers][:, ::2, ::2].contiguous()
    return gauss_octaves, dog_octaves


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------
def _extrema_mask(dog: torch.Tensor, prelim_thresh: float) -> torch.Tensor:
    """dog (B, L+2, H, W) -> bool (B, L, H, W): 3x3x3 extrema of layers
    1..L above the prelim threshold, outside the 5-px border.

    Compares bf16-rounded values, as the JAX package does (in f32, which
    gives the same truth values); ties count as extrema (OpenCV's >=).
    """
    d = dog.to(torch.bfloat16).to(torch.float32)
    center = d[:, 1:-1]
    wmax = F.max_pool3d(d[:, None], 3, stride=1)[:, 0]  # (B, L, H-2, W-2)
    wmin = -F.max_pool3d(-d[:, None], 3, stride=1)[:, 0]
    inner = center[:, :, 1:-1, 1:-1]
    is_max = (inner >= wmax) & (inner > 0)
    is_min = (inner <= wmin) & (inner < 0)
    mask = torch.zeros_like(center, dtype=torch.bool)
    mask[:, :, 1:-1, 1:-1] = (inner.abs() > prelim_thresh) & (is_max | is_min)
    h, w = mask.shape[2:]
    border = torch.zeros((h, w), dtype=torch.bool, device=dog.device)
    border[5 : h - 5, 5 : w - 5] = True
    return mask & border


def _rank_candidates(dog_o: torch.Tensor, budget: int, cfg: SiftConfig):
    """Extrema mask, bf16 scores and the two-level top-k of one octave:
    the top 8 per (layer, row), then the top ``budget`` of those.

    dog_o (B, L+2, H, W) -> (vals, layer, r, c, valid), each (B, <=budget).
    """
    prelim = math.floor(0.5 * cfg.contrast_threshold / cfg.n_octave_layers * 255)
    mask = _extrema_mask(dog_o, float(max(prelim, 1)))
    score = torch.where(mask, dog_o[:, 1:-1].to(torch.bfloat16).to(torch.float32).abs(), 0.0)
    b, n_l, n_h, n_w = score.shape
    per_row = min(8, n_w)
    budget = min(budget, n_l * n_h * per_row)
    row_vals, row_idx = _stable_top(score.reshape(b, n_l * n_h, n_w), per_row)
    vals, ii = _stable_top(row_vals.reshape(b, -1), budget)
    row = ii // per_row
    layer = (row // n_h + 1).to(torch.int32)
    r = (row % n_h).to(torch.int32)
    c = row_idx.reshape(b, -1).gather(1, ii).to(torch.int32)
    return vals, layer, r, c, vals > 0


def _refine_octaves(dogs, ranked, cfg: SiftConfig) -> dict:
    """Refinement of every octave's ranked candidates in one kernel call: a
    dict of (B, sum of the octaves' budgets) per-candidate tensors, the
    octaves side by side. The kernel takes the candidates octave after
    octave, each octave's image after image."""
    b, dev = dogs[0].shape[0], dogs[0].device
    ks = [valid.shape[1] for *_, valid in ranked]
    counts = [b * k for k in ks]

    def flat(field: int) -> torch.Tensor:
        return torch.cat([r[field].reshape(-1) for r in ranked])

    img = torch.cat([torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(k)
                     for k in ks])
    ref = kernels.refine(
        [d.contiguous() for d in dogs], img, flat(1), flat(2), flat(3), flat(4), counts=counts,
        n_layers=cfg.n_octave_layers, steps=cfg.refine_steps, reach=cfg.refine_reach,
        contrast_threshold=cfg.contrast_threshold, edge_threshold=cfg.edge_threshold,
    )
    layer, r, c, xr, xc, xi, contrast, ok = (
        torch.cat([part.reshape(b, k) for part, k in zip(t.split(counts), ks)], dim=1)
        for t in ref)
    scl_oct = cfg.sigma * torch.pow(2.0, (layer.to(torch.float32) + xi) / cfg.n_octave_layers)
    octave = torch.cat([torch.full((b, k), o, dtype=torch.int32, device=dev)
                        for o, k in enumerate(ks)], dim=1)
    return {
        "layer": layer, "r": r, "c": c, "xr": xr, "xc": xc, "xi": xi, "scl_oct": scl_oct,
        "response": torch.where(ok, contrast.abs(), -1.0),
        "valid": ok, "octave": octave,
    }


# ---------------------------------------------------------------------------
# Gradient atlas
# ---------------------------------------------------------------------------
def _magang_stacks(gauss: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, L+3, H, W) Gaussian levels -> (B, L, H, W, 2) gradient magnitude
    and angle of levels 1..L (the only ones keypoints live on).

    OpenCV's convention: dx = I[r, c+1] - I[r, c-1], dy = I[r-1, c] -
    I[r+1, c] (y up), angle atan2(dy, dx). The magnitude is zero on the
    one-pixel border ring, which OpenCV's per-pixel test excludes.
    """
    g = gauss[:, 1:-2]
    dx = F.pad(g[..., 2:] - g[..., :-2], (1, 1, 0, 0))
    dy = F.pad(g[..., :-2, :] - g[..., 2:, :], (0, 0, 1, 1))
    mag = torch.sqrt(dx * dx + dy * dy)
    mag[..., 0, :] = 0.0
    mag[..., -1, :] = 0.0
    mag[..., :, 0] = 0.0
    mag[..., :, -1] = 0.0
    return torch.stack([mag, torch.atan2(dy, dx)], dim=-1).to(dtype)


def _grad_atlas(gauss_octaves, cfg: SiftConfig):
    """Every octave's magnitude/angle stack in one flat tensor, and the
    (n_octaves, 3) int64 table of (offset, H, W) the window kernels read."""
    dtype = _ATLAS_DTYPES[cfg.atlas_dtype]
    sizes = [g.shape[0] * cfg.n_octave_layers * g.shape[2] * g.shape[3] * 2
             for g in gauss_octaves]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    dev = gauss_octaves[0].device
    atlas = torch.empty(int(sum(sizes)), dtype=dtype, device=dev)
    for g, off, size in zip(gauss_octaves, offsets, sizes):
        atlas[int(off) : int(off) + size] = _magang_stacks(g, dtype).reshape(-1)
    table = [[int(off), g.shape[2], g.shape[3]] for g, off in zip(gauss_octaves, offsets)]
    return atlas, torch.tensor(table, dtype=torch.int64, device=dev)


def _radius_class(scl: torch.Tensor, mult: float, radii) -> torch.Tensor:
    """The patch radius class of each keypoint: the first of ``radii`` >=
    round(mult * scl), the last one for larger scales."""
    table = torch.tensor(radii, dtype=torch.float32, device=scl.device)
    need = torch.round(mult * scl)
    cls = torch.searchsorted(table, need.contiguous()).clamp(max=len(radii) - 1)
    return table.to(torch.int32)[cls]


# ---------------------------------------------------------------------------
# The whole core
# ---------------------------------------------------------------------------
def _sift_core(base_batch: torch.Tensor, cfg: SiftConfig,
               on_stage: Callable[[str], None] | None = None) -> dict:
    """base_batch: (B, S, S) letterboxed grayscale, float 0..255 or uint8
    (cast to f32 on the device). Ranks each octave's candidates, refines
    them all in one kernel call, keeps the global top ``max_keypoints`` by
    response, orients them, adds the secondary-orientation duplicates
    re-ranked into the same budget, and describes the survivors.

    Returns (B, max_keypoints[, 128]) tensors in ``process_size``
    coordinates: desc, x, y, size, theta, response, mask (rows sorted by
    response, valid first).

    ``on_stage(name)`` is called after each stage (pyramid, detect, atlas,
    orientation, descriptor). It is the core's one timing seam: a caller
    records a CUDA event there to split the core's device time by stage
    (``chip_smoke.py`` does). It changes no result.
    """
    mark = on_stage or (lambda name: None)
    x = base_batch.to(torch.float32)
    if cfg.upscale:
        up = _upscale2x(x)
        sig_diff = math.sqrt(max(cfg.sigma**2 - 1.0, 0.01))
    else:
        up = x
        sig_diff = math.sqrt(max(cfg.sigma**2 - 0.25, 0.01))
    gauss, dog = _build_pyramids(gaussian_blur_batch(up, sig_diff), cfg)
    mark("pyramid")

    ranked = [_rank_candidates(dog[o], cfg.octave_budget(o), cfg) for o in range(cfg.n_octaves)]
    merged = _refine_octaves(dog, ranked, cfg)
    del dog, ranked
    k = min(cfg.max_keypoints, merged["response"].shape[1])
    _, top = _stable_top(merged["response"], k)
    cand = {name: v.gather(1, top) for name, v in merged.items()}
    mark("detect")

    atlas, octaves = _grad_atlas(gauss, cfg)
    del gauss
    mark("atlas")

    b = cand["valid"].shape[0]
    img = torch.arange(b, dtype=torch.int32, device=atlas.device).repeat_interleave(k)

    def window_args(rows: dict, radii, mult: float):
        flat = {name: rows[name].reshape(-1).contiguous()
                for name in ("octave", "layer", "r", "c", "scl_oct", "valid")}
        return dict(
            atlas=atlas, octaves=octaves, img=img, octave=flat["octave"], layer=flat["layer"],
            row=flat["r"], col=flat["c"], scl=flat["scl_oct"],
            radius=_radius_class(flat["scl_oct"], mult, radii), valid=flat["valid"],
            n_layers=cfg.n_octave_layers,
        )

    theta, theta2, has_second = kernels.orientation(
        **window_args(cand, cfg.ori_radius_classes, 4.5))
    theta, theta2, has_second = (t.reshape(b, k) for t in (theta, theta2, has_second))
    mark("orientation")

    if cfg.multi_orientation:
        dup_valid = cand["valid"] & has_second
        rows = {name: torch.cat([v, v], dim=1) for name, v in cand.items()}
        rows["valid"] = torch.cat([cand["valid"], dup_valid], dim=1)
        rows["response"] = torch.cat(
            [cand["response"], torch.where(dup_valid, cand["response"], -1.0)], dim=1)
        rows["theta"] = torch.cat([theta, theta2], dim=1)
        _, top2 = _stable_top(torch.where(rows["valid"], rows["response"], -1.0), k)
        rows = {name: v.gather(1, top2) for name, v in rows.items()}
    else:
        rows = dict(cand, theta=theta)

    desc = kernels.descriptor(
        **window_args(rows, cfg.desc_radius_classes, 3.0 * 1.4142135623730951 * 2.5),
        theta=rows["theta"].reshape(-1).contiguous(),
    ).reshape(b, k, 128)
    mark("descriptor")

    scale = torch.pow(2.0, rows["octave"].to(torch.float32)) / (2.0 if cfg.upscale else 1.0)
    out = {
        "desc": desc,
        "x": (rows["c"].to(torch.float32) + rows["xc"]) * scale,
        "y": (rows["r"].to(torch.float32) + rows["xr"]) * scale,
        "size": rows["scl_oct"] * scale * 2.0,
        "theta": rows["theta"],
        "response": rows["response"],
        "mask": rows["valid"].to(torch.float32),
    }
    if k < cfg.max_keypoints:
        pad = cfg.max_keypoints - k
        out = {name: F.pad(v, (0, 0, 0, pad) if v.dim() == 3 else (0, pad))
               for name, v in out.items()}
    return out


# ---------------------------------------------------------------------------
# Host API
# ---------------------------------------------------------------------------
def _apply_root_sift(desc: torch.Tensor) -> torch.Tensor:
    """Hellinger map: L1-normalise (+1e-7), then the square root."""
    return torch.sqrt(desc / (desc.sum(dim=-1, keepdim=True) + 1e-7))


def _to_gray_u8(image: np.ndarray) -> np.ndarray:
    """RGB/gray -> uint8 grayscale, matching OpenCV's RGB2GRAY weights."""
    if image.ndim == 3:
        g = image[..., 0] * 0.299 + image[..., 1] * 0.587 + image[..., 2] * 0.114
        return np.round(g).astype(np.uint8)
    return image.astype(np.uint8)


def _linear_taps(src: int, dst: int, dtype=np.float32):
    """OpenCV's INTER_LINEAR source index (unclamped) and weight of each
    output position along one axis, the weight in ``dtype``."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(dtype)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(dtype)).astype(dtype)


def _edge_taps(src: int, dst: int, dtype):
    """Taps whose columns past an edge take the edge pixel with weight 1."""
    s, f = _linear_taps(src, dst, dtype)
    f[(s < 0) | (s >= src - 1)] = 0.0
    s = np.clip(s, 0, src - 1)
    return s, np.minimum(s + 1, src - 1), f


def _u8_taps(h: int, w: int, nh: int, nw: int):
    """The taps of OpenCV's fixed-point INTER_LINEAR from (h, w) to (nh,
    nw): the source columns ``sx``, ``sx1`` and their 11-bit weights
    ``ax0``, ``ax1``; the source rows ``sy0``, ``sy1`` and theirs ``by0``,
    ``by1`` (int32 weights). Rows past an edge are clamped but keep their
    weight, as OpenCV's generic path does."""
    sx, sx1, fx = _edge_taps(w, nw, np.float32)
    sy, fy = _linear_taps(h, nh)
    sy0, sy1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    one, coef = np.float32(1.0), np.float32(2048)
    ax0 = np.rint((one - fx) * coef).astype(np.int32)
    ax1 = np.rint(fx * coef).astype(np.int32)
    by0 = np.rint((one - fy) * coef).astype(np.int32)
    by1 = np.rint(fy * coef).astype(np.int32)
    return sx, sx1, ax0, ax1, sy0, sy1, by0, by1


def _resize_linear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` for a
    2-D uint8 or float32 image, without OpenCV.

    uint8 follows OpenCV's fixed-point path (``_u8_taps``): f32
    positions, 11-bit weights, int32 horizontal sums, and the vertical
    blend of its SIMD loop, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >>
    16)`` rounded by ``(+2) >> 2``. float32 blends in float64 with both
    axes' edge weights zeroed and rounds once, which is what OpenCV's build
    with Intel IPP returns to within 3e-5 at 0..255 scale.
    """
    h, w = img.shape
    if (h, w) == (nh, nw):
        return img.copy()
    if img.dtype == np.uint8:
        sx, sx1, ax0, ax1, sy0, sy1, by0, by1 = _u8_taps(h, w, nh, nw)
        src = img.astype(np.int32)
        rows = src[:, sx] * ax0 + src[:, sx1] * ax1
        out = (((rows[sy0] >> 4) * by0[:, None]) >> 16) + (((rows[sy1] >> 4) * by1[:, None]) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    sx, sx1, fx = _edge_taps(w, nw, np.float64)
    sy, sy1, fy = _edge_taps(h, nh, np.float64)
    src = img.astype(np.float64)
    rows = src[:, sx] * (1.0 - fx) + src[:, sx1] * fx
    return (rows[sy] * (1.0 - fy)[:, None] + rows[sy1] * fy[:, None]).astype(np.float32)


def _letterbox_shape(h: int, w: int, size: int) -> tuple[int, int]:
    """The size of an (h, w) image with its longest side scaled to ``size``."""
    s = size / max(h, w)
    return max(1, round(h * s)), max(1, round(w * s))


def _letterbox(gray: np.ndarray, size: int) -> np.ndarray:
    """Host-side: scale the longest side to ``size`` (INTER_LINEAR) and
    zero-pad to a square. uint8 stays uint8, so one byte per pixel crosses
    to the device; anything else becomes float32."""
    nh, nw = _letterbox_shape(*gray.shape, size)
    if gray.dtype != np.uint8:
        gray = gray.astype(np.float32)
    out = np.zeros((size, size), gray.dtype)
    out[:nh, :nw] = _resize_linear(gray, nh, nw)
    return out


@functools.lru_cache(maxsize=64)
def _letterbox_taps(h: int, w: int, size: int) -> np.ndarray:
    """The device route's taps of an (h, w) image letterboxed to ``size``:
    ``_u8_taps`` to its letterboxed size as one read-only int64 array, the
    four x tables (``nw`` each) then the four y tables (``nh`` each). An
    image that keeps its size gets taps that copy it (one weight 2048)."""
    taps = np.concatenate(_u8_taps(h, w, *_letterbox_shape(h, w, size))).astype(np.int64)
    taps.flags.writeable = False
    return taps


def _chunk_layout(images, size: int):
    """The raw bytes of one chunk of uint8 images and the tables of
    ``ops/cuda/ingest.py``: ``(raw, layout, taps)``. A contiguous uint8
    batch array is its own raw buffer; a list is packed into one. Each
    distinct image shape has its taps once."""
    if isinstance(images, np.ndarray):
        raw = np.ascontiguousarray(images)
        shapes = [images.shape[1:]] * len(images)
    else:
        arrays = [np.asarray(im) for im in images]
        shapes = [im.shape for im in arrays]
        raw = np.concatenate([im.reshape(-1) for im in arrays])
    layout = np.empty((len(shapes), len(ingest.COLUMNS)), np.int64)
    tap_parts, starts, offset, n_taps = [], {}, 0, 0
    for i, shape in enumerate(shapes):
        if len(shape) not in (2, 3):
            raise ValueError(f"images must be 2-D gray or 3-D colour, got shape {shape}")
        h, w = shape[:2]
        c = shape[2] if len(shape) == 3 else 1
        nh, nw = _letterbox_shape(h, w, size)
        if (h, w) not in starts:
            starts[h, w] = n_taps
            tap_parts.append(_letterbox_taps(h, w, size))
            n_taps += len(tap_parts[-1])
        start = starts[h, w]
        layout[i] = (offset, h, w, c, nh, nw, start, start + 4 * nw)
        offset += h * w * c
    return raw, layout, np.concatenate(tap_parts)


def _ingest_on_device(images, size: int, dev) -> torch.Tensor:
    """One chunk of uint8 images (2-D gray or 3-D RGB(A)) uploaded as they
    are and turned gray and letterboxed by one launch of the ingest kernel
    (its plain version on the CPU): the ``(B, size, size)`` uint8 base. The
    raw upload is freed on return, before the SIFT core allocates."""
    with profiling.span("ingest.upload"):
        raw, layout, taps = _chunk_layout(images, size)
        profiling.count("h2d_bytes", raw.nbytes)
        raw = upload(raw, dev)
    with profiling.span("ingest.letterbox"):
        base = ingest.gray_letterbox(raw, layout, taps, size)
    profiling.count("ingest.on_card", len(layout))
    return base


def _ingest_on_host(images, size: int, dev) -> torch.Tensor:
    """One chunk of other images turned gray (colour ones, by
    ``_to_gray_u8``) and letterboxed on the host, then uploaded: the
    ``(B, size, size)`` base, uint8 or float32."""
    arrays = [np.asarray(im) for im in images]
    if any(im.ndim == 3 for im in arrays):
        with profiling.span("ingest.gray"):
            arrays = [_to_gray_u8(im) if im.ndim == 3 else im for im in arrays]
    with profiling.span("ingest.letterbox"):
        chunk = np.stack([_letterbox(im, size) for im in arrays])
    with profiling.span("ingest.upload"):
        profiling.count("h2d_bytes", chunk.nbytes)
        base = torch.from_numpy(chunk).to(dev)
    profiling.count("ingest.on_host", len(chunk))
    return base


def _all_uint8(images) -> bool:
    if isinstance(images, np.ndarray):
        return images.dtype == np.uint8
    return all(np.asarray(im).dtype == np.uint8 for im in images)


def sift_descriptors(
    images: np.ndarray | list[np.ndarray],
    cfg: SiftConfig | None = None,
    root_sift: bool = False,
    keys: tuple[str, ...] | None = None,
    device: bool = False,
    run_on=None,
) -> dict:
    """Result dict for a batch of images of any sizes: desc (B, N, 128),
    mask (B, N), x, y, size, theta, response in processing coordinates.
    ``keys`` keeps only those planes (desc and mask always).

    ``images`` is a list of images, each 2-D gray (uint8 or float 0..255)
    or 3-D colour (RGB, or RGBA whose alpha is ignored), or one array of
    them: a 2-D array is one image, a 3-D one a batch of gray images, a
    4-D one a batch of colour images.

    Images run in device calls of ``PYVISIM_SIFT_DEVICE_BATCH`` (default
    16). A call whose images are all uint8 uploads them raw (a contiguous
    batch array as it lies, a list packed into one buffer) and turns them
    gray and letterboxes them on the device in one kernel launch
    (``ops/cuda/ingest.py``; its plain version on the CPU), bit for bit
    as the host would. Any other call takes the host route: colour images
    gray by ``_to_gray_u8``, then ``_letterbox`` (float grays stay float),
    then the upload. The counters ``ingest.on_card`` and
    ``ingest.on_host`` count the images of each route.

    ``device=False`` returns numpy arrays, each call's results copied to
    the host; ``device=True`` keeps them on the device as tensors, for at
    most 16 device calls' worth of images. ``run_on`` is the torch device
    (None means CUDA).
    """
    cfg = cfg or SiftConfig()
    if isinstance(images, np.ndarray) and images.ndim == 2:
        images = [images]
    b = len(images)
    device_batch = int(os.environ.get("PYVISIM_SIFT_DEVICE_BATCH", "16"))
    if device and b > 16 * device_batch:
        raise ValueError(
            f"sift device=True keeps all {b} images' descriptors on the device; cap the "
            f"batch at {16 * device_batch} or use device=False for gallery-scale extraction."
        )
    dev = resolve_device(run_on)
    outs = []
    for start in range(0, b, device_batch):
        part = images[start : start + device_batch]
        with torch.inference_mode():
            ingest_chunk = _ingest_on_device if _all_uint8(part) else _ingest_on_host
            base = ingest_chunk(part, cfg.process_size, dev)
            with profiling.span("features"):
                out = _sift_core(base, cfg)
                if root_sift:
                    out["desc"] = _apply_root_sift(out["desc"]) * out["mask"][..., None]
                profiling.count("sift.keypoints", out["mask"])
                profiling.count("sift.slots", out["mask"].numel())
        if keys is not None:
            out = {k: v for k, v in out.items() if k in keys or k in ("desc", "mask")}
        outs.append(out if device else {k: v.cpu().numpy() for k, v in out.items()})
    cat = torch.cat if device else np.concatenate
    return {k: cat([o[k] for o in outs]) for k in outs[0]}


def sift_single(
    gray01: np.ndarray,
    max_keypoints: int = 2048,
    root_sift: bool = False,
    cfg: SiftConfig | None = None,
    run_on=None,
):
    """(H, W) grayscale in [0, 1] -> (desc (N, 128), mask (N,)) numpy."""
    cfg = cfg or SiftConfig(max_keypoints=max_keypoints)
    if cfg.max_keypoints != max_keypoints:
        cfg = dataclasses.replace(cfg, max_keypoints=max_keypoints)
    out = sift_descriptors([np.asarray(gray01) * 255.0], cfg, root_sift=root_sift, run_on=run_on)
    return out["desc"][0], out["mask"][0]


def sift_batch(
    images: np.ndarray | list[np.ndarray],
    max_keypoints: int = 2048,
    root_sift: bool = False,
    cfg: SiftConfig | None = None,
    device: bool = False,
    run_on=None,
):
    """Images -> (desc (B, N, 128), mask (B, N)).

    ``images`` as ``sift_descriptors`` takes them: raw uint8 images (2-D
    gray or 3-D RGB(A)) are turned gray and letterboxed on the device, any
    other on the host. ``device=True`` returns tensors that stay on the
    device (f32 descriptors, root-SIFT applied there), for encoders that
    encode on the device right away; else numpy arrays.
    """
    cfg = cfg or SiftConfig(max_keypoints=max_keypoints)
    if cfg.max_keypoints != max_keypoints:
        cfg = dataclasses.replace(cfg, max_keypoints=max_keypoints)
    out = sift_descriptors(images, cfg, root_sift=root_sift, keys=("desc", "mask"),
                           device=device, run_on=run_on)
    return out["desc"], out["mask"]
