"""The plain SIFT / RootSIFT pipeline: the benchmark's reference for it.

A frozen copy, made at commit ede8601, of the program's plain versions:
``pyvisim_tpu_torch/ops/gaussian.py`` (the separable blur),
``pyvisim_tpu_torch/ops/cuda/sift_window.py`` (the plain versions of the
refinement, orientation and descriptor kernels: ``refine_reference``,
``orientation_reference``, ``descriptor_reference`` and their helpers),
``pyvisim_tpu_torch/ops/sift.py`` (the pyramid, detection, ranking,
gradient atlas, the core and the host letterbox) and
``pyvisim_tpu_torch/features/_features.py:_to_gray_u8``. It imports
nothing of the program, so that a later change to the program cannot move
the yardstick.

Changes from the copied text: the core calls the plain versions where
the program calls its kernels, and ``_blur_hw`` takes ``allow_tf32`` (the
program's is always off) and ``_ATLAS_DTYPES`` and ``_ATLAS`` hold float8, so that the
control of ``benchmark/control.py`` can run this pipeline one precision
lower than the configuration states. ``describe`` is new: the host ingest
and the core for a list of RGB images, as ``RootSIFT`` runs them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

def gaussian_kernel1d(sigma: float, kernel_size: int | None = None) -> np.ndarray:
    """Sampled-Gaussian 1-D kernel, matching OpenCV's ``getGaussianKernel``
    for sizes where OpenCV computes (rather than looks up) coefficients."""
    if kernel_size is None:
        kernel_size = 2 * int(3.0 * sigma) + 1
    if kernel_size % 2 != 1:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    r = (kernel_size - 1) // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _blur_hw(img: torch.Tensor, sigma: float, kernel_size: int,
             allow_tf32: bool = False) -> torch.Tensor:
    """Blur a (B, H, W) float32 stack along H, then W."""
    k = torch.from_numpy(gaussian_kernel1d(sigma, kernel_size)).to(img.device)
    r = (kernel_size - 1) // 2
    x = img[:, None]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=allow_tf32):
        x = F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1))
        x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    return x[:, 0]


def gaussian_blur_batch(
    images: torch.Tensor, sigma: float, kernel_size: int | None = None,
    allow_tf32: bool = False,
) -> torch.Tensor:
    """Blur a batch: (B, H, W) or (B, H, W, C) float32 tensor."""
    if kernel_size is None:
        kernel_size = 2 * int(3.0 * sigma) + 1
    images = images.to(torch.float32)
    if images.dim() == 4:
        b, h, w, c = images.shape
        x = images.permute(0, 3, 1, 2).reshape(b * c, h, w)
        out = _blur_hw(x, float(sigma), int(kernel_size), allow_tf32)
        return out.reshape(b, c, h, w).permute(0, 2, 3, 1)
    return _blur_hw(images, float(sigma), int(kernel_size), allow_tf32)


_IMG_SCALE = float(np.float32(1.0) / np.float32(255.0))


_DERIV_SCALE = float(np.float32(_IMG_SCALE) * np.float32(0.5))


_CROSS_SCALE = float(np.float32(_IMG_SCALE) * np.float32(0.25))


_ORI_BINS = 36


_BINS_PER_RAD_36 = 36 / (2.0 * np.pi)  # rounded to f32 where it multiplies f32


_RAD_PER_BIN_36 = 2.0 * np.pi / 36


_BINS_PER_RAD_8 = 8 / (2.0 * np.pi)


_SQRT2 = 1.4142135623730951


class Refined(NamedTuple):
    """Per-candidate refinement results; rejected candidates (``ok``
    False) keep their start position and zero offsets and contrast."""

    layer: torch.Tensor  # int32
    row: torch.Tensor  # int32
    col: torch.Tensor  # int32
    xr: torch.Tensor  # f32 offsets
    xc: torch.Tensor
    xi: torch.Tensor
    contrast: torch.Tensor  # f32, normalised 0..1 scale, signed
    ok: torch.Tensor  # bool


_PER_ITEM = {"img", "octave", "layer", "row", "col", "scl", "theta", "radius", "valid"}


_I32, _F32, _BOOL = (torch.int32,), (torch.float32,), (torch.bool,)


_ATLAS = (torch.bfloat16, torch.float32, torch.float8_e4m3fn)


_MAX_OCTAVES = 16


_CHUNK_ELEMS = 1 << 25


def _check(tensors: dict, dtypes: dict) -> int:
    """Each tensor must have its dtype, be contiguous and lie on the first
    one's device; the per-candidate ones are 1-D of one length. Returns
    that length."""
    first_name, first = next(iter(tensors.items()))
    n = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype not in dtypes[name]:
            raise TypeError(f"{name} must be {' or '.join(map(str, dtypes[name]))}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {first_name} on {first.device}")
        if name in _PER_ITEM:
            if t.dim() != 1 or (n is not None and t.numel() != n):
                raise ValueError(f"{name} must be 1-D of length {n}, got {tuple(t.shape)}")
            n = t.numel()
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SIFT kernels run on cpu or cuda, not {first.device}")
    return n


def _stencils(dog, img, layer, row, col):
    """The value and 9 derivatives of each candidate's 3x3x3 cube, image
    scales folded in (clamped reads, as the kernel's)."""
    _, n_total, h, w = dog.shape
    flat = dog.reshape(-1)
    base = img.long() * n_total

    def at(dl, dr, dc):
        ll = (layer + dl).clamp(0, n_total - 1).long()
        rr = (row + dr).clamp(0, h - 1).long()
        cc = (col + dc).clamp(0, w - 1).long()
        return flat[((base + ll) * h + rr) * w + cc]

    v = at(0, 0, 0)
    c_p, c_m = at(0, 0, 1), at(0, 0, -1)
    r_p, r_m = at(0, 1, 0), at(0, -1, 0)
    l_p, l_m = at(1, 0, 0), at(-1, 0, 0)
    v2 = v * 2.0
    return (
        v * _IMG_SCALE,
        (c_p - c_m) * _DERIV_SCALE,
        (r_p - r_m) * _DERIV_SCALE,
        (l_p - l_m) * _DERIV_SCALE,
        (c_p + c_m - v2) * _IMG_SCALE,
        (r_p + r_m - v2) * _IMG_SCALE,
        (l_p + l_m - v2) * _IMG_SCALE,
        (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * _CROSS_SCALE,
        (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * _CROSS_SCALE,
        (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * _CROSS_SCALE,
    )


def _solve3(s):
    """Adjugate solve of H x = (dDx, dDy, dDs); returns -x as (xc, xr, xi)."""
    _, dDx, dDy, dDs, a, d, f, b, c, e = s
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, 1e-30, det)
    xc = -((co00 * dDx + co01 * dDy + co02 * dDs) * inv_det)
    xr = -((co01 * dDx + co11 * dDy + co12 * dDs) * inv_det)
    xi = -((co02 * dDx + co12 * dDy + co22 * dDs) * inv_det)
    return xc, xr, xi


_REFINE_DTYPES = dict(img=_I32, layer=_I32, row=_I32, col=_I32, valid=_BOOL)


def _check_refine(dogs, img, layer, row, col, valid, counts, n_layers: int) -> int:
    """The per-candidate tensors as ``_check`` wants them; ``dogs`` a list of
    1 to 16 contiguous f32 ``(B, n_layers + 2, H, W)`` DoGs of one B on the
    candidates' device, ``counts`` one int per DoG summing to the number of
    candidates. Reads only metadata: it runs on every SIFT call."""
    n = _check(dict(img=img, layer=layer, row=row, col=col, valid=valid), _REFINE_DTYPES)
    if not isinstance(dogs, (list, tuple)) or not 1 <= len(dogs) <= _MAX_OCTAVES:
        raise ValueError(f"dogs must be a list of 1 to {_MAX_OCTAVES} octaves' DoGs")
    for o, dog in enumerate(dogs):
        if not isinstance(dog, torch.Tensor) or dog.dtype != torch.float32:
            raise TypeError(f"dogs[{o}] must be a float32 tensor")
        if dog.device != img.device or not dog.is_contiguous():
            raise ValueError(f"dogs[{o}] must be contiguous on {img.device}")
        if dog.dim() != 4 or dog.shape[1] != n_layers + 2 or dog.shape[0] != dogs[0].shape[0]:
            raise ValueError(f"dogs[{o}] must be (B, n_layers + 2 = {n_layers + 2}, H, W) "
                             f"with the B of dogs[0], got {tuple(dog.shape)}")
    if len(counts) != len(dogs) or min(counts) < 0 or sum(counts) != n:
        raise ValueError(f"counts must give each of the {len(dogs)} octaves' candidates, "
                         f"{n} in all; got {list(counts)}")
    return n


def _refine_octave(dog, img, layer, row, col, valid, *, n_layers, steps, reach,
                   contrast_threshold, edge_threshold):
    """:func:`refine_reference` on one octave's DoG: its Refined, and the
    number of fits each candidate took."""
    h, w = dog.shape[2], dog.shape[3]
    n = valid.numel()
    zeros_i = torch.zeros(n, dtype=torch.int32, device=dog.device)
    lay, dr, dc = layer.clone(), zeros_i.clone(), zeros_i.clone()
    xr = torch.zeros(n, dtype=torch.float32, device=dog.device)
    xc, xi = xr.clone(), xr.clone()
    ok = valid.clone()
    converged = torch.zeros_like(valid)
    fits = zeros_i.clone()
    for _ in range(steps):
        active = ok & ~converged
        fits += active.to(torch.int32)
        xc_n, xr_n, xi_n = _solve3(_stencils(dog, img, lay, row + dr, col + dc))
        xr = torch.where(active, xr_n, xr)
        xc = torch.where(active, xc_n, xc)
        xi = torch.where(active, xi_n, xi)
        done = (xc_n.abs() < 0.5) & (xr_n.abs() < 0.5) & (xi_n.abs() < 0.5)
        converged = converged | (active & done)
        move = active & ~done
        finite = (xc_n.abs() <= 1e6) & (xr_n.abs() <= 1e6) & (xi_n.abs() <= 1e6)

        def step(x):
            return torch.round(torch.where(finite, x, 0.0)).to(torch.int32)

        new_l, new_dr, new_dc = lay + step(xi_n), dr + step(xr_n), dc + step(xc_n)
        gr, gc = row + new_dr, col + new_dc
        inside = ((new_l >= 1) & (new_l <= n_layers) & (gr >= 5) & (gr < h - 5)
                  & (gc >= 5) & (gc < w - 5))
        in_window = (new_dr.abs() <= reach) & (new_dc.abs() <= reach)
        ok = ok & ~(move & ~(finite & inside & in_window))
        moved = move & ok
        lay = torch.where(moved, new_l, lay)
        dr = torch.where(moved, new_dr, dr)
        dc = torch.where(moved, new_dc, dc)
    ok = ok & converged
    s = _stencils(dog, img, lay, row + dr, col + dc)
    val, dDx, dDy, dDs, dxx, dyy, _, dxy = s[:8]
    contr = val + 0.5 * (dDx * xc + dDy * xr + dDs * xi)
    e = float(np.float32(edge_threshold))
    e1 = float(np.float32(e + 1.0) * np.float32(e + 1.0))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    ok = (ok & (contr.abs() * float(n_layers) >= float(np.float32(contrast_threshold)))
          & (det > 0) & (tr * tr * e < e1 * det))
    zero = torch.zeros_like(xr)
    out = Refined(
        torch.where(ok, lay, layer), torch.where(ok, row + dr, row), torch.where(ok, col + dc, col),
        torch.where(ok, xr, zero), torch.where(ok, xc, zero), torch.where(ok, xi, zero),
        torch.where(ok, contr, zero), ok,
    )
    return out, fits


def refine_reference(
    dogs, img, layer, row, col, valid, *, counts, n_layers: int, steps: int, reach: int,
    contrast_threshold: float, edge_threshold: float, return_steps: bool = False,
):
    """Plain version of :func:`refine` (OpenCV adjustLocalExtrema, as
    ``pyvisim_tpu/ops/sift.py:_refine_candidates``), one octave at a time:
    up to ``steps`` quadratic fits per candidate, a step to the rounded
    offset after each, until every offset is below 0.5; rejection on
    offsets that are not finite or above 1e6, on leaving layers
    1..n_layers, the 5-px border or the ``+-reach`` window, on not
    converging, and on the contrast and edge tests. With ``return_steps``
    also the number of fits each candidate took."""
    _check_refine(dogs, img, layer, row, col, valid, counts, n_layers)
    kw = dict(n_layers=n_layers, steps=steps, reach=reach,
              contrast_threshold=contrast_threshold, edge_threshold=edge_threshold)
    parts = [_refine_octave(dog, *(t[start:start + k] for t in (img, layer, row, col, valid)), **kw)
             for dog, start, k in zip(dogs, np.cumsum([0, *counts[:-1]]).tolist(), counts)]
    out = Refined(*(torch.cat(field) for field in zip(*(ref for ref, _ in parts))))
    return (out, torch.cat([fits for _, fits in parts])) if return_steps else out


_WINDOW_DTYPES = dict(
    atlas=_ATLAS, octaves=(torch.int64,), img=_I32, octave=_I32, layer=_I32, row=_I32,
    col=_I32, scl=_F32, theta=_F32, radius=_I32, valid=_BOOL,
)


def _check_window(atlas, octaves, **per_item) -> int:
    n = _check(dict(atlas=atlas, octaves=octaves, **per_item), _WINDOW_DTYPES)
    if atlas.dim() != 1:
        raise ValueError(f"atlas must be flat, got {tuple(atlas.shape)}")
    if octaves.dim() != 2 or octaves.shape[1] != 3 or octaves.shape[0] < 1:
        raise ValueError(f"octaves must be (n_octaves, 3), got {tuple(octaves.shape)}")
    return n


def _window(atlas, octaves, img, octave, layer, row, col, radius, n_layers):
    """Magnitude, angle and in-image mask of each keypoint's window of
    radius ``radius.max()``, pixels in row-major order, and the (ii, jj)
    offsets of those pixels (f32)."""
    rmax = max(int(radius.max()), 0)
    d = torch.arange(-rmax, rmax + 1, device=atlas.device, dtype=torch.int32)
    side = 2 * rmax + 1
    ii, jj = d.repeat_interleave(side), d.repeat(side)
    oct_l = octave.long()
    off, h, w = octaves[oct_l, 0], octaves[oct_l, 1], octaves[oct_l, 2]
    rr = row[:, None] + ii
    cc = col[:, None] + jj
    inside = (rr >= 1) & (rr < h[:, None] - 1) & (cc >= 1) & (cc < w[:, None] - 1)
    plane = (img.long() * n_layers + (layer.long() - 1)) * h * w
    rr_in = torch.minimum(rr.long().clamp(min=0), (h - 1)[:, None])
    cc_in = torch.minimum(cc.long().clamp(min=0), (w - 1)[:, None])
    at = (off + 2 * plane)[:, None] + 2 * (rr_in * w[:, None] + cc_in)
    mag = atlas[at].to(torch.float32)
    ang = atlas[at + 1].to(torch.float32)
    return mag, ang, inside, ii.to(torch.float32), jj.to(torch.float32)


def _orientation_peaks(hist, valid):
    """Smoothed histogram -> (theta, theta2, has_second), as the kernel's
    thread 0 computes them."""
    def roll(x, s):
        return torch.roll(x, s, dims=1)

    hs = (roll(hist, 2) + roll(hist, -2)) * 0.0625 + (roll(hist, 1) + roll(hist, -1)) * 0.25 \
        + hist * 0.375
    bins = torch.arange(_ORI_BINS, device=hist.device)

    def peak_theta(peak):
        pick = lambda s: hs.gather(1, ((peak + s) % _ORI_BINS)[:, None])[:, 0]  # noqa: E731
        l_, c_, r_ = pick(-1), pick(0), pick(1)
        denom = l_ - 2.0 * c_ + r_
        interp = torch.where(denom.abs() > 1e-12, 0.5 * (l_ - r_) / denom, 0.0)
        return (peak.to(torch.float32) + interp) * _RAD_PER_BIN_36

    peak = hs.argmax(dim=1)
    omax = hs.gather(1, peak[:, None])
    is_peak = ((hs > roll(hs, 1)) & (hs >= roll(hs, -1)) & (hs >= 0.8 * omax)
               & (bins[None, :] != peak[:, None]))
    second = torch.where(is_peak, hs, -torch.inf).argmax(dim=1)
    has_second = is_peak.any(dim=1) & valid
    theta = torch.where(valid, peak_theta(peak), 0.0)
    theta2 = torch.where(has_second, peak_theta(second), 0.0)
    return theta, theta2, has_second


def orientation_reference(atlas, octaves, img, octave, layer, row, col, scl, radius, valid,
                          *, n_layers: int):
    """Plain version of :func:`orientation` (``pyvisim_tpu/ops/sift.py:
    _orientation``), with the kernel's histogram sums: each bin adds its
    pixels' weighted magnitudes in row-major window order."""
    n = _check_window(atlas, octaves, img=img, octave=octave, layer=layer, row=row, col=col,
                      scl=scl, radius=radius, valid=valid)
    hist = torch.zeros((n, _ORI_BINS), dtype=torch.float32, device=atlas.device)
    if n:
        rad = torch.minimum(radius, torch.round(4.5 * scl).to(torch.int32))
        mag, ang, inside, ii, jj = _window(atlas, octaves, img, octave, layer, row, col,
                                           rad, n_layers)
        sigma_w = 1.5 * scl
        exp_scale = -1.0 / (2.0 * sigma_w * sigma_w)
        in_radius = (ii.abs()[None, :] <= rad[:, None]) & (jj.abs()[None, :] <= rad[:, None])
        wm = torch.exp((ii * ii + jj * jj)[None, :] * exp_scale[:, None]) * mag
        wm = torch.where(inside & in_radius & valid[:, None], wm, 0.0)
        bins = torch.remainder(torch.round(ang * _BINS_PER_RAD_36).to(torch.int64), _ORI_BINS)
        for p in range(wm.shape[1]):  # one add per bin and pixel, in window order
            hist.scatter_add_(1, bins[:, p : p + 1], wm[:, p : p + 1])
    return _orientation_peaks(hist, valid)


def _round_like(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).to(torch.float32) if dtype != torch.float32 else x


def _hat(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def descriptor_reference(atlas, octaves, img, octave, layer, row, col, scl, theta, radius,
                         valid, *, n_layers: int):
    """Plain version of :func:`descriptor` (``pyvisim_tpu/ops/sift.py:
    _descriptor``): per radius class, the interior 4x4 spatial hat weights
    times the magnitude, rounded to the atlas' type, contracted against the
    rounded orientation hats in one batched matmul, rows in chunks."""
    n = _check_window(atlas, octaves, img=img, octave=octave, layer=layer, row=row, col=col,
                      scl=scl, theta=theta, radius=radius, valid=valid)
    dev = atlas.device
    desc = torch.zeros((n, 128), dtype=torch.float32, device=dev)
    if not n:
        return desc
    hist_width = 3.0 * scl
    cos_t = torch.cos(theta) / hist_width
    sin_t = torch.sin(theta) / hist_width
    radius_f = torch.round(hist_width * _SQRT2 * 5.0 * 0.5)
    rad = torch.minimum(radius, radius_f.to(torch.int32))
    k4 = torch.arange(1, 5, device=dev, dtype=torch.float32)  # interior spatial bins
    ko = torch.arange(0, 9, device=dev, dtype=torch.float32)  # bin 9 is always empty
    for cls in torch.unique(radius[valid]).tolist():
        rows = torch.nonzero(valid & (radius == cls))[:, 0]
        side = 2 * cls + 1
        step = max(1, _CHUNK_ELEMS // (16 * side * side))
        for start in range(0, rows.numel(), step):
            idx = rows[start : start + step]
            sel = lambda t: t[idx]  # noqa: E731
            mag, ang, inside, ii, jj = _window(
                atlas, octaves, sel(img), sel(octave), sel(layer), sel(row), sel(col),
                torch.full_like(idx, cls, dtype=torch.int32), n_layers)
            r_eff = sel(rad)[:, None]
            in_radius = (ii.abs()[None, :] <= r_eff) & (jj.abs()[None, :] <= r_eff)
            ct, st = sel(cos_t)[:, None], sel(sin_t)[:, None]
            c_rot = jj * ct - ii * st
            r_rot = jj * st + ii * ct
            rbin = r_rot + 2.0 - 0.5
            cbin = c_rot + 2.0 - 0.5
            ok = (inside & in_radius & (rbin > -1.0) & (rbin < 4.0) & (cbin > -1.0)
                  & (cbin < 4.0))
            obin = (ang - sel(theta)[:, None]) * _BINS_PER_RAD_8
            wgt = torch.exp((c_rot * c_rot + r_rot * r_rot) * -0.125)
            m = mag * wgt * ok.to(torch.float32)
            pos_o = obin - 8.0 * torch.floor(obin * 0.125)
            hr = _hat((rbin + 1.0)[:, None, :] - k4[None, :, None])  # (n, 4, P)
            hc = _hat((cbin + 1.0)[:, None, :] - k4[None, :, None])
            wrc = (hr[:, :, None, :] * hc[:, None, :, :]).reshape(idx.numel(), 16, -1)
            a = _round_like(wrc * m[:, None, :], atlas.dtype)
            wo = _round_like(_hat(pos_o[:, None, :] - ko[None, :, None]), atlas.dtype)
            hist = torch.bmm(a, wo.transpose(1, 2))  # (n, 16, 9)
            vec = torch.cat([hist[:, :, :1] + hist[:, :, 8:9], hist[:, :, 1:8]], dim=2)
            desc[idx] = vec.reshape(idx.numel(), 128)
    thr = torch.sqrt((desc * desc).sum(dim=1, keepdim=True)) * 0.2
    desc = torch.minimum(desc, thr)
    scale = 512.0 / torch.clamp_min(torch.sqrt((desc * desc).sum(dim=1, keepdim=True)), 1e-12)
    desc = torch.round(torch.clamp_max(desc * scale, 255.0))
    return torch.where(valid[:, None], desc, 0.0)


_ATLAS_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float8_e4m3fn": torch.float8_e4m3fn}


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
    # Run the pyramid's blurs in TF32 (the control's precision; the
    # configuration states float32 with TF32 off).
    pyramid_tf32: bool = False

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
            levels.append(gaussian_blur_batch(levels[-1], sigs[i], allow_tf32=cfg.pyramid_tf32))
        g = torch.stack(levels, dim=1)
        gauss_octaves.append(g)
        dog_octaves.append(g[:, 1:] - g[:, :-1])
        # next octave base: level n_octave_layers, every second pixel
        current = levels[cfg.n_octave_layers][:, ::2, ::2].contiguous()
    return gauss_octaves, dog_octaves


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
    ref = refine_reference(
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
    gauss, dog = _build_pyramids(
        gaussian_blur_batch(up, sig_diff, allow_tf32=cfg.pyramid_tf32), cfg)
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

    theta, theta2, has_second = orientation_reference(
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

    desc = descriptor_reference(
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


def _apply_root_sift(desc: torch.Tensor) -> torch.Tensor:
    """Hellinger map: L1-normalise (+1e-7), then the square root."""
    return torch.sqrt(desc / (desc.sum(dim=-1, keepdim=True) + 1e-7))


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


def _resize_linear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` for a
    2-D uint8 or float32 image, without OpenCV.

    uint8 follows OpenCV's fixed-point path: f32 positions, 11-bit
    weights, int32 horizontal sums, and the vertical blend of its SIMD
    loop, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)`` rounded by
    ``(+2) >> 2``; rows past an edge are clamped but keep their weight, as
    OpenCV's generic path does. float32 blends in float64 with both axes'
    edge weights zeroed and rounds once, which is what OpenCV's build with
    Intel IPP returns to within 3e-5 at 0..255 scale.
    """
    h, w = img.shape
    if (h, w) == (nh, nw):
        return img.copy()
    if img.dtype == np.uint8:
        sx, sx1, fx = _edge_taps(w, nw, np.float32)
        sy, fy = _linear_taps(h, nh)
        sy0, sy1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
        one, coef = np.float32(1.0), np.float32(2048)
        ax0 = np.rint((one - fx) * coef).astype(np.int32)
        ax1 = np.rint(fx * coef).astype(np.int32)
        by0 = np.rint((one - fy) * coef).astype(np.int32)[:, None]
        by1 = np.rint(fy * coef).astype(np.int32)[:, None]
        src = img.astype(np.int32)
        rows = src[:, sx] * ax0 + src[:, sx1] * ax1
        out = (((rows[sy0] >> 4) * by0) >> 16) + (((rows[sy1] >> 4) * by1) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    sx, sx1, fx = _edge_taps(w, nw, np.float64)
    sy, sy1, fy = _edge_taps(h, nh, np.float64)
    src = img.astype(np.float64)
    rows = src[:, sx] * (1.0 - fx) + src[:, sx1] * fx
    return (rows[sy] * (1.0 - fy)[:, None] + rows[sy1] * fy[:, None]).astype(np.float32)


def _letterbox(gray: np.ndarray, size: int) -> np.ndarray:
    """Host-side: scale the longest side to ``size`` (INTER_LINEAR) and
    zero-pad to a square. uint8 stays uint8, so one byte per pixel crosses
    to the device; anything else becomes float32."""
    h, w = gray.shape
    s = size / max(h, w)
    nh, nw = max(1, round(h * s)), max(1, round(w * s))
    if gray.dtype != np.uint8:
        gray = gray.astype(np.float32)
    out = np.zeros((size, size), gray.dtype)
    out[:nh, :nw] = _resize_linear(gray, nh, nw)
    return out


def _to_gray_u8(image: np.ndarray) -> np.ndarray:
    """RGB/gray -> uint8 grayscale, matching OpenCV's RGB2GRAY weights."""
    if image.ndim == 3:
        g = image[..., 0] * 0.299 + image[..., 1] * 0.587 + image[..., 2] * 0.114
        return np.round(g).astype(np.uint8)
    return image.astype(np.uint8)


def describe(images, cfg: SiftConfig, device, root_sift: bool = True, batch: int = 16) -> tuple:
    """``(desc (B, max_keypoints, 128), mask (B, max_keypoints))`` float32 on
    ``device`` for a list or array of uint8 RGB images: gray and letterbox
    on the host, the core on ``device`` in calls of ``batch`` images, then
    the Hellinger map where ``root_sift``, as ``RootSIFT`` runs them."""
    descs, masks = [], []
    for start in range(0, len(images), batch):
        chunk = np.stack([_letterbox(_to_gray_u8(np.asarray(img)), cfg.process_size)
                          for img in images[start:start + batch]])
        with torch.inference_mode():
            out = _sift_core(torch.from_numpy(chunk).to(device), cfg)
            desc = out["desc"]
            if root_sift:
                desc = _apply_root_sift(desc) * out["mask"][..., None]
        descs.append(desc)
        masks.append(out["mask"])
    return torch.cat(descs), torch.cat(masks)
