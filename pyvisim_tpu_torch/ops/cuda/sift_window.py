"""SIFT keypoint kernels: candidate refinement, orientation and descriptor.
The CUDA kernels' wrappers and their plain PyTorch versions.

The kernels (``csrc/sift_window.cu``) replace the TPU kernels of
``pyvisim_tpu/ops/pallas/sift_window.py``: ``refine`` replaces
``_refine_gather_kernel`` (``refine_gather_pass``) with the math of
``pyvisim_tpu/ops/sift.py:_refine_candidates`` that consumes its windows,
``orientation`` replaces ``_ori_kernel`` (``orientation_window_pass``) and
``descriptor`` replaces ``_desc_kernel_gang``/``_desc_kernel``
(``descriptor_window_pass``). The TPU kernels gather row-folded windows
with DMAs because Mosaic cannot gather; on this card each candidate's
block reads its window straight from the DoG or the atlas, so the folds,
lane alignment and chunk skipping of the JAX package have no counterpart.

Bound: all three read small windows of large tensors and do a few tens of
operations per value read, so the bytes of the windows bound them (see
the source). ``refine`` takes the candidates of every octave of a SIFT
call at once and launches its kernel once for all of them. Each wrapper
takes its plain version for CPU tensors and launches its kernel for CUDA
tensors, and counts the launches in ``.launches``.

The plain versions are ports of the JAX package's XLA path
(``_refine_candidates``, ``_orientation``, ``_descriptor``). The refinement
and the orientation repeat the kernels' float arithmetic operation for
operation, the histogram sums in the kernels' order, so on the card kernel
and plain version agree bit for bit; the descriptor's plain version
contracts its histogram with a batched matmul as the JAX package does, so
its f32 sums run in another order.

The gradient atlas both window kernels read is one flat tensor (bf16 or
f32) holding, per octave ``o``, a ``(B, L, H, W, 2)`` region (magnitude,
angle) at element ``octaves[o, 0]``, with ``H = octaves[o, 1]`` and
``W = octaves[o, 2]``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ._build import load_library
from .aggregate import launch_target

__all__ = [
    "Refined",
    "refine",
    "refine_reference",
    "orientation",
    "orientation_reference",
    "descriptor",
    "descriptor_reference",
]

# Image scales of OpenCV's adjustLocalExtrema, as the kernel's f32 constants.
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


def _library() -> ctypes.CDLL:
    lib = load_library("sift_window")
    if not getattr(lib, "_pyvisim_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sift_refine_f32.argtypes = [ptr, i32] + [ptr] * 8 + [i32] * 4 + [f32, f32, i32, ptr]
        lib.sift_refine_f32.restype = i32
        i64 = ctypes.c_longlong
        lib.sift_orientation.argtypes = ([ptr, i32, ptr, i32] + [ptr] * 11
                                         + [i32, i32, i64, i32, ptr])
        lib.sift_orientation.restype = i32
        lib.sift_descriptor.argtypes = ([ptr, i32, ptr, i32] + [ptr] * 10
                                        + [i32, i32, i64, i32, ptr])
        lib.sift_descriptor.restype = i32
        lib.sift_error_string.argtypes = [i32]
        lib.sift_error_string.restype = ctypes.c_char_p
        lib._pyvisim_typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: {lib.sift_error_string(err).decode()} ({err})")


_PER_ITEM = {"img", "octave", "layer", "row", "col", "scl", "theta", "radius", "valid"}
_I32, _F32, _BOOL = (torch.int32,), (torch.float32,), (torch.bool,)
_ATLAS = (torch.bfloat16, torch.float32)
# Octaves one refinement launch takes (the kernel's parameter table).
_MAX_OCTAVES = 16
# Histogram weights the descriptor's plain version holds at once.
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


# ---------------------------------------------------------------------------
# Refinement
# ---------------------------------------------------------------------------
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


def refine(
    dogs, img, layer, row, col, valid, *, counts, n_layers: int, steps: int, reach: int,
    contrast_threshold: float, edge_threshold: float,
) -> Refined:
    """Subpixel refinement of DoG extrema, every octave in one call.

    ``dogs`` the octaves' ``(B, n_layers + 2, H, W)`` f32 DoGs (0..255
    scale), at most 16; ``counts`` the number of candidates of each octave,
    which lie octave after octave; per candidate the image ``img``,
    ``layer`` in 1..n_layers, ``row``, ``col`` (int32) and ``valid``
    (bool). CPU tensors take :func:`refine_reference`; CUDA tensors launch
    the kernel once, one thread per candidate.
    """
    n = _check_refine(dogs, img, layer, row, col, valid, counts, n_layers)
    kw = dict(n_layers=n_layers, steps=steps, reach=reach,
              contrast_threshold=contrast_threshold, edge_threshold=edge_threshold)
    if img.device.type == "cpu":
        return refine_reference(dogs, img, layer, row, col, valid, counts=counts, **kw)
    if any(dog.numel() >= 2**62 for dog in dogs) or n >= 2**31:
        raise ValueError(f"DoG or candidates too large for the kernel: {n} candidates")
    # One allocation: (layer, row, col) int32, (xr, xc, xi, contrast) f32, ok.
    out = torch.empty((8, n), dtype=torch.int32, device=img.device)
    ok = out[7].view(torch.uint8)[:n].view(torch.bool)
    if n:
        lib = _library()
        index, stream = launch_target(img.device)
        table = (ctypes.c_longlong * (4 * len(dogs)))(
            *(dog.data_ptr() for dog in dogs), *(dog.shape[2] for dog in dogs),
            *(dog.shape[3] for dog in dogs), *counts)
        err = lib.sift_refine_f32(
            table, len(dogs), img.data_ptr(), layer.data_ptr(), row.data_ptr(), col.data_ptr(),
            valid.data_ptr(), out.data_ptr(), out[3].data_ptr(), ok.data_ptr(),
            dogs[0].shape[0], n_layers, steps, reach, contrast_threshold, edge_threshold,
            index, stream,
        )
        _raise_on(lib, err, "SIFT refinement")
        refine.launches += 1
    return Refined(*out[:3].unbind(), *out[3:7].view(torch.float32).unbind(), ok)


refine.launches = 0


# ---------------------------------------------------------------------------
# Windows of the gradient atlas
# ---------------------------------------------------------------------------
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


def orientation(atlas, octaves, img, octave, layer, row, col, scl, radius, valid,
                *, n_layers: int):
    """Dominant gradient orientation of each keypoint (radians,
    atan2(dy, dx) with y up), the strongest secondary peak >= 0.8 of the
    maximum and whether it exists: ``(theta, theta2, has_second)``.

    The window is ``|ii|, |jj| <= min(radius, round(4.5 * scl))``, where
    ``radius`` is the keypoint's radius class. CPU tensors take
    :func:`orientation_reference`; CUDA tensors launch the kernel, one
    warp per keypoint.
    """
    n = _check_window(atlas, octaves, img=img, octave=octave, layer=layer, row=row, col=col,
                      scl=scl, radius=radius, valid=valid)
    if atlas.device.type == "cpu":
        return orientation_reference(atlas, octaves, img, octave, layer, row, col, scl, radius,
                                     valid, n_layers=n_layers)
    theta = torch.empty((n,), dtype=torch.float32, device=atlas.device)
    theta2 = torch.empty_like(theta)
    has_second = torch.empty((n,), dtype=torch.bool, device=atlas.device)
    if n:
        lib = _library()
        index, stream = launch_target(atlas.device)
        err = lib.sift_orientation(
            atlas.data_ptr(), int(atlas.dtype == torch.bfloat16), octaves.data_ptr(),
            octaves.shape[0], img.data_ptr(), octave.data_ptr(), layer.data_ptr(),
            row.data_ptr(), col.data_ptr(), scl.data_ptr(), radius.data_ptr(), valid.data_ptr(),
            theta.data_ptr(), theta2.data_ptr(), has_second.data_ptr(), n, n_layers,
            atlas.numel(), index, stream,
        )
        _raise_on(lib, err, "SIFT orientation")
        orientation.launches += 1
    return theta, theta2, has_second


orientation.launches = 0


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


def descriptor(atlas, octaves, img, octave, layer, row, col, scl, theta, radius, valid,
               *, n_layers: int):
    """128-D SIFT descriptors (OpenCV calcSIFTDescriptor: rotated 4x4x8
    trilinear histogram, clip at 0.2, rescale to 512, cap at 255, round);
    zeros for invalid keypoints. ``radius`` is each keypoint's radius class.
    CPU tensors take :func:`descriptor_reference`; CUDA tensors launch the
    kernel, one block of 128 threads per keypoint."""
    n = _check_window(atlas, octaves, img=img, octave=octave, layer=layer, row=row, col=col,
                      scl=scl, theta=theta, radius=radius, valid=valid)
    if atlas.device.type == "cpu":
        return descriptor_reference(atlas, octaves, img, octave, layer, row, col, scl, theta,
                                    radius, valid, n_layers=n_layers)
    desc = torch.empty((n, 128), dtype=torch.float32, device=atlas.device)
    if n:
        lib = _library()
        index, stream = launch_target(atlas.device)
        err = lib.sift_descriptor(
            atlas.data_ptr(), int(atlas.dtype == torch.bfloat16), octaves.data_ptr(),
            octaves.shape[0], img.data_ptr(), octave.data_ptr(), layer.data_ptr(),
            row.data_ptr(), col.data_ptr(), scl.data_ptr(), theta.data_ptr(), radius.data_ptr(),
            valid.data_ptr(), desc.data_ptr(), n, n_layers, atlas.numel(), index, stream,
        )
        _raise_on(lib, err, "SIFT descriptor")
        descriptor.launches += 1
    return desc


descriptor.launches = 0
