"""Seeded photograph-like images and the seed streams of a run.

Extends ``chip_smoke.py:structured_images`` and
``pyvisim_tpu_torch/datasets/synthetic.py`` (commit ede8601), whose 8x8
colour blocks and grey blobs are too plain for SIFT: each image is a
texture with a 1/f amplitude spectrum, correlated across the colour
channels as a photograph's are, under a few hard-edged ellipses and
rectangles of one colour each. Images are drawn on the given device from a
``torch.Generator`` in a few large calls and returned as host uint8
``(n, H, W, 3)`` arrays, the form a user hands the encoders.
"""
from __future__ import annotations

import numpy as np
import torch

# One stream of random numbers per purpose, so that adding a purpose later
# moves none of the others.
STREAMS = {"weights": 1, "vocabulary": 2, "pool": 3, "gallery_rows": 4, "order": 5,
           "check": 6, "arrivals": 7}
_SHAPES = 12
# The amplitude spectrum falls as 1/f**_SLOPE: photographs lie near 1 to 1.5.
_SLOPE = 1.4
_CHUNK = 16


def generator(seed: int, stream: str, device="cpu") -> torch.Generator:
    """The generator of one purpose of a run, on ``device``."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + STREAMS[stream]) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator of one purpose of a run, for host-side choices."""
    return np.random.default_rng([int(seed) % (1 << 63), STREAMS[stream]])


def _texture(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 3, h, w) float32 texture with a 1/f amplitude spectrum, zero mean
    and unit deviation per image; the channels share most of their
    luminance, as a photograph's do."""
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = f ** -_SLOPE
    amp[0, 0] = 0.0
    spec = torch.randn((n, 2, h, w // 2 + 1, 2), generator=gen, device=device)
    spec = torch.view_as_complex(spec) * amp
    planes = torch.fft.irfft2(spec, s=(h, w))  # (n, 2, h, w): luminance, chroma
    planes = planes / planes.flatten(2).std(dim=2)[..., None, None]
    lum, chroma = planes[:, 0], planes[:, 1]
    tint = torch.rand((n, 3), generator=gen, device=device) - 0.5
    rgb = lum[:, None] + tint[:, :, None, None] * chroma[:, None]
    return rgb / rgb.flatten(1).std(dim=1)[:, None, None, None]


def _shapes(gen: torch.Generator, img: torch.Tensor) -> torch.Tensor:
    """Paint ``_SHAPES`` ellipses and rectangles of one colour over each
    image of ``img (n, 3, h, w)`` (0..255), at random places and sizes."""
    n, _, h, w = img.shape
    dev = img.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    params = torch.rand((_SHAPES, n, 8), generator=gen, device=dev)
    for p in params:
        cy, cx = p[:, 0, None, None] * h, p[:, 1, None, None] * w
        ry = 6.0 + p[:, 2, None, None] * h * 0.16
        rx = 6.0 + p[:, 3, None, None] * w * 0.16
        dy, dx = (ys - cy) / ry, (xs - cx) / rx
        ellipse = dy * dy + dx * dx < 1.0
        rect = (dy.abs() < 1.0) & (dx.abs() < 1.0)
        inside = torch.where(p[:, 4, None, None] < 0.5, ellipse, rect)
        colour = p[:, 5:8] * 255.0
        # The shape keeps part of the texture under it, as a lit surface does.
        img = torch.where(inside[:, None], colour[:, :, None, None] + 0.35 * (img - 118.0), img)
    return img


def photo_batch(seed: int, stream: str, n: int, height: int, width: int,
                device="cpu", first: int = 0) -> np.ndarray:
    """``n`` uint8 RGB images ``(n, height, width, 3)`` of one stream.

    The images are drawn in chunks of 16 on ``device``; image ``first + i``
    of a stream is the same whatever ``n`` and ``first`` are, since each
    chunk has a generator of its own."""
    out = np.empty((n, height, width, 3), np.uint8)
    for chunk in range(first // _CHUNK, -(-(first + n) // _CHUNK)):
        gen = generator(seed * 1009 + chunk, stream, device)
        tex = _texture(gen, _CHUNK, height, width, device)
        img = _shapes(gen, 118.0 + 44.0 * tex)
        img = torch.clamp(torch.round(img), 0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        lo, hi = max(first, chunk * _CHUNK), min(first + n, (chunk + 1) * _CHUNK)
        out[lo - first:hi - first] = img[lo - chunk * _CHUNK:hi - chunk * _CHUNK].cpu().numpy()
    return out
