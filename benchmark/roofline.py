"""Peaks of the card and the least time of the work the cells do.

The peaks and the counting rules are copied from ``chip_smoke.py``
(``bound``, ``conv_bound``, ``query_bytes``) at commit ede8601, so that a
later change to the program cannot move them. Each count is worked out
from shapes and the precision a configuration states, never from a kernel
name or from the program's own state.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): 67 TFLOP/s float32 on the CUDA cores, 989 TFLOP/s bf16 and
1,979 TOP/s int8 on the tensor cores, 3.35 TB/s of HBM.
"""
from __future__ import annotations

import math

F32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12

PEAKS = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS, "int8": INT8_OPS}
BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def least_s(n_ops: float, n_bytes: float, precision: str = "float32") -> float:
    """The least time of ``n_ops`` operations at ``precision``'s peak and
    ``n_bytes`` moved at the HBM rate: the larger of the two."""
    return max(n_ops / PEAKS[precision], n_bytes / HBM_BYTES_PER_S)


def conv_layers(widths, image_size: int, pools_after) -> list[dict]:
    """The 3x3 SAME convs of a VGG trunk: ``widths`` the output channels of
    each conv, ``pools_after`` the indices of the convs a 2x2 pool follows.
    Each entry gives the conv's input side, Cin, Cout and whether it pools."""
    out, side, cin = [], image_size, 3
    for i, cout in enumerate(widths):
        out.append({"index": i, "side": side, "cin": cin, "cout": cout,
                    "pool": i in pools_after})
        if i in pools_after:
            side //= 2
        cin = cout
    return out


def conv_least_s(layer: dict, precision: str) -> float:
    """One image's least time of one fused conv (+ ReLU, + pool): its
    operations at the route's peak, or the bfloat16 input map read once,
    the weights read once and the (pooled) bfloat16 output written once
    (``conv_bound``)."""
    hw, cin, cout = layer["side"], layer["cin"], layer["cout"]
    ops = 2 * hw * hw * 9 * cin * cout
    out_hw = hw // 2 if layer["pool"] else hw
    act = BYTES["bfloat16"]
    n_bytes = (act * hw * hw * cin + BYTES[precision] * 9 * cin * cout + 8 * cout
               + act * out_hw * out_hw * cout)
    return least_s(ops, n_bytes, precision)


def trunk_least_s(cfg: dict, ops_only: bool = False) -> float:
    """One image's least time of a configuration's conv trunk, each conv at
    the peak of the precision its ``conv_precision`` entry states. With
    ``ops_only`` the bytes are not counted (operations alone)."""
    trunk = cfg["trunk"]
    total = 0.0
    for layer in conv_layers(trunk["widths"], trunk["image_size"], trunk["pools_after"]):
        prec = trunk["conv_precision"][layer["index"]]
        if ops_only:
            hw = layer["side"]
            total += 2 * hw * hw * 9 * layer["cin"] * layer["cout"] / PEAKS[prec]
        else:
            total += conv_least_s(layer, prec)
    return total


def vlad_least_s(b: int, n: int, n_valid: int, d: int, k: int) -> float:
    """A batch's least time of VLAD (``chip_smoke.py``'s count): the
    nearest-centre assignment and the residual sums of the ``n_valid``
    weighted rows and the normalisation, at the float32 rate, or the
    descriptors, weights and centres read once and the encodings written
    once."""
    n_ops = 2 * n_valid * k * d + 2 * n_valid * d + 2 * b * k * d
    n_bytes = 4 * (b * n * d + b * n + k * d + b * k * d)
    return least_s(n_ops, n_bytes, "float32")


def scan_least_s(rows: int, dim: int) -> float:
    """One query's least time of the exact float32 scan: every gallery row
    and the query read once, at the HBM rate (``query_bytes`` of the
    float32 route, rewritten from N and D)."""
    return (rows + 1) * dim * 4 / HBM_BYTES_PER_S


def _blur_taps(sigma: float) -> int:
    return 2 * int(3.0 * sigma) + 1


def sift_pyramid_least_s(cfg: dict) -> float:
    """One image's least time of the SIFT scale space: the separable blurs
    of every level (two passes of ``taps`` multiply-adds a pixel) at the
    float32 rate, or each level written once as float32; the larger of
    the two. A lower bound of the SIFT core: detection and the keypoint
    windows are not counted."""
    sift = cfg["extractor"]
    layers, sigma = sift["n_octave_layers"], sift["sigma"]
    base = sift["process_size"] * (2 if sift["upscale"] else 1)
    n_octaves = max(1, int(math.log2(base)) - 3)
    k = 2.0 ** (1.0 / layers)
    sigmas = [math.sqrt(max(sigma ** 2 - (1.0 if sift["upscale"] else 0.25), 0.01))]
    for i in range(1, layers + 3):
        prev = sigma * k ** (i - 1)
        sigmas.append(math.sqrt((prev * k) ** 2 - prev ** 2))
    ops = n_bytes = 0.0
    side = base
    for o in range(n_octaves):
        px = side * side
        blurs = sigmas if o == 0 else sigmas[1:]
        ops += sum(2 * 2 * _blur_taps(s) * px for s in blurs)
        n_bytes += 4 * px * (layers + 3) + 4 * px * (layers + 2)  # levels and DoGs written
        side //= 2
    return least_s(ops, n_bytes, "float32")


def features_least_s(cfg: dict) -> float:
    """One image's least time of a configuration's feature extractor."""
    if "trunk" in cfg:
        return trunk_least_s(cfg)
    return sift_pyramid_least_s(cfg)


def share_pct(least: float, measured: float) -> float | None:
    """``least / measured`` in percent; None where nothing was measured."""
    if measured is None or measured <= 0 or least is None:
        return None
    return 100.0 * least / measured
