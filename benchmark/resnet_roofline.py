"""The convs of a ResNet trunk and their least time, from a configuration's
``resnet`` key.

``convs`` walks the trunk from its shapes alone: the 7x7/2 stem, then each
stage's bottlenecks (1x1, 3x3 with the stage's stride, 1x1 to
``expansion`` times the width, and a 1x1 projection shortcut where the
shape changes), each conv with its input side and the route the
configuration's routing window gives it. ``conv_least_s`` counts a conv
in the style of ``roofline.conv_least_s``: its multiply-adds at its
route's peak, or its bytes at the HBM rate, whichever is larger, where
the bytes are the bfloat16 input map read once, the weights read once at
the route's width (with an int8 conv's float32 scales), BatchNorm's four
float32 parameters, the bfloat16 output written once (the stem's after
its 3x3/2 max pool) and, for the conv that ends a bottleneck, the
residual map read once. Nothing here reads the program.
"""
from __future__ import annotations

from benchmark.roofline import BYTES, least_s

_ACT = BYTES["bfloat16"]


def _route(cfg: dict, side: int, cin: int) -> str:
    """The precision of a block conv whose input is ``side`` square with
    ``cin`` channels: int8 inside the routing window, else bfloat16."""
    r = cfg["resnet"]
    return "int8" if r["int8_min_spatial"] <= side <= r["int8_max_spatial"] and cin >= 64 \
        else "bfloat16"


def _out(side: int, k: int, stride: int) -> int:
    return (side + 2 * (k // 2) - k) // stride + 1


def convs(cfg: dict, image_size: int | None = None) -> list[dict]:
    """Every conv of the trunk, in the order a forward runs them: ``name``
    (torchvision's module name), ``bn`` (its BatchNorm's), ``cin``,
    ``cout``, ``k``, ``stride``, ``side`` (input) and ``out`` (output,
    before the stem's pool), ``route``, ``residual`` (it ends a
    bottleneck, whose shortcut it adds) and ``pool`` (the stem's max pool
    follows)."""
    r = cfg["resnet"]
    side = image_size or r["image_size"]
    out = [{"name": "conv1", "bn": "bn1", "cin": 3, "cout": 64, "k": 7, "stride": 2,
            "side": side, "out": _out(side, 7, 2), "route": "bfloat16", "residual": False,
            "pool": True}]
    side = _out(_out(side, 7, 2), 3, 2)
    cin = 64
    for s, (n_blocks, width) in enumerate(zip(r["blocks"][:r["n_stages"]], r["stage_widths"])):
        cout = width * r["expansion"]
        for b in range(n_blocks):
            stride = 2 if s > 0 and b == 0 else 1
            pre = f"layer{s + 1}.{b}"
            mid = _out(side, 3, stride)
            block = [(f"{pre}.conv1", f"{pre}.bn1", cin, width, 1, 1, side),
                     (f"{pre}.conv2", f"{pre}.bn2", width, width, 3, stride, side),
                     (f"{pre}.conv3", f"{pre}.bn3", width, cout, 1, 1, mid)]
            if stride != 1 or cin != cout:
                block.append((f"{pre}.downsample.0", f"{pre}.downsample.1", cin, cout, 1,
                              stride, side))
            for name, bn, ci, co, k, st, sd in block:
                out.append({"name": name, "bn": bn, "cin": ci, "cout": co, "k": k, "stride": st,
                            "side": sd, "out": _out(sd, k, st), "route": _route(cfg, sd, ci),
                            "residual": name.endswith("conv3"), "pool": False})
            side, cin = mid, cout
    return out


def conv_macs(c: dict) -> int:
    """One image's multiply-adds of one conv."""
    return c["out"] ** 2 * c["k"] ** 2 * c["cin"] * c["cout"]


def conv_bytes(c: dict) -> int:
    """One image's bytes of one conv, fused with its BatchNorm, ReLU,
    residual add and (the stem) max pool."""
    written = _out(c["out"], 3, 2) if c["pool"] else c["out"]
    n = (_ACT * c["side"] ** 2 * c["cin"] + BYTES[c["route"]] * c["k"] ** 2 * c["cin"] * c["cout"]
         + 16 * c["cout"] + _ACT * written ** 2 * c["cout"])
    if c["route"] == "int8":
        n += 4 * c["cout"]
    if c["residual"]:
        n += _ACT * c["out"] ** 2 * c["cout"]
    return n


def conv_least_s(c: dict) -> float:
    """One image's least time of one conv at its route."""
    return least_s(2 * conv_macs(c), conv_bytes(c), c["route"])


def trunk_least_s(cfg: dict) -> float:
    """One image's least time of the whole trunk."""
    return sum(conv_least_s(c) for c in convs(cfg))

