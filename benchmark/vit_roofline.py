"""The ops of a ViT trunk to one block's facet and their least time, from a
configuration's ``vit`` key.

``ops`` walks one image's forward from its shapes alone: the patch
embedding, the CLS token and position embedding, blocks ``0 .. layer-1``
and the facet of block ``layer``. Each op is priced on its own, as the
program runs it: its floating-point operations at the bf16 peak, or its
bytes at the HBM rate, whichever is longer (``roofline.least_s``). A
linear reads its bfloat16 input, weight and bias once and writes its
bfloat16 output once; attention reads q, k and v and writes its output
once (4 N^2 D operations a block: the scores and their product with v);
a LayerNorm reads its map and writes it, with its two parameters; the
LayerScale plus residual add reads both maps and gamma and writes one;
SwiGLU's ``silu(x1) * x2`` reads the two halves and writes one (GELU reads
and writes its map); the embedding reads the image once and writes the
tokens once. Nothing here reads the program.
"""
from __future__ import annotations

from benchmark.roofline import BYTES, least_s

_ACT = BYTES["bfloat16"]


def _op(name: str, flops: float, n_bytes: float) -> dict:
    return {"name": name, "flops": flops, "bytes": n_bytes}


def _linear(name: str, n: int, din: int, dout: int) -> dict:
    return _op(name, 2 * n * din * dout, _ACT * (n * din + din * dout + dout + n * dout))


def _elementwise(name: str, n_read: int, n_written: int, params: int = 0) -> dict:
    return _op(name, 0, _ACT * (n_read + n_written + params))


def block_ops(cfg: dict, i: int = 0) -> list[dict]:
    """One image's ops of one whole block, in the order a forward runs them."""
    v = cfg["vit"]
    n, d, h = v["tokens"], v["embed_dim"], v["ffn_hidden"]
    pre = f"blocks.{i}"
    out = [_elementwise(f"{pre}.norm1", n * d, n * d, 2 * d),
           _linear(f"{pre}.attn.qkv", n, d, 3 * d),
           _op(f"{pre}.attn.core", 4 * n * n * d, _ACT * 4 * n * d),
           _linear(f"{pre}.attn.proj", n, d, d),
           _elementwise(f"{pre}.ls1", 2 * n * d, n * d, d),
           _elementwise(f"{pre}.norm2", n * d, n * d, 2 * d)]
    if v["ffn"] == "swiglu":
        out += [_linear(f"{pre}.mlp.w12", n, d, 2 * h),
                _elementwise(f"{pre}.mlp.swiglu", 2 * n * h, n * h),
                _linear(f"{pre}.mlp.w3", n, h, d)]
    else:
        out += [_linear(f"{pre}.mlp.fc1", n, d, h),
                _elementwise(f"{pre}.mlp.gelu", n * h, n * h),
                _linear(f"{pre}.mlp.fc2", n, h, d)]
    return out + [_elementwise(f"{pre}.ls2", 2 * n * d, n * d, d)]


def ops(cfg: dict) -> list[dict]:
    """One image's ops of the whole trunk, in the order a forward runs them."""
    v = cfg["vit"]
    n, d, p, s, g = v["tokens"], v["embed_dim"], v["patch_size"], v["image_size"], v["grid"]
    out = [_op("patch_embed.proj", 2 * g * g * 3 * p * p * d,
               _ACT * (3 * s * s + 3 * p * p * d + d + g * g * d)),
           _elementwise("pos_embed", g * g * d + d, n * d, n * d)]
    for i in range(v["layer"]):
        out += block_ops(cfg, i)
    pre, patches = f"blocks.{v['layer']}", g * g
    if v["facet"] == "token":
        return out + block_ops(cfg, v["layer"])
    return out + [_elementwise(f"{pre}.norm1", patches * d, patches * d, 2 * d),
                  _linear(f"{pre}.attn.qkv.{v['facet']}", patches, d, d)]


def op_least_s(op: dict) -> float:
    return least_s(op["flops"], op["bytes"], "bfloat16")


def trunk_least_s(cfg: dict) -> float:
    """One image's least time of the whole trunk."""
    return sum(op_least_s(op) for op in ops(cfg))


def attention_least_s(cfg: dict) -> float:
    """One image's least time of the attention cores of the forward: 4 N^2 D
    operations a block at the bf16 peak, or q, k, v and the output moved
    once."""
    return sum(op_least_s(op) for op in ops(cfg) if op["name"].endswith(".attn.core"))
