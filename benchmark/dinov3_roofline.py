"""The ops of the DINOv3 trunk to the final norm of its patch tokens and
their least time, from a configuration's ``dinov3`` key.

``ops`` walks one image's forward from its shapes alone: the patch
embedding, the token sequence (CLS, the registers, the patches), every
block with its RoPE rotation between the qkv projection and attention, and
the final LayerNorm of the patch rows. Each op is priced on its own, by
the rules ``vit_roofline`` prices the ViT-g trunk's ops with (its
helpers): its operations at the bf16 peak, or its bytes at the HBM rate,
whichever is longer. The qkv projection carries a bias only where the
configuration says so. The rotation reads and writes the bfloat16 q and k
of the patch rows once, 4 bytes an entry; its float32 table (cos and sin
of ``P x hd / 2`` angles, 1.2 MB at 768^2, read once a call and shared by
every image of the batch and every head) is left out, under 0.1 % of a
16-image call's bytes. Nothing here reads the program.
"""
from __future__ import annotations

from benchmark.vit_roofline import _ACT, _elementwise, _linear, _op, op_least_s


def _patches(v: dict) -> int:
    return (v["image_size"] // v["patch_size"]) ** 2


def params(cfg: dict) -> int:
    """The parameters of the trunk: the patch projection, CLS and register
    tokens, the blocks and the final norm."""
    v = cfg["dinov3"]
    d, h, p = v["embed_dim"], v["ffn_hidden"], v["patch_size"]
    block = (2 * d + 3 * d * d + (3 * d if v["qkv_bias"] else 0) + d * d + d + d + 2 * d
             + 2 * h * d + 2 * h + h * d + d + d)
    return 3 * p * p * d + d + (1 + v["registers"]) * d + v["depth"] * block + 2 * d


def block_ops(cfg: dict, i: int = 0) -> list[dict]:
    """One image's ops of one block, in the order a forward runs them."""
    v = cfg["dinov3"]
    n, d, h, patches = v["tokens"], v["embed_dim"], v["ffn_hidden"], _patches(v)
    pre = f"blocks.{i}"
    qkv = (_linear(f"{pre}.attn.qkv", n, d, 3 * d) if v["qkv_bias"] else
           _op(f"{pre}.attn.qkv", 2 * n * d * 3 * d, _ACT * (n * d + 3 * d * d + 3 * n * d)))
    return [_elementwise(f"{pre}.norm1", n * d, n * d, 2 * d), qkv,
            _elementwise(f"{pre}.attn.rope", 2 * patches * d, 2 * patches * d),
            _op(f"{pre}.attn.core", 4 * n * n * d, _ACT * 4 * n * d),
            _linear(f"{pre}.attn.proj", n, d, d),
            _elementwise(f"{pre}.ls1", 2 * n * d, n * d, d),
            _elementwise(f"{pre}.norm2", n * d, n * d, 2 * d),
            _linear(f"{pre}.mlp.w12", n, d, 2 * h),
            _elementwise(f"{pre}.mlp.swiglu", 2 * n * h, n * h),
            _linear(f"{pre}.mlp.w3", n, h, d),
            _elementwise(f"{pre}.ls2", 2 * n * d, n * d, d)]


def ops(cfg: dict) -> list[dict]:
    """One image's ops of the whole trunk, in the order a forward runs them."""
    v = cfg["dinov3"]
    n, d, p, s, patches = (v["tokens"], v["embed_dim"], v["patch_size"], v["image_size"],
                           _patches(v))
    out = [_op("patch_embed.proj", 2 * patches * 3 * p * p * d,
               _ACT * (3 * s * s + 3 * p * p * d + d + patches * d)),
           _elementwise("tokens", patches * d + (n - patches) * d, n * d)]
    for i in range(v["depth"]):
        out += block_ops(cfg, i)
    return out + [_elementwise("norm", patches * d, patches * d, 2 * d)]


def _least_s(cfg: dict, suffix: str = "") -> float:
    return sum(op_least_s(op) for op in ops(cfg) if op["name"].endswith(suffix))


def trunk_least_s(cfg: dict) -> float:
    """One image's least time of the whole trunk."""
    return _least_s(cfg)


def attention_least_s(cfg: dict) -> float:
    """One image's least time of the attention cores: 4 N^2 D operations a
    block at the bf16 peak, or q, k, v and the output moved once."""
    return _least_s(cfg, ".attn.core")


def rope_least_s(cfg: dict) -> float:
    """One image's least time of the RoPE rotations: the patch rows' q and k
    read and written once a block at the HBM rate."""
    return _least_s(cfg, ".attn.rope")
