"""DINOv3 ViT-7B/16 to its final norm -> VLAD, as the program runs it:
``DeepConvFeature(module=ViTTrunk(...))`` in bfloat16 under ``VLADEncoder``.

``build`` opens the range ``bench.attention`` around each block's attention
core (``Attention.core``: the fused kernel alone) and ``bench.rope`` around
its RoPE rotation (``Attention.rotate``: the one in-place pass over qkv's q
and k thirds), only while a profiler is recording, so that an untraced run
pays one flag read a call. The trunk is made on the meta device and takes
the drawn weights as its parameters, so the card holds one copy of the
13.4 GB of weights, which the reference reads after the window."""
from __future__ import annotations

import math

import torch

from benchmark import images, trace

FEATURES = "extract_batch"
# Parameters drawn U(0.5, 1.5): the LayerNorms' weights.
_NORM_WEIGHTS = ("norm1.weight", "norm2.weight", "norm.weight")


def shapes(cfg: dict) -> dict:
    """``{name: shape}`` of every parameter the trunk holds, under the port's
    names (DINOv3's, with ``mlp.w1`` and ``mlp.w2`` stacked as ``mlp.w12``):
    the patch embedding, CLS and register tokens, the 40 blocks whole and
    the final norm."""
    v = cfg["dinov3"]
    d, p, h = v["embed_dim"], v["patch_size"], v["ffn_hidden"]
    out = {"cls_token": (1, 1, d),
           **({"storage_tokens": (1, v["registers"], d)} if v["registers"] else {}),
           "patch_embed.proj.weight": (d, 3, p, p), "patch_embed.proj.bias": (d,)}
    block = {"norm1.weight": (d,), "norm1.bias": (d,), "attn.qkv.weight": (3 * d, d),
             **({"attn.qkv.bias": (3 * d,)} if v["qkv_bias"] else {}),
             "attn.proj.weight": (d, d), "attn.proj.bias": (d,), "ls1.gamma": (d,),
             "norm2.weight": (d,), "norm2.bias": (d,), "mlp.w12.weight": (2 * h, d),
             "mlp.w12.bias": (2 * h,), "mlp.w3.weight": (d, h), "mlp.w3.bias": (d,),
             "ls2.gamma": (d,)}
    for i in range(v["depth"]):
        out.update({f"blocks.{i}.{k}": s for k, s in block.items()})
    return {**out, "norm.weight": (d,), "norm.bias": (d,)}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The trunk's state dict in bfloat16, drawn on ``device`` tensor by
    tensor from the seed's generator (see the configuration's
    ``assumed.weights``), each in float32 and rounded, so that no float32
    copy of the 6.7 B weights is ever held: weights of linears and the patch
    projection normal with variance 1 / fan_in, the q and k thirds of qkv
    times sqrt(2) (attention neither uniform nor one-hot), biases N(0, 0.1),
    LayerNorm weight U(0.5, 1.5) and bias N(0, 0.1), LayerScale U(0.2, 0.6),
    CLS and register tokens N(0, 1). A skipped block, a dropped rotation or
    a wrong angle then moves the descriptors."""
    d = cfg["dinov3"]["embed_dim"]
    gen = images.generator(seed, "weights", device)
    state = {}
    for name, shape in shapes(cfg).items():
        if name.endswith("gamma"):
            t = 0.2 + 0.4 * torch.rand(shape, generator=gen, device=device)
        elif name.endswith(_NORM_WEIGHTS):
            t = 0.5 + torch.rand(shape, generator=gen, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device)
            if name.endswith("bias"):
                t *= 0.1
            elif name.endswith("weight"):
                t /= math.sqrt(math.prod(shape[1:]))
                if name.endswith("qkv.weight"):
                    t[:2 * d] *= math.sqrt(2.0)
        state[name] = t.to(torch.bfloat16)
    return state


def _ranged(fn, name: str):
    """``fn`` inside the range ``bench.<name>`` while a profiler records,
    bare otherwise."""
    def call(*args):
        if not torch.autograd._profiler_enabled():
            return fn(*args)
        with torch.profiler.record_function(trace.PREFIX + name):
            return fn(*args)
    return call


def build(cfg: dict, weights: dict, centers: torch.Tensor, device):
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.models.vit import ViTSpec, ViTTrunk
    from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook

    v = cfg["dinov3"]
    spec = ViTSpec(v["embed_dim"], v["depth"], v["num_heads"], v["ffn"], v["ffn_hidden"],
                   patch=v["patch_size"], registers=v["registers"], position=v["position"],
                   ln_eps=v["layer_norm_eps"], qkv_bias=v["qkv_bias"])
    trunk = ViTTrunk(spec, facet=v["facet"], image_size=v["image_size"], device="meta",
                     dtype=torch.bfloat16)
    trunk.load_state_dict(weights, assign=True)
    for blk in trunk.blocks:
        blk.attn.core = _ranged(blk.attn.core, "attention")
        blk.attn.rotate = _ranged(blk.attn.rotate, "rope")
    ext = DeepConvFeature(module=trunk, dtype=torch.bfloat16, image_size=v["image_size"],
                          spatial_encoding=cfg["spatial_encoding"], device=device)
    vlad = cfg["vlad"]
    return VLADEncoder(ext, kmeans_model=KMeansCodebook(centers=centers),
                       power_norm_weight=vlad["power_norm_weight"],
                       norm_order=vlad["norm_order"], epsilon=vlad["epsilon"], device=device)
