"""DINOv2 ViT-g/14 to one block's facet -> VLAD, as the program runs it:
``DeepConvFeature(module=ViTTrunk(...))`` in bfloat16 under ``VLADEncoder``.

``build`` opens the range ``bench.attention`` around each block's attention
core (``Attention.core``: the fused kernel alone, not the qkv and output
projections), and only while a profiler is recording, so that an untraced
run pays one flag read a block."""
from __future__ import annotations

import math

import torch

from benchmark import images, trace

FEATURES = "extract_batch"


def shapes(cfg: dict) -> dict:
    """``{name: shape}`` of every parameter the trunk holds, under DINOv2's
    names: the patch embedding, CLS and position embedding, and blocks
    ``0 .. layer`` whole."""
    v = cfg["vit"]
    d, p, h = v["embed_dim"], v["patch_size"], v["ffn_hidden"]
    out = {"cls_token": (1, 1, d), "pos_embed": (1, 1 + v["grid"] ** 2, d),
           "patch_embed.proj.weight": (d, 3, p, p), "patch_embed.proj.bias": (d,)}
    ffn = ({"mlp.w12.weight": (2 * h, d), "mlp.w12.bias": (2 * h,), "mlp.w3.weight": (d, h),
            "mlp.w3.bias": (d,)} if v["ffn"] == "swiglu" else
           {"mlp.fc1.weight": (h, d), "mlp.fc1.bias": (h,), "mlp.fc2.weight": (d, h),
            "mlp.fc2.bias": (d,)})
    block = {"norm1.weight": (d,), "norm1.bias": (d,), "attn.qkv.weight": (3 * d, d),
             "attn.qkv.bias": (3 * d,), "attn.proj.weight": (d, d), "attn.proj.bias": (d,),
             "ls1.gamma": (d,), "norm2.weight": (d,), "norm2.bias": (d,),
             **ffn, "ls2.gamma": (d,)}
    for i in range(v["layer"] + 1):
        out.update({f"blocks.{i}.{k}": s for k, s in block.items()})
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The trunk's state dict in bfloat16, drawn on ``device`` in two draws
    of the seed's generator (see the configuration's ``assumed.weights``):
    weights of linears and the patch projection normal with variance
    1 / fan_in, the q and k thirds of qkv times sqrt(2) (attention neither
    uniform nor one-hot), biases N(0, 0.1), LayerNorm weight U(0.5, 1.5)
    and bias N(0, 0.1), LayerScale U(0.2, 0.6), CLS N(0, 1), position
    embedding N(0, 0.2). A skipped block, a dropped LayerScale or a wrong
    softmax scale then moves the descriptors."""
    d = cfg["vit"]["embed_dim"]
    named = shapes(cfg)
    gen = images.generator(seed, "weights", device)
    flat = torch.empty(sum(math.prod(s) for s in named.values()), device=device)
    flat.normal_(generator=gen)
    uniform = torch.rand(sum(math.prod(s) for k, s in named.items()
                             if k.endswith(("gamma", "norm1.weight", "norm2.weight"))),
                         generator=gen, device=device)
    state, pos, at = {}, 0, 0
    for name, shape in named.items():
        n = math.prod(shape)
        if name.endswith(("gamma", "norm1.weight", "norm2.weight")):
            u = uniform[at:at + n].view(shape)
            at += n
            t = 0.2 + 0.4 * u if name.endswith("gamma") else 0.5 + u
        else:
            t = flat[pos:pos + n].view(shape)
            pos += n
            if name == "pos_embed":
                t = 0.2 * t
            elif name.endswith("bias"):
                t = 0.1 * t
            elif name.endswith("weight"):
                t = t / math.sqrt(math.prod(shape[1:]))
                if name.endswith("qkv.weight"):
                    t = torch.cat([t[:2 * d] * math.sqrt(2.0), t[2 * d:]])
        state[name] = t.to(torch.bfloat16)
    return state


def _ranged(core):
    """``core`` inside the range ``bench.attention`` while a profiler
    records, bare otherwise."""
    def call(q, k, v):
        if not torch.autograd._profiler_enabled():
            return core(q, k, v)
        with torch.profiler.record_function(trace.PREFIX + "attention"):
            return core(q, k, v)
    return call


def build(cfg: dict, weights: dict, centers: torch.Tensor, device):
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.models.vit import ViTSpec, ViTTrunk
    from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook

    v = cfg["vit"]
    spec = ViTSpec(v["embed_dim"], v["depth"], v["num_heads"], v["ffn"], v["ffn_hidden"])
    trunk = ViTTrunk(spec, layer=v["layer"], facet=v["facet"], image_size=v["image_size"],
                     device=device, dtype=torch.bfloat16)
    for blk in trunk.blocks:
        blk.attn.core = _ranged(blk.attn.core)
    ext = DeepConvFeature(module=trunk, params=weights, dtype=torch.bfloat16,
                          image_size=v["image_size"], spatial_encoding=cfg["spatial_encoding"],
                          device=device)
    vlad = cfg["vlad"]
    return VLADEncoder(ext, kmeans_model=KMeansCodebook(centers=centers),
                       power_norm_weight=vlad["power_norm_weight"],
                       norm_order=vlad["norm_order"], epsilon=vlad["epsilon"], device=device)
