"""The counts of ``benchmark/dinov3_roofline.py`` against hand-worked values,
and its four readers."""
import math

import pytest

from benchmark import dinov3_roofline, readers, run
from benchmark.systems import dinov3_vit7b16 as system
from benchmark.tests.conftest import tiny_vgg

# DINOv3 ViT-7B/16 at 768^2: tokens (CLS + 4 registers + 48^2 patches),
# patches, width, SwiGLU's hidden width.
N, P, D, F_ = 2309, 2304, 4096, 8192


@pytest.fixture(scope="module")
def cfg():
    return run.load_config("dinov3-vit7b16-vlad32")


def test_the_parameter_count_is_6_716_b(cfg):
    # A block: 4 D^2 in qkv (no bias) and proj, 3 D F in the SwiGLU FFN,
    # 8 D of norms, LayerScales and biases of proj and w3, 2 F of w12's bias.
    block = 4 * D * D + 3 * D * F_ + 8 * D + 2 * F_
    assert block == 167_821_312
    want = 40 * block + 3 * 16 * 16 * D + D + 5 * D + 2 * D
    assert dinov3_roofline.params(cfg) == want == 6_716_030_976
    assert sum(math.prod(s) for s in system.shapes(cfg).values()) == want


def test_one_block_by_hand(cfg):
    # (operations, bytes) of each op of one block, every map and weight in
    # bfloat16: a linear reads its input, weight (and bias) and writes its
    # output, qkv has no bias; the rotation reads and writes the patch rows'
    # q and k; attention 4 N^2 D operations, q, k, v read and o written; a
    # LayerNorm reads and writes its map (+ 2 D parameters); LayerScale plus
    # the residual reads two maps and gamma and writes one; SwiGLU's product
    # reads the two halves and writes one.
    want = {
        "blocks.3.norm1": (0, 2 * (2 * N * D + 2 * D)),
        "blocks.3.attn.qkv": (2 * N * D * 3 * D, 2 * (N * D + 3 * D * D + 3 * N * D)),
        "blocks.3.attn.rope": (0, 2 * (2 * P * D + 2 * P * D)),
        "blocks.3.attn.core": (4 * N * N * D, 2 * 4 * N * D),
        "blocks.3.attn.proj": (2 * N * D * D, 2 * (N * D + D * D + D + N * D)),
        "blocks.3.ls1": (0, 2 * (3 * N * D + D)),
        "blocks.3.norm2": (0, 2 * (2 * N * D + 2 * D)),
        "blocks.3.mlp.w12": (2 * N * D * 2 * F_, 2 * (N * D + 2 * F_ * D + 2 * F_ + 2 * N * F_)),
        "blocks.3.mlp.swiglu": (0, 2 * 3 * N * F_),
        "blocks.3.mlp.w3": (2 * N * F_ * D, 2 * (N * F_ + F_ * D + D + N * D)),
        "blocks.3.ls2": (0, 2 * (3 * N * D + D)),
    }
    got = {op["name"]: (op["flops"], op["bytes"]) for op in dinov3_roofline.block_ops(cfg, 3)}
    assert got == want
    # 775 G of linears and 155 G of attention a block and image; the
    # rotation 75.5 MB.
    assert sum(f for n, (f, _) in want.items() if "core" not in n) == 774_771_834_880
    assert want["blocks.3.attn.core"][0] == 87_350_984_704
    assert want["blocks.3.attn.rope"][1] == 75_497_472
    for name, (flops, n_bytes) in want.items():
        op = {"name": name, "flops": flops, "bytes": n_bytes}
        assert dinov3_roofline.op_least_s(op) == pytest.approx(max(flops / 989e12,
                                                                   n_bytes / 3.35e12))
        assert (flops / 989e12 > n_bytes / 3.35e12) == (flops > 0)


def test_the_trunk_to_the_final_norm(cfg):
    ops = dinov3_roofline.ops(cfg)
    names = [op["name"] for op in ops]
    assert names[:2] == ["patch_embed.proj", "tokens"] and names[-2:] == ["blocks.39.ls2", "norm"]
    assert sum(n.endswith(".attn.core") for n in names) == 40
    assert sum(n.endswith(".attn.rope") for n in names) == 40
    flops = sum(op["flops"] for op in ops)
    # 40 blocks and the 16 x 16 patch projection: 34.5 TFLOP an image.
    assert flops == 40 * (774_771_834_880 + 87_350_984_704) + 2 * P * 3 * 16 * 16 * D
    assert flops == pytest.approx(34.499e12, rel=1e-4)
    # 39.4 ms an image at the bf16 peak and the HBM rate; attention 3.53 ms
    # of it, the rotations 0.90 ms.
    assert dinov3_roofline.trunk_least_s(cfg) == pytest.approx(39.421e-3, rel=1e-4)
    assert dinov3_roofline.attention_least_s(cfg) == pytest.approx(40 * 4 * N * N * D / 989e12)
    assert dinov3_roofline.rope_least_s(cfg) == pytest.approx(40 * 8 * P * D / 3.35e12)


def _ctx(cfg, device_s, items=32, window_s=2.5):
    trace = {"device_s": device_s, "window_s": window_s}
    return readers.Context(cfg=cfg, kind="closed", trace=trace, items=items, rows=items * P,
                           valid_rows=items * P)


NAMES = ["dinov3_trunk_roofline.gallery16", "dinov3_attention_roofline.gallery16",
         "dinov3_rope_roofline.gallery16", "dinov3_step_mfu.gallery16"]
RANGES = {"features": 2.0, "attention": 0.5, "rope": 0.05, "encode": 2.1}


@pytest.mark.parametrize("other", ["tiny-vgg", "dinov2-vitg14-vlad32"])
@pytest.mark.parametrize("name", NAMES)
def test_the_readers_are_silent_without_a_dinov3_key(name, other):
    cfg = tiny_vgg() if other == "tiny-vgg" else run.load_config(other)
    assert readers.load(name)(_ctx(cfg, RANGES)) is None


def test_the_readers_read_their_ranges(cfg):
    ctx = _ctx(cfg, RANGES)
    trunk = dinov3_roofline.trunk_least_s(cfg)
    assert readers.load(NAMES[0])(ctx) == pytest.approx(100 * 32 * trunk / 2.0)
    assert readers.load(NAMES[1])(ctx) == pytest.approx(
        100 * 32 * dinov3_roofline.attention_least_s(cfg) / 0.5)
    assert readers.load(NAMES[2])(ctx) == pytest.approx(
        100 * 32 * dinov3_roofline.rope_least_s(cfg) / 0.05)
    assert readers.load(NAMES[3])(ctx) > 100 * 32 * trunk / 2.5
    for name, gone in ((NAMES[1], "attention"), (NAMES[2], "rope")):
        with pytest.raises(readers.Malformed):
            readers.load(name)(_ctx(cfg, {**RANGES, gone: 0.0}))
