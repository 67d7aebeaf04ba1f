"""The counts of ``benchmark/vit_roofline.py`` against hand-worked values,
and its three readers."""
import pytest

from benchmark import readers, run, vit_roofline
from benchmark.tests.conftest import tiny_vgg

N, D, F_ = 1370, 1536, 4096  # ViT-g/14 at 518^2: tokens, width, SwiGLU's hidden width


@pytest.fixture(scope="module")
def cfg():
    return run.load_config("dinov2-vitg14-vlad32")


def test_one_block_by_hand(cfg):
    # (operations, bytes) of each op of one block, every map and weight in
    # bfloat16: a linear reads its input, weight and bias and writes its
    # output; attention 4 N^2 D operations, q, k, v read and o written; a
    # LayerNorm reads and writes its map (+ 2 D parameters); LayerScale plus
    # the residual reads two maps and gamma and writes one; SwiGLU's product
    # reads the two halves and writes one.
    want = {
        "blocks.7.norm1": (0, 2 * (2 * N * D + 2 * D)),
        "blocks.7.attn.qkv": (2 * N * D * 3 * D, 2 * (N * D + 3 * D * D + 3 * D + 3 * N * D)),
        "blocks.7.attn.core": (4 * N * N * D, 2 * 4 * N * D),
        "blocks.7.attn.proj": (2 * N * D * D, 2 * (N * D + D * D + D + N * D)),
        "blocks.7.ls1": (0, 2 * (3 * N * D + D)),
        "blocks.7.norm2": (0, 2 * (2 * N * D + 2 * D)),
        "blocks.7.mlp.w12": (2 * N * D * 2 * F_, 2 * (N * D + 2 * F_ * D + 2 * F_ + 2 * N * F_)),
        "blocks.7.mlp.swiglu": (0, 2 * 3 * N * F_),
        "blocks.7.mlp.w3": (2 * N * F_ * D, 2 * (N * F_ + F_ * D + D + N * D)),
        "blocks.7.ls2": (0, 2 * (3 * N * D + D)),
    }
    got = {op["name"]: (op["flops"], op["bytes"]) for op in vit_roofline.block_ops(cfg, 7)}
    assert got == want
    # 77.6 G of linears and 11.5 G of attention a block and image.
    assert sum(f for n, (f, _) in want.items() if "core" not in n) == 77_573_652_480
    assert want["blocks.7.attn.core"][0] == 11_531_673_600
    # The linears and attention are bound by their operations, the rest by bytes.
    for name, (flops, n_bytes) in want.items():
        op = {"name": name, "flops": flops, "bytes": n_bytes}
        bound = max(flops / 989e12, n_bytes / 3.35e12)
        assert vit_roofline.op_least_s(op) == pytest.approx(bound)
        assert (flops / 989e12 > n_bytes / 3.35e12) == (flops > 0)


def test_the_trunk_to_block_31s_value_facet(cfg):
    ops = vit_roofline.ops(cfg)
    names = [op["name"] for op in ops]
    assert names[:2] == ["patch_embed.proj", "pos_embed"]
    assert names[-2:] == ["blocks.31.norm1", "blocks.31.attn.qkv.value"]
    assert sum(n.endswith(".attn.core") for n in names) == 31
    flops = sum(op["flops"] for op in ops)
    # 31 blocks, the facet's 1,369 x 1,536 x 1,536 and the 14 x 14 patch projection.
    assert flops == 31 * (77_573_652_480 + 11_531_673_600) + 2 * 1369 * D * D \
        + 2 * 1369 * 3 * 14 * 14 * D
    # 3.51 ms an image at the bf16 peak and the HBM rate; attention 0.36 ms of it.
    assert vit_roofline.trunk_least_s(cfg) == pytest.approx(3.5095e-3, rel=1e-3)
    assert vit_roofline.attention_least_s(cfg) == pytest.approx(31 * 4 * N * N * D / 989e12)


def _ctx(cfg, device_s, items=128, window_s=2.0):
    trace = {"device_s": device_s, "window_s": window_s}
    return readers.Context(cfg=cfg, kind="closed", trace=trace, items=items, rows=items * 1369,
                           valid_rows=items * 1369)


NAMES = ["vit_trunk_roofline.gallery", "vit_attention_roofline.gallery", "vit_step_mfu.gallery"]


@pytest.mark.parametrize("name", NAMES)
def test_the_readers_are_silent_without_a_vit_configuration(name):
    ctx = _ctx(tiny_vgg(), {"features": 1.0, "attention": 0.5, "encode": 1.5})
    assert readers.load(name)(ctx) is None


def test_the_readers_read_their_ranges(cfg):
    ctx = _ctx(cfg, {"features": 1.0, "attention": 0.25, "encode": 1.1})
    trunk, attn = vit_roofline.trunk_least_s(cfg), vit_roofline.attention_least_s(cfg)
    assert readers.load(NAMES[0])(ctx) == pytest.approx(100 * 128 * trunk / 1.0)
    assert readers.load(NAMES[1])(ctx) == pytest.approx(100 * 128 * attn / 0.25)
    assert readers.load(NAMES[2])(ctx) > 100 * 128 * trunk / 2.0
    with pytest.raises(readers.Malformed):
        readers.load(NAMES[1])(_ctx(cfg, {"features": 1.0, "attention": 0.0}))
