"""The benchmark's DINOv2 system held to its plain reference on the CPU, at
a small size: 4 blocks of width 96 with 4 heads, the facet of block 3, on
56^2 images (a 4 x 4 patch grid, 17 tokens), seeded weights drawn as the
cell draws them. Both FFN kinds and every facet; the reference one
precision lower and three mutated references fail; the configuration's
widths are ViT-g/14's and build its shapes; VLAD-8 through
``DeepConvFeature(module=ViTTrunk)`` agrees with the reference's float64
encodings; a recorded forward opens the trunk's spans and counts its
attention route, its float passes' route and its tokens."""
import copy
import math

import pytest
import torch
import torch.nn.functional as F

from benchmark import images, run
from benchmark.reference import dinov2_vitg14 as ref
from benchmark.reference import vlad as ref_vlad
from benchmark.systems import dinov2_vitg14 as system
from pyvisim_tpu_torch import profiling
from pyvisim_tpu_torch.models.vit import VARIANTS, ViTSpec, ViTTrunk

SEED = 2**31 + 101
SIDE = 56
# The widest 1 - cos of an image's flattened descriptors, program against
# reference. Both round to bfloat16 at the same places (SwiGLU as two ops,
# attention's unnormalised weights before their product with v), so they
# part only where a sum's order moves a rounding: 0 to 1.4e-5 over five
# seeds, three facets and both FFN kinds. The reference one precision
# lower (int8 linears) reads 1.4e-4 to 4.9e-4, a wrong softmax scale
# 4.1e-3 and up, a skipped block or a dropped LayerScale 0.11 and up: the
# limit lies between.
DESC_GAP = 5e-5
# VLAD-8 in float32 of the program's descriptors against float64 of the
# reference's, where no row lies near a tie between two centres (the test
# checks the margin): the descriptors' own gap, 0 to 3.6e-5 over four
# seeds. The reference one precision lower reads 1.6e-3 to 3.7e-2, a
# skipped block 0.63 and up.
ENC_GAP = 2.5e-4


def desc_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.float64).flatten(1), want.to(torch.float64).flatten(1)
    return float((1.0 - F.cosine_similarity(got, want)).max())


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cfg(ffn: str = "swiglu", facet: str = "value") -> dict:
    c = copy.deepcopy(run.load_config("dinov2-vitg14-vlad32"))
    c["vit"].update(embed_dim=96, depth=4, num_heads=4, head_dim=24, ffn=ffn,
                    ffn_hidden=128 if ffn == "swiglu" else 384, image_size=SIDE,
                    grid=SIDE // 14, tokens=1 + (SIDE // 14) ** 2, layer=3, facet=facet)
    c["descriptor_dim"] = 96
    c["vlad"]["k"] = 8
    c["encoding_dim"] = 8 * 96
    return c


@pytest.fixture(scope="module")
def cfg():
    return small_cfg()


@pytest.fixture(scope="module")
def weights(cfg):
    return system.make_weights(cfg, SEED, "cpu")


@pytest.fixture(scope="module")
def imgs():
    return images.photo_batch(SEED, "pool", 2, 120, 160)


@pytest.fixture(scope="module")
def encoder(cfg, weights):
    """The cell's encoder at the small size, with 8 centres from the
    reference's descriptors of four other images."""
    vocab = images.photo_batch(SEED, "vocabulary", 4, 120, 160)
    rows = ref.descriptors(cfg, weights, vocab, "cpu")[0].reshape(-1, 96)
    pick = torch.randperm(rows.shape[0], generator=torch.Generator().manual_seed(3))[:8]
    return system.build(cfg, weights, rows[pick].contiguous(), "cpu")


@pytest.fixture(scope="module")
def program_desc(encoder, imgs):
    desc, mask = encoder.feature_extractor.extract_batch(imgs)
    assert desc.dtype == torch.bfloat16 and bool((mask == 1).all())
    return desc.to(torch.float32)


@pytest.fixture(scope="module")
def reference(cfg, weights, imgs):
    return ref.descriptors(cfg, weights, imgs, "cpu")[0]


def test_weights_carry_every_name_of_the_trunk_in_bfloat16(cfg, weights):
    trunk = ViTTrunk(ViTSpec(96, 4, 4, "swiglu", 128), layer=3, image_size=SIDE)
    assert {k: tuple(v.shape) for k, v in weights.items()} == \
        {k: tuple(v.shape) for k, v in trunk.state_dict().items()}
    assert {v.dtype for v in weights.values()} == {torch.bfloat16}
    # LayerScale far from the 1e-5 training init, LayerNorm away from identity.
    gamma = weights["blocks.2.ls1.gamma"].float()
    assert 0.2 <= float(gamma.min()) and float(gamma.max()) <= 0.6
    assert weights["blocks.1.norm2.weight"].float().std() > 0.1
    assert weights["blocks.0.attn.qkv.bias"].float().abs().max() > 0.05


@pytest.mark.parametrize("facet", ["value", "key", "query", "token"])
@pytest.mark.parametrize("ffn", ["swiglu", "mlp"])
def test_the_trunk_agrees_with_the_reference_at_the_stated_precision(imgs, ffn, facet):
    c = small_cfg(ffn, facet)
    w = system.make_weights(c, SEED, "cpu")
    got = system.build(c, w, torch.zeros(8, 96), "cpu").feature_extractor.extract_batch(imgs)[0]
    want = ref.descriptors(c, w, imgs, "cpu")[0]
    assert got.shape == want.shape == (2, 16, 96)
    assert desc_gap(got, want) < DESC_GAP


def test_the_reference_one_precision_lower_fails(cfg, weights, imgs, program_desc):
    low, _ = ref.descriptors(cfg, weights, imgs, "cpu", ref.CONTROL)
    assert desc_gap(program_desc, low) > DESC_GAP


def _skip_block_1(inner):
    return lambda x, w, i, c, p: x if i == 1 else inner(x, w, i, c, p)


def _scale_off(inner):
    return lambda head_dim: inner(head_dim) * math.sqrt(2.0)


def _layer_scale_dropped(inner):
    return lambda x, y, gamma: inner(x, y, torch.ones_like(gamma))


@pytest.mark.parametrize("part, mutate", [("_block", _skip_block_1), ("_scale", _scale_off),
                                          ("_residual", _layer_scale_dropped)],
                         ids=["one-block-skipped", "softmax-scale-off-by-sqrt2",
                              "layer-scale-dropped"])
def test_a_mutated_reference_fails(cfg, weights, imgs, program_desc, monkeypatch, part, mutate):
    monkeypatch.setattr(ref, part, mutate(getattr(ref, part)))
    mutated, _ = ref.descriptors(cfg, weights, imgs, "cpu")
    assert desc_gap(program_desc, mutated) > DESC_GAP


def test_the_configuration_builds_vitg14_at_its_published_widths():
    full = run.load_config("dinov2-vitg14-vlad32")
    v = full["vit"]
    spec = ViTSpec(v["embed_dim"], v["depth"], v["num_heads"], v["ffn"], v["ffn_hidden"])
    assert spec == VARIANTS["dinov2_vitg14"] == ViTSpec(1536, 40, 24, "swiglu", 4096)
    assert v["embed_dim"] // v["num_heads"] == v["head_dim"] == 64
    assert (v["image_size"] // v["patch_size"], v["tokens"]) == (v["grid"], 1 + v["grid"] ** 2)
    assert full["descriptor_dim"] == v["embed_dim"]
    assert full["encoding_dim"] == full["vlad"]["k"] * full["descriptor_dim"] == 49152
    assert full["reduced"] == []
    trunk = ViTTrunk("dinov2_vitg14", layer=v["layer"], facet=v["facet"],
                     image_size=v["image_size"], device="meta")
    assert len(trunk.blocks) == 32  # blocks 0-31: block 31 gives the facet
    shapes = {k: tuple(t.shape) for k, t in trunk.state_dict().items()}
    assert shapes == system.shapes(full)
    assert shapes["blocks.31.mlp.w12.weight"] == (8192, 1536)
    assert shapes["pos_embed"] == (1, 1370, 1536)
    assert sum(math.prod(s) for s in shapes.values()) == pytest.approx(0.91e9, rel=0.01)


@pytest.mark.parametrize("variant, dims", [("dinov2_vits14", (384, 12, 6, 1536)),
                                           ("dinov2_vitb14", (768, 12, 12, 3072)),
                                           ("dinov2_vitl14", (1024, 24, 16, 4096))])
def test_the_gelu_variants_hold_their_published_widths(variant, dims):
    trunk = ViTTrunk(variant, device="meta")
    d, depth, heads, hidden = dims
    assert len(trunk.blocks) == depth and trunk.blocks[0].attn.num_heads == heads
    assert tuple(trunk.blocks[-1].mlp.fc1.weight.shape) == (hidden, d)
    assert trunk(torch.empty(1, 3, 518, 518, device="meta")).shape == (1, d, 37, 37)


def test_the_trunk_refuses_what_it_cannot_run():
    trunk = ViTTrunk(ViTSpec(96, 2, 4, "mlp", 384), image_size=SIDE)
    with pytest.raises(ValueError, match="56"):
        trunk(torch.zeros(1, 3, 70, 70))
    with pytest.raises(ValueError, match="facet"):
        ViTTrunk(ViTSpec(96, 2, 4, "mlp", 384), facet="keys", image_size=SIDE)
    with pytest.raises(ValueError, match="layer"):
        ViTTrunk(ViTSpec(96, 2, 4, "mlp", 384), layer=2, image_size=SIDE)
    with pytest.raises(ValueError, match="multiple of 14"):
        ViTTrunk(ViTSpec(96, 2, 4, "mlp", 384), image_size=50)


def test_vlad8_through_the_extractor_agrees_with_the_reference(cfg, weights, encoder, imgs,
                                                              reference):
    got = torch.as_tensor(encoder.encode(imgs))
    assert got.shape == (2, 8 * 96)
    centers = encoder._clustering_model.centers.to(torch.float64)
    mask = torch.ones(reference.shape[:2])
    want, labels = ref_vlad.encode(reference, mask, centers)
    # No row lies near a tie between its two nearest centres.
    x = reference.to(torch.float64)
    d2 = torch.cdist(x, centers[None].expand(len(x), -1, -1)) ** 2
    two = d2.topk(2, dim=-1, largest=False).values
    assert float(((two[..., 1] - two[..., 0]) / two[..., 0]).min()) > 1e-3
    assert ref_vlad.nonempty_clusters(labels) > 1
    gap = float((1.0 - F.cosine_similarity(got.to(torch.float64), want)).max())
    assert gap < ENC_GAP
    low, _ = ref_vlad.encode(ref.descriptors(cfg, weights, imgs, "cpu", ref.CONTROL)[0], mask,
                             centers)
    assert float((1.0 - F.cosine_similarity(got.to(torch.float64), low)).max()) > ENC_GAP


def test_a_recorded_forward_opens_the_trunk_spans_and_counts_its_route(encoder, imgs):
    ext = encoder.feature_extractor
    with profiling.record() as rec:
        ext.extract_batch(imgs)
    spans = rec.spans
    parent = {s.name: (spans[s.parent].name if s.parent is not None else None) for s in spans}
    assert parent["features"] is None
    assert {n: parent[n] for n in ("vit.embed", "vit.blocks", "vit.facet")} == \
        dict.fromkeys(("vit.embed", "vit.blocks", "vit.facet"), "features")
    assert parent["vit.attention"] == parent["vit.ffn"] == "vit.blocks"
    names = [s.name for s in spans]
    assert names.count("vit.attention") == names.count("vit.ffn") == 3  # blocks 0-2
    # One attention call a block, on the plain route on the CPU; 2 x 17 tokens;
    # the float passes on their plain route: a SwiGLU a block, an ls1 + norm2
    # and an ls2 + next norm1 a block.
    counts = {k: v for k, v in rec.counters().items() if k.startswith(("attn.", "vit."))}
    assert counts == {"attn.math": 3, "vit.tokens": 2 * 17, "vit.swiglu.plain": 3,
                      "vit.add_norm.plain": 6}
