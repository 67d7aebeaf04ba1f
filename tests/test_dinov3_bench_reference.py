"""The DINOv3 trunk (``models/vit.py`` under RoPE) and the benchmark's
DINOv3 system held to its plain reference on the CPU, at a small size: 2
blocks of width 128 with 4 heads of 32, 4 register tokens, patch 16, the
final-norm facet, at 64^2 and 96^2 (4 x 4 and 6 x 6 patch grids), seeded
weights drawn as the cell draws them. The RoPE table against its closed
form; the rotation leaves the CLS and register rows untouched and composes
as a rotation; the reference one precision lower, and references with a
skipped rotation, swapped axes or a skipped block, fail; the
configuration's widths are ViT-7B/16's and build its 6.716 B parameters;
the DINOv2 trunks still take their one size; a recorded forward opens the
trunk's spans and counts its routes."""
import copy
import math

import pytest
import torch
import torch.nn.functional as F

from benchmark import dinov3_roofline, images, run
from benchmark.reference import dinov3_vit7b16 as ref
from benchmark.reference import vlad as ref_vlad
from benchmark.systems import dinov3_vit7b16 as system
from pyvisim_tpu_torch import profiling
from pyvisim_tpu_torch.models import vit
from pyvisim_tpu_torch.ops.cuda import vit_passes

SEED = 2**31 + 2711
SIDES = (64, 96)
D, HEADS, HD = 128, 4, 32
# The widest 1 - cos of an image's flattened descriptors, program against
# reference. Both round to bfloat16 at the same places (RoPE in float32
# and q, k rounded once; SwiGLU as two ops; attention's unnormalised
# weights before their product with v), so they part only where a sum's
# order moves a rounding: 0 to 9.5e-6 over six seeds at both sizes. The
# reference one precision lower (int8 linears) reads 2.1e-4 to 3.9e-4, a
# skipped rotation 0.035 and up, swapped RoPE axes 0.041 and up, a skipped
# block 0.12 and up: the limit lies between.
DESC_GAP = 5e-5
# VLAD-8 in float32 of the program's descriptors against float64 of the
# reference's, where no row lies near a tie between two centres (the test
# checks the margin): the descriptors' own gap, 0 to 6.6e-6 over four
# seeds. The reference one precision lower reads 1.2e-3 to 0.14.
ENC_GAP = 2.5e-4


def desc_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.float64).flatten(1), want.to(torch.float64).flatten(1)
    return float((1.0 - F.cosine_similarity(got, want)).max())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(side: int = 64) -> dict:
    c = copy.deepcopy(run.load_config("dinov3-vit7b16-vlad32"))
    g = side // 16
    c["dinov3"].update(embed_dim=D, depth=2, num_heads=HEADS, head_dim=HD, ffn_hidden=256,
                       image_size=side, grid=g, tokens=1 + 4 + g * g)
    c["descriptor_dim"] = D
    c["vlad"]["k"] = 8
    c["encoding_dim"] = 8 * D
    return c


@pytest.fixture(scope="module")
def weights():
    return system.make_weights(small_cfg(), SEED, "cpu")


@pytest.fixture(scope="module")
def imgs():
    return images.photo_batch(SEED, "pool", 2, 120, 160)


def _extract(side: int, weights, imgs, centers=None):
    cfg = small_cfg(side)
    enc = system.build(cfg, weights, torch.zeros(8, D) if centers is None else centers, "cpu")
    desc, mask = enc.feature_extractor.extract_batch(imgs)
    assert desc.dtype == torch.bfloat16 and bool((mask == 1).all())
    return enc, desc.to(torch.float32)


@pytest.fixture(scope="module")
def program_desc(weights, imgs):
    return _extract(64, weights, imgs)[1]


def test_weights_carry_every_name_of_the_trunk_in_bfloat16(weights):
    trunk = vit.ViTTrunk(system_spec(small_cfg()), facet="norm", image_size=64, device="meta")
    assert {k: tuple(v.shape) for k, v in weights.items()} == \
        {k: tuple(v.shape) for k, v in trunk.state_dict().items()}
    assert {v.dtype for v in weights.values()} == {torch.bfloat16}
    assert "blocks.0.attn.qkv.bias" not in weights and weights["storage_tokens"].shape == (1, 4, D)
    gamma = weights["blocks.1.ls1.gamma"].float()
    assert 0.2 <= float(gamma.min()) and float(gamma.max()) <= 0.6
    assert weights["norm.weight"].float().std() > 0.1
    # q and k columns drawn sqrt(2) wider than v's.
    qkv = weights["blocks.0.attn.qkv.weight"].float()
    assert 1.25 < float(qkv[:D].std() / qkv[2 * D:].std()) < 1.6


def system_spec(cfg: dict) -> vit.ViTSpec:
    v = cfg["dinov3"]
    return vit.ViTSpec(v["embed_dim"], v["depth"], v["num_heads"], v["ffn"], v["ffn_hidden"],
                       patch=v["patch_size"], registers=v["registers"], position=v["position"],
                       ln_eps=v["layer_norm_eps"], qkv_bias=v["qkv_bias"])


@pytest.mark.parametrize("side", SIDES)
def test_the_trunk_agrees_with_the_reference_at_the_stated_precision(weights, imgs, side):
    _, got = _extract(side, weights, imgs)
    want = ref.descriptors(small_cfg(side), weights, imgs, "cpu")[0]
    g = side // 16
    assert got.shape == want.shape == (2, g * g, D)
    assert desc_gap(got, want) < DESC_GAP


def test_one_trunk_takes_any_multiple_of_the_patch_and_its_grid_follows(weights):
    trunk = vit.ViTTrunk(system_spec(small_cfg()), facet="norm", image_size=64, device="meta")
    trunk.load_state_dict(weights, assign=True)
    x = torch.rand(2, 3, 96, 96, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    with torch.inference_mode():
        at_96 = trunk(x)
        at_64 = trunk(x[:, :, :64, 16:80])
        wide = trunk(x[:, :, :64, :])
    assert at_96.shape == (2, D, 6, 6) and at_64.shape == (2, D, 4, 4)
    assert wide.shape == (2, D, 4, 6)
    assert sorted(k[:2] for k in trunk._rope_tables) == [(4, 4), (4, 6), (6, 6)]
    cfg = small_cfg(96)
    pre = x.permute(0, 2, 3, 1)
    want = ref.trunk(cfg, weights, pre, ref.STATED).to(torch.float32)
    assert desc_gap(at_96.flatten(2).transpose(1, 2), want) < DESC_GAP
    with pytest.raises(ValueError, match="multiples of 16"):
        trunk(x[:, :, :72, :72])


def test_the_rope_table_is_the_closed_form():
    gh, gw, base = 3, 5, 100.0
    got = vit.rope_table(gh, gw, HD)
    assert torch.equal(got, vit.rope_table(gh, gw, HD, base))
    assert got.shape == (2, gh * gw, HD // 2) and got.dtype == torch.float32
    k = torch.arange(HD // 4, dtype=torch.float64)
    period = base ** (2 * k / (HD // 2))
    want = torch.empty(gh * gw, HD // 2, dtype=torch.float64)
    for i in range(gh):
        for j in range(gw):
            cy, cx = 2 * (i + 0.5) / gh - 1, 2 * (j + 0.5) / gw - 1
            want[i * gw + j] = torch.cat([2 * math.pi * cy / period, 2 * math.pi * cx / period])
    assert torch.allclose(got[0].double(), want.cos(), rtol=0, atol=2e-6)
    assert torch.allclose(got[1].double(), want.sin(), rtol=0, atol=2e-6)
    # The reference's (sin, cos) are the same angles tiled twice to hd.
    sin, cos = ref.rope_sin_cos({"dinov3": {"head_dim": HD, "rope_base": base}}, gh, gw, "cpu")
    assert torch.equal(cos, got[0].tile(2)) and torch.equal(sin, got[1].tile(2))


def _qkv(b, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, n, 3 * D, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_rotation_leaves_cls_v_and_the_registers_untouched(dtype):
    table = vit.rope_table(4, 4, HD)
    attn = vit.Attention(D, HEADS)
    qkv = _qkv(2, 21, dtype)
    before = qkv.clone()
    with profiling.record() as rec:
        out = attn.rotate(qkv, table)
    assert out is qkv and rec.counters() == {"vit.rope.plain": 1}
    assert torch.equal(qkv[:, :5], before[:, :5])  # CLS and the 4 registers
    assert torch.equal(qkv[..., 2 * D:], before[..., 2 * D:])  # v
    changed = (qkv[:, 5:, :2 * D] != before[:, 5:, :2 * D]).double().mean()
    assert float(changed) > 0.9


def test_two_rotations_compose_as_one_by_the_summed_angles():
    g = torch.Generator().manual_seed(3)
    a1, a2 = (6.0 * torch.rand(9, HD // 2, generator=g, dtype=torch.float64) for _ in range(2))

    def table(a):
        return torch.stack([a.cos(), a.sin()])

    qkv = _qkv(2, 14, torch.float64, seed=5)
    twice = vit_passes.rope_reference(vit_passes.rope_reference(qkv.clone(), table(a1)),
                                      table(a2))
    once = vit_passes.rope_reference(qkv.clone(), table(a1 + a2))
    assert torch.allclose(twice, once, rtol=0, atol=1e-12)
    # A rotation keeps each head's norm.
    n0 = qkv[:, 5:, :2 * D].unflatten(-1, (-1, HD)).norm(dim=-1)
    n1 = once[:, 5:, :2 * D].unflatten(-1, (-1, HD)).norm(dim=-1)
    assert torch.allclose(n0, n1, rtol=1e-12, atol=0)


def test_the_reference_one_precision_lower_fails(weights, imgs, program_desc):
    low, _ = ref.descriptors(small_cfg(), weights, imgs, "cpu", ref.CONTROL)
    assert desc_gap(program_desc, low) > DESC_GAP


def _rope_skipped(inner):
    return lambda x, sin, cos: x.to(torch.bfloat16).to(torch.float32)


def _axes_swapped(inner):
    def swapped(cfg, gh, gw, device):
        sin, cos = inner(cfg, gh, gw, device)
        flip = lambda t: t.unflatten(-1, (2, 2, -1)).flip(2).flatten(-3)  # x angles first
        return flip(sin), flip(cos)
    return swapped


def _skip_block_1(inner):
    return lambda x, w, i, c, p, r: x if i == 1 else inner(x, w, i, c, p, r)


@pytest.mark.parametrize("part, mutate", [("_rope", _rope_skipped),
                                          ("rope_sin_cos", _axes_swapped),
                                          ("_block", _skip_block_1)],
                         ids=["rotation-skipped", "axes-swapped", "one-block-skipped"])
def test_a_mutated_reference_fails(weights, imgs, program_desc, monkeypatch, part, mutate):
    monkeypatch.setattr(ref, part, mutate(getattr(ref, part)))
    mutated, _ = ref.descriptors(small_cfg(), weights, imgs, "cpu")
    assert desc_gap(program_desc, mutated) > DESC_GAP


def test_vlad8_through_the_extractor_agrees_with_the_reference(weights, imgs):
    cfg = small_cfg()
    vocab = images.photo_batch(SEED, "vocabulary", 4, 120, 160)
    rows = ref.descriptors(cfg, weights, vocab, "cpu")[0].reshape(-1, D)
    centers = rows[torch.randperm(rows.shape[0], generator=torch.Generator().manual_seed(3))[:8]]
    enc, _ = _extract(64, weights, imgs, centers.contiguous())
    got = torch.as_tensor(enc.encode(imgs)).to(torch.float64)
    assert got.shape == (2, 8 * D)
    reference = ref.descriptors(cfg, weights, imgs, "cpu")[0]
    c64, mask = centers.to(torch.float64), torch.ones(reference.shape[:2])
    want, labels = ref_vlad.encode(reference, mask, c64)
    x = reference.to(torch.float64)
    two = (torch.cdist(x, c64[None].expand(len(x), -1, -1)) ** 2).topk(2, dim=-1,
                                                                       largest=False).values
    assert float(((two[..., 1] - two[..., 0]) / two[..., 0]).min()) > 1e-3
    assert ref_vlad.nonempty_clusters(labels) > 1
    assert float((1.0 - F.cosine_similarity(got, want)).max()) < ENC_GAP
    low, _ = ref_vlad.encode(ref.descriptors(cfg, weights, imgs, "cpu", ref.CONTROL)[0], mask,
                             c64)
    assert float((1.0 - F.cosine_similarity(got, low)).max()) > ENC_GAP


def test_the_configuration_builds_vit7b16_at_its_published_widths():
    full = run.load_config("dinov3-vit7b16-vlad32")
    v = full["dinov3"]
    assert system_spec(full) == vit.VARIANTS["dinov3_vit7b16"] == vit.ViTSpec(
        4096, 40, 32, "swiglu", 8192, patch=16, registers=4, position="rope", ln_eps=1e-5,
        qkv_bias=False)
    assert v["rope_base"] == vit.ROPE_BASE
    assert v["embed_dim"] // v["num_heads"] == v["head_dim"] == 128
    g = v["image_size"] // v["patch_size"]
    assert (g, v["tokens"]) == (v["grid"], 1 + v["registers"] + g * g) == (48, 2309)
    assert full["descriptor_dim"] == v["embed_dim"]
    assert full["encoding_dim"] == full["vlad"]["k"] * full["descriptor_dim"] == 131072
    assert full["reduced"] == [] and "vit" not in full
    trunk = vit.ViTTrunk("dinov3_vit7b16", facet="norm", image_size=768, device="meta")
    assert len(trunk.blocks) == 40 and trunk.pos_embed is None and trunk.prefix == 5
    shapes = {k: tuple(t.shape) for k, t in trunk.state_dict().items()}
    assert shapes == system.shapes(full)
    assert shapes["blocks.39.mlp.w12.weight"] == (16384, 4096)
    assert sum(math.prod(s) for s in shapes.values()) == dinov3_roofline.params(full) \
        == 6_716_030_976
    out = trunk(torch.empty(1, 3, 768, 768, device="meta"))
    assert out.shape == (1, 4096, 48, 48)


@pytest.mark.parametrize("variant", ["dinov2_vits14", "dinov2_vitb14", "dinov2_vitl14",
                                     "dinov2_vitg14"])
def test_the_dinov2_variants_still_take_their_one_size(variant):
    trunk = vit.ViTTrunk(variant, device="meta")
    assert trunk.pos_embed is not None and trunk.prefix == 1
    with pytest.raises(ValueError, match="518"):
        trunk(torch.empty(1, 3, 532, 532, device="meta"))


def test_the_rope_trunk_refuses_what_it_cannot_run():
    spec = system_spec(small_cfg())
    for facet in ("query", "key"):
        with pytest.raises(ValueError, match="learned positions only"):
            vit.ViTTrunk(spec, facet=facet, image_size=64)
    with pytest.raises(ValueError, match="last block"):
        vit.ViTTrunk(spec, layer=0, facet="norm", image_size=64)
    with pytest.raises(ValueError, match="register tokens"):
        vit.ViTTrunk(vit.ViTSpec(D, 2, HEADS, "mlp", 256, registers=4), image_size=56)
    with pytest.raises(ValueError, match="position"):
        vit.ViTTrunk(vit.ViTSpec(D, 2, HEADS, "mlp", 256, position="sincos"), image_size=56)
    with pytest.raises(ValueError, match="multiple of 16"):
        vit.ViTTrunk(spec, facet="norm", image_size=56)


def test_a_recorded_forward_opens_the_trunk_spans_and_counts_its_routes(weights, imgs):
    enc, _ = _extract(64, weights, imgs)
    with profiling.record() as rec:
        enc.feature_extractor.extract_batch(imgs)
    spans = rec.spans
    parent = {s.name: (spans[s.parent].name if s.parent is not None else None) for s in spans}
    assert {n: parent[n] for n in ("vit.embed", "vit.blocks", "vit.norm")} == \
        dict.fromkeys(("vit.embed", "vit.blocks", "vit.norm"), "features")
    assert "vit.facet" not in parent
    names = [s.name for s in spans]
    assert names.count("vit.attention") == 2  # block 0 in vit.blocks, block 1 in vit.norm
    # A rotation and an attention call a block, on the plain routes on the
    # CPU; 2 x 21 tokens; a SwiGLU a block; an ls1 + norm2 and an ls2 + next
    # norm a block (the last block's with the final norm).
    counts = {k: v for k, v in rec.counters().items() if k.startswith(("attn.", "vit."))}
    assert counts == {"attn.math": 2, "vit.rope.plain": 2, "vit.tokens": 2 * 21,
                      "vit.swiglu.plain": 2, "vit.add_norm.plain": 4}
