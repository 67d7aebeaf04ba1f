"""The benchmark's ResNet50 int8 system held to its plain reference on the
CPU: seeded weights with BatchNorm away from identity, two images at 96^2,
where layer1-2 and part of layer3 run int8 (sides 24 and 12, kernel 8's
plain version and the gemm route's) and the rest bfloat16 (sides 6 and 3,
below the routing window). The reference held against a mutated copy of
itself fails; the configuration's routing is the program's conv by conv,
at 96^2 and at the cell's 448^2; VLAD-64 on 2,050-D agrees with the
reference's."""
import copy

import pytest
import torch
import torch.nn.functional as F

from benchmark import images, resnet_roofline, run
from benchmark.reference import resnet50_int8 as ref
from benchmark.reference import vlad as ref_vlad
from benchmark.systems import resnet50_int8 as system
from pyvisim_tpu_torch.models.quant import RoutedConv
from pyvisim_tpu_torch.models.resnet import ResNetTrunk

SEED = 2**31 + 101
SIDE = 96
# The widest 1 - cos of an image's flattened descriptors, program against
# reference. Both compute every int8 conv by the same recipe and every
# bfloat16 conv as one rounding of a float32 sum, so they part only where
# a sum's order moves a bfloat16 rounding and, downstream, an int8 step:
# 1.5e-5 to 7.3e-5 over five seeds. The reference one precision lower
# (bfloat16 convs in int8) reads 3.2e-4 to 3.6e-4, an int8 conv in int4
# 0.015 to 0.023, one BatchNorm left out 6e-3: the limit lies between.
DESC_GAP = 1.5e-4
# VLAD in float32 (the program) against float64 (the reference), on the
# same descriptors, where no row lies near a tie between two centres (the
# test checks the margin): rounding alone, ~1e-7. bfloat16 VLAD reads
# above 1e-4.
ENC_GAP = 1e-5


def desc_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.float64).flatten(1), want.to(torch.float64).flatten(1)
    return float((1.0 - F.cosine_similarity(got, want)).max())


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    c = copy.deepcopy(run.load_config("resnet50-int8-vlad64"))
    c["resnet"]["image_size"] = SIDE
    return c


@pytest.fixture(scope="module")
def weights(cfg):
    return system.make_weights(cfg, SEED, "cpu")


@pytest.fixture(scope="module")
def imgs():
    return images.photo_batch(SEED, "pool", 2, 120, 160)


@pytest.fixture(scope="module")
def centers(cfg, weights):
    """64 centres from the reference's descriptors of eight other images."""
    vocab = images.photo_batch(SEED, "vocabulary", 8, 120, 160)
    rows = ref.descriptors(cfg, weights, vocab, "cpu")[0].reshape(-1, 2050)
    pick = torch.randperm(rows.shape[0], generator=torch.Generator().manual_seed(3))[:64]
    return rows[pick].contiguous()


@pytest.fixture(scope="module")
def encoder(cfg, weights, centers):
    return system.build(cfg, weights, centers, "cpu")


@pytest.fixture(scope="module")
def program_desc(encoder, imgs):
    desc, mask = encoder.feature_extractor.extract_batch(imgs)
    assert desc.dtype == torch.bfloat16 and bool((mask == 1).all())
    return desc.to(torch.float32)


@pytest.fixture(scope="module")
def reference(cfg, weights, imgs):
    """The reference's descriptors, and the route each conv took in it."""
    taken = []
    inner = ref._conv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "_conv", lambda x, w, name, *a: taken.append((name, a[-1])) or
                   inner(x, w, name, *a))
        desc, _ = ref.descriptors(cfg, weights, imgs, "cpu")
    return desc, taken


def test_weights_carry_every_name_of_the_trunk_and_batchnorm_away_from_identity(weights):
    assert set(weights) == set(ResNetTrunk("resnet50", int8=True).state_dict())
    assert weights["layer3.2.bn2.running_var"].min() >= 0.5
    assert weights["layer3.2.bn2.weight"].std() > 0.1
    assert weights["layer4.0.downsample.1.running_mean"].abs().max() > 0.05


def test_the_system_agrees_with_the_reference_at_the_stated_precision(program_desc, reference):
    want, _ = reference
    assert program_desc.shape == want.shape == (2, 9, 2050)
    assert desc_gap(program_desc, want) < DESC_GAP


@pytest.mark.parametrize("lowered", [{"bfloat16": "int8"}, {"int8": "int4"}])
def test_the_reference_one_precision_lower_fails(cfg, weights, imgs, program_desc, lowered):
    low, _ = ref.descriptors(cfg, weights, imgs, "cpu", lowered)
    assert desc_gap(program_desc, low) > DESC_GAP


def test_a_reference_without_one_batchnorm_fails(cfg, weights, imgs, program_desc, monkeypatch):
    inner = ref._bn
    monkeypatch.setattr(ref, "_bn", lambda x, w, name: x if name == "layer3.2.bn2"
                        else inner(x, w, name))
    mutated, _ = ref.descriptors(cfg, weights, imgs, "cpu")
    assert desc_gap(program_desc, mutated) > DESC_GAP


def test_a_reference_without_one_shortcut_fails(cfg, weights, imgs, program_desc, monkeypatch):
    inner = ref._shortcut
    monkeypatch.setattr(ref, "_shortcut", lambda x, w, pre, *a: torch.zeros_like(x)
                        if pre == "layer2.1" else inner(x, w, pre, *a))
    mutated, _ = ref.descriptors(cfg, weights, imgs, "cpu")
    assert desc_gap(program_desc, mutated) > DESC_GAP


def _program_routes(side: int) -> dict:
    """``{conv name: route}`` of the program's int8 trunk at ``side``: each
    RoutedConv's ``uses_int8`` on its input's shape (from the float trunk run
    on the meta device), the stem bfloat16."""
    shapes = {}

    def keep(name):
        def hook(module, args):
            shapes[name] = args[0].shape
        return hook

    plain = ResNetTrunk("resnet50").to("meta")
    hooks = [m.register_forward_pre_hook(keep(n))
             for n, m in plain.named_modules() if isinstance(m, torch.nn.Conv2d)]
    plain(torch.empty((1, 3, side, side), device="meta"))
    for h in hooks:
        h.remove()
    out = {"conv1": "bfloat16"}
    for n, m in ResNetTrunk("resnet50", int8=True).named_modules():
        if isinstance(m, RoutedConv):
            int8 = m.uses_int8(torch.empty(shapes[n], device="meta"))
            out[n] = "int8" if int8 else "bfloat16"
    return out


@pytest.mark.parametrize("side", [SIDE, 448])
def test_the_configuration_routes_each_conv_as_the_program(cfg, side):
    convs = resnet_roofline.convs(cfg, side)
    assert {c["name"]: c["route"] for c in convs} == _program_routes(side)
    if side == 448:  # the cell: 13 bfloat16 block convs, 10 through kernel 8, 29 gemm
        routes = [("k8" if c["k"] == 3 and c["stride"] == 1 else "gemm")
                  if c["route"] == "int8" else "float" for c in convs[1:]]
        assert [routes.count(r) for r in ("float", "k8", "gemm")] == [13, 10, 29]


def test_the_reference_routes_each_conv_as_the_program(cfg, reference):
    _, taken = reference
    assert [n for n, _ in taken] == [c["name"] for c in resnet_roofline.convs(cfg)]
    assert dict(taken) == _program_routes(SIDE)
    assert {r for _, r in taken} == {"int8", "bfloat16"}


def test_vlad64_on_2050_d_agrees_with_the_reference(encoder, imgs, program_desc, centers):
    got = torch.as_tensor(encoder.encode(imgs))
    assert got.shape == (2, 64 * 2050)
    mask = torch.ones(program_desc.shape[:2])
    want, labels = ref_vlad.encode(program_desc, mask, centers)
    # No row lies near a tie between its two nearest centres.
    x, c = program_desc.to(torch.float64), centers.to(torch.float64)
    d2 = torch.cdist(x, c[None].expand(len(x), -1, -1)) ** 2
    two = d2.topk(2, dim=-1, largest=False).values
    assert float(((two[..., 1] - two[..., 0]) / two[..., 0]).min()) > 1e-4
    assert ref_vlad.nonempty_clusters(labels) > 1
    gap = float((1.0 - F.cosine_similarity(got.to(torch.float64), want)).max())
    assert gap < ENC_GAP
    low, _ = ref_vlad.encode(program_desc, mask, centers, precision="bfloat16")
    assert float((1.0 - F.cosine_similarity(low, want)).max()) > ENC_GAP
