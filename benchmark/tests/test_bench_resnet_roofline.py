"""The counts of ``benchmark/resnet_roofline.py`` against hand-worked values."""
import pytest

from benchmark import resnet_roofline, run


@pytest.fixture(scope="module")
def cfg():
    return run.load_config("resnet50-int8-vlad64")


def test_one_bottleneck_by_hand(cfg):
    # layer2.0 at 448^2: 256 x 112^2 in, width 128, stride 2 on the 3x3.
    convs = {c["name"]: c for c in resnet_roofline.convs(cfg) if c["name"].startswith("layer2.0.")}
    assert list(convs) == ["layer2.0.conv1", "layer2.0.conv2", "layer2.0.conv3",
                           "layer2.0.downsample.0"]
    # (multiply-adds, bytes, route): bytes are the bfloat16 input, the
    # weights at the route's width (+ int8 scales), BatchNorm's 4 float32
    # parameters, the bfloat16 output and, for conv3, the residual read.
    want = {
        "layer2.0.conv1": (112 ** 2 * 256 * 128,
                           2 * 112 ** 2 * 256 + 2 * 256 * 128 + 16 * 128 + 2 * 112 ** 2 * 128,
                           "bfloat16"),
        "layer2.0.conv2": (56 ** 2 * 9 * 128 * 128,
                           2 * 112 ** 2 * 128 + 2 * 9 * 128 * 128 + 16 * 128 + 2 * 56 ** 2 * 128,
                           "bfloat16"),
        "layer2.0.conv3": (56 ** 2 * 128 * 512,
                           2 * 56 ** 2 * 128 + 128 * 512 + 4 * 512 + 16 * 512
                           + 2 * 2 * 56 ** 2 * 512, "int8"),
        "layer2.0.downsample.0": (56 ** 2 * 256 * 512,
                                  2 * 112 ** 2 * 256 + 2 * 256 * 512 + 16 * 512
                                  + 2 * 56 ** 2 * 512, "bfloat16"),
    }
    assert [want[n][0] for n in want] == [411_041_792, 462_422_016, 205_520_896, 411_041_792]
    assert [want[n][1] for n in want] == [9_701_376, 4_311_040, 7_301_120, 9_904_128]
    for name, (macs, n_bytes, route) in want.items():
        c = convs[name]
        assert (resnet_roofline.conv_macs(c), resnet_roofline.conv_bytes(c), c["route"]) == \
            (macs, n_bytes, route)
        # At 112^2 and 56^2 each of them is bound by its bytes.
        assert resnet_roofline.conv_least_s(c) == pytest.approx(n_bytes / 3.35e12)


def test_a_3x3_int8_conv_inside_the_window_is_bound_by_its_operations(cfg):
    (c,) = [c for c in resnet_roofline.convs(cfg) if c["name"] == "layer3.1.conv2"]
    macs = 28 ** 2 * 9 * 256 * 256
    assert c["route"] == "int8" and resnet_roofline.conv_macs(c) == macs
    assert resnet_roofline.conv_least_s(c) == pytest.approx(2 * macs / 1979e12)


def test_resnet50_totals(cfg):
    # ResNet50's convs at 224^2: 4.087 G multiply-adds, 4.09 G with the
    # 2,048 x 1,000 fc that the trunk leaves out (torchvision's figure).
    def macs(side):
        return sum(resnet_roofline.conv_macs(c) for c in resnet_roofline.convs(cfg, side))

    assert macs(224) == 4_087_136_256
    assert macs(224) + 2048 * 1000 == pytest.approx(4.09e9, rel=1e-3)
    assert macs(448) == 4 * macs(224)  # every side doubles
    assert len(resnet_roofline.convs(cfg)) == 53  # the stem, 16 x 3 convs, 4 projections
    # One image at 448^2: 71.4 us at the routes' peaks and the HBM rate.
    assert resnet_roofline.trunk_least_s(cfg) == pytest.approx(71.42e-6, rel=1e-3)
