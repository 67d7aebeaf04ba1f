"""The counts of ``benchmark/roofline.py`` against hand-worked values."""
import pytest

from benchmark import roofline, run


def vgg():
    return run.load_config("vgg16-int8-vlad256")


def test_vgg16_trunk_operations_at_their_routes_peaks():
    # bf16 convs 0-3 and 10-12: 0.173 + 3.699 + 1.850 + 3.699 + 3 x 0.925 GFLOP;
    # int8 convs 4-9: 1.850 + 3.699 + 3.699 + 1.850 + 3.699 + 3.699 GOP.
    bf16 = 2 * 9 * (224 ** 2 * (3 * 64 + 64 * 64) + 112 ** 2 * (64 * 128 + 128 * 128)
                    + 3 * 14 ** 2 * 512 * 512)
    int8 = 2 * 9 * (56 ** 2 * (128 * 256 + 2 * 256 * 256) + 28 ** 2 * (256 * 512 + 2 * 512 * 512))
    assert bf16 == pytest.approx(12.2e9, rel=2e-3)
    assert int8 == pytest.approx(18.5e9, rel=2e-3)
    assert roofline.trunk_least_s(vgg(), ops_only=True) == pytest.approx(21.7e-6, rel=2e-3)


def test_bytes_bound_the_first_conv():
    layer = roofline.conv_layers([64], 224, [])[0]
    ops_s = 2 * 224 * 224 * 9 * 3 * 64 / 989e12
    bytes_s = (2 * 224 * 224 * 3 + 2 * 9 * 3 * 64 + 8 * 64 + 2 * 224 * 224 * 64) / 3.35e12
    assert bytes_s > ops_s
    assert roofline.conv_least_s(layer, "bfloat16") == pytest.approx(bytes_s)
    assert roofline.trunk_least_s(vgg()) > roofline.trunk_least_s(vgg(), ops_only=True)


def test_vlad_count_as_chip_smoke():
    # Dense 128 x 196 x 514 into 256: 6.6618 GFLOP at 67 TFLOP/s = 99.43 us.
    n_ops = 2 * 25088 * 256 * 514 + 2 * 25088 * 514 + 2 * 128 * 256 * 514
    assert n_ops == 6_661_834_752
    assert roofline.vlad_least_s(128, 196, 25088, 514, 256) == pytest.approx(n_ops / 67e12)
    # PERF.md's 0.0887 ms: phase 2a's inputs weigh ~9 in 10 rows of 127 sets.
    assert roofline.vlad_least_s(128, 196, 22_380, 514, 256) == pytest.approx(88.7e-6, rel=2e-3)


def test_scan_bytes_of_the_served_gallery():
    # 6,149 x 131,584 float32 rows and one query at 3.35 TB/s: 0.9663 ms.
    assert roofline.scan_least_s(6149, 131584) == pytest.approx(0.9663e-3, rel=1e-4)


def test_sift_pyramid_is_a_positive_lower_bound():
    cfg = run.load_config("rootsift-vlad256")
    t = roofline.sift_pyramid_least_s(cfg)
    # 7 octaves from 1024^2; the first octave's six blurs alone are
    # 2 x 2 x (taps) x 1024^2 operations.
    assert 1e-6 < t < 1e-3
    assert roofline.features_least_s(cfg) == t


def test_share_is_silent_without_a_measurement():
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, None) is None
    assert roofline.share_pct(1.0, 4.0) == 25.0
