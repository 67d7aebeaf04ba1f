"""The port's VGG trunk and DeepConvFeature against the JAX package's,
with the JAX package's seed-0 weights carried across by params_from_jax.
"""
import jax
import numpy as np
import pytest
import torch

from pyvisim_tpu.features import DeepConvFeature as JDeepConvFeature
from pyvisim_tpu.models import vgg as jvgg
from pyvisim_tpu_torch.features import DeepConvFeature
from pyvisim_tpu_torch.models import vgg as tvgg
from pyvisim_tpu_torch.ops.vlad import vlad_encode_batch


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_params():
    return _numpy_tree(jvgg.init_params("vgg16", -1, seed=0, image_size=64))


def test_params_from_jax_round_trip(jax_params):
    state = tvgg.params_from_jax(jax_params)
    assert len(state) == 2 * 13
    model = tvgg.VGGConvFeatures("vgg16")
    model.load_params(state)
    assert model.features[28].weight.shape == (512, 512, 3, 3)
    back = jvgg.params_from_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, "vgg16"
    )
    for name, layer in jax_params["params"].items():
        np.testing.assert_array_equal(np.asarray(back["params"][name]["kernel"]), layer["kernel"])
        np.testing.assert_array_equal(np.asarray(back["params"][name]["bias"]), layer["bias"])


def test_torchvision_state_dict_loads_directly(jax_params):
    state = tvgg.params_from_jax(jax_params)
    state["classifier.0.weight"] = torch.zeros(4, 4)  # keys beyond the trunk are ignored
    model = tvgg.VGGConvFeatures("vgg16", layer_index=3)
    model.load_params(state)
    np.testing.assert_array_equal(
        model.features[7].weight.detach().numpy(),
        jax_params["params"]["conv3"]["kernel"].transpose(3, 2, 0, 1),
    )
    with pytest.raises(RuntimeError):
        tvgg.VGGConvFeatures("vgg16").load_params({"features.0.weight": torch.zeros(64, 3, 3, 3)})


@pytest.mark.parametrize("layer_index", [0, 3, -1])
def test_trunk_matches_jax(jax_params, layer_index):
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jvgg.VGGConvFeatures(layer_index=layer_index).apply(jax_params, x))
    model = tvgg.VGGConvFeatures("vgg16", layer_index=layer_index)
    model.load_params(tvgg.params_from_jax(jax_params))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_default_init_draws_flax_distributions():
    j = _numpy_tree(jvgg.init_params("vgg16", 10, seed=0, image_size=32))["params"]["conv10"]
    t = tvgg.VGGConvFeatures("vgg16", layer_index=10).features[-2]
    assert not t.bias.any() and not np.asarray(j["bias"]).any()
    np.testing.assert_allclose(t.weight.std().item(), np.asarray(j["kernel"]).std(), rtol=0.02)
    assert t.weight.abs().max().item() <= 2.0 * np.sqrt(1 / (9 * 512)) / 0.8796 + 1e-6


@pytest.fixture(scope="module")
def extractors(jax_params):
    jext = JDeepConvFeature(params=jax_params, image_size=64)
    text = DeepConvFeature(params=tvgg.params_from_jax(jax_params), image_size=64, device="cpu")
    return jext, text


def test_deep_feature_call_matches_jax(extractors):
    jext, text = extractors
    img = (np.random.default_rng(0).random((50, 70, 3)) * 255).astype(np.uint8)
    got = text(img)
    want = jext(img)
    assert got.shape == (16, 514) and got.dtype == np.float32
    assert text.output_dim == 514 and text.descriptor_budget == 16
    np.testing.assert_allclose(got, want, atol=1e-4)
    # (x/Wf, y/Hf), x first, in row-major (h, w) order
    coords = np.array([[x / 4, y / 4] for y in range(4) for x in range(4)], np.float32)
    np.testing.assert_array_equal(got[:, -2:], coords)


def test_deep_feature_ragged_batch_matches_single(extractors):
    _, text = extractors
    rng = np.random.default_rng(3)
    imgs = [
        (rng.random((80, 96, 3)) * 255).astype(np.uint8),
        (rng.random((64, 64, 3)) * 255).astype(np.uint8),
        (rng.random((50, 40, 3)) * 255).astype(np.uint8),
    ]
    desc, mask = text.extract_batch(imgs)
    assert tuple(desc.shape) == (3, 16, 514)
    assert torch.all(mask == 1.0)
    for i, img in enumerate(imgs):
        np.testing.assert_allclose(desc[i].numpy(), text(img), rtol=1e-4, atol=1e-5)


def test_deep_feature_device_batch_cap_gathers_on_host(extractors, monkeypatch):
    _, text = extractors
    imgs = (np.random.default_rng(4).random((5, 64, 64, 3)) * 255).astype(np.uint8)
    whole, _ = text.extract_batch(imgs)
    monkeypatch.setenv("PYVISIM_DEEP_DEVICE_BATCH", "2")
    parts, mask = text.extract_batch(imgs)
    assert isinstance(parts, np.ndarray) and parts.shape == (5, 16, 514)
    assert mask.shape == (5, 16)
    np.testing.assert_allclose(parts, whole.numpy(), rtol=1e-4, atol=1e-5)


def test_bf16_trunk_encoding_cosine_vs_f32(jax_params):
    rng = np.random.default_rng(5)
    imgs = (rng.random((2, 64, 64, 3)) * 255).astype(np.uint8)
    state = tvgg.params_from_jax(jax_params)
    descs = {}
    for dtype in (torch.float32, torch.bfloat16):
        ext = DeepConvFeature(params=state, image_size=64, dtype=dtype, device="cpu")
        desc, _ = ext.extract_batch(imgs)
        assert desc.dtype == dtype
        descs[dtype] = desc.to(torch.float32)
    flat = descs[torch.float32].reshape(-1, 514)
    centers = flat[::4] + 0.01 * torch.from_numpy(rng.normal(size=(8, 514)).astype(np.float32))
    vecs = {k: vlad_encode_batch(v, None, centers) for k, v in descs.items()}
    a, b = vecs[torch.float32], vecs[torch.bfloat16]
    cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))
    assert torch.all(cos > 0.999), cos


def test_custom_module_sets_geometry():
    mod = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, stride=2, padding=1), torch.nn.ReLU(),
        torch.nn.Conv2d(8, 12, 3, stride=2, padding=1),
    )
    ext = DeepConvFeature(module=mod, image_size=32, device="cpu")
    assert ext.output_dim == 14 and ext.descriptor_budget == 64
    img = (np.random.default_rng(0).random((40, 50, 3)) * 255).astype(np.uint8)
    assert ext(img).shape == (64, 14)
