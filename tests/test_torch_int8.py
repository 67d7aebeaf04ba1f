"""The port's int8 VGG trunk against the JAX package's, and its quality
gates: the counterparts of tests/test_features_deep.py's int8 tests.

At 64^2 the trunk routes conv1, conv6 and conv9 through kernel 7 (float
conv + ReLU + pool), conv3 through kernel 8 (int8 conv + ReLU + pool) and
conv2 through kernel 8 alone; on the CPU each takes its plain version. The
quality gates run at 112^2, where conv2-6 are int8 (both pooled kernels),
to keep the CPU's exact float64 int8 convs inside the time of a test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvisim_tpu.encoders import VLADEncoder as JVLADEncoder
from pyvisim_tpu.features import DeepConvFeature as JDeepConvFeature
from pyvisim_tpu.models import vgg as jvgg
from pyvisim_tpu.ops.codebooks import KMeansCodebook as JKMeansCodebook
from pyvisim_tpu_torch.encoders import VLADEncoder
from pyvisim_tpu_torch.features import DeepConvFeature
from pyvisim_tpu_torch.models import vgg as tvgg
from pyvisim_tpu_torch.models.quant import RoutedConv
from pyvisim_tpu_torch.ops.codebooks import KMeansCodebook
from pyvisim_tpu_torch.ops.cuda import conv as tconv
from pyvisim_tpu_torch.ops.vlad import vlad_encode


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    # The params do not depend on the size of the init image.
    return jax.tree_util.tree_map(np.asarray, jvgg.init_params("vgg16", -1, seed=0, image_size=32))


def _trunk_routes(model, size):
    """Each conv's route at input ``size``: "k7", "k8" (pooled), "quant"
    (kernel 8 alone) or "cudnn"."""
    routes = []
    for m in model.features:
        if isinstance(m, RoutedConv):
            route = m.route(torch.empty((1, m.in_channels, size, size)))
            routes.append({"int8_k8": "k8" if m.pool else "quant"}.get(route, route))
            size //= 2 if m.pool else 1
    return routes


def test_int8_trunk_routes_as_jax():
    model = tvgg.VGGConvFeatures("vgg16", int8=True)
    assert _trunk_routes(model, 64) == ["cudnn", "k7", "quant", "k8", "cudnn", "cudnn", "k7",
                                        "cudnn", "cudnn", "k7", "cudnn", "cudnn", "cudnn"]
    assert _trunk_routes(model, 224) == ["cudnn", "k7", "cudnn", "k7", "quant", "quant", "k8",
                                         "quant", "quant", "k8", "cudnn", "cudnn", "cudnn"]
    # The same state dict loads into the float and the int8 trunk.
    assert set(model.state_dict()) == set(tvgg.VGGConvFeatures("vgg16").state_dict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_trunk_matches_jax(jax_params, dtype):
    """float32: within 1e-4 * max|ref| (f32 sums in another order; a value
    at a rounding boundary of the int8 grid can move one step). bfloat16:
    cosine > 0.9999 per image and within 1 % of max|ref|: the port's fused
    layers add the float32 bias before one rounding where JAX's bf16
    ``nn.Conv`` rounds, adds a bf16 bias and rounds again, and the int8
    layers quantise what differs by those roundings."""
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jvgg.VGGConvFeatures(dtype=jnp.dtype(dtype), int8=True)
                      .apply(jax_params, jx).astype(jnp.float32))
    tdtype = getattr(torch, dtype)
    model = tvgg.VGGConvFeatures("vgg16", int8=True)
    model.load_params(tvgg.params_from_jax(jax_params))
    model = model.to(tdtype)
    inp = torch.from_numpy(x).to(tdtype).permute(0, 3, 1, 2)  # channels-last strides
    with torch.no_grad():
        got = model(inp).float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 4, 4, 512)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if dtype == "float32":
        assert err <= 1e-4 * scale, err
    else:
        cos = (got * want).reshape(2, -1).sum(1) / (
            np.linalg.norm(got.reshape(2, -1), axis=1) * np.linalg.norm(want.reshape(2, -1), axis=1))
        assert (cos > 0.9999).all(), cos
        assert err <= 1e-2 * scale, err


def test_int8_weights_quantised_from_float32_in_a_bf16_trunk(jax_params):
    """DeepConvFeature casts the trunk to bf16; the int8 weights and their
    scales must still be JAX's recipe on the float32 kernels, bit for bit,
    and the biases stay float32."""
    ext = DeepConvFeature(params=tvgg.params_from_jax(jax_params), image_size=64,
                          dtype=torch.bfloat16, int8=True, device="cpu")
    convs = [m for m in ext.model.features if isinstance(m, RoutedConv)]
    assert len(convs) == 13
    for i, m in enumerate(convs):
        kernel = jnp.asarray(jax_params["params"][f"conv{i}"]["kernel"])
        sw = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)) / 127.0, 1e-8)
        wq = jnp.round(kernel / sw).clip(-127, 127).astype(jnp.int8)
        np.testing.assert_array_equal(m.wq.numpy(), np.asarray(wq).transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(m.sw.numpy(), np.asarray(sw))
        assert m.bias.dtype == m.sw.dtype == torch.float32
        np.testing.assert_array_equal(m.bias.numpy(), jax_params["params"][f"conv{i}"]["bias"])
        assert m.w_x.dtype == torch.bfloat16 and m.w_x.is_contiguous()


def _cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _vlad_cosine_vs_f32(state, size=112):
    """tests/test_features_deep.py:233's gate on the port alone: one image,
    VLAD on 64 random centers, float32 trunk against bf16 int8."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((1, size, size, 3)) * 255).astype(np.uint8))
    centers = torch.from_numpy(rng.normal(size=(64, 514)).astype(np.float32))
    encodings, descs = {}, {}
    for name, kw in (("float32", dict(dtype=torch.float32)),
                     ("int8", dict(dtype=torch.bfloat16, int8=True))):
        ext = DeepConvFeature("vgg16", params=state, image_size=size, device="cpu", **kw)
        with torch.no_grad():
            desc = ext._forward(img).to(torch.float32)
        descs[name] = desc
        encodings[name] = vlad_encode(desc[0], None, centers).numpy()
    return _cosine(encodings["float32"], encodings["int8"]), descs["float32"]


def test_int8_trunk_encoding_cosine_vs_f32(jax_params):
    cos, _ = _vlad_cosine_vs_f32(tvgg.params_from_jax(jax_params))
    assert cos > 0.999, f"int8 trunk encoding cosine {cos} vs f32"


def test_int8_trunk_heavy_tailed_activation_fidelity(jax_params):
    """tests/test_features_deep.py:297's stress: per-output-channel
    log-normal (sigma 1.5) kernel rescaling gives a heavy activation tail."""
    r2 = np.random.default_rng(1)
    heavy = {"params": {}}
    for i in range(13):
        layer = jax_params["params"][f"conv{i}"]
        scale = np.exp(r2.normal(0, 1.5, size=(layer["kernel"].shape[-1],))).astype(np.float32)
        heavy["params"][f"conv{i}"] = {"kernel": layer["kernel"] * scale, "bias": layer["bias"]}
    cos, desc = _vlad_cosine_vs_f32(tvgg.params_from_jax(heavy))
    tail = np.percentile(desc.abs().numpy(), 99.9) / max(float(desc.abs().median()), 1e-9)
    assert tail > 100, f"stress regime too mild: ratio {tail}"
    assert cos > 0.999, f"int8 heavy-tail encoding cosine {cos}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_int8_descriptors_batch_independent(dtype):
    """tests/test_features_deep.py:281: per-image activation scales, so a
    saturated batchmate cannot move an image's quantisation grid. The trunk
    is read at conv6, the last of the five int8 convs at 112^2: the float
    convs of the 7^2 tail may take other algorithms for other batch sizes
    (oneDNN's float32 convs at 4^2 x 512 differ by 1e-4 between batches of
    1 and 2), which says nothing of the quantisation."""
    ext = DeepConvFeature(image_size=112, layer_index=6, spatial_encoding=False, int8=True,
                          dtype=dtype, device="cpu")
    rng = np.random.default_rng(5)
    img = (rng.random((112, 112, 3)) * 255).astype(np.uint8)
    sat = np.full((112, 112, 3), 255, np.uint8)
    alone = ext.extract_batch(np.stack([img]))[0][0]
    paired = ext.extract_batch(np.stack([img, sat]))[0][0]
    assert torch.equal(alone, paired)


def test_int8_vlad_encoder_matches_jax(jax_params):
    """DeepConvFeature(int8=True) -> VLADEncoder in both stacks, float32,
    with centers near descriptors so no label is a near tie."""
    rng = np.random.default_rng(0)
    grid = rng.integers(0, 256, size=(3, 4, 4, 3))
    images = np.clip(np.repeat(np.repeat(grid, 18, axis=1), 20, axis=2)
                     + rng.normal(0, 12, size=(3, 72, 80, 3)), 0, 255).astype(np.uint8)
    jext = JDeepConvFeature("vgg16", params=jax_params, image_size=64, int8=True, dtype=jnp.float32)
    desc, _ = jext.extract_batch(images[:2])
    flat = np.asarray(desc).reshape(-1, 514)
    centers = flat[rng.choice(len(flat), 8, replace=False)]
    centers = (centers + 0.01 * rng.normal(size=centers.shape)).astype(np.float32)
    want = np.asarray(JVLADEncoder(jext, kmeans_model=JKMeansCodebook(centers)).encode(images))
    text = DeepConvFeature("vgg16", params=tvgg.params_from_jax(jax_params), image_size=64,
                           int8=True, device="cpu")
    before = [f.launches for f in (tconv.conv3x3_relu_maxpool, tconv.conv3x3_relu_maxpool_q8,
                                   tconv.conv3x3_q8)]
    got = VLADEncoder(text, kmeans_model=KMeansCodebook(centers)).encode(images)
    assert got.shape == want.shape == (3, 8 * 514)
    # JAX's float slice gate is atol 1e-4; here a value at a rounding
    # boundary of an int8 layer's grid may land one step apart, moving a
    # few entries by up to ~1e-4 more.
    np.testing.assert_allclose(got, want, atol=5e-4)
    # CPU tensors take the plain versions: no kernel launches.
    assert [f.launches for f in (tconv.conv3x3_relu_maxpool, tconv.conv3x3_relu_maxpool_q8,
                                 tconv.conv3x3_q8)] == before
