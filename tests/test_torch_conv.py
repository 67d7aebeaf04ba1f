"""The port's fused conv kernels' plain versions (kernels 7 and 8) and its
QuantConv against the JAX package: the Pallas kernels in interpret mode,
their XLA references and ``models/quant.py:QuantConv``.

On the CPU the wrappers take their plain versions, so these tests hold the
arithmetic that the CUDA kernels must repeat (``tests/test_torch_cuda.py``
holds the kernels against the plain versions on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pyvisim_tpu.models.quant import QuantConv as JQuantConv
from pyvisim_tpu.ops.pallas import conv as jconv
from pyvisim_tpu_torch.models import QuantConv
from pyvisim_tpu_torch.ops.cuda import conv as tconv


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ohwi(w_hwio: np.ndarray) -> torch.Tensor:
    """JAX's HWIO kernel as the port's (Cout, 3, 3, Cin)."""
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 0, 1, 2)))


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bfloat16 step at each value of t (8 significant bits)."""
    _, exp = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), exp - 8)


def _inputs(shape, seed):
    b, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, ci)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, ci, co)) * 0.05).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    return x, wk, bias


# The shapes of tests/test_pallas_conv.py:18-25.
PALLAS_SHAPES = [(2, 32, 32, 64, 64), (1, 16, 48, 64, 128), (2, 64, 32, 64, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_relu_pool_matches_jax(shape, dtype):
    x, wk, bias = _inputs(shape, seed=0)
    jx = jnp.asarray(x).astype(dtype)
    want_xla = np.asarray(jconv.conv3x3_relu_maxpool_reference(jx, jnp.asarray(wk), jnp.asarray(bias)).astype(jnp.float32))
    want_pallas = np.asarray(jconv.conv3x3_relu_maxpool(jx, jnp.asarray(wk), jnp.asarray(bias),
                                                        interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tconv.conv3x3_relu_maxpool(tx, _ohwi(wk), torch.from_numpy(bias))
    assert got.dtype == tx.dtype and tuple(got.shape) == want_xla.shape
    got = got.float()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want_xla, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-4, rtol=1e-4)
    else:
        # Both round an f32 sum of exact bf16 products once; the sums'
        # order differs, so a value may round one bf16 step apart.
        for want in (want_xla, want_pallas):
            want = torch.tensor(want)
            diff = (got - want).abs()
            assert bool((diff <= _bf16_ulp(want) + 1e-6).all())
            assert (diff == 0).float().mean().item() >= 0.99


def test_conv_zero_padding_semantics():
    """tests/test_pallas_conv.py:37: borders sum zero padding, not edge
    copies; on all ones with one summing channel the conv is 4 at a
    corner, 6 on an edge and 9 inside, exact in float32."""
    ci = co = 64
    x = np.ones((1, 8, 8, ci), np.float32)
    wk = np.zeros((3, 3, ci, co), np.float32)
    wk[:, :, 0, 0] = 1.0
    bias = np.zeros((co,), np.float32)
    want = np.asarray(jconv.conv3x3_relu_maxpool(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bias),
                                                 interpret=True))
    got = tconv.conv3x3_relu_maxpool(torch.from_numpy(x), _ohwi(wk), torch.from_numpy(bias)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :, :, 0], np.full((4, 4), 9.0))
    conv = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), _ohwi(wk).permute(0, 3, 1, 2), padding=1)
    assert conv[0, 0, 0, 0] == 4 and conv[0, 0, 0, 1] == 6 and conv[0, 0, 1, 1] == 9


@pytest.mark.parametrize("hw", [(9, 11), (7, 6), (1, 4)])
def test_conv_relu_pool_floors_odd_sides(hw):
    """An odd side drops its last row or column, as MaxPool2d(2, 2) and
    Flax's VALID max_pool do (the JAX kernel itself takes even sides)."""
    h, w = hw
    x, wk, bias = _inputs((2, h, w, 8, 64), seed=1)
    got = tconv.conv3x3_relu_maxpool(torch.from_numpy(x), _ohwi(wk), torch.from_numpy(bias))
    assert tuple(got.shape) == (2, h // 2, w // 2, 64)
    want = np.asarray(jconv.conv3x3_relu_maxpool_reference(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bias)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if h > 1:
        conv = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), _ohwi(wk).permute(0, 3, 1, 2),
                        torch.from_numpy(bias), padding=1)
        pooled = F.max_pool2d(torch.relu(conv), 2, 2).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), pooled.numpy(), atol=1e-5, rtol=1e-5)


def _jax_recipe(x, wk):
    """QuantConv's quantisation and exact accumulators from JAX's own
    pieces (tests/test_pallas_conv.py:69-83)."""
    xf = jnp.asarray(x).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True) / 127.0, 1e-8)
    xq = jnp.round(xf / sx).clip(-127, 127).astype(jnp.int8)
    kernel = jnp.asarray(wk)
    sw = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)) / 127.0, 1e-8)
    wq = jnp.round(kernel / sw).clip(-127, 127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, wq, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    )
    return (np.asarray(xq), np.asarray(sx).reshape(-1), np.asarray(wq), np.asarray(sw),
            np.asarray(acc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantisation_and_accumulators_match_jax_bit_for_bit(dtype):
    x, wk, bias = _inputs((2, 16, 24, 64, 64), seed=2)
    x[1] *= 40.0  # images on different scales
    jx = jnp.asarray(x).astype(dtype)
    xq, sx, wq, sw, acc = _jax_recipe(jx, wk)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    t_xq, t_sx = tconv.quantize_activation(tx)
    t_wq, t_sw = tconv.quantize_weight(_ohwi(wk))
    np.testing.assert_array_equal(t_sx.numpy(), sx)
    np.testing.assert_array_equal(t_xq.numpy(), xq)
    np.testing.assert_array_equal(t_sw.numpy(), sw)
    np.testing.assert_array_equal(t_wq.numpy(), wq.transpose(3, 0, 1, 2))
    _, t_acc = tconv.conv3x3_q8(tx, t_wq.contiguous(), t_sw, torch.from_numpy(bias), return_acc=True)
    np.testing.assert_array_equal(t_acc.numpy(), acc)


def test_q8_reference_matches_jax_pallas_q8():
    """tests/test_pallas_conv.py:58 at its tolerance: the Pallas kernel
    multiplies by 1/sx where QuantConv and the port divide, which may move
    a quantised value by one step."""
    x, wk, bias = _inputs((2, 16, 32, 64, 64), seed=3)
    want = np.asarray(jconv.conv3x3_relu_maxpool_q8(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bias),
                                                    interpret=True))
    wq, sw = tconv.quantize_weight(_ohwi(wk))
    got = tconv.conv3x3_relu_maxpool_q8(torch.from_numpy(x), wq.contiguous(), sw, torch.from_numpy(bias))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def _quant_conv_pair(ci, co, dtype, seed, **kw):
    """A JAX QuantConv and the port's with the same float32 params."""
    rng = np.random.default_rng(seed)
    jkw = {k: v for k, v in kw.items() if k != "bias"}
    jmod = JQuantConv(features=co, dtype=jnp.dtype(dtype), use_bias=kw.get("bias", True), **{
        "kernel_size": jkw.get("kernel_size", (3, 3)), "strides": jkw.get("strides", (1, 1)),
        "padding": jkw.get("padding", "SAME")})
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, ci), dtype)))
    if "bias" in params["params"]:
        params["params"]["bias"] = rng.normal(size=(co,)).astype(np.float32)
    kh, kw_ = jkw.get("kernel_size", (3, 3))
    stride = jkw.get("strides", (1, 1))[0]
    padding = jkw.get("padding", "SAME")
    tmod = QuantConv(ci, co, (kh, kw_), stride, padding if isinstance(padding, str) else padding[0],
                     bias=kw.get("bias", True))
    state = {"weight": torch.from_numpy(params["params"]["kernel"].transpose(3, 2, 0, 1).copy())}
    if "bias" in params["params"]:
        state["bias"] = torch.from_numpy(params["params"]["bias"])
    tmod.load_state_dict(state)
    return jmod, params, tmod


def _close_within_one_step(got: torch.Tensor, want: np.ndarray, dtype: str):
    want_t = torch.tensor(np.asarray(want, np.float32))
    diff = (got.float() - want_t).abs()
    if dtype == "bfloat16":
        step = _bf16_ulp(want_t)
    else:
        step = torch.nextafter(want_t.abs(), torch.tensor(np.inf)) - want_t.abs()
    assert bool((diff <= step).all()), float((diff - step).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_conv_matches_jax(dtype):
    """The accumulators of one QuantConv layer bit for bit, the outputs
    within one step of the output dtype (XLA may fuse the dequantising
    multiply and add)."""
    jmod, params, tmod = _quant_conv_pair(64, 64, dtype, seed=4)
    x = np.random.default_rng(5).normal(size=(2, 12, 20, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jmod.apply(params, jx).astype(jnp.float32))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tmod(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    _close_within_one_step(got, want, dtype)
    *_, acc = _jax_recipe(jx, params["params"]["kernel"])
    _, t_acc = tconv.conv3x3_q8(tx.contiguous(), tmod.wq, tmod.sw, tmod.bias, relu=False,
                                return_acc=True)
    np.testing.assert_array_equal(t_acc.numpy(), acc)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=(1, 1), strides=(2, 2), padding=(0, 0), bias=False),
    dict(kernel_size=(3, 3), strides=(2, 2), padding=(1, 1), bias=False),
    dict(kernel_size=(3, 3), strides=(2, 2), padding="SAME"),
    dict(kernel_size=(1, 1), strides=(1, 1), padding="VALID"),
], ids=["1x1s2", "3x3s2p1", "3x3s2same", "1x1valid"])
def test_quant_conv_general_shapes_on_cpu(kw):
    """On the CPU QuantConv takes any kernel, stride and padding (ResNet's
    forms), as the JAX module does."""
    jmod, params, tmod = _quant_conv_pair(16, 32, "float32", seed=6, **kw)
    x = np.random.default_rng(7).normal(size=(2, 9, 10, 16)).astype(np.float32)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    _close_within_one_step(got, want, "float32")


def test_quant_conv_keeps_float32_masters_through_casts():
    layer = QuantConv(64, 64)
    layer.load_state_dict({"weight": torch.randn(64, 64, 3, 3), "bias": torch.randn(64)})
    wq, sw = layer.wq.clone(), layer.sw.clone()
    layer = layer.to(torch.bfloat16).to(memory_format=torch.channels_last)
    assert layer.weight.dtype == layer.bias.dtype == layer.sw.dtype == torch.float32
    assert layer.wq.is_contiguous() and torch.equal(layer.wq, wq) and torch.equal(layer.sw, sw)
    assert set(layer.state_dict()) == {"weight", "bias"}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(1, 8, 8, 16)
    w = torch.randn(64, 3, 3, 16)
    b = torch.zeros(64)
    with pytest.raises(ValueError):
        tconv.conv3x3_relu_maxpool(x, w[:48].contiguous(), b[:48])
    with pytest.raises(ValueError):
        tconv.conv3x3_relu_maxpool(x.permute(0, 2, 1, 3), w, b)
    with pytest.raises(ValueError):
        tconv.conv3x3_relu_maxpool(x, w.permute(0, 2, 1, 3), b)
    with pytest.raises(ValueError):
        tconv.conv3x3_relu_maxpool(x, torch.randn(64, 3, 3, 8), b)
    with pytest.raises(TypeError):
        tconv.conv3x3_relu_maxpool(x.double(), w, b)
    wq, sw = tconv.quantize_weight(w)
    with pytest.raises(TypeError):
        tconv.conv3x3_q8(x, w, sw, b)
    with pytest.raises(ValueError):
        tconv.conv3x3_q8(x, wq.contiguous(), sw[:32], b)


# (B, H, W, Cin, Cout): Cin padded to the 32-channel k-step (3, 20, 160),
# already a multiple of it (64), odd sides, and Cout of 64, 192 and 128.
PACKED_SHAPES = [(1, 9, 13, 3, 64), (2, 7, 5, 20, 192), (1, 6, 10, 160, 64), (2, 5, 8, 64, 128)]


@pytest.mark.parametrize("shape", PACKED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_q8_weights_give_the_plain_int32_sums(shape):
    """Kernel 8 reads the weights packed as (Cout / 64, Cp / 16, 9, 64, 16)
    and x quantised with its channels zero-padded to Cp: a plain conv over
    those layouts, one channel tile, 16 channels and one tap at a time as
    the wgmma tiles take them, gives the plain version's int32 sums bit for
    bit."""
    x, wk, bias = _inputs(shape, seed=5)
    b, h, w, ci, co = shape
    wq, sw = tconv.quantize_weight(_ohwi(wk))
    wp = tconv.pack_q8_weights(wq)
    cp = -(-ci // 32) * 32
    n = 64
    assert tuple(wp.shape) == (co // n, cp // 16, 9, n, 16) and wp.is_contiguous()
    assert not wp.permute(1, 4, 2, 0, 3).reshape(cp, 9, co)[ci:].any()  # zero past Cin
    tx = torch.from_numpy(x)
    xq, _ = tconv.quantize_activation(tx)
    # SAME padding of one pixel, channels padded to Cp.
    xpad = F.pad(xq.to(torch.float64), (0, cp - ci, 1, 1, 1, 1))
    acc = torch.zeros((b, h, w, co), dtype=torch.float64)
    for tile in range(co // n):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            for blk in range(cp // 16):
                patch = xpad[:, dy : dy + h, dx : dx + w, 16 * blk : 16 * blk + 16]
                acc[..., n * tile : n * tile + n] += patch @ wp[tile, blk, tap].to(torch.float64).T
    _, want = tconv.conv3x3_q8_reference(tx, wq, sw, torch.from_numpy(bias), pool=False,
                                         return_acc=True)
    assert torch.equal(acc.round().to(torch.int32), want)


@pytest.mark.parametrize("shape", PACKED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_bf16_weights_unpack_to_the_weights(shape):
    """Kernel 7 in bf16 reads the weights packed as (Cout / 64, Cp / 8, 9,
    64, 8), Cin zero-padded to Cp (a multiple of 16): unpacked, one channel
    tile, 8 channels and one tap at a time as the wgmma tiles take them,
    they are the weights rounded to bf16, and zeros past Cin."""
    _, wk, _ = _inputs(shape, seed=6)
    _, _, _, ci, co = shape
    w = _ohwi(wk)
    wp = tconv.pack_bf16_weights(w)
    cp, n = -(-ci // 16) * 16, 64
    assert tuple(wp.shape) == (co // n, cp // 8, 9, n, 8) and wp.is_contiguous()
    assert wp.dtype == torch.bfloat16
    unpacked = torch.zeros((co, 9, cp), dtype=torch.bfloat16)
    for tile in range(co // n):
        for blk in range(cp // 8):
            for tap in range(9):
                unpacked[n * tile : n * tile + n, tap, 8 * blk : 8 * blk + 8] = wp[tile, blk, tap]
    assert not unpacked[..., ci:].any()
    assert torch.equal(unpacked[..., :ci].reshape(co, 3, 3, ci), w.to(torch.bfloat16))


def _nan_image(shape, seed, at):
    """Inputs with one NaN in image 0 at pixel ``at``, channel 3, and the
    same inputs without it."""
    x, wk, bias = _inputs(shape, seed=seed)
    clean = x.copy()
    x[(0, *at, 3)] = np.nan
    return x, clean, wk, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_relu_pool_reference_carries_nan_as_jax(dtype):
    """One NaN in one image: NaN in each pooled output whose 2x2 window
    holds a conv output that reads it (ReLU and the max carry it), as JAX's
    reference gives; every other output as without the NaN."""
    x, clean, wk, bias = _nan_image((2, 12, 16, 64, 64), seed=7, at=(5, 9))
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jconv.conv3x3_relu_maxpool_reference(
        jx, jnp.asarray(wk), jnp.asarray(bias)).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    w, b = _ohwi(wk), torch.from_numpy(bias)
    got = tconv.conv3x3_relu_maxpool(tx, w, b).float()
    nan = np.isnan(want)
    # conv rows 4-6 and columns 8-10 read pixel (5, 9): pooled rows 2-3, columns 4-5
    assert nan[0, 2:4, 4:6].all() and nan.sum() == 4 * 64
    np.testing.assert_array_equal(torch.isnan(got).numpy(), nan)
    before = tconv.conv3x3_relu_maxpool(torch.from_numpy(clean).to(tx.dtype), w, b).float()
    assert torch.equal(got[~torch.isnan(got)], before[~torch.isnan(got)])
    diff = (got - torch.from_numpy(want)).abs()[~torch.from_numpy(nan)]
    if dtype == "float32":
        assert diff.max().item() <= 1e-4
    else:
        ulp = _bf16_ulp(torch.from_numpy(want))[~torch.from_numpy(nan)]
        assert bool((diff <= ulp + 1e-6).all())


@pytest.mark.parametrize("pool", [True, False], ids=["pooled", "unpooled"])
def test_q8_reference_carries_nan_as_jax(pool):
    """One NaN in one image makes its scale NaN, so every output of that
    image is NaN, as the Pallas q8 kernel (pooled, in interpret mode) and
    QuantConv (unpooled, no ReLU) give; the other image is unchanged."""
    x, clean, wk, bias = _nan_image((2, 16, 32, 64, 64), seed=8, at=(7, 11))
    wq, sw = tconv.quantize_weight(_ohwi(wk))
    wq, tx, b = wq.contiguous(), torch.from_numpy(x), torch.from_numpy(bias)
    if pool:
        want = np.asarray(jconv.conv3x3_relu_maxpool_q8(
            jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bias), interpret=True))
        run = lambda t: tconv.conv3x3_relu_maxpool_q8(t, wq, sw, b)  # noqa: E731
    else:
        jmod = JQuantConv(features=64, dtype=jnp.float32)
        want = np.asarray(jmod.apply({"params": {"kernel": jnp.asarray(wk), "bias": jnp.asarray(bias)}},
                                     jnp.asarray(x)))
        run = lambda t: tconv.conv3x3_q8(t, wq, sw, b, relu=False)  # noqa: E731
    got = run(tx)
    assert np.isnan(want[0]).all() and not np.isnan(want[1]).any()
    assert bool(torch.isnan(got[0]).all())
    assert torch.equal(got[1], run(torch.from_numpy(clean))[1])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-5, atol=1e-4)
