"""The port's ResNet trunks against the JAX package's, float and int8.

Tolerances: float32 trunk outputs to 2e-5 * max|ref| (the two stacks sum
convolutions and fold BatchNorm in other orders); int32 sums of every
int8 route bit for bit; the int8 trunk against JAX's int8 trunk at cosine
> 0.9999 per image (a float difference of the order above can move a
value across a rounding boundary of the next int8 grid, one step of 127),
and against the float trunk at JAX's own gate, cosine > 0.995.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from pyvisim_tpu.features import DeepConvFeature as JDeepConvFeature
from pyvisim_tpu.models import quant as jquant
from pyvisim_tpu.models import resnet as jresnet
from pyvisim_tpu_torch import profiling
from pyvisim_tpu_torch.features import DeepConvFeature
from pyvisim_tpu_torch.models import quant as tquant
from pyvisim_tpu_torch.models import resnet as tresnet
from pyvisim_tpu_torch.models import vgg as tvgg
from pyvisim_tpu_torch.ops.cuda import conv as tconv
from pyvisim_tpu_torch.ops.cuda import int8_epilogue as tepi


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the port from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_variables(cfg, n_stages, seed=0):
    """Variables of JAX's trunk, drawn with numpy: He-scaled kernels, and
    BatchNorm statistics and affine parameters at random, so that the test
    reaches them. (Flax's eager ``init`` of resnet50 costs seconds.)"""
    tree = jax.eval_shape(lambda: jresnet.ResNetTrunk(cfg_name=cfg, n_stages=n_stages).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(leaf.shape[:3])
            return (rng.normal(size=leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.uniform(-0.3, 0.3, leaf.shape).astype(np.float32)
        return rng.uniform(0.6, 1.4, leaf.shape).astype(np.float32)  # var, scale

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def r50():
    """resnet50 at n_stages=4 (its 2-stage cut takes a prefix of these)."""
    return _jax_variables("resnet50", 4)


def _images(seed=1, b=2, size=64):
    return np.random.default_rng(seed).random((b, size, size, 3)).astype(np.float32)


def _port_trunk(cfg, n_stages, variables, **kw):
    model = tresnet.ResNetTrunk(cfg, n_stages, **kw).eval()
    model.load_state_dict(tresnet.params_from_jax(variables, cfg, n_stages))
    return model


def _run_port(model, x):
    with torch.no_grad():
        y = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


def _cosines(a, b):
    a, b = a.reshape(len(a), -1).astype(np.float64), b.reshape(len(b), -1).astype(np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("cfg, n_stages", [("resnet18", 2), ("resnet18", 4), ("resnet50", 2)])
def test_float_trunk_matches_jax(cfg, n_stages, r50):
    variables = r50 if cfg == "resnet50" else _jax_variables(cfg, n_stages)
    x = _images()
    want = np.asarray(jax.jit(jresnet.ResNetTrunk(cfg_name=cfg, n_stages=n_stages).apply)(
        variables, x))
    model = _port_trunk(cfg, n_stages, variables)
    got = _run_port(model, x)
    assert got.shape == want.shape and model.out_channels == want.shape[-1]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_state_dict_has_torchvision_names():
    keys = set(tresnet.ResNetTrunk("resnet18").state_dict())
    for k in ("conv1.weight", "bn1.running_mean", "bn1.num_batches_tracked",
              "layer1.1.conv2.weight", "layer2.0.downsample.0.weight",
              "layer4.0.downsample.1.running_var"):
        assert k in keys
    assert "layer1.0.downsample.0.weight" not in keys
    keys50 = set(tresnet.ResNetTrunk("resnet50", 3).state_dict())
    assert {"layer1.0.downsample.0.weight", "layer3.5.conv3.weight"} <= keys50
    # the int8 trunk takes the same state dict; init_params is seeded
    assert set(tresnet.ResNetTrunk("resnet18", int8=True).state_dict()) == keys
    a, b = tresnet.init_params("resnet18", 2, seed=3), tresnet.init_params("resnet18", 2, seed=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], tresnet.init_params("resnet18", 2)["conv1.weight"])


def test_batch_norm_uses_running_statistics_in_train_mode(r50):
    model = _port_trunk("resnet50", 2, r50).train()
    x = _images(b=1)
    want = _run_port(model.eval(), x)
    np.testing.assert_array_equal(_run_port(model.train(), x), want)


# The int8 routes on ResNet-like shapes: (kernel, stride, padding) and an
# odd side, so that strided taps meet the ragged edge.
ROUTES = {"1x1": (1, 1, 0), "1x1/2": (1, 2, 0), "3x3/2": (3, 2, 1)}


def _int8_operands(k, seed, b=2, h=9, w=7, cin=64, cout=72):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (cout, k, k, cin)).astype(np.int8)
    return xq, wq


def _lax_sums(xq, wq, stride, pad):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq.transpose(1, 2, 3, 0)), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_int8_route_sums_equal_lax_conv(route):
    """The rows and ``torch._int_mm`` product that the card runs, here on the
    CPU, and the plain version's float64 conv, against ``lax.conv`` on the
    same int8 operands: int32 sums bit for bit."""
    k, stride, pad = ROUTES[route]
    xq, wq = _int8_operands(k, seed=k + stride)
    want = _lax_sums(xq, wq, stride, pad)
    rows, (b, ho, wo) = tquant._im2col_rows(torch.from_numpy(xq), k, stride, pad)
    got = tquant._int_mm(rows, torch.from_numpy(wq).reshape(wq.shape[0], -1))
    np.testing.assert_array_equal(got.view(b, ho, wo, -1).numpy(), want)
    plain = tconv._int_conv(torch.from_numpy(xq), torch.from_numpy(wq), stride, pad)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert tquant.gemm_route((k, k), stride, pad)


def test_int_mm_pads_fewer_than_17_rows():
    """A 2x2 map of one image (layer 4's downsample at 64^2) has 4 rows."""
    xq, wq = _int8_operands(1, seed=5, b=1, h=3, w=3, cin=256, cout=512)
    rows, (b, ho, wo) = tquant._im2col_rows(torch.from_numpy(xq), 1, 2, 0)
    assert rows.shape[0] == 4
    got = tquant._int_mm(rows, torch.from_numpy(wq).reshape(512, -1)).view(b, ho, wo, -1)
    np.testing.assert_array_equal(got.numpy(), _lax_sums(xq, wq, 2, 0))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_quant_conv_matches_jax_quant_conv(route):
    """QuantConv (its plain version on the CPU) against JAX's QuantConv with
    the same float32 kernel, to 1e-6 * max|ref|: the same recipe, quantised
    activations equal, one float product of the int32 sums."""
    k, stride, pad = ROUTES[route]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 7, 64)).astype(np.float32)
    kernel = rng.normal(size=(k, k, 64, 64)).astype(np.float32) * 0.1
    jmod = jquant.QuantConv(64, kernel_size=(k, k), strides=(stride, stride), padding=(pad, pad),
                            use_bias=False, dtype=jnp.float32)
    want = np.asarray(jmod.apply({"params": {"kernel": kernel}}, x))
    tmod = tquant.QuantConv(64, 64, k, stride, pad, bias=False)
    tmod.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())})
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # int8_gemm_conv's CPU tensors take the plain version, int32 sums included
    y, acc = tquant.int8_gemm_conv(torch.from_numpy(x), tmod.wq, tmod.sw, stride=stride,
                                   padding=pad, return_acc=True)
    xq, _ = tconv.quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(acc.numpy(), _lax_sums(xq.numpy(), tmod.wq.numpy(), stride, pad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_int8_gemm_conv_on_the_cpu_is_the_plain_version(route, dtype):
    """Without BatchNorm, int8_gemm_conv's CPU branch (plain quantiser,
    exact conv, the epilogue's twin) equals quant_conv_reference bit for
    bit, sums included, in any float dtype, and returns a contiguous map."""
    k, stride, pad = ROUTES[route]
    g = torch.Generator().manual_seed(11)
    x = torch.randn(2, 9, 7, 64, generator=g).to(dtype)
    wq, sw = tconv.quantize_weight(torch.randn(72, k, k, 64, generator=g) * 0.05)
    b = torch.randn(72, generator=g)
    y, acc = tquant.int8_gemm_conv(x, wq, sw, b, stride=stride, padding=pad, return_acc=True)
    want, want_acc = tconv.quant_conv_reference(x, wq, sw, b, stride=stride, padding=pad,
                                                return_acc=True)
    assert y.dtype == dtype and y.is_contiguous()
    assert torch.equal(y, want) and torch.equal(acc, want_acc)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=str)
def test_int8_gemm_conv_refuses_other_dtypes_off_the_cpu(dtype):
    """Off the CPU the route takes float32 or bfloat16 maps only, and says
    so before any launch (a meta tensor reaches the check and no kernel)."""
    x = torch.empty((1, 8, 8, 64), dtype=dtype, device="meta")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tquant.int8_gemm_conv(x, torch.empty((64, 1, 1, 64), dtype=torch.int8, device="meta"),
                              torch.empty(64, device="meta"), stride=1, padding=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fuses_batch_norm_by_dtype_and_device(device, dtype):
    """The epilogue takes the BatchNorm on the CPU and for bf16 maps on the
    card; float32 maps on the card keep F.batch_norm (cuDNN's rounding)."""
    want = device == "cpu" or dtype == torch.bfloat16
    assert tepi.fuses_batch_norm(dtype, torch.device(device)) is want


def test_gemm_route_and_refusals():
    assert tquant.gemm_route(1, 1, "SAME") and tquant.gemm_route((1, 1), 2, "VALID")
    for args in [((3, 3), 1, 1), ((3, 3), 2, "SAME"), ((1, 1), 3, 0), ((7, 7), 2, 3),
                 ((1, 1), 1, 1)]:
        assert not tquant.gemm_route(*args)
    # a device other than the CPU reaches the route's shape checks first
    x = torch.empty((1, 8, 8, 64), device="meta")
    with pytest.raises(NotImplementedError, match="int8_gemm_conv runs"):
        tquant.int8_gemm_conv(x, torch.empty((64, 7, 7, 64), dtype=torch.int8, device="meta"),
                              torch.empty(64, device="meta"), stride=2, padding=3)
    m = tquant.QuantConv(64, 64, 5, 1, 2).to("meta")
    with pytest.raises(NotImplementedError, match="QuantConv on meta"):
        m(torch.empty((1, 64, 8, 8), device="meta").to(memory_format=torch.channels_last))


@pytest.fixture(scope="module")
def int8_pair(r50):
    """JAX's resnet50 float and int8 (window 7-56) outputs on two 64^2
    images: convs at 16^2 and 8^2 int8, at 4^2 and 2^2 float."""
    x = _images(seed=2)
    want_f = np.asarray(jax.jit(jresnet.ResNetTrunk(cfg_name="resnet50").apply)(r50, x))
    want_q = np.asarray(jax.jit(jresnet.ResNetTrunk(cfg_name="resnet50", int8=True).apply)(r50, x))
    return x, want_f, want_q


def test_int8_trunk_matches_jax_int8_trunk(r50, int8_pair):
    x, want_f, want_q = int8_pair
    model = _port_trunk("resnet50", 4, r50, int8=True)
    routes = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: routes.__setitem__(name, mod.uses_int8(args[0])))
        for name, m in model.named_modules() if isinstance(m, tquant.RoutedConv)]
    got = _run_port(model, x)
    for h in hooks:
        h.remove()
    assert routes["layer1.0.conv1"] and routes["layer3.0.downsample.0"]
    assert not routes["layer3.1.conv1"] and not routes["layer4.2.conv3"]
    assert (_cosines(got, want_q) > 0.9999).all(), _cosines(got, want_q)
    assert (_cosines(got, want_f) > 0.995).all(), _cosines(got, want_f)
    assert (_cosines(want_q, want_f) > 0.995).all()


def test_deep_conv_feature_with_resnet_matches_jax(r50):
    """Descriptors of DeepConvFeature(module=ResNetTrunk) against JAX's on a
    ragged image resized to 64^2, float and int8 (window 1-64)."""
    cfg, n = "resnet50", 2
    variables = {"params": {k: v for k, v in r50["params"].items() if not k.startswith(("layer3", "layer4"))},
                 "batch_stats": {k: v for k, v in r50["batch_stats"].items()
                                 if not k.startswith(("layer3", "layer4"))}}
    img = (np.random.default_rng(3).random((80, 60, 3)) * 255).astype(np.uint8)
    state = tresnet.params_from_jax(variables, cfg, n)
    for int8 in (False, True):
        kw = dict(int8=True, int8_min_spatial=1, int8_max_spatial=64) if int8 else {}
        jext = JDeepConvFeature(module=jresnet.ResNetTrunk(cfg_name=cfg, n_stages=n, **kw),
                                params=variables, image_size=64)
        ext = DeepConvFeature(module=tresnet.ResNetTrunk(cfg, n, **kw), params=state,
                              image_size=64, device="cpu")
        assert ext._channels_last == int8  # a QuantConv trunk runs channels-last
        want, got = jext(img), ext(img)
        assert got.shape == want.shape == (64, 514) and ext.output_dim == 514
        if int8:
            assert _cosines(got[None], want[None])[0] > 0.9999
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_int8_scales_follow_the_device_as_jax_follows_jit():
    """``max|x| / 127``: PyTorch divides a CPU tensor exactly, as eager JAX
    does, and a CUDA tensor by the product with float32(1/127), as XLA does
    under jit. The two differ in one ulp for a few % of scales, so a value
    at a rounding tie can quantise one step apart on the CPU and the card
    (a known limit, not a fault: each device matches one of JAX's modes)."""
    rng = np.random.default_rng(12)
    x = (rng.random((512, 3, 3, 8)) * rng.random((512, 1, 1, 1)) * 100).astype(np.float32)
    scale = lambda a: jnp.maximum(jnp.max(jnp.abs(a), axis=(1, 2, 3)) / 127.0, 1e-8)
    eager, jitted = np.asarray(scale(x)), np.asarray(jax.jit(scale)(x))
    np.testing.assert_array_equal(tconv.activation_scale(torch.from_numpy(x)).numpy(), eager)
    amax = torch.from_numpy(np.abs(x).max(axis=(1, 2, 3)))
    np.testing.assert_array_equal(torch.clamp_min(amax * (1.0 / 127.0), 1e-8).numpy(), jitted)
    assert 0 < (eager != jitted).mean() < 0.1


def _jax_variables_wide_bn(cfg, n_stages, seed=0):
    """As :func:`_jax_variables`, with BatchNorm far from its default: mean
    N(0, 1), var e^N(0, 1), scale 1 + 0.2 N and bias 0.2 N. Where the
    statistics are 0 and 1, a BatchNorm rounded to bf16 is exact."""
    rng = np.random.default_rng(seed + 1)
    draws = {"mean": lambda s: rng.normal(size=s), "var": lambda s: np.exp(rng.normal(size=s)),
             "scale": lambda s: 1 + 0.2 * rng.normal(size=s),
             "bias": lambda s: 0.2 * rng.normal(size=s)}

    def draw(path, leaf):
        name = path[-1].key
        return leaf if name == "kernel" else draws[name](leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _jax_variables(cfg, n_stages, seed))


def test_bf16_trunk_keeps_batch_norm_in_float32():
    """The bf16 trunk against JAX's ``ResNetTrunk(dtype=bfloat16)``, each
    held against JAX's float32 trunk: 1 - cosine per image, the port's at
    most 1.1 times JAX's. Flax keeps BatchNorm's parameters and statistics
    in float32 and rounds its output once; so must the port, after
    ``Module.to(bfloat16)``.

    JAX's side is compiled with ``xla_allow_excess_precision`` off, so that
    XLA rounds every bf16 result as the trunk's dtype says (and as cuDNN
    does on the card); with it on, XLA on the CPU keeps the conv outputs in
    float32 into BatchNorm."""
    cfg, n_stages = "resnet18", 4
    variables = _jax_variables_wide_bn(cfg, n_stages)
    x = _images(b=4)
    want = np.asarray(jax.jit(jresnet.ResNetTrunk(cfg_name=cfg, n_stages=n_stages).apply)(
        variables, x))
    j16 = jax.jit(jresnet.ResNetTrunk(cfg_name=cfg, n_stages=n_stages, dtype=jnp.bfloat16).apply)
    j16 = j16.lower(variables, x).compile(compiler_options={"xla_allow_excess_precision": False})
    jax_bf16 = np.asarray(j16(variables, x).astype(jnp.float32))
    model = _port_trunk(cfg, n_stages, variables).to(torch.bfloat16)
    for name in ("weight", "bias", "running_mean", "running_var"):
        assert getattr(model.layer1[0].bn1, name).dtype == torch.float32
    with torch.no_grad():
        y = model(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    port = y.float().permute(0, 2, 3, 1).numpy()
    jax_gap, port_gap = 1 - _cosines(jax_bf16, want), 1 - _cosines(port, want)
    assert (jax_gap > 0).all()
    assert (port_gap <= 1.1 * jax_gap).all(), (port_gap, jax_gap)


def _frozen_bn(c, seed):
    """BatchNorm away from identity, as the ResNet cell draws it."""
    g = torch.Generator().manual_seed(seed)
    bn = tresnet.FrozenBatchNorm2d(c)
    bn.load_state_dict({"weight": torch.rand(c, generator=g) + 0.5,
                        "bias": 0.1 * torch.randn(c, generator=g),
                        "running_mean": 0.1 * torch.randn(c, generator=g),
                        "running_var": 1.5 * torch.rand(c, generator=g) + 0.5,
                        "num_batches_tracked": torch.tensor(0)})
    return bn


MODES = {"bn": (False, False), "bn_relu": (True, False), "bn_residual_relu": (True, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fused_gemm_call_equals_the_module_chain(route, mode, dtype):
    """A gemm-route RoutedConv called with its BatchNorm (and ReLU, and the
    residual) takes them into int8_gemm_conv's epilogue, whose CPU twin
    equals the chain of module passes bit for bit; the counter records the
    fused call."""
    k, stride, pad = ROUTES[route]
    relu, with_residual = MODES[mode]
    conv = tquant.RoutedConv(64, 72, k, stride, pad, bias=False, min_spatial=1, max_spatial=64)
    g = torch.Generator().manual_seed(k + stride)
    conv.load_state_dict({"weight": torch.randn(72, 64, k, k, generator=g) * 0.05})
    conv, bn = conv.to(dtype), _frozen_bn(72, seed=k).to(dtype)
    x = torch.randn(2, 64, 9, 7, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    ho, wo = (9 + 2 * pad - k) // stride + 1, (7 + 2 * pad - k) // stride + 1
    residual = torch.randn(2, 72, ho, wo, generator=g).to(dtype) if with_residual else None
    with torch.no_grad(), profiling.record() as rec:
        got = conv(x, bn, relu, residual)
    assert rec.counters() == {"conv.int8_gemm": 1, "conv.int8_gemm_fused": 1}
    with torch.no_grad():
        want = bn(tquant.QuantConv.forward(conv, x))
        want = want + residual if with_residual else want
        want = torch.relu(want) if relu else want
    assert got.dtype == dtype and torch.equal(got, want)
    # the same from the sums, through the epilogue's own twin
    xh = x.permute(0, 2, 3, 1)
    _, acc = tquant.int8_gemm_conv(xh, conv.wq, conv.sw, stride=stride, padding=pad,
                                   return_acc=True)
    plain = tepi.gemm_epilogue(acc, tconv.activation_scale(xh), conv.sw, dtype=dtype,
                               bn=bn.batch_norm_args(), relu=relu,
                               residual=None if residual is None else residual.permute(0, 2, 3, 1))
    assert torch.equal(plain, want.permute(0, 2, 3, 1))


def test_block_convs_off_the_gemm_route_keep_their_passes(monkeypatch):
    """Kernel 8's 3x3/1 conv and a conv outside the int8 window take the
    BatchNorm after the conv, unfused and uncounted as fused. The conv's
    map reaches the BatchNorm as a temporary that nothing else holds, so
    it is freed as soon as BatchNorm has read it (a map held through the
    add and ReLU raised the ResNet cell's peak by one map of layer1)."""
    x = torch.randn(1, 64, 8, 8, generator=torch.Generator().manual_seed(3))
    bn = _frozen_bn(64, seed=4)
    refs, tail = [], tepi.batch_norm_tail

    def counted_tail(y, *args):
        refs.append(sys.getrefcount(y))  # this frame's name and the call's argument
        return tail(y, *args)

    monkeypatch.setattr(tepi, "batch_norm_tail", counted_tail)
    for conv, route in ((tquant.RoutedConv(64, 64, 3, 1, 1, bias=False, min_spatial=1,
                                           max_spatial=64), "conv.int8_k8"),
                        (tquant.RoutedConv(64, 64, 1, 1, 0, bias=False, min_spatial=16,
                                           max_spatial=64), "conv.cudnn")):
        conv.load_state_dict({"weight": torch.randn(conv.weight.shape,
                                                    generator=torch.Generator().manual_seed(5))})
        with torch.no_grad(), profiling.record() as rec:
            got = conv(x, bn, True)
        assert rec.counters() == {route: 1}
        assert refs == [2], refs
        refs.clear()
        with torch.no_grad():
            assert torch.equal(got, torch.relu(bn(conv(x))))


def _old_block_order(block, x):
    """The blocks' forward before the shortcut moved first: the residual
    computed last, through ``downsample`` as a Sequential."""
    if isinstance(block, tresnet.Bottleneck):
        y = torch.relu(block.bn1(block.conv1(x)))
        y = torch.relu(block.bn2(block.conv2(y)))
        y = block.bn3(block.conv3(y))
    else:
        y = torch.relu(block.bn1(block.conv1(x)))
        y = block.bn2(block.conv2(y))
    residual = x if block.downsample is None else block.downsample(x)
    return torch.relu(y + residual)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("kind, cin, stride", [("bottleneck", 128, 2), ("bottleneck", 256, 1),
                                               ("basic", 64, 2)])
def test_blocks_with_the_shortcut_first_equal_the_old_order(kind, cin, stride, int8):
    """Computing the shortcut (downsample) first and handing it to the last
    conv's call changes no value, float or int8, with BatchNorm away from
    identity."""
    conv = tresnet._conv_factory(int8, 1, 64)
    block_cls = tresnet.Bottleneck if kind == "bottleneck" else tresnet.BasicBlock
    block = block_cls(cin, 64, stride, conv).eval()
    g = torch.Generator().manual_seed(cin + stride)
    for i, m in enumerate(block.modules()):
        if isinstance(m, tresnet.FrozenBatchNorm2d):
            m.load_state_dict(_frozen_bn(m.num_features, seed=i).state_dict())
        elif isinstance(m, (torch.nn.Conv2d, tquant.QuantConv)):
            m.load_state_dict({"weight": torch.randn(m.weight.shape, generator=g)
                               / m.weight[0].numel() ** 0.5})
    x = torch.randn(2, cin, 10, 10, generator=g).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(block(x), _old_block_order(block, x))


# Route counts of one forward at 32^2 with every block conv int8 (window
# 1-64), and of the int8 VGG16 at 224^2 (the routes that
# tests/test_torch_int8.py's test_int8_trunk_routes_as_jax asserts).
TRUNK_ROUTES = {
    "resnet18": {"conv.int8_k8": 13, "conv.int8_gemm": 6, "conv.int8_gemm_fused": 6},
    "resnet50": {"conv.int8_k8": 6, "conv.int8_gemm": 17, "conv.int8_gemm_fused": 17},
    "vgg16": {"conv.cudnn": 5, "conv.k7": 2, "conv.int8_k8": 6},
}


@pytest.mark.parametrize("cfg, n_stages", [("resnet18", 4), ("resnet50", 2),
                                           pytest.param("vgg16", None, id="vgg16-224")])
def test_every_gemm_route_call_of_an_int8_trunk_takes_its_batch_norm(cfg, n_stages):
    """Each gemm-route conv of an int8 trunk is followed by a BatchNorm, so
    ``conv.int8_gemm_fused`` equals ``conv.int8_gemm``: ResNet18's
    stride-2 conv1s and downsamples, every ResNet50 1x1 and 3x3/2 conv.
    Every route of a forward is counted once a conv, in the VGG trunk too."""
    if cfg == "vgg16":
        model, side = tvgg.VGGConvFeatures("vgg16", int8=True), 224
    else:
        model, side = tresnet.ResNetTrunk(cfg, n_stages, int8=True, int8_min_spatial=1,
                                          int8_max_spatial=64).eval(), 32
    with torch.no_grad(), profiling.record() as rec:
        model(torch.rand(1, 3, side, side).contiguous(memory_format=torch.channels_last))
    assert {k: v for k, v in rec.counters().items() if k.startswith("conv.")} == TRUNK_ROUTES[cfg]
