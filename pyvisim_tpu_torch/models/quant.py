"""The int8 convolution of the inference trunks.

Port of ``pyvisim_tpu/models/quant.py``. Quantisation is dynamic and
symmetric: per-IMAGE activation scales (a per-tensor scale would make an
image's descriptors depend on its batchmates), per-output-channel weight
scales taken from the float32 weights, int8 x int8 -> int32 accumulation,
then ``float(acc) * (sx * sw) + bias`` in float32 and one rounding to the
input's dtype.

The float32 weight and bias are buffers under torch's conv names
(``weight (Cout, Cin, kh, kw)``, ``bias``), so a torchvision-named state
dict loads into a float and an int8 trunk alike. They stay float32 whatever
``Module.to`` is asked, because the recipe quantises and adds the float32
values; the int8 weights and their scales are derived from them on every
load and every move.

:class:`QuantConv` is always int8. :class:`RoutedConv`, the conv of both
int8 trunks, decides on each call whether it runs int8 or float, through
which kernel, and what fuses into it.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..ops.cuda import conv as conv_ops
from ..ops.cuda import int8_epilogue as epilogue_ops
from ..ops.cuda.aggregate import launch_target

__all__ = ["QuantConv", "RoutedConv", "int8_gemm_conv", "gemm_route", "lecun_normal_"]


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def gemm_route(kernel_size, stride: int, padding) -> bool:
    """Whether :func:`int8_gemm_conv` runs this conv on CUDA: a 1x1 conv at
    stride 1 or 2 without padding ("SAME" pads a 1x1 conv by nothing), or a
    3x3 conv at stride 2 with padding 1."""
    k, p = _pair(kernel_size), padding if isinstance(padding, str) else _pair(padding)
    if k == (1, 1):
        return stride in (1, 2) and p in ("SAME", "VALID", (0, 0))
    return k == (3, 3) and stride == 2 and p == (1, 1)


def _im2col_rows(xq: torch.Tensor, kh: int, stride: int, pad: int):
    """NHWC int8 ``xq`` as the ``(B * H' * W', kh * kh * Cin)`` rows of a
    ``kh x kh`` conv at ``stride`` with ``pad`` zeros around, taps in the
    order of ``wq (Cout, kh, kw, Cin)``; and ``(B, H', W')``."""
    b, h, w, c = xq.shape
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kh) // stride + 1
    if kh == 1:
        taps = xq[:, : stride * (ho - 1) + 1 : stride, : stride * (wo - 1) + 1 : stride]
        return taps.reshape(b * ho * wo, c), (b, ho, wo)
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
    taps = [xp[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride]
            for dy in range(kh) for dx in range(kh)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kh * c), (b, ho, wo)


def _int_mm(rows: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``rows (M, K) @ w2 (N, K).T`` in int32 through ``torch._int_mm``,
    which takes more than 16 rows: fewer are padded with zero rows."""
    m = rows.shape[0]
    if m <= 16:
        rows = F.pad(rows, (0, 0, 0, 17 - m))
    return torch._int_mm(rows.contiguous(), w2.T)[:m]


def int8_gemm_conv(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                   b: torch.Tensor | None = None, *, stride: int, padding,
                   return_acc: bool = False, bn=None, relu: bool = False,
                   residual: torch.Tensor | None = None):
    """``QuantConv``'s exact int32 route for the convs of :func:`gemm_route`,
    optionally followed by a frozen BatchNorm, a residual add and ReLU.

    ``x (B, H, W, Cin)`` float32 or bfloat16 NHWC; ``wq (Cout, kh, kw, Cin)``
    int8 and ``sw (Cout,)``; ``b (Cout,)`` or None. ``x`` is quantised per
    image on its whole extent by kernel 8's amax and quantise launches
    (``ops/cuda/conv.py``; bit for bit with
    :func:`~..ops.cuda.conv.quantize_activation`), then cut into the conv's
    rows (a strided slice for 1x1, an int8 im2col for 3x3), and the int32
    sums are ``torch._int_mm`` of those rows with ``wq`` as a ``(Cout, K)``
    matrix (K and Cout multiples of 8; fewer than 17 rows are padded with
    zero rows, which add nothing). One launch of the epilogue kernel
    (:func:`~..ops.cuda.int8_epilogue.gemm_epilogue`) then writes
    ``float(acc) * (sx * sw) + b`` rounded once to ``x.dtype`` and, when
    given, ``bn`` (``(weight, bias, running_mean, running_var, eps)``, as
    ``F.batch_norm`` takes them), ``+ residual`` (NHWC, of the output's
    shape and dtype) and ReLU, rounding where separate torch passes round:
    the result equals :func:`~..ops.cuda.conv.quant_conv_reference` followed
    by :func:`~..ops.cuda.int8_epilogue.batch_norm_tail` on the NCHW views,
    bit for bit (on the card, with ``F.batch_norm`` run by ATen's own
    kernel: always for bf16, for float32 on NCHW-contiguous maps; see the
    epilogue's module). CPU
    tensors take the plain quantiser, the exact conv of the plain version
    and the epilogue's plain twin. ``launches`` counts the CUDA calls.
    """
    if x.device.type == "cpu":
        xq, sx = conv_ops.quantize_activation(x.contiguous())
        acc = conv_ops._int_conv(xq, wq, stride, padding)
        y = epilogue_ops.gemm_epilogue(acc, sx, sw, b, dtype=x.dtype, bn=bn, relu=relu,
                                       residual=residual)
        return (y, acc) if return_acc else y
    kh, kw = wq.shape[1], wq.shape[2]
    if not gemm_route((kh, kw), stride, padding) or wq.shape[3] != x.shape[3]:
        raise NotImplementedError(
            f"int8_gemm_conv runs 1x1 convs at stride 1 or 2 and 3x3 convs at stride 2 with "
            f"padding 1; got kernel {(kh, kw)}, stride {stride}, padding {padding!r}, "
            f"x {tuple(x.shape)}, wq {tuple(wq.shape)}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_gemm_conv takes float32 or bfloat16 maps on CUDA, not {x.dtype}")
    cin, cout, k = x.shape[3], wq.shape[0], kh * kw * wq.shape[3]
    if k % 8 or cout % 8:
        raise ValueError(f"torch._int_mm needs Cin * kh * kw ({k}) and Cout ({cout}) "
                         "to be multiples of 8")
    if x.shape[0] > 65535 or x.shape[1] * x.shape[2] * conv_ops._padded_channels(cin) >= 2**31:
        raise ValueError(f"input too large for kernel 8's quantiser: {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # kernel 8's passes read 16 bytes at a time
        x = x.clone()
    lib = conv_ops._library()
    dev, stream = launch_target(x.device)
    sx = conv_ops._scale_launch(lib, x, dev, stream)
    xq = conv_ops._quantize_launch(lib, x, sx, dev, stream)[..., :cin]
    rows, (bsz, ho, wo) = _im2col_rows(xq, kh, stride, 0 if kh == 1 else 1)
    acc = _int_mm(rows, wq.reshape(cout, k)).view(bsz, ho, wo, cout)
    y = epilogue_ops.gemm_epilogue(acc, sx, sw, b, dtype=x.dtype, bn=bn, relu=relu,
                                   residual=residual)
    int8_gemm_conv.launches += 1
    return (y, acc) if return_acc else y


int8_gemm_conv.launches = 0


class QuantConv(nn.Module):
    """int8 convolution, ``(B, Cin, H, W) -> (B, Cout, H', W')`` in the
    input's dtype (channels-last in and out on CUDA).

    On the CPU any kernel size, stride and padding ("SAME" as Flax pads it,
    "VALID", an int or an (h, w) pair) run through the plain version. On
    CUDA the 3x3, stride-1, SAME (or padding 1) conv runs through kernel 8
    (``ops.cuda.conv.conv3x3_q8``), the convs of :func:`gemm_route`
    through :func:`int8_gemm_conv` (without ReLU; JAX leaves them to XLA);
    other shapes raise ``NotImplementedError``. ``relu`` applies ReLU in
    the kernel's epilogue, which equals ``relu(QuantConv(...)(x))``.
    """

    # Float32 masters; everything else is derived from them by _derive.
    _MASTERS = ("weight", "bias")

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int | Sequence[int] = 3,
        stride: int = 1,
        padding: str | int | Sequence[int] = "SAME",
        bias: bool = True,
        relu: bool = False,
    ):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = (kh, kw)
        self.stride = stride
        self.padding = padding
        self.relu = relu
        self.register_buffer("weight", torch.zeros(out_channels, in_channels, kh, kw))
        self.register_buffer("bias", torch.zeros(out_channels) if bias else None)
        self.register_buffer(
            "wq", torch.zeros((out_channels, kh, kw, in_channels), dtype=torch.int8),
            persistent=False,
        )
        self.register_buffer("sw", torch.ones(out_channels), persistent=False)
        # The int8 route of this geometry: kernel 8, the gemm route (without
        # ReLU) or the plain version, which runs on the CPU only.
        same = (kh, kw) == (3, 3) and stride == 1 and padding in ("SAME", 1, (1, 1), [1, 1])
        self._int8_route = ("int8_k8" if same else "int8_gemm"
                            if gemm_route((kh, kw), stride, padding) and not relu else "int8_plain")
        self._derive()

    @torch.no_grad()
    def _derive(self) -> None:
        """Requantise: ``wq (Cout, kh, kw, Cin)`` int8 and ``sw (Cout,)``
        from the float32 weight."""
        wq, sw = conv_ops.quantize_weight(self.weight.permute(0, 2, 3, 1))
        self.wq, self.sw = wq.contiguous(), sw

    def _apply(self, fn, recurse=True):
        # Module.to() may move the masters but not cast them; derived
        # tensors are rebuilt from them, in their own dtype and layout.
        masters = {n: self._buffers[n] for n in self._MASTERS if self._buffers[n] is not None}
        super()._apply(fn, recurse)
        for name, old in masters.items():
            self._buffers[name] = old.to(self._buffers[name].device)
        self._derive()
        return self

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._derive()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._int8(x, self.relu)

    def _int8(self, x: torch.Tensor, relu: bool, bn=None,
              residual: torch.Tensor | None = None) -> torch.Tensor:
        """The int8 conv of NCHW ``x`` on this geometry's route, with ReLU in
        its epilogue if ``relu``; the gemm route's also takes ``bn`` and the
        NCHW ``residual``."""
        xh = x.permute(0, 2, 3, 1)
        if self._int8_route == "int8_k8":
            if x.device.type == "cpu":
                xh = xh.contiguous()
            y = conv_ops.conv3x3_q8(xh, self.wq, self.sw, self.bias, relu=relu)
        elif self._int8_route == "int8_gemm":
            y = int8_gemm_conv(xh, self.wq, self.sw, self.bias, stride=self.stride,
                               padding=self.padding, bn=bn, relu=relu,
                               residual=None if residual is None else residual.permute(0, 2, 3, 1))
        elif x.device.type == "cpu":
            y = conv_ops.quant_conv_reference(
                xh.contiguous(), self.wq, self.sw, self.bias, stride=self.stride,
                padding=self.padding, relu=relu,
            )
        else:
            raise NotImplementedError(
                f"QuantConv on {x.device.type} runs the 3x3 stride-1 SAME conv, 1x1 convs at "
                f"stride 1 or 2 and the 3x3 stride-2 conv with padding 1 (the last two without "
                f"ReLU); not kernel {self.kernel_size}, stride {self.stride}, padding "
                f"{self.padding!r}, relu={self.relu}."
            )
        return y.permute(0, 3, 1, 2)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, "
                f"stride={self.stride}, padding={self.padding!r}, "
                f"bias={self.bias is not None}, relu={self.relu}")


class RoutedConv(QuantConv):
    """A conv of an int8 trunk, routed on each call by its input as the
    JAX package routes it at trace time: int8 where :meth:`uses_int8`
    holds, float otherwise. ``pool`` fuses VGG's ReLU and 2x2 max pool into
    a 3x3 stride-1 conv. A call adds one to ``conv.<route>`` (:meth:`route`):

    - ``int8_k8``: 3x3 at stride 1 through kernel 8, pooled or not;
    - ``int8_gemm``: 1x1, and 3x3 at stride 2, through :func:`int8_gemm_conv`;
    - ``int8_plain``: another int8 geometry, the plain version (CPU only);
    - ``k7``: float with the pool, kernel 7 with the float32 bias;
    - ``cudnn``: float without it, ``F.conv2d`` on ``w_x`` and ``bias_x``.

    ``forward(x, bn, relu, residual)`` is ``relu(bn(conv(x)) [+ residual])``,
    each part when asked, ``bn`` a ``resnet.FrozenBatchNorm2d``. Where
    ``int8_epilogue.fuses_batch_norm`` holds, the gemm route's epilogue
    takes all of it (and the call adds to ``conv.int8_gemm_fused``); else
    the conv's own kernel takes a ReLU that nothing else follows, and the
    rest runs after it, a torch pass each.

    ``w_x (Cout, kh, kw, Cin)`` and ``bias_x`` are the float weight and
    bias in the trunk's dtype, derived from the float32 masters as
    ``wq``/``sw`` are, so ``Module.to(dtype)`` sets that dtype.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True, relu: bool = False, *,
                 pool: bool = False, min_spatial: int, max_spatial: int):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias,
                         relu or pool)
        if pool and self._int8_route != "int8_k8":
            raise ValueError("pool fuses into a 3x3 stride-1 conv with padding 1 only")
        self.pool = pool
        self.min_spatial, self.max_spatial = min_spatial, max_spatial
        self.register_buffer("w_x", torch.zeros(out_channels, *self.kernel_size, in_channels),
                             persistent=False)
        self.register_buffer("bias_x", torch.zeros(out_channels) if bias else None,
                             persistent=False)
        self._derive()

    @torch.no_grad()
    def _derive(self) -> None:
        super()._derive()
        if getattr(self, "w_x", None) is not None:
            dtype = self.w_x.dtype
            self.w_x = self.weight.permute(0, 2, 3, 1).to(dtype).contiguous()
            self.bias_x = None if self.bias is None else self.bias.to(dtype)

    def uses_int8(self, x: torch.Tensor) -> bool:
        """The JAX package's predicate on an NCHW input."""
        return self.min_spatial <= x.shape[2] <= self.max_spatial and x.shape[1] >= 64

    def route(self, x: torch.Tensor) -> str:
        """The route of a call on the NCHW input ``x`` (see the class)."""
        if self.uses_int8(x):
            return self._int8_route
        return "k7" if self.pool else "cudnn"

    def forward(self, x: torch.Tensor, bn: nn.Module | None = None, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        relu = relu or self.relu
        route = self.route(x)
        profiling.count("conv." + route, 1)
        if route == "k7":
            y = conv_ops.conv3x3_relu_maxpool(x.permute(0, 2, 3, 1), self.w_x, self.bias)
            return y.permute(0, 3, 1, 2)
        if self.pool:
            y = conv_ops.conv3x3_relu_maxpool_q8(x.permute(0, 2, 3, 1), self.wq, self.sw, self.bias)
            return y.permute(0, 3, 1, 2)
        bn = None if bn is None else bn.batch_norm_args()
        if route == "int8_gemm" and bn is not None and epilogue_ops.fuses_batch_norm(
                x.dtype, x.device):
            profiling.count("conv.int8_gemm_fused", 1)
            return self._int8(x, relu, bn, residual)
        if bn is None and residual is None:  # the conv's own epilogue takes the ReLU
            return self._conv(x, route, relu)
        # The conv's map is passed as a temporary, so that it is dropped as
        # soon as BatchNorm has read it.
        return epilogue_ops.batch_norm_tail(self._conv(x, route, False), bn, relu, residual)

    def _conv(self, x: torch.Tensor, route: str, relu: bool) -> torch.Tensor:
        """The conv alone on ``route`` (cuDNN or int8), with ReLU if ``relu``."""
        if route != "cudnn":
            return self._int8(x, relu)
        y = F.conv2d(x, self.w_x.permute(0, 3, 1, 2), self.bias_x, self.stride, self.padding)
        return torch.relu_(y) if relu else y

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, pool={self.pool}"


@torch.no_grad()
def lecun_normal_(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """Draw every conv and dense kernel of ``module``, in module order, as
    Flax's ``nn.Conv`` and ``nn.Dense`` draw it (lecun-normal: a normal
    truncated at +-2 std, scaled to variance 1/fan_in) from ``generator``
    (seed 0 when None) on the CPU, and zero their biases; an int8 conv
    requantises."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, QuantConv)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            m.weight.copy_(w * std)
            if m.bias is not None:
                m.bias.zero_()
            if isinstance(m, QuantConv):
                m._derive()
