"""ResNet convolutional trunks (18/34/50) in PyTorch.

Port of ``pyvisim_tpu/models/resnet.py``: the stem and stages 1..``n_stages``
of a torchvision ResNet, returning the last kept stage's ``(B, C, Hf, Wf)``
map before any pooling, for use as ``DeepConvFeature(module=...)``.

The modules carry torchvision's names (``conv1``, ``bn1``,
``layerS.B.convI``, ``layerS.B.bnI``, ``layerS.B.downsample.0/1``), so a
torchvision ResNet ``state_dict`` loads as it is; the JAX package's Flax
variables cross through :func:`params_from_jax`. BatchNorm always runs on
its running statistics with eps 1e-5, as the JAX trunk's
``use_running_average=True`` does, whatever ``train()`` says. The stem's
``-inf`` pad and VALID 3x3/2 max pool are ``max_pool2d(3, 2, padding=1)``.

With ``int8=True`` each block conv is routed at run time as the JAX
package's ``_block_conv`` routes it at trace time: int8
(:class:`~.quant.QuantConv`) where its input height lies in
[``int8_min_spatial``, ``int8_max_spatial``] and it has >= 64 input
channels, float otherwise; the 7x7 stem stays float. BatchNorm follows the
dequantised output. On CUDA the int8 3x3 stride-1 convs run through kernel
8 (no bias, no ReLU, no pool), the 1x1 and 3x3 stride-2 convs through
``quant.int8_gemm_conv``, whose epilogue takes the BatchNorm that follows
and, by the conv's place in its block, ReLU or the residual add and ReLU
(on the CPU the same call is the plain chain of torch passes); the int8
trunk runs channels-last.

Under ``profiling.record()`` the trunk opens the spans ``resnet.stem`` and
``resnet.layer1`` ... ``resnet.layer4``, and each call of an int8 trunk's
block conv adds one to the counter of the route it takes:
``resnet.float_convs``, ``resnet.int8_k8`` (kernel 8) or
``resnet.int8_gemm`` (``int8_gemm_conv``); a gemm-route call that takes
its BatchNorm into the epilogue adds one to ``resnet.int8_gemm_fused``
too.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..ops.cuda.int8_epilogue import batch_norm_tail, fuses_batch_norm
from . import quant
from .quant import QuantConv

__all__ = ["ResNetTrunk", "RESNET_CFGS", "init_params", "params_from_jax"]

# (block type, per-stage block counts)
RESNET_CFGS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
}
_STAGE_WIDTHS = (64, 128, 256, 512)
_STAGE_SPANS = tuple(f"resnet.layer{i + 1}" for i in range(4))


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, torchvision's keys) that normalises by
    its running statistics in every mode.

    Its scale, shift and statistics stay float32 under ``Module.to(dtype)``,
    as Flax's ``nn.BatchNorm(dtype=...)`` keeps its own: ``batch_norm``
    then takes a bf16 map with float32 parameters, normalises it in float32
    and rounds the result once to bf16, in one pass."""

    _FLOAT32 = ("weight", "bias", "running_mean", "running_var")

    def _apply(self, fn, recurse=True):
        kept = {n: getattr(self, n).data for n in self._FLOAT32}
        super()._apply(fn, recurse)
        for name, old in kept.items():
            new = getattr(self, name)
            if new.dtype != old.dtype:
                new.data = old.to(new.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)

    def batch_norm_args(self) -> tuple:
        """``(weight, bias, running_mean, running_var, eps)``: the ``bn`` that
        ``quant.int8_gemm_conv`` takes into its epilogue."""
        return self.weight, self.bias, self.running_mean, self.running_var, self.eps


def _bn_args(bn: FrozenBatchNorm2d | None) -> tuple | None:
    """``bn``'s arguments for ``int8_epilogue.batch_norm_tail``, or None."""
    return None if bn is None else bn.batch_norm_args()


class BlockConv(QuantConv):
    """A bias-less block conv of the int8 trunk, routed by its input: int8
    through ``QuantConv`` where :meth:`uses_int8` holds, else a float conv
    with ``w_x``, the float32 master in the trunk's dtype. Each call counts
    its route (see the module docstring).

    ``forward(x, bn, relu, residual)`` is ``relu(bn(conv(x)) [+ residual])``
    (each part when asked). Where the conv takes the int8 gemm route and
    ``int8_epilogue.fuses_batch_norm`` says the epilogue repeats the
    trunk's BatchNorm on this map (on the CPU, where it is the plain chain
    of the same passes, and for bf16 maps on CUDA), the BatchNorm, the
    residual add and ReLU run in ``int8_gemm_conv``'s epilogue. Elsewhere
    they run after the conv, a pass each."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: int, min_spatial: int, max_spatial: int):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=False)
        self.min_spatial, self.max_spatial = min_spatial, max_spatial
        self.register_buffer("w_x", torch.zeros(self.weight.shape), persistent=False)
        self._int8_counter = "resnet.int8_k8" if self._is_3x3_same else "resnet.int8_gemm"
        self._gemm = quant.gemm_route(self.kernel_size, stride, padding)
        self._derive()

    @torch.no_grad()
    def _derive(self) -> None:
        super()._derive()
        if getattr(self, "w_x", None) is not None:
            self.w_x = self.weight.to(self.w_x.dtype)

    def uses_int8(self, x: torch.Tensor) -> bool:
        """The JAX package's predicate on an NCHW input."""
        return self.min_spatial <= x.shape[2] <= self.max_spatial and x.shape[1] >= 64

    def forward(self, x: torch.Tensor, bn: FrozenBatchNorm2d | None = None, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if not self.uses_int8(x):
            profiling.count("resnet.float_convs", 1)
            return batch_norm_tail(F.conv2d(x, self.w_x, None, self.stride, self.padding),
                                   _bn_args(bn), relu, residual)
        profiling.count(self._int8_counter, 1)
        if not (self._gemm and bn is not None and fuses_batch_norm(x.dtype, x.device)):
            return batch_norm_tail(super().forward(x), _bn_args(bn), relu, residual)
        profiling.count("resnet.int8_gemm_fused", 1)
        y = quant.int8_gemm_conv(
            x.permute(0, 2, 3, 1), self.wq, self.sw, self.bias, stride=self.stride,
            padding=self.padding, bn=bn.batch_norm_args(), relu=relu,
            residual=None if residual is None else residual.permute(0, 2, 3, 1))
        return y.permute(0, 3, 1, 2)


def _conv_bn(conv: nn.Module, bn: FrozenBatchNorm2d, x: torch.Tensor, relu: bool = False,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(bn(conv(x)) [+ residual])``; a ``BlockConv`` takes all of it."""
    if isinstance(conv, BlockConv):
        return conv(x, bn, relu, residual)
    return batch_norm_tail(conv(x), _bn_args(bn), relu, residual)


def _conv_factory(int8: bool, lo: int, hi: int):
    def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Module:
        pad = k // 2
        if int8:
            return BlockConv(cin, cout, k, stride, pad, lo, hi)
        return nn.Conv2d(cin, cout, k, stride, pad, bias=False)

    return conv


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int, conv):
        super().__init__()
        self.conv1 = conv(cin, width, 3, stride)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = conv(width, width, 3)
        self.bn2 = FrozenBatchNorm2d(width)
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(conv(cin, width, 1, stride), FrozenBatchNorm2d(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else _conv_bn(*self.downsample, x)
        y = _conv_bn(self.conv1, self.bn1, x, relu=True)
        return _conv_bn(self.conv2, self.bn2, y, relu=True, residual=residual)


class Bottleneck(nn.Module):
    """Bottleneck of width ``width`` and output ``4 * width``; the stride
    sits on the 3x3 conv, as in torchvision and the JAX trunk."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int, conv):
        super().__init__()
        self.conv1 = conv(cin, width, 1)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = conv(width, width, 3, stride)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = conv(width, 4 * width, 1)
        self.bn3 = FrozenBatchNorm2d(4 * width)
        self.downsample = None
        if stride != 1 or cin != 4 * width:
            self.downsample = nn.Sequential(conv(cin, 4 * width, 1, stride),
                                            FrozenBatchNorm2d(4 * width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The shortcut first, so that conv3's epilogue can add it.
        residual = x if self.downsample is None else _conv_bn(*self.downsample, x)
        y = _conv_bn(self.conv1, self.bn1, x, relu=True)
        y = _conv_bn(self.conv2, self.bn2, y, relu=True)
        return _conv_bn(self.conv3, self.bn3, y, relu=True, residual=residual)


class ResNetTrunk(nn.Module):
    """ResNet feature trunk: stem + stages 1..``n_stages``;
    ``(B, 3, H, W) -> (B, C, Hf, Wf)``, the last kept stage's map.

    :param cfg_name: "resnet18", "resnet34" or "resnet50".
    :param n_stages: stages kept (1-4).
    :param int8: route the block convs through int8 where the input height
        lies in [``int8_min_spatial``, ``int8_max_spatial``] (see the module
        docstring); the same state dict loads into the float and the int8
        trunk.
    :param generator: the default initialisation draws, as Flax does,
        lecun-normal conv kernels, unit BatchNorm scales and zero shifts,
        means and unit variances, from this generator (seed 0 when None).
    """

    def __init__(
        self,
        cfg_name: str = "resnet50",
        n_stages: int = 4,
        int8: bool = False,
        int8_min_spatial: int = 7,
        int8_max_spatial: int = 56,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if cfg_name not in RESNET_CFGS:
            raise ValueError(f"Unknown ResNet config {cfg_name!r}; one of {sorted(RESNET_CFGS)}")
        if not 1 <= n_stages <= 4:
            raise ValueError(f"n_stages must lie in 1..4, got {n_stages}")
        self.cfg_name, self.n_stages = cfg_name, n_stages
        kind, counts = RESNET_CFGS[cfg_name]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        conv = _conv_factory(int8, int8_min_spatial, int8_max_spatial)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for stage in range(n_stages):
            blocks = []
            for blk in range(counts[stage]):
                stride = 2 if stage > 0 and blk == 0 else 1
                blocks.append(block_cls(cin, _STAGE_WIDTHS[stage], stride, conv))
                cin = _STAGE_WIDTHS[stage] * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.reset_parameters(generator)

    @property
    def out_channels(self) -> int:
        kind, _ = RESNET_CFGS[self.cfg_name]
        w = _STAGE_WIDTHS[self.n_stages - 1]
        return w if kind == "basic" else 4 * w

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, QuantConv)):
                fan_in = m.weight[0].numel()
                # Flax lecun_normal: variance 1/fan_in after truncation at +-2 std.
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                m.weight.copy_(w * std)
                if isinstance(m, QuantConv):
                    m._derive()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("resnet.stem"):
            x = torch.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in range(self.n_stages):
            with profiling.span(_STAGE_SPANS[stage]):
                x = getattr(self, f"layer{stage + 1}")(x)
        return x


def init_params(cfg_name: str = "resnet50", n_stages: int = 4, seed: int = 0
                ) -> Dict[str, torch.Tensor]:
    """A trunk's state dict drawn from ``torch.Generator().manual_seed(seed)``
    (see :class:`ResNetTrunk`)."""
    gen = torch.Generator().manual_seed(seed)
    return ResNetTrunk(cfg_name, n_stages, generator=gen).state_dict()


def params_from_jax(variables: Mapping, cfg_name: str = "resnet50", n_stages: int = 4
                    ) -> Dict[str, torch.Tensor]:
    """Convert the JAX trunk's Flax variables ``{"params", "batch_stats"}``
    (numpy arrays) to this trunk's ``state_dict``: kernels HWIO -> OIHW,
    BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``; the reverse of the JAX package's
    ``params_from_torch_state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    state: Dict[str, torch.Tensor] = {}

    def conv(key: str, tree) -> None:
        k = np.asarray(tree["kernel"], np.float32).transpose(3, 2, 0, 1)
        state[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(k))

    def bn(key: str, p, s) -> None:
        for name, v in (("weight", p["scale"]), ("bias", p["bias"]),
                        ("running_mean", s["mean"]), ("running_var", s["var"])):
            state[f"{key}.{name}"] = torch.from_numpy(np.array(v, np.float32))
        state[f"{key}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    _, counts = RESNET_CFGS[cfg_name]
    for stage in range(n_stages):
        for blk in range(counts[stage]):
            src, dst = f"layer{stage + 1}_{blk}", f"layer{stage + 1}.{blk}"
            p, s = params[src], stats[src]
            i = 1
            while f"conv{i}" in p:
                conv(f"{dst}.conv{i}", p[f"conv{i}"])
                bn(f"{dst}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
                i += 1
            if "downsample_conv" in p:
                conv(f"{dst}.downsample.0", p["downsample_conv"])
                bn(f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    return state
