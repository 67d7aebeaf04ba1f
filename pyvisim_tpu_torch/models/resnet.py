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

With ``int8=True`` each block conv is a :class:`~.quant.RoutedConv`,
routed at run time as the JAX package's ``_block_conv`` routes it at trace
time: int8 where its input height lies in [``int8_min_spatial``,
``int8_max_spatial``] and it has >= 64 input channels, float otherwise;
the 7x7 stem stays float. Each block conv is called with the BatchNorm,
ReLU and residual add that follow it, and takes what its route fuses (see
``RoutedConv``); the int8 trunk runs channels-last.

Under ``profiling.record()`` the trunk opens the spans ``resnet.stem`` and
``resnet.layer1`` ... ``resnet.layer4``; its block convs count their routes
(``conv.*``).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..ops.cuda.int8_epilogue import batch_norm_tail
from .quant import RoutedConv, lecun_normal_

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
        return batch_norm_tail(x, self.batch_norm_args())

    def batch_norm_args(self) -> tuple:
        """``(weight, bias, running_mean, running_var, eps)``: the ``bn`` that
        ``int8_epilogue.batch_norm_tail`` and ``quant.int8_gemm_conv`` take."""
        return self.weight, self.bias, self.running_mean, self.running_var, self.eps


def _conv_bn(conv: nn.Module, bn: FrozenBatchNorm2d, x: torch.Tensor, relu: bool = False,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(bn(conv(x)) [+ residual])``; a ``RoutedConv`` takes all of it."""
    if isinstance(conv, RoutedConv):
        return conv(x, bn, relu, residual)
    return batch_norm_tail(conv(x), bn.batch_norm_args(), relu, residual)


def _conv_factory(int8: bool, lo: int, hi: int):
    def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Module:
        if int8:
            return RoutedConv(cin, cout, k, stride, k // 2, bias=False, min_spatial=lo,
                              max_spatial=hi)
        return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)

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
        lecun_normal_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
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
