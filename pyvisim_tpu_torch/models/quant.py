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
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.cuda import conv as conv_ops

__all__ = ["QuantConv"]


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class QuantConv(nn.Module):
    """int8 convolution, ``(B, Cin, H, W) -> (B, Cout, H', W')`` in the
    input's dtype (channels-last in and out on CUDA).

    On the CPU any kernel size, stride and padding ("SAME" as Flax pads it,
    "VALID", an int or an (h, w) pair) run through the plain version. On
    CUDA the 3x3, stride-1, SAME (or padding 1) conv runs through kernel 8
    (``ops.cuda.conv.conv3x3_q8``); other shapes raise
    ``NotImplementedError``. ``relu`` applies ReLU in the kernel's epilogue,
    which equals ``relu(QuantConv(...)(x))``.
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

    @property
    def _is_3x3_same(self) -> bool:
        return (self.kernel_size == (3, 3) and self.stride == 1
                and self.padding in ("SAME", 1, (1, 1), [1, 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1)
        if self._is_3x3_same:
            if x.device.type == "cpu":
                xh = xh.contiguous()
            y = conv_ops.conv3x3_q8(xh, self.wq, self.sw, self.bias, relu=self.relu)
        elif x.device.type == "cpu":
            y = conv_ops.quant_conv_reference(
                xh.contiguous(), self.wq, self.sw, self.bias, stride=self.stride,
                padding=self.padding, relu=self.relu,
            )
        else:
            raise NotImplementedError(
                f"QuantConv on {x.device.type} runs only the 3x3, stride-1, SAME conv of its "
                f"kernel; kernel {self.kernel_size}, stride {self.stride}, padding "
                f"{self.padding!r} come with the port of ResNet's int8 trunk, a later slice."
            )
        return y.permute(0, 3, 1, 2)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, "
                f"stride={self.stride}, padding={self.padding!r}, "
                f"bias={self.bias is not None}, relu={self.relu}")
