"""Fused 3x3 conv + bias + ReLU (+ 2x2 max-pool) in float and int8: the
CUDA kernels' wrappers and their plain PyTorch versions.

The kernels (``csrc/conv.cu``) replace the TPU kernels
``pyvisim_tpu/ops/pallas/conv.py:_fused_kernel`` (``conv3x3_relu_maxpool``,
kernel 7) and ``_fused_kernel_q8`` (``conv3x3_relu_maxpool_q8``, kernel 8).
Layouts: ``x (B, H, W, Cin)`` NHWC, contiguous; weights ``(Cout, 3, 3,
Cin)``, which is torch's OIHW conv weight in channels-last order (contiguous
over the 9*Cin reduction); biases and scales float32.

The int8 recipe is the JAX package's ``models/quant.py:QuantConv``: a
per-image activation scale ``sx = max(max|x| / 127, 1e-8)``, per-output-
channel weight scales, values rounded half to even and clipped to +-127,
int32 accumulation, then ``float(acc) * (sx * sw) + b``. The activations are
divided by ``sx``, as ``QuantConv`` does; the Pallas q8 kernel multiplies by
its reciprocal (``conv.py:242-246``), which can move a value by one step.

Bound, per 128 images at 224^2 (VGG16): kernel 7 at conv1 and conv3 is
473.5 GFLOP, 0.48 ms at the card's bf16 rate; kernel 8 is 473.5 or 236.8
GOP, 0.24 or 0.12 ms at its int8 rate. Operations bound all of them; see
the source for the design. Kernel 7 in bf16 and kernel 8's conv are one
kernel on ``wgmma`` with TMA, which reads the weights in the layout of
:func:`pack_bf16_weights` or :func:`pack_q8_weights`, built once per
weight tensor. A kernel-7 call in bf16 is one launch (two where Cin is no
multiple of 16: the channels are first zero-padded to one). A kernel-8
call is three launches: each image's max |x|, the quantise pass (into
``(B, H, W, Cp)`` int8, Cin padded with zeros to a multiple of 32) and the
conv.

ReLU and the 2x2 max carry NaN in the kernels as ``torch.relu`` and
``F.max_pool2d`` do in the plain versions, and kernel 8's amax does as
:func:`activation_scale` does: an image that holds a NaN comes out NaN
where its plain version does.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ._build import load_library
from .aggregate import launch_target

__all__ = [
    "activation_scale",
    "quantize_activation",
    "quantize_weight",
    "quant_conv_reference",
    "conv3x3_relu_maxpool_reference",
    "conv3x3_q8_reference",
    "conv3x3_relu_maxpool",
    "conv3x3_relu_maxpool_q8",
    "conv3x3_q8",
    "pack_q8_weights",
    "pack_bf16_weights",
]

# A kernel block computes 64 output channels; the wrappers take multiples of it.
_COUT_MULTIPLE = 64
# The wgmma kernel's chunk in input channels (two 16-byte blocks: one
# k-step per tap); Cin is zero-padded to a multiple of it.
_K_STEP = 32  # kernel 8, int8
_K_STEP_BF16 = 16  # kernel 7 in bf16


def _scale_shape(t: torch.Tensor) -> tuple:
    return (-1,) + (1,) * (t.dim() - 1)


def _scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax / 127.0, 1e-8)


def activation_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-image scales ``max(max|x[b]| / 127, 1e-8)`` in float32, ``(B,)``."""
    amax = torch.linalg.vector_norm(
        x, ord=math.inf, dim=tuple(range(1, x.dim())), dtype=torch.float32
    )
    return _scale_from_amax(amax)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(x.to(torch.float32) / scale.view(_scale_shape(x)))
    return q.clamp_(-127, 127).to(torch.int8)


def quantize_activation(x: torch.Tensor):
    """``(xq int8, sx (B,) f32)``: each image on its own scale, so that an
    image's grid never depends on its batchmates."""
    sx = activation_scale(x)
    return _quantize(x, sx), sx


def quantize_weight(w: torch.Tensor):
    """``(wq int8, sw (Cout,) f32)`` of a weight whose first dimension is the
    output channel, scaled per output channel from its float32 values."""
    wf = w.to(torch.float32)
    sw = torch.clamp_min(wf.abs().amax(dim=tuple(range(1, w.dim()))) / 127.0, 1e-8)
    return _quantize(wf, sw), sw


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """Flax's SAME padding: the output has ceil(size / stride) positions,
    the odd pixel of padding goes after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _max_pool_2x2(y: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool of NHWC ``y``, flooring odd sides (empty below 2)."""
    b, h, w, c = y.shape
    if h < 2 or w < 2:
        return y.new_empty((b, h // 2, w // 2, c))
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _int_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding) -> torch.Tensor:
    """The exact int32 conv of NHWC int8 ``xq`` with ``wq (Cout, kh, kw,
    Cin)``: a float64 conv of the integer values, rounded. Its products and
    sums stay far below 2**53, so every algorithm gives the exact sums, on
    the CPU and on the card."""
    kh, kw = wq.shape[1], wq.shape[2]
    if padding == "SAME":
        pads = (*_same_pads(xq.shape[2], kw, stride), *_same_pads(xq.shape[1], kh, stride))
    elif padding == "VALID":
        pads = (0, 0, 0, 0)
    else:
        ph, pw = (padding, padding) if isinstance(padding, int) else tuple(padding)
        pads = (pw, pw, ph, ph)
    xd = F.pad(xq.permute(0, 3, 1, 2).to(torch.float64), pads)
    acc = F.conv2d(xd, wq.permute(0, 3, 1, 2).to(torch.float64), stride=stride)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1)


def quant_conv_reference(x, wq, sw, b=None, *, stride: int = 1, padding="SAME",
                         relu: bool = False, pool: bool = False, return_acc: bool = False):
    """The ``QuantConv`` recipe on NHWC ``x`` with ``wq (Cout, kh, kw, Cin)``
    int8 and ``sw (Cout,)``: quantise ``x`` per image, the exact int32 conv,
    then ``float(acc) * (sx * sw) + b``, ReLU if ``relu``, the 2x2 max-pool
    if ``pool``, and one rounding to ``x.dtype``. ``padding`` is "SAME",
    "VALID", an int or an (h, w) pair. With ``return_acc`` the int32
    accumulators come too."""
    xq, sx = quantize_activation(x)
    acc = _int_conv(xq, wq, stride, padding)
    y = acc.to(torch.float32) * (sx.view(-1, 1, 1, 1) * sw.to(torch.float32))
    if b is not None:
        y = y + b.to(torch.float32)
    if relu:
        y = torch.relu(y)
    if pool:
        y = _max_pool_2x2(y)
    y = y.to(x.dtype).contiguous()
    return (y, acc) if return_acc else y


def conv3x3_q8_reference(x, wq, sw, b, *, pool: bool, relu: bool = True,
                         return_acc: bool = False):
    """Plain version of kernel 8: :func:`quant_conv_reference` with a SAME
    3x3 stride-1 conv."""
    return quant_conv_reference(x, wq, sw, b, relu=relu, pool=pool, return_acc=return_acc)


def conv3x3_relu_maxpool_reference(x, w, b):
    """Plain version of kernel 7, the port of the JAX package's
    ``conv3x3_relu_maxpool_reference``: the SAME conv of ``x`` with
    ``w.to(x.dtype)``, both promoted to float32 (cuDNN's TF32 off), plus the
    float32 bias, ReLU, the 2x2 max-pool, one rounding to ``x.dtype``.
    ``(B, H, W, Cin)`` -> ``(B, H // 2, W // 2, Cout)``."""
    xf = x.to(torch.float32).permute(0, 3, 1, 2)
    wf = w.to(x.dtype).to(torch.float32).permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xf, wf, padding=1)
    y = torch.relu(y + b.to(torch.float32).view(-1, 1, 1))
    return _max_pool_2x2(y.permute(0, 2, 3, 1)).to(x.dtype).contiguous()


def _check(x, w, b, weight_dtypes) -> None:
    """Shapes, types, layouts and devices as the kernels read them."""
    for name, t in (("x", x), ("w", w)) + ((("b", b),) if b is not None else ()):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be (B, H, W, Cin) float32 or bfloat16; got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (B, H, W, Cin)")
    if x.shape[3] == 0:
        raise ValueError("x must have at least one channel")
    if w.dim() != 4 or w.shape[1:3] != (3, 3) or w.shape[3] != x.shape[3]:
        raise ValueError(f"w must be (Cout, 3, 3, {x.shape[3]}); got {tuple(w.shape)}")
    if w.dtype not in weight_dtypes:
        raise TypeError(f"w must be one of {weight_dtypes}; got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous (Cout, 3, 3, Cin)")
    cout = w.shape[0]
    if cout % _COUT_MULTIPLE or cout == 0:
        raise ValueError(f"Cout must be a positive multiple of {_COUT_MULTIPLE}; got {cout}")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"b must be ({cout},); got {tuple(b.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the conv kernels run on cpu or cuda, not {x.device}")


def _library() -> ctypes.CDLL:
    lib = load_library("conv")
    if not getattr(lib, "_pyvisim_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.conv_pool_bf16.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.conv_pool_bf16.restype = i32
        lib.conv_pool_f32.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.conv_pool_f32.restype = i32
        lib.conv_q8_amax.argtypes = [ptr, i32, ptr] + [i32] * 5 + [ptr]
        lib.conv_q8_amax.restype = i32
        lib.conv_q8_quantize.argtypes = [ptr, i32, ptr, ptr] + [i32] * 6 + [ptr]
        lib.conv_q8_quantize.restype = i32
        lib.conv_q8.argtypes = [ptr] * 6 + [i32, ptr] + [i32] * 8 + [ptr]
        lib.conv_q8.restype = i32
        lib.conv_error_string.argtypes = [i32]
        lib.conv_error_string.restype = ctypes.c_char_p
        lib._pyvisim_typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel failed: {lib.conv_error_string(err).decode()} ({err})")


def _check_aligned(**tensors) -> None:
    """The kernels copy 16 bytes at a time from where each tensor starts."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (a fresh tensor does)")


def _too_large(x: torch.Tensor, cout: int) -> bool:
    """Past the kernels' grid (images, and the wgmma kernel's 32x8 or 16x16
    tiles per image) or 64-bit offsets."""
    b, h, w, cin = x.shape
    tiles = max(-(-h // 32) * -(-w // 8), -(-h // 16) * -(-w // 16))
    per_image = h * w * _padded_channels(cin)  # the quantise pass's 32-bit offsets
    return (b > 65535 or tiles > 65535 or per_image >= 2**31
            or b * h * w * max(cout, cin + _K_STEP) >= 2**62)


def conv3x3_relu_maxpool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel 7: SAME 3x3 conv + float32 bias + ReLU + 2x2 max-pool.

    ``x (B, H, W, Cin)`` float32 or bfloat16, contiguous NHWC, any H, W and
    Cin (an odd H or W drops its last row or column, as ``MaxPool2d(2, 2)``
    does); ``w (Cout, 3, 3, Cin)``, cast to ``x.dtype`` as the JAX kernel
    does; ``b (Cout,)``. Cout must be a multiple of 64. Returns ``(B, H // 2,
    W // 2, Cout)`` in ``x.dtype``, accumulated in float32. CPU tensors take
    :func:`conv3x3_relu_maxpool_reference`; CUDA tensors launch the kernel
    (bf16 on the tensor cores, float32 on the CUDA cores) or raise. In bf16
    the kernel reads ``w`` packed by :func:`pack_bf16_weights`, kept on
    ``w``, and, for a Cin that is no multiple of 16, ``x`` zero-padded to
    one in a pass of its own (TMA reads 16-byte channel blocks; the main
    path's Cin, 64 and 128, needs none). ``launches`` counts the kernel's
    launches.
    """
    _check(x, w, b, (torch.float32, torch.bfloat16))
    if x.device.type == "cpu":
        return conv3x3_relu_maxpool_reference(x, w, b)
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    if _too_large(x, cout):
        raise ValueError(f"input too large for the kernel: {tuple(x.shape)}, Cout={cout}")
    b = b.to(torch.float32)
    out = torch.empty((bsz, h // 2, wd // 2, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    dev, stream = launch_target(x.device)
    if x.dtype == torch.bfloat16:
        cp = _padded_channels(cin, _K_STEP_BF16)
        x = x if cp == cin else F.pad(x, (0, cp - cin))
        w = _packed_weights(w, pack_bf16_weights)
        fn = lib.conv_pool_bf16
    else:
        cp, w = cin, w.to(x.dtype)
        fn = lib.conv_pool_f32
    _check_aligned(x=x, w=w)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
             bsz, h, wd, cp, cout, dev, stream)
    _raise_on(lib, err, "conv3x3_relu_maxpool")
    conv3x3_relu_maxpool.launches += 1
    return out


def _padded_channels(cin: int, step: int = _K_STEP) -> int:
    """Cin rounded up to the wgmma kernel's chunk of ``step`` channels."""
    return -(-cin // step) * step


def _pack(w: torch.Tensor, step: int) -> torch.Tensor:
    """``w (Cout, 3, 3, Cin)`` as ``(Cout / 64, Cp / block, 9, 64, block)``,
    Cin zero-padded to ``Cp`` (a multiple of ``step``) and ``block`` the
    channels in 16 bytes. For each tile of 64 output channels (a kernel
    block's), block of input channels and tap ``3 * dy + dx``: the 64 rows
    of 16 bytes that one wgmma B operand reads (K-major core matrices). A
    tile's chunk of ``step`` channels is contiguous, so one bulk copy
    stages it."""
    cout, kh, kw, cin = w.shape
    cp, block = _padded_channels(cin, step), 16 // w.element_size()
    w = w.reshape(cout, kh * kw, cin)
    if cp != cin:
        w = F.pad(w, (0, cp - cin))
    w = w.reshape(cout // _COUT_MULTIPLE, _COUT_MULTIPLE, kh * kw, cp // block, block)
    return w.permute(0, 3, 2, 1, 4).contiguous()


def pack_q8_weights(wq: torch.Tensor) -> torch.Tensor:
    """Kernel 8's weight layout: ``wq (Cout, 3, 3, Cin)`` int8 as ``(Cout / 64,
    Cp / 16, 9, 64, 16)``, Cin zero-padded to ``Cp`` (a multiple of 32)."""
    return _pack(wq, _K_STEP)


def pack_bf16_weights(w: torch.Tensor) -> torch.Tensor:
    """Kernel 7's weight layout in bf16: ``w (Cout, 3, 3, Cin)``, rounded to
    bf16, as ``(Cout / 64, Cp / 8, 9, 64, 8)``, Cin zero-padded to ``Cp`` (a
    multiple of 16)."""
    return _pack(w.to(torch.bfloat16), _K_STEP_BF16)


def _packed_weights(w: torch.Tensor, pack) -> torch.Tensor:
    """``pack(w)``, kept on ``w`` until it changes in place: a trunk's convs
    call kernels 7 and 8 with the same weights on every encode."""
    hit = getattr(w, "_pyvisim_packed", None)
    if hit is None or hit[0] != (w._version, pack):
        hit = ((w._version, pack), pack(w))
        w._pyvisim_packed = hit
    return hit[1]


def _scale_launch(lib, x: torch.Tensor, dev: int, stream) -> torch.Tensor:
    """:func:`activation_scale` of a CUDA ``x``: kernel 8's amax pass gives
    the same maximum as the plain version's reduction, and the scale is
    formed from it by the same operations."""
    bsz, h, wd, cin = x.shape
    amax = torch.zeros((bsz,), dtype=torch.int32, device=x.device)
    err = lib.conv_q8_amax(x.data_ptr(), int(x.dtype == torch.bfloat16), amax.data_ptr(),
                           bsz, h, wd, cin, dev, stream)
    _raise_on(lib, err, "conv3x3_q8 amax")
    return _scale_from_amax(amax.view(torch.float32))


def _quantize_launch(lib, x: torch.Tensor, sx: torch.Tensor, dev: int, stream) -> torch.Tensor:
    """Kernel 8's quantise pass: ``x`` on ``sx`` into int8 ``(B, H, W, Cp)``,
    zero past Cin."""
    bsz, h, wd, cin = x.shape
    cp = _padded_channels(cin)
    xq = torch.empty((bsz, h, wd, cp), dtype=torch.int8, device=x.device)
    err = lib.conv_q8_quantize(x.data_ptr(), int(x.dtype == torch.bfloat16), sx.data_ptr(),
                               xq.data_ptr(), bsz, h, wd, cin, cp, dev, stream)
    _raise_on(lib, err, "conv3x3_q8 quantise")
    return xq


def _conv_launch(lib, xq, wp, sw, sx, b, out, acc, *, pool: bool, relu: bool, dev: int,
                 stream) -> None:
    """Kernel 8's conv on the quantised ``xq`` and the packed ``wp``."""
    bsz, h, wd, cp = xq.shape
    err = lib.conv_q8(
        xq.data_ptr(), wp.data_ptr(), sw.data_ptr(), sx.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16),
        None if acc is None else acc.data_ptr(), int(pool), int(relu),
        bsz, h, wd, cp, out.shape[-1], dev, stream,
    )
    _raise_on(lib, err, "conv3x3_q8")


def _launch_q8(x, wq, sw, b, *, pool: bool, relu: bool, return_acc: bool):
    bsz, h, wd, _ = x.shape
    cout = wq.shape[0]
    if _too_large(x, cout):
        raise ValueError(f"input too large for the kernel: {tuple(x.shape)}, Cout={cout}")
    _check_aligned(x=x)
    sw = sw.to(torch.float32).contiguous()
    b = None if b is None else b.to(torch.float32).contiguous()
    shape = (bsz, h // 2, wd // 2, cout) if pool else (bsz, h, wd, cout)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    acc = torch.zeros((bsz, h, wd, cout), dtype=torch.int32, device=x.device) if return_acc else None
    if out.numel() == 0 and (acc is None or acc.numel() == 0):
        return ((out, acc) if return_acc else out), False
    lib = _library()
    dev, stream = launch_target(x.device)
    sx = _scale_launch(lib, x, dev, stream)
    xq = _quantize_launch(lib, x, sx, dev, stream)
    _conv_launch(lib, xq, _packed_weights(wq, pack_q8_weights), sw, sx, b, out, acc,
                 pool=pool, relu=relu, dev=dev, stream=stream)
    return ((out, acc) if return_acc else out), True


def _check_q8(x, wq, sw, b) -> None:
    _check(x, wq, b, (torch.int8,))
    if sw.device != x.device or tuple(sw.shape) != (wq.shape[0],):
        raise ValueError(f"sw must be ({wq.shape[0]},) on {x.device}; got {tuple(sw.shape)} on {sw.device}")


def conv3x3_relu_maxpool_q8(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                            b: torch.Tensor | None, *, return_acc: bool = False):
    """Kernel 8, pooled: quantise ``x`` per image, int8 SAME 3x3 conv with
    int32 sums, ``float(acc) * (sx * sw) + b``, ReLU, 2x2 max-pool.

    ``x (B, H, W, Cin)`` float32 or bfloat16, contiguous NHWC; ``wq (Cout, 3,
    3, Cin)`` int8 and ``sw (Cout,)`` from :func:`quantize_weight`; ``b
    (Cout,)`` or None. Cout must be a multiple of 64. Returns ``(B, H // 2,
    W // 2, Cout)`` in ``x.dtype`` (and with ``return_acc`` the ``(B, H, W,
    Cout)`` int32 accumulators). CPU tensors take
    :func:`conv3x3_q8_reference`; CUDA tensors launch the kernel, which
    equals it bit for bit, or raise. ``launches`` counts the launches.
    """
    _check_q8(x, wq, sw, b)
    if x.device.type == "cpu":
        return conv3x3_q8_reference(x, wq, sw, b, pool=True, return_acc=return_acc)
    out, launched = _launch_q8(x, wq, sw, b, pool=True, relu=True, return_acc=return_acc)
    conv3x3_relu_maxpool_q8.launches += launched
    return out


def conv3x3_q8(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, b: torch.Tensor | None,
               *, relu: bool = True, return_acc: bool = False):
    """Kernel 8 without the pool: as :func:`conv3x3_relu_maxpool_q8`, with
    ReLU only if ``relu``, returning ``(B, H, W, Cout)``."""
    _check_q8(x, wq, sw, b)
    if x.device.type == "cpu":
        return conv3x3_q8_reference(x, wq, sw, b, pool=False, relu=relu, return_acc=return_acc)
    out, launched = _launch_q8(x, wq, sw, b, pool=False, relu=relu, return_acc=return_acc)
    conv3x3_q8.launches += launched
    return out


conv3x3_relu_maxpool.launches = 0
conv3x3_relu_maxpool_q8.launches = 0
conv3x3_q8.launches = 0
