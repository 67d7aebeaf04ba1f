#!/usr/bin/env python3
"""Where the time of the wgmma conv kernel goes, on one CUDA card.

Builds ``pyvisim_tpu_torch/csrc/conv.cu`` as it is and copies of it with
one part removed or one choice changed, then times each at the int8 VGG16
trunk's shapes (B=128, 224^2 input): kernel 7 in bf16 at conv1 and conv3,
kernel 8's conv kernel alone (on x already quantised, weights already
packed) at conv5 and, pooled, at conv9. Both kernels are instances of one
template, so each edit reaches both. The copies:

- "no mma": the ``wgmma`` instructions;
- "no staging": the TMA and bulk copies (the barriers still complete, on
  zero bytes);
- "no stores": the stores of the output tile to device memory;
- "16x16 tiles", "32x8 tiles": kernel 7 on one tile shape at every size
  (as built it takes 32x8 unless 16x16 pads the image less);
- "4 stages": a ring of 4 stages, which leaves one block per SM.

The first three compute wrong values: only their times mean something.
Kernel 8's other launches, the per-image amax and the quantise pass, and
the packing of its weights (once per weight tensor), are timed apart at
both of its shapes. Last, kernel 7 in bf16 and its plain version against
a float64 conv on signed inputs (the card test's at 2 x 112^2 x 128):
how far each lies from the exact result beyond the final bf16 rounding,
and the outputs more than one bf16 step (+ 1e-6) apart. Run from a
checkout:

    python3 conv_probe.py
"""
from __future__ import annotations

import subprocess
import sys

import torch
import torch.nn.functional as F

import chip_smoke
from kernel_probe import build_variants
from pyvisim_tpu_torch.ops.cuda import _build, conv

VARIANTS = {
    "as built": [],
    "no mma": [("        K::mma(acc[sub], da, db);",
                "        acc[sub][0] += static_cast<typename K::Acc>(da ^ db);")],
    "no staging": [("  mbar_expect_tx(&full[s], K::kTxBytes);\n"
                    "  for (int j = 0; j < kWgBlocks; ++j)\n"
                    "    tma_load_4d(st + j * K::kPlaneStride, tm_x, K::kBlockElems * "
                    "(kWgBlocks * c + j), ox0 - 1,\n"
                    "                oy0 - 1, b, &full[s]);\n"
                    "  bulk_load(st + K::kABytes, w_tile + static_cast<size_t>(c) * kWgBBytes, "
                    "kWgBBytes, &full[s]);\n",
                    "  mbar_expect_tx(&full[s], 0);\n")],
    "no stores": [("    *reinterpret_cast<uint4*>(out + at) = "
                   "*reinterpret_cast<const uint4*>(ep + pix * kEp + piece * kVec);", "")],
    "16x16 tiles": [("  if (padded(32, 8) <= padded(16, 16))", "  if (false)")],
    "32x8 tiles": [("  if (padded(32, 8) <= padded(16, 16))", "  if (true)")],
    "4 stages": [("constexpr int kWgStages = 3;", "constexpr int kWgStages = 4;")],
}
SHAPES = [("conv1", 224, 64, 64, "k7"), ("conv3", 112, 128, 128, "k7"),
          ("conv5", 56, 256, 256, "k8"), ("conv9", 28, 512, 512, "k8p")]


def bf16_accuracy() -> None:
    """Kernel 7 in bf16 and its plain version against float64, on the
    inputs of tests/test_torch_cuda.py's signed 2 x 112^2 x 128 case."""
    g = torch.Generator().manual_seed(4)
    b, h, w, ci, co = 2, 112, 112, 128, 128
    x = torch.randn(b, h, w, ci, generator=g).to("cuda", torch.bfloat16)
    wt = (torch.randn(co, 3, 3, ci, generator=g) / (9 * ci) ** 0.5).to("cuda", torch.bfloat16)
    bias = (0.1 * torch.randn(co, generator=g)).cuda()
    got = conv.conv3x3_relu_maxpool(x, wt, bias).double()
    want = conv.conv3x3_relu_maxpool_reference(x, wt, bias).double()
    y = F.conv2d(x.double().permute(0, 3, 1, 2), wt.double().permute(0, 3, 1, 2), padding=1)
    exact = F.max_pool2d(torch.relu(y + bias.double().view(-1, 1, 1)), 2, 2).permute(0, 2, 3, 1)
    half_step = chip_smoke.bf16_ulp(exact).double() / 2
    for name, t in (("kernel", got), ("plain", want)):
        beyond = float(((t - exact).abs() - half_step).clamp_min(0).max())
        print(f"bf16 accuracy, {name}: up to {beyond:.3e} from float64 beyond half a bf16 step")
    far = (got - want).abs() > chip_smoke.bf16_ulp(want).double() + 1e-6
    print(f"bf16 accuracy: {int(far.sum())} of {far.numel()} outputs more than one bf16 step "
          f"+ 1e-6 from the plain version; exact share {float((got == want).double().mean()):.6f}")
    for i in torch.nonzero(far)[:5].tolist():
        at = tuple(i)
        print(f"  at {at}: kernel {float(got[at]):.6e}, plain {float(want[at]):.6e}, "
              f"float64 {float(exact[at]):.6e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_probe: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build_variants("conv", VARIANTS)
    b = chip_smoke.B
    for layer, hw, cin, cout, route in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(b, hw, hw, cin, device="cuda", generator=g).relu_().to(torch.bfloat16)
        w = torch.randn(cout, 3, 3, cin, device="cuda", generator=g) / (9 * cin) ** 0.5
        bias = torch.zeros(cout, device="cuda")
        wq, sw = conv.quantize_weight(w)
        wq, wx = wq.contiguous(), w.to(torch.bfloat16)
        for name, lib in libs.items():
            conv.load_library = lambda _name, lib=lib: lib
            if route == "k7":
                call = lambda: conv.conv3x3_relu_maxpool(x, wx, bias)  # noqa: E731
            else:
                call = chip_smoke.q8_parts(conv, x, wq, sw, bias, route == "k8p")["conv"]
            ms = chip_smoke.cuda_ms(call, reps=5, rounds=5)
            print(f"{layer} {route} {name}: {ms:.4f} ms")
        if route != "k7":
            parts = chip_smoke.q8_parts(conv, x, wq, sw, bias, route == "k8p")
            parts["pack_weights (once per weight tensor)"] = lambda: conv.pack_q8_weights(wq)
            for part in ("amax", "quantise", "pack_weights (once per weight tensor)"):
                ms = chip_smoke.cuda_ms(parts[part], reps=5, rounds=5)
                print(f"{layer} {route} {part}: {ms:.4f} ms")
    conv.load_library = _build.load_library
    bf16_accuracy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
