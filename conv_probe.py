#!/usr/bin/env python3
"""Where the time of the fused conv kernels goes, on one CUDA card.

Builds ``pyvisim_tpu_torch/csrc/conv.cu`` as it is and three copies of it
with one part removed each, then times each at the int8 VGG16 trunk's
shapes (B=128, 224^2 input): kernel 7 at conv1, kernel 8's conv kernel
alone (on x already quantised, weights already packed) at conv5 and,
pooled, at conv9. The parts removed:

- "no mma": kernel 7's ``mma.sync`` instructions and kernel 8's ``wgmma``
  instructions;
- "no staging": kernel 7's ``cp.async`` copies, and kernel 8's TMA and bulk
  copies (its barriers still complete, on zero bytes);
- "no stores": the stores of the output tile to device memory, in both.

The copies compute wrong values: only their times mean something. Kernel
8's other launches, the per-image amax and the quantise pass, and the
packing of its weights (once per weight tensor), are timed apart at both
shapes. Run from a checkout:

    python3 conv_probe.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

import chip_smoke
from pyvisim_tpu_torch.ops.cuda import _build, conv

VARIANTS = {
    "as built": [],
    "no mma": [("        wgmma_s8_64x64(acc[sub], da, db);",
                "        acc[sub][0] += static_cast<int>(da ^ db);"),
               ("mma_bf16(acc[i][j], a, bf[j]);",
                "acc[i][j][0] += __uint_as_float(a[0] ^ bf[j][0]);")],
    "no staging": [("  mbar_expect_tx(&full[s], kQ8TxBytes);\n"
                    "  for (int j = 0; j < kQ8Blocks; ++j)\n"
                    "    tma_load_4d(st + j * kQ8PlaneStride, tm_x, kQ8Chunk * c + 16 * j, "
                    "ox0 - 1, oy0 - 1, b,\n"
                    "                &full[s]);\n"
                    "  bulk_load(st + kQ8ABytes, w_tile + static_cast<size_t>(c) * kQ8BBytes, "
                    "kQ8BBytes, &full[s]);\n",
                    "  mbar_expect_tx(&full[s], 0);\n"),
                   ("      cp_async16(dst, src, inside);", ""),
                   ("      cp_async16(dst, src, ci < Cin);", "")],
    "no stores": [("    *reinterpret_cast<uint4*>(out + at) = "
                   "*reinterpret_cast<const uint4*>(ep + pix * kEp + piece * kVec);", ""),
                  ("  store_pooled(ep, out, b, oy0, ox0, n0, H, W, Cout);", "")],
}
SHAPES = [("conv1", 224, 64, 64, "k7"), ("conv5", 56, 256, 256, "k8"), ("conv9", 28, 512, 512, "k8p")]


def build_variants() -> dict[str, ctypes.CDLL]:
    """Each variant's library, all compiled at once into the build directory."""
    source = (_build.CSRC / "conv.cu").read_text()
    out_dir = _build.BUILD_DIR / "conv_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in conv.cu")
            text = text.replace(old, new)
        stem = name.replace(" ", "_")
        src = out_dir / f"{stem}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_probe: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build_variants()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
