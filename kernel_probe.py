#!/usr/bin/env python3
"""Where the time of kernel B (SIFT orientation) and kernel 2 (GMM
statistics) goes, on one CUDA card.

Run from a checkout of the repository:

    python3 kernel_probe.py

Kernel B runs on the orientation call of one 16-image SIFT call at the
default SiftConfig(), on the main path's 384x512 images and on 1/f-noise
images that fill the keypoint budget (as ``chip_smoke.py`` phase 2d has
them):

- as built, and on the valid slots alone (the same call compacted);
- as copies of ``csrc/sift_window.cu`` with one choice changed: 2, 8 or
  16 keypoints (warps) a block in place of 4 ("2 warps", ...), or 4
  chunks of 32 pixels a tile in place of 8 ("4 chunks"), each bit for bit
  with the plain version;
- as copies with one part removed: the bin words of lane bits per bin
  ("no bin words"), the owners' walk over them ("no adds"), or the
  exponential ("no exp"). These compute wrong values; only their times
  mean something.

Kernel 2 runs at the deep FV shape (128 x 196 x 257, K = 256) and the
RootSIFT FV encode's shape, as copies of ``csrc/gmm_stats.cu`` with three
quarters of the FMAs of pass 1 ("logp fma / 4") or of pass 2 ("stats fma /
4") removed, without pass 1's softmax ("no softmax") or pass 2's stores
("no stats stores"), without either pass's copies into shared memory ("no
logp staging", "no stats staging"), with a 4-stage ring ("4 stages"), and
with pass 2 held to three blocks an SM ("stats 3 blocks"); by pass.

Each time is device time from the profiler, with the card's name and
power limit; the last line is a JSON object of all numbers.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from pyvisim_tpu_torch.ops.cuda import _build

SIFT_VARIANTS = {
    "as built": [],
    **{f"{w} warps": [("constexpr int kOriWarps = 4;", f"constexpr int kOriWarps = {w};")]
       for w in (2, 8, 16)},
    "4 chunks": [("constexpr int kOriChunks = 8;", "constexpr int kOriChunks = 4;")],
    "no bin words": [("        atomicOr(&lanes_of[u][bin], 1u << lane);\n", "")],
    "no adds": [("      for (unsigned m = lanes_of[u][lane]; m; m &= m - 1)\n"
                 "        acc_lo += wm_of[u * 32 + __ffs(m) - 1];",
                 "      acc_lo += wm_of[u * 32 + lane];"),
                ("        for (unsigned m = lanes_of[u][lane + 32]; m; m &= m - 1)\n"
                 "          acc_hi += wm_of[u * 32 + __ffs(m) - 1];",
                 "        acc_hi += wm_of[u * 32 + lane];")],
    "no exp": [("wm = expf((fi * fi + fj * fj) * exp_scale) * mag;",
                "wm = (fi * fi + fj * fj) * exp_scale * mag;")],
}
# The variants that compute what the kernel as built computes.
SIFT_EXACT = ("as built", "2 warps", "8 warps", "16 warps", "4 chunks")
GMM_VARIANTS = {
    "as built": [],
    "logp fma / 4": [("for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);",
                      "for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);")],
    "stats fma / 4": [("for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);",
                       "for (int c = 0; c < 2; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);")],
    "no softmax": [("for (int r = warp; r < n_rows; r += kThreads1 / 32) {",
                    "for (int r = warp; r < 0; r += kThreads1 / 32) {")],
    "no stats stores": [("(sq ? p2 : p1)[(out0 + k) * D + (sq ? col - D : col)] = acc[r][c];",
                         "if (acc[r][c] == 12345.f) p1[0] = 0.f;")],
    "4 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "no stats staging": [
        ("        cp_async4(xs + tid + j * nthreads, ok ? x_src + static_cast<size_t>(n0 + r) * D "
         ": xb, ok);", "        (void)ok;"),
        ("        cp_async16(qs + r * kComps2 + c4 * 4,\n"
         "                   ok ? qb + static_cast<size_t>(n0 + r) * KQ + k0 + c4 * 4 : qb, ok);",
         "        (void)ok;")],
    "no logp staging": [
        ("        cp_async4(as + a_dd * kApad + r, ok ? x_col + static_cast<size_t>(r) * D : desc, "
         "ok);", "        (void)ok;"),
        ("        cp_async16(bs + dr * kComps1 + c4 * 4, bt + static_cast<size_t>(j0 + dr) * KB + "
         "k0 + c4 * 4,\n                   true);", "        (void)dr;")],
    "stats 3 blocks": [("__global__ void __launch_bounds__(256)\nstats_kernel",
                        "__global__ void __launch_bounds__(256, 3)\nstats_kernel")],
}


def build_variants(name: str, variants: dict) -> dict[str, ctypes.CDLL]:
    """Each variant of ``csrc/<name>.cu`` (a label and its literal text
    replacements), all compiled at once with the source's flags."""
    source = (_build.CSRC / f"{name}.cu").read_text()
    out_dir = _build.BUILD_DIR / "kernel_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, edits in variants.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {label!r}: {old!r} is not in {name}.cu")
            text = text.replace(old, new)
        stem = f"{name}_{label.replace(' ', '_').replace('/', 'by')}"
        src = out_dir / f"{stem}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(name, ()),
               f"-I{_build.CSRC}", "-o", str(lib), str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib)
    libs = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {label!r}:\n{log}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def device_ms(fn, top: int = 8) -> dict:
    """Device ms per call of ``fn``: in all, and by kernel."""
    prof = cs.profile_device_graph(fn, reps=20, top=top)
    by_kernel = {}
    for t in prof["top"]:
        name = re.search(r"::(\w+)", t["kernel"]) or re.match(r"\w+", t["kernel"])
        by_kernel[name.group(name.lastindex or 0)] = t["ms_per_call"]
    return {"total": prof["kernel_ms_per_call"], **by_kernel}


def probe_orientation(sw, results: dict) -> None:
    from pyvisim_tpu_torch.ops import sift as sift_ops

    cfg = sift_ops.SiftConfig()
    loads = {"main path": cs.sift_gray_batch(cs.SIFT_BATCH, seed=0)[1],
             "full budget": cs.full_budget_grays(cs.SIFT_BATCH, seed=0)}
    libs = build_variants("sift_window", SIFT_VARIANTS)
    try:
        for load, grays in loads.items():
            batch = torch.from_numpy(grays).cuda()
            with torch.inference_mode():
                calls = cs.capture_kernel_calls(sw, lambda: sift_ops._sift_core(batch, cfg))
                (args, kw), = calls["orientation"]
                want = sw.orientation_reference(*args, **kw)
                rows = {}
                for label, lib in libs.items():
                    sw.load_library = lambda _name, lib=lib: lib
                    if label in SIFT_EXACT:
                        got = sw.orientation(*args, **kw)
                        torch.cuda.synchronize()
                        cs.check(cs.same_bits(got, want),
                                 f"variant {label!r} differs from the plain version")
                    rows[f"variant {label}"] = device_ms(lambda: sw.orientation(*args, **kw))["total"]
                sw.load_library = _build.load_library
                keep = kw["valid"].nonzero()[:, 0]
                compact = {k: (v[keep].contiguous() if torch.is_tensor(v) and v.dim() == 1
                               and v.numel() == kw["valid"].numel() else v) for k, v in kw.items()}
                rows["valid slots alone"] = device_ms(lambda: sw.orientation(*args, **compact))["total"]
                for key, ms in rows.items():
                    print(f"orientation ({load}) {key}: {ms:.4f} ms device", flush=True)
            results[f"orientation {load}"] = rows
    finally:
        sw.load_library = _build.load_library


def probe_gmm(gs, gmm_call, results: dict) -> None:
    gmm = cs.shipped_gmm()
    params = (gmm.weights.contiguous(), gmm.means.contiguous(), gmm.covariances.contiguous())
    d = gmm.means.shape[1]
    desc = cs.draw_from_gmm(gmm, cs.B * cs.N, seed=1).reshape(cs.B, cs.N, d).contiguous()
    mask = torch.ones((cs.B, cs.N), device="cuda")
    (r_desc, r_mask, *r_params), r_kw = gmm_call
    shapes = {"deep fv": lambda: gs.gmm_stats_batched(desc, mask, *params),
              "rootsift fv": lambda: gs.gmm_stats_batched(r_desc, r_mask, *r_params, **r_kw)}
    libs = build_variants("gmm_stats", GMM_VARIANTS)
    try:
        for label, lib in libs.items():
            gs.load_library = lambda _name, lib=lib: lib
            for shape, fn in shapes.items():
                ms = device_ms(fn)
                results[f"gmm {shape} {label}"] = ms
                print(f"gmm ({shape}) {label}: {json.dumps(ms)}", flush=True)
    finally:
        gs.load_library = _build.load_library


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device is available", file=sys.stderr)
        return 1
    from pyvisim_tpu_torch.ops.cuda import gmm_stats as gs
    from pyvisim_tpu_torch.ops.cuda import sift_window as sw

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    results = {"card": smi}
    _, gmm_call = cs.rootsift_encode_calls()
    probe_orientation(sw, results)
    probe_gmm(gs, gmm_call, results)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
