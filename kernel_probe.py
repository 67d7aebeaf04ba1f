#!/usr/bin/env python3
"""Where the time of kernel B (SIFT orientation), kernel 2 (GMM
statistics) and kernels 1 and 3 (VLAD and Lloyd) goes, on one CUDA card.

Run from a checkout of the repository:

    python3 kernel_probe.py [--parent DIR] [--only aggregate|sift|gmm]

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

Kernels 1 (VLAD) and 3 (Lloyd) run at phase 2a's deep VLAD shape (128 x
196 x 514, K = 256), the RootSIFT VLAD encode's shape (64 x 2048 x 128,
23,090 valid rows) and phase 2c's Lloyd shape (25,088 x 514), as copies
of ``csrc/aggregate.cu``:

- as built;
- with one choice changed, each bit for bit with it: a 4-stage ring ("4
  stages"); 64- or 128-row assignment tiles ("64-row tiles", "128-row
  tiles"); one assignment block an SM ("1 block an SM", also with 128-row
  tiles); 64-row tiles at three blocks an SM; no weightless tile skipped
  ("no skip"); 32-deep slices in place of 16 ("32-deep slices"); 8
  clusters a VLAD gather warp in place of 4 ("gather 8 clusters a
  warp"); 32 clusters a gather block where a set fits one chunk ("gather
  one step a block"); 1,024 labels a gather step in place of 2,048
  ("gather 1024-row chunks"); half as many rows' loads issued together
  ("gather half batches");
- with one part removed, whose values are wrong: the arg-min's compare
  and select ("no arg-min"), Lloyd's ||x||^2 ("no x2"), the read of a
  skipped tile ("no finiteness read"), the count of a computed row's
  non-finite values ("no nf count"), the gather's row loads ("gather no
  row loads"), its per-warp lists ("gather no lists") or its stores
  ("gather no stores").

With ``--parent DIR``, a tree of the parent commit's sources (``git
archive <parent> pyvisim_tpu_torch/csrc`` unpacked into DIR), its
``aggregate.cu`` runs too, through its own C interface: parent, as built,
the variants, as built, parent.

Each time is device time from the profiler, beside back-to-back CUDA-event
time for kernels 1 and 3, with the card's name and power limit; the last
line is a JSON object of all numbers. ``--only aggregate`` (or ``sift``,
``gmm``) runs one part.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
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
AGG_VARIANTS = {
    "as built": [],
    "4 stages": [("constexpr int kStages = 3;       // cp.async ring",
                  "constexpr int kStages = 4;       // cp.async ring")],
    "64-row tiles": [("constexpr int kRows = 96;", "constexpr int kRows = 64;")],
    "128-row tiles": [("constexpr int kRows = 96;", "constexpr int kRows = 128;")],
    "1 block an SM": [("__global__ void __launch_bounds__(kThreads, 2)\nassign_kernel",
                       "__global__ void __launch_bounds__(kThreads, 1)\nassign_kernel")],
    "128-row tiles, 1 block an SM": [
        ("constexpr int kRows = 96;", "constexpr int kRows = 128;"),
        ("__global__ void __launch_bounds__(kThreads, 2)\nassign_kernel",
         "__global__ void __launch_bounds__(kThreads, 1)\nassign_kernel")],
    "64-row tiles, 3 blocks an SM": [
        ("constexpr int kRows = 96;", "constexpr int kRows = 64;"),
        ("__global__ void __launch_bounds__(kThreads, 2)\nassign_kernel",
         "__global__ void __launch_bounds__(kThreads, 3)\nassign_kernel")],
    "no skip": [("  if (__syncthreads_and(tid >= n_rows || mask[row0 + tid] == 0.f)) {",
                 "  if (__syncthreads_and(false)) {")],
    "32-deep slices": [("constexpr int kDepth = 16;       // feature dimensions staged per step",
                        "constexpr int kDepth = 32;       // feature dimensions staged per step")],
    "gather 8 clusters a warp": [("constexpr int kVladClusters = 4;",
                                  "constexpr int kVladClusters = 8;")],
    "gather one step a block": [("  if (N <= kChunk)\n    S =", "  if (false)\n    S =")],
    "gather 1024-row chunks": [("constexpr int kChunk = 2048;", "constexpr int kChunk = 1024;")],
    "gather half batches": [("static constexpr int BATCH = LLOYD ? 8 : 4;",
                             "static constexpr int BATCH = LLOYD ? 4 : 2;")],
    "no arg-min": [("          if (k < K && dist < best[i]) {\n"
                    "            best[i] = dist;\n"
                    "            bk[i] = k;\n"
                    "          }", "          best[i] += dist;")],
    "no x2": [("    if (LLOYD && kt == 0 && tid < 2 * kRows) {", "    if (false) {")],
    "no finiteness read": [("    const long long len = static_cast<long long>(n_rows) * D;",
                            "    const long long len = 0;")],
    "no nf count": [("      if (kt == 0 && count_nf && tx == 0) {", "      if (false) {")],
    "gather no row loads": [
        ("for (int c = 0; c < LC; ++c) xv[q][c] = ok && col0 + 32 * c < D ? __ldg(x + 32 * c) : 0.f;",
         "for (int c = 0; c < LC; ++c) xv[q][c] = 0.f * static_cast<float>(row);")],
    "gather no lists": [("      const bool hit = slot >= 0 && slot < G;", "      const bool hit = false;")],
    "gather no stores": [("      ob[d] = v;", "      if (v == 12345.f) ob[d] = v;")],
}
# The variants that compute what the kernel as built computes.
AGG_EXACT = ("as built", "4 stages", "64-row tiles", "128-row tiles", "1 block an SM",
             "128-row tiles, 1 block an SM", "64-row tiles, 3 blocks an SM", "no skip", "32-deep slices",
             "gather 8 clusters a warp", "gather one step a block",
             "gather 1024-row chunks", "gather half batches")


def build_variants(name: str, variants: dict, source: str | None = None,
                   include: pathlib.Path = _build.CSRC) -> dict[str, ctypes.CDLL]:
    """Each variant of ``csrc/<name>.cu`` (or of ``source``, whose headers
    are in ``include``): a label and its literal text replacements, all
    compiled at once with the source's flags."""
    source = (_build.CSRC / f"{name}.cu").read_text() if source is None else source
    out_dir = _build.BUILD_DIR / "kernel_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, edits in variants.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {label!r}: {old!r} is not in {name}.cu")
            text = text.replace(old, new)
        stem = f"{name}_{re.sub(r'[^0-9A-Za-z]+', '_', label.replace('/', 'by'))}"
        src = out_dir / f"{stem}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(name, ()),
               f"-I{include}", "-o", str(lib), str(src)]
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
    return {"total": prof["kernel_ms_per_call"], **cs.by_pass(prof)}


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


class ParentAggregate:
    """The parent commit's ``aggregate.cu`` behind its own C interface: the
    kernels' wrappers as they were, for the same calls."""

    def __init__(self, lib: ctypes.CDLL):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vlad_aggregate_f32.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.lloyd_stats_f32.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
        self.lib = lib

    def vlad(self, desc, mask, centers):
        from pyvisim_tpu_torch.ops.cuda.aggregate import launch_target

        b, n, d = desc.shape
        k = centers.shape[0]
        out = torch.empty((b, k, d), device=desc.device)
        labels = torch.empty((b, n), dtype=torch.int32, device=desc.device)
        c2 = torch.empty((k,), device=desc.device)
        dev, stream = launch_target(desc.device)
        rc = self.lib.vlad_aggregate_f32(desc.data_ptr(), mask.data_ptr(), centers.data_ptr(),
                                         c2.data_ptr(), labels.data_ptr(), out.data_ptr(), b, n,
                                         d, k, dev, stream)
        cs.check(rc == 0, f"parent VLAD kernel failed ({rc})")
        return out

    def lloyd(self, desc, mask, centers):
        from pyvisim_tpu_torch.ops.cuda.aggregate import launch_target

        n, d = desc.shape
        k = centers.shape[0]
        seg = max(1024, -(-n // 256))
        n_seg = -(-n // seg)
        new = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=desc.device)
        sums, counts, inertia = new(k, d), new(k), new(1)
        parts = (new(n_seg, k, d), new(n_seg, k)) if n_seg > 1 else (sums, counts)
        c2, labels, err = new(k), new(n, dtype=torch.int32), new(n)  # held until the call returns
        dev, stream = launch_target(desc.device)
        rc = self.lib.lloyd_stats_f32(desc.data_ptr(), mask.data_ptr(), centers.data_ptr(),
                                      c2.data_ptr(), labels.data_ptr(), err.data_ptr(),
                                      parts[0].data_ptr(), parts[1].data_ptr(), sums.data_ptr(),
                                      counts.data_ptr(), inertia.data_ptr(), n, d, k, seg, dev,
                                      stream)
        cs.check(rc == 0, f"parent Lloyd kernel failed ({rc})")
        return sums, counts, inertia[0]


def probe_aggregate(agg, ls, rootsift_call, parent: pathlib.Path | None, results: dict) -> None:
    (r_desc, r_mask, r_centers), _ = rootsift_call
    inputs = {"deep vlad": cs.margin_vlad_inputs(), "rootsift vlad": (r_desc, r_mask, r_centers),
              "lloyd": cs.margin_lloyd_inputs()}
    kernel = {"deep vlad": agg.vlad_aggregate_batched, "rootsift vlad": agg.vlad_aggregate_batched,
              "lloyd": ls.lloyd_stats}
    libs = build_variants("aggregate", AGG_VARIANTS)
    order = ["as built", *libs, "as built"]
    if parent is not None:
        csrc = parent / "pyvisim_tpu_torch" / "csrc"
        old = build_variants("aggregate_parent", {"parent": []},
                             source=(csrc / "aggregate.cu").read_text(), include=csrc)["parent"]
        old = ParentAggregate(old)
        order = ["parent", *order, "parent"]
    want = {}
    try:
        for i, label in enumerate(order):
            tag = f"{label} (again)" if label in order[:i] else label
            for shape, args in inputs.items():
                if label == "parent":
                    fn = (lambda a=args: old.lloyd(*a)) if shape == "lloyd" else (
                        lambda a=args: old.vlad(*a))
                else:
                    agg.load_library = lambda _name, lib=libs[label]: lib
                    fn = lambda f=kernel[shape], a=args: f(*a, return_labels=True)
                    if label in AGG_EXACT:
                        got = fn()
                        torch.cuda.synchronize()
                        want.setdefault(shape, got)
                        cs.check(cs.same_bits(got, want[shape]),
                                 f"variant {label!r} differs from the kernel as built ({shape})")
                ms = device_ms(fn)
                ms["back to back"] = cs.cuda_ms(fn)
                results[f"{shape} {tag}"] = ms
                print(f"{shape} {tag}: {json.dumps(ms)}", flush=True)
        if parent is not None:
            # The new sums against the parent's on the same finite inputs.
            same = {}
            for shape, args in inputs.items():
                old_out = old.lloyd(*args) if shape == "lloyd" else (old.vlad(*args),)
                same[shape] = cs.same_bits(want[shape][:len(old_out)], old_out)
            results["bit for bit with parent"] = same
            print(f"bit for bit with parent: {same}", flush=True)
    finally:
        agg.load_library = _build.load_library


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device is available", file=sys.stderr)
        return 1
    from pyvisim_tpu_torch.ops.cuda import gmm_stats as gs
    from pyvisim_tpu_torch.ops.cuda import sift_window as sw

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=pathlib.Path, default=None,
                        help="a tree of the parent commit's csrc, for kernels 1 and 3")
    parser.add_argument("--only", choices=("aggregate", "sift", "gmm"), default=None)
    args = parser.parse_args()
    from pyvisim_tpu_torch.ops.cuda import aggregate as agg
    from pyvisim_tpu_torch.ops.cuda import lloyd_stats as ls

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    results = {"card": smi}
    vlad_call, gmm_call = cs.rootsift_encode_calls()
    if args.only in (None, "aggregate"):
        probe_aggregate(agg, ls, vlad_call, args.parent, results)
    if args.only in (None, "sift"):
        probe_orientation(sw, results)
    if args.only in (None, "gmm"):
        probe_gmm(gs, gmm_call, results)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
