#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pyvisim_tpu_torch) on one CUDA card.

Run from a checkout of the repository:

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. Environment: torch, CUDA, the card's name and power limit; builds every
   CUDA kernel from ``pyvisim_tpu_torch/csrc`` with nvcc.
2. Kernel: the VLAD aggregation kernel against its plain PyTorch version
   at the main path's shape (128 sets of 196 x 514 descriptors, K=256),
   on margin data: labels must agree exactly, outputs to
   1e-4 * max|ref| + 1e-5. Times both with CUDA events.
3. Slice: the main path at full width through the public entry points,
   ``VLADEncoder(DeepConvFeature("vgg16", 224, bf16))`` with K=256 on 128
   images, then retrieval of 8 of them from a gallery of all 128. The
   kernel's launch count is reset just before and read just after.
4. f32 cross-check: 2 images encoded in float32 (cuDNN TF32 off) on the
   card and on the CPU must agree to cosine > 0.9999.

The last two lines of standard output are one JSON object of kernel
numbers and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, the script exits nonzero before printing results.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
F32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

B, N, D, K = 128, 196, 514, 256


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, reps: int = 10, rounds: int = 7, warmup: int = 3) -> float:
    """Median over ``rounds`` of the mean CUDA-event time of ``reps`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def structured_images(rng, n: int, size: int = 224) -> np.ndarray:
    """uint8 images of random 8x8 colour blocks plus noise; unlike pure
    noise, they give distinct deep features, so retrieval is meaningful."""
    grid = rng.integers(0, 256, size=(n, 8, 8, 3))
    up = np.repeat(np.repeat(grid, size // 8, axis=1), size // 8, axis=2)
    return np.clip(up + rng.normal(0, 12, size=up.shape), 0, 255).astype(np.uint8)


def profile_device_graph(fn, reps: int = 3, top: int = 8) -> dict:
    """Device time by kernel over ``reps`` calls of ``fn``, and the share of
    the window in which the card ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)

    def self_device_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    events = prof.key_averages()
    kernels = sorted(
        ((e.key, self_device_us(e)) for e in events if str(e.device_type).endswith("CUDA")),
        key=lambda kv: -kv[1],
    )
    # The operator that launched each kernel, so that unnamed elementwise
    # kernels can be told apart.
    ops = sorted(
        ((e.key, self_device_us(e)) for e in events
         if str(e.device_type).endswith("CPU") and e.key.startswith("aten::")),
        key=lambda kv: -kv[1],
    )
    busy_ms = sum(us for _, us in kernels) / 1e3
    return {
        "window_ms_per_call": window_ms / reps,
        "kernel_ms_per_call": busy_ms / reps,
        "idle_share": max(0.0, 1.0 - busy_ms / window_ms),
        "top": [{"kernel": k[:90], "ms_per_call": us / 1e3 / reps} for k, us in kernels[:top]],
        "top_ops": [{"op": k, "ms_per_call": us / 1e3 / reps} for k, us in ops[:top] if us > 0],
    }


def phase_environment(build):
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(
        "matmul allow_tf32=False for every phase; cuDNN allow_tf32 global="
        f"{torch.backends.cudnn.allow_tf32}, turned off by DeepConvFeature for "
        "float32 trunks (phase 4), unused by the bf16 trunk (phase 3)"
    )
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    report = build.build(names)
    log(f"built {names} in {time.perf_counter() - t0:.2f} s")
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


def phase_kernel(agg):
    """The kernel against its plain version on margin data."""
    g = torch.Generator(device="cpu").manual_seed(0)
    protos = torch.randn(K, D, generator=g)
    true = torch.randint(0, K, (B * N,), generator=g)
    true[:K] = torch.arange(K)  # every cluster populated
    desc = (protos[true] + 0.1 * torch.randn(B * N, D, generator=g)).reshape(B, N, D)
    centers = protos + 0.01 * torch.randn(K, D, generator=g)
    mask = (torch.rand(B, N, generator=g) > 0.1).float()
    mask[0] = 0.0  # one fully masked set
    mask[1, 3] = 0.37  # one fractional weight
    desc, mask, centers = desc.cuda(), mask.cuda(), centers.cuda()

    out, labels = agg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    ref, ref_labels = agg.vlad_aggregate_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    mismatches = int((labels != ref_labels).sum())
    max_diff = float((out - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max()) + 1e-5
    log(f"kernel: label mismatches {mismatches}, max|diff| {max_diff:.3e} (tol {tol:.3e})")
    check(mismatches == 0, f"{mismatches} labels differ from the plain argmin")
    check(max_diff <= tol, f"kernel output off by {max_diff} > {tol}")
    check(float(out[0].abs().max()) == 0.0, "fully masked set did not aggregate to zero")

    kernel_ms = cuda_ms(lambda: agg.vlad_aggregate_batched(desc, mask, centers))
    plain_ms = cuda_ms(lambda: agg.vlad_aggregate_reference(desc, mask, centers))
    log(json.dumps({"kernel_profile": profile_device_graph(
        lambda: agg.vlad_aggregate_batched(desc, mask, centers), reps=10, top=4
    )}))
    n_valid = int((mask != 0).sum())
    n_bytes = 4 * (B * N * D + B * N + K * D + B * K * D)
    n_ops = 2 * n_valid * K * D + 2 * n_valid * D + 2 * B * K * D
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_CUDA_CORE_FLOPS * 1e3
    log(
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
        f"{max(bytes_ms, ops_ms):.4f} ms ({n_ops / 1e9:.3f} GFLOP f32 -> {ops_ms:.4f} ms, "
        f"{n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms)"
    )
    return {
        "name": "vlad_aggregate",
        "route": "cuda",
        "source": "pyvisim_tpu_torch/csrc/aggregate.cu",
        "replaces": "pyvisim_tpu/ops/pallas/aggregate.py:115",
        "replaces_function": "_vlad_kernel (vlad_aggregate_pallas)",
        "launches": None,
        "max_abs_err": max_diff,
        "max_abs_diff": max_diff,
        "label_mismatches": mismatches,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def phase_slice(agg):
    """The main path at full width through the public entry points."""
    from pyvisim_tpu_torch import eval as pv_eval
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.ops import KMeansCodebook, nearest_centroid, vlad_encode_batch

    rng = np.random.default_rng(0)
    ext = DeepConvFeature("vgg16", image_size=224, dtype=torch.bfloat16)
    warm, _ = ext.extract_batch(structured_images(rng, 16))
    flat = warm.to(torch.float32).reshape(-1, D)
    pick = torch.from_numpy(rng.choice(flat.shape[0], K, replace=False)).cuda()
    noise = torch.from_numpy(rng.normal(size=(K, D)).astype(np.float32)).cuda()
    centers = (flat[pick] + 0.01 * flat.std() * noise).cpu().numpy()
    enc = VLADEncoder(ext, kmeans_model=KMeansCodebook(centers))
    images = structured_images(rng, B)
    listed = list(images)
    enc.encode(listed[:8])  # warm the bf16 conv algorithms

    agg.vlad_aggregate_batched.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = enc.encode(listed)
    encode_s = time.perf_counter() - t0
    encode_launches = agg.vlad_aggregate_batched.launches
    paths = [f"img_{i:03d}.png" for i in range(B)]
    gallery = dict(zip(paths, out))
    queries = list(range(0, B, B // 8))
    top1 = [pv_eval.retrieve_top_k_similar(images[i], gallery, enc, k=3)[0][0] for i in queries]
    accuracy = pv_eval.top_k_accuracy(
        [images[i] for i in queries], queries, gallery,
        {p: i for i, p in enumerate(paths)}, enc, k=1,
    )
    launches = agg.vlad_aggregate_batched.launches
    log(
        f"slice: encode of {B} images {encode_s * 1e3:.1f} ms, {encode_launches} kernel "
        f"launch(es); {launches} in the whole run with retrieval"
    )

    check(out.shape == (B, K * D), f"encoding shape {out.shape}")
    check(bool(np.isfinite(out).all()), "non-finite encodings")
    check(launches > 0, "the main path never launched the VLAD kernel")
    check(encode_launches == 1, f"one encode of {B} images took {encode_launches} launches")
    check(top1 == [paths[i] for i in queries], f"self-retrieval failed: {top1}")
    check(accuracy == 1.0, f"top-1 accuracy {accuracy}")
    desc, _ = ext.extract_batch(images)
    labels = nearest_centroid(desc.to(torch.float32), torch.from_numpy(centers).cuda())
    non_empty = np.array([len(set(row)) for row in labels.cpu().numpy().tolist()])
    norms = np.linalg.norm(out.astype(np.float64), axis=1)
    worst = float(np.abs(norms - np.sqrt(non_empty)).max())
    log(f"slice: norm vs sqrt(non-empty clusters) worst |diff| {worst:.2e}")
    check(worst <= 1e-3, "encoding norms do not match the non-empty cluster counts")

    # Host uint8 in, numpy out.
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        enc.encode(listed)
    e2e_img_s = B * reps / (time.perf_counter() - t0)

    # The device graph alone, on a device-resident batch.
    dev_images = torch.from_numpy(images).cuda()
    centers_dev = torch.from_numpy(centers).cuda()
    dev_desc = ext._forward(dev_images).to(torch.float32)
    ones = torch.ones((B, N), device="cuda")
    trunk_ms = cuda_ms(lambda: ext._forward(dev_images), reps=3, rounds=5)
    vlad_ms = cuda_ms(lambda: vlad_encode_batch(dev_desc, ones, centers_dev), reps=5, rounds=5)
    graph_ms = cuda_ms(
        lambda: vlad_encode_batch(ext._forward(dev_images).to(torch.float32), ones, centers_dev),
        reps=3, rounds=5,
    )
    slice_numbers = {
        "encode_e2e_img_per_s": e2e_img_s,
        "device_graph_img_per_s": B / graph_ms * 1e3,
        "device_graph_ms": graph_ms,
        "trunk_ms": trunk_ms,
        "vlad_encode_ms": vlad_ms,
        "batch": B,
        "dtype": "bfloat16",
    }
    log(json.dumps({"slice": slice_numbers}))
    log(json.dumps({"profile": profile_device_graph(
        lambda: vlad_encode_batch(ext._forward(dev_images).to(torch.float32), ones, centers_dev)
    )}))
    return launches, encode_launches, centers


def phase_f32_crosscheck(centers):
    """float32 on the card (TF32 off) against the port on the CPU, both
    with the default seed-0 weights."""
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.ops import KMeansCodebook

    images = structured_images(np.random.default_rng(1), 2)
    vecs = {}
    for device in ("cuda", "cpu"):
        ext = DeepConvFeature("vgg16", image_size=224, device=device)
        vecs[device] = VLADEncoder(ext, kmeans_model=KMeansCodebook(centers)).encode(images)
    a, b = vecs["cuda"].astype(np.float64), vecs["cpu"].astype(np.float64)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    log(f"f32 card vs cpu: cosine {cos.tolist()}, max|diff| {float(np.abs(a - b).max()):.3e}")
    check(bool((cos > 0.9999).all()), f"float32 card and CPU encodings disagree: {cos}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from pyvisim_tpu_torch.ops.cuda import _build
    from pyvisim_tpu_torch.ops.cuda import aggregate as agg

    t0 = time.perf_counter()
    phase_environment(_build)
    kernel = phase_kernel(agg)
    launches, encode_launches, centers = phase_slice(agg)
    kernel["launches"] = launches
    kernel["launches_per_encode_of_128"] = encode_launches
    phase_f32_crosscheck(centers)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
