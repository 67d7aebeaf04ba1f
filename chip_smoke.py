#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pyvisim_tpu_torch) on one CUDA card.

Run from a checkout of the repository:

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. Environment: torch, CUDA, the card's name and power limit; builds every
   CUDA kernel from ``pyvisim_tpu_torch/csrc`` with nvcc, all at once.
2. Kernels, each against its plain PyTorch version on the card, timed
   with CUDA events beside its bound, with a device profile:
   a. VLAD aggregation at the main path's shape (128 sets of 196 x 514
      descriptors, K=256, set 0 fully masked), on margin data: weighted
      rows' labels equal to the plain argmin's, weightless rows' equal or
      -1 (the kernel's label of a row of zero weight), set 0's all -1,
      outputs to 1e-4 * max|ref| + 1e-5; then held to the same gates,
      two calls bit-equal, and timed on the arguments a RootSIFT VLAD
      encode of slice 3's 64 images gives it (64 sets of 2,048 x 128,
      about 361 valid rows a set); device time by pass at both shapes.
      At both, the NaN probe of kernels 1 and 3: a NaN in a weighted row,
      a NaN or an inf in a weightless row must give NaN and inf exactly
      where the plain versions do (column 7 of the set in every cluster)
      and Lloyd's inertia NaN where the plain version's is;
   b. GMM statistics with the shipped GMM-k256 on 257-D descriptors drawn
      from it, in the Fisher-vector form (128 sets of 196, one fully
      masked, one fractional weight) and the EM form (one set of 25,088
      rows, with the log-likelihood to rel 1e-5), and on the arguments a
      RootSIFT FV encode of slice 3's 64 images gives it (64 sets of 2,048
      x 64 after PCA-64, mostly masked rows; with a fully masked set, and
      a NaN in one masked row, which must make its set's statistics NaN
      where the plain version has it and leave the other sets as they
      were): s0/s1/s2 to 1e-4 * max|ref| + 1e-5, each form's two calls
      bit-equal, device time by pass;
   c. Lloyd statistics on one set of 25,088 x 514 margin rows, K=256:
      labels as in a, counts equal, sums as above, inertia to rel 1e-5;
      device time by pass.
   d. The SIFT kernels (refinement, orientation, descriptor) on the
      arguments one 16-image device call of the SIFT core at the default
      SiftConfig() gives them (process size 512, 2048 keypoints), at two
      loads: the main path's 384x512 structured images (a sixth of the
      keypoint budget valid) and 1/f-noise images that fill the budget:
      refinement (one launch over the 7 octaves) ok flags and positions
      equal and offsets to 1e-5, angles to 1e-5 rad and second-peak flags
      equal, descriptors within 1 unit and exact on >= 99 % of entries;
      each kernel's two calls bit-equal. Kernels A and B are also timed on
      the device alone (profiler), apart from their calls' host time.
      Then the ingest kernel (raw uint8 images turned gray and letterboxed)
      bit for bit with its plain version and the host numpy route on a
      chunk of 16 RGB images at 500x667 and a ragged chunk, timed beside
      its byte bound, the raw upload and the host route. Then the int8
      gemm route's float passes at ResNet50's widest gemm conv at 448^2
      (layer3's 1x1/2 downsample, 64 x 56^2 x 512 bf16 to 28^2 x 1,024):
      kernel 8's amax and quantise launches and the epilogue kernel in its
      three modes (BatchNorm; + ReLU; + residual + ReLU), each bit for bit
      with its plain version, timed beside its byte bound and the torch
      passes it replaces. Then the ViT block's float passes at the ViT-g
      cell's shapes (64 images x 1,370 tokens): SwiGLU over 87,680 x 2 x
      4,096 bit for bit with ``F.silu(x1) * x2``, and LayerScale + residual
      + LayerNorm over 87,680 x 1,536 bit for bit with ``torch.addcmul``
      and ``F.layer_norm``, each timed beside its byte bound and the torch
      passes it replaces, with the bandwidth it reaches. Then the same at
      the DINOv3 cell's shapes (16 images x 2,309 tokens): the RoPE
      rotation of qkv's q and k (3 x 4,096, heads of 128) in place, bit for
      bit with its plain route, SwiGLU over 36,944 x 2 x 8,192 and
      add-norm over 36,944 x 4,096 (its streamed path).
   e. The fused conv kernels at the int8 trunk's shapes (VGG16, 224^2,
      bf16, B=128): kernel 7 at conv1 and conv3, kernel 8 pooled at conv6
      and conv9 and unpooled at conv4, 5, 7 and 8, each against its plain
      version on the first 16 images: kernel 8 and its int32 accumulators
      bit for bit, kernel 7 within one bf16 step and exact on >= 99 % of
      entries; kernel 7 in float32 at conv3's shape to 1e-5 * max|ref|;
      each kernel's two calls bit-equal. Timed beside the cuDNN sequence
      conv2d + relu_ + max_pool2d at the same shape; each kernel-8 call's
      time is also split into its per-image amax, quantise pass and conv.
      Then a NaN in one image of a batch: kernel 7 (bf16 and f32) NaN
      exactly where its plain version is and unchanged elsewhere, kernel 8
      (pooled and unpooled) NaN on all of that image, as its plain version,
      and bit for bit with it on the others, int32 sums included.
   f. Kernels 1 and 2 on the golden fixtures that pin the JAX package
      (``tests/testdata/golden_encodings.npz``): VLAD with and without the
      power norm and Fisher vectors, at ``tests/test_golden.py``'s rtol
      1e-5 and atol 1e-6; the one check that does not rest on the plain
      versions.
3. Slice 1: ``VLADEncoder(DeepConvFeature("vgg16", 224, bf16))`` with
   K=256 on 128 images, then retrieval of 8 of them from a gallery of all
   128.
4. Slice 2, on the same extractor: ``FisherVectorEncoder`` with the
   shipped GMM-k256 / PCA-257 and ``Pipeline([vlad, fv])`` encode the 128
   images and retrieve 8 of them; one ``Pipeline.encode`` must run the
   trunk once and launch each kernel once. Then ``learn()`` trains a
   K-Means-256 on the 25,088 514-D descriptors and a PCA-257 + GMM-256,
   with one kernel launch per Lloyd and EM iteration, inertia and
   log-likelihood no worse than at their starts, and retrieval with the
   learned vocabularies.
5. f32 cross-check: 2 images encoded in float32 (cuDNN TF32 off) on the
   card and on the CPU, by VLAD, Fisher vectors and the Pipeline, must
   agree to cosine > 0.9999; so must VLAD over the int8 trunk in float32
   on 2 images at 112^2 (kernels 7 and 8 on the card, their plain
   versions on the CPU).
6. Slice 3: ``VLADEncoder(weights=KMeansWeights.OXFORD102_K256_ROOTSIFT)``
   with its default RootSIFT and ``Pipeline([vlad, fv])`` with the shipped
   GMM-k256/PCA-64 encode 64 structured 384x512 images (four 16-image SIFT
   calls, one extraction for the Pipeline) and retrieve 8 of them; VLAD
   norms sqrt(non-empty clusters), FV norms 1, and the expected launches
   of every SIFT, VLAD and GMM kernel per encode. Prints encode img/s,
   the SIFT core's device ms by stage (on these images and on images that
   fill the keypoint budget) and the host letterbox's ms.
7. Slice 4: ``VLADEncoder(DeepConvFeature("vgg16", 224, bf16, int8=True))``
   with slice 1's centers on its 128 images: 2 launches of kernel 7, 2 of
   pooled and 4 of unpooled kernel 8 and 1 of VLAD per encode, retrieval,
   VLAD norms, and encodings at cosine > 0.999 against the float32 trunk's.
   Prints encode img/s, the device graph's and the int8 and bf16 trunks'
   ms, and device profiles by operator.
8. Serving, on phase 7's encoder: 16 synthetic classes x 13 views at 224^2
   (``datasets.make_retrieval_corpus``); views 0-7 are encoded through
   ``io.prefetch_to_device`` in 64-image batches (bit-equal to direct
   encodes) and expanded (``expand_encodings``, seed 0) to a 6,149 x
   131,584 gallery; views 8-12 are the 80 queries. Four ``RetrievalIndex``
   modes, one at a time: float32, int8, and each with a 256-D screen and
   rerank 128. Gates: the float32 top-5 against a float64 brute force
   (where the 5th-6th margin exceeds 1e-6) with scores to 1e-5; the int8
   scan's int32 sums (``torch._int_mm``) bit for bit with exact float64
   sums at Q=1 and 8; a screened query with rerank >= n equal to its exact
   counterpart; self-retrieval of the 128 real rows (int8 with the screen:
   the top-1 scores as the best dequantised row); a duplicated row in
   ``lax.top_k``'s order; ``add()`` of 2,048 rows across the capacity
   doubling (8,192 -> 16,384) against a whole build; the int8 index
   through save and load with codes and scales bit-equal;
   ``from_encoding_map``, ``build`` and ``generate_encoding_map`` on 16
   PNG files; kernels 1, 7 and 8 held against their plain versions on the
   arguments the path gives them at its batch sizes 64 (a gallery batch),
   80 (the queries) and 1 (``query(encoder, [image])``). Prints query latency at Q=1 and 8 per mode and route (CUDA
   events and host clock, beside the byte bound), device ms by Q (where
   the screen stops beating the full scan), recall@5 of int8 + screen
   against the int8 scan at rerank 16-256, the top-k's cost, and one
   ``query(encoder, [image])`` end to end.

9. The Siamese trainer and encoder: ``SiameseEmbedder("vgg16", 128)`` in
   float32 (TF32 off) trains 30 ``nt_xent`` steps with ``adamw(3e-4)`` on
   32-view batches (8 classes x 4 views, drawn by a seeded generator) of
   the 128 training views of a 16-class synthetic corpus at 224^2: every
   loss finite and the last 5 below the first 5. Then 3 steps each of
   ``triplet``, ``cosface`` and ``arcface`` (16 classes) and 5 steps in
   bf16, all finite; a narrow copy (vgg11, 2 convs, 64^2, B=8) whose loss
   (rel 1e-5) and gradients (1e-3 * max|CPU| each) on the card match the
   CPU's; ``save_train_state``/``restore_train_state`` bit for bit, and
   the next step from both equal under ``cudnn.deterministic``; the
   trained ``SiameseEncoder`` embeds the 128 views (norms 1 within 1e-5)
   and a ragged batch (each image as encoded alone, within 1e-5), and a
   float32 ``RetrievalIndex`` retrieves each view as itself. Prints step
   ms, img/s and peak memory (float32 and bf16), top-1 accuracy and mAP of
   the 80 held-out views for the trained and the untrained encoder, and a
   profile of one step by kernel and operator.
10. ResNet50 trunks: kernels 1 and 3 at D = 2,050 against their plain
   versions at phase 2a's and 2c's gates (128 sets of 49; 6,272 rows),
   timed; ``DeepConvFeature(module=ResNetTrunk("resnet50"))`` at 224^2 on
   phase 3's 128 images in float32 (TF32 off), bf16, int8 (window 7-56,
   float32 around the int8 convs) and int8 in bf16 (the ResNet cell's
   dtype): the float32 trunk on the card against the CPU on 2 images
   (cosine > 0.9999); ``learn()`` of K-Means-256 on the float trunk's
   6,272 descriptors (one kernel-3 launch per Lloyd step); VLAD with those
   centers on each trunk, one kernel-1 launch per encode, and in int8 13
   kernel-8 launches and 39 ``int8_gemm_conv`` calls, each ending in one
   epilogue launch, the 39 in bf16 with their BatchNorm in it (counter
   ``conv.int8_gemm_fused``); self-retrieval on each; every kernel-8,
   ``int8_gemm_conv`` and kernel-1 call of each int8 encode against its
   plain version on the path's arguments (int32 sums bit for bit, the
   bf16 encode's fused calls against the plain conv, BatchNorm, residual
   add and ReLU); int8 against float32 descriptors at cosine > 0.995 per
   image. Prints the trunks' ms per 128 images, encode img/s, each int8
   route's ms beside its bound, and the int8 trunk's device profile.
11. The clustering evaluation at Oxford Flowers-102's scale: a tree in the
   dataset's layout (8,189 224^2 JPEGs of 102 synthetic scene classes,
   ``labels.mat``, ``setid.mat``) in a temporary directory that
   ``PYVISIM_TPU_TORCH_CACHE_DIR`` names, the download replaced by a
   refusal; ``OxfordFlowerDataset(purpose="train")`` (6,149 images, its
   labels as written) through ``iter_batches(128, 224)`` and phase 7's
   int8 VLAD encoder (kernels 7, 8 and 1 as in phase 7 per batch), then
   ``cluster_images_and_generate_statistics`` with 102 clusters by
   K-Means on the 6,149 x 131,584 encodings, spectral clustering on them,
   and spectral clustering on their cosine-similarity matrix. Gates:
   kernel 3 launched once per Lloyd step of the three fits, and held
   against its plain version on each fit's first step (D = 131,584 and
   D = 102, K = 102); ``knn_affinity`` symmetric in {0, 0.5, 1} with a
   unit diagonal, >= 11 nonzeros a row and equal to float64 on clear rows;
   the embedding's columns eigenvectors of L_sym to 1e-3 with ascending
   eigenvalues from 0; RI and ARI equal to a float64 contingency count to
   1e-12; at most 102 clusters. Prints the scores, seconds per call, the
   Lloyd step (queued and synced) and kernel 3 beside their bounds,
   seeding, ``knn_affinity`` beside its bound, ``eigh``, decode ms per
   image and encode img/s.

12. The mesh paths (``pyvisim_tpu_torch.parallel``) in two worlds of
   ranks, each spawned once (``parallel.local.LocalWorld``) and running
   every step: one rank under NCCL, and two ranks sharing the card under
   gloo (NCCL refuses two ranks on one card; gloo's collectives take the
   card's tensors through pinned host memory). Meshes: 'data' over the
   world, and 'data' x 'cluster' and 'data' x 'model' of 1 x the world.
   Steps, each also run on the single card in this process:
   ``distributed_kmeans_fit`` (10 Lloyd steps) on slice 1's 25,088 x 514
   descriptors from kmeans_fit's own k-means++ seeding, K=256;
   ``distributed_pca_fit`` to 257; ``distributed_gmm_fit`` (10 EM steps,
   K=256) on the descriptors after the shipped PCA from the shipped GMM's
   means; ``VLADEncoder`` and ``FisherVectorEncoder`` on
   ``DeepConvFeature(int8, mesh=)`` over phase 3's 128 images;
   ``cluster_sharded_vlad_encode`` and ``cluster_sharded_fisher_encode``;
   ``sharded_sift_batch`` on phase 6's 64 images; ``RetrievalIndex(mesh=)``
   in float32 and int8 on a 6,149 x 131,584 gallery drawn on the card from
   a seed, Q=1 and Q=8; the sharded Siamese VGG16 trainer at 224^2, B=32,
   3 steps in float32 (``cudnn.deterministic``), data-parallel and
   tensor-parallel. Gates: on one rank, K-Means, GMM, both encoders and
   SIFT bit for bit, launches per step equal; on two ranks K-Means
   inertia to rel 1e-5 a step and centers to 1e-4 * max|ref| + 1e-5
   (clusters that a near-tie row changes excused), GMM weights and means
   to 1e-4 of their largest, covariances to 1e-4 of the largest raw second
   moment (cov + mean^2, whose sums round) and log-likelihood to rel 1e-5, encodings to 1e-5 with
   1 - cos <= 1e-6 a row, SIFT bit for bit; in both: PCA mean to 1e-5 *
   max|mean|, variances to 1e-4 of the largest, separated components at
   cos >= 1 - 1e-4; cluster-sharded VLAD against the plain aggregation
   (images with a near-tie descriptor excused) and FV against kernel 2's
   encode at the encodings' gate; index ids equal in order and scores to
   1e-6; DP losses to rel 1e-5 (one rank, first loss bit for bit) or 1e-4
   (two) of the single card's, TP to rel 1e-5 of the single card's and of
   DP's first two steps, and 1e-4 of DP's third; every rank launched every
   kernel. Two ranks' encoders are held against the single card's
   encodes of the same 64-image blocks (the int8 trunk's encodings depend
   on the batch size); the gap to one encode of all 128 is printed. Prints each step's seconds and staged bytes per rank, and
   kernels 3 and 2 and a Q=1 query per rank beside the single card; two
   ranks on one card measure cost per rank, not scaling.

Each slice resets the kernels' launch counts just before it and reads
them just after.

The last two lines of standard output are one JSON object of kernel
numbers and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, the script exits nonzero before printing results.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = pathlib.Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
F32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

B, N, D, K = 128, 196, 514, 256
D_PCA = 257  # the shipped GMM's width: VGG16 descriptors after PCA 514 -> 257
N_TRAIN = B * N  # descriptors of the 128 images: the training set of slice 2


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


def structured_images(rng, n: int, size: int | tuple[int, int] = 224) -> np.ndarray:
    """uint8 images (square ``size`` or ``(height, width)``) of random 8x8
    colour blocks plus noise; unlike pure noise, they give distinct deep
    features and SIFT keypoints, so retrieval is meaningful."""
    h, w = (size, size) if isinstance(size, int) else size
    grid = rng.integers(0, 256, size=(n, 8, 8, 3))
    up = np.repeat(np.repeat(grid, h // 8, axis=1), w // 8, axis=2)
    return np.clip(up + rng.normal(0, 12, size=up.shape), 0, 255).astype(np.uint8)


def self_device_us(e) -> float:
    """A profiler event's device time, under either of torch's names."""
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


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
    events = prof.key_averages()
    kernels = sorted(
        ((e.key, self_device_us(e), e.count) for e in events
         if str(e.device_type).endswith("CUDA")),
        key=lambda kv: -kv[1],
    )
    # The operator that launched each kernel, so that unnamed elementwise
    # kernels can be told apart.
    ops = sorted(
        ((e.key, self_device_us(e)) for e in events
         if str(e.device_type).endswith("CPU") and e.key.startswith("aten::")),
        key=lambda kv: -kv[1],
    )
    busy_ms = sum(us for _, us, _ in kernels) / 1e3
    # "launches" is each kernel's count in the trace: fewer than its
    # launches per call times ``reps`` means the trace lost events.
    return {
        "window_ms_per_call": window_ms / reps,
        "kernel_ms_per_call": busy_ms / reps,
        "idle_share": max(0.0, 1.0 - busy_ms / window_ms),
        "top": [{"kernel": k[:90], "ms_per_call": us / 1e3 / reps, "launches": n}
                for k, us, n in kernels[:top]],
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
        "float32 trunks (phase 5), unused by the bf16 trunk (phases 3 and 4)"
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


def margin_vlad_inputs(b: int = B, n: int = N, d: int = D, seed: int = 0):
    """Phase 2a's inputs on the card: 128 sets of 196 x 514 descriptors (or
    ``b`` sets of ``n`` x ``d``) near 256 known centers (no label is a near
    tie), a tenth of the rows weightless, set 0 fully masked, one
    fractional weight."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    protos = torch.randn(K, d, generator=g)
    true = torch.randint(0, K, (b * n,), generator=g)
    true[:K] = torch.arange(K)  # every cluster populated
    desc = (protos[true] + 0.1 * torch.randn(b * n, d, generator=g)).reshape(b, n, d)
    centers = protos + 0.01 * torch.randn(K, d, generator=g)
    mask = (torch.rand(b, n, generator=g) > 0.1).float()
    mask[0] = 0.0  # one fully masked set
    mask[1, 3] = 0.37  # one fractional weight
    return desc.cuda(), mask.cuda(), centers.cuda()


def margin_lloyd_inputs():
    """Phase 2c's inputs on the card: one set of 25,088 x 514 rows near 256
    known centers, a tenth weightless, one fractional weight."""
    g = torch.Generator(device="cpu").manual_seed(4)
    protos = torch.randn(K, D, generator=g)
    true = torch.randint(0, K, (N_TRAIN,), generator=g)
    true[:K] = torch.arange(K)  # every cluster populated
    desc = (protos[true] + 0.1 * torch.randn(N_TRAIN, D, generator=g)).cuda()
    centers = (protos + 0.01 * torch.randn(K, D, generator=g)).cuda()
    mask = (torch.rand(N_TRAIN, generator=g) > 0.1).float()
    mask[7] = 0.375  # one fractional weight, exact in f32 so counts compare exactly
    return desc, mask.cuda(), centers


def phase_kernel(agg, ls):
    """The kernel against its plain version on margin data; then the NaN
    probe of kernels 1 and 3 on the same rows."""
    desc, mask, centers = margin_vlad_inputs()

    out, labels = agg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    ref, ref_labels = agg.vlad_aggregate_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    mismatches = label_gate(labels, ref_labels, mask, "kernel")
    check(bool((labels[0] == -1).all()), "the fully masked set's labels are not all -1")
    max_diff = float((out - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max()) + 1e-5
    log(f"kernel: label mismatches {mismatches}, max|diff| {max_diff:.3e} (tol {tol:.3e})")
    check(max_diff <= tol, f"kernel output off by {max_diff} > {tol}")
    check(float(out[0].abs().max()) == 0.0, "fully masked set did not aggregate to zero")

    kernel_ms = cuda_ms(lambda: agg.vlad_aggregate_batched(desc, mask, centers))
    plain_ms = cuda_ms(lambda: agg.vlad_aggregate_reference(desc, mask, centers))
    prof = profile_device_graph(lambda: agg.vlad_aggregate_batched(desc, mask, centers),
                                reps=10, top=4)
    log(json.dumps({"kernel_profile": prof}))
    n_valid = int((mask != 0).sum())
    n_bytes = 4 * (B * N * D + B * N + K * D + B * K * D)
    n_ops = 2 * n_valid * K * D + 2 * n_valid * D + 2 * B * K * D
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_CUDA_CORE_FLOPS * 1e3
    log(
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
        f"{max(bytes_ms, ops_ms):.4f} ms ({n_ops / 1e9:.3f} GFLOP f32 -> {ops_ms:.4f} ms, "
        f"{n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms); device by pass {by_pass(prof)}"
    )
    nan_outputs = aggregate_nan_probe(agg, ls, desc, mask, centers, "deep")
    return {
        "name": "vlad_aggregate",
        "route": "cuda",
        "source": "pyvisim_tpu_torch/csrc/aggregate.cu",
        "replaces": "pyvisim_tpu/ops/pallas/aggregate.py:169",
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
        "device_ms": prof["kernel_ms_per_call"],
        "device_ms_by_pass": by_pass(prof),
        "nan_probe_outputs": nan_outputs,
    }


def label_gate(labels, ref_labels, mask, what: str) -> int:
    """Kernels 1 and 3's labels against the plain argmin's: every row of
    nonzero weight equal, every row of zero weight equal or -1 (the kernels
    give such rows -1). Returns the weighted rows that differ."""
    weighted = mask != 0
    mismatches = int((labels != ref_labels)[weighted].sum())
    rest = labels[~weighted]
    stray = int(((rest != ref_labels[~weighted]) & (rest != -1)).sum())
    check(mismatches == 0, f"{what}: {mismatches} weighted rows' labels differ from the plain "
          "argmin")
    check(stray == 0, f"{what}: {stray} weightless rows' labels are neither the plain argmin's "
          "nor -1")
    return mismatches


def by_pass(prof: dict) -> dict:
    """A device profile's ms per call by kernel, under the kernels' short
    names."""
    out = {}
    for t in prof["top"]:
        name = re.search(r"::(\w+)", t["kernel"]) or re.match(r"\w+", t["kernel"])
        name = name.group(name.lastindex or 0)
        out[name] = out.get(name, 0.0) + t["ms_per_call"]
    return out


def aggregate_nan_probe(agg, ls, desc, mask, centers, shape: str) -> dict:
    """Kernels 1 and 3 on ``desc`` with one value poisoned in set 1, column
    7: a NaN in a weighted row, a NaN in a weightless row, an inf in a
    weightless row. Each must be NaN and +-inf exactly where its plain
    version is (the plain one-hot product makes column 7 of set 1 NaN in
    every cluster), equal to it within 1e-4 * max|ref| + 1e-5 elsewhere,
    and Lloyd's inertia NaN where the plain version's is. Kernel 3 takes
    the rows of all sets as one set. Returns the NaN outputs of each."""
    counts = {}
    d = desc.shape[-1]
    for case in ("nan_weighted", "nan_weightless", "inf_weightless"):
        rows = ((mask[1] != 0) == (case == "nan_weighted")).nonzero()[:, 0]
        row = int(rows[len(rows) // 2])  # inside the masked tail of a RootSIFT set
        x = desc.clone()
        x[1, row, 7] = float("inf") if case.startswith("inf") else float("nan")
        got = agg.vlad_aggregate_batched(x, mask, centers)
        want = agg.vlad_aggregate_reference(x, mask, centers)
        flat, m = x.reshape(-1, d), mask.reshape(-1)
        lgot = ls.lloyd_stats(flat, m, centers)
        lwant = ls.lloyd_stats_reference(flat, m, centers)
        torch.cuda.synchronize()
        for what, a, b in ((f"vlad {shape} {case}", got, want),
                           (f"lloyd {shape} {case} sums", lgot[0], lwant[0])):
            check(bool(b.isnan().any()), f"{what}: the plain version lost the NaN")
            check(torch.equal(a.isnan(), b.isnan()), f"{what}: NaN where the plain version has "
                  f"none or none where it has: {int(a.isnan().sum())} vs {int(b.isnan().sum())}")
            check(torch.equal(a.isinf(), b.isinf()) and torch.equal(a[a.isinf()], b[b.isinf()]),
                  f"{what}: inf differs from the plain version")
            fin = b.isfinite()
            err = float((a[fin] - b[fin]).abs().max())
            tol = 1e-4 * float(b[fin].abs().max()) + 1e-5
            check(err <= tol, f"{what}: finite entries off by {err} > {tol}")
            counts[what] = int(a.isnan().sum())
        check(bool(lgot[2].isnan()) == bool(lwant[2].isnan()),
              f"lloyd {shape} {case}: inertia {float(lgot[2])}, plain {float(lwant[2])}")
        counts[f"lloyd {shape} {case} inertia"] = str(float(lgot[2]))  # JSON has no NaN
    log(f"aggregate NaN probe ({shape}): {counts}")
    return counts


def bound(n_ops: int, n_bytes: int) -> dict:
    """The least time of the card for ``n_ops`` f32 operations and
    ``n_bytes`` moved, and which of the two bounds it."""
    ops_ms = n_ops / F32_CUDA_CORE_FLOPS * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ops_gflop": n_ops / 1e9,
        "mb": n_bytes / 1e6,
    }


def max_err(got, want, what: str) -> float:
    """max|got - want|, checked against 1e-4 * max|want| + 1e-5."""
    err = float((got - want).abs().max())
    tol = 1e-4 * float(want.abs().max()) + 1e-5
    log(f"  {what}: max|diff| {err:.3e} (tol {tol:.3e})")
    check(err <= tol, f"{what} off by {err} > {tol}")
    return err


def shipped_gmm():
    from pyvisim_tpu_torch.encoders import GMMWeights

    gmm = GMMWeights.OXFORD102_K256_VGG16_PCA.load().to("cuda")
    check(tuple(gmm.means.shape) == (K, D_PCA), f"shipped GMM is {tuple(gmm.means.shape)}")
    return gmm


def draw_from_gmm(gmm, rows: int, seed: int) -> torch.Tensor:
    """``rows`` descriptors for ``gmm``: half drawn from it, half on the
    segment between two components' means where their weighted densities
    differ by a factor of e^u, u uniform in [-3, 3]. In 257 dimensions a
    draw from one component has a one-hot posterior; the second half keeps
    the softmax from being trivial. A row whose segment has no such point
    is drawn from the GMM too."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w, mu, cov = (t.cpu().double() for t in (gmm.weights, gmm.means, gmm.covariances))
    k = w.shape[0]
    comp = torch.multinomial(w, rows, replacement=True, generator=g)
    x = mu[comp] + cov[comp].sqrt() * torch.randn(rows, mu.shape[1], generator=g,
                                                  dtype=torch.float64)
    half = rows // 2
    a = comp[:half]
    b = torch.multinomial(w, half, replacement=True, generator=g)
    b = torch.where(b == a, (a + 1) % k, b)
    delta = mu[b] - mu[a]
    # log w_a N(x | a) - log w_b N(x | b) at x = mu_a + t * delta is
    # c0 - A t^2 / 2 + Bq (t - 1)^2 / 2; solve it for u.
    big_a = (delta**2 / cov[a]).sum(1)
    big_b = (delta**2 / cov[b]).sum(1)
    c0 = (w[a].log() - w[b].log()
          - 0.5 * cov[a].log().sum(1) + 0.5 * cov[b].log().sum(1))
    u = 6.0 * torch.rand(half, generator=g, dtype=torch.float64) - 3.0
    qa, qb, qc = 0.5 * (big_b - big_a), -big_b, 0.5 * big_b + c0 - u
    root = (qb * qb - 4 * qa * qc).clamp_min(0).sqrt()
    roots = torch.stack([(-qb - root) / (2 * qa), (-qb + root) / (2 * qa)], dim=1)
    inside = (roots >= 0) & (roots <= 1)
    t = torch.where(inside[:, 0], roots[:, 0], roots[:, 1])
    ok = inside.any(dim=1)
    x[:half] = torch.where(ok[:, None], mu[a] + t[:, None] * delta, x[:half])
    return x.float().cuda()


def capture_calls(module, name: str, run) -> list:
    """The arguments of every call ``run()`` makes to ``module.name``."""
    calls = []
    saved = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append((args, kwargs))
        return saved(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        run()
    finally:
        setattr(module, name, saved)
    return calls


def rootsift_encode_calls():
    """The arguments that the main path's RootSIFT encodes give kernels 1
    and 2: one VLAD and one FV encode of slice 3's 64 images with the
    shipped RootSIFT vocabularies, (64, 2048, 128) and (64, 2048, 64)
    after PCA-64, about 361 valid rows a set."""
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder, GMMWeights, KMeansWeights
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.ops import fisher as fisher_ops
    from pyvisim_tpu_torch.ops import vlad as vlad_ops

    images = list(sift_gray_batch(SIFT_IMAGES, seed=0)[0])
    vlad = VLADEncoder(weights=KMeansWeights.OXFORD102_K256_ROOTSIFT)
    fv = FisherVectorEncoder(vlad.feature_extractor,
                             weights=GMMWeights.OXFORD102_K256_ROOTSIFT_PCA)
    vlad_calls = capture_calls(vlad_ops, "vlad_aggregate_batched", lambda: vlad.encode(images))
    gmm_calls = capture_calls(fisher_ops, "gmm_stats_batched", lambda: fv.encode(images))
    check(len(vlad_calls) == 1 and len(gmm_calls) == 1,
          f"RootSIFT encodes made {len(vlad_calls)} VLAD and {len(gmm_calls)} GMM calls")
    return vlad_calls[0], gmm_calls[0]


def check_vlad_rootsift(agg, ls, call) -> dict:
    """Kernel 1 at the RootSIFT VLAD encode's shape, held against its plain
    version there as phase 2a holds it (every valid row's label equal, the
    others equal or -1, the sums within 1e-4 * max|ref| + 1e-5, two calls
    bit-equal), timed for the table beside the plain version, with its
    bound on the valid rows, and profiled by pass; then the NaN probe of
    kernels 1 and 3 on these rows."""
    (desc, mask, centers), _ = call
    out, labels = agg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    again = agg.vlad_aggregate_batched(desc, mask, centers)
    ref, ref_labels = agg.vlad_aggregate_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    valid = mask != 0
    mismatches = label_gate(labels, ref_labels, mask, "vlad rootsift form")
    check(same_bits(out, again), "VLAD kernel does not repeat bit for bit (RootSIFT form)")
    err = max_err(out, ref, "vlad rootsift form sums")
    ms = cuda_ms(lambda: agg.vlad_aggregate_batched(desc, mask, centers))
    plain_ms = cuda_ms(lambda: agg.vlad_aggregate_reference(desc, mask, centers))
    b_, n_, d_ = desc.shape
    k_ = centers.shape[0]
    n_valid = int(valid.sum())
    b = bound(2 * n_valid * k_ * d_ + 2 * n_valid * d_ + 2 * b_ * k_ * d_,
              4 * (b_ * n_ * d_ + b_ * n_ + k_ * d_ + b_ * k_ * d_))
    prof = profile_device_graph(lambda: agg.vlad_aggregate_batched(desc, mask, centers),
                                reps=10, top=4)
    log(json.dumps({"kernel_profile_vlad_rootsift": prof}))
    log(f"vlad rootsift form ({b_} x {n_} x {d_}, K={k_}, {n_valid} valid rows): "
        f"{mismatches} valid-row labels differ, max|diff| {err:.3e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b}); device by pass "
        f"{by_pass(prof)}")
    nan_outputs = aggregate_nan_probe(agg, ls, desc, mask, centers, "rootsift")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "device_ms": prof["kernel_ms_per_call"], "device_ms_by_pass": by_pass(prof),
            "max_abs_err": err, "label_mismatches": mismatches, "nan_probe_outputs": nan_outputs,
            "shape": f"rootsift B={b_} N={n_} D={d_} K={k_}, {n_valid} valid rows"}


def gmm_ll_float64(desc, mask, weights, means, covariances):
    """Kernel 2's masked log-likelihood per set in float64, and the scale
    of its float32 rounding: the sum over rows of the two squares that the
    matmul form cancels, 0.5 sum_d (x^2 + mu^2) / cov at the row's most
    likely component."""
    x, m, w, mu, cov = (t.double() for t in (desc, mask, weights, means, covariances))
    const = torch.log(w) - 0.5 * (torch.log(2 * torch.pi * cov) + mu * mu / cov).sum(1)
    logp = x @ (mu / cov).T - (x * x) @ (0.5 / cov).T + const
    best = logp.argmax(-1)
    squares = 0.5 * ((x * x) / cov[best] + (mu * mu / cov)[best]).sum(-1)
    return (torch.logsumexp(logp, dim=-1) * m).sum(1), (squares * m).sum(1)


def gmm_gate(gs, args, kw, got, what: str, ll_against: str = "plain") -> dict:
    """Kernel 2's statistics ``got`` against its plain version on the same
    arguments: s0, s1 and s2 within 1e-4 * max|ref| + 1e-5 (``max_err``);
    the EM form's log-likelihood within rel 1e-5 of the plain version's
    (``ll_against="plain"``) or, with ``"float64"``, both within rel 1e-5
    of the float64 value or one float32 rounding of each row's squares
    that the matmul form cancels, summed, where that is larger: on real
    descriptors both float32 sums part from float64 by about rel 1e-5."""
    want = gs.gmm_stats_reference(*args, **kw)
    torch.cuda.synchronize()
    rec = {"max_abs_err": max(max_err(a, b, f"{what} {name}")
                              for name, a, b in zip(("s0", "s1", "s2"), got, want))}
    if not kw.get("with_ll"):
        return rec
    if ll_against == "plain":
        rel_ll = abs(float(got[3]) - float(want[3])) / abs(float(want[3]))
        log(f"  {what} ll: kernel {float(got[3]):.6f}, plain {float(want[3]):.6f}, "
            f"rel {rel_ll:.3e}")
        check(rel_ll <= 1e-5, f"{what}: EM log-likelihood off by rel {rel_ll}")
        return {**rec, "ll_rel_err": rel_ll}
    exact, squares = gmm_ll_float64(*args)
    tol = torch.maximum(1e-5 * exact.abs(), 2.0**-24 * squares)
    errs = {"kernel": got[3].double() - exact, "plain": want[3].double() - exact}
    log(f"  {what} ll: float64 {exact.tolist()}, kernel {errs['kernel'].tolist()}, plain "
        f"{errs['plain'].tolist()} (tol {tol.tolist()})")
    check(all(bool((e.abs() <= tol).all()) for e in errs.values()),
          f"{what}: EM log-likelihood off float64 by {errs} > {tol}")
    rel = {k: float((e.abs() / exact.abs()).max()) for k, e in errs.items()}
    return {**rec, "ll_rel_err": rel["kernel"], "ll_plain_rel_err": rel["plain"],
            "ll_tol_rel": float((tol / exact.abs()).max())}


def phase_gmm_kernel(gs, gmm, rootsift_call):
    """The GMM statistics kernel against its plain version, in the Fisher
    form (a batch of sets), the EM form (one large set) and the RootSIFT
    FV encode's form (``rootsift_call``: mostly masked sets)."""
    from pyvisim_tpu_torch.ops import gmm_posteriors

    params = (gmm.weights.contiguous(), gmm.means.contiguous(), gmm.covariances.contiguous())
    k, d = gmm.means.shape
    desc = draw_from_gmm(gmm, B * N, seed=1).reshape(B, N, d).contiguous()
    g = torch.Generator(device="cpu").manual_seed(2)
    mask = (torch.rand(B, N, generator=g) > 0.1).float()
    mask[0] = 0.0  # one fully masked set
    mask[1, 3] = 0.37  # one fractional weight
    mask = mask.cuda()
    got = gs.gmm_stats_batched(desc, mask, *params)
    soft = int((gmm_posteriors(desc, gmm).amax(dim=-1) < 0.99).sum())
    log(f"gmm fisher form: {soft} of {B * N} rows have a largest posterior < 0.99")
    check(soft > 0, "every posterior is one-hot")
    errs = [gmm_gate(gs, (desc, mask, *params), {}, got, "fisher")["max_abs_err"]]
    check(not any(float(t[0].abs().max()) for t in got), "fully masked set has statistics")
    ms = cuda_ms(lambda: gs.gmm_stats_batched(desc, mask, *params))
    plain_ms = cuda_ms(lambda: gs.gmm_stats_reference(desc, mask, *params))
    n_valid = int((mask != 0).sum())
    fv_bound = bound(8 * n_valid * k * d, 4 * (B * N * d + B * N + 3 * k * d + k + B * k
                                               + 2 * B * k * d))
    log(f"gmm fisher form: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{fv_bound['bound_ms']:.4f} ms ({fv_bound})")
    log(json.dumps({"kernel_profile_gmm_fisher": profile_device_graph(
        lambda: gs.gmm_stats_batched(desc, mask, *params), reps=10, top=6)}))

    x = draw_from_gmm(gmm, N_TRAIN, seed=3)[None].contiguous()
    m = torch.ones((1, N_TRAIN), device="cuda")
    m[0, :100] = 0.0
    got = gs.gmm_stats_batched(x, m, *params, with_ll=True)
    em = gmm_gate(gs, (x, m, *params), {"with_ll": True}, got, "em")
    errs.append(em["max_abs_err"])
    rel_ll = em["ll_rel_err"]
    em_ms = cuda_ms(lambda: gs.gmm_stats_batched(x, m, *params, with_ll=True))
    em_plain_ms = cuda_ms(lambda: gs.gmm_stats_reference(x, m, *params, with_ll=True))
    em_bound = bound(8 * (N_TRAIN - 100) * k * d,
                     4 * (N_TRAIN * d + N_TRAIN + 3 * k * d + k + k + 2 * k * d + 1))
    log(f"gmm em form: kernel {em_ms:.4f} ms, plain {em_plain_ms:.4f} ms, bound "
        f"{em_bound['bound_ms']:.4f} ms ({em_bound})")
    log(json.dumps({"kernel_profile_gmm_em": profile_device_graph(
        lambda: gs.gmm_stats_batched(x, m, *params, with_ll=True), reps=10, top=8)}))
    rootsift = check_gmm_rootsift(gs, rootsift_call)
    errs.append(rootsift.pop("max_abs_err"))
    return {
        "name": "gmm_stats",
        "route": "cuda",
        "source": "pyvisim_tpu_torch/csrc/gmm_stats.cu",
        "replaces": "pyvisim_tpu/ops/pallas/aggregate.py:290",
        "replaces_function": "_fisher_kernel (gmm_em_stats_pallas, fisher_stats_pallas)",
        "launches": None,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": fv_bound["bound_ms"],
        "bound_by": fv_bound["bound_by"],
        "library_ms": None,
        "shape": f"fisher B={B} N={N} D={d} K={k}",
        "em_ms": em_ms,
        "em_plain_ms": em_plain_ms,
        "em_bound_ms": em_bound["bound_ms"],
        "em_shape": f"em N={N_TRAIN} D={d} K={k}",
        "em_ll_rel_err": rel_ll,
        "rootsift_fv": rootsift,
    }


def check_gmm_rootsift(gs, call) -> dict:
    """The RootSIFT FV encode's call: sums as the other forms, two calls
    bit-equal, a fully masked set zero, and a NaN in one masked row NaN on
    its set's statistics where the plain version has it, the other sets
    unchanged. Its bound counts the valid rows' products."""
    (desc, mask, *params), kw = call
    got = gs.gmm_stats_batched(desc, mask, *params, **kw)
    again = gs.gmm_stats_batched(desc, mask, *params, **kw)
    want = gs.gmm_stats_reference(desc, mask, *params, **kw)
    torch.cuda.synchronize()
    check(same_bits(got, again), "GMM kernel does not repeat bit for bit (RootSIFT form)")
    err = max(max_err(a, b, f"rootsift fv {name}") for name, a, b in zip(("s0", "s1", "s2"), got, want))
    masked = mask.clone()
    masked[1] = 0.0
    zero = gs.gmm_stats_batched(desc, masked, *params, **kw)
    check(not any(float(t[1].abs().max()) for t in zero), "fully masked RootSIFT set has statistics")
    row = int((mask[0] == 0).nonzero()[0, 0])
    poisoned = desc.clone()
    poisoned[0, row, 3] = float("nan")
    got_nan = gs.gmm_stats_batched(poisoned, mask, *params, **kw)
    want_nan = gs.gmm_stats_reference(poisoned, mask, *params, **kw)
    torch.cuda.synchronize()
    for a, b, clean in zip(got_nan, want_nan, got):
        check(torch.equal(a.isnan(), b.isnan()), "NaN pattern differs from the plain version")
        check(bool(a[0].isnan().all()), "a NaN in a masked row did not reach its set's statistics")
        check(torch.equal(a[1:], clean[1:]), "a NaN in one set moved another set's statistics")
    ms = cuda_ms(lambda: gs.gmm_stats_batched(desc, mask, *params, **kw))
    plain_ms = cuda_ms(lambda: gs.gmm_stats_reference(desc, mask, *params, **kw))
    b_, n_, d_ = desc.shape
    k_ = params[1].shape[0]
    n_valid = int((mask != 0).sum())
    b = bound(8 * n_valid * k_ * d_, 4 * (b_ * n_ * d_ + b_ * n_ + 3 * k_ * d_ + k_ + b_ * k_
                                          + 2 * b_ * k_ * d_))
    log(f"gmm rootsift fv form ({b_} x {n_} x {d_}, K={k_}, {n_valid} valid rows): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b})")
    prof = profile_device_graph(lambda: gs.gmm_stats_batched(desc, mask, *params, **kw),
                                reps=10, top=8)
    log(json.dumps({"kernel_profile_gmm_rootsift": prof}))
    return {"ms": ms, "device_ms": prof["kernel_ms_per_call"], "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "max_abs_err": err,
            "shape": f"rootsift fv B={b_} N={n_} D={d_} K={k_}, {n_valid} valid rows"}


def golden_fixture_gate(agg, gs) -> dict:
    """Phase 2f: kernels 1 and 2 on the golden fixtures that pin the JAX
    package (``tests/testdata/golden_encodings.npz``, ``tests/test_golden.py``),
    at its rtol 1e-5 and atol 1e-6: VLAD with and without the power norm,
    Fisher vectors on the fixtures' GMM and on the shipped
    ``gmm_k256_sift_pca.npz``. The one check on the card that does not rest
    on the plain versions."""
    from pyvisim_tpu_torch._config import MODEL_FILES_PATH
    from pyvisim_tpu_torch.ops import GmmCodebook, fisher_encode, load_codebook, vlad_encode

    with np.load(REPO / "tests" / "testdata" / "golden_encodings.npz") as f:
        g = {k: torch.from_numpy(f[k]).cuda() for k in f.files}
    gmm = GmmCodebook(weights=g["gmm_w"], means=g["gmm_m"], covariances=g["gmm_c"])
    real = load_codebook(MODEL_FILES_PATH / "gmm_k256_sift_pca.npz").to("cuda")
    n1, n2 = agg.vlad_aggregate_batched.launches, gs.gmm_stats_batched.launches
    got = {
        "vlad": vlad_encode(g["desc"], g["mask"], g["centers"]),
        "vlad_p05": vlad_encode(g["desc"], g["mask"], g["centers"], power_norm_weight=0.5),
        "fisher": fisher_encode(g["desc"], g["mask"], gmm),
        "fisher_real": fisher_encode(g["desc_real"], None, real),
    }
    check(agg.vlad_aggregate_batched.launches == n1 + 2 and gs.gmm_stats_batched.launches == n2 + 2,
          "the golden encodes did not launch kernels 1 and 2 twice each")
    errs = {}
    for name, out in got.items():
        want = g[name].double()
        diff = (out.double() - want).abs()
        check(bool((diff <= 1e-6 + 1e-5 * want.abs()).all()),
              f"golden {name}: max|diff| {float(diff.max())} beyond rtol 1e-5, atol 1e-6")
        errs[name] = float(diff.max())
    log(f"golden fixtures on kernels 1 and 2: max|diff| {errs}")
    return errs


def phase_lloyd_kernel(ls):
    """The Lloyd statistics kernel against its plain version on one set of
    margin rows at the training shape."""
    desc, mask, centers = margin_lloyd_inputs()
    sums, counts, inertia, labels = ls.lloyd_stats(desc, mask, centers, return_labels=True)
    r_sums, r_counts, r_inertia, r_labels = ls.lloyd_stats_reference(
        desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    mismatches = label_gate(labels, r_labels, mask, "lloyd")
    log(f"lloyd: label mismatches {mismatches}")
    err = max_err(sums, r_sums, "lloyd sums")
    check(torch.equal(counts, r_counts), "Lloyd counts differ")
    rel = abs(float(inertia) - float(r_inertia)) / float(r_inertia)
    log(f"  lloyd inertia: kernel {float(inertia):.6f}, plain {float(r_inertia):.6f}, rel {rel:.3e}")
    check(rel <= 1e-5, f"Lloyd inertia off by rel {rel}")
    ms = cuda_ms(lambda: ls.lloyd_stats(desc, mask, centers))
    plain_ms = cuda_ms(lambda: ls.lloyd_stats_reference(desc, mask, centers))
    n_valid = int((mask != 0).sum())
    lb = bound(2 * n_valid * K * D + 2 * n_valid * D,
               4 * (N_TRAIN * D + N_TRAIN + K * D + K * D + K + 1))
    prof = profile_device_graph(lambda: ls.lloyd_stats(desc, mask, centers), reps=10, top=6)
    log(json.dumps({"kernel_profile_lloyd": prof}))
    log(f"lloyd: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {lb['bound_ms']:.4f} ms "
        f"({lb}); device by pass {by_pass(prof)}")
    return {
        "name": "lloyd_stats",
        "route": "cuda",
        "source": "pyvisim_tpu_torch/csrc/aggregate.cu",
        "replaces": "pyvisim_tpu/ops/pallas/aggregate.py:93",
        "replaces_function": "_lloyd_kernel (lloyd_stats_pallas)",
        "launches": None,
        "max_abs_err": err,
        "label_mismatches": mismatches,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": lb["bound_ms"],
        "bound_by": lb["bound_by"],
        "library_ms": None,
        "device_ms": prof["kernel_ms_per_call"],
        "device_ms_by_pass": by_pass(prof),
        "shape": f"N={N_TRAIN} D={D} K={K}",
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
    return launches, encode_launches, centers, ext, images


def counting(obj, name: str, counts: dict):
    """Wrap ``obj.name`` so that ``counts[name]`` counts its calls."""
    inner = getattr(obj, name)

    def wrapper(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return inner(*args, **kwargs)

    setattr(obj, name, wrapper)


def self_retrieval(encoder, images, n_queries: int = 8):
    """Encode all ``images`` as a gallery; each of ``n_queries`` of them
    must retrieve itself first. Returns the gallery vectors."""
    from pyvisim_tpu_torch import eval as pv_eval

    vectors = encoder.encode(list(images))
    paths = [f"img_{i:03d}.png" for i in range(len(images))]
    gallery = dict(zip(paths, vectors))
    queries = list(range(0, len(images), len(images) // n_queries))
    top1 = [pv_eval.retrieve_top_k_similar(images[i], gallery, encoder, k=3)[0][0]
            for i in queries]
    accuracy = pv_eval.top_k_accuracy(
        [images[i] for i in queries], queries, gallery,
        {p: i for i, p in enumerate(paths)}, encoder, k=1,
    )
    check(top1 == [paths[i] for i in queries], f"self-retrieval failed: {top1}")
    check(accuracy == 1.0, f"top-1 accuracy {accuracy}")
    return vectors


def images_per_s(encoder, images, reps: int = 3) -> float:
    listed = list(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        encoder.encode(listed)
    return len(listed) * reps / (time.perf_counter() - t0)


def phase_slice2(kernels, ext, centers, images):
    """Fisher vectors, the Pipeline and vocabulary learning through the
    public entry points, on slice 1's bf16 extractor and 128 images."""
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder, GMMWeights, Pipeline, VLADEncoder
    from pyvisim_tpu_torch.ops import KMeansCodebook, validate_codebook

    agg, gs, ls = kernels
    fv = FisherVectorEncoder(ext, weights=GMMWeights.OXFORD102_K256_VGG16_PCA)
    vlad = VLADEncoder(ext, kmeans_model=KMeansCodebook(centers))
    pipe = Pipeline([vlad, fv])
    fv.encode(list(images[:8]))  # warm the PCA and Fisher path
    n_fv = 2 * K * D_PCA + K
    calls = {}
    counting(ext, "_run_trunk", calls)
    for wrapper in (agg.vlad_aggregate_batched, gs.gmm_stats_batched, ls.lloyd_stats):
        wrapper.launches = 0
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    out = pipe.encode(list(images))
    pipe_s = time.perf_counter() - t0
    per_encode = {"trunk": calls.get("_run_trunk", 0), "vlad": agg.vlad_aggregate_batched.launches,
                  "gmm_stats": gs.gmm_stats_batched.launches}
    log(f"slice 2: one Pipeline.encode of {B} images {pipe_s * 1e3:.1f} ms, {per_encode}")
    check(out.shape == (B, K * D + n_fv), f"Pipeline encoding shape {out.shape}")
    check(bool(np.isfinite(out).all()), "non-finite Pipeline encodings")
    check(per_encode == {"trunk": 1, "vlad": 1, "gmm_stats": 1},
          f"one Pipeline.encode ran {per_encode}")

    fv_vecs = self_retrieval(fv, images)
    check(fv_vecs.shape == (B, n_fv), f"FV encoding shape {fv_vecs.shape}")
    norms = np.linalg.norm(fv_vecs.astype(np.float64), axis=1)
    log(f"slice 2: FV norms worst |1 - norm| {float(np.abs(norms - 1).max()):.2e}")
    check(bool(np.abs(norms - 1.0).max() <= 1e-3), "FV norms are not 1")
    self_retrieval(pipe, images)
    numbers = {
        "fv_encode_img_per_s": images_per_s(fv, images),
        "pipeline_encode_img_per_s": images_per_s(pipe, images),
        "pipeline_launches_per_encode": per_encode,
    }

    # Vocabulary learning on the 128 images' 25,088 descriptors.
    learned = {}
    for name, enc, kw in (
        ("kmeans", VLADEncoder(ext), {}),
        ("pca_gmm", FisherVectorEncoder(ext), {"dim_reduction_factor": 2}),
    ):
        history = {}
        before = (ls.lloyd_stats.launches, gs.gmm_stats_batched.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.learn(list(images), n_clusters=K, history=history, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lloyd = ls.lloyd_stats.launches - before[0]
        em = gs.gmm_stats_batched.launches - before[1]
        steps = history["lloyd_inertia"][0]
        lls = history.get("em_mean_ll", [])
        log(f"learn {name}: {seconds:.2f} s; {len(steps)} Lloyd steps ({lloyd} launches), "
            f"inertia {steps[0]:.6g} -> {steps[-1]:.6g}; {len(lls)} EM steps ({em} launches)"
            + (f", mean ll {lls[0]:.6g} -> {lls[-1]:.6g}" if lls else ""))
        check(lloyd == len(steps), f"{lloyd} Lloyd launches for {len(steps)} iterations")
        check(em == len(lls), f"{em} GMM-statistics launches for {len(lls)} EM iterations")
        check(steps[-1] <= steps[0], "final inertia above the k-means++ centers' inertia")
        model = enc.clustering_model
        validate_codebook(model)
        if lls:
            check(lls[-1] >= lls[0], "final mean log-likelihood below the k-means start's")
            check(abs(float(model.weights.sum()) - 1.0) <= 1e-5, "GMM weights do not sum to 1")
            check(bool((model.covariances >= 1e-6).all()), "a covariance is below reg_covar")
            check(enc.pca.n_components == D_PCA, f"PCA to {enc.pca.n_components}")
            validate_codebook(enc.pca)
        self_retrieval(enc, images)
        if name == "kmeans":
            vlad_learned = enc
        else:
            fv_learned = enc
        learned[name] = {"seconds": seconds, "lloyd_iterations": len(steps),
                         "em_iterations": len(lls)}
    numbers["learn"] = learned
    launches = {"vlad": agg.vlad_aggregate_batched.launches,
                "gmm_stats": gs.gmm_stats_batched.launches,
                "lloyd_stats": ls.lloyd_stats.launches}
    check(all(launches.values()), f"slice 2 did not launch every kernel: {launches}")
    # Measurements after the path, outside its launch counts.
    numbers["learn_breakdown"] = learn_breakdown(ext, images, vlad_learned, fv_learned)
    numbers.update(device_graphs(ext, images, vlad, fv))
    log(json.dumps({"slice2": numbers, "launches": launches}))
    return launches, numbers


def host_ms(fn, reps: int = 5) -> float:
    """Mean host-clock time of ``fn`` (which ends in a read-back) per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def learn_breakdown(ext, images, vlad_learned, fv_learned) -> dict:
    """Where ``learn()``'s time goes: extraction, k-means++ seeding, PCA,
    and one Lloyd or EM iteration queued back to back (CUDA events) or
    with the loop's once-per-iteration read-back (host clock)."""
    from pyvisim_tpu_torch.ops import em_step, kmeans_plus_plus_init, lloyd_step, pca_fit

    listed = list(images)
    extract_ms = host_ms(lambda: [ext.extract_batch(listed[i:i + 64])[0].sum().item()
                                  for i in range(0, B, 64)], reps=3)
    desc, _ = ext.extract_batch(listed)
    x = desc.to(torch.float32).reshape(-1, D).contiguous()
    ones = torch.ones((x.shape[0],), device="cuda")
    gen = torch.Generator(device="cuda")
    seed_ms = host_ms(lambda: kmeans_plus_plus_init(gen.manual_seed(0), x, K, ones)[0, 0].item(),
                      reps=2)
    pca_ms = host_ms(lambda: pca_fit(x, D_PCA).components[0, 0].item(), reps=3)
    centers = vlad_learned.clustering_model.centers

    def lloyd_synced():
        new, inertia = lloyd_step(x, ones, centers)
        torch.stack([((new - centers) ** 2).sum(), inertia]).tolist()

    xp = fv_learned.pca(x).contiguous()
    gmm = fv_learned.clustering_model
    out = {
        "extract_128_ms": extract_ms,
        "kmeans_pp_seed_ms": seed_ms,
        "pca_fit_ms": pca_ms,
        "lloyd_step_queued_ms": cuda_ms(lambda: lloyd_step(x, ones, centers), reps=5, rounds=5),
        "lloyd_step_synced_ms": host_ms(lloyd_synced),
        "em_step_queued_ms": cuda_ms(lambda: em_step(xp, ones, gmm, 1e-6), reps=5, rounds=5),
        "em_step_synced_ms": host_ms(lambda: em_step(xp, ones, gmm, 1e-6)[1].item()),
    }
    log(json.dumps({"learn_breakdown": out}))
    return out


def device_graphs(ext, images, vlad, fv) -> dict:
    """The FV and Pipeline device graphs on a batch already on the card:
    trunk, PCA and Fisher vectors (and VLAD), no host copies; and the FV
    core alone (PCA, statistics, normalisation) on its descriptors."""
    dev_images = torch.from_numpy(images).cuda()
    ones = torch.ones((B, N), device="cuda")

    def fv_graph():
        return fv._encode_core(ext._forward(dev_images), ones, fv.clustering_model, fv.pca)

    def pipeline_graph():
        desc = ext._forward(dev_images)
        return (vlad._encode_core(desc, ones, vlad.clustering_model, None),
                fv._encode_core(desc, ones, fv.clustering_model, fv.pca))

    with torch.inference_mode():
        dev_desc = ext._forward(dev_images)
        fv_core_ms = cuda_ms(lambda: fv._encode_core(dev_desc, ones, fv.clustering_model, fv.pca),
                             reps=5, rounds=5)
        fv_ms = cuda_ms(fv_graph, reps=3, rounds=5)
        pipe_ms = cuda_ms(pipeline_graph, reps=3, rounds=5)
        log(json.dumps({"profile_pipeline": profile_device_graph(pipeline_graph, top=10)}))
    out = {
        "fv_encode_core_ms": fv_core_ms,
        "fv_device_graph_ms": fv_ms,
        "fv_device_graph_img_per_s": B / fv_ms * 1e3,
        "pipeline_device_graph_ms": pipe_ms,
        "pipeline_device_graph_img_per_s": B / pipe_ms * 1e3,
    }
    log(json.dumps({"device_graphs": out}))
    return out


def cosine_rows(a, b) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def phase_f32_crosscheck(centers):
    """float32 on the card (TF32 off) against the port on the CPU, both
    with the default seed-0 weights: VLAD, Fisher vectors (shipped
    GMM-k256 / PCA-257) and the Pipeline of both."""
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder, GMMWeights, Pipeline, VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.ops import KMeansCodebook

    images = structured_images(np.random.default_rng(1), 2)
    vecs = {}
    for device in ("cuda", "cpu"):
        ext = DeepConvFeature("vgg16", image_size=224, device=device)
        vlad = VLADEncoder(ext, kmeans_model=KMeansCodebook(centers))
        fv = FisherVectorEncoder(ext, weights=GMMWeights.OXFORD102_K256_VGG16_PCA)
        vecs[device] = {"vlad": vlad.encode(images), "fv": fv.encode(images),
                        "pipeline": Pipeline([vlad, fv]).encode(images)}
    for name in ("vlad", "fv", "pipeline"):
        a, b = vecs["cuda"][name], vecs["cpu"][name]
        cos = cosine_rows(a, b)
        log(f"f32 card vs cpu, {name}: cosine {cos.tolist()}, "
            f"max|diff| {float(np.abs(a.astype(np.float64) - b).max()):.3e}")
        check(bool((cos > 0.9999).all()), f"float32 card and CPU {name} encodings disagree: {cos}")
    # The int8 trunk in float32 at 112^2 (conv2-6 int8), where the CPU's
    # exact float64 int8 convs take seconds: kernels 7 and 8 on the card
    # against their plain versions on the CPU, end to end.
    small = structured_images(np.random.default_rng(2), 2, 112)
    int8_vecs = [VLADEncoder(DeepConvFeature("vgg16", image_size=112, int8=True, device=device),
                             kmeans_model=KMeansCodebook(centers)).encode(small)
                 for device in ("cuda", "cpu")]
    cos = cosine_rows(*int8_vecs)
    log(f"f32 card vs cpu, int8 trunk at 112^2: cosine {cos.tolist()}, max|diff| "
        f"{float(np.abs(int8_vecs[0].astype(np.float64) - int8_vecs[1]).max()):.3e}")
    check(bool((cos > 0.9999).all()), f"float32 int8-trunk card and CPU encodings disagree: {cos}")


SIFT_BATCH = 16  # images per SIFT device call (PYVISIM_SIFT_DEVICE_BATCH)
SIFT_IMAGES = 64  # slice 3's gallery
SIFT_HW = (384, 512)


def sift_gray_batch(n: int, seed: int):
    """``n`` structured RGB images at 384x512 and their letterboxed uint8
    grayscale at the default process size."""
    from pyvisim_tpu_torch.features._features import _to_gray_u8
    from pyvisim_tpu_torch.ops import sift as sift_ops

    images = structured_images(np.random.default_rng(seed), n, SIFT_HW)
    grays = np.stack([sift_ops._letterbox(_to_gray_u8(im), sift_ops.SiftConfig().process_size)
                      for im in images])
    return images, grays


def full_budget_grays(n: int, seed: int) -> np.ndarray:
    """``n`` letterboxed uint8 grayscale 384x512 images of 1/f noise,
    whose detail at every scale fills the default keypoint budget: the
    most work one SIFT call can give its kernels."""
    from pyvisim_tpu_torch.ops import sift as sift_ops

    rng = np.random.default_rng(seed)
    h, w = SIFT_HW
    f2 = np.fft.fftfreq(h)[:, None] ** 2 + np.fft.fftfreq(w)[None, :] ** 2
    f2[0, 0] = 1.0
    grays = []
    for _ in range(n):
        spec = (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w))) / np.sqrt(f2)
        x = np.fft.ifft2(spec).real
        x = np.clip(128 + 48 * (x - x.mean()) / x.std(), 0, 255).astype(np.uint8)
        grays.append(sift_ops._letterbox(x, sift_ops.SiftConfig().process_size))
    return np.stack(grays)


def capture_kernel_calls(kernels, run) -> dict:
    """The arguments of every SIFT kernel call ``run()`` makes."""
    names = ("refine", "orientation", "descriptor")
    calls = {name: [] for name in names}
    saved = {name: getattr(kernels, name) for name in names}

    def recorder(name):
        def wrapped(*args, **kwargs):
            calls[name].append((args, kwargs))
            return saved[name](*args, **kwargs)
        # A wrapper counts its launches on the module attribute of its name.
        wrapped.launches = saved[name].launches
        return wrapped

    try:
        for name in names:
            setattr(kernels, name, recorder(name))
        run()
    finally:
        for name in names:
            saved[name].launches = getattr(kernels, name).launches
            setattr(kernels, name, saved[name])
    return calls


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_sift_kernels(kernels):
    """Kernels A (refinement), B (orientation) and C (descriptor) against
    their plain versions on the card, on the arguments one 16-image device
    call of the SIFT core at the default SiftConfig() gives them: the main
    path's images, then images that fill the keypoint budget. The records
    hold the main path's numbers, and the full budget's under
    ``full_budget``."""
    from pyvisim_tpu_torch.ops import sift as sift_ops

    cfg = sift_ops.SiftConfig()
    loads = {"main path": sift_gray_batch(SIFT_BATCH, seed=0)[1],
             "full budget": full_budget_grays(SIFT_BATCH, seed=0)}
    records = []
    for load, grays in loads.items():
        batch = torch.from_numpy(grays).cuda()
        with torch.inference_mode():
            calls = capture_kernel_calls(kernels, lambda: sift_ops._sift_core(batch, cfg))
            torch.cuda.synchronize()
            records.append([check_refine(kernels, calls["refine"], load),
                            check_orientation(kernels, calls["orientation"], load),
                            check_descriptor(kernels, calls["descriptor"], load)])
    main, full = records
    for rec, other in zip(main, full):
        rec["full_budget"] = {key: other[key] for key in (
            "max_abs_err", "ms", "device_ms", "device_ms_valid_only", "plain_ms", "bound_ms",
            "bound_by", "shape")
            if key in other}
    return main


def phase_ingest(ingest):
    """The ingest kernel (raw uint8 images turned gray and letterboxed in
    one launch a chunk) against its plain version and the host numpy
    route, bit for bit, on a gallery chunk (16 RGB images of 500x667, a
    slice of one batch array, letterboxed to the default process size) and
    a ragged one (gray, RGBA, 1x1, an image of the process size); timed on
    the gallery chunk beside its byte bound: the launch alone (device time,
    its tables on the card), the wrapper's call (with the copy of its
    tables), the plain version on the card, the raw chunk's pageable
    upload and the host route it replaces."""
    from pyvisim_tpu_torch.ops import sift as sift_ops
    from pyvisim_tpu_torch.ops.cuda.aggregate import launch_target

    size = sift_ops.SiftConfig().process_size
    rng = np.random.default_rng(0)
    loads = {
        "gallery": rng.integers(0, 256, (2 * SIFT_BATCH, 500, 667, 3), np.uint8)[SIFT_BATCH:],
        "ragged": [rng.integers(0, 256, shape, np.uint8) for shape in
                   [(500, 667, 3), (333, 211), (640, 480, 4), (1, 1, 3), (512, 384, 3),
                    (17, 900), (500, 667, 3)]],
    }
    rec = {"name": "ingest_gray_letterbox", "route": "cuda",
           "source": "pyvisim_tpu_torch/csrc/ingest.cu", "replaces": None,
           "replaces_function": "none: the host's _to_gray_u8 and _letterbox (numpy)",
           "library_ms": None}
    for load, images in loads.items():
        raw, layout, taps = sift_ops._chunk_layout(images, size)
        dev_raw = torch.from_numpy(raw).cuda()
        before = ingest.gray_letterbox.launches
        got = ingest.gray_letterbox(dev_raw, layout, taps, size)
        torch.cuda.synchronize()
        check(ingest.gray_letterbox.launches == before + 1, f"ingest ({load}): not one launch")
        plain = ingest.gray_letterbox_reference(dev_raw, layout, taps, size)
        host = np.stack([sift_ops._letterbox(sift_ops._to_gray_u8(im), size) for im in images])
        check(torch.equal(got, plain), f"ingest ({load}): the kernel differs from its plain version")
        check(np.array_equal(got.cpu().numpy(), host), f"ingest ({load}): differs from the host")
        log(f"ingest ({load}): {len(layout)} images, kernel = plain version = host route")
    raw, layout, taps = sift_ops._chunk_layout(loads["gallery"], size)
    dev_raw = torch.from_numpy(raw).cuda()
    meta = torch.from_numpy(np.concatenate([layout.reshape(-1), taps])).cuda()
    out = torch.empty((len(layout), size, size), dtype=torch.uint8, device="cuda")
    lib = ingest._library()
    index, stream = launch_target(dev_raw.device)

    def launch():
        return lib.ingest_gray_letterbox(dev_raw.data_ptr(), meta.data_ptr(), len(layout), size,
                                         out.data_ptr(), index, stream)

    check(launch() == 0, "ingest launch failed")
    kernel_ms = profile_device_graph(launch, reps=20, top=1)["kernel_ms_per_call"]
    call_ms = cuda_ms(lambda: ingest.gray_letterbox(dev_raw, layout, taps, size))
    plain_ms = cuda_ms(lambda: ingest.gray_letterbox_reference(dev_raw, layout, taps, size),
                       reps=2, rounds=3)
    upload_ms = cuda_ms(lambda: torch.from_numpy(raw).cuda(), reps=3, rounds=5)
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        [sift_ops._letterbox(sift_ops._to_gray_u8(im), size) for im in loads["gallery"]]
        host.append((time.perf_counter() - t0) * 1e3)
    # Each raw byte read once, each output byte written once (the tables
    # are 0.03 MB).
    b = bound(0, raw.nbytes + out.numel())
    rec.update({"launches": None, "max_abs_err": 0.0, "ms": call_ms, "device_ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "raw_upload_ms": upload_ms, "host_route_ms": statistics.median(host),
                "launches_per_16_image_call": 1,
                "shape": f"{len(layout)} x 500 x 667 x 3 uint8 -> {len(layout)} x {size}^2"})
    log(f"ingest: kernel {kernel_ms:.4f} ms device, call {call_ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {b['bound_ms']:.4f} ms ({b}); raw upload {upload_ms:.4f} ms; host route "
        f"{rec['host_route_ms']:.2f} ms per 16 images")
    return rec


def phase_int8_epilogue(conv, epi):
    """The int8 gemm route's float passes around ``torch._int_mm`` at
    ResNet50's widest gemm conv at 448^2 (layer3's 1x1/2 downsample: 64 x
    56^2 x 512 bf16 in, 28^2 x 1,024 out), on BatchNorm drawn as the ResNet
    cell draws it: kernel 8's amax and quantise launches against the torch
    quantiser they replace (``quantize_activation``: a reduction, a cast,
    a divide, a round, a clamp and a cast), and the epilogue kernel in each
    mode against the torch passes it replaces (a cast, two multiplies and a
    cast to dequantise, ``F.batch_norm``, the residual add, ``relu``); each
    bit for bit with its plain version first, then timed beside its byte
    bound (device time from the profiler, the call's with CUDA events)."""
    from pyvisim_tpu_torch.models import quant
    from pyvisim_tpu_torch.ops.cuda.aggregate import launch_target

    b, h, cin, cout, ho = 64, 56, 512, 1024, 28
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((b, h, h, cin), device="cuda", generator=g).relu_().to(torch.bfloat16)
    wq, sw = conv.quantize_weight(torch.randn(cout, 1, 1, cin, device="cuda", generator=g)
                                  / cin ** 0.5)
    wq = wq.contiguous()
    bn = (torch.rand(cout, device="cuda", generator=g) + 0.5,
          0.1 * torch.randn(cout, device="cuda", generator=g),
          0.1 * torch.randn(cout, device="cuda", generator=g),
          1.5 * torch.rand(cout, device="cuda", generator=g) + 0.5, 1e-5)
    residual = torch.randn((b, ho, ho, cout), device="cuda", generator=g).to(torch.bfloat16)
    lib = conv._library()
    dev, stream = launch_target(x.device)
    sx = conv._scale_launch(lib, x, dev, stream)
    xq = conv._quantize_launch(lib, x, sx, dev, stream)
    want_xq, want_sx = conv.quantize_activation(x)
    check(torch.equal(sx, want_sx) and torch.equal(xq, want_xq),
          "kernel 8's quantiser differs from quantize_activation at the gemm route's shape")
    rows, _ = quant._im2col_rows(xq, 1, 2, 0)
    acc = quant._int_mm(rows, wq.reshape(cout, cin)).view(b, ho, ho, cout)
    n_in, n_out = x.numel(), acc.numel()
    quantiser = {
        "amax": {"call": lambda: conv._scale_launch(lib, x, dev, stream), "bytes": 2 * n_in},
        "quantise": {"call": lambda: conv._quantize_launch(lib, x, sx, dev, stream),
                     "bytes": 2 * n_in + n_in},
    }
    rec = {"name": "int8_gemm_epilogue", "route": "cuda",
           "source": "pyvisim_tpu_torch/csrc/int8_epilogue.cu", "replaces": None,
           "replaces_function": "none: the int8 gemm route's dequantise + BatchNorm epilogue",
           "library_ms": None, "shape": f"{b} x {h}^2 x {cin} bf16 -> 1x1/2 -> {ho}^2 x {cout}"}
    for name, part in quantiser.items():
        rec[name] = {"device_ms": profile_device_graph(part["call"], reps=20)["kernel_ms_per_call"],
                     "ms": cuda_ms(part["call"]), **bound(0, part["bytes"])}
    rec["torch_quantiser_ms"] = cuda_ms(lambda: conv.quantize_activation(x))
    rec["torch_quantiser"] = profile_device_graph(lambda: conv.quantize_activation(x), reps=5)
    modes = {"bn": {"bn": bn}, "bn_relu": {"bn": bn, "relu": True},
             "bn_residual_relu": {"bn": bn, "relu": True, "residual": residual}}
    for mode, kw in modes.items():
        call = lambda kw=kw: epi.gemm_epilogue(acc, sx, sw, dtype=torch.bfloat16, **kw)
        plain = lambda kw=kw: epi.gemm_epilogue_reference(acc, sx, sw, dtype=torch.bfloat16, **kw)
        check(torch.equal(call(), plain()), f"the epilogue kernel ({mode}) differs from its plain version")
        n_bytes = 4 * n_out + 2 * n_out + (2 * n_out if "residual" in kw else 0) + 4 * b + 20 * cout
        rec[mode] = {"device_ms": profile_device_graph(call, reps=20)["kernel_ms_per_call"],
                     "ms": cuda_ms(call), "plain_ms": cuda_ms(plain),
                     "plain": profile_device_graph(plain, reps=5), **bound(0, n_bytes)}
    # In float32 the kernel's BatchNorm is ATen's, which F.batch_norm runs on
    # an NCHW-contiguous map; a channels-last one (the trunk's layout) goes
    # to cuDNN: how far apart the two are, in float32 steps.
    got = epi.gemm_epilogue(acc, sx, sw, dtype=torch.float32, bn=bn)
    y = epi.gemm_epilogue_reference(acc, sx, sw, dtype=torch.float32).permute(0, 3, 1, 2)
    weight, bias, mean, var, eps = bn
    aten = F.batch_norm(y.contiguous(), mean, var, weight, bias, False, 0.0, eps)
    cudnn = F.batch_norm(y, mean, var, weight, bias, False, 0.0, eps)
    check(torch.equal(got, aten.permute(0, 2, 3, 1)),
          "the float32 epilogue differs from ATen's BatchNorm on an NCHW map")
    cudnn = cudnn.permute(0, 2, 3, 1)
    step = torch.nextafter(cudnn.abs(), torch.tensor(float("inf"), device="cuda")) - cudnn.abs()
    apart = (got - cudnn).abs() / step
    rec["float32_vs_cudnn"] = {"share_differing": float((got != cudnn).float().mean()),
                               "max_steps": float(apart.max()),
                               "share_one_step": float((apart == 1).float().mean())}
    log(json.dumps({"int8_epilogue": rec}))
    log("int8 gemm route at layer3's downsample: amax {:.4f} ms, quantise {:.4f} ms (torch "
        "quantiser {:.4f} ms); epilogue bn {:.4f}, +relu {:.4f}, +residual {:.4f} ms device "
        "(torch passes {:.4f}, {:.4f}, {:.4f} ms)".format(
            rec["amax"]["device_ms"], rec["quantise"]["device_ms"], rec["torch_quantiser_ms"],
            *(rec[m]["device_ms"] for m in modes), *(rec[m]["plain_ms"] for m in modes)))
    return rec


def time_passes(passes: dict) -> dict:
    """Each pass's device time (profiler) and call time (CUDA events) beside
    its byte bound and its plain version's, with the bandwidth it reaches."""
    out = {}
    for name, part in passes.items():
        device_ms = profile_device_graph(part["call"], reps=20)["kernel_ms_per_call"]
        plain = profile_device_graph(part["plain"], reps=5)
        out[name] = {"shape": part["shape"], "device_ms": device_ms,
                     "ms": cuda_ms(part["call"]), "plain_ms": cuda_ms(part["plain"]),
                     "plain_device_ms": plain["kernel_ms_per_call"], "plain": plain,
                     "tb_per_s": part["bytes"] / device_ms / 1e9, **bound(0, part["bytes"])}
    return out


def phase_vit_passes(vp):
    """The ViT block's two float-pass kernels at the ViT-g cell's shapes, on
    maps drawn as the trunk carries them: each against its plain version
    (the torch passes it replaces) first, then timed beside its byte bound
    (device time from the profiler, the call's with CUDA events) and the
    plain version, with the bandwidth each reaches."""
    rows, hidden, width = 64 * 1370, 4096, 1536
    g = torch.Generator(device="cuda").manual_seed(26)
    x12 = (2.0 * torch.randn(rows, 2 * hidden, device="cuda", generator=g)).to(torch.bfloat16)
    x = (3.0 * torch.randn(rows, width, device="cuda", generator=g)).to(torch.bfloat16)
    y = torch.randn(rows, width, device="cuda", generator=g).to(torch.bfloat16)
    gamma = (0.2 + 0.4 * torch.rand(width, device="cuda", generator=g)).to(torch.bfloat16)
    weight = (0.5 + torch.rand(width, device="cuda", generator=g)).to(torch.bfloat16)
    bias = (0.1 * torch.randn(width, device="cuda", generator=g)).to(torch.bfloat16)
    norm = (gamma, weight, bias, 1e-6)
    with torch.inference_mode():
        check(torch.equal(vp.swiglu(x12).view(torch.int16),
                          vp.swiglu_reference(x12).view(torch.int16)),
              "the SwiGLU kernel differs from F.silu(x1) * x2")
        for got, want in zip(vp.add_norm(x, y, *norm), vp.add_norm_reference(x, y, *norm)):
            check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  "the add-norm kernel differs from torch.addcmul and F.layer_norm")
        rec = {"name": "vit_passes", "route": "cuda", "source": "pyvisim_tpu_torch/csrc/vit_passes.cu",
               "replaces": None, "library_ms": None,
               "replaces_function": "none: the ViT block's SwiGLU and LayerScale-add-LayerNorm "
                                    "torch passes"}
        passes = {
            "swiglu": {"call": lambda: vp.swiglu(x12), "plain": lambda: vp.swiglu_reference(x12),
                       "bytes": 2 * x12.numel() + 2 * rows * hidden,
                       "shape": f"{rows} x 2 x {hidden} bf16"},
            "add_norm": {"call": lambda: vp.add_norm(x, y, *norm),
                         "plain": lambda: vp.add_norm_reference(x, y, *norm),
                         "bytes": 4 * 2 * x.numel() + 6 * width,
                         "shape": f"{rows} x {width} bf16"},
        }
        rec.update(time_passes(passes))
    log(json.dumps({"vit_passes": rec}))
    log("ViT passes at the ViT-g cell: swiglu {:.4f} ms device ({:.2f} TB/s; bound {:.4f}; torch "
        "passes {:.4f}), add_norm {:.4f} ms device ({:.2f} TB/s; bound {:.4f}; torch passes "
        "{:.4f})".format(*(rec[n][k] for n in passes for k in ("device_ms", "tb_per_s",
                                                                 "bound_ms", "plain_device_ms"))))
    return rec


def phase_dinov3_passes(vp, vit):
    """The RoPE kernel at the DINOv3 cell's shapes (16 images x 2,309 tokens,
    qkv 3 x 4,096 in bf16, 32 heads of 128, the 48 x 48 grid's table), and
    the other two float-pass kernels at its widths (``swiglu`` at 36,944 x 2
    x 8,192; ``add_norm`` at 36,944 x 4,096, eps 1e-5, its streamed path):
    each against its plain version first, bit for bit, then timed beside
    its byte bound (device time from the profiler, the call's with CUDA
    events) and the plain version, with the bandwidth each reaches. The
    rotation is in place, so its timed calls rotate the same buffer on."""
    b, n, dim, hidden = 16, 2309, 4096, 8192
    rows, patches = b * n, 48 * 48
    g = torch.Generator(device="cuda").manual_seed(27)
    qkv = (3.0 * torch.randn(b, n, 3 * dim, device="cuda", generator=g)).to(torch.bfloat16)
    table = vit.rope_table(48, 48, 128, device="cuda")
    x12 = (2.0 * torch.randn(rows, 2 * hidden, device="cuda", generator=g)).to(torch.bfloat16)
    x = (3.0 * torch.randn(rows, dim, device="cuda", generator=g)).to(torch.bfloat16)
    y = torch.randn(rows, dim, device="cuda", generator=g).to(torch.bfloat16)
    gamma = (0.2 + 0.4 * torch.rand(dim, device="cuda", generator=g)).to(torch.bfloat16)
    weight = (0.5 + torch.rand(dim, device="cuda", generator=g)).to(torch.bfloat16)
    bias = (0.1 * torch.randn(dim, device="cuda", generator=g)).to(torch.bfloat16)
    norm = (gamma, weight, bias, 1e-5)
    with torch.inference_mode():
        check(torch.equal(vp.rope(qkv.clone(), table).view(torch.int16),
                          vp.rope_reference(qkv.clone(), table).view(torch.int16)),
              "the RoPE kernel differs from its plain route at the DINOv3 cell's shapes")
        check(torch.equal(vp.swiglu(x12).view(torch.int16),
                          vp.swiglu_reference(x12).view(torch.int16)),
              "the SwiGLU kernel differs from F.silu(x1) * x2 at halves of 8,192")
        for got, want in zip(vp.add_norm(x, y, *norm), vp.add_norm_reference(x, y, *norm)):
            check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  "the add-norm kernel differs from torch.addcmul and F.layer_norm at 4,096")
        rec = {"name": "vit_rope", "route": "cuda",
               "source": "pyvisim_tpu_torch/csrc/vit_passes.cu", "replaces": None,
               "library_ms": None,
               "replaces_function": "none: DINOv3's RoPE rotation of q and k (x cos + "
                                    "rotate_half(x) sin in float32), as torch passes"}
        passes = {
            "rope": {"call": lambda: vp.rope(qkv, table),
                     "plain": lambda: vp.rope_reference(qkv, table),
                     "bytes": 2 * 2 * (b * patches * 2 * dim),
                     "shape": f"{b} x {n} x 3 x {dim} bf16, {patches} patches, heads of 128"},
            "swiglu": {"call": lambda: vp.swiglu(x12), "plain": lambda: vp.swiglu_reference(x12),
                       "bytes": 2 * x12.numel() + 2 * rows * hidden,
                       "shape": f"{rows} x 2 x {hidden} bf16"},
            "add_norm": {"call": lambda: vp.add_norm(x, y, *norm),
                         "plain": lambda: vp.add_norm_reference(x, y, *norm),
                         "bytes": 4 * 2 * x.numel() + 6 * dim,
                         "shape": f"{rows} x {dim} bf16"},
        }
        rec.update(time_passes(passes))
    log(json.dumps({"dinov3_passes": rec}))
    log("DINOv3 passes: rope {:.4f} ms device ({:.2f} TB/s; bound {:.4f}; plain {:.4f}), swiglu "
        "{:.4f} ms ({:.2f} TB/s; bound {:.4f}; torch passes {:.4f}), add_norm {:.4f} ms ({:.2f} "
        "TB/s; bound {:.4f}; torch passes {:.4f})".format(
            *(rec[name][k] for name in passes for k in ("device_ms", "tb_per_s", "bound_ms",
                                                         "plain_device_ms"))))
    return rec


def time_calls(fn, calls, **kw) -> float:
    """CUDA-event ms of ``fn`` over all ``calls`` (one device call's worth)."""
    return cuda_ms(lambda: [fn(*a, **k) for a, k in calls], **kw)


def refine_gate(kernels, args, kw) -> dict:
    """Kernel A on one call's arguments against its plain version: ok
    flags and positions equal, offsets and contrast to 1e-5 (the kernel
    repeats the plain version's f32 operations), two calls bit-equal."""
    got = kernels.refine(*args, **kw)
    again = kernels.refine(*args, **kw)
    want, fits = kernels.refine_reference(*args, **kw, return_steps=True)
    torch.cuda.synchronize()
    check(same_bits(got, again), "refinement kernel does not repeat bit for bit")
    check(torch.equal(got.ok, want.ok), f"{int((got.ok != want.ok).sum())} ok flags differ")
    for name in ("layer", "row", "col"):
        check(torch.equal(getattr(got, name), getattr(want, name)), f"refined {name} differs")
    err = max(float((getattr(got, name) - getattr(want, name)).abs().max())
              for name in ("xr", "xc", "xi", "contrast"))
    check(err <= 1e-5, f"refined offsets off by {err}")
    return {"max_abs_err": err, "candidates": int(args[5].sum()), "kept": int(got.ok.sum()),
            "fits": int(fits.sum())}


def check_refine(kernels, calls, load: str) -> dict:
    """One launch over every octave; ok flags and positions equal, offsets
    and contrast to 1e-5 (the kernel repeats the plain version's f32
    operations, so 0 is expected), two kernel calls bit-equal."""
    check(len(calls) == 1, f"the SIFT call refined in {len(calls)} launches, not 1")
    recs = [refine_gate(kernels, args, kw) for args, kw in calls]
    err = max(r["max_abs_err"] for r in recs)
    n_cand, n_ok, fits_total = (sum(r[k] for r in recs) for k in ("candidates", "kept", "fits"))
    ms = time_calls(kernels.refine, calls)
    plain_ms = time_calls(kernels.refine_reference, calls, reps=3, rounds=5)
    # The launch's own device time, apart from the host time of the call
    # that the back-to-back timing above reads when it is the longer.
    prof = profile_device_graph(lambda: time_calls(kernels.refine, calls, reps=1, rounds=1,
                                                   warmup=0), reps=10, top=2)
    device_ms = prof["kernel_ms_per_call"]
    # Whether compacting the valid candidates first would pay: the launch's
    # device time on them alone (the compaction itself not counted).
    (dogs, img, layer, row, col, valid), kw = calls[0]
    keep = valid.nonzero()[:, 0]
    kept = dict(kw, counts=[int(part.sum()) for part in valid.split(kw["counts"])])
    only_valid = [t[keep].contiguous() for t in (img, layer, row, col, valid)]
    valid_only_ms = profile_device_graph(lambda: kernels.refine(dogs, *only_valid, **kept),
                                         reps=10, top=2)["kernel_ms_per_call"]
    n_rows = sum(args[5].numel() for args, _ in calls)
    # Each fit reads the 19 DoG values of its stencils and does ~100 f32
    # operations; each row reads 17 bytes and writes 29.
    b = bound(100 * fits_total, 19 * 4 * fits_total + 46 * n_rows)
    log(f"sift refine ({load}): {len(calls)} launch(es) per call, {n_cand} valid of {n_rows} candidates, "
        f"{n_ok} kept, {fits_total} fits; max|diff| {err:.3e}; kernel {ms:.4f} ms "
        f"(device {device_ms:.4f}, on the valid candidates alone {valid_only_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b})")
    return {
        "name": "sift_refine", "route": "cuda",
        "source": "pyvisim_tpu_torch/csrc/sift_window.cu",
        "replaces": "pyvisim_tpu/ops/pallas/sift_window.py:855",
        "replaces_function": "_refine_gather_kernel (refine_gather_pass) + _refine_candidates",
        "launches": None, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
        "device_ms_valid_only": valid_only_ms,
        "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": None, "launches_per_16_image_call": len(calls),
        "shape": f"{n_rows} candidates over {len(calls[0][0][0])} octaves, {n_cand} valid, "
                 f"{n_ok} kept",
    }


def window_pixels(kw, radius_f) -> int:
    """Window pixels of the valid keypoints of one orientation call, each
    at min(class radius, radius_f)."""
    rad = torch.minimum(kw["radius"], radius_f.to(torch.int32))[kw["valid"]].to(torch.int64)
    return int(((2 * rad + 1) ** 2).sum())


def orientation_gate(kernels, args, kw) -> dict:
    """Kernel B on one call's (keyword) arguments against its plain
    version: theta to 1e-5 rad where the keypoint is valid, theta2 where
    both find a second peak, has_second equal, two calls bit-equal."""
    got = kernels.orientation(*args, **kw)
    again = kernels.orientation(*args, **kw)
    want = kernels.orientation_reference(*args, **kw)
    torch.cuda.synchronize()
    check(same_bits(got, again), "orientation kernel does not repeat bit for bit")
    valid = kw["valid"]
    mismatched = int((got[2] != want[2]).sum())
    check(mismatched == 0, f"has_second differs on {mismatched} keypoints")
    err = float((got[0] - want[0])[valid].abs().max()) if valid.any() else 0.0
    if got[2].any():
        err = max(err, float((got[1] - want[1])[got[2]].abs().max()))
    check(err <= 1e-5, f"orientation off by {err} rad")
    return {"max_abs_err": err, "valid": int(valid.sum()), "second_peaks": int(got[2].sum())}


def check_orientation(kernels, calls, load: str) -> dict:
    """theta to 1e-5 rad where the keypoint is valid, theta2 where both
    find a second peak, has_second equal, two kernel calls bit-equal."""
    (args, kw), = calls
    gate = orientation_gate(kernels, args, kw)
    err = gate["max_abs_err"]
    valid = kw["valid"]
    ms = time_calls(kernels.orientation, calls)
    plain_ms = time_calls(kernels.orientation_reference, calls, reps=1, rounds=3, warmup=1)
    # The launch's own device time, apart from the host time of the call.
    device_ms = profile_device_graph(lambda: time_calls(kernels.orientation, calls, reps=1,
                                                        rounds=1, warmup=0),
                                     reps=10, top=2)["kernel_ms_per_call"]
    n = valid.numel()
    pix = window_pixels(kw, torch.round(4.5 * kw["scl"]))
    atlas_bytes = kw["atlas"].element_size() * 2
    b = bound(10 * pix, atlas_bytes * pix + 29 * n + 9 * n)
    log(f"sift orientation ({load}): {int(valid.sum())} valid of {n}, {gate['second_peaks']} second peaks, "
        f"{pix} window pixels; max|diff| {err:.3e} rad; kernel {ms:.4f} ms (device "
        f"{device_ms:.4f}), plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b})")
    return {
        "name": "sift_orientation", "route": "cuda",
        "source": "pyvisim_tpu_torch/csrc/sift_window.cu",
        "replaces": "pyvisim_tpu/ops/pallas/sift_window.py:775",
        "replaces_function": "_ori_kernel (orientation_window_pass)",
        "launches": None, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": None, "launches_per_16_image_call": len(calls),
        "shape": f"{n} keypoints, {int(valid.sum())} valid, {pix} window pixels",
    }


def descriptor_pixels(kw) -> tuple[int, int]:
    """Window pixels of the valid keypoints of one descriptor call, and how
    many of them lie in the image and in the keypoint's rotated 4x4 region
    (-1 < rbin, cbin < 4): only those add histogram terms and need their
    atlas values. The same coordinates as the kernel's and its twin's."""
    valid = kw["valid"]
    hist_width = 3.0 * kw["scl"][valid]
    radius_f = torch.round(hist_width * 1.4142135623730951 * 5.0 * 0.5)
    rad = torch.minimum(kw["radius"][valid], radius_f.to(torch.int32))
    cos_t = torch.cos(kw["theta"][valid]) / hist_width
    sin_t = torch.sin(kw["theta"][valid]) / hist_width
    row, col = kw["row"][valid], kw["col"][valid]
    octave = kw["octave"][valid].long()
    h, w = kw["octaves"][octave, 1], kw["octaves"][octave, 2]
    window = inside = 0
    for r in torch.unique(rad).tolist():
        d = torch.arange(-r, r + 1, device=rad.device, dtype=torch.float32)
        ii, jj = d.repeat_interleave(2 * r + 1), d.repeat(2 * r + 1)
        for idx in torch.nonzero(rad == r)[:, 0].split(4096):
            ct, st = cos_t[idx, None], sin_t[idx, None]
            rbin = jj * st + ii * ct + 1.5
            cbin = jj * ct - ii * st + 1.5
            rr, cc = row[idx, None] + ii, col[idx, None] + jj
            ok = ((rbin > -1.0) & (rbin < 4.0) & (cbin > -1.0) & (cbin < 4.0)
                  & (rr >= 1) & (rr < h[idx, None] - 1) & (cc >= 1) & (cc < w[idx, None] - 1))
            window += idx.numel() * (2 * r + 1) ** 2
            inside += int(ok.sum())
    return window, inside


def descriptor_gate(kernels, args, kw) -> dict:
    """Kernel C on one call's (keyword) arguments against its plain
    version: within 1 unit everywhere and exact on >= 99 % of the valid
    keypoints' entries, two calls bit-equal."""
    got = kernels.descriptor(*args, **kw)
    again = kernels.descriptor(*args, **kw)
    want = kernels.descriptor_reference(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "descriptor kernel does not repeat bit for bit")
    diff = (got - want).abs()
    err = float(diff.max())
    exact = float((diff[kw["valid"]] == 0).float().mean())
    check(err <= 1.0, f"descriptors differ by {err} units")
    check(exact >= 0.99, f"only {exact:.4f} of descriptor entries are exact")
    return {"max_abs_err": err, "exact_share": exact}


def check_descriptor(kernels, calls, load: str) -> dict:
    """Descriptors within 1 unit everywhere and exact on >= 99 % of the
    valid keypoints' entries (the plain version sums its histogram in
    another f32 order), two kernel calls bit-equal."""
    (args, kw), = calls
    gate = descriptor_gate(kernels, args, kw)
    err, exact = gate["max_abs_err"], gate["exact_share"]
    valid = kw["valid"]
    ms = time_calls(kernels.descriptor, calls)
    plain_ms = time_calls(kernels.descriptor_reference, calls, reps=1, rounds=3, warmup=1)
    n = valid.numel()
    pix, inside = descriptor_pixels(kw)
    atlas_bytes = kw["atlas"].element_size() * 2
    # ~20 operations per window pixel for its rotated bin coordinates and
    # weight; ~10 for each of the 8 histogram terms of a pixel inside the
    # region, whose magnitude and angle are read; 33 bytes in and 512 out
    # per row.
    b = bound(20 * pix + 80 * inside, atlas_bytes * inside + 33 * n + 512 * n)
    log(f"sift descriptor ({load}): {int(valid.sum())} valid of {n}, {pix} window pixels, "
        f"{inside} inside the region; max|diff| "
        f"{err:.1f}, exact {exact:.6f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b})")
    return {
        "name": "sift_descriptor", "route": "cuda",
        "source": "pyvisim_tpu_torch/csrc/sift_window.cu",
        "replaces": "pyvisim_tpu/ops/pallas/sift_window.py:569",
        "replaces_function": "_desc_kernel_gang / _desc_kernel (descriptor_window_pass)",
        "launches": None, "max_abs_err": err, "exact_share": exact, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": None, "launches_per_16_image_call": len(calls),
        "shape": f"{n} keypoints, {int(valid.sum())} valid, {pix} window pixels, "
                 f"{inside} inside the region",
    }


def sift_stage_ms(grays) -> dict:
    """Device ms of one 16-image SIFT core call by stage (CUDA events at
    its stage marks), median of 5 calls."""
    from pyvisim_tpu_torch.ops import sift as sift_ops

    cfg = sift_ops.SiftConfig()
    batch = torch.from_numpy(grays[:SIFT_BATCH]).cuda()
    runs = []
    with torch.inference_mode():
        for _ in range(6):
            events = [("start", torch.cuda.Event(enable_timing=True))]
            events[0][1].record()

            def mark(name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((name, ev))

            sift_ops._sift_core(batch, cfg, on_stage=mark)
            torch.cuda.synchronize()
            runs.append({name: events[i - 1][1].elapsed_time(ev)
                         for i, (name, ev) in enumerate(events) if i})
    stages = {name: statistics.median(r[name] for r in runs[1:]) for name in runs[0]}
    stages["total"] = sum(stages.values())
    return stages


def phase_slice3(kernels, agg, gs):
    """SIFT/RootSIFT -> VLAD-k256 and FV-k256 with the shipped RootSIFT
    vocabularies -> retrieval, through the public entry points, on 64
    structured 384x512 images."""
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder, GMMWeights, KMeansWeights, Pipeline
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import RootSIFT
    from pyvisim_tpu_torch.features._features import _to_gray_u8
    from pyvisim_tpu_torch.ops import nearest_centroid
    from pyvisim_tpu_torch.ops import sift as sift_ops

    images, grays = sift_gray_batch(SIFT_IMAGES, seed=0)
    listed = list(images)
    vlad = VLADEncoder(weights=KMeansWeights.OXFORD102_K256_ROOTSIFT)
    ext = vlad.feature_extractor
    check(isinstance(ext, RootSIFT), f"VLADEncoder's default extractor is {type(ext).__name__}")
    fv = FisherVectorEncoder(ext, weights=GMMWeights.OXFORD102_K256_ROOTSIFT_PCA)
    pipe = Pipeline([vlad, fv])
    pipe.encode(listed[:SIFT_BATCH])  # warm up
    from pyvisim_tpu_torch.ops.cuda import ingest

    wrappers = (kernels.refine, kernels.orientation, kernels.descriptor,
                agg.vlad_aggregate_batched, gs.gmm_stats_batched, ingest.gray_letterbox)
    names = ("sift_refine", "sift_orientation", "sift_descriptor", "vlad", "gmm_stats",
             "ingest_gray_letterbox")
    n_calls = -(-SIFT_IMAGES // SIFT_BATCH)

    def counts():
        return dict(zip(names, (w.launches for w in wrappers)))

    def since(before):
        return {name: n - before[name] for name, n in counts().items()}

    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vlad_vecs = vlad.encode(listed)
    vlad_s = time.perf_counter() - t0
    per_vlad = since(dict.fromkeys(names, 0))
    before = counts()
    t0 = time.perf_counter()
    pipe_vecs = pipe.encode(listed)
    pipe_s = time.perf_counter() - t0
    per_pipe = since(before)
    log(f"slice 3: VLAD encode of {SIFT_IMAGES} images {vlad_s * 1e3:.1f} ms, launches "
        f"{per_vlad}; Pipeline encode {pipe_s * 1e3:.1f} ms, launches {per_pipe}")
    sift_expected = {"sift_refine": n_calls, "sift_orientation": n_calls,
                     "sift_descriptor": n_calls, "ingest_gray_letterbox": n_calls}
    check(per_vlad == dict(sift_expected, vlad=1, gmm_stats=0), f"VLAD encode ran {per_vlad}")
    check(per_pipe == dict(sift_expected, vlad=1, gmm_stats=1), f"Pipeline encode ran {per_pipe}")

    k_vlad, d = vlad.clustering_model.centers.shape
    n_fv = 2 * fv.clustering_model.means.shape[0] * fv.clustering_model.means.shape[1] \
        + fv.clustering_model.means.shape[0]
    check(vlad_vecs.shape == (SIFT_IMAGES, k_vlad * d), f"VLAD shape {vlad_vecs.shape}")
    check(pipe_vecs.shape == (SIFT_IMAGES, k_vlad * d + n_fv), f"Pipeline shape {pipe_vecs.shape}")
    check(bool(np.isfinite(pipe_vecs).all()), "non-finite Pipeline encodings")
    check(np.array_equal(pipe_vecs[:, : k_vlad * d], vlad_vecs),
          "the Pipeline's VLAD part differs from VLADEncoder.encode")

    desc, mask = ext.extract_batch_device(listed)
    valid = mask > 0
    mean_kp = float(valid.sum(dim=1).float().mean())
    log(f"slice 3: mean valid keypoints per image {mean_kp:.1f} of {desc.shape[1]}")
    check(mean_kp > 0, "no keypoints")
    labels = nearest_centroid(desc, vlad.clustering_model.centers)
    non_empty = np.array([len(set(row[v].tolist())) for row, v in
                          zip(labels.cpu().numpy(), valid.cpu().numpy())])
    norms = np.linalg.norm(vlad_vecs.astype(np.float64), axis=1)
    worst_vlad = float(np.abs(norms - np.sqrt(non_empty)).max())
    fv_norms = np.linalg.norm(pipe_vecs[:, k_vlad * d:].astype(np.float64), axis=1)
    worst_fv = float(np.abs(fv_norms - 1.0).max())
    log(f"slice 3: VLAD norm vs sqrt(non-empty clusters) worst |diff| {worst_vlad:.2e}; "
        f"FV worst |1 - norm| {worst_fv:.2e}")
    check(worst_vlad <= 1e-3, "VLAD norms do not match the non-empty cluster counts")
    check(worst_fv <= 1e-3, "FV norms are not 1")

    self_retrieval(vlad, images)
    self_retrieval(pipe, images)
    self_retrieval(fv, images)
    launches = counts()
    check(all(launches.values()), f"slice 3 did not launch every kernel: {launches}")

    # Measurements after the path, outside its launch counts.
    t0 = time.perf_counter()
    for im in images:
        sift_ops._letterbox(_to_gray_u8(im), sift_ops.SiftConfig().process_size)
    letterbox_ms = (time.perf_counter() - t0) / SIFT_IMAGES * 1e3
    stages = sift_stage_ms(grays)
    full_stages = sift_stage_ms(full_budget_grays(SIFT_BATCH, seed=0))
    numbers = {
        "vlad_encode_img_per_s": images_per_s(vlad, images),
        "pipeline_encode_img_per_s": images_per_s(pipe, images),
        "sift_core_ms_per_16_image_call": stages,
        "sift_core_ms_per_16_image_call_full_budget": full_stages,
        "letterbox_and_gray_host_ms_per_image": letterbox_ms,
        "mean_valid_keypoints_per_image": mean_kp,
        "launches_per_vlad_encode_of_64": per_vlad,
        "launches_per_pipeline_encode_of_64": per_pipe,
    }
    log(json.dumps({"slice3": numbers, "launches": launches}))
    return launches, numbers


# Published peaks of one H100 SXM on the tensor cores (dense, 700 W).
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12

# The fused conv layers of VGG16's int8 trunk at 224^2: (layer, H = W, Cin,
# Cout, route). k7 is kernel 7, k8p kernel 8 with the pool, k8 without.
VGG16_FUSED = [
    ("conv1", 224, 64, 64, "k7"), ("conv3", 112, 128, 128, "k7"),
    ("conv4", 56, 128, 256, "k8"), ("conv5", 56, 256, 256, "k8"), ("conv6", 56, 256, 256, "k8p"),
    ("conv7", 28, 256, 512, "k8"), ("conv8", 28, 512, 512, "k8"), ("conv9", 28, 512, 512, "k8p"),
]
N_CHECK = 16  # images of each batch held against the plain version


def conv_bound(b: int, hw: int, cin: int, cout: int, route: str, dtype) -> dict:
    """The least time of the card for one fused conv call: its operations
    at the bf16 (or f32) or int8 tensor rate, or the bytes of x, the
    weights, bias and scales read once and the output written once."""
    ops = 2 * b * hw * hw * 9 * cin * cout
    size = torch.tensor([], dtype=dtype).element_size()
    out_hw = hw // 2 if route in ("k7", "k8p") else hw
    w_bytes = 9 * cin * cout * (1 if route != "k7" else size)
    n_bytes = size * b * hw * hw * cin + w_bytes + 8 * cout + 4 * b + size * b * out_hw ** 2 * cout
    rate = INT8_TENSOR_OPS if route != "k7" else (
        BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else F32_CUDA_CORE_FLOPS)
    ops_ms, bytes_ms = ops / rate * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "gop": ops / 1e9, "mb": n_bytes / 1e6}


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bfloat16 step at each value of t (8 significant bits)."""
    _, exp = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), exp - 8)


def q8_parts(conv, x, wq, sw, bias, pool: bool) -> dict:
    """Kernel 8's launches as separate calls on the same inputs, to time one
    call apart: the per-image amax (with the scale formed from it), the
    quantise pass and the conv kernel on the quantised x. (The packed
    weights are built once per weight tensor and kept.)"""
    lib = conv._library()
    dev, stream = conv.launch_target(x.device)
    sx = conv._scale_launch(lib, x, dev, stream)
    xq = conv._quantize_launch(lib, x, sx, dev, stream)
    wp = conv.pack_q8_weights(wq)
    b, h, w, _ = x.shape
    out = torch.empty((b, h // 2, w // 2, wq.shape[0]) if pool else (b, h, w, wq.shape[0]),
                      dtype=x.dtype, device=x.device)
    return {
        "amax": lambda: conv._scale_launch(lib, x, dev, stream),
        "quantise": lambda: conv._quantize_launch(lib, x, sx, dev, stream),
        "conv": lambda: conv._conv_launch(lib, xq, wp, sw, sx, bias, out, None, pool=pool,
                                          relu=True, dev=dev, stream=stream),
    }


def check_conv_call(conv, layer, hw, cin, cout, route, dtype=torch.bfloat16) -> dict:
    """One fused conv of the trunk at B=128 against its plain version on the
    first 16 images; its time, the plain version's and the cuDNN sequence's
    (conv2d with bias, relu_, max_pool2d: three calls) on the whole batch."""
    g = torch.Generator(device="cuda").manual_seed(int(layer[4:]))
    x = torch.randn(B, hw, hw, cin, device="cuda", generator=g).relu_().to(dtype)
    w = torch.randn(cout, 3, 3, cin, device="cuda", generator=g) / (9 * cin) ** 0.5
    bias = 0.1 * torch.randn(cout, device="cuda", generator=g)
    x16 = x[:N_CHECK].contiguous()
    rec = {"layer": layer, "shape": f"B={B} {hw}x{hw} {cin}->{cout}", "route": route,
           "dtype": str(dtype).replace("torch.", "")}
    if route == "k7":
        wx = w.to(dtype)
        run = lambda: conv.conv3x3_relu_maxpool(x, wx, bias)  # noqa: E731
        plain = lambda: conv.conv3x3_relu_maxpool_reference(x, wx, bias)  # noqa: E731
        got, again = run(), run()
        want = conv.conv3x3_relu_maxpool_reference(x16, wx, bias)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{layer}: kernel 7 does not repeat bit for bit")
        diff = (got[:N_CHECK].float() - want.float()).abs()
        rec["max_abs_err"] = float(diff.max())
        if dtype == torch.bfloat16:
            rec["exact_share"] = float((diff == 0).float().mean())
            ok = bool((diff <= bf16_ulp(want) + 1e-6).all())
            check(ok, f"{layer}: kernel 7 is more than one bf16 step from its plain version")
            check(rec["exact_share"] >= 0.99, f"{layer}: only {rec['exact_share']} exact")
        else:
            tol = 1e-5 * float(want.abs().max())
            check(rec["max_abs_err"] <= tol, f"{layer} f32: kernel 7 off by {rec['max_abs_err']}")
    else:
        wq, sw = conv.quantize_weight(w)
        wq = wq.contiguous()
        pool = route == "k8p"
        fn = conv.conv3x3_relu_maxpool_q8 if pool else conv.conv3x3_q8
        run = lambda: fn(x, wq, sw, bias)  # noqa: E731
        plain = lambda: conv.conv3x3_q8_reference(x, wq, sw, bias, pool=pool)  # noqa: E731
        got, again = run(), run()
        got16, acc16 = fn(x16, wq, sw, bias, return_acc=True)
        want, want_acc = conv.conv3x3_q8_reference(x16, wq, sw, bias, pool=pool, return_acc=True)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{layer}: kernel 8 does not repeat bit for bit")
        check(torch.equal(acc16, want_acc), f"{layer}: kernel 8's int32 accumulators differ")
        check(torch.equal(got16, want) and torch.equal(got[:N_CHECK], want),
              f"{layer}: kernel 8 differs from its plain version")
        rec["max_abs_err"] = float((got[:N_CHECK].float() - want.float()).abs().max())
    nchw = x.permute(0, 3, 1, 2)
    w_cl = w.to(dtype).permute(0, 3, 1, 2)
    b_x = bias.to(dtype)
    if route == "k8":
        seq = lambda: torch.relu_(F.conv2d(nchw, w_cl, b_x, padding=1))  # noqa: E731
    else:
        seq = lambda: F.max_pool2d(torch.relu_(F.conv2d(nchw, w_cl, b_x, padding=1)), 2, 2)  # noqa: E731
    flags = torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
    with flags:
        rec["ms"] = cuda_ms(run, reps=5, rounds=5)
        rec["plain_ms"] = cuda_ms(plain, reps=1, rounds=3, warmup=1)
        rec["cudnn_sequence_ms"] = cuda_ms(seq, reps=5, rounds=5)
    if route != "k7":
        parts = q8_parts(conv, x, wq, sw.to(torch.float32), bias, pool)
        rec["split_ms"] = {name: cuda_ms(fn, reps=5, rounds=5) for name, fn in parts.items()}
    rec.update(conv_bound(B, hw, cin, cout, route, dtype))
    split = rec.get("split_ms")
    log(f"conv {layer} {route} {rec['dtype']}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, "
        f"cuDNN sequence {rec['cudnn_sequence_ms']:.4f}, bound {rec['bound_ms']:.4f} "
        f"({rec['bound_by']}, {rec['gop']:.1f} GOP, {rec['mb']:.1f} MB); max|diff| "
        f"{rec['max_abs_err']:.3e}" + (f", exact {rec['exact_share']:.6f}" if "exact_share" in rec else "")
        + ("; split " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) if split else ""))
    return rec


def nan_probe(conv) -> dict:
    """A NaN in image 0 of 4 post-ReLU activations, at conv1's shape for
    kernel 7 (bf16 and f32) and conv4's for kernel 8 (pooled and not).
    Kernel 7 must be NaN exactly where its plain version is (the pooled
    outputs whose conv outputs read the NaN pixel) and elsewhere equal to
    its output on the batch without the NaN; kernel 8 NaN on all of image
    0, as its plain version (the scale is NaN), and bit for bit with it on
    images 1-3, int32 sums included. Returns the NaN outputs of each."""
    g = torch.Generator(device="cuda").manual_seed(7)
    nan_outputs = {}
    for name, hw, cin, cout in (("k7", 224, 64, 64), ("k8", 56, 128, 256)):
        x32 = torch.randn(4, hw, hw, cin, device="cuda", generator=g).relu_()
        w = torch.randn(cout, 3, 3, cin, device="cuda", generator=g) / (9 * cin) ** 0.5
        bias = 0.1 * torch.randn(cout, device="cuda", generator=g)
        wq, sw = conv.quantize_weight(w)
        wq = wq.contiguous()
        for dtype in (torch.bfloat16, torch.float32):
            clean = x32.to(dtype)
            x = clean.clone()
            x[0, 101 % hw, 57 % hw, 5] = float("nan")
            if name == "k7":
                wx = w.to(dtype)
                got = conv.conv3x3_relu_maxpool(x, wx, bias)
                before = conv.conv3x3_relu_maxpool(clean, wx, bias)
                want = conv.conv3x3_relu_maxpool_reference(x, wx, bias)
                torch.cuda.synchronize()
                nan = torch.isnan(want)
                label = f"k7 {str(dtype)[6:]}"
                check(bool(nan.any()), f"{label}: the plain version lost the NaN")
                check(torch.equal(torch.isnan(got), nan), f"{label}: NaN where the plain version "
                      f"has none or none where it has: {int(torch.isnan(got).sum())} vs {int(nan.sum())}")
                check(torch.equal(got[~nan], before[~nan]), f"{label}: the NaN moved other outputs")
                nan_outputs[label] = int(nan.sum())
                continue
            for pool in (True, False):
                fn = conv.conv3x3_relu_maxpool_q8 if pool else conv.conv3x3_q8
                got, acc = fn(x, wq, sw, bias, return_acc=True)
                want, want_acc = conv.conv3x3_q8_reference(x, wq, sw, bias, pool=pool,
                                                           return_acc=True)
                torch.cuda.synchronize()
                label = f"k8 {'pooled' if pool else 'unpooled'} {str(dtype)[6:]}"
                check(bool(torch.isnan(want[0]).all()), f"{label}: the plain version is not NaN")
                check(bool(torch.isnan(got[0]).all()), f"{label}: image 0 is not all NaN")
                check(torch.equal(got[1:], want[1:]) and torch.equal(acc[1:], want_acc[1:]),
                      f"{label}: the other images differ from the plain version")
                nan_outputs[label] = int(torch.isnan(got).sum())
    log(f"conv NaN probe: NaN outputs {nan_outputs}")
    return nan_outputs


def phase_conv_kernels(conv):
    """Phase 2e: kernels 7 and 8 at the int8 trunk's shapes (bf16, B=128),
    and kernel 7 in float32 at conv3's; then the NaN probe. Returns the two
    kernels' records, whose times and bounds sum their calls of one
    128-image encode."""
    calls = [check_conv_call(conv, *spec) for spec in VGG16_FUSED]
    f32 = check_conv_call(conv, "conv3", 112, 128, 128, "k7", dtype=torch.float32)
    nan_outputs = nan_probe(conv)
    records = []
    for name, line, routes in (("conv3x3_relu_maxpool", 157, ("k7",)),
                               ("conv3x3_relu_maxpool_q8", 301, ("k8", "k8p"))):
        mine = [c for c in calls if c["route"] in routes]
        total = {key: sum(c[key] for c in mine) for key in
                 ("ms", "plain_ms", "cudnn_sequence_ms", "bound_ms")}
        if "split_ms" in mine[0]:
            total["split_ms"] = {k: sum(c["split_ms"][k] for c in mine) for k in mine[0]["split_ms"]}
        records.append({
            "name": name, "route": "cuda", "source": "pyvisim_tpu_torch/csrc/conv.cu",
            "replaces": f"pyvisim_tpu/ops/pallas/conv.py:{line}",
            "replaces_function": "_fused_kernel" if line == 157 else "_fused_kernel_q8",
            "launches": None, "max_abs_err": max(c["max_abs_err"] for c in mine),
            **total,
            "bound_by": "operations" if all(c["bound_by"] == "operations" for c in mine) else "bytes",
            "library_ms": None,
            "cudnn_sequence": "F.conv2d with bias, relu_, max_pool2d (three calls; no max_pool2d "
                              "for the unpooled convs), bf16 channels-last",
            "times_are": f"sums over the {len(mine)} calls of one 128-image encode at 224^2",
            "per_call": mine,
        })
    records[0]["f32_conv3"] = f32
    for rec, prefix in zip(records, ("k7", "k8")):
        rec["nan_probe_outputs"] = {k: v for k, v in nan_outputs.items() if k.startswith(prefix)}
    return records


def phase_slice4(conv, agg, ext_bf16, centers, images):
    """Phase 7, slice 4: the int8 trunk (bf16) -> VLAD-k256 -> retrieval on
    slice 1's 128 images and centers, through the public entry points."""
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.ops import KMeansCodebook, nearest_centroid, vlad_encode_batch

    ext = DeepConvFeature("vgg16", image_size=224, dtype=torch.bfloat16, int8=True)
    enc = VLADEncoder(ext, kmeans_model=KMeansCodebook(centers))
    listed = list(images)
    enc.encode(listed[:8])  # warm up
    wrappers = {"k7": conv.conv3x3_relu_maxpool, "k8_pooled": conv.conv3x3_relu_maxpool_q8,
                "k8_unpooled": conv.conv3x3_q8, "vlad": agg.vlad_aggregate_batched}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = enc.encode(listed)
    encode_s = time.perf_counter() - t0
    per_encode = {name: w.launches for name, w in wrappers.items()}
    log(f"slice 4: int8 encode of {B} images {encode_s * 1e3:.1f} ms, launches {per_encode}")
    check(out.shape == (B, K * D), f"int8 encoding shape {out.shape}")
    check(bool(np.isfinite(out).all()), "non-finite int8 encodings")
    check(per_encode == {"k7": 2, "k8_pooled": 2, "k8_unpooled": 4, "vlad": 1},
          f"one int8 encode ran {per_encode}")
    self_retrieval(enc, images)
    desc, _ = ext.extract_batch(images)
    labels = nearest_centroid(desc.to(torch.float32), torch.from_numpy(centers).cuda())
    non_empty = np.array([len(set(row)) for row in labels.cpu().numpy().tolist()])
    worst = float(np.abs(np.linalg.norm(out.astype(np.float64), axis=1) - np.sqrt(non_empty)).max())
    log(f"slice 4: norm vs sqrt(non-empty clusters) worst |diff| {worst:.2e}")
    check(worst <= 1e-3, "int8 encoding norms do not match the non-empty cluster counts")
    launches = {name: w.launches for name, w in wrappers.items()}
    check(all(launches.values()), f"slice 4 did not launch every kernel: {launches}")

    # The comparison with the float32 trunk and the measurements, outside
    # the launch counts. JAX's gate (tests/test_features_deep.py:233): VLAD
    # on 64 N(0, 1) centers, int8 against float32, cosine > 0.999 per image;
    # and the descriptors themselves (196 x 512 per image), cosine > 0.999.
    # Slice 1's centers lie among the descriptors, so near ties move labels
    # there: their cosines are printed for the int8 and the bf16 trunk alike.
    f32_ext = DeepConvFeature("vgg16", image_size=224, dtype=torch.float32)
    descs = {name: e.extract_batch(images)[0].to(torch.float32)
             for name, e in (("float32", f32_ext), ("int8", ext), ("bf16", ext_bf16))}
    gate_centers = torch.from_numpy(
        np.random.default_rng(0).normal(size=(64, D)).astype(np.float32)).cuda()
    slice_centers = torch.from_numpy(centers).cuda()

    def rows(name, cs=None):
        if cs is None:
            return descs[name][..., :-2].reshape(B, -1).cpu().numpy()
        return vlad_encode_batch(descs[name], None, cs).cpu().numpy()

    cos = {
        "jax_gate_vlad64": cosine_rows(rows("int8", gate_centers), rows("float32", gate_centers)),
        "descriptors": cosine_rows(rows("int8"), rows("float32")),
        "slice1_centers": cosine_rows(rows("int8", slice_centers), rows("float32", slice_centers)),
        "bf16_slice1_centers": cosine_rows(rows("bf16", slice_centers),
                                           rows("float32", slice_centers)),
        "bf16_descriptors": cosine_rows(rows("bf16"), rows("float32")),
    }
    log("slice 4: cosine against the float32 trunk per image, min/mean: " + ", ".join(
        f"{name} {c.min():.6f}/{c.mean():.6f}" for name, c in cos.items()))
    for name in ("jax_gate_vlad64", "descriptors"):
        check(bool((cos[name] > 0.999).all()),
              f"int8 and float32 trunks disagree ({name}): min cosine {cos[name].min()}")
    dev_images = torch.from_numpy(images).cuda()
    centers_dev = torch.from_numpy(centers).cuda()
    ones = torch.ones((B, N), device="cuda")
    with torch.inference_mode():
        graph = lambda: vlad_encode_batch(  # noqa: E731
            ext._forward(dev_images).to(torch.float32), ones, centers_dev)
        numbers = {
            "encode_e2e_img_per_s": images_per_s(enc, images),
            "device_graph_ms": cuda_ms(graph, reps=3, rounds=5),
            "int8_trunk_ms": cuda_ms(lambda: ext._forward(dev_images), reps=3, rounds=5),
            "bf16_trunk_ms": cuda_ms(lambda: ext_bf16._forward(dev_images), reps=3, rounds=5),
            "cosine_vs_f32_min": {name: float(c.min()) for name, c in cos.items()},
            "launches_per_encode_of_128": per_encode,
        }
        numbers["device_graph_img_per_s"] = B / numbers["device_graph_ms"] * 1e3
        log(json.dumps({"slice4": numbers, "launches": launches}))
        log(json.dumps({"profile_int8": profile_device_graph(graph, top=14)}))
        log(json.dumps({"profile_bf16_trunk": profile_device_graph(
            lambda: ext_bf16._forward(dev_images), top=10)}))
    return launches, numbers, enc


# Phase 8: the serving path at full width. The gallery is the JAX rounds'
# BASELINE size (6,149 rows, docs/PERF.md:647-648) expanded from real
# int8-trunk encodings of a synthetic corpus: 16 classes, views 0-7 of each
# in the gallery and views 8-12 as the 80 queries.
SERVE_CLASSES, SERVE_VIEWS, SERVE_QUERY_VIEWS = 16, 8, 5
SERVE_ROWS = 6149
SERVE_ADD = 2048  # 6,150 + 2,048 rows cross 8,192: the capacity doubles
SERVE_MODES = {
    "f32": {},
    "int8": {"quantize": "int8"},
    "f32_screen": {"screen_dim": 256, "rerank": 128},
    "int8_screen": {"quantize": "int8", "screen_dim": 256, "rerank": 128},
}
RERANKS = (16, 32, 64, 128, 256)
# recall@5 of int8 + screen-256 against the int8 scan in the JAX rounds, on
# their own 6,149-row gallery (docs/PERF.md:772-774): for comparison only.
JAX_RECALL = {16: 0.64, 32: 0.81, 64: 0.92, 128: 0.99, 256: 1.00}
SWEEP_Q = (1, 2, 4, 8, 16, 32, 64)


def query_chunks(index, vecs: np.ndarray, k: int, chunk: int = 16):
    """``query_vectors`` in chunks of queries, so a screened query's gather
    of chunk x rerank full rows stays a few GB."""
    parts = [index.query_vectors(vecs[i : i + chunk], k) for i in range(0, len(vecs), chunk)]
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def query_bytes(index, n_queries: int, k: int = 5) -> int:
    """Bytes one query call must read: each input once (the scanned rows,
    their scales, the JL projection and screen, the gathered rows)."""
    n, d = len(index), index.vectors.shape[1]
    row_bytes = index.vectors.element_size() * d + (4 if index.quantize else 0)
    r = index._route(n_queries, k)
    if r is None:
        return n * row_bytes + n_queries * d * 4
    return (index._proj.numel() * 4 + n * index.screen_dim * 4
            + n_queries * r * row_bytes + n_queries * d * 4)


def serving_latency(index, vecs: np.ndarray, k: int = 5, reps: int = 20) -> dict:
    """Device ms of the search (CUDA events, queries already on the card)
    and host ms of ``query_vectors`` with numpy in and out, beside the byte
    bound at 3.35 TB/s."""
    qd = torch.from_numpy(vecs).cuda()
    device_ms = cuda_ms(lambda: index._query(qd, k), reps=10, rounds=5)
    index.query_vectors(vecs, k)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        index.query_vectors(vecs, k)
        times.append((time.perf_counter() - t0) * 1e3)
    n_bytes = query_bytes(index, len(vecs), k)
    return {"route": "exact" if index._route(len(vecs), k) is None else "screened",
            "device_ms": device_ms, "host_ms": statistics.median(times),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_mb": n_bytes / 1e6}


def vlad_on_path_gate(agg, out, desc, mask, centers) -> dict:
    """Kernel 1's output from the main path against its plain version on
    the same arguments: every weighted row's label (from a second call that
    returns them, not counted) equal to the plain argmin's or, on these
    real descriptors, within 1e-5 (|x|^2 + |c|^2) of its float64 distance
    (a near tie); the sums within phase 2a's 1e-4 * max|ref| + 1e-5 of the
    plain aggregation with the kernel's labels (the plain version itself
    where no label differs)."""
    n0 = agg.vlad_aggregate_batched.launches
    again, labels = agg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    agg.vlad_aggregate_batched.launches = n0
    ref_labels = agg.vlad_aggregate_reference(desc, mask, centers, return_labels=True)[1]
    check(torch.equal(out, again), "kernel 1 does not repeat bit for bit on the main path")
    weighted = mask != 0
    differ = (labels != ref_labels) & weighted
    x = desc[differ].double()
    c_got = centers[labels[differ].long()].double()
    c_ref = centers[ref_labels[differ].long()].double()
    gap = ((x - c_got) ** 2).sum(1) - ((x - c_ref) ** 2).sum(1)
    slack = 1e-5 * ((x**2).sum(1) + (c_got**2).sum(1))
    check(bool((gap <= slack).all()), f"kernel 1: {int((gap > slack).sum())} weighted rows' "
          "labels are not the nearest center on the main path")
    rest = labels[~weighted]
    check(bool(((rest == -1) | (rest == ref_labels[~weighted])).all()),
          "kernel 1: a weightless row's label is neither -1 nor the plain argmin")
    one_hot = F.one_hot(labels.clamp(min=0).long(), centers.shape[0]).to(desc.dtype)
    one_hot = one_hot * mask[..., None]
    same_labels = torch.bmm(one_hot.transpose(1, 2), desc) - one_hot.sum(1)[..., None] * centers
    err = max_err(out, same_labels, f"kernel 1 on the main path, B={desc.shape[0]}")
    return {"shape": list(desc.shape), "max_abs_err": err, "near_tie_rows": int(differ.sum())}


def conv_on_path_gate(conv, name, out, acc, x, w, args, kwargs) -> dict:
    """Kernel 7 or 8's output from the main path against its plain version
    on the same arguments, at phase 2e's gates over the whole batch: kernel
    7 in bf16 within one bf16 step and 99 % exact (float32 within 1e-5 *
    max|ref|), kernel 8 bit for bit, its int32 sums ``acc`` too."""
    rec = {"kernel": name, "shape": list(x.shape), "cout": int(w.shape[0])}
    if name == "conv3x3_relu_maxpool":
        want = conv.conv3x3_relu_maxpool_reference(x, w, *args)
        diff = (out.float() - want.float()).abs()
        rec["max_abs_err"] = float(diff.max())
        if x.dtype == torch.bfloat16:
            rec["exact_share"] = float((diff == 0).float().mean())
            check(bool((diff <= bf16_ulp(want) + 1e-6).all()) and rec["exact_share"] >= 0.99,
                  f"kernel 7 on the main path: {rec}")
        else:
            check(rec["max_abs_err"] <= 1e-5 * float(want.abs().max()),
                  f"kernel 7 float32 on the main path: {rec}")
        return rec
    want, want_acc = conv.conv3x3_q8_reference(x, w, *args, pool=name.endswith("maxpool_q8"),
                                               return_acc=True, **kwargs)
    rec["max_abs_err"] = float((out.float() - want.float()).abs().max())
    check(torch.equal(acc, want_acc), f"kernel 8's int32 accumulators differ on the main path: {rec}")
    check(torch.equal(out, want), f"kernel 8 differs from its plain version on the main path: {rec}")
    return rec


def on_path_kernel_checks(conv, agg, run, what: str):
    """``run()``, an encode of the main path, with each call of kernels 1,
    7 and 8 held against its plain version on the arguments the path gave
    it (``vlad_on_path_gate``, ``conv_on_path_gate``). Returns what
    ``run()`` returns and the records."""
    from pyvisim_tpu_torch.ops import vlad as vlad_ops

    names = ("conv3x3_relu_maxpool", "conv3x3_relu_maxpool_q8", "conv3x3_q8")
    saved = {name: getattr(conv, name) for name in names}
    saved_vlad = vlad_ops.vlad_aggregate_batched
    records = []

    def conv_checked(name):
        def wrapped(x, w, *args, **kwargs):
            out = saved[name](x, w, *args, **kwargs)
            acc = None
            if name != "conv3x3_relu_maxpool":
                # Kernel 8's int32 sums, from a call not counted.
                n0 = wrapped.launches
                _, acc = saved[name](x, w, *args, return_acc=True, **kwargs)
                wrapped.launches = n0
            records.append(conv_on_path_gate(conv, name, out, acc, x, w, args, kwargs))
            return out
        # A wrapper counts its launches on the module attribute of its name.
        wrapped.launches = saved[name].launches
        return wrapped

    def vlad_checked(desc, mask, centers):
        out = saved_vlad(desc, mask, centers)
        records.append({"kernel": "vlad_aggregate",
                        **vlad_on_path_gate(agg, out, desc, mask, centers)})
        return out

    try:
        for name in names:
            setattr(conv, name, conv_checked(name))
        vlad_ops.vlad_aggregate_batched = vlad_checked
        result = run()
    finally:
        for name in names:
            saved[name].launches = getattr(conv, name).launches
            setattr(conv, name, saved[name])
        vlad_ops.vlad_aggregate_batched = saved_vlad
    kinds = {r["kernel"] for r in records}
    check(kinds == {"vlad_aggregate", *names},
          f"{what}: the encode did not reach kernels 1, 7 and 8 ({sorted(kinds)})")
    log(f"serving: kernels on the main path at {what} held against their plain versions: "
        + json.dumps(records))
    return result, records


def serving_corpus(conv, agg, enc, wrappers):
    """The corpus encoded on the card: the gallery views through
    ``prefetch_to_device`` in 64-image batches (bit-equal to direct encodes
    of the same batches), the query views in one encode. The first direct
    batch and the queries' encode hold kernels 1, 7 and 8 against their
    plain versions at their batch sizes (``on_path_kernel_checks``)."""
    from pyvisim_tpu_torch.datasets import make_retrieval_corpus
    from pyvisim_tpu_torch.io import prefetch_to_device

    n_views = SERVE_VIEWS + SERVE_QUERY_VIEWS
    images, labels = make_retrieval_corpus(SERVE_CLASSES, n_views, h=224, w=224)
    images = np.stack(images)
    view = np.arange(len(images)) % n_views
    gal_imgs, gal_labels = images[view < SERVE_VIEWS], labels[view < SERVE_VIEWS]
    q_imgs = images[view >= SERVE_VIEWS]
    batches = [gal_imgs[i : i + 64] for i in range(0, len(gal_imgs), 64)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    real = np.concatenate([enc.encode(b) for b in prefetch_to_device(iter(batches))])
    gallery_s = time.perf_counter() - t0
    prefetch_vlad = wrappers["vlad"].launches
    first, checked = on_path_kernel_checks(conv, agg, lambda: enc.encode(batches[0]),
                                           f"B={len(batches[0])}, a gallery batch")
    direct = np.concatenate([first] + [enc.encode(b) for b in batches[1:]])
    check(np.array_equal(real, direct),
          "encodings through prefetch_to_device differ from direct encodes")
    queries, checked_q = on_path_kernel_checks(conv, agg, lambda: enc.encode(q_imgs),
                                               f"B={len(q_imgs)}, the queries")
    check(real.shape == (len(gal_imgs), K * D) and queries.shape == (len(q_imgs), K * D),
          f"corpus encodings {real.shape}, {queries.shape}")
    check(bool(np.isfinite(real).all() and np.isfinite(queries).all()), "non-finite encodings")
    log(f"serving: {len(gal_imgs)} gallery images encoded through prefetch_to_device in "
        f"{gallery_s * 1e3:.1f} ms ({prefetch_vlad} VLAD launches), bit-equal to direct encodes")
    return gal_imgs, gal_labels, q_imgs, real, queries, gallery_s, checked + checked_q


def float64_top(gallery: np.ndarray, queries: np.ndarray):
    """Cosine top list of every query in float64 on the card."""
    g = torch.from_numpy(gallery).cuda().double()
    g /= g.norm(dim=1, keepdim=True)
    q = torch.from_numpy(queries).cuda().double()
    q /= q.norm(dim=1, keepdim=True)
    values, index = torch.sort(q @ g.T, dim=1, descending=True, stable=True)
    return values[:, :6].cpu().numpy(), index[:, :6].cpu().numpy()


def serving_gates(name, index, gallery, labels, queries, ref, exact_top):
    """Phase 8's gates on one index; raise on failure."""
    from pyvisim_tpu_torch.index import _quantize_rows, int8_accumulators, int8_accumulators_plain

    n = len(index)
    gates = {}
    if name == "f32":
        ref_vals, ref_idx = ref
        s, i = index.query_vectors(queries, 5)
        # The top-5 as a set, where the 5th-6th margin is clear of float32's
        # rounding; the order within it may differ at closer margins.
        clear = ref_vals[:, 4] - ref_vals[:, 5] > 1e-6
        check(np.array_equal(np.sort(i[clear]), np.sort(ref_idx[clear, :5])),
              "exact f32 top-5 differs from the float64 brute force")
        err = float(np.abs(s - ref_vals[:, :5]).max())
        check(err <= 1e-5, f"exact f32 scores off the float64 ones by {err}")
        gates["f64_queries_clear_of_ties"] = int(clear.sum())
        gates["f64_max_score_err"] = err
    if name == "int8":
        codes = index._scanned_codes()
        check(codes.shape[0] % 8 == 0 and codes.shape[1] % 8 == 0,
              "the int8 scan does not meet torch._int_mm's shape rules")
        qd = torch.from_numpy(queries[:8]).cuda()
        qn = qd / torch.clamp(torch.linalg.vector_norm(qd, dim=1, keepdim=True), min=1e-12)
        for q in (1, 8):
            q8, _ = _quantize_rows(qn[:q])
            check(torch.equal(int8_accumulators(q8, codes), int8_accumulators_plain(q8, codes)),
                  f"int8 accumulators at Q={q} differ from the exact float64 sums")
        gates["int32_accumulators_bit_equal_q"] = [1, 8]
    if index.screen_dim is not None:
        saved = index.rerank, index.auto_exact
        index.rerank, index.auto_exact = n, False
        s, i = query_chunks(index, queries[:2], 5, chunk=1)
        index.rerank, index.auto_exact = saved
        if index.quantize is None:
            want_s, want_i = exact_top["f32"]
            want_s, want_i = want_s[:2], want_i[:2]
        else:
            # Its exact counterpart: the float32 cosine against the
            # dequantised rows, which is what the screened route rescores.
            qd = torch.from_numpy(queries[:2]).cuda()
            qn = qd / torch.clamp(torch.linalg.vector_norm(qd, dim=1, keepdim=True), min=1e-12)
            deq = index.vectors[:n].to(torch.float32) * index.scales[:n]
            want_s, want_i = (t.cpu().numpy() for t in torch.sort(
                qn @ deq.T, dim=1, descending=True, stable=True))
            want_s, want_i = want_s[:, :5], want_i[:, :5]
            del deq
        check(np.array_equal(i, want_i), f"{name}: rerank >= n differs from the exact scan")
        err = float(np.abs(s - want_s).max())
        check(err <= 1e-6, f"{name}: rerank >= n scores off the exact scan's by {err}")
        gates["full_rerank_equals_exact_max_err"] = err
    # Self-retrieval of the real rows, through the route under test.
    saved = index.auto_exact
    index.auto_exact = False
    s, top = query_chunks(index, gallery[:128], 2)
    index.auto_exact = saved
    missed = np.flatnonzero(top[:, 0] != np.arange(128))
    gates["self_retrieval_hits_of_128"] = 128 - len(missed)
    if index.quantize is None or index.screen_dim is None:
        check(len(missed) == 0, f"{name}: self-retrieval missed rows {missed.tolist()}")
        return gates
    # The int8 screen rescores the float32 query against dequantised rows,
    # whose norms are 1 only up to the quantisation error (~1e-4 here), so
    # a near-duplicate within that margin can outscore the row itself, in
    # the JAX package too (tests/test_torch_index.py). The gate: the top-1
    # scores as high as the best dequantised row of the whole gallery.
    qd = torch.from_numpy(gallery[:128]).cuda()
    qn = qd / torch.clamp(torch.linalg.vector_norm(qd, dim=1, keepdim=True), min=1e-12)
    deq = index.vectors[:n].to(torch.float32) * index.scales[:n]
    best = (qn @ deq.T).max(dim=1).values.cpu().numpy()
    del deq
    err = float(np.abs(s[:, 0] - best).max())
    gates["top1_vs_best_dequantised_max_err"] = err
    log(f"{name}: self-retrieval {128 - len(missed)}/128; the other rows' top-1 is a "
        f"near-duplicate; top-1 against the best dequantised row max|diff| {err:.2e}")
    check(err <= 1e-6, f"{name}: the top-1 scores {err} below the best dequantised row")
    return gates


def serving_ties_and_add(name, index, gallery, labels, more, more_labels, kw):
    """A duplicated row ranks in lax.top_k's order; then (f32 and the
    production int8 + screen) add() across the capacity doubling answers as
    an index built at once."""
    from pyvisim_tpu_torch.index import RetrievalIndex

    n = len(index)
    index.add(gallery[5:6], ["dup/5"], labels[5:6])
    saved = index.auto_exact
    index.auto_exact = False
    s, i = index.query_vectors(gallery[5:6], 3)
    index.auto_exact = saved
    # A float32 product may round the two copies apart by their positions
    # in it. Where they score alike, lax.top_k's order puts first the lower
    # index (a full scan) or the better screen rank (a screened query); the
    # int8 scan's int32 sums tie exactly.
    tied = bool(s[0, 0] == s[0, 1])
    first = 5
    if index.screen_dim is not None:
        # The screen scores as the screened route computes them.
        q = torch.from_numpy(gallery[5:6]).cuda()
        qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True), min=1e-12)
        sims = ((qn @ index._proj) @ index._screen[: n + 1].T)[0]
        first = 5 if sims[5] >= sims[n] else n
    check(sorted(i[0, :2]) == [5, n] and (not tied or i[0, 0] == first)
          and (tied or name != "int8"),
          f"{name}: a duplicated row ranks {i[0].tolist()} with scores {s[0].tolist()}")
    if name not in ("f32", "int8_screen"):
        return {"duplicate_scores_tie": tied}
    cap0 = index.vectors.shape[0]
    t0 = time.perf_counter()
    index.add(more, [f"more/{j}" for j in range(len(more))], more_labels)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    check(index.vectors.shape[0] == 2 * cap0 and len(index) == n + 1 + len(more),
          f"{name}: add() left capacity {index.vectors.shape[0]} and {len(index)} rows")
    whole_vecs = np.concatenate([gallery, gallery[5:6], more])
    probe = np.concatenate([gallery[:4], more[:4]])
    got = query_chunks(index, probe, 5)
    whole = RetrievalIndex(whole_vecs, [str(j) for j in range(len(whole_vecs))], **kw)
    want = query_chunks(whole, probe, 5)
    check(np.array_equal(got[1], want[1]), f"{name}: add() top-5 differs from a whole build")
    err = float(np.abs(got[0] - want[0]).max())
    check(err <= 1e-6, f"{name}: add() scores off a whole build's by {err}")
    return {"duplicate_scores_tie": tied, "add_s": add_s, "capacity": [cap0, 2 * cap0],
            "max_score_err": err}


def serving_save_load(index) -> dict:
    import tempfile

    from pyvisim_tpu_torch.index import RetrievalIndex

    n = len(index)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/int8.npz"
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = RetrievalIndex.load(path)
        load_s = time.perf_counter() - t0
    check(back.quantize == "int8" and len(back) == n, "the int8 index did not load back")
    check(torch.equal(back.vectors[:n], index.vectors[:n])
          and torch.equal(back.scales[:n], index.scales[:n]),
          "the int8 index's codes or scales changed through save and load")
    del back
    return {"save_s": save_s, "load_s": load_s}


def serving_from_files(enc, gal_imgs, real) -> dict:
    """``RetrievalIndex.build``, ``generate_encoding_map`` and
    ``from_encoding_map`` on 16 gallery images written as PNG, against the
    index of their encodings; ``from_encoding_map`` on the real rows."""
    import tempfile

    import cv2

    from pyvisim_tpu_torch.index import RetrievalIndex
    from pyvisim_tpu_torch.io import native_loader_available

    probe = real[:8] * 1.01
    by_map = RetrievalIndex.from_encoding_map({f"img/{i}": v for i, v in enumerate(real)})
    direct = RetrievalIndex(real, [f"img/{i}" for i in range(len(real))])
    a, b = by_map.query_vectors(probe, 5), direct.query_vectors(probe, 5)
    check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
          "from_encoding_map answers differently from the index of the same array")
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, img in enumerate(gal_imgs[:16]):
            files.append(f"{tmp}/g{i:02d}.png")
            cv2.imwrite(files[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        built = RetrievalIndex.build(enc, files, quantize="int8")
        emap = enc.generate_encoding_map(files, batch_size=16)
    want = RetrievalIndex(enc.encode(gal_imgs[:16]), files, quantize="int8")
    by_file_map = RetrievalIndex.from_encoding_map(emap, quantize="int8")
    for idx in (built, by_file_map):
        got = idx.query_vectors(real[:16], 3)
        ref = want.query_vectors(real[:16], 3)
        check(np.array_equal(got[1], ref[1]) and np.array_equal(got[0], ref[0]),
              "an index built from image files answers differently")
    check(list(emap) == files, "generate_encoding_map lost the file order")
    return {"native_jpeg_loader": native_loader_available(), "png_files": len(files)}


def phase_serving(conv, agg, enc):
    """Phase 8: the serving path at full width through the public entry
    points (gallery encode, four RetrievalIndex modes, queries)."""
    from pyvisim_tpu_torch.datasets import expand_encodings
    from pyvisim_tpu_torch.index import RetrievalIndex, _top_k

    t_phase = time.perf_counter()
    wrappers = {"k7": conv.conv3x3_relu_maxpool, "k8_pooled": conv.conv3x3_relu_maxpool_q8,
                "k8_unpooled": conv.conv3x3_q8, "vlad": agg.vlad_aggregate_batched}
    for w in wrappers.values():
        w.launches = 0
    gal_imgs, gal_labels, q_imgs, real, queries, gallery_s, checked = serving_corpus(
        conv, agg, enc, wrappers)
    encodes = 2 * len(gal_imgs) // 64 + 1

    t0 = time.perf_counter()
    gallery, labels = expand_encodings(real, gal_labels, SERVE_ROWS, seed=0)
    more, more_labels = (a[len(real):] for a in
                         expand_encodings(real, gal_labels, len(real) + SERVE_ADD, seed=1))
    expand_s = time.perf_counter() - t0
    paths = [f"gallery/{i:05d}" for i in range(SERVE_ROWS)]
    ref = float64_top(gallery, queries)
    log(f"serving: gallery {gallery.shape} expanded in {expand_s:.1f} s; "
        f"5th-6th float64 margin median {np.median(ref[0][:, 4] - ref[0][:, 5]):.2e}")

    numbers = {"gallery_rows": SERVE_ROWS, "dim": int(gallery.shape[1]),
               "gallery_encode_ms_128_prefetched": gallery_s * 1e3, "expand_s": expand_s,
               "modes": {}}
    exact_top, exact_ms = {}, {}
    for name, kw in SERVE_MODES.items():
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = RetrievalIndex(gallery, paths, labels, **kw)
        torch.cuda.synchronize()
        rec = {"build_s": time.perf_counter() - t0,
               "gallery_gb": (index.vectors[:SERVE_ROWS].numel()
                              * index.vectors.element_size()) / 1e9,
               "capacity": index.vectors.shape[0]}
        if index.screen_dim is None:
            exact_top[name] = index.query_vectors(queries, 5)
        rec["gates"] = serving_gates(name, index, gallery, labels, queries, ref, exact_top)
        for q in (1, 8):
            routes = [("", kw.get("auto_exact", True))]
            if index.screen_dim is not None:
                routes = [("", True), ("_pinned", False)]
            for suffix, auto in routes:
                index.auto_exact = auto
                rec[f"q{q}{suffix}"] = serving_latency(index, queries[:q])
            index.auto_exact = True
        # Device ms by Q: the exact scans' and the screened route's, for the
        # crossover against the JAX package's Q * rerank * 15 >= n rule.
        index.auto_exact = False
        sweep = {}
        for q in SWEEP_Q:
            qd = torch.from_numpy(queries[:q]).cuda()
            sweep[q] = cuda_ms(lambda: index._query(qd, 5), reps=5, rounds=3)
        index.auto_exact = True
        rec["device_ms_by_q"] = sweep
        if index.screen_dim is None:
            exact_ms[name] = sweep
        else:
            exact = exact_ms["int8" if index.quantize else "f32"]
            slower = [q for q in SWEEP_Q if sweep[q] >= exact[q]]
            rec["screen_stops_winning_at_q"] = slower[0] if slower else None
            rec["jax_rule_exact_from_q"] = -(-SERVE_ROWS // (128 * 15))
        if name == "int8":
            rec["save_load"] = serving_save_load(index)
        if name == "int8_screen":
            recall = {}
            index.auto_exact = False
            for r in RERANKS:
                index.rerank = r
                _, got = query_chunks(index, queries, 5)
                recall[r] = float(np.mean([len(set(a) & set(b)) / 5
                                           for a, b in zip(got, exact_top["int8"][1])]))
            index.rerank, index.auto_exact = 128, True
            rec["recall_at_5_vs_int8_exact"] = recall
            rec["jax_recall_at_5"] = JAX_RECALL
            log("serving: recall@5 of int8 + screen-256 against the int8 scan by rerank: "
                + ", ".join(f"{r}: {recall[r]:.4f} (JAX {JAX_RECALL[r]:.2f})" for r in RERANKS))
            # The first call, a warm-up, holds the kernels at B=1.
            _, checked_b1 = on_path_kernel_checks(
                conv, agg, lambda: index.query(enc, [q_imgs[0]], k=5), "B=1, a query image")
            checked += checked_b1
            times = []
            for j in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = index.query(enc, [q_imgs[j]], k=5)
                times.append((time.perf_counter() - t0) * 1e3)
                check(len(res) == 1 and len(res[0]) == 5, f"query(encoder, [image]) gave {res}")
            encodes += 6
            rec["query_encoder_image_e2e_ms"] = statistics.median(times)
        rec["ties_and_add"] = serving_ties_and_add(name, index, gallery, labels, more,
                                                   more_labels, kw)
        del index
        log(json.dumps({f"serving_{name}": rec}))
        numbers["modes"][name] = rec
    torch.cuda.empty_cache()
    sims = torch.randn((8, SERVE_ROWS), device="cuda")
    numbers["top_k_ms"] = {
        "stable_sort_q1": cuda_ms(lambda: _top_k(sims[:1], 5)),
        "stable_sort_q8": cuda_ms(lambda: _top_k(sims, 5)),
        "torch_topk_q1": cuda_ms(lambda: torch.topk(sims[:1], 5)),
        "torch_topk_q8": cuda_ms(lambda: torch.topk(sims, 5)),
        "stable_sort_q8_r128": cuda_ms(lambda: _top_k(sims[:, :128], 5)),
    }
    numbers["files"] = serving_from_files(enc, gal_imgs, real)
    encodes += 3  # build, generate_encoding_map and the direct encode of 16 images
    launches = {name: w.launches for name, w in wrappers.items()}
    check(launches["vlad"] == encodes,
          f"phase 8 ran {launches['vlad']} VLAD launches for {encodes} encodes")
    check(all(launches.values()), f"phase 8 did not launch every kernel: {launches}")
    numbers["launches"] = launches
    numbers["on_path_max_abs_err"] = {
        name: max(r["max_abs_err"] for r in checked if r["kernel"] in names)
        for name, names in (("vlad_aggregate", ("vlad_aggregate",)),
                            ("conv3x3_relu_maxpool", ("conv3x3_relu_maxpool",)),
                            ("conv3x3_relu_maxpool_q8", ("conv3x3_relu_maxpool_q8", "conv3x3_q8")))}
    numbers["on_path_batches"] = sorted({r["shape"][0] for r in checked})
    numbers["on_path_near_tie_rows"] = sum(r.get("near_tie_rows", 0) for r in checked)
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"serving": {k: v for k, v in numbers.items() if k != "modes"}}))
    return launches, numbers


# Phase 9: the Siamese trainer and encoder at full width (VGG16, 224^2).
TRAIN_CLASSES, TRAIN_VIEWS, HELD_OUT_VIEWS = 16, 8, 5
TRAIN_B, TRAIN_STEPS, TRAIN_SIZE = 32, 30, 224


def training_corpus():
    """16 synthetic classes x 13 views at 240 x 300: views 0-7 (128 images,
    class-major) are the training set and the gallery, views 8-12 (80)
    the held-out queries."""
    from pyvisim_tpu_torch.datasets import make_retrieval_corpus

    per = TRAIN_VIEWS + HELD_OUT_VIEWS
    imgs, labels = make_retrieval_corpus(TRAIN_CLASSES, per)
    train = [i for i in range(len(imgs)) if i % per < TRAIN_VIEWS]
    held = [i for i in range(len(imgs)) if i % per >= TRAIN_VIEWS]
    return [imgs[i] for i in train], labels[train], [imgs[i] for i in held], labels[held]


def same_state(a, b) -> bool:
    """Parameters and optimizer state of two TrainStates bit for bit."""
    if a.step != b.step or any(not torch.equal(a.params[k], b.params[k]) for k in a.params):
        return False
    sa, sb = a.opt_state.state_dict()["state"], b.opt_state.state_dict()["state"]
    return sa.keys() == sb.keys() and all(
        torch.equal(sa[i][key], sb[i][key]) for i in sa for key in sa[i])


def step_ms(step, state, draw, n: int):
    """``n`` steps on fresh batches; the losses and each step's CUDA-event ms."""
    losses, times = [], []
    for _ in range(n):
        x, y = draw()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, x, y)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        times.append(start.elapsed_time(end))
    return state, losses, times


def narrow_card_vs_cpu(S, x, y) -> dict:
    """vgg11 with 2 convs at 64^2, B=8: the nt_xent loss and its gradients on
    the card (float32, TF32 off) against the CPU. Gates: the loss to rel
    1e-5 and each gradient to 1e-3 * its max |CPU| (f32 sums in other
    orders)."""
    model = S.SiameseEmbedder("vgg11", embed_dim=128, trunk_convs=2)
    out = {}
    for dev in ("cpu", "cuda"):
        state = S.create_train_state(model, S.adamw(3e-4), seed=2, device=dev)
        with S.full_f32():
            loss = S.make_loss_fn(model, "nt_xent")(state.params, x.to(dev), y.to(dev))
            loss.backward()
        out[dev] = loss.item(), {k: p.grad.cpu() for k, p in state.params.items()}
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    loss_rel = abs(lg - lc) / abs(lc)
    grad_rel = {k: float((gg[k] - gc[k]).abs().max() / gc[k].abs().max()) for k in gc}
    log(f"siamese narrow card vs cpu: loss {lg:.7f} vs {lc:.7f} (rel {loss_rel:.2e}), "
        f"gradient max|diff| / max|cpu| {max(grad_rel.values()):.2e}")
    check(loss_rel <= 1e-5, f"narrow Siamese loss on the card off by rel {loss_rel}")
    check(all(v <= 1e-3 for v in grad_rel.values()),
          f"narrow Siamese gradients on the card disagree with the CPU: {grad_rel}")
    return {"loss_rel": loss_rel, "grad_rel_max": max(grad_rel.values())}


def retrieval_quality(enc, gallery, train_labels, held_imgs, held_labels) -> dict:
    from pyvisim_tpu_torch import eval as pv_eval

    paths = [f"train_{i:03d}.png" for i in range(len(gallery))]
    enc_map = dict(zip(paths, gallery))
    path_labels = dict(zip(paths, train_labels.tolist()))
    return {"top1_accuracy": pv_eval.top_k_accuracy(held_imgs, held_labels, enc_map,
                                                    path_labels, enc, k=1),
            "map": pv_eval.top_k_map(held_imgs, held_labels, enc_map, path_labels, enc)}


def phase_siamese():
    """Phase 9: train SiameseEmbedder("vgg16", 128) with adamw(3e-4) and
    nt_xent for 30 steps of 32 views at 224^2, float32 with TF32 off; the
    other losses, bf16, a narrow copy against the CPU, a checkpoint round
    trip, and the trained encoder's embeddings served by a float32
    RetrievalIndex."""
    import tempfile

    from pyvisim_tpu_torch import checkpoint, profiling
    from pyvisim_tpu_torch.encoders import SiameseEncoder
    from pyvisim_tpu_torch.index import RetrievalIndex
    from pyvisim_tpu_torch.models import siamese as S
    from pyvisim_tpu_torch.ops.resize import masked_linear_resize

    t_phase = time.perf_counter()
    train_imgs, train_labels, held_imgs, held_labels = training_corpus()
    u8 = torch.from_numpy(np.stack(train_imgs)).cuda()
    x_all = masked_linear_resize(u8.float() / 255.0, TRAIN_SIZE)
    y_all = torch.from_numpy(train_labels).cuda()
    gen = torch.Generator().manual_seed(0)

    def draw():
        """8 classes x 4 of their views, drawn by a seeded generator."""
        classes = torch.randperm(TRAIN_CLASSES, generator=gen)[: TRAIN_B // 4]
        idx = torch.cat([c * TRAIN_VIEWS + torch.randperm(TRAIN_VIEWS, generator=gen)[:4]
                         for c in classes.tolist()])
        return x_all[idx.cuda()], y_all[idx.cuda()]

    numbers = {"batch": TRAIN_B, "image_size": TRAIN_SIZE, "steps": TRAIN_STEPS}
    model = S.SiameseEmbedder("vgg16", embed_dim=128)
    opt = S.adamw(3e-4)
    state = S.create_train_state(model, opt, seed=0)
    untrained = SiameseEncoder.from_train_state(model, state)
    step = S.train_step(model, opt, loss="nt_xent")
    torch.cuda.reset_peak_memory_stats()
    state, losses, times = step_ms(step, state, draw, TRAIN_STEPS)
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"siamese f32 nt_xent losses: {[round(v, 4) for v in losses]}")
    check(all(np.isfinite(losses)), "a non-finite float32 training loss")
    check(last < first, f"the loss did not fall: first 5 {first:.4f}, last 5 {last:.4f}")
    f32_ms = statistics.median(times[5:])
    numbers["f32"] = {"step_ms": f32_ms, "img_per_s": TRAIN_B / f32_ms * 1e3,
                      "first_step_ms": times[0],
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "loss_first5": first, "loss_last5": last}

    model16 = S.SiameseEmbedder("vgg16", embed_dim=128, n_classes=TRAIN_CLASSES)
    numbers["other_losses"] = {}
    for loss in ("triplet", "cosface", "arcface"):
        st = S.create_train_state(model16, opt, seed=1)
        st, ls_, ts = step_ms(S.train_step(model16, opt, loss=loss), st, draw, 3)
        check(all(np.isfinite(ls_)), f"a non-finite {loss} loss: {ls_}")
        numbers["other_losses"][loss] = {"losses": ls_, "step_ms": statistics.median(ts)}
        del st

    model_bf = S.SiameseEmbedder("vgg16", embed_dim=128, dtype=torch.bfloat16)
    st = S.create_train_state(model_bf, opt, seed=0)
    torch.cuda.reset_peak_memory_stats()
    st, ls_, ts = step_ms(S.train_step(model_bf, opt), st, draw, 5)
    check(all(np.isfinite(ls_)), f"a non-finite bf16 loss: {ls_}")
    bf_ms = statistics.median(ts[2:])
    numbers["bf16"] = {"losses": ls_, "step_ms": bf_ms, "img_per_s": TRAIN_B / bf_ms * 1e3,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del st

    x8, y8 = draw()
    x8 = masked_linear_resize(x8[:8].cpu(), 64)
    numbers["narrow_card_vs_cpu"] = narrow_card_vs_cpu(S, x8, y8[:8].cpu())

    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_train_state(tmp, state)
        restored = checkpoint.restore_train_state(
            tmp, S.create_train_state(model, opt, seed=5))
        check(checkpoint.latest_step(tmp) == TRAIN_STEPS, "the checkpoint's step")
    check(same_state(state, restored), "restored parameters or optimizer state differ")
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        x, y = draw()
        state, l_live = step(state, x, y)
        restored, l_rest = step(restored, x, y)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    check(torch.equal(l_live, l_rest) and same_state(state, restored),
          "the step from the restored state differs from the live state's")
    log(f"siamese checkpoint: restored bit for bit; the next step equal (loss {float(l_live):.6f})")
    del restored

    enc = SiameseEncoder.from_train_state(model, state)
    gallery = enc.encode(train_imgs)
    norms = np.linalg.norm(gallery.astype(np.float64), axis=1)
    check(gallery.shape == (len(train_imgs), 128), f"gallery embeddings {gallery.shape}")
    check(float(np.abs(norms - 1).max()) <= 1e-5, f"embedding norms {norms.min()}..{norms.max()}")
    ragged = [img[: 160 + 16 * i, : 300 - 20 * i] for i, img in enumerate(held_imgs[:6])]
    together = enc.encode(ragged)
    alone = np.concatenate([enc.encode(i) for i in ragged])
    ragged_err = float(np.abs(together - alone).max())
    check(ragged_err <= 1e-5, f"a ragged image's embedding depends on its batch: {ragged_err}")
    index = RetrievalIndex(gallery, [str(i) for i in range(len(gallery))])
    _, top = index.query_vectors(gallery, k=1)
    self_hits = int((top[:, 0] == np.arange(len(gallery))).sum())
    check(self_hits == len(gallery), f"self-retrieval {self_hits}/{len(gallery)}")
    numbers["encoder"] = {
        "ragged_max_abs_diff": ragged_err, "self_retrieval": self_hits,
        "encode_img_per_s": images_per_s(enc, train_imgs),
        "trained": retrieval_quality(enc, gallery, train_labels, held_imgs, held_labels),
        "untrained": retrieval_quality(untrained, untrained.encode(train_imgs), train_labels,
                                       held_imgs, held_labels),
    }
    # Where a float32 step's time goes, by kernel and by operator; and the
    # port's own trace context on the card.
    x, y = draw()
    numbers["profile_step"] = profile_device_graph(lambda: step(state, x, y), reps=3, top=12)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            step(state, x, y)
        traced = [p.name for p in pathlib.Path(tmp).glob("*.json")]
    cuda_us = sum(self_device_us(e) for e in prof.key_averages())
    check(traced and cuda_us > 0, f"profiling.trace wrote {traced}, device us {cuda_us}")
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"siamese": numbers}))
    return numbers


# Phase 10: ResNet50 trunks at 224^2 as DeepConvFeature modules; VLAD-256.
R50_D, R50_N = 2050, 49
R50_K8, R50_GEMM = 13, 39  # int8 block convs of one resnet50 forward: 3x3/1, the rest


def resnet_kernel_gates(agg, ls) -> dict:
    """Kernels 1 and 3 at ResNet50's width against their plain versions at
    phase 2a's and 2c's gates, and timed beside them and their bounds:
    kernel 1 at 128 sets of 49 x 2,050 (K=256), kernel 3 at the 6,272 x
    2,050 rows of the same images."""
    desc, mask, centers = margin_vlad_inputs(B, R50_N, R50_D, seed=10)
    out, labels = agg.vlad_aggregate_batched(desc, mask, centers, return_labels=True)
    ref, ref_labels = agg.vlad_aggregate_reference(desc, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    label_gate(labels, ref_labels, mask, "kernel 1 at D=2050")
    vlad_err = max_err(out, ref, "kernel 1 at D=2050")
    n_valid = int((mask != 0).sum())
    vb = bound(2 * n_valid * K * R50_D + 2 * n_valid * R50_D + 2 * B * K * R50_D,
               4 * (B * R50_N * R50_D + B * R50_N + K * R50_D + B * K * R50_D))
    vlad = {"shape": f"B={B} N={R50_N} D={R50_D} K={K}", "max_abs_err": vlad_err,
            "ms": cuda_ms(lambda: agg.vlad_aggregate_batched(desc, mask, centers)),
            "plain_ms": cuda_ms(lambda: agg.vlad_aggregate_reference(desc, mask, centers)), **vb}
    flat, fmask = desc.reshape(-1, R50_D), mask.reshape(-1)
    got = ls.lloyd_stats(flat, fmask, centers, return_labels=True)
    want = ls.lloyd_stats_reference(flat, fmask, centers, return_labels=True)
    torch.cuda.synchronize()
    label_gate(got[3], want[3], fmask, "kernel 3 at D=2050")
    lloyd_err = max_err(got[0], want[0], "kernel 3 sums at D=2050")
    check(torch.equal(got[1], want[1]), "kernel 3 counts at D=2050")
    rel = abs(float(got[2]) - float(want[2])) / float(want[2])
    check(rel <= 1e-5, f"kernel 3 inertia at D=2050 off by rel {rel}")
    rows = flat.shape[0]
    lb = bound(2 * n_valid * K * R50_D + 2 * n_valid * R50_D,
               4 * (rows * R50_D + rows + 2 * K * R50_D + K + 1))
    lloyd = {"shape": f"N={rows} D={R50_D} K={K}", "max_abs_err": lloyd_err,
             "ms": cuda_ms(lambda: ls.lloyd_stats(flat, fmask, centers)),
             "plain_ms": cuda_ms(lambda: ls.lloyd_stats_reference(flat, fmask, centers)), **lb}
    log(json.dumps({"resnet_kernels": {"vlad_aggregate": vlad, "lloyd_stats": lloyd}}))
    return {"vlad_aggregate": vlad, "lloyd_stats": lloyd}


def gemm_bound(x, wq, stride: int, residual=None) -> dict:
    """The least time of one int8_gemm_conv call: its int8 operations at the
    int8 tensor rate, or x, the weights, the residual and the output moved
    once."""
    b, h, w, cin = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (w + 2 * (k // 2) - k) // stride + 1
    ops = 2 * b * ho * wo * k * k * cin * cout
    size = x.element_size()
    n_bytes = (size * b * h * w * cin + wq.numel() + 4 * cout
               + size * b * ho * wo * cout * (1 if residual is None else 2))
    ops_ms, bytes_ms = ops / INT8_TENSOR_OPS * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "gop": ops / 1e9, "mb": n_bytes / 1e6}


def resnet_on_path_checks(conv, quant, agg, run):
    """``run()``, an int8 ResNet encode, with every kernel-8 call and every
    int8_gemm_conv call held against its plain version on the arguments the
    path gave it (outputs and int32 sums bit for bit; the sums from a
    second call that is not counted), kernel 1's call through
    ``vlad_on_path_gate``, and each int8 route timed beside its bound.
    Returns what ``run()`` returns, the records and the times by route and
    shape. A fused call (BatchNorm, and ReLU or the residual add and ReLU,
    in the epilogue) is held against the plain conv followed by
    ``batch_norm_tail``, the chain of torch passes it replaces."""
    from pyvisim_tpu_torch.ops import vlad as vlad_ops
    from pyvisim_tpu_torch.ops.cuda import int8_epilogue

    saved_k8, saved_gemm = conv.conv3x3_q8, quant.int8_gemm_conv
    saved_vlad = vlad_ops.vlad_aggregate_batched
    counts = (saved_k8.launches, saved_gemm.launches, agg.vlad_aggregate_batched.launches,
              int8_epilogue.gemm_epilogue.launches)
    records, routes = [], {}

    def timed(key, fn, n_bytes_bound):
        if key not in routes:
            routes[key] = {"calls": 0, "ms": cuda_ms(fn, reps=3, rounds=3), **n_bytes_bound}
        routes[key]["calls"] += 1

    def k8_checked(x, wq, sw, b, **kwargs):
        out = saved_k8(x, wq, sw, b, **kwargs)
        _, acc = saved_k8(x, wq, sw, b, return_acc=True, **kwargs)
        records.append(conv_on_path_gate(conv, "conv3x3_q8", out, acc, x, wq, (sw, b), kwargs))
        b_, h, w, cin = x.shape
        key = f"k8 3x3/1 {h}x{w}x{cin}->{wq.shape[0]}"
        timed(key, lambda: saved_k8(x, wq, sw, b, **kwargs),
              conv_bound(b_, h, cin, wq.shape[0], "k8", x.dtype))
        return out

    def gemm_checked(x, wq, sw, b=None, *, stride, padding, **kwargs):
        out = saved_gemm(x, wq, sw, b, stride=stride, padding=padding, **kwargs)
        _, acc = saved_gemm(x, wq, sw, b, stride=stride, padding=padding, return_acc=True)
        want, want_acc = conv.quant_conv_reference(x, wq, sw, b, stride=stride, padding=padding,
                                                   return_acc=True)
        bn, relu, residual = kwargs.get("bn"), kwargs.get("relu", False), kwargs.get("residual")
        want = int8_epilogue.batch_norm_tail(
            want.permute(0, 3, 1, 2), bn, relu,
            None if residual is None else residual.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        parts = [name for name, on in (("bn", bn is not None), ("residual", residual is not None),
                                       ("relu", relu)) if on]
        mode = "".join(f" +{name}" for name in parts)
        rec = {"kernel": "int8_gemm_conv", "shape": list(x.shape), "cout": int(wq.shape[0]),
               "k": int(wq.shape[1]), "stride": stride, "epilogue": parts}
        check(torch.equal(acc, want_acc), f"int8_gemm_conv's int32 sums differ: {rec}")
        check(torch.equal(out, want), f"int8_gemm_conv differs from its plain version: {rec}")
        records.append(rec)
        _, h, w, cin = x.shape
        key = f"gemm {wq.shape[1]}x{wq.shape[2]}/{stride} {h}x{w}x{cin}->{wq.shape[0]}{mode}"
        timed(key, lambda: saved_gemm(x, wq, sw, b, stride=stride, padding=padding, **kwargs),
              gemm_bound(x, wq, stride, residual))
        return out

    def vlad_checked(desc, mask, centers):
        out = saved_vlad(desc, mask, centers)
        records.append({"kernel": "vlad_aggregate",
                        **vlad_on_path_gate(agg, out, desc, mask, centers)})
        return out

    # A wrapper counts its launches on the module attribute of its name, so
    # the checks' own launches land on these and are dropped; the counts
    # are as they were before this run.
    k8_checked.launches = gemm_checked.launches = 0
    conv.conv3x3_q8, quant.int8_gemm_conv = k8_checked, gemm_checked
    vlad_ops.vlad_aggregate_batched = vlad_checked
    try:
        result = run()
    finally:
        conv.conv3x3_q8, quant.int8_gemm_conv = saved_k8, saved_gemm
        vlad_ops.vlad_aggregate_batched = saved_vlad
        (saved_k8.launches, saved_gemm.launches, agg.vlad_aggregate_batched.launches,
         int8_epilogue.gemm_epilogue.launches) = counts
    kinds = [r["kernel"] for r in records]
    check(kinds.count("conv3x3_q8") == R50_K8 and kinds.count("int8_gemm_conv") == R50_GEMM
          and kinds.count("vlad_aggregate") == 1,
          f"the int8 ResNet encode reached {sorted(set(kinds))}: {len(kinds)} calls")
    return result, records, routes


def phase_resnet(conv, agg, ls, images):
    """Phase 10: DeepConvFeature(module=ResNetTrunk("resnet50")) at 224^2 on
    the 128 images of phase 3, in float32 (TF32 off), bf16, int8 (window
    7-56, float32 around the int8 convs) and int8 in bf16; K-Means-256
    learned on the float trunk's descriptors (kernel 3 at D = 2,050) and
    VLAD with it on every trunk (kernel 1 at 128 x 49 x 2,050)."""
    from pyvisim_tpu_torch import profiling
    from pyvisim_tpu_torch.encoders import VLADEncoder
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.models import quant
    from pyvisim_tpu_torch.models import resnet as R
    from pyvisim_tpu_torch.ops.cuda import int8_epilogue as epi

    t_phase = time.perf_counter()
    numbers = {"kernels": resnet_kernel_gates(agg, ls)}
    weights = R.init_params("resnet50")

    def extractor(name, device=None):
        return DeepConvFeature(module=R.ResNetTrunk("resnet50", int8=name.startswith("int8")),
                               params=weights, image_size=224, device=device,
                               dtype=torch.bfloat16 if name.endswith("bf16") else torch.float32)

    exts = {name: extractor(name) for name in ("float32", "bf16", "int8", "int8_bf16")}
    check(all(e.output_dim == R50_D and e.descriptor_budget == R50_N for e in exts.values()),
          "ResNet50 descriptors are not 49 x 2,050")
    # The card's float32 trunk against the CPU's on 2 images.
    two = images[:2]
    card = exts["float32"].extract_batch(two)[0].float().cpu().numpy().reshape(2, -1)
    cpu = extractor("float32", "cpu").extract_batch(two)[0].float().numpy().reshape(2, -1)
    cos_cpu = cosine_rows(card, cpu)
    log(f"resnet50 f32 card vs cpu: cosine {cos_cpu.tolist()}")
    check(bool((cos_cpu > 0.9999).all()), f"float32 ResNet50 card and CPU disagree: {cos_cpu}")

    # The path: learn() on the float trunk, then VLAD on each trunk.
    wrappers = {"vlad": agg.vlad_aggregate_batched, "lloyd": ls.lloyd_stats,
                "k8": conv.conv3x3_q8, "gemm": quant.int8_gemm_conv,
                "epilogue": epi.gemm_epilogue}
    for w in wrappers.values():
        w.launches = 0
    history = {}
    vlad_f32 = VLADEncoder(exts["float32"])
    t0 = time.perf_counter()
    vlad_f32.learn(list(images), n_clusters=K, history=history)
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    inertia = history["lloyd_inertia"][0]
    check(ls.lloyd_stats.launches == len(inertia),
          f"{ls.lloyd_stats.launches} Lloyd launches for {len(inertia)} iterations")
    check(inertia[-1] <= inertia[0], "final inertia above the k-means++ centers' inertia")
    centers = vlad_f32.clustering_model
    encoders = {"float32": vlad_f32, **{name: VLADEncoder(exts[name], kmeans_model=centers)
                                        for name in ("bf16", "int8", "int8_bf16")}}
    per_encode, vecs = {}, {}
    for name, enc in encoders.items():
        enc.encode(list(images[:8]))  # warm up
        before = {k: w.launches for k, w in wrappers.items()}
        with profiling.record() as rec:
            vecs[name] = enc.encode(list(images))
        per_encode[name] = {k: w.launches - before[k] for k, w in wrappers.items()}
        per_encode[name]["fused"] = rec.counters().get("conv.int8_gemm_fused", 0)
        check(vecs[name].shape == (B, K * R50_D) and bool(np.isfinite(vecs[name]).all()),
              f"{name} ResNet50 VLAD encodings")
        self_retrieval(enc, images)
    want = {"vlad": 1, "lloyd": 0, "k8": 0, "gemm": 0, "epilogue": 0, "fused": 0}
    check(per_encode["float32"] == want and per_encode["bf16"] == want,
          f"float ResNet50 encodes ran {per_encode}")
    # One epilogue launch per gemm-route call; in bf16 each takes its BatchNorm.
    want_int8 = {**want, "k8": R50_K8, "gemm": R50_GEMM, "epilogue": R50_GEMM}
    check(per_encode["int8"] == want_int8 and per_encode["int8_bf16"] == {
        **want_int8, "fused": R50_GEMM}, f"the int8 ResNet50 encodes ran {per_encode}")
    launches = {k: w.launches for k, w in wrappers.items()}
    check(all(launches[k] for k in ("vlad", "lloyd", "k8", "epilogue")),
          f"phase 10 launches {launches}")
    log(f"resnet50: learn {learn_s:.2f} s ({len(inertia)} Lloyd steps, inertia "
        f"{inertia[0]:.6g} -> {inertia[-1]:.6g}); launches per encode {per_encode}")

    # Outside the counts: the int8 encode's kernel calls against their plain
    # versions, the trunks against each other, and the times.
    _, records, routes = resnet_on_path_checks(
        conv, quant, agg, lambda: encoders["int8"].encode(list(images)))
    _, records_bf16, routes_bf16 = resnet_on_path_checks(
        conv, quant, agg, lambda: encoders["int8_bf16"].encode(list(images)))
    fused = [r for r in records_bf16 if "bn" in r.get("epilogue", ())]
    check(len(fused) == R50_GEMM and not any(r.get("epilogue") for r in records),
          f"{len(fused)} fused calls checked in the bf16 int8 encode, "
          f"{sum(bool(r.get('epilogue')) for r in records)} in the float32 one")
    descs = {name: e.extract_batch(images)[0][..., :-2].float().reshape(B, -1).cpu().numpy()
             for name, e in exts.items()}
    cos = {name: cosine_rows(descs[name], descs["float32"])
           for name in ("int8", "bf16", "int8_bf16")}
    cos["int8_vlad"] = cosine_rows(vecs["int8"], vecs["float32"])
    log("resnet50: cosine against the float32 trunk per image, min/mean: " + ", ".join(
        f"{n} {c.min():.6f}/{c.mean():.6f}" for n, c in cos.items()))
    check(bool((cos["int8"] > 0.995).all()),
          f"int8 and float32 ResNet50 trunks disagree: min cosine {cos['int8'].min()}")
    dev_images = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        numbers["trunk_ms_per_128"] = {
            name: cuda_ms(lambda e=e: e._forward(dev_images), reps=3, rounds=5)
            for name, e in exts.items()}
        numbers["profile_int8_trunk"] = profile_device_graph(
            lambda: exts["int8"]._forward(dev_images), top=14)
    numbers["encode_img_per_s"] = {name: images_per_s(enc, images)
                                   for name, enc in encoders.items()}
    numbers["int8_routes"] = routes
    numbers["int8_bf16_routes"] = routes_bf16
    numbers["int8_calls_checked"] = len(records) + len(records_bf16)
    numbers["int8_fused_calls_checked"] = len(fused)
    numbers["cosine_vs_f32_min"] = {n: float(c.min()) for n, c in cos.items()}
    numbers["learn_s"] = learn_s
    numbers["lloyd_iterations"] = len(inertia)
    numbers["launches_per_encode_of_128"] = per_encode
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"resnet": numbers, "launches": launches}))
    return launches, numbers


# Phase 11: the clustering evaluation of a gallery at Oxford Flowers-102's
# scale (6,149 'tstid' images in 102 classes become the train split), in
# the dataset's own layout, built from synthetic views.
FLOWERS_CLASSES, FLOWERS_GALLERY, FLOWERS_SPLIT = 102, 6149, 10
FLOWERS_BATCH = 128


def flowers_tree(root: pathlib.Path) -> np.ndarray:
    """Write ``oxford_flower_dataset/`` under ``root`` as Flowers-102 lays it
    out: 8,189 JPEGs ``images/jpg/image_00001.jpg ...`` at 224^2,
    ``labels.mat`` and ``setid.mat``. Class c holds 60 or 61 'tstid' views
    of one synthetic scene (``make_class_images``, seed 100 + c, as
    ``make_retrieval_corpus`` draws it), then 10 'trnid' and 10 'valid'
    images, hard links to one further view (only the integrity check
    counts them). Returns the 6,149 'tstid' labels (1-102) in ID order."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import scipy.io

    from pyvisim_tpu_torch.datasets import make_class_images

    jpg = root / "oxford_flower_dataset" / "images" / "jpg"
    jpg.mkdir(parents=True)
    per = [FLOWERS_GALLERY // FLOWERS_CLASSES + (c < FLOWERS_GALLERY % FLOWERS_CLASSES)
           for c in range(FLOWERS_CLASSES)]
    first = np.cumsum([0] + [n + 2 * FLOWERS_SPLIT for n in per])[:-1] + 1

    def write_class(c: int) -> None:
        views = make_class_images(seed=100 + c, n=per[c] + 1, h=224, w=224)
        for j in range(per[c] + 1):
            ok = cv2.imwrite(str(jpg / f"image_{first[c] + j:05d}.jpg"), views[j][..., ::-1])
            check(ok, f"could not write image {first[c] + j}")
        shared = jpg / f"image_{first[c] + per[c]:05d}.jpg"
        for j in range(per[c] + 1, per[c] + 2 * FLOWERS_SPLIT):
            os.link(shared, jpg / f"image_{first[c] + j:05d}.jpg")

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write_class, range(FLOWERS_CLASSES)))
    labels = np.concatenate([np.full(n + 2 * FLOWERS_SPLIT, c + 1) for c, n in enumerate(per)])
    ids = {"tstid": [], "trnid": [], "valid": []}
    for c, n in enumerate(per):
        ids["tstid"] += range(first[c], first[c] + n)
        ids["trnid"] += range(first[c] + n, first[c] + n + FLOWERS_SPLIT)
        ids["valid"] += range(first[c] + n + FLOWERS_SPLIT, first[c] + n + 2 * FLOWERS_SPLIT)
    base = root / "oxford_flower_dataset"
    scipy.io.savemat(str(base / "labels.mat"), {"labels": labels.reshape(1, -1)})
    scipy.io.savemat(str(base / "setid.mat"),
                     {k: np.asarray(v).reshape(1, -1) for k, v in ids.items()})
    return labels[np.asarray(ids["tstid"]) - 1]


def f32_slack(d: int) -> float:
    """The relative slack of a float32 squared distance over ``d``
    dimensions: phase 8's 1e-5 (|x|^2 + |c|^2), or three rounding steps
    grown with sqrt(d), as a sum of ``d`` products rounded in float32 errs,
    where that is larger (6.5e-5 at d = 131,584)."""
    return max(1e-5, 3 * 2.0**-24 * d**0.5)


def lloyd_gate(ls, x, mask, centers, what: str) -> dict:
    """Kernel 3 on the arguments of a Lloyd step of the path against its
    plain version, at phase 2c's gates where these real rows allow: each
    label equal to the plain argmin's or, for a near tie, within
    ``f32_slack(D)`` (|x|^2 + |c|^2) of its float64 distance; the sums
    within 1e-4 * max|ref| + 1e-5 and the counts equal to the plain
    version's statistics under the kernel's labels (the plain version
    itself where no label differs); two calls bit-equal; the inertia of
    both within rel 1e-5 of the float64 inertia under the kernel's labels,
    or within the float32 slack of its terms where that is larger."""
    from pyvisim_tpu_torch.ops import pairwise_sqdist

    got = ls.lloyd_stats(x, mask, centers, return_labels=True)
    again = ls.lloyd_stats(x, mask, centers, return_labels=True)
    ref = ls.lloyd_stats_reference(x, mask, centers, return_labels=True)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: kernel 3 does not repeat bit for bit")
    labels, ref_labels = got[3], ref[3]
    weighted = mask != 0
    differ = (labels != ref_labels) & weighted
    xd = x[differ].double()
    c_got, c_ref = (centers[lab[differ].long()].double() for lab in (labels, ref_labels))
    gap = ((xd - c_got) ** 2).sum(1) - ((xd - c_ref) ** 2).sum(1)
    slack = f32_slack(x.shape[1]) * ((xd**2).sum(1) + (c_got**2).sum(1))
    check(bool((gap <= slack).all()), f"{what}: {int((gap > slack).sum())} labels are not the "
          "nearest center")
    rest = labels[~weighted]
    check(bool(((rest == -1) | (rest == ref_labels[~weighted])).all()),
          f"{what}: a weightless row's label is neither -1 nor the plain argmin")

    one_hot = F.one_hot(labels.clamp(min=0).long(), centers.shape[0]).to(x.dtype) * mask[:, None]
    d2 = pairwise_sqdist(x, centers).gather(1, labels.clamp(min=0).long()[:, None])[:, 0]
    want = (one_hot.T @ x, one_hot.sum(0), (d2.clamp_min(0.0) * mask).sum())
    err = max_err(got[0], want[0], f"{what}: kernel 3 sums")
    check(torch.equal(got[1], want[1]), f"{what}: kernel 3 counts differ")
    # The inertia sums |x|^2 - 2 x.c + |c|^2 over the rows: each term errs by
    # up to f32_slack(D) (|x|^2 + |c|^2) in float32, and at D = 131,584 that
    # exceeds rel 1e-5 of the sum. So both are held to the float64 inertia
    # under the kernel's labels, within rel 1e-5 or that slack summed.
    lab = labels.clamp(min=0).long()
    exact = scale = 0.0
    for i in range(0, x.shape[0], 1024):
        xd, cd, md = x[i:i + 1024].double(), centers[lab[i:i + 1024]].double(), mask[i:i + 1024]
        exact += float((((xd - cd) ** 2).sum(1) * md).sum())
        scale += float((((xd**2).sum(1) + (cd**2).sum(1)) * md).sum())
    tol = max(1e-5 * exact, f32_slack(x.shape[1]) * scale)
    inertia_err = {"kernel": float(got[2]) - exact, "plain": float(want[2]) - exact}
    log(f"  {what}: inertia float64 {exact:.6f}, kernel {inertia_err['kernel']:+.3e}, plain "
        f"{inertia_err['plain']:+.3e} (tol {tol:.3e})")
    check(all(abs(e) <= tol for e in inertia_err.values()),
          f"{what}: inertia off float64 by {inertia_err} > {tol}")
    return {"shape": f"N={x.shape[0]} D={x.shape[1]} K={centers.shape[0]}", "max_abs_err": err,
            "near_tie_rows": int(differ.sum()), "inertia_float64": exact,
            "inertia_err": inertia_err}


def lloyd_on_path_gate(ls, x, mask, centers, what: str) -> dict:
    """``lloyd_gate`` on the first Lloyd step's arguments of a fit of the
    path, timed beside the plain version and its bound."""
    from pyvisim_tpu_torch.ops import lloyd_step

    rec = lloyd_gate(ls, x, mask, centers, what)
    n, d = x.shape
    k = centers.shape[0]
    n_valid = int((mask != 0).sum())
    lb = bound(2 * n_valid * k * d + 2 * n_valid * d, 4 * (n * d + n + 2 * k * d + k + 1))

    def step_synced():
        new, inertia = lloyd_step(x, mask, centers)
        torch.stack([((new - centers) ** 2).sum(), inertia]).tolist()

    rec.update({
        "ms": cuda_ms(lambda: ls.lloyd_stats(x, mask, centers), reps=5, rounds=5),
        "plain_ms": cuda_ms(lambda: ls.lloyd_stats_reference(x, mask, centers), reps=5,
                            rounds=5),
        "step_queued_ms": cuda_ms(lambda: lloyd_step(x, mask, centers), reps=5, rounds=5),
        "step_synced_ms": host_ms(step_synced), **lb})
    log(f"  {what}: kernel 3 {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}, bound "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']}); Lloyd step queued "
        f"{rec['step_queued_ms']:.4f}, synced {rec['step_synced_ms']:.4f}")
    return rec


def knn_gate(x, a) -> dict:
    """``knn_affinity``'s matrix ``a`` of the rows ``x``: symmetric, values in
    {0, 0.5, 1}, a diagonal of 1, at least 11 nonzeros a row, and equal to
    a float64 recomputation (stable order) wherever both the row and the
    column are clear: their 11th and 12th nearest squared distances differ
    by more than 1e-5 relative and by more than the float32 slack
    (``f32_slack``) of the row's and the largest squared norm. A near tie
    there may pick either."""
    check(torch.equal(a, a.T), "knn_affinity is not symmetric")
    check(bool(((a == 0) | (a == 0.5) | (a == 1)).all()), "knn_affinity has values "
          "outside {0, 0.5, 1}")
    check(bool((a.diagonal() == 1).all()), "knn_affinity's diagonal is not 1")
    nnz = (a > 0).sum(1)
    check(bool((nnz >= 11).all()), f"a row of knn_affinity has {int(nnz.min())} nonzeros")
    xd = x.double()
    sq = (xd * xd).sum(1)
    d2 = sq[:, None] - 2.0 * (xd @ xd.T) + sq[None, :]
    del xd
    order = torch.sort(d2, dim=1, stable=True)
    kept, dropped = order.values[:, 10], order.values[:, 11]
    slack = f32_slack(x.shape[1]) * (sq + sq.max())
    clear = ((dropped - kept) > 1e-5 * dropped.abs()) & ((dropped - kept) > slack)
    raw = torch.zeros_like(d2)
    raw.scatter_(1, order.indices[:, :11], 1.0)
    raw.diagonal().fill_(1.0)
    want = (0.5 * (raw + raw.T)).to(a.dtype)
    both = clear[:, None] & clear[None, :]
    diff = int(((a != want) & both).sum())
    check(diff == 0, f"knn_affinity differs from float64 on {diff} entries of clear rows")
    return {"clear_rows": int(clear.sum()), "min_nonzeros": int(nnz.min())}


def embedding_gate(x, emb, a) -> dict:
    """The spectral embedding's columns times sqrt(deg) are eigenvectors of
    L_sym = I - D^-1/2 W D^-1/2 (float64): with lambda each column's
    Rayleigh quotient, ||L v - lambda v||_inf / ||v||_inf <= 1e-3, and the
    lambdas ascending (to 1e-5) from about 0."""
    w = a.double()
    dis = 1.0 / torch.sqrt(w.sum(1).clamp_min(1e-12))
    lsym = -(w * dis[:, None] * dis[None, :])
    lsym.diagonal().add_(1.0)
    v = emb.double() / dis[:, None]
    lv = lsym @ v
    lam = (v * lv).sum(0) / (v * v).sum(0)
    res = (lv - lam * v).abs().amax(0) / v.abs().amax(0)
    check(bool((res <= 1e-3).all()), f"spectral embedding residual {float(res.max())} > 1e-3")
    check(float(lam[0]) <= 1e-4 and bool((lam.diff() >= -1e-5).all()),
          f"spectral embedding eigenvalues not ascending from 0: {lam[:5].tolist()}")
    return {"max_residual": float(res.max()), "lambda_first": float(lam[0]),
            "lambda_last": float(lam[-1])}


def float64_pair_scores(a: np.ndarray, b: np.ndarray) -> dict:
    """Rand and adjusted Rand index from a contingency table in float64."""
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    table = np.zeros((ia.max() + 1, ib.max() + 1))
    np.add.at(table, (ia, ib), 1.0)
    pairs = lambda m: (m * (m - 1) / 2).sum()  # noqa: E731
    n = float(len(a))
    total, cells = n * (n - 1) / 2, pairs(table)
    rows, cols = pairs(table.sum(1)), pairs(table.sum(0))
    expected = rows * cols / total
    return {"ri": (total + 2 * cells - rows - cols) / total,
            "ari": (cells - expected) / (0.5 * (rows + cols) - expected)}


def phase_flowers(conv, agg, ls, enc, root: pathlib.Path):
    """Phase 11: a Flowers-102 tree, ``OxfordFlowerDataset(purpose="train")``
    encoded by phase 7's int8 VLAD encoder, then
    ``cluster_images_and_generate_statistics`` three ways, through the
    public entry points. ``root`` is the cache directory that
    ``PYVISIM_TPU_TORCH_CACHE_DIR`` named before the port was imported."""
    from pyvisim_tpu_torch import _utils
    from pyvisim_tpu_torch.datasets import datasets as ds
    from pyvisim_tpu_torch.ops import kmeans as kmeans_ops
    from pyvisim_tpu_torch.ops import kmeans_plus_plus_init
    from pyvisim_tpu_torch.ops import spectral as spectral_ops

    t_phase = time.perf_counter()
    check(pathlib.Path(ds._DATASET_ROOT) == root / "oxford_flower_dataset",
          f"the dataset root {ds._DATASET_ROOT} is not phase 11's tree")
    t0 = time.perf_counter()
    tst_labels = flowers_tree(root)
    tree_s = time.perf_counter() - t0

    def refuse():
        raise RuntimeError("phase 11's Flowers-102 tree failed the integrity check")

    ds.download_oxford_flowers_data = refuse
    data = ds.OxfordFlowerDataset(purpose="train")
    check(len(data) == FLOWERS_GALLERY, f"train split has {len(data)} images")
    check(np.array_equal(np.asarray(data.labels), tst_labels), "train labels differ")
    labels = np.asarray(data.labels)

    wrappers = {"k7": conv.conv3x3_relu_maxpool, "k8_pooled": conv.conv3x3_relu_maxpool_q8,
                "k8_unpooled": conv.conv3x3_q8, "vlad": agg.vlad_aggregate_batched,
                "lloyd": ls.lloyd_stats}
    for w in wrappers.values():
        w.launches = 0
    # Each fit's Lloyd steps and its first step's arguments, recorded on the
    # way; the wrappers call the originals and launch nothing themselves.
    steps, first_steps, fit_open = [], [], [False]
    saved = kmeans_ops.lloyd_step, kmeans_ops.kmeans_fit, spectral_ops.kmeans_fit

    def counted_step(x, mask, centers, chunk_size=None):
        steps[-1] += 1
        if fit_open[0]:
            first_steps.append((x, mask, centers))
            fit_open[0] = False
        return saved[0](x, mask, centers, chunk_size)

    def opened_fit(*args, **kwargs):
        fit_open[0] = True
        steps.append(0)
        return saved[1](*args, **kwargs)

    kmeans_ops.lloyd_step, kmeans_ops.kmeans_fit, spectral_ops.kmeans_fit = (
        counted_step, opened_fit, opened_fit)
    try:
        encodings = np.empty((FLOWERS_GALLERY, K * D), np.float32)
        decode_s = encode_s = 0.0
        at, batches = 0, iter(data.iter_batches(FLOWERS_BATCH, 224))
        t_enc = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            decode_s += time.perf_counter() - t0
            if batch is None:
                break
            imgs, batch_labels, _ = batch
            before = {n: w.launches for n, w in wrappers.items()}
            t0 = time.perf_counter()
            encodings[at : at + len(imgs)] = enc.encode(imgs)
            encode_s += time.perf_counter() - t0
            per = {n: w.launches - before[n] for n, w in wrappers.items() if n != "lloyd"}
            check(per == {"k7": 2, "k8_pooled": 2, "k8_unpooled": 4, "vlad": 1},
                  f"an encode of {len(imgs)} images ran {per}")
            check(np.array_equal(batch_labels, labels[at : at + len(imgs)]), "batch labels")
            at += len(imgs)
        encode_e2e_s = time.perf_counter() - t_enc
        check(at == FLOWERS_GALLERY and bool(np.isfinite(encodings).all()),
              f"encoded {at} images, or non-finite encodings")
        runs, cluster_labels = {}, []
        saved_labels = _utils.cluster_and_return_labels

        def recorded(*args, **kwargs):
            out = saved_labels(*args, **kwargs)
            cluster_labels.append(out)
            return out

        _utils.cluster_and_return_labels = recorded
        try:
            for name, method, feats in (("kmeans", "kmeans", lambda: encodings),
                                        ("spectral", "spectral", lambda: encodings),
                                        ("spectral_cosine", "spectral",
                                         lambda: _utils.cosine_similarity(encodings, encodings))):
                features = feats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scores = _utils.cluster_images_and_generate_statistics(
                    features, labels, FLOWERS_CLASSES, method=method)
                torch.cuda.synchronize()
                runs[name] = {**scores, "s": time.perf_counter() - t0}
                log(f"flowers102 {name}: {runs[name]}")
                del features
        finally:
            _utils.cluster_and_return_labels = saved_labels
    finally:
        kmeans_ops.lloyd_step, kmeans_ops.kmeans_fit, spectral_ops.kmeans_fit = saved
    launches = {n: w.launches for n, w in wrappers.items()}
    log(f"flowers102: launches {launches}, Lloyd steps of each fit {steps}")
    check(all(launches.values()), f"phase 11 did not launch every kernel: {launches}")
    check(launches["lloyd"] == sum(steps), f"kernel 3 launched {launches['lloyd']} times for "
          f"{sum(steps)} Lloyd steps")
    batches_run = -(-FLOWERS_GALLERY // FLOWERS_BATCH)
    check(launches["vlad"] == batches_run, f"{launches['vlad']} VLAD launches")
    check(len(first_steps) == 3, f"{len(first_steps)} K-Means fits recorded")

    # The gates and measurements, outside the launch counts.
    for (name, rec), out in zip(runs.items(), cluster_labels):
        check(out.shape == (FLOWERS_GALLERY,) and 0 <= out.min() and out.max() < FLOWERS_CLASSES
              and len(np.unique(out)) <= FLOWERS_CLASSES, f"{name}: labels out of range")
        ref = float64_pair_scores(labels, out)
        for key in ("ri", "ari"):
            check(abs(rec[key] - ref[key]) <= 1e-12,
                  f"{name}: {key} {rec[key]} against float64 {ref[key]}")
        rec["clusters"] = int(len(np.unique(out)))
    kernel3 = {f"{name} D={x.shape[1]}": lloyd_on_path_gate(ls, x, m, c, f"flowers102 {name}")
               for (x, m, c), name in zip(first_steps, runs)}
    x = first_steps[0][0]
    ones = torch.ones((x.shape[0],), device="cuda")
    gen = torch.Generator(device="cuda")
    seed_ms = host_ms(lambda: kmeans_plus_plus_init(gen.manual_seed(0), x, FLOWERS_CLASSES,
                                                    ones)[0, 0].item(), reps=2)
    knn_ms = cuda_ms(lambda: spectral_ops.knn_affinity(x, 10), reps=1, rounds=3, warmup=1)
    n = x.shape[0]
    knn_bound = bound(2 * n * n * x.shape[1], 4 * (n * x.shape[1] + n * n))
    a = spectral_ops.knn_affinity(x, 10)
    knn = knn_gate(x, a)
    emb = spectral_ops.spectral_embedding(x, FLOWERS_CLASSES)
    spectral = embedding_gate(x, emb, a)
    dis = 1.0 / torch.sqrt(a.sum(1))
    lsym = -(a * dis[:, None] * dis[None, :])
    lsym.diagonal().add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.linalg.eigh(lsym)
    torch.cuda.synchronize()
    eigh_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    torch.from_numpy(encodings).cuda()
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    numbers = {
        "gallery": FLOWERS_GALLERY, "classes": FLOWERS_CLASSES, "dim": K * D,
        "tree_s": tree_s, "decode_ms_per_image": decode_s / FLOWERS_GALLERY * 1e3,
        "encode_img_per_s": FLOWERS_GALLERY / encode_s,
        "encode_e2e_img_per_s": FLOWERS_GALLERY / encode_e2e_s,
        "encodings_gb": encodings.nbytes / 1e9, "encodings_h2d_pageable_ms": h2d_ms,
        "runs": runs, "lloyd_steps_per_fit": steps, "kernel3": kernel3,
        "kmeans_pp_seed_ms": seed_ms, "knn_affinity_ms": knn_ms,
        "knn_affinity_bound_ms": knn_bound["bound_ms"], "knn": knn,
        "eigh_ms": eigh_ms, "embedding": spectral,
        "phase_s": time.perf_counter() - t_phase,
    }
    for name, rec in runs.items():
        log(f"flowers102 {name}: RI {rec['ri']:.6f} ARI {rec['ari']:.6f} AMI {rec['nmi']:.6f}, "
            f"{rec['clusters']} clusters, {rec['s']:.2f} s")
    log(f"flowers102: decode {numbers['decode_ms_per_image']:.3f} ms/img, encode "
        f"{numbers['encode_img_per_s']:.1f} img/s ({numbers['encode_e2e_img_per_s']:.1f} with "
        f"decoding), seeding {seed_ms:.1f} ms, knn_affinity {knn_ms:.1f} ms (bound "
        f"{knn_bound['bound_ms']:.1f}), eigh {eigh_ms:.1f} ms, encodings to the card "
        f"{h2d_ms:.1f} ms")
    log(json.dumps({"flowers102": numbers, "launches": launches}))
    return launches, numbers


# ---------------------------------------------------------------------------
# Phase 12: the mesh paths (pyvisim_tpu_torch.parallel) in worlds of ranks
# ---------------------------------------------------------------------------
DEV = "cuda"  # phase 12's device
MESH_WORLDS = (("nccl1", 1, "nccl"), ("gloo2", 2, "gloo"))
MESH_KM_STEPS = MESH_EM_STEPS = 10
MESH_TRAIN_STEPS, MESH_TRAIN_LR = 3, 3e-4
MESH_GALLERY_SEED, MESH_Q = 12, 8
MESH_CHECKED = {"vlad_aggregate", "gmm_stats", "lloyd_stats", "sift_refine", "sift_orientation",
                "sift_descriptor", "conv3x3_relu_maxpool", "conv3x3_relu_maxpool_q8", "conv3x3_q8"}
MESH_STEPS = ("kmeans", "pca", "gmm", "vlad_encoder", "fv_encoder", "cluster_vlad",
              "cluster_fisher", "sift", "index_f32", "index_int8", "train_dp", "train_tp")


def mesh_wrappers() -> dict:
    """The eight kernels' wrappers by their records' names (kernel 8 has a
    pooled and an unpooled entry point)."""
    from pyvisim_tpu_torch.ops.cuda import aggregate, conv, gmm_stats, lloyd_stats, sift_window

    return {"vlad_aggregate": (aggregate.vlad_aggregate_batched,),
            "gmm_stats": (gmm_stats.gmm_stats_batched,),
            "lloyd_stats": (lloyd_stats.lloyd_stats,),
            "sift_refine": (sift_window.refine,),
            "sift_orientation": (sift_window.orientation,),
            "sift_descriptor": (sift_window.descriptor,),
            "conv3x3_relu_maxpool": (conv.conv3x3_relu_maxpool,),
            "conv3x3_relu_maxpool_q8": (conv.conv3x3_relu_maxpool_q8, conv.conv3x3_q8)}


def mesh_kernel_gates() -> dict:
    """Each kernel's gate on one call of the path, by record name:
    ``gate(args, kwargs, out)`` holds the call's output against the
    kernel's plain version on the same arguments at phase 2's tolerances
    (the checks of phases 2a-2e, 8 and 11) and returns its record."""
    from pyvisim_tpu_torch.ops.cuda import aggregate, conv, gmm_stats, lloyd_stats, sift_window

    def repeats(what, fn, a, k, out):
        check(same_bits(out, fn(*a, **k)), f"{what} does not repeat bit for bit on the mesh path")

    def lloyd(a, k, out):
        repeats("kernel 3", lloyd_stats.lloyd_stats, a, k, out)
        return lloyd_gate(lloyd_stats, *a, "mesh kernel 3")

    def sift(name, gate):
        def g(a, k, out):
            repeats(name, getattr(sift_window, name), a, k, out)
            return gate(sift_window, a, k)
        return g

    def conv_gate(name):
        def g(a, k, out):
            acc = None
            if name != "conv3x3_relu_maxpool":  # kernel 8's int32 sums too
                acc = getattr(conv, name)(*a, return_acc=True, **k)[1]
            return conv_on_path_gate(conv, name, out, acc, a[0], a[1], a[2:], k)
        return g

    return {"vlad_aggregate": lambda a, k, out: vlad_on_path_gate(aggregate, out, *a),
            "gmm_stats": lambda a, k, out: gmm_gate(gmm_stats, a, k, out, "mesh kernel 2",
                                                    ll_against="float64"),
            "lloyd_stats": lloyd,
            "sift_refine": sift("refine", refine_gate),
            "sift_orientation": sift("orientation", orientation_gate),
            "sift_descriptor": sift("descriptor", descriptor_gate),
            "conv3x3_relu_maxpool": conv_gate("conv3x3_relu_maxpool"),
            "conv3x3_relu_maxpool_q8": conv_gate("conv3x3_relu_maxpool_q8"),
            "conv3x3_q8": conv_gate("conv3x3_q8")}


class _Module:
    """A module with some of its names replaced."""

    def __init__(self, module, **names):
        self.__dict__.update(names)
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, name)


class MeshPathChecks:
    """Holds, inside a rank, the first call of each kernel at each input
    shape during a named step against the kernel's plain version on the
    same arguments (``mesh_kernel_gates``): it wraps the names through
    which the port calls the kernels. The launches the checks make are
    taken off the kernels' counts, and their seconds off the step's."""

    SITES = {  # module: (name in it, kernel record name or a module's kernels)
        "pyvisim_tpu_torch.ops.vlad": ("vlad_aggregate_batched", "vlad_aggregate"),
        "pyvisim_tpu_torch.ops.fisher": ("gmm_stats_batched", "gmm_stats"),
        "pyvisim_tpu_torch.parallel.sharded": (("gmm_stats_batched", "gmm_stats"),
                                               ("lloyd_stats", "lloyd_stats")),
        "pyvisim_tpu_torch.ops.kmeans": ("lloyd_stats", "lloyd_stats"),
        "pyvisim_tpu_torch.ops.sift": ("kernels", {"refine": "sift_refine",
                                                   "orientation": "sift_orientation",
                                                   "descriptor": "sift_descriptor"}),
        "pyvisim_tpu_torch.models.quant": ("conv_ops", {n: n for n in (
            "conv3x3_relu_maxpool", "conv3x3_relu_maxpool_q8", "conv3x3_q8")}),
    }

    def __init__(self):
        self.step, self.seen, self.records, self.seconds = None, set(), [], 0.0
        self.gates = mesh_kernel_gates()
        self.counted = [w for ws in mesh_wrappers().values() for w in ws]
        self.saved = []

    def wrap(self, record, fn):
        def checked(*args, **kwargs):
            out = fn(*args, **kwargs)
            first = args[0] if args else next(iter(kwargs.values()))
            sig = [tuple(t.shape) for t in (first if isinstance(first, list) else [first])]
            if self.step is not None and (record, str(sig)) not in self.seen:
                self.seen.add((record, str(sig)))
                counts = [w.launches for w in self.counted]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec = self.gates[record](args, kwargs, out)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                for w, n in zip(self.counted, counts):
                    w.launches = n
                self.records.append({"step": self.step, "kernel": record, "input": str(sig),
                                     **{k: v for k, v in rec.items() if k != "kernel"}})
            return out
        return checked

    def install(self):
        import importlib

        for path, sites in self.SITES.items():
            module = importlib.import_module(path)
            for attr, record in (sites if isinstance(sites[0], tuple) else (sites,)):
                fn = getattr(module, attr)
                self.saved.append((module, attr, fn))
                if isinstance(record, dict):
                    setattr(module, attr, _Module(fn, **{n: self.wrap(r, getattr(fn, n))
                                                         for n, r in record.items()}))
                else:
                    setattr(module, attr, self.wrap(record, fn))

    def remove(self):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)
        self.saved = []


class MeshSteps:
    """Runs named steps with every kernel's count set to 0 just before each
    and read just after; records each step's seconds (the card synced; the
    seconds of ``checks``, a ``MeshPathChecks``, taken off), launches and
    the bytes staged through the host for gloo."""

    def __init__(self, checks=None):
        from pyvisim_tpu_torch.parallel import _collectives

        self.coll = _collectives
        self.wrappers = mesh_wrappers()
        self.checks = checks
        self.seconds, self.launches, self.staged = {}, {}, {}

    def run(self, name, fn):
        for ws in self.wrappers.values():
            for w in ws:
                w.launches = 0
        self.coll.reset_staged_bytes()
        checked_s = 0.0
        if self.checks is not None:
            self.checks.step, checked_s = name, self.checks.seconds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            if self.checks is not None:
                self.checks.step, checked_s = None, self.checks.seconds - checked_s
        self.seconds[name] = time.perf_counter() - t0 - checked_s
        counts = {k: sum(w.launches for w in ws) for k, ws in self.wrappers.items()}
        self.launches[name] = {k: n for k, n in counts.items() if n}
        self.staged[name] = self.coll.staged_bytes()
        return out


def mesh_gallery() -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 12's served gallery, 6,149 x 131,584 drawn on the card from a
    seed, and 8 queries near its rows 5, 773, ... (every 768th)."""
    g = torch.Generator(device=DEV).manual_seed(MESH_GALLERY_SEED)
    gallery = torch.randn((SERVE_ROWS, K * D), generator=g, device=DEV)
    rows = torch.arange(MESH_Q, device=DEV) * (SERVE_ROWS // MESH_Q) + 5
    noise = torch.randn((MESH_Q, K * D), generator=g, device=DEV)
    return gallery, gallery[rows] + 0.5 * noise


def mesh_train_batch():
    """The first 32 training views of phase 9's corpus (4 classes x 8
    views) at 224^2, and their labels."""
    from pyvisim_tpu_torch.ops.resize import masked_linear_resize

    imgs, labels, _, _ = training_corpus()
    u8 = torch.from_numpy(np.stack(imgs[:TRAIN_B])).to(DEV)
    return (masked_linear_resize(u8.float() / 255.0, TRAIN_SIZE).cpu().numpy(),
            labels[:TRAIN_B].astype(np.int64))


def mesh_index_answers(index, queries) -> dict:
    out = {}
    for q in (1, MESH_Q):
        scores, ids = index.query_vectors(queries[:q], 5)
        out[f"q{q}_ids"], out[f"q{q}_scores"] = ids, scores
    return out


def mesh_query_ms(index, queries, reps: int = 20) -> float:
    """Median host ms of a Q=1 query (numpy out, so the card is synced)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        index.query_vectors(queries[:1], 5)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_steps(run, inp, meshes, trainer):
    """Every step of phase 12 through ``run(name, fn)``. ``meshes`` maps
    "data", "cluster" and "model" to the mesh of each step (None for the
    single card); ``trainer(mesh)`` gives ``(state, step)``. Returns the
    steps' results as numpy arrays, by step."""
    from pyvisim_tpu_torch import parallel as par
    from pyvisim_tpu_torch.encoders import FisherVectorEncoder, GMMWeights, VLADEncoder
    from pyvisim_tpu_torch.encoders._base_encoder import _CLUSTERING_TO_PCA_MAPPING
    from pyvisim_tpu_torch.features import DeepConvFeature
    from pyvisim_tpu_torch.index import RetrievalIndex
    from pyvisim_tpu_torch.ops import KMeansCodebook, fisher_encode_batch, gmm, kmeans, pca, sift
    from pyvisim_tpu_torch.ops.cuda import aggregate
    from pyvisim_tpu_torch.ops.norms import lp_normalize

    data, clu = meshes["data"], meshes["cluster"]
    x = torch.from_numpy(inp["x"]).to(DEV)
    desc = x.view(B, N, D)
    init = torch.from_numpy(inp["init"]).to(DEV)
    centers = torch.from_numpy(inp["centers"]).to(DEV)
    fv_gmm = GMMWeights.OXFORD102_K256_VGG16_PCA.load().to(DEV)
    projector = _CLUSTERING_TO_PCA_MAPPING[GMMWeights.OXFORD102_K256_VGG16_PCA].load().to(DEV)
    x_pca = projector(x).contiguous()
    res = {}

    def kmeans_step():
        h = {}
        if data is None:
            cb, _ = kmeans.kmeans_fit(x, K, max_iters=MESH_KM_STEPS, tol=-1.0, history=h,
                                      device=DEV)
        else:
            cb, _ = par.distributed_kmeans_fit(x, K, data, n_iters=MESH_KM_STEPS,
                                               init_centers=init, history=h)
        return {"centers": cb.centers, "inertia": np.asarray(h["lloyd_inertia"][0])}

    def pca_step():
        p = (pca.pca_fit(x, D_PCA, device=DEV) if data is None
             else par.distributed_pca_fit(x, D_PCA, data))
        return {"mean": p.mean, "components": p.components, "var": p.explained_variance}

    def gmm_step():
        km = KMeansCodebook(centers=fv_gmm.means)
        ones = torch.ones(x_pca.shape[0], device=DEV)
        if data is None:
            g = gmm._init_from_kmeans(x_pca, ones, km, 1e-6)
            lls = []
            for _ in range(MESH_EM_STEPS):
                g, ll = gmm.em_step(x_pca, ones, g, 1e-6)
                lls.append(ll)
            lls = torch.stack(lls).tolist()
        else:
            h = {}
            g, _ = par.distributed_gmm_fit(x_pca, K, data, n_iters=MESH_EM_STEPS, init_kmeans=km,
                                           history=h)
            lls = h["em_mean_ll"][0]
        return {"weights": g.weights, "means": g.means, "covariances": g.covariances,
                "mean_ll": np.asarray(lls)}

    ext8 = DeepConvFeature("vgg16", image_size=224, dtype=torch.bfloat16, int8=True, mesh=data,
                           device=DEV if data is None else None)
    vlad = VLADEncoder(ext8, kmeans_model=KMeansCodebook(centers))
    fv = FisherVectorEncoder(ext8, weights=GMMWeights.OXFORD102_K256_VGG16_PCA)
    listed = list(inp["images"])
    vlad.encode(listed[:8])  # warm the trunk's kernels and cuDNN's choices
    fv.encode(listed[:8])

    def cluster_vlad_step():
        if clu is None:  # the plain aggregation (the sharded blocks' arithmetic)
            v = aggregate.vlad_aggregate_reference(desc, torch.ones(B, N, device=DEV),
                                                   centers)
            return lp_normalize(v, dim=-1).reshape(B, -1)
        return par.cluster_sharded_vlad_encode(desc, None, centers, clu)

    def cluster_fisher_step():
        d = x_pca.view(B, N, D_PCA)
        if clu is None:
            return fisher_encode_batch(d, None, fv_gmm)
        return par.cluster_sharded_fisher_encode(d, None, fv_gmm, clu)

    def sift_step():
        if data is None:
            return sift.sift_batch(list(inp["grays"]), run_on=DEV)
        return par.sharded_sift_batch(list(inp["grays"]), data)

    gallery, queries = mesh_gallery()
    paths = [str(i) for i in range(SERVE_ROWS)]
    indexes = {}

    def index_step(quantize):
        index = RetrievalIndex(gallery, paths, quantize=quantize, mesh=data,
                               device=DEV if data is None else None)
        indexes[quantize] = index
        return mesh_index_answers(index, queries)

    images, labels = torch.from_numpy(inp["train_x"]).to(DEV), torch.from_numpy(inp["train_y"])

    def train_step(mesh):
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            t0 = time.perf_counter()
            state, step = trainer(mesh)
            times, losses = [time.perf_counter() - t0], []
            for _ in range(MESH_TRAIN_STEPS):
                t0 = time.perf_counter()
                losses.append(float(step(state, images, labels)[1]))
                times.append(time.perf_counter() - t0)
        finally:
            torch.backends.cudnn.deterministic = saved
        return {"losses": np.asarray(losses), "seconds": np.asarray(times)}

    res["kmeans"] = run("kmeans", kmeans_step)
    res["pca"] = run("pca", pca_step)
    res["gmm"] = run("gmm", gmm_step)
    res["vlad_encoder"] = run("vlad_encoder", lambda: vlad.encode(listed))
    res["fv_encoder"] = run("fv_encoder", lambda: fv.encode(listed))
    res["cluster_vlad"] = run("cluster_vlad", cluster_vlad_step)
    res["cluster_fisher"] = run("cluster_fisher", cluster_fisher_step)
    res["sift"] = dict(zip(("desc", "mask"), run("sift", sift_step)))
    res["index_f32"] = run("index_f32", lambda: index_step(None))
    res["index_int8"] = run("index_int8", lambda: index_step("int8"))
    res["train_dp"] = run("train_dp", lambda: train_step(data))
    if meshes["model"] is not None:
        res["train_tp"] = run("train_tp", lambda: train_step(meshes["model"]))
    else:
        # cuDNN's bf16 convs round otherwise at another batch size
        # (int8_batch_probe), so a rank's encodings are held bit for bit
        # against the single card's of the same block.
        half = len(listed) // 2
        for name, enc in (("vlad_encoder", vlad), ("fv_encoder", fv)):
            res[f"{name}_halves"] = np.concatenate([enc.encode(listed[:half]),
                                                    enc.encode(listed[half:])])
    timing = mesh_timing(x, x_pca, init, fv_gmm, data, indexes, queries)
    del gallery, indexes
    torch.cuda.empty_cache()
    return {k: to_numpy(v) for k, v in res.items()}, timing


def to_numpy(v):
    if isinstance(v, dict):
        return {k: to_numpy(t) for k, t in v.items()}
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def mesh_timing(x, x_pca, centers, gmm_model, data, indexes, queries) -> dict:
    """Kernels 3 and 2 on the rows this rank holds (all of them on the
    single card) and a Q=1 query of each index, per rank."""
    from pyvisim_tpu_torch.ops.cuda import gmm_stats, lloyd_stats

    if data is not None:
        from pyvisim_tpu_torch.parallel.mesh import data_sharding

        x = data_sharding(data, 2).shard(x)
        x_pca = data_sharding(data, 2).shard(x_pca)
    ones = torch.ones(x.shape[0], device=DEV)
    params = tuple(t.contiguous() for t in (gmm_model.weights, gmm_model.means,
                                            gmm_model.covariances))
    n0 = (lloyd_stats.lloyd_stats.launches, gmm_stats.gmm_stats_batched.launches)
    out = {
        "rows": x.shape[0],
        "lloyd_kernel_ms": cuda_ms(lambda: lloyd_stats.lloyd_stats(x, ones, centers)),
        "em_kernel_ms": cuda_ms(lambda: gmm_stats.gmm_stats_batched(
            x_pca[None], ones[None], *params, with_ll=True)),
        "query_q1_ms": {q or "f32": mesh_query_ms(ix, queries) for q, ix in indexes.items()},
    }
    lloyd_stats.lloyd_stats.launches, gmm_stats.gmm_stats_batched.launches = n0
    return out


def mesh_job(path: str) -> dict:
    """One rank's part of phase 12, run in every rank of a world: every
    step on this world's meshes ('data' = the world, 'data' x 'cluster' and
    'data' x 'model' = 1 x the world). Rank 0 writes the results beside the
    inputs; every rank returns its seconds, launches, staged bytes and
    kernel times."""
    import torch.distributed as dist

    from pyvisim_tpu_torch import parallel as par

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, n = dist.get_rank(), dist.get_world_size()
    with np.load(path) as f:
        inp = {k: f[k] for k in f.files}
    meshes = {"data": par.make_mesh(device_type=DEV),
              "cluster": par.make_mesh(n, ("data", "cluster"), (1, n), device_type=DEV),
              "model": par.make_mesh(n, ("data", "model"), (1, n), device_type=DEV)}

    def trainer(mesh):
        _, state, step = par.make_sharded_trainer(
            mesh, cfg_name="vgg16", embed_dim=128, image_size=TRAIN_SIZE,
            learning_rate=MESH_TRAIN_LR, loss="nt_xent")
        return state, step

    checks = MeshPathChecks()
    checks.install()
    try:
        steps = MeshSteps(checks)
        res, timing = mesh_steps(steps.run, inp, meshes, trainer)
    finally:
        checks.remove()
    out = {"rank": rank, "device": str(torch.cuda.current_device()),
           "backend": dist.get_backend(), "seconds": steps.seconds,
           "launches": steps.launches, "staged_bytes": steps.staged, "timing": timing,
           "on_path_checks": checks.records, "on_path_check_seconds": checks.seconds}
    if rank == 0:
        out["results"] = str(pathlib.Path(path).with_name(f"results_{n}.npz"))
        np.savez(out["results"], **{f"{s}__{k}": v for s, r in res.items()
                                    for k, v in (r.items() if isinstance(r, dict)
                                                 else [("out", r)])})
    return out


def int8_batch_probe(images: np.ndarray) -> dict:
    """The mesh encoders' int8 VGG16 trunk on all images at once and on
    its two halves, layer by layer: each layer on the same input at both
    batch sizes (isolated) and the two trunks carried through (cascade).
    Kernels 7 and 8 and the int8 convs are held bit for bit, cuDNN's bf16
    convs within one bf16 step of the layer's largest output (cuDNN chooses
    its algorithm by shape), each beside a float32 conv of the same input
    (the share of outputs farther from it than their own rounding). Returns
    each layer's readings and the images whose descriptors differ."""
    from pyvisim_tpu_torch.features import DeepConvFeature

    ext = DeepConvFeature("vgg16", image_size=224, dtype=torch.bfloat16, int8=True, device=DEV)
    x = ext._preprocess(torch.from_numpy(images).to(DEV)).permute(0, 3, 1, 2)
    half = len(images) // 2
    parts, layers = [x[:half], x[half:]], []

    def reading(a, b):
        diff = (a.float() - b.float()).abs()
        rows = diff.flatten(1).amax(1) > 0
        return {"max_abs": float(diff.max()),
                "bf16_steps_of_largest": float(diff.max() / bf16_ulp(b.float().abs().max())),
                "share": float((diff > 0).float().mean()), "images": int(rows.sum())}, rows

    with torch.inference_mode():
        for i, m in enumerate(ext.model.features):
            if isinstance(m, torch.nn.Identity):
                continue
            route = {"int8_k8": "kernel 8", "k7": "kernel 7", "cudnn": "cudnn bf16"}[m.route(x)]
            out = m(x)
            halves = torch.cat([m(x[:half]), m(x[half:])])
            isolated, _ = reading(halves, out)
            parts = [m(t) for t in parts]
            cascade, rows = reading(torch.cat(parts), out)
            rec = {"layer": i, "route": route, "input": list(x.shape[1:]), "isolated": isolated,
                   "cascade": cascade}
            if route == "cudnn bf16":
                with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                    f32 = torch.relu(F.conv2d(x.float(), m.w_x.permute(0, 3, 1, 2).float(),
                                              m.bias_x.float(), padding=1))
                # Beyond rounding: elements farther from the float32 conv
                # than half a bf16 step of their own value.
                half_step = 0.5 * bf16_ulp(f32.abs())
                rec["from_float32"] = {
                    n: {"max_abs": float((y.float() - f32).abs().max()),
                        "share_beyond_rounding": float(
                            ((y.float() - f32).abs() > half_step * 1.001).float().mean())}
                    for n, y in ((len(images), out), (half, halves))}
                del f32, half_step
            layers.append(rec)
            limit = 1.0 if route == "cudnn bf16" else 0.0
            check(isolated["bf16_steps_of_largest"] <= limit,
                  f"int8 trunk layer {i} ({route}) at batch {half} against {len(images)}: "
                  f"{isolated}")
            x = out
    first = next((r for r in layers if r["isolated"]["images"]), None)
    log(f"int8 trunk, batch {half} against {len(images)}: first layer that differs on the same "
        f"input {first}; " + ", ".join(f"{r['layer']} {r['route']} {r['cascade']['images']} "
                                       f"images" for r in layers))
    return {"layers": layers, "first_differing": first,
            "images_differing": np.nonzero(rows.cpu().numpy())[0].tolist()}


def mesh_rows_cos(got: np.ndarray, want: np.ndarray) -> float:
    """The worst 1 - cosine of two encodings' rows, in float64."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    dot = (g * w).sum(1)
    norms = np.linalg.norm(g, axis=1) * np.linalg.norm(w, axis=1)
    return float(np.max(1.0 - np.where(norms > 0, dot / np.maximum(norms, 1e-300), 1.0)))


def mesh_encodings_gate(what, got, want, skip=()) -> dict:
    """Encodings within 1e-5 with 1 - cosine <= 1e-6 per row (rows in
    ``skip`` excused); bit for bit or not, said."""
    keep = np.setdiff1d(np.arange(len(want)), np.asarray(skip, np.int64))
    check(got.shape == want.shape, f"{what}: shape {got.shape} against {want.shape}")
    err = float(np.abs(got[keep] - want[keep]).max())
    cos = mesh_rows_cos(got[keep], want[keep])
    check(err <= 1e-5 and cos <= 1e-6, f"{what}: max|diff| {err:.3e}, 1 - cos {cos:.3e}")
    return {"max_abs_err": err, "one_minus_cos": cos, "bit_equal": bool(np.array_equal(got, want)),
            "rows_excused": len(want) - len(keep)}


def near_tie_rows(x: torch.Tensor, centers: torch.Tensor, rel: float) -> torch.Tensor:
    """Rows whose two nearest centers are within ``rel * (|x|^2 + |c|^2)``
    of each other in float64: where f32 distances of another summation
    order may pick either."""
    xd, cd = x.double(), centers.double()
    d2 = torch.cdist(xd, cd) ** 2
    two = torch.topk(d2, 2, dim=1, largest=False)
    slack = rel * ((xd**2).sum(1) + (cd[two.indices[:, 0]] ** 2).sum(1))
    return (two.values[:, 1] - two.values[:, 0]) <= slack


def mesh_kmeans_gate(n, ref, got, x) -> dict:
    steps_ref, steps_got = ref["inertia"], got["inertia"]
    c_ref, c_got = ref["centers"], got["centers"]
    if n == 1:
        check(np.array_equal(c_got, c_ref) and np.array_equal(steps_got, steps_ref),
              "mesh kmeans on one rank is not kmeans_fit bit for bit")
        return {"bit_equal": True}
    inertia_rel = float(np.max(np.abs(steps_got - steps_ref) / np.abs(steps_ref)))
    check(inertia_rel <= 1e-5, f"mesh kmeans inertia off by rel {inertia_rel:.3e}")
    # Rows that change cluster between the two fits must be near ties, and
    # only their clusters may move by more than the sums' rounding.
    cr, cg = torch.from_numpy(c_ref).to(DEV), torch.from_numpy(c_got).to(DEV)
    lr = torch.cdist(x.double(), cr.double()).argmin(1)
    lg = torch.cdist(x.double(), cg.double()).argmin(1)
    moved = lr != lg
    tie = near_tie_rows(x[moved], cr, 1e-4)
    check(bool(tie.all()), f"mesh kmeans: {int((~tie).sum())} rows changed cluster off a tie")
    touched = set(lr[moved].tolist()) | set(lg[moved].tolist())
    tol = 1e-4 * float(np.abs(c_ref).max()) + 1e-5
    off = set(np.nonzero(np.abs(c_got - c_ref).max(1) > tol)[0].tolist())
    check(off <= touched, f"mesh kmeans: clusters {sorted(off - touched)} off by more than {tol}")
    keep = [i for i in range(K) if i not in touched]
    err = float(np.abs(c_got[keep] - c_ref[keep]).max())
    return {"inertia_max_rel": inertia_rel, "centers_max_abs_err": err,
            "rows_changed_cluster": int(moved.sum()), "clusters_excused": len(touched)}


def mesh_pca_gate(ref, got) -> dict:
    """Mean to 1e-5 * max|mean|; explained variance to 1e-4 of the largest;
    each leading component whose variance stands 1 % apart from its
    neighbours' at |cos| >= 1 - 1e-4 (others are not determined)."""
    mean_err = float(np.abs(got["mean"] - ref["mean"]).max())
    check(mean_err <= 1e-5 * float(np.abs(ref["mean"]).max()) + 1e-7,
          f"mesh PCA mean off by {mean_err}")
    var = ref["var"].astype(np.float64)
    var_err = float(np.abs(got["var"] - ref["var"]).max() / var.max())
    check(var_err <= 1e-4, f"mesh PCA variances off by {var_err} of the largest")
    gaps = np.abs(np.diff(var)) / var.max()
    clear = [i for i in range(len(var))
             if (i == 0 or gaps[i - 1] > 1e-2) and (i == len(var) - 1 or gaps[i] > 1e-2)]
    cos = np.abs((got["components"][clear].astype(np.float64)
                  * ref["components"][clear]).sum(1))
    check(bool((cos >= 1 - 1e-4).all()), f"mesh PCA: a separated component at cos {cos.min()}")
    return {"mean_max_abs_err": mean_err, "var_max_rel": var_err, "separated_components": len(clear),
            "worst_cos": float(cos.min()) if clear else None,
            "bit_equal_mean": bool(np.array_equal(got["mean"], ref["mean"]))}


def mesh_gmm_gate(n, ref, got) -> dict:
    names = ("weights", "means", "covariances", "mean_ll")
    if n == 1:
        check(all(np.array_equal(got[k], ref[k]) for k in names),
              "mesh GMM on one rank is not the single card's EM bit for bit")
        return {"bit_equal": True}
    # A covariance is s2/nk - mean^2: the sums' rounding scales with the raw
    # second moment s2/nk, so that is the covariances' scale here.
    scale = {"weights": np.abs(ref["weights"]).max(), "means": np.abs(ref["means"]).max(),
             "covariances": (ref["covariances"] + ref["means"].astype(np.float64) ** 2).max()}
    errs = {k: float(np.abs(got[k] - ref[k]).max() / scale[k]) for k in names[:3]}
    ll_rel = float(np.max(np.abs(got["mean_ll"] - ref["mean_ll"]) / np.abs(ref["mean_ll"])))
    check(all(e <= 1e-4 for e in errs.values()), f"mesh GMM parameters off: {errs}")
    check(ll_rel <= 1e-5, f"mesh GMM mean log-likelihood off by rel {ll_rel}")
    cov_rel = float(np.abs(got["covariances"] - ref["covariances"]).max()
                    / np.abs(ref["covariances"]).max())
    return {"max_err_of_scale": errs, "covariances_max_rel_of_largest": cov_rel,
            "mean_ll_max_rel": ll_rel}


# The two-rank encodes against one encode of all 128 images: (max|diff|,
# 1 - cos) limits, 2.4x and 2.6x VLAD's gap and 9x and 5.5x FV's as the card
# measured them (0.209 and 3.85e-3; 5.4e-5 and 1.8e-9). They come from
# cuDNN's bf16 conv5 rounding otherwise at 64 images (int8_batch_probe),
# which VLAD's hard assignment turns into a descriptor moved to another
# center, and for FV also from the PCA product, which cuBLAS computes by
# the batch's shape: so only VLAD's rows are held to the images whose
# descriptors moved.
MESH_ONE_ENCODE_LIMITS = {"vlad_encoder": (0.5, 1e-2), "fv_encoder": (5e-4, 1e-8)}


def mesh_gates(n, ref, got, x, desc, centers, batch_probe) -> dict:
    """Phase 12's gates for a world of ``n`` ranks against the single card;
    ``batch_probe`` is ``int8_batch_probe``'s record."""
    gates = {"kmeans": mesh_kmeans_gate(n, ref["kmeans"], got["kmeans"], x),
             "pca": mesh_pca_gate(ref["pca"], got["pca"]),
             "gmm": mesh_gmm_gate(n, ref["gmm"], got["gmm"])}
    for name in ("vlad_encoder", "fv_encoder"):
        # Each rank's block against the single card's encode of that block,
        # and against one encode of all 128 within MESH_ONE_ENCODE_LIMITS.
        blocks = ref[name] if n == 1 else ref[f"{name}_halves"]
        gates[name] = mesh_encodings_gate(f"mesh {name}", got[name], blocks)
        if n == 1:
            check(gates[name]["bit_equal"], f"mesh {name} on one rank is not bit for bit")
        rows = np.nonzero((got[name] != ref[name]).any(1))[0].tolist()
        one = {"max_abs_err": float(np.abs(got[name] - ref[name]).max()),
               "one_minus_cos": mesh_rows_cos(got[name], ref[name]), "rows_differing": rows}
        limit_abs, limit_cos = MESH_ONE_ENCODE_LIMITS[name]
        check(name != "vlad_encoder" or set(rows) <= set(batch_probe["images_differing"]),
              f"mesh {name}: rows {rows} differ from one encode of all, not only the images "
              f"whose descriptors the batch size moved {batch_probe['images_differing']}")
        check(one["max_abs_err"] <= limit_abs and one["one_minus_cos"] <= limit_cos,
              f"mesh {name} against one encode of all: {one}, limits {limit_abs}, {limit_cos}")
        gates[name]["against_one_encode_of_all"] = one
    # The cluster-sharded VLAD against the plain aggregation; where they
    # differ, only images with a descriptor near a tie between two centers
    # may (the two compute distances in products of other shapes).
    skip = ()
    if not np.array_equal(got["cluster_vlad"], ref["cluster_vlad"]):
        ties = near_tie_rows(desc.reshape(-1, D), centers, 1e-5).view(B, N).any(1)
        skip = np.nonzero(ties.cpu().numpy())[0]
    gates["cluster_vlad"] = mesh_encodings_gate("mesh cluster VLAD", got["cluster_vlad"],
                                                ref["cluster_vlad"], skip)
    gates["cluster_fisher"] = mesh_encodings_gate("mesh cluster FV", got["cluster_fisher"],
                                                  ref["cluster_fisher"])
    check(all(np.array_equal(got["sift"][k], ref["sift"][k]) for k in ("desc", "mask")),
          "mesh SIFT descriptors or masks differ from the single card's")
    gates["sift"] = {"bit_equal": True}
    for name in ("index_f32", "index_int8"):
        r, g = ref[name], got[name]
        for q in (1, MESH_Q):
            check(np.array_equal(g[f"q{q}_ids"], r[f"q{q}_ids"]),
                  f"mesh {name} Q={q}: ids {g[f'q{q}_ids'].tolist()} against "
                  f"{r[f'q{q}_ids'].tolist()}")
        err = max(float(np.abs(g[f"q{q}_scores"] - r[f"q{q}_scores"]).max()) for q in (1, MESH_Q))
        check(err <= 1e-6, f"mesh {name} scores off by {err}")
        gates[name] = {"ids_equal": True, "scores_max_abs_err": err}
    dp, tp, single = got["train_dp"]["losses"], got["train_tp"]["losses"], ref["train_dp"]["losses"]
    # Adam's first updates are about lr * sign(g): a gradient entry near 0
    # that the ranks' sums round otherwise moves its parameter by up to
    # 2 * lr, so the trajectories part a little more each step. TP runs the
    # trunk on the whole batch, as the single card does; DP runs it on
    # each rank's block, whose convs may round otherwise.
    rel = lambda a, b: float(np.max(np.abs(a - b) / np.abs(b)))
    dp_rel, tp_single_rel = rel(dp, single), rel(tp, single)
    tp_rel, tp_rel_two = rel(tp, dp), rel(tp[:2], dp[:2])
    check(dp_rel <= (1e-5 if n == 1 else 1e-4), f"mesh DP losses {dp} against {single}")
    check(tp_single_rel <= 1e-5, f"mesh TP losses {tp} against the single card's {single}")
    check(tp_rel_two <= 1e-5 and tp_rel <= 1e-4,
          f"mesh TP losses {tp} against the DP steps' {dp}")
    if n == 1:
        check(dp[0] == single[0], "mesh DP first loss on one rank is not the single card's")
    gates["train"] = {"dp_max_rel": dp_rel, "tp_vs_single_max_rel": tp_single_rel,
                      "tp_vs_dp_max_rel": tp_rel, "tp_vs_dp_first_two_max_rel": tp_rel_two,
                      "dp_bit_equal": bool(np.array_equal(dp, single)),
                      "losses": {"single": single.tolist(), "dp": dp.tolist(), "tp": tp.tolist()},
                      "build_then_step_seconds": {
                          "single": ref["train_dp"]["seconds"].tolist(),
                          "dp": got["train_dp"]["seconds"].tolist(),
                          "tp": got["train_tp"]["seconds"].tolist()}}
    return gates


def mesh_results(path: str) -> dict:
    out = {}
    with np.load(path) as f:
        for key in f.files:
            step, name = key.split("__")
            if name == "out":
                out[step] = f[key]
            else:
                out.setdefault(step, {})[name] = f[key]
    return out


def phase_mesh(smi: str, ext, centers, images):
    """Phase 12: the mesh paths in a world of one rank under NCCL and one of
    two ranks sharing the card under gloo, against the single card."""
    from pyvisim_tpu_torch.models import siamese as S
    from pyvisim_tpu_torch.ops.kmeans import _seed_centers
    from pyvisim_tpu_torch.parallel.local import LocalWorld

    t_phase = time.perf_counter()
    batch_probe = int8_batch_probe(images)
    desc = ext.extract_batch(images)[0].to(torch.float32)
    x = desc.reshape(-1, D).contiguous()
    init = _seed_centers(torch.Generator(device=DEV).manual_seed(0), x,
                         torch.ones(N_TRAIN, device=DEV), K, 65536)
    train_x, train_y = mesh_train_batch()
    inp = {"x": x.cpu().numpy(), "init": init.cpu().numpy(), "centers": centers,
           "images": images, "grays": sift_gray_batch(SIFT_IMAGES, seed=0)[1],
           "train_x": train_x, "train_y": train_y}

    def single_trainer(mesh):
        model = S.SiameseEmbedder("vgg16", embed_dim=128)
        opt = S.adamw(MESH_TRAIN_LR)
        return (S.create_train_state(model, opt, seed=0, device=DEV),
                S.train_step(model, opt, loss="nt_xent"))

    steps = MeshSteps()
    ref, ref_timing = mesh_steps(steps.run, inp, dict.fromkeys(("data", "cluster", "model")),
                                 single_trainer)
    numbers = {"single": {"seconds": steps.seconds, "launches": steps.launches,
                          "timing": ref_timing}, "int8_batch_probe": batch_probe}
    log(f"mesh single card ({smi}): " + ", ".join(f"{k} {v:.3f} s"
                                                  for k, v in steps.seconds.items()))
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="pyvisim_mesh_")
    try:
        path = os.path.join(tmp, "inputs.npz")
        np.savez(path, **inp)
        for name, n, backend in MESH_WORLDS:
            t0 = time.perf_counter()
            with LocalWorld(n, backend, DEV, threads=None, timeout_s=600) as world:
                outs = world.run(mesh_job, path)
            world_s = time.perf_counter() - t0
            got = mesh_results(outs[0]["results"])
            gates = mesh_gates(n, ref, got, x, desc, torch.from_numpy(centers).to(DEV),
                               batch_probe)
            for o in outs:
                checked = {r["kernel"] for r in o["on_path_checks"]}
                check(checked == MESH_CHECKED, f"mesh {name} rank {o['rank']}: kernels held "
                      f"against their plain versions on the path {sorted(checked)}")
                em = [r for r in o["on_path_checks"] if "ll_rel_err" in r]
                check(em and len(em) < sum(r["kernel"] == "gmm_stats" for r in o["on_path_checks"]),
                      f"mesh {name} rank {o['rank']}: kernel 2 not checked in both forms")
                log(f"mesh {name} rank {o['rank']}: {len(o['on_path_checks'])} kernel calls held "
                    f"against their plain versions on the path ("
                    f"{o['on_path_check_seconds']:.1f} s): " + json.dumps(
                        [{k: r[k] for k in ("step", "kernel", "input", "max_abs_err")}
                         for r in o["on_path_checks"]]))
                per_rank = {k: sum(o["launches"][s].get(k, 0) for s in o["launches"])
                            for k in mesh_wrappers()}
                check(all(per_rank.values()), f"mesh {name} rank {o['rank']} did not launch "
                      f"every kernel: {per_rank}")
                if n == 1:  # the cluster-sharded blocks are plain torch, as in JAX
                    for s in MESH_STEPS[:5] + MESH_STEPS[7:-1]:
                        check(o["launches"][s] == steps.launches[s],
                              f"mesh {name} {s}: launches {o['launches'][s]} against the "
                              f"single card's {steps.launches[s]}")
                o["launches_total"] = per_rank
                log(f"mesh {name} rank {o['rank']} ({o['backend']}, cuda:{o['device']}, "
                    f"{smi}): " + ", ".join(f"{s} {o['seconds'][s]:.3f} s "
                                            f"({o['staged_bytes'][s]} B staged)"
                                            for s in MESH_STEPS))
                t = o["timing"]
                log(f"mesh {name} rank {o['rank']} ({smi}): Lloyd kernel {t['lloyd_kernel_ms']:.4f}"
                    f" ms on {t['rows']} rows (single card {ref_timing['lloyd_kernel_ms']:.4f} ms "
                    f"on {ref_timing['rows']}), EM kernel {t['em_kernel_ms']:.4f} ms (single "
                    f"{ref_timing['em_kernel_ms']:.4f}), Q=1 query ms {t['query_q1_ms']} (single "
                    f"{ref_timing['query_q1_ms']})")
            numbers[name] = {"world_seconds": world_s, "gates": gates,
                             "ranks": [{k: v for k, v in o.items() if k != "results"}
                                       for o in outs]}
            log(f"mesh {name}: world {world_s:.1f} s (spawn, build of nothing, every step)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"mesh": numbers}, default=float))
    return {k: sum(o["launches_total"][k] for w, _, _ in MESH_WORLDS
                   for o in numbers[w]["ranks"]) for k in mesh_wrappers()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # Phase 11's dataset tree. The port reads the variable when it is first
    # imported, so it is set before any import of it.
    flowers_root = pathlib.Path(tempfile.mkdtemp(prefix="pyvisim_flowers_"))
    os.environ["PYVISIM_TPU_TORCH_CACHE_DIR"] = str(flowers_root)
    try:
        return run(flowers_root)
    finally:
        shutil.rmtree(flowers_root, ignore_errors=True)


def run(flowers_root: pathlib.Path) -> int:
    sys.path.insert(0, str(REPO))
    from pyvisim_tpu_torch.ops.cuda import _build
    from pyvisim_tpu_torch.ops.cuda import aggregate as agg
    from pyvisim_tpu_torch.ops.cuda import conv
    from pyvisim_tpu_torch.ops.cuda import gmm_stats as gs
    from pyvisim_tpu_torch.ops.cuda import ingest
    from pyvisim_tpu_torch.ops.cuda import int8_epilogue as epi
    from pyvisim_tpu_torch.ops.cuda import lloyd_stats as ls
    from pyvisim_tpu_torch.ops.cuda import sift_window as sw
    from pyvisim_tpu_torch.models import vit
    from pyvisim_tpu_torch.ops.cuda import vit_passes as vp

    t0 = time.perf_counter()
    smi = phase_environment(_build)
    kernel = phase_kernel(agg, ls)
    vlad_rootsift_call, gmm_rootsift_call = rootsift_encode_calls()
    kernel["rootsift_vlad"] = check_vlad_rootsift(agg, ls, vlad_rootsift_call)
    gmm_kernel = phase_gmm_kernel(gs, shipped_gmm(), gmm_rootsift_call)
    golden = golden_fixture_gate(agg, gs)
    kernel["golden_max_abs_err"] = {k: v for k, v in golden.items() if k.startswith("vlad")}
    gmm_kernel["golden_max_abs_err"] = {k: v for k, v in golden.items() if k.startswith("fisher")}
    del vlad_rootsift_call, gmm_rootsift_call
    lloyd_kernel = phase_lloyd_kernel(ls)
    sift_kernels = phase_sift_kernels(sw)
    ingest_kernel = phase_ingest(ingest)
    epilogue_kernel = phase_int8_epilogue(conv, epi)
    vit_kernels = phase_vit_passes(vp)
    torch.cuda.empty_cache()
    rope_kernel = phase_dinov3_passes(vp, vit)
    torch.cuda.empty_cache()
    conv_kernels = phase_conv_kernels(conv)
    launches, encode_launches, centers, ext, images = phase_slice(agg)
    kernel["launches"] = launches
    kernel["launches_per_encode_of_128"] = encode_launches
    launches2, numbers2 = phase_slice2((agg, gs, ls), ext, centers, images)
    kernel["launches_slice2"] = launches2["vlad"]
    gmm_kernel["launches"] = launches2["gmm_stats"]
    gmm_kernel["launches_per_pipeline_encode_of_128"] = (
        numbers2["pipeline_launches_per_encode"]["gmm_stats"])
    gmm_kernel["launches_per_learn"] = numbers2["learn"]["pca_gmm"]["em_iterations"]
    lloyd_kernel["launches"] = launches2["lloyd_stats"]
    lloyd_kernel["launches_per_learn"] = {
        name: rec["lloyd_iterations"] for name, rec in numbers2["learn"].items()}
    phase_f32_crosscheck(centers)
    launches3, numbers3 = phase_slice3(sw, agg, gs)
    for rec in sift_kernels:
        rec["launches"] = launches3[rec["name"]]
        rec["launches_per_vlad_encode_of_64"] = numbers3["launches_per_vlad_encode_of_64"][rec["name"]]
    kernel["launches_slice3"] = launches3["vlad"]
    ingest_kernel["launches"] = launches3["ingest_gray_letterbox"]
    ingest_kernel["launches_per_vlad_encode_of_64"] = (
        numbers3["launches_per_vlad_encode_of_64"]["ingest_gray_letterbox"])
    gmm_kernel["launches_slice3"] = launches3["gmm_stats"]
    launches4, numbers4, enc8 = phase_slice4(conv, agg, ext, centers, images)
    k7, k8 = conv_kernels
    per_encode = numbers4["launches_per_encode_of_128"]
    k7["launches"] = launches4["k7"]
    k7["launches_per_encode_of_128"] = per_encode["k7"]
    k8["launches"] = launches4["k8_pooled"] + launches4["k8_unpooled"]
    k8["launches_pooled"], k8["launches_unpooled"] = launches4["k8_pooled"], launches4["k8_unpooled"]
    k8["launches_per_encode_of_128"] = per_encode["k8_pooled"] + per_encode["k8_unpooled"]
    kernel["launches_slice4"] = launches4["vlad"]
    launches8, numbers8 = phase_serving(conv, agg, enc8)
    for rec in (kernel, k7, k8):
        rec["max_abs_err_serving_path"] = numbers8["on_path_max_abs_err"][rec["name"]]
        rec["serving_path_batches_checked"] = numbers8["on_path_batches"]
    kernel["launches_serving"] = launches8["vlad"]
    k7["launches_serving"] = launches8["k7"]
    k8["launches_serving"] = launches8["k8_pooled"] + launches8["k8_unpooled"]
    phase_siamese()
    torch.cuda.empty_cache()
    launches10, numbers10 = phase_resnet(conv, agg, ls, images)
    kernel["launches_resnet50"] = launches10["vlad"]
    kernel["resnet50"] = numbers10["kernels"]["vlad_aggregate"]
    lloyd_kernel["launches_resnet50_learn"] = launches10["lloyd"]
    lloyd_kernel["resnet50"] = numbers10["kernels"]["lloyd_stats"]
    k8["launches_resnet50"] = launches10["k8"]
    k8["launches_per_resnet50_int8_encode_of_128"] = R50_K8
    k8["resnet50_calls"] = {key: rec for key, rec in numbers10["int8_routes"].items()
                            if key.startswith("k8")}
    epilogue_kernel["launches"] = launches10["epilogue"]
    epilogue_kernel["launches_per_resnet50_int8_encode_of_128"] = R50_GEMM
    epilogue_kernel["resnet50_bf16_calls"] = {
        key: rec for key, rec in numbers10["int8_bf16_routes"].items() if key.startswith("gemm")}
    torch.cuda.empty_cache()
    launches11, numbers11 = phase_flowers(conv, agg, ls, enc8, flowers_root)
    lloyd_kernel["launches_clustering"] = launches11["lloyd"]
    lloyd_kernel["flowers102"] = numbers11["kernel3"]
    kernel["launches_flowers102"] = launches11["vlad"]
    k7["launches_flowers102"] = launches11["k7"]
    k8["launches_flowers102"] = launches11["k8_pooled"] + launches11["k8_unpooled"]
    torch.cuda.empty_cache()
    launches12 = phase_mesh(smi, ext, centers, images)
    for rec in (kernel, gmm_kernel, lloyd_kernel, *sift_kernels, k7, k8):
        rec["launches_parallel"] = launches12[rec["name"]]
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kernel, gmm_kernel, lloyd_kernel, *sift_kernels, k7, k8,
                                  ingest_kernel, epilogue_kernel, vit_kernels,
                                  rope_kernel]}))
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
