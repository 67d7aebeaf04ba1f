// Fused 3x3 convolution + bias + ReLU (+ 2x2 max-pool) for Hopper (sm_90a):
// the VGG block boundary in float32, bfloat16 and int8.
//
// Replaces the TPU kernels of pyvisim_tpu/ops/pallas/conv.py:
//   conv3x3_relu_maxpool / _fused_kernel (conv.py:157)       -> conv_pool_f32, conv_pool_bf16
//   conv3x3_relu_maxpool_q8 / _fused_kernel_q8 (conv.py:301) -> conv_q8 (pooled, or not)
// For x (B, H, W, Cin) NHWC, weights (Cout, 3, 3, Cin) (torch's OIHW in
// channels-last order: contiguous over the 9*Cin reduction) and an f32 bias:
//   float: y = maxpool2x2(relu(conv_same(x, w) + b))        f32 accumulation
//   int8:  xq  = clamp(rint(x / sx[b]), -127, 127)           per-image sx, IEEE division
//          acc = conv_same(xq, wq)                           int32, exact
//          y   = relu(float(acc) * (sx[b] * sw[c]) + b[c])   then the 2x2 max if POOL
// The pool floors odd H and W, as torch's MaxPool2d(2, 2) does. The result is
// rounded once, to x's dtype. ReLU and the 2x2 max carry NaN, as torch.relu,
// F.max_pool2d and jnp.maximum do (max_nan, device_utils.cuh), and so does kernel 8's
// amax: an image holding a NaN gets a NaN scale and NaN outputs, as its
// plain version and the JAX package give.
//
// Bound. Per 128 images at 224^2 (VGG16): conv1 and conv3 are 473.5 GFLOP
// each, 0.48 ms at 989 TFLOP/s bf16, against 1.03 and 0.51 GB of activations
// in and out (0.31 and 0.15 ms at 3.35 TB/s), so operations bound both. The
// int8 convs are 473.5 GOP (conv5, 6, 8, 9) or 236.8 GOP (conv4, 7), 0.24 and
// 0.12 ms at 1,979 TOP/s. The f32 instance is bound by 67 TFLOP/s on the CUDA
// cores. chip_smoke.py recomputes these from the shapes it runs.
//
// Design. An implicit GEMM over NHWC (M = conv outputs, N = Cout, K = 9*Cin),
// without the TPU kernel's im2col scratch, whose shifted VMEM copies were what
// made it lose to XLA's conv on the TPU (conv.py:26-36).
//
// Kernel 7 in bf16 and kernel 8 are one kernel, conv_wgmma_kernel, on
// Hopper's warpgroup MMA:
//   kernel 8: wgmma.mma_async m64n64k32 s8, int32 sums, exact in any order,
//             so the kernel equals its plain version bit for bit; a 32x8 tile;
//   kernel 7: wgmma.mma_async m64n64k16 bf16 (products exact, sums f32); a
//             32x8 tile, or 16x16 where that pads the image less: at 224^2
//             (conv1) neither pads and 32x8 was 6 % faster, at 112^2 (conv3)
//             32-row tiles waste 12.5 % and 16x16 was 5 % faster
//             (conv_probe.py, NVIDIA H100 80GB HBM3, 700 W).
// A block of two warpgroups owns a tile of 256 conv outputs and 64 output
// channels; each warpgroup computes two 64-pixel sub-tiles of 8 rows x 8
// columns, and two blocks share an SM, so that one's epilogue overlaps the
// other's wgmmas (a 128-channel tile on one block per SM was 10-20 % slower
// for kernel 8). Both operands are K-major in shared memory, without swizzle:
//   A, the halo of x, is staged channel-blocked, [block of 16 bytes of
//     channels][halo rows][halo columns][16 bytes], by one TMA load per block
//     (a 4-D tensor map over NHWC whose out-of-bounds zero fill is the SAME
//     padding). For every tap (dy, dx) the 8 pixels of a conv row are then
//     one contiguous 128-byte core matrix, the next conv row is one halo row
//     further (the descriptor's stride offset) and the next 16 bytes of
//     channels one block further (its leading offset): each of the 9 taps is
//     one descriptor on the same staged tile.
//   B, the weights, come packed as [block][tap][Cout][16 bytes]
//     (ops/cuda/conv.py:pack_q8_weights, pack_bf16_weights), so that one bulk
//     copy stages a chunk's (2 blocks x 9 taps x 64 x 16 bytes) in the layout
//     wgmma reads.
// Chunks of two blocks (32 int8 or 16 bf16 channels: one k-step per tap)
// flow through a ring of 3 stages: thread 0 keeps the next two chunks' loads
// in flight on each stage's mbarrier while the warpgroups run the current
// chunk's 9 x 2 wgmmas; a stage is refilled once both warpgroups' wgmmas on
// it have retired. The epilogue works in registers: kernel 8 dequantises,
// __fmul_rn(__int2float_rn(acc), __fmul_rn(sx[b], sw[n])); both add the bias
// with __fadd_rn (explicit round-to-nearest intrinsics, which nvcc cannot
// contract into an FMA) and apply ReLU; the 2x2 max is taken in registers,
// on the accumulators, before those (they are monotone and commute with
// it): a thread holds two vertically adjacent pixels of each accumulator
// fragment and its neighbour lane (lane ^ 4) the next column. The output
// tile is then staged in shared memory and written in 16-byte pieces.
//
// Kernel 8 reads x quantised: a first pass takes each image's max |x| (the
// scale sx = max(amax / 127, 1e-8) is then formed as the plain version forms
// it), a second quantises x once (rounded as IEEE division rounds, rint: half
// to even) into an int8 scratch whose channels are padded with zeros to a
// multiple of 32. (Quantising in each block while staging instead repeats the
// division for every channel tile and every halo: 15x the bound at conv5.)
// Kernel 7 in bf16 reads x as it is; the wrapper pads Cin to a multiple of 16
// only where it is not one.
//
// Kernel 7 in f32 runs on the CUDA cores (TF32 would change results that the
// f32 mode must keep): a block of 256 threads owns a 16x16 tile of conv
// outputs (8x8 pooled ones) and 64 output channels, walks Cin in chunks of 16
// channels staged with cp.async (the 18x18 halo, zero outside the image and
// past Cin, and the matching 64 x 9 x 16 weights), accumulates with FMAs in
// registers and takes the 2x2 max from an epilogue tile in shared memory.

#include <algorithm>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "device_utils.cuh"

namespace {

// ---------------------------------------------------------------------------
// Kernel 7 in f32, on the CUDA cores.
// ---------------------------------------------------------------------------
constexpr int kTile = 16;                                  // conv outputs per tile side
constexpr int kHalo = kTile + 2;                           // staged input rows and columns
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kBlockN = 64;                                // output channels per block
constexpr int kThreads = 256;
constexpr int kChunkBytes = 64;                            // one pixel's staged channels
constexpr int kPixStrideBytes = kChunkBytes + 16;          // 20 words: rows in distinct banks
constexpr int kWStrideBytes = 9 * kChunkBytes + 16;        // 148 words, likewise
constexpr int kHaloBytes = kHaloPix * kPixStrideBytes;     // 25,920
constexpr int kWeightBytes = kBlockN * kWStrideBytes;      // 37,888
constexpr int kEpStride = kBlockN + 8;                     // f32 words per pixel of the epilogue tile
constexpr int kEpBytes = kTile * kTile * kEpStride * 4;    // 73,728
constexpr int kSmemBytes =
    kEpBytes > kHaloBytes + kWeightBytes ? kEpBytes : kHaloBytes + kWeightBytes;
constexpr int kChunk = kChunkBytes / 4;                    // f32 channels per chunk

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stages channels [c0, c0 + kChunk) of the 18x18 halo tile whose corner is
// (oy0 - 1, ox0 - 1) in image b, zero outside the image and past Cin. Pixel
// p's channels start at hs + p * kPixStrideBytes / 4.
__device__ __forceinline__ void stage_halo(const float* __restrict__ x, float* hs, int b, int oy0,
                                           int ox0, int c0, int H, int W, int Cin) {
  constexpr int kGroups = kChunkBytes / 16;
  constexpr int kStride = kPixStrideBytes / 4;
  const bool vec = Cin % 4 == 0;
  for (int u = threadIdx.x; u < kHaloPix * kGroups; u += kThreads) {
    const int pix = u / kGroups, grp = u % kGroups;
    const int iy = oy0 - 1 + pix / kHalo, ix = ox0 - 1 + pix % kHalo;
    const int ci = c0 + grp * 4;
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W && ci < Cin;
    const float* src = inside ? x + ((static_cast<size_t>(b) * H + iy) * W + ix) * Cin + ci : x;
    float* dst = hs + pix * kStride + grp * 4;
    if (vec) {
      cp_async16(dst, src, inside);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float* e = reinterpret_cast<float*>(&v);
      for (int j = 0; inside && j < 4 && ci + j < Cin; ++j) e[j] = src[j];
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

// Stages channels [c0, c0 + kChunk) of the 64 output channels from n0 on:
// ws[n][tap * kChunk + c] for tap = 3 * dy + dx, zero past Cin.
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, float* ws, int n0,
                                              int c0, int Cin) {
  constexpr int kGroups = kChunkBytes / 16;
  constexpr int kStride = kWStrideBytes / 4;
  const bool vec = Cin % 4 == 0;
  for (int u = threadIdx.x; u < kBlockN * 9 * kGroups; u += kThreads) {
    const int row = u / kGroups, grp = u % kGroups;  // row = local n * 9 + tap
    const int ci = c0 + grp * 4;
    const float* src = ci < Cin ? w + (static_cast<size_t>(n0) * 9 + row) * Cin + ci : w;
    float* dst = ws + (row / 9) * kStride + (row % 9) * kChunk + grp * 4;
    if (vec) {
      cp_async16(dst, src, ci < Cin);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float* e = reinterpret_cast<float*>(&v);
      for (int j = 0; j < 4 && ci + j < Cin; ++j) e[j] = src[j];
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

// Eight channels from src as f32: one or two 16-byte loads when vec, else
// the first `left` of them and zeros.
__device__ __forceinline__ void load8(const float* src, int left, bool vec, float (&v)[8]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 c = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < left ? __ldg(src + j) : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, int left, bool vec,
                                      float (&v)[8]) {
  if (vec) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < left ? __bfloat162float(src[j]) : 0.f;
  }
}

// clamp(rint(v / s), -127, 127), the quotient rounded as IEEE division
// rounds it, given inv_s = RN(1 / s) and |v| <= 127 s (s is the image's
// amax / 127). v * inv_s is then within 2e-5 of the quotient, so the two
// round to the same integer unless the quotient lies within 1e-4 of a
// half-integer; those few values take the division, which costs the pass
// twice its time when every value takes it.
__device__ __forceinline__ int8_t quantize(float v, float s, float inv_s) {
  const float q = __fmul_rn(v, inv_s);
  const float r = fabsf(q - floorf(q) - 0.5f) > 1e-4f ? rintf(q) : rintf(__fdiv_rn(v, s));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// amax[b] |= max |x[b]| over the image's per_image elements, as the bits of
// a non-negative float, whose order is that of the ints: atomicMax gives the
// same maximum in any order. A NaN survives the block's maxima (max_nan),
// and fabsf has cleared its sign, so its bits win the atomicMax over every
// number, infinity included. amax must be zero first. Grid: x = blocks per
// image, each striding over it eight elements a thread; y = image.
template <typename Tin>
__global__ void amax_kernel(const Tin* __restrict__ x, int* __restrict__ amax,
                            long long per_image) {
  __shared__ float s_max[kThreads / 32];
  const Tin* xb = x + static_cast<size_t>(blockIdx.y) * per_image;
  const bool vec = per_image % 8 == 0;
  float m = 0.f;
  for (long long e = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 8;
       e < per_image; e += static_cast<long long>(gridDim.x) * kThreads * 8) {
    float v[8];
    load8(xb + e, static_cast<int>(min(8LL, per_image - e)), vec, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = max_nan(m, fabsf(v[j]));
  }
  for (int off = 16; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) s_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max_nan(m, s_max[w]);
    atomicMax(amax + blockIdx.y, __float_as_int(m));
  }
}

// xq (B, H, W, Cp) = clamp(rint(x / sx[image]), -127, 127) for the Cin
// channels of x (B, H, W, Cin), zeros in channels Cin..Cp-1; Cp is a
// multiple of 8, so eight consecutive elements lie in one pixel. Grid: x
// over one image's per_image = H * W * Cp elements, kQuantGroups groups of
// eight a thread (so that each thread has several loads in flight), y =
// image.
constexpr int kQuantGroups = 8;

template <typename Tin>
__global__ void quantize_kernel(const Tin* __restrict__ x, const float* __restrict__ sx,
                                int8_t* __restrict__ xq, int Cin, int Cp, int per_image) {
  const int b = blockIdx.y;
  const float s = sx[b], inv_s = __frcp_rn(s);
  const Tin* xb = x + static_cast<size_t>(b) * (per_image / Cp) * Cin;
  int8_t* qb = xq + static_cast<size_t>(b) * per_image;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * 8 * kQuantGroups;
#pragma unroll
  for (int it = 0; it < kQuantGroups; ++it) {
    const long long e64 = first + (static_cast<long long>(it) * kThreads + threadIdx.x) * 8;
    if (e64 >= per_image) return;
    const int e = static_cast<int>(e64);
    float v[8];
    int c = 0;
    if (Cin == Cp) {
      load8(xb + e, 8, true, v);
    } else {
      const int pix = e / Cp;
      c = e - pix * Cp;
      load8(xb + pix * Cin + c, Cin - c, false, v);
    }
    uint2 q;
    int8_t* qe = reinterpret_cast<int8_t*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) qe[j] = c + j < Cin ? quantize(v[j], s, inv_s) : 0;
    *reinterpret_cast<uint2*>(qb + e) = q;
  }
}

// Walks Cin in chunks: stages one (cp.async) and runs compute(halo,
// weights) on it. Two blocks share an SM, so one's copies overlap the
// other's math; a ring of two stages inside the block would take 128 KB of
// shared memory and leave one block per SM.
template <typename Compute>
__device__ __forceinline__ void run_chunks(const float* __restrict__ x, const float* __restrict__ w,
                                           unsigned char* smem, int b, int oy0, int ox0, int n0,
                                           int H, int W, int Cin, Compute compute) {
  for (int c0 = 0; c0 < Cin; c0 += kChunk) {
    stage_halo(x, reinterpret_cast<float*>(smem), b, oy0, ox0, c0, H, W, Cin);
    stage_weights(w, reinterpret_cast<float*>(smem + kHaloBytes), n0, c0, Cin);
    cp_async_wait_all();
    __syncthreads();
    compute(smem, smem + kHaloBytes);
    __syncthreads();
  }
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Writes the block's pooled outputs from the epilogue tile ep[pixel][channel]:
// the 2x2 max of each pooled pixel inside (H/2, W/2). A warp writes one
// pixel's 64 channels, two a thread.
__device__ __forceinline__ void store_pooled(const float* ep, float* __restrict__ out, int b,
                                             int oy0, int ox0, int n0, int H, int W, int Cout) {
  const int nl = 2 * (threadIdx.x % 32);
  constexpr int kRowsPerPass = kThreads / 32;
  constexpr int kHalf = kTile / 2;
  const int Hp = H / 2, Wp = W / 2;
  for (int pp = threadIdx.x / 32; pp < kHalf * kHalf; pp += kRowsPerPass) {
    const int oy = oy0 / 2 + pp / kHalf, ox = ox0 / 2 + pp % kHalf;
    if (oy >= Hp || ox >= Wp) continue;
    const float* e = ep + (2 * (pp / kHalf) * kTile + 2 * (pp % kHalf)) * kEpStride + nl;
    const float2 v00 = *reinterpret_cast<const float2*>(e);
    const float2 v01 = *reinterpret_cast<const float2*>(e + kEpStride);
    const float2 v10 = *reinterpret_cast<const float2*>(e + kTile * kEpStride);
    const float2 v11 = *reinterpret_cast<const float2*>(e + (kTile + 1) * kEpStride);
    store2(out + ((static_cast<size_t>(b) * Hp + oy) * Wp + ox) * Cout + n0 + nl,
           max_nan(max_nan(v00.x, v01.x), max_nan(v10.x, v11.x)),
           max_nan(max_nan(v00.y, v01.y), max_nan(v10.y, v11.y)));
  }
}

// Thread (tp, tn) owns conv row tp / 2, columns 8 (tp % 2) .. +7, and
// channels tn, tn + 8, .., tn + 56 of the block's tile (so that the eight
// tn of a warp read weights from eight distinct banks). Grid: x = conv
// tiles (tiles_x per tile row), y = Cout / 64, z = image.
__global__ void __launch_bounds__(kThreads)
conv_pool_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                     int Cin, int Cout, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ep = reinterpret_cast<float*>(smem);
  constexpr int kPS = kPixStrideBytes / 4;
  constexpr int kWS = kWStrideBytes / 4;
  const int b = blockIdx.z, n0 = blockIdx.y * kBlockN;
  const int oy0 = (blockIdx.x / tiles_x) * kTile, ox0 = (blockIdx.x % tiles_x) * kTile;
  const int tn = threadIdx.x % 8, tp = threadIdx.x / 8;
  const int cy = tp >> 1, cx0 = (tp & 1) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  run_chunks(x, w, smem, b, oy0, ox0, n0, H, W, Cin,
             [&](const unsigned char* hb, const unsigned char* wb) {
    const float* hs = reinterpret_cast<const float*>(hb);
    const float* ws = reinterpret_cast<const float*>(wb);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* xr = hs + ((cy + tap / 3) * kHalo + cx0 + tap % 3) * kPS;
      const float* wr = ws + tn * kWS + tap * kChunk;
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        float xv[8], wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = xr[i * kPS + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = wr[8 * j * kWS + c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
  });

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ep[(cy * kTile + cx0 + i) * kEpStride + tn + 8 * j] =
          max_nan(acc[i][j] + bias[n0 + tn + 8 * j], 0.f);
  __syncthreads();
  store_pooled(ep, out, b, oy0, ox0, n0, H, W, Cout);
}

// ---------------------------------------------------------------------------
// Kernels 7 (bf16) and 8 (int8) on wgmma (see the design at the top of the file).
// ---------------------------------------------------------------------------
constexpr int kWgThreads = 256;                     // two warpgroups
constexpr int kWgN = 64;                            // output channels of a block tile
constexpr int kWgStages = 3;
constexpr int kWgBlocks = 2;                        // 16-byte channel blocks per chunk
constexpr int kWgBBytes = kWgBlocks * 9 * kWgN * 16;  // [block][tap][n][16 bytes]

// A block tile of kRows x kCols conv outputs: four sub-tiles of 8x8, and
// the ring of stages that feeds it.
template <int Rows, int Cols>
struct TileShape {
  static constexpr int kRows = Rows, kCols = Cols;
  static constexpr int kHaloRows = kRows + 2, kHaloCols = kCols + 2;
  static constexpr int kPlaneBytes = kHaloRows * kHaloCols * 16;     // one block's halo
  static constexpr int kPlaneStride = (kPlaneBytes + 127) / 128 * 128;  // TMA writes 128-B aligned
  static constexpr int kABytes = kWgBlocks * kPlaneStride;
  static constexpr int kStageBytes = kABytes + kWgBBytes;
  static constexpr int kTxBytes = kWgBlocks * kPlaneBytes + kWgBBytes;
  // The ring, its barriers, and room to align the dynamic shared memory:
  // below half an SM's, so that two blocks share one.
  static constexpr int kSmemBytes = kWgStages * kStageBytes + kWgStages * 8 + 128;
  static_assert(kRows % 8 == 0 && kCols % 8 == 0 && kRows * kCols == 4 * 64,
                "a tile is four 8x8 sub-tiles");
  static_assert(kStageBytes % 128 == 0, "stages must stay 128-byte aligned");
};

// d (64 x 64 int32, the warpgroup's accumulator fragment) += A (64 x 32
// int8) * B (64 x 32 int8)^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_64x64(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16 bf16) * B (64 x 16 bf16)^T, both K-major
// (neither transposed) in shared memory, scales +1.
__device__ __forceinline__ void wgmma_bf16_64x64(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

// Kernel 8: int8 x, int32 sums, 32x8 tiles.
struct Q8 : TileShape<32, 8> {
  using Acc = int;
  static constexpr int kBlockElems = 16;  // channels in a 16-byte block
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
    wgmma_s8_64x64(d, da, db);
  }
};

// Kernel 7 in bf16: bf16 x, f32 sums, on tiles of Rows x Cols.
template <int Rows, int Cols>
struct Bf16 : TileShape<Rows, Cols> {
  using Acc = float;
  static constexpr int kBlockElems = 8;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    wgmma_bf16_64x64(d, da, db);
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrives on bar and expects `bytes` more from the copies that complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One tile of a 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A shared-memory matrix descriptor without swizzle: the start address, the
// leading byte offset (between the two 16-byte core matrices of a k-step)
// and the stride byte offset (between groups of 8 rows), all in 16 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the wgmma fences and waits.
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Stages chunk c (channel blocks 2c and 2c + 1) into its slot of the ring:
// the halo of the tile whose corner is (oy0 - 1, ox0 - 1) in image b, one
// TMA load per block, and the chunk's weights for the block's channel tile,
// contiguous in the packed layout, in one bulk copy; both complete on the
// slot's barrier. Called by one thread.
template <class K>
__device__ __forceinline__ void stage_chunk(const CUtensorMap* tm_x, const unsigned char* w_tile,
                                            unsigned char* ring, uint64_t* full, int c, int b,
                                            int oy0, int ox0) {
  const int s = c % kWgStages;
  unsigned char* st = ring + s * K::kStageBytes;
  mbar_expect_tx(&full[s], K::kTxBytes);
  for (int j = 0; j < kWgBlocks; ++j)
    tma_load_4d(st + j * K::kPlaneStride, tm_x, K::kBlockElems * (kWgBlocks * c + j), ox0 - 1,
                oy0 - 1, b, &full[s]);
  bulk_load(st + K::kABytes, w_tile + static_cast<size_t>(c) * kWgBBytes, kWgBBytes, &full[s]);
}

// The conv of x (B, H, W, Cp), read through tm_x, with the weights wp
// packed by pack_q8_weights or pack_bf16_weights; then, for kernel 8, the
// dequantisation by sx (B,) and sw (Cout,); the bias (Cout,) f32, if not
// null; ReLU if relu; the 2x2 max if pool. acc_out (kernel 8), when not
// null, receives the int32 accumulators of every conv pixel of the tile
// inside (H, W), as (B, H, W, Cout). Grid: x = Cout / kWgN, y = conv tiles
// (tiles_x per tile row), z = image.
template <class K, typename OutT>
__global__ void __launch_bounds__(kWgThreads, 2)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const unsigned char* __restrict__ wp,
                  const float* __restrict__ sw, const float* __restrict__ sx,
                  const float* __restrict__ bias, OutT* __restrict__ out, int* __restrict__ acc_out,
                  int pool, int relu, int H, int W, int Cout, int n_chunks, int tiles_x) {
  using Acc = typename K::Acc;
  constexpr bool kQuantised = std::is_same<Acc, int>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgStages * K::kStageBytes);
  const int n0 = blockIdx.x * kWgN, b = blockIdx.z;
  const int oy0 = (blockIdx.y / tiles_x) * K::kRows, ox0 = (blockIdx.y % tiles_x) * K::kCols;
  const int tid = threadIdx.x, wg = tid / 128;
  // The packed weights of this channel tile: n_chunks chunks of kWgBBytes.
  const unsigned char* w_tile = wp + static_cast<size_t>(blockIdx.x) * n_chunks * kWgBBytes;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid == 0)
    for (int c = 0; c < min(kWgStages, n_chunks); ++c)
      stage_chunk<K>(&tm_x, w_tile, smem, full, c, b, oy0, ox0);
  __syncwarp();

  // Sub-tile t = 2 wg + sub of the tile covers conv rows y0(t)..+7 and
  // columns x0(t)..+7.
  constexpr int kSubCols = K::kCols / 8;
  Acc acc[2][kWgN / 2];  // the warpgroup's two 64-pixel sub-tiles
#pragma unroll
  for (int sub = 0; sub < 2; ++sub)
#pragma unroll
    for (int i = 0; i < kWgN / 2; ++i) acc[sub][i] = 0;

  const uint32_t ring = smem_addr(smem);
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kWgStages;
    mbar_wait(&full[s], (c / kWgStages) & 1);
    const uint32_t a_st = ring + s * K::kStageBytes;
    const uint32_t b_st = a_st + K::kABytes;
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t db = smem_desc(b_st + tap * kWgN * 16, 9 * kWgN * 16, 128);
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        // Conv row r of the tile reads halo row r + dy at tap (dy, dx).
        const int t = 2 * wg + sub;
        const int hrow = (t / kSubCols) * 8 + tap / 3, hcol = (t % kSubCols) * 8 + tap % 3;
        const uint64_t da = smem_desc(a_st + (hrow * K::kHaloCols + hcol) * 16, K::kPlaneStride,
                                      K::kHaloCols * 16);
        K::mma(acc[sub], da, db);
      }
    }
    wgmma_commit();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    // Chunk c - 1's wgmmas have retired in this warpgroup; after the
    // barrier, in both: its stage takes chunk c - 1 + kWgStages.
    wgmma_wait<1>();
    __syncthreads();
    if (tid == 0 && c >= 1 && c - 1 + kWgStages < n_chunks)
      stage_chunk<K>(&tm_x, w_tile, smem, full, c - 1 + kWgStages, b, oy0, ox0);
    __syncwarp();
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  __syncthreads();  // every wgmma has read its stage: the ring holds the output tile now

  // Fragment layout: warp wi of the warpgroup holds rows 16 wi + g and
  // 16 wi + g + 8 of each sub-tile (conv rows 2 wi and 2 wi + 1, column g),
  // element 4j + 2h + e at channel 8j + 2q + e. Pooled, a thread first
  // takes the 2x2 max of its accumulators (the column pair sits in lanes g
  // and g ^ 1), then dequantises (kernel 8), adds the bias and applies ReLU
  // to the one value left: each of these is monotone (the scales are
  // positive), so they commute with the max, exactly, and a NaN still
  // wins; it is four times less work than finishing every conv output,
  // which made the epilogue nearly as long as the main loop at conv1 (1.15
  // ms a call there, 0.94 after, chip_smoke.py on the H100). Each thread
  // writes its values to the output tile in shared memory, [pixel]
  // [channel] in OutT with rows padded by 16 bytes (no bank conflicts);
  // then the block copies the tile out in 16-byte pieces, each pixel's
  // channels contiguous.
  constexpr int kEp = kWgN + 16 / static_cast<int>(sizeof(OutT));  // elements per tile pixel
  static_assert(K::kRows * K::kCols * kEp * static_cast<int>(sizeof(OutT)) <=
                    kWgStages * K::kStageBytes, "the output tile must fit in the ring");
  OutT* ep = reinterpret_cast<OutT*>(smem);
  const int lane = tid & 31, wi = (tid >> 5) & 3, g = lane >> 2, q = lane & 3;
  auto finish = [&](Acc a, int nl) {
    float y;
    if constexpr (kQuantised)
      y = __fmul_rn(__int2float_rn(a), __fmul_rn(sx[b], sw[n0 + nl]));
    else
      y = a;
    if (bias != nullptr) y = __fadd_rn(y, bias[n0 + nl]);
    return relu ? max_nan(y, 0.f) : y;
  };
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    const int t = 2 * wg + sub;
    const int ty = (t / kSubCols) * 8 + 2 * wi;  // this thread's tile rows ty, ty + 1
    const int tx = (t % kSubCols) * 8 + g;       // and tile column
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j) {
      const int nl = 8 * j + 2 * q;
      Acc* a = acc[sub];  // a[4 j + 2 h + e]: conv row ty + h, channel nl + e
      if constexpr (kQuantised) {
        if (acc_out != nullptr) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (oy0 + ty + h < H && ox0 + tx < W)
              *reinterpret_cast<int2*>(
                  acc_out + ((static_cast<size_t>(b) * H + oy0 + ty + h) * W + ox0 + tx) * Cout + n0 + nl) =
                  make_int2(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
        }
      }
      if (pool) {
        Acc m0 = max_nan(a[4 * j], a[4 * j + 2]), m1 = max_nan(a[4 * j + 1], a[4 * j + 3]);
        m0 = max_nan(m0, __shfl_xor_sync(0xffffffffu, m0, 4));  // columns tx, tx ^ 1
        m1 = max_nan(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
        if ((g & 1) == 0)
          store2(ep + ((ty / 2) * (K::kCols / 2) + tx / 2) * kEp + nl, finish(m0, nl), finish(m1, nl + 1));
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store2(ep + ((ty + h) * K::kCols + tx) * kEp + nl, finish(a[4 * j + 2 * h], nl),
                 finish(a[4 * j + 2 * h + 1], nl + 1));
      }
    }
  }
  __syncthreads();
  constexpr int kVec = 16 / static_cast<int>(sizeof(OutT));  // elements per 16-byte piece
  constexpr int kPieces = kWgN / kVec;                           // pieces per pixel
  const int rows = pool ? K::kRows / 2 : K::kRows, cols = pool ? K::kCols / 2 : K::kCols;
  const int Ho = pool ? H / 2 : H, Wo = pool ? W / 2 : W;
  const int py0 = pool ? oy0 / 2 : oy0, px0 = pool ? ox0 / 2 : ox0;
  for (int u = tid; u < rows * cols * kPieces; u += kWgThreads) {
    const int pix = u / kPieces, piece = u % kPieces;
    const int oy = py0 + pix / cols, ox = px0 + pix % cols;
    if (oy >= Ho || ox >= Wo) continue;
    const size_t at = ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * Cout + n0 + piece * kVec;
    *reinterpret_cast<uint4*>(out + at) = *reinterpret_cast<const uint4*>(ep + pix * kEp + piece * kVec);
  }
}

// cuTensorMapEncodeTiled, looked up once at run time through the CUDA
// runtime's entry-point query (the library links only the runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled tensor map of `rank` dimensions (innermost first), zero outside
// the tensor.
cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class K, typename OutT>
cudaError_t launch_wgmma(const void* x, const void* wp, const float* sw, const float* sx,
                         const float* bias, void* out, int* acc, int pool, int relu, int B, int H,
                         int W, int Cp, int Cout, cudaStream_t stream) {
  // x as (Cp, W, H, B): a box of (one block, halo columns, halo rows, 1)
  // lands in shared memory as one block's [halo row][halo column][16 bytes].
  CUtensorMap tm_x;
  const cuuint64_t elem = 16 / K::kBlockElems;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {elem * Cp, elem * W * Cp, elem * H * W * Cp};
  const cuuint32_t x_box[4] = {K::kBlockElems, K::kHaloCols, K::kHaloRows, 1};
  cudaError_t err = encode_map(&tm_x, K::kMapType, x, 4, x_dims, x_strides, x_box);
  if (err != cudaSuccess) return err;
  auto kernel = conv_wgmma_kernel<K, OutT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + K::kCols - 1) / K::kCols, tiles_y = (H + K::kRows - 1) / K::kRows;
  const dim3 grid(Cout / kWgN, tiles_x * tiles_y, B);
  kernel<<<grid, kWgThreads, K::kSmemBytes, stream>>>(
      tm_x, static_cast<const unsigned char*>(wp), sw, sx, bias, static_cast<OutT*>(out), acc,
      pool, relu, H, W, Cout, Cp / (kWgBlocks * K::kBlockElems), tiles_x);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel 7 in bfloat16: x (B, H, W, Cp) bf16, Cp a multiple of 16; wp the
// packed weights (Cout / 64, Cp / 8, 9, 64, 8) bf16
// (ops/cuda/conv.py:pack_bf16_weights); bias (Cout,) f32; out (B, H/2, W/2,
// Cout) bf16; Cout a multiple of 64; x, wp and out 16-byte aligned. Returns
// the CUDA error status (0 on success).
int conv_pool_bf16(const void* x, const void* wp, const float* bias, void* out, int B, int H,
                   int W, int Cp, int Cout, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Cp % (kWgBlocks * Bf16<32, 8>::kBlockElems) != 0 || Cp == 0 || Cout % kWgN != 0 ||
      Cout == 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const auto padded = [&](int rows, int cols) {
    return static_cast<long long>((H + rows - 1) / rows * rows) * ((W + cols - 1) / cols * cols);
  };
  if (padded(32, 8) <= padded(16, 16))
    return launch_wgmma<Bf16<32, 8>, __nv_bfloat16>(x, wp, nullptr, nullptr, bias, out, nullptr,
                                                   1, 1, B, H, W, Cp, Cout, s);
  return launch_wgmma<Bf16<16, 16>, __nv_bfloat16>(x, wp, nullptr, nullptr, bias, out, nullptr, 1,
                                                  1, B, H, W, Cp, Cout, s);
}

// Kernel 7 in float32: x (B, H, W, Cin) and w (Cout, 3, 3, Cin) f32, bias
// (Cout,) f32, out (B, H/2, W/2, Cout) f32; Cout a multiple of 64.
int conv_pool_f32(const float* x, const float* w, const float* bias, float* out, int B, int H,
                  int W, int Cin, int Cout, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_pool_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + kTile - 1) / kTile;
  const dim3 grid(tiles_x * ((H + kTile - 1) / kTile), Cout / kBlockN, B);
  conv_pool_f32_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream_ptr)>>>(
      x, w, bias, out, H, W, Cin, Cout, tiles_x);
  return cudaGetLastError();
}

// Kernel 8's amax pass: amax (B,) int32, zero on entry, receives the bits
// of max |x[b]| (a float; NaN if x[b] holds one) for x (B, H, W, Cin) f32
// (bf16_input 0) or bf16 (1).
int conv_q8_amax(const void* x, int bf16_input, int* amax, int B, int H, int W, int Cin,
                 int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B > 65535) return cudaErrorInvalidValue;
  const long long per_image = static_cast<long long>(H) * W * Cin;
  if (per_image == 0 || B == 0) return cudaSuccess;
  // About eight blocks per SM over the whole batch, at least one per image.
  const long long per_block = 8LL * kThreads;
  const long long blocks = std::min((per_image + per_block - 1) / per_block,
                                    static_cast<long long>(std::max(1, 1056 / B)));
  const dim3 grid(static_cast<unsigned>(blocks), B);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16_input)
    amax_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), amax, per_image);
  else
    amax_kernel<float><<<grid, kThreads, 0, stream>>>(static_cast<const float*>(x), amax,
                                                      per_image);
  return cudaGetLastError();
}

// Kernel 8's quantise pass: x (B, H, W, Cin) f32 (bf16_input 0) or bf16 (1)
// and its per-image scales sx (B,) f32 -> xq (B, H, W, Cp) int8, Cp a
// multiple of 32 >= Cin, zero past Cin.
int conv_q8_quantize(const void* x, int bf16_input, const float* sx, int8_t* xq, int B, int H,
                     int W, int Cin, int Cp, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Cp % (kWgBlocks * Q8::kBlockElems) != 0 || Cp < Cin) return cudaErrorInvalidValue;
  const long long per_image = static_cast<long long>(H) * W * Cp;
  if (per_image >= (1LL << 31) || B > 65535) return cudaErrorInvalidValue;
  if (per_image == 0 || B == 0) return cudaSuccess;
  const long long per_block = 8LL * kThreads * kQuantGroups;
  const dim3 grid(static_cast<unsigned>((per_image + per_block - 1) / per_block), B);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16_input)
    quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), sx, xq, Cin, Cp, static_cast<int>(per_image));
  else
    quantize_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), sx, xq, Cin, Cp, static_cast<int>(per_image));
  return cudaGetLastError();
}

// Kernel 8 on the quantised xq (B, H, W, Cp): wp the packed weights
// (Cout / 64, Cp / 16, 9, 64, 16) int8 (ops/cuda/conv.py:pack_q8_weights); sw (Cout,)
// and sx (B,) f32 scales; bias (Cout,) f32 or null; out (B, H/2, W/2, Cout)
// if pool else (B, H, W, Cout), bf16 (bf16_out 1) or f32 (0); acc (B, H, W,
// Cout) int32 or null. Cout a multiple of 64; xq, wp, out and acc 16-byte
// aligned.
int conv_q8(const int8_t* xq, const int8_t* wp, const float* sw, const float* sx,
            const float* bias, void* out, int bf16_out, int* acc, int pool, int relu, int B,
            int H, int W, int Cp, int Cout, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (Cp % (kWgBlocks * Q8::kBlockElems) != 0 || Cp == 0 || Cout % kWgN != 0 || Cout == 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (bf16_out)
    return launch_wgmma<Q8, __nv_bfloat16>(xq, wp, sw, sx, bias, out, acc, pool, relu, B, H, W,
                                           Cp, Cout, s);
  return launch_wgmma<Q8, float>(xq, wp, sw, sx, bias, out, acc, pool, relu, B, H, W, Cp, Cout, s);
}

}  // extern "C"
