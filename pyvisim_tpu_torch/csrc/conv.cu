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
// rounded once, to x's dtype.
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
// Kernel 7 (bf16 and f32). A block of 256 threads owns a 16x16 tile of conv
// outputs (8x8 pooled ones) and 64 output channels. It walks Cin in chunks
// of 64 bytes per pixel (16 f32, 32 bf16 channels): it stages the chunk's
// 18x18 halo tile in shared memory with cp.async, zero outside the image
// (SAME padding) and past Cin, with the matching (64 x 9 x chunk) weights,
// and accumulates in registers.
//   bf16: warp-level mma.sync m16n8k16 (bf16 products are exact, sums f32).
//         Each warp owns 64 pixels x 32 channels (4 x 4 mma tiles), its
//         fragments loaded with ldmatrix; per-pixel and per-channel strides
//         of the staged tiles are padded by 16 bytes, so the eight rows of an
//         8x8 matrix fall in distinct banks.
//   f32:  FMAs on the CUDA cores; TF32 would change results that the f32
//         mode must keep.
// In the epilogue the block writes its conv tile, with bias and ReLU
// applied, to shared memory and takes the 2x2 max from there: the pre-pool
// activation never reaches device memory.
//
// Kernel 8 (int8). A first pass takes each image's max |x| (the scale sx =
// max(amax / 127, 1e-8) is then formed as the plain version forms it), a
// second quantises x once (rounded as IEEE division rounds, rint: half to
// even) into an int8 scratch whose channels are padded with zeros to a
// multiple of 32 (the k32 step). The conv runs on Hopper's warpgroup MMA,
// wgmma.mma_async m64n64k32 s8 with int32 sums, exact in any order, so the
// kernel equals its plain version bit for bit. A block of two warpgroups owns
// a 32x8 tile of conv outputs and 64 output channels; each warpgroup computes
// two 64-pixel sub-tiles of 8 rows x 8 columns (m64n64k32), and two blocks
// share an SM, so that one's epilogue overlaps the other's wgmmas (a
// 128-channel tile on one block per SM was 10-20 % slower). Both operands
// are K-major in shared memory, without swizzle:
//   A, the halo of the quantised x, is staged channel-blocked,
//     [16-channel block][34 halo rows][10 halo columns][16 bytes], by one TMA
//     load per block of 16 channels (a 4-D tensor map over NHWC whose
//     out-of-bounds zero fill is the SAME padding). For every tap (dy, dx)
//     the 8 pixels of a conv row are then one contiguous 128-byte core
//     matrix, the next conv row is one halo row further (the descriptor's
//     stride offset) and the next 16 channels one block further (its leading
//     offset): each of the 9 taps is one descriptor on the same staged tile.
//   B, the weights, come packed as [16-channel block][tap][Cout][16 bytes]
//     (ops/cuda/conv.py:pack_q8_weights), so that one 3-D TMA load stages a
//     chunk's (2 blocks x 9 taps x N x 16 bytes) in the layout wgmma reads.
// Chunks of 32 channels flow through a ring of 3 stages: thread 0 keeps the
// next two chunks' loads in flight on each stage's mbarrier while the
// warpgroups run the current chunk's 9 x 2 wgmmas; a stage is refilled once
// both warpgroups' wgmmas on it have retired. The epilogue dequantises in
// registers, __fmul_rn(__int2float_rn(acc), __fmul_rn(sx[b], sw[n])), adds
// the bias with __fadd_rn (explicit round-to-nearest intrinsics, which nvcc
// cannot contract into an FMA), applies ReLU and takes the 2x2 max in
// registers: a thread holds two vertically adjacent pixels of each
// accumulator fragment and its neighbour lane (lane ^ 4) the next column.
// (Quantising in each block while staging instead repeats the division for
// every channel tile and every halo: 15x the bound at conv5.)

#include <algorithm>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kTile = 16;                                  // conv outputs per tile side
constexpr int kHalo = kTile + 2;                           // staged input rows and columns
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kBlockN = 64;                                // output channels per block
constexpr int kThreads = 256;
constexpr int kChunkBytes = 64;                            // one pixel's staged channels (kernel 7)
constexpr int kPixStrideBytes = kChunkBytes + 16;          // 20 words: rows in distinct banks
constexpr int kWStrideBytes = 9 * kChunkBytes + 16;        // 148 words, likewise
constexpr int kHaloBytes = kHaloPix * kPixStrideBytes;     // 25,920
constexpr int kWeightBytes = kBlockN * kWStrideBytes;      // 37,888
constexpr int kEpStride = kBlockN + 8;                     // f32 words per pixel of the epilogue tile
constexpr int kEpBytes = kTile * kTile * kEpStride * 4;    // 73,728
constexpr int kSmemBytes =
    kEpBytes > kHaloBytes + kWeightBytes ? kEpBytes : kHaloBytes + kWeightBytes;

// Four 8x8 matrices of 16-bit elements (rows of 16 bytes) from shared
// memory: lane l gives the address of row l % 8 of matrix l / 8, and
// receives in r[i] the 32-bit word l % 4 of row l / 4 of matrix i, which is
// the mma.sync fragment layout for 16-bit and 8-bit operands alike.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes from global to shared memory without passing through registers;
// zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stages channels [c0, c0 + chunk) of the 18x18 halo tile whose corner is
// (oy0 - 1, ox0 - 1) in image b, as raw elements, zero outside the image and
// past Cin. Pixel p's channels start at hs + p * kPixStrideBytes / sizeof(T).
template <typename T>
__device__ __forceinline__ void stage_halo(const T* __restrict__ x, T* hs, int b, int oy0,
                                           int ox0, int c0, int H, int W, int Cin) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kGroups = kChunkBytes / 16;
  constexpr int kStride = kPixStrideBytes / sizeof(T);
  const bool vec = Cin % kVec == 0;
  for (int u = threadIdx.x; u < kHaloPix * kGroups; u += kThreads) {
    const int pix = u / kGroups, grp = u % kGroups;
    const int iy = oy0 - 1 + pix / kHalo, ix = ox0 - 1 + pix % kHalo;
    const int ci = c0 + grp * kVec;
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W && ci < Cin;
    const T* src = inside ? x + ((static_cast<size_t>(b) * H + iy) * W + ix) * Cin + ci : x;
    T* dst = hs + pix * kStride + grp * kVec;
    if (vec) {
      cp_async16(dst, src, inside);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      T* e = reinterpret_cast<T*>(&v);
      for (int j = 0; inside && j < kVec && ci + j < Cin; ++j) e[j] = src[j];
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
}

// Stages channels [c0, c0 + chunk) of the 64 output channels from n0 on:
// ws[n][tap * chunk + c] for tap = 3 * dy + dx, zero past Cin.
template <typename T>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w, T* ws, int n0, int c0,
                                              int Cin) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kGroups = kChunkBytes / 16;
  constexpr int kChunk = kChunkBytes / sizeof(T);
  constexpr int kStride = kWStrideBytes / sizeof(T);
  const bool vec = Cin % kVec == 0;
  for (int u = threadIdx.x; u < kBlockN * 9 * kGroups; u += kThreads) {
    const int row = u / kGroups, grp = u % kGroups;  // row = local n * 9 + tap
    const int ci = c0 + grp * kVec;
    const T* src = ci < Cin ? w + (static_cast<size_t>(n0) * 9 + row) * Cin + ci : w;
    T* dst = ws + (row / 9) * kStride + (row % 9) * kChunk + grp * kVec;
    if (vec) {
      cp_async16(dst, src, ci < Cin);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      T* e = reinterpret_cast<T*>(&v);
      for (int j = 0; j < kVec && ci + j < Cin; ++j) e[j] = src[j];
      *reinterpret_cast<uint4*>(dst) = v;
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
// same maximum in any order. amax must be zero first. Grid: x = blocks per
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
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) s_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, s_max[w]);
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The math of one staged chunk: 9 taps x 64 bytes of K for the warp's 64
// pixels (tile rows 4wm..4wm+3) x 32 channels (32wn..32wn+31), as 4 x 4
// mma tiles per 32-byte k-step. ldmatrix reads A as the matrices (pixels
// 0-7 | 8-15) x (bytes 0-15 | 16-31) of a tile row, and B as (channels 0-7
// | 8-15 of two n8 tiles) x (bytes 0-15 | 16-31): the fragments of m16n8k16.
__device__ __forceinline__ void mma_chunk(float (&acc)[4][4][4], const unsigned char* hs,
                                          const unsigned char* ws) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane & 7, lm = lane >> 3;
  const int wm = warp & 3, wn = warp >> 2;
  const unsigned char* a0 =
      hs + (wm * 4 * kHalo + lr + 8 * (lm & 1)) * kPixStrideBytes + 16 * (lm >> 1);
  const unsigned char* b0 = ws + (wn * 32 + 8 * (lm >> 1) + lr) * kWStrideBytes + 16 * (lm & 1);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const unsigned char* at = a0 + ((tap / 3) * kHalo + tap % 3) * kPixStrideBytes;
    const unsigned char* bt = b0 + tap * kChunkBytes;
#pragma unroll
    for (int ks = 0; ks < kChunkBytes; ks += 32) {
      uint32_t bf[4][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t r[4];
        ldmatrix_x4(r, bt + q * 16 * kWStrideBytes + ks);
        bf[2 * q][0] = r[0];
        bf[2 * q][1] = r[1];
        bf[2 * q + 1][0] = r[2];
        bf[2 * q + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, at + i * kHalo * kPixStrideBytes + ks);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, bf[j]);
      }
    }
  }
}

// Walks Cin in chunks: stages one (cp.async) and runs compute(halo,
// weights) on it. x and w are staged alike, raw. Two blocks share an SM, so
// one's copies overlap the other's math; a ring of two 64-byte stages inside
// the block would take 128 KB of shared memory and leave one block per SM.
template <typename T, typename Compute>
__device__ __forceinline__ void run_chunks(const T* __restrict__ x, const T* __restrict__ w,
                                           unsigned char* smem, int b, int oy0, int ox0, int n0,
                                           int H, int W, int Cin, Compute compute) {
  constexpr int kChunk = kChunkBytes / sizeof(T);
  for (int c0 = 0; c0 < Cin; c0 += kChunk) {
    stage_halo(x, reinterpret_cast<T*>(smem), b, oy0, ox0, c0, H, W, Cin);
    stage_weights(w, reinterpret_cast<T*>(smem + kHaloBytes), n0, c0, Cin);
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
template <typename OutT>
__device__ __forceinline__ void store_pooled(const float* ep, OutT* __restrict__ out, int b,
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
           fmaxf(fmaxf(v00.x, v01.x), fmaxf(v10.x, v11.x)),
           fmaxf(fmaxf(v00.y, v01.y), fmaxf(v10.y, v11.y)));
  }
}

// Grid: x = conv tiles (tiles_x per tile row), y = Cout / 64, z = image.
__global__ void __launch_bounds__(kThreads)
conv_pool_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H,
                      int W, int Cin, int Cout, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ep = reinterpret_cast<float*>(smem);
  const int b = blockIdx.z, n0 = blockIdx.y * kBlockN;
  const int oy0 = (blockIdx.x / tiles_x) * kTile, ox0 = (blockIdx.x % tiles_x) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // tile rows 4wm..4wm+3, channels 32wn..32wn+31

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  run_chunks(x, w, smem, b, oy0, ox0, n0, H, W, Cin,
             [&](const unsigned char* hs, const unsigned char* ws) { mma_chunk(acc, hs, ws); });

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nl = wn * 32 + j * 8 + 2 * t;
    const float b0 = bias[n0 + nl], b1 = bias[n0 + nl + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm * 4 + i) * kTile + g + 8 * h;
        *reinterpret_cast<float2*>(ep + p * kEpStride + nl) =
            make_float2(fmaxf(acc[i][j][2 * h] + b0, 0.f), fmaxf(acc[i][j][2 * h + 1] + b1, 0.f));
      }
  }
  __syncthreads();
  store_pooled(ep, out, b, oy0, ox0, n0, H, W, Cout);
}

// Thread (tp, tn) owns conv row tp / 2, columns 8 (tp % 2) .. +7, and
// channels tn, tn + 8, .., tn + 56 of the block's tile (so that the eight
// tn of a warp read weights from eight distinct banks).
__global__ void __launch_bounds__(kThreads)
conv_pool_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                     int Cin, int Cout, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ep = reinterpret_cast<float*>(smem);
  constexpr int kChunk = kChunkBytes / 4;
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
          fmaxf(acc[i][j] + bias[n0 + tn + 8 * j], 0.f);
  __syncthreads();
  store_pooled(ep, out, b, oy0, ox0, n0, H, W, Cout);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

dim3 grid_for(int B, int H, int W, int Cout) {
  return dim3(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile), Cout / kBlockN, B);
}

// ---------------------------------------------------------------------------
// Kernel 8 on wgmma (see the design at the top of the file).
// ---------------------------------------------------------------------------
constexpr int kQ8Threads = 256;                     // two warpgroups
constexpr int kQ8Rows = 32;                         // conv rows of a block tile
constexpr int kQ8Cols = 8;                          // conv columns: one core-matrix row each
constexpr int kQ8HaloRows = kQ8Rows + 2;
constexpr int kQ8HaloCols = kQ8Cols + 2;
constexpr int kQ8Chunk = 32;                        // channels per stage: one k32 step per tap
constexpr int kQ8Blocks = kQ8Chunk / 16;            // 16-channel blocks per stage
constexpr int kQ8Stages = 3;
constexpr int kQ8N = 64;                            // output channels of a block tile
constexpr int kQ8PlaneBytes = kQ8HaloRows * kQ8HaloCols * 16;      // 5,440: one block's halo
constexpr int kQ8PlaneStride = (kQ8PlaneBytes + 127) / 128 * 128;  // TMA writes 128-B aligned
constexpr int kQ8ABytes = kQ8Blocks * kQ8PlaneStride;
constexpr int kQ8BBytes = kQ8Blocks * 9 * kQ8N * 16;  // [block][tap][n][16 bytes]
constexpr int kQ8StageBytes = kQ8ABytes + kQ8BBytes;     // 29,440
constexpr int kQ8TxBytes = kQ8Blocks * kQ8PlaneBytes + kQ8BBytes;
static_assert(kQ8StageBytes % 128 == 0, "stages must stay 128-byte aligned");
// The ring, its barriers, and room to align the dynamic shared memory:
// 88,472 bytes, so that two blocks share an SM.
constexpr int kQ8SmemBytes = kQ8Stages * kQ8StageBytes + kQ8Stages * 8 + 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
// leading byte offset (between the two 16-byte core matrices of a k32 step)
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

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma fences and waits.
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

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


// Stages chunk c (channels 32c..32c+31) into its slot of the ring: the halo
// of the tile whose corner is (oy0 - 1, ox0 - 1) in image b, one TMA load
// per 16-channel block, and the chunk's weights for the block's
// channel tile, contiguous in the packed layout, in one bulk copy; both
// complete on the slot's barrier. Called by one thread.
__device__ __forceinline__ void stage_chunk(const CUtensorMap* tm_x, const int8_t* w_tile,
                                            unsigned char* ring, uint64_t* full, int c, int b,
                                            int oy0, int ox0) {
  const int s = c % kQ8Stages;
  unsigned char* st = ring + s * kQ8StageBytes;
  mbar_expect_tx(&full[s], kQ8TxBytes);
  for (int j = 0; j < kQ8Blocks; ++j)
    tma_load_4d(st + j * kQ8PlaneStride, tm_x, kQ8Chunk * c + 16 * j, ox0 - 1, oy0 - 1, b,
                &full[s]);
  bulk_load(st + kQ8ABytes, w_tile + static_cast<size_t>(c) * kQ8BBytes, kQ8BBytes, &full[s]);
}

// The int8 conv on xq (B, H, W, Cp), quantize_kernel's output, read through
// tm_x, with the weights wp packed by pack_q8_weights. acc_out, when not null,
// receives the int32 accumulators of every conv pixel of the tile inside
// (H, W), as (B, H, W, Cout). Grid: x = Cout / kQ8N, y = conv tiles (tiles_x
// per tile row), z = image.
template <typename OutT>
__global__ void __launch_bounds__(kQ8Threads, 2)
conv_q8_kernel(const __grid_constant__ CUtensorMap tm_x, const int8_t* __restrict__ wp,
               const float* __restrict__ sw, const float* __restrict__ sx,
               const float* __restrict__ bias, OutT* __restrict__ out, int* __restrict__ acc_out,
               int pool, int relu, int H, int W, int Cout, int n_chunks, int tiles_x) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kQ8Stages * kQ8StageBytes);
  const int n0 = blockIdx.x * kQ8N, b = blockIdx.z;
  const int oy0 = (blockIdx.y / tiles_x) * kQ8Rows, ox0 = (blockIdx.y % tiles_x) * kQ8Cols;
  const int tid = threadIdx.x, wg = tid / 128;
  // The packed weights of this channel tile: n_chunks chunks of kQ8BBytes.
  const int8_t* w_tile = wp + static_cast<size_t>(blockIdx.x) * n_chunks * kQ8BBytes;
  if (tid == 0) {
    for (int s = 0; s < kQ8Stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid == 0)
    for (int c = 0; c < min(kQ8Stages, n_chunks); ++c)
      stage_chunk(&tm_x, w_tile, smem, full, c, b, oy0, ox0);
  __syncwarp();

  int acc[2][kQ8N / 2];  // the warpgroup's two 64-pixel sub-tiles
#pragma unroll
  for (int sub = 0; sub < 2; ++sub)
#pragma unroll
    for (int i = 0; i < kQ8N / 2; ++i) acc[sub][i] = 0;

  const uint32_t ring = smem_addr(smem);
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kQ8Stages;
    mbar_wait(&full[s], (c / kQ8Stages) & 1);
    const uint32_t a_st = ring + s * kQ8StageBytes;
    const uint32_t b_st = a_st + kQ8ABytes;
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint64_t db = smem_desc(b_st + tap * kQ8N * 16, 9 * kQ8N * 16, 128);
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        // Conv row r of the tile reads halo row r + dy at tap (dy, dx).
        const int hrow = (2 * wg + sub) * 8 + tap / 3;
        const uint64_t da = smem_desc(a_st + (hrow * kQ8HaloCols + tap % 3) * 16, kQ8PlaneStride,
                                      kQ8HaloCols * 16);
        wgmma_s8_64x64(acc[sub], da, db);
      }
    }
    wgmma_commit();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    // Chunk c - 1's wgmmas have retired in this warpgroup; after the
    // barrier, in both: its stage takes chunk c - 1 + kQ8Stages.
    wgmma_wait<1>();
    __syncthreads();
    if (tid == 0 && c >= 1 && c - 1 + kQ8Stages < n_chunks)
      stage_chunk(&tm_x, w_tile, smem, full, c - 1 + kQ8Stages, b, oy0, ox0);
    __syncwarp();
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  __syncthreads();  // every wgmma has read its stage: the ring holds the output tile now

  // Fragment layout: warp wi of the warpgroup holds rows 16 wi + g and
  // 16 wi + g + 8 of each sub-tile (conv rows 2 wi and 2 wi + 1, column g),
  // element 4j + 2h + e at channel 8j + 2q + e. Each thread dequantises
  // its elements, pools them if asked (the column pair sits in lanes g and
  // g ^ 1), and writes them to the output tile in shared memory, [pixel]
  // [channel] in OutT with rows padded by 16 bytes (no bank conflicts);
  // then the block copies the tile out in 16-byte pieces, each pixel's
  // channels contiguous.
  constexpr int kEp = kQ8N + 16 / static_cast<int>(sizeof(OutT));  // elements per tile pixel
  static_assert(kQ8Rows * kQ8Cols * kEp * static_cast<int>(sizeof(OutT)) <=
                    kQ8Stages * kQ8StageBytes, "the output tile must fit in the ring");
  OutT* ep = reinterpret_cast<OutT*>(smem);
  const float s = sx[b];
  const int lane = tid & 31, wi = (tid >> 5) & 3, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    const int ty = (2 * wg + sub) * 8 + 2 * wi;  // this thread's tile rows ty, ty + 1
#pragma unroll
    for (int j = 0; j < kQ8N / 8; ++j) {
      const int nl = 8 * j + 2 * q, n = n0 + nl;
      const float sc[2] = {__fmul_rn(s, sw[n]), __fmul_rn(s, sw[n + 1])};
      float bn[2] = {0.f, 0.f};
      if (bias != nullptr) bn[0] = bias[n], bn[1] = bias[n + 1];
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = __fmul_rn(__int2float_rn(acc[sub][4 * j + e]), sc[e & 1]);
        if (bias != nullptr) t = __fadd_rn(t, bn[e & 1]);
        if (relu) t = fmaxf(t, 0.f);
        v[e] = t;
      }
      if (acc_out != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (oy0 + ty + h < H && ox0 + g < W)
            *reinterpret_cast<int2*>(
                acc_out + ((static_cast<size_t>(b) * H + oy0 + ty + h) * W + ox0 + g) * Cout + n) =
                make_int2(acc[sub][4 * j + 2 * h], acc[sub][4 * j + 2 * h + 1]);
      }
      if (pool) {
        float m0 = fmaxf(v[0], v[2]), m1 = fmaxf(v[1], v[3]);  // rows ty, ty + 1
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));   // columns g, g ^ 1
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
        if ((g & 1) == 0) store2(ep + ((ty / 2) * (kQ8Cols / 2) + g / 2) * kEp + nl, m0, m1);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) store2(ep + ((ty + h) * kQ8Cols + g) * kEp + nl, v[2 * h], v[2 * h + 1]);
      }
    }
  }
  __syncthreads();
  constexpr int kVec = 16 / static_cast<int>(sizeof(OutT));  // elements per 16-byte piece
  constexpr int kPieces = kQ8N / kVec;                           // pieces per pixel
  const int rows = pool ? kQ8Rows / 2 : kQ8Rows, cols = pool ? kQ8Cols / 2 : kQ8Cols;
  const int Ho = pool ? H / 2 : H, Wo = pool ? W / 2 : W;
  const int py0 = pool ? oy0 / 2 : oy0, px0 = pool ? ox0 / 2 : ox0;
  for (int u = tid; u < rows * cols * kPieces; u += kQ8Threads) {
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

// A tiled int8 tensor map of `rank` dimensions (innermost first), zero
// outside the tensor.
cudaError_t encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base),
                              dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename OutT>
cudaError_t launch_q8(const int8_t* xq, const int8_t* wp, const float* sw, const float* sx,
                      const float* bias, void* out, int* acc, int pool, int relu, int B, int H,
                      int W, int Cp, int Cout, cudaStream_t stream) {
  // xq as (Cp, W, H, B): a box of (16, 10, 34, 1) lands in shared memory
  // as one 16-channel block's [halo row][halo column][16 bytes].
  CUtensorMap tm_x;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(W) * Cp,
                                   static_cast<cuuint64_t>(H) * W * Cp};
  const cuuint32_t x_box[4] = {16, kQ8HaloCols, kQ8HaloRows, 1};
  cudaError_t err = encode_map(&tm_x, xq, 4, x_dims, x_strides, x_box);
  if (err != cudaSuccess) return err;
  auto kernel = conv_q8_kernel<OutT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kQ8SmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + kQ8Cols - 1) / kQ8Cols, tiles_y = (H + kQ8Rows - 1) / kQ8Rows;
  const dim3 grid(Cout / kQ8N, tiles_x * tiles_y, B);
  kernel<<<grid, kQ8Threads, kQ8SmemBytes, stream>>>(
      tm_x, wp, sw, sx, bias, static_cast<OutT*>(out), acc, pool, relu, H, W, Cout,
      Cp / kQ8Chunk, tiles_x);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel 7 in bfloat16: x (B, H, W, Cin) and w (Cout, 3, 3, Cin) bf16, bias
// (Cout,) f32, out (B, H/2, W/2, Cout) bf16; Cout a multiple of 64. Returns
// the CUDA error status (0 on success).
int conv_pool_bf16(const void* x, const void* w, const float* bias, void* out, int B, int H,
                   int W, int Cin, int Cout, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(conv_pool_bf16_kernel)) != cudaSuccess) return err;
  conv_pool_bf16_kernel<<<grid_for(B, H, W, Cout), kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, (W + kTile - 1) / kTile);
  return cudaGetLastError();
}

// Kernel 7 in float32, as conv_pool_bf16.
int conv_pool_f32(const float* x, const float* w, const float* bias, float* out, int B, int H,
                  int W, int Cin, int Cout, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(conv_pool_f32_kernel)) != cudaSuccess) return err;
  conv_pool_f32_kernel<<<grid_for(B, H, W, Cout), kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream_ptr)>>>(
      x, w, bias, out, H, W, Cin, Cout, (W + kTile - 1) / kTile);
  return cudaGetLastError();
}

// Kernel 8's amax pass: amax (B,) int32, zero on entry, receives the bits
// of max |x[b]| (a float) for x (B, H, W, Cin) f32 (bf16_input 0) or bf16 (1).
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
  if (Cp % kQ8Chunk != 0 || Cp < Cin) return cudaErrorInvalidValue;
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
  if (Cp % kQ8Chunk != 0 || Cp == 0 || Cout % 64 != 0 || Cout == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (bf16_out)
    return launch_q8<__nv_bfloat16>(xq, wp, sw, sx, bias, out, acc, pool, relu, B, H, W, Cp, Cout,
                                    s);
  return launch_q8<float>(xq, wp, sw, sx, bias, out, acc, pool, relu, B, H, W, Cp, Cout, s);
}

}  // extern "C"
