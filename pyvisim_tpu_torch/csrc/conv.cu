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
// made it lose to XLA's conv on the TPU (conv.py:26-36). A block of 256 threads
// owns a 16x16 tile of conv outputs (8x8 pooled ones) and 64 output channels.
// It walks Cin in chunks of 64 bytes per pixel (16 f32, 32 bf16, 64 int8
// channels): it stages the chunk's 18x18 halo tile in shared memory, zero
// outside the image (SAME padding) and past Cin, with the matching
// (64 x 9 x chunk) weights, and accumulates in registers.
//   bf16: warp-level mma.sync m16n8k16 (bf16 products are exact, sums f32).
//   int8: a first pass quantises x once (IEEE division, rint: half to
//         even) into an int8 scratch, which the blocks stage as they stage
//         the weights; mma.sync m16n8k32 s8 with int32 sums, exact in any
//         order, so the kernel equals its plain version bit for bit. The
//         epilogue's multiply and add are explicit round-to-nearest
//         intrinsics, which nvcc cannot contract into an FMA. (Quantising
//         in each block while staging, the first design, repeated the
//         division for every 64 output channels and every halo: 3.5 ms at
//         conv5, 15x its bound.)
//   f32:  FMAs on the CUDA cores; TF32 would change results that the f32
//         mode must keep.
// Each warp of the tensor-core kernels owns 64 pixels x 32 channels (4 x 4
// mma tiles), its fragments loaded with ldmatrix. Per-pixel and per-channel
// strides of the staged tiles are padded by 16 bytes, so the eight rows of
// an 8x8 matrix fall in distinct banks. In
// the epilogue the block writes its conv tile, with bias (or dequantisation)
// and ReLU applied, to shared memory and takes the 2x2 max from there: the
// pre-pool activation never reaches device memory. Chunks are copied with
// cp.async, which bypasses registers. Not yet done: wgmma and TMA, the way
// to the tensor cores' full rate (mma.sync reaches about half of it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

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

__device__ __forceinline__ int8_t quantize(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

// xq = clamp(rint(x / sx[image]), -127, 127) over the whole (B, H, W, Cin)
// tensor, eight elements a thread; per_image = H * W * Cin.
template <typename Tin>
__global__ void quantize_kernel(const Tin* __restrict__ x, const float* __restrict__ sx,
                                int8_t* __restrict__ xq, long long per_image, long long total) {
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (e >= total) return;
  if (per_image % 8 == 0) {
    const float s = sx[e / per_image];
    float v[8];
    load8(x + e, 8, true, v);
    uint2 q;
    int8_t* qe = reinterpret_cast<int8_t*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) qe[j] = quantize(v[j], s);
    *reinterpret_cast<uint2*>(xq + e) = q;
  } else {
    for (int j = 0; j < 8 && e + j < total; ++j) {
      float v[8];
      load8(x + e + j, 1, false, v);
      xq[e + j] = quantize(v[0], sx[(e + j) / per_image]);
    }
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

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The math of one staged chunk: 9 taps x 64 bytes of K for the warp's 64
// pixels (tile rows 4wm..4wm+3) x 32 channels (32wn..32wn+31), as 4 x 4
// mma tiles per 32-byte k-step. ldmatrix reads A as the matrices (pixels
// 0-7 | 8-15) x (bytes 0-15 | 16-31) of a tile row, and B as (channels 0-7
// | 8-15 of two n8 tiles) x (bytes 0-15 | 16-31): the fragments of m16n8k16
// bf16 and m16n8k32 s8 alike.
template <bool INT8, typename Acc>
__device__ __forceinline__ void mma_chunk(Acc (&acc)[4][4][4], const unsigned char* hs,
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
        for (int j = 0; j < 4; ++j) {
          if constexpr (INT8) {
            mma_s8(acc[i][j], a, bf[j]);
          } else {
            mma_bf16(acc[i][j], a, bf[j]);
          }
        }
      }
    }
  }
}

// Walks Cin in chunks: stages one (cp.async) and runs compute(halo,
// weights) on it. x and w are staged alike, raw (the int8 kernel stages the
// quantised x). Two blocks share an SM, so one's copies overlap the other's
// math; a ring of two 64-byte stages inside the block would take 128 KB of
// shared memory and leave one block per SM.
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

// Writes the block's outputs from the epilogue tile ep[pixel][channel]: the
// 2x2 max of each pooled pixel inside (H/2, W/2) if POOL, else each conv
// pixel inside (H, W). A warp writes one pixel's 64 channels, two a thread.
template <bool POOL, typename OutT>
__device__ __forceinline__ void store_tile(const float* ep, OutT* __restrict__ out, int b, int oy0,
                                           int ox0, int n0, int H, int W, int Cout) {
  const int nl = 2 * (threadIdx.x % 32);
  constexpr int kRowsPerPass = kThreads / 32;
  if (POOL) {
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
  } else {
    for (int p = threadIdx.x / 32; p < kTile * kTile; p += kRowsPerPass) {
      const int oy = oy0 + p / kTile, ox = ox0 + p % kTile;
      if (oy >= H || ox >= W) continue;
      const float2 v = *reinterpret_cast<const float2*>(ep + p * kEpStride + nl);
      store2(out + ((static_cast<size_t>(b) * H + oy) * W + ox) * Cout + n0 + nl, v.x, v.y);
    }
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
             [&](const unsigned char* hs, const unsigned char* ws) { mma_chunk<false>(acc, hs, ws); });

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
  store_tile<true>(ep, out, b, oy0, ox0, n0, H, W, Cout);
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
  store_tile<true>(ep, out, b, oy0, ox0, n0, H, W, Cout);
}

// The int8 kernel on xq, quantize_kernel's output; acc_out, when not null,
// receives the int32 accumulators of every conv pixel of the tile inside
// (H, W), as (B, H, W, Cout).
template <typename Tin, bool POOL, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv_q8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
               const float* __restrict__ sw, const float* __restrict__ sx,
               const float* __restrict__ bias, Tin* __restrict__ out, int* __restrict__ acc_out,
               int H, int W, int Cin, int Cout, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ep = reinterpret_cast<float*>(smem);
  const int b = blockIdx.z, n0 = blockIdx.y * kBlockN;
  const int oy0 = (blockIdx.x / tiles_x) * kTile, ox0 = (blockIdx.x % tiles_x) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const float s = sx[b];

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  run_chunks(xq, wq, smem, b, oy0, ox0, n0, H, W, Cin,
             [&](const unsigned char* hs, const unsigned char* ws) { mma_chunk<true>(acc, hs, ws); });

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nl = wn * 32 + j * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cy = wm * 4 + i, cx = g + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + nl + e;
          const int a = acc[i][j][2 * h + e];
          if (acc_out != nullptr && oy0 + cy < H && ox0 + cx < W)
            acc_out[((static_cast<size_t>(b) * H + oy0 + cy) * W + ox0 + cx) * Cout + n] = a;
          float v = __fmul_rn(__int2float_rn(a), __fmul_rn(s, sw[n]));
          if (bias != nullptr) v = __fadd_rn(v, bias[n]);
          if (RELU) v = fmaxf(v, 0.f);
          ep[(cy * kTile + cx) * kEpStride + nl + e] = v;
        }
      }
  }
  __syncthreads();
  store_tile<POOL>(ep, out, b, oy0, ox0, n0, H, W, Cout);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

dim3 grid_for(int B, int H, int W, int Cout) {
  return dim3(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile), Cout / kBlockN, B);
}

template <typename Tin, bool POOL, bool RELU>
cudaError_t launch_q8(const int8_t* xq, const int8_t* wq, const float* sw, const float* sx,
                      const float* bias, void* out, int* acc, int B, int H, int W, int Cin,
                      int Cout, cudaStream_t stream) {
  auto kernel = conv_q8_kernel<Tin, POOL, RELU>;
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(B, H, W, Cout), kThreads, kSmemBytes, stream>>>(
      xq, wq, sw, sx, bias, static_cast<Tin*>(out), acc, H, W, Cin, Cout, (W + kTile - 1) / kTile);
  return cudaGetLastError();
}

// Quantises x into the scratch xq, then runs the conv on it.
template <typename Tin>
cudaError_t dispatch_q8(const void* x, int8_t* xq, const int8_t* wq, const float* sw,
                        const float* sx, const float* bias, void* out, int* acc, int pool,
                        int relu, int B, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const long long per_image = static_cast<long long>(H) * W * Cin;
  const long long total = per_image * B;
  const long long blocks = (total + 8 * kThreads - 1) / (8 * kThreads);
  if (total == 0) return cudaSuccess;
  quantize_kernel<Tin><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), sx, xq, per_image, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (pool && relu)
    return launch_q8<Tin, true, true>(xq, wq, sw, sx, bias, out, acc, B, H, W, Cin, Cout, stream);
  if (pool)
    return launch_q8<Tin, true, false>(xq, wq, sw, sx, bias, out, acc, B, H, W, Cin, Cout, stream);
  if (relu)
    return launch_q8<Tin, false, true>(xq, wq, sw, sx, bias, out, acc, B, H, W, Cin, Cout, stream);
  return launch_q8<Tin, false, false>(xq, wq, sw, sx, bias, out, acc, B, H, W, Cin, Cout, stream);
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

// Kernel 8: x (B, H, W, Cin) f32 (bf16_input 0) or bf16 (1); xq scratch of
// B * H * W * Cin bytes; wq (Cout, 3, 3, Cin) int8; sw (Cout,) and sx (B,)
// f32 scales; bias (Cout,) f32 or null; out (B, H/2, W/2, Cout) if pool else
// (B, H, W, Cout), in x's dtype; acc (B, H, W, Cout) int32 or null. Cout a
// multiple of 64.
int conv_q8(const void* x, int bf16_input, int8_t* xq, const int8_t* wq, const float* sw,
            const float* sx, const float* bias, void* out, int* acc, int pool, int relu, int B,
            int H, int W, int Cin, int Cout, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16_input)
    return dispatch_q8<__nv_bfloat16>(x, xq, wq, sw, sx, bias, out, acc, pool, relu, B, H, W,
                                      Cin, Cout, stream);
  return dispatch_q8<float>(x, xq, wq, sw, sx, bias, out, acc, pool, relu, B, H, W, Cin, Cout,
                            stream);
}

}  // extern "C"
