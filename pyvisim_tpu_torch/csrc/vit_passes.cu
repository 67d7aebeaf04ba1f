// The ViT block's float passes between its linears, for Hopper (sm_90a), in
// bf16: SwiGLU over w12's output in one pass, LayerScale + residual add
// together with the LayerNorm that follows it in one pass, and DINOv3's
// RoPE rotation of q and k in one in-place pass over qkv's output.
//
// They replace no TPU kernel: the JAX package leaves these elementwise
// passes and LayerNorm to XLA, which fuses them. Before them, the port ran
// each as torch passes of its own (F.silu on one strided half of w12's
// output, its product with the other half, torch.addcmul, then
// F.layer_norm), and it still does off the card:
// ops/cuda/vit_passes.py:swiglu_reference, add_norm_reference and
// rope_reference are the plain versions. The kernels round where those
// passes round:
//   swiglu:   s = round(x1 / (1 + expf(-x1)))     F.silu, as ATen's CUDA
//             out = round(s * x2)                  kernel computes it; * x2
//   add_norm: x_new = round(x + y * gamma)         torch.addcmul (y * gamma
//                                                  is exact in float)
//             h = round(w * (rstd * (x_new - mean)) + b)
//                                                  F.layer_norm, as ATen's
//             vectorised kernel computes it: mean and rstd = rsqrtf(var +
//             eps) in float32 from the rounded x_new, by ATen's Welford
//             partials of 128 threads a row (4 columns a vector, vector i
//             to thread i % 128), combined in ATen's order (a shuffle-down
//             tree in each of its four warps, then across them), the last
//             multiply and add fused,
//   rope:     x1' = round(x1 * c - x2 * s)       the plain route's float32
//             x2' = round(x2 * c + x1 * s)       products and sum, each
//                                                rounded (no multiply-add
//                                                fused), rounded once to bf16
// so the kernels are bit for bit with the torch passes. (Statistics
// summed in another order put a few entries in a million a bf16 step or
// two off F.layer_norm's, where its output lies near zero.)
//
// Bound: the bytes. swiglu reads 4 bytes an output and writes 2: at the
// ViT-g cell's 87,680 x 8,192 (64 images x 1,370 tokens, 2 x 4,096) 2.15 GB,
// 0.64 ms at 3.35 TB/s, where the torch passes moved 5 bytes an output (a
// silu temporary written and read back). add_norm reads x and y and writes
// x_new and h, 8 bytes an entry: at 87,680 x 1,536 1.08 GB, 0.32 ms, where
// addcmul then LayerNorm moved 10.
//
// swiglu: a thread owns 8 consecutive columns of a row: one 16-byte load
// from each half and one 16-byte store, no shared memory. Neighbouring
// threads take neighbouring columns, so a warp reads 512 contiguous bytes
// of each half; the block's other warps take other rows.
// add_norm: a warp owns a row and does the work of ATen's four warps on it:
// lane l takes the vectors of ATen's threads l, l + 32, l + 64 and l + 96,
// 8-byte loads of x, y and gamma, neighbouring lanes on neighbouring
// columns; up to 2,048 columns (every DINOv2 width, 384-1,536; 48 values a
// lane at 1,536) the row's x_new stays in registers, packed in bf16, between
// the statistics and the norm. Wider rows are streamed: x_new is stored,
// then read back (from L2) for the norm. On an H100 at the ViT-g cell's
// shapes swiglu moves 3.1 TB/s and add_norm 2.3: the statistics' serial
// Welford chains and reciprocals, more than the bytes, set add_norm's pace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // bf16 columns a thread takes at a time
constexpr int kThreads = 256;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 bf16 as floats, through the read-only cache (data this kernel does
// not write).
__device__ __forceinline__ void load8(const bf16* p, float v[kVec]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// Each float rounded to bf16, to nearest even (exact where v holds bf16
// values already).
__device__ __forceinline__ void store8(bf16* p, const float v[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Grid: x over groups of kVec columns (threadIdx.x, blockIdx.x), y over rows
// with a stride (threadIdx.y, blockIdx.y). in (rows, 2 * hidden), out
// (rows, hidden).
__global__ void __launch_bounds__(kThreads)
    swiglu_kernel(const bf16* __restrict__ in, bf16* __restrict__ out, int rows, int hidden) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  if (c >= hidden) return;
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows; r += gridDim.y * blockDim.y) {
    const bf16* row = in + static_cast<size_t>(r) * 2 * hidden;
    float a[kVec], b[kVec], o[kVec];
    load8(row + c, a);
    load8(row + hidden + c, b);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      // F.silu's expression, as ATen's CUDA kernel spells it.
      const float s = round_bf16(a[j] / (1.0f + expf(-a[j])));
      o[j] = round_bf16(__fmul_rn(s, b[j]));
    }
    store8(out + static_cast<size_t>(r) * hidden + c, o);
  }
}

// rope: the DINOv3 trunk's 2-D RoPE over qkv's (rows, 3 * dim) bf16 output,
// in place: the q and k thirds (2 * dim columns, heads of 2 * half) of each
// image's patch rows, the CLS and register rows before them untouched. The
// float32 table holds cos (patches, half), then sin (patches, half); a
// patch's angles are the same for all its q and k heads (64 of them at the
// DINOv3 ViT-7B cell's 32 heads of 128).
// Bound: the bytes, 2 read and 2 written an entry: at the cell's 16 images
// x 2,304 patches x 8,192 q and k columns 1.21 GB a call, 0.36 ms at 3.35
// TB/s (the 1.2 MB table stays in L2). Before it the plain torch route made
// float32 copies of q and k, four products, a sum, a difference, a stack
// and a rounded copy back: about 12 times the bytes.
// A block takes one patch row: a thread takes 8 columns of a half-head
// (threadIdx.x) and kRopePer heads (threadIdx.y plus strides of
// blockDim.y), loads its 8 cos and 8 sin once, then both halves of each of
// its heads (two 16-byte loads, two 16-byte stores). A warp reads 128
// contiguous bytes of each half of four heads.
constexpr int kRopePer = 2;  // heads a thread rotates

__device__ __forceinline__ void load8f(const float* p, float v[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// 8 bf16 as floats through the coherent path (data this kernel writes).
__device__ __forceinline__ void load8_rw(const bf16* p, float v[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// Grid: x over the images' patch rows (image * patches + patch), y over
// groups of blockDim.y * kRopePer heads.
__global__ void __launch_bounds__(kThreads)
    rope_kernel(bf16* __restrict__ qkv, const float* __restrict__ table, int patches, int tokens,
                int prefix, int dim, int half) {
  const int image = blockIdx.x / patches, p = blockIdx.x - image * patches;
  const int j = threadIdx.x * kVec;
  const int heads = dim / half;  // q and k heads: 2 * dim / (2 * half)
  float c[kVec], s[kVec];
  load8f(table + static_cast<size_t>(p) * half + j, c);
  load8f(table + (static_cast<size_t>(patches) + p) * half + j, s);
  bf16* row = qkv + (static_cast<size_t>(image) * tokens + prefix + p) * 3 * dim;
  float x1[kRopePer][kVec], x2[kRopePer][kVec];
  const int first = blockIdx.y * blockDim.y * kRopePer + threadIdx.y;
#pragma unroll
  for (int k = 0; k < kRopePer; ++k) {
    const int v = first + k * blockDim.y;
    if (v < heads) {
      load8_rw(row + static_cast<size_t>(v) * 2 * half + j, x1[k]);
      load8_rw(row + static_cast<size_t>(v) * 2 * half + half + j, x2[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRopePer; ++k) {
    const int v = first + k * blockDim.y;
    if (v < heads) {
      float o1[kVec], o2[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        o1[e] = __fsub_rn(__fmul_rn(x1[k][e], c[e]), __fmul_rn(x2[k][e], s[e]));
        o2[e] = __fadd_rn(__fmul_rn(x2[k][e], c[e]), __fmul_rn(x1[k][e], s[e]));
      }
      // store8 rounds each float to bf16, to nearest even, once.
      store8(row + static_cast<size_t>(v) * 2 * half + j, o1);
      store8(row + static_cast<size_t>(v) * 2 * half + half + j, o2);
    }
  }
}

// 4 bf16 (8 bytes) to floats and back; the floats are bf16 values.
__device__ __forceinline__ void unpack4(uint2 raw, float v[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ uint2 pack4(const float v[4]) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  return raw;
}

// 4 bf16 as floats, through the read-only cache.
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  unpack4(__ldg(reinterpret_cast<const uint2*>(p)), v);
}

// A row's running mean, sum of squared deviations and count, as ATen's
// WelfordDataLN.
struct Welford {
  float mean, m2, count;
};

// ATen's cuWelfordOnlineSum: v joins w, count the values after it (a
// constant where the loop is unrolled; 1 / count is correctly rounded
// either way, as ATen's reciprocal).
__device__ __forceinline__ void welford_add(Welford& w, float v, float count) {
  const float delta = __fsub_rn(v, w.mean);
  w.mean = __fmaf_rn(delta, 1.f / count, w.mean);
  w.m2 = __fmaf_rn(delta, __fsub_rn(v, w.mean), w.m2);
  w.count = count;
}

// ATen's cuWelfordCombine(b, a): b the own partial, a the partner's.
__device__ __forceinline__ Welford welford_combine(const Welford& b, const Welford& a) {
  const float delta = __fsub_rn(b.mean, a.mean);
  const float count = __fadd_rn(a.count, b.count);
  if (!(count > 0.f)) return {0.f, 0.f, count};
  const float coef = 1.f / count;
  const float na = __fmul_rn(a.count, coef), nb = __fmul_rn(b.count, coef);
  // ATen's nA * A.mean + nB * B.mean with the first product fused into the
  // add (fusing the second
  // instead parts from F.layer_norm in a few entries a million).
  const float mean = __fmaf_rn(na, a.mean, __fmul_rn(nb, b.mean));
  const float m2 =
      __fmaf_rn(__fmul_rn(__fmul_rn(delta, delta), a.count), nb, __fadd_rn(a.m2, b.m2));
  return {mean, m2, count};
}

__device__ __forceinline__ Welford shfl_down(const Welford& w, int offset) {
  return {__shfl_down_sync(0xffffffffu, w.mean, offset),
          __shfl_down_sync(0xffffffffu, w.m2, offset),
          __shfl_down_sync(0xffffffffu, w.count, offset)};
}

// The row's mean and rstd from the partials of ATen's 128 threads, lane l
// holding thread l + 32 y in w[y]: each ATen warp's shuffle-down tree (the
// same lanes), then its tree over the four warps; lane 0's result, to every
// lane.
__device__ __forceinline__ void row_stats(Welford w[4], int cols, float eps, float& mean,
                                          float& rstd) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int y = 0; y < 4; ++y) w[y] = welford_combine(w[y], shfl_down(w[y], offset));
  }
  w[0] = welford_combine(w[0], w[2]);
  w[1] = welford_combine(w[1], w[3]);
  w[0] = welford_combine(w[0], w[1]);
  mean = __shfl_sync(0xffffffffu, w[0].mean, 0);
  const float var = __fdiv_rn(__shfl_sync(0xffffffffu, w[0].m2, 0), static_cast<float>(cols));
  rstd = rsqrtf(__fadd_rn(var, eps));
}

// x_new = round(x + y * gamma) for 4 columns, packed, joining the Welford
// partial w as their k-th vector (values 4k + 1 .. 4k + 4 of that partial).
__device__ __forceinline__ uint2 add_scaled(const bf16* x, const bf16* y, const bf16* gamma,
                                            int k, Welford& w) {
  float a[4], b[4], g[4], v[4];
  load4(x, a);
  load4(y, b);
  load4(gamma, g);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = round_bf16(__fadd_rn(a[e], __fmul_rn(b[e], g[e])));
    welford_add(w, v[e], static_cast<float>(4 * k + e + 1));
  }
  return pack4(v);
}

// h = round(w * (rstd * (x_new - mean)) + b) for 4 columns of packed x_new,
// as ATen writes it.
__device__ __forceinline__ void store_normed(bf16* h, uint2 packed, const bf16* weight,
                                             const bf16* bias, float mean, float rstd) {
  float v[4], w[4], b[4], o[4];
  unpack4(packed, v);
  load4(weight, w);
  load4(bias, b);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = __fmaf_rn(w[e], __fmul_rn(rstd, __fsub_rn(v[e], mean)), b[e]);
  *reinterpret_cast<uint2*>(h) = pack4(o);
}

// A warp a row (threadIdx.x the lane, threadIdx.y the row in the block).
// The row's 4-column vectors are ATen's: vector i belongs to its thread
// i % 128 as that thread's (i / 128)-th, so lane l takes vectors l + 32 m,
// m = 4 k + y, as thread l + 32 y's k-th. kSteps > 0: the row in
// registers, k < kSteps (cols <= 512 kSteps); kSteps == 0: streamed.
template <int kSteps>
__global__ void __launch_bounds__(kThreads)
    add_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                    const bf16* __restrict__ gamma, const bf16* __restrict__ weight,
                    const bf16* __restrict__ bias, float eps, bf16* __restrict__ x_out,
                    bf16* __restrict__ h_out, int rows, int cols) {
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const int lane = threadIdx.x;
  const int vecs = cols / 4;
  const size_t base = static_cast<size_t>(r) * cols;
  Welford w[4] = {};
  float mean, rstd;
  if constexpr (kSteps > 0) {
    uint2 v[4 * kSteps];  // x_new, packed: 2 registers a vector
#pragma unroll
    for (int m = 0; m < 4 * kSteps; ++m) {
      const int c = 4 * (lane + 32 * m);
      if (c < cols) {
        v[m] = add_scaled(x + base + c, y + base + c, gamma + c, m / 4, w[m % 4]);
        *reinterpret_cast<uint2*>(x_out + base + c) = v[m];
      }
    }
    row_stats(w, cols, eps, mean, rstd);
#pragma unroll
    for (int m = 0; m < 4 * kSteps; ++m) {
      const int c = 4 * (lane + 32 * m);
      if (c < cols) store_normed(h_out + base + c, v[m], weight + c, bias + c, mean, rstd);
    }
  } else {
    for (int k = 0; lane + 128 * k < vecs; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * (lane + 32 * (4 * k + q));
        if (c < cols)
          *reinterpret_cast<uint2*>(x_out + base + c) =
              add_scaled(x + base + c, y + base + c, gamma + c, k, w[q]);
      }
    }
    row_stats(w, cols, eps, mean, rstd);
    for (int m = 0; lane + 32 * m < vecs; ++m) {
      const int c = 4 * (lane + 32 * m);
      // Written by this thread above: the coherent path, not __ldg.
      store_normed(h_out + base + c, *reinterpret_cast<const uint2*>(x_out + base + c),
                   weight + c, bias + c, mean, rstd);
    }
  }
}

template <int kSteps>
cudaError_t launch_add_norm(const bf16* x, const bf16* y, const bf16* gamma, const bf16* weight,
                            const bf16* bias, float eps, bf16* x_out, bf16* h_out, int rows,
                            int cols, cudaStream_t stream) {
  const dim3 block(32, kThreads / 32);
  const dim3 grid((rows + block.y - 1) / block.y);
  add_norm_kernel<kSteps><<<grid, block, 0, stream>>>(x, y, gamma, weight, bias, eps, x_out,
                                                      h_out, rows, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vit_passes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// in (rows, 2 * hidden) bf16, out (rows, hidden) bf16, both contiguous and
// 16-byte aligned; hidden a multiple of 8. The wrapper
// (ops/cuda/vit_passes.py) has checked them. Returns the CUDA error status
// (0 on success).
int vit_swiglu(const void* in, void* out, int rows, int hidden, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  if (hidden % kVec != 0 || hidden <= 0 || rows < 0) return cudaErrorInvalidValue;
  const int groups = hidden / kVec;
  const int tx = groups < 32 ? groups : 32;
  const dim3 block(tx, kThreads / tx);
  const int gx = (groups + tx - 1) / tx;
  const long long want_y = (static_cast<long long>(rows) + block.y - 1) / block.y;
  const dim3 grid(gx, static_cast<unsigned>(want_y < 65535 ? want_y : 65535));
  swiglu_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const bf16*>(in), static_cast<bf16*>(out), rows, hidden);
  return cudaGetLastError();
}

// x, y, x_out, h_out (rows, cols) bf16; gamma, weight, bias (cols,) bf16;
// all contiguous and 16-byte aligned; cols a multiple of 8. Writes x_out =
// x + y * gamma and h_out = the LayerNorm of x_out (weight, bias, eps).
// Returns the CUDA error status (0 on success).
int vit_add_norm(const void* x, const void* y, const void* gamma, const void* weight,
                 const void* bias, float eps, void* x_out, void* h_out, int rows, int cols,
                 int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  if (cols % kVec != 0 || cols <= 0 || rows < 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16 *px = static_cast<const bf16*>(x), *py = static_cast<const bf16*>(y);
  const bf16 *pg = static_cast<const bf16*>(gamma), *pw = static_cast<const bf16*>(weight);
  const bf16* pb = static_cast<const bf16*>(bias);
  bf16 *ox = static_cast<bf16*>(x_out), *oh = static_cast<bf16*>(h_out);
  const int steps = (cols + 511) / 512;  // vectors a partial of ATen's 128 threads
#define VIT_ADD_NORM(k) \
  return launch_add_norm<k>(px, py, pg, pw, pb, eps, ox, oh, rows, cols, stream)
  switch (steps) {
    case 1: VIT_ADD_NORM(1);
    case 2: VIT_ADD_NORM(2);
    case 3: VIT_ADD_NORM(3);
    case 4: VIT_ADD_NORM(4);
    default: VIT_ADD_NORM(0);
  }
#undef VIT_ADD_NORM
}

// qkv (images * tokens, 3 * dim) bf16, contiguous and 16-byte aligned;
// table (2, tokens - prefix, half) float32, contiguous and 16-byte aligned;
// half a multiple of 8 dividing dim. Rotates, in place, the q and k thirds
// of each image's rows prefix .. tokens - 1. Returns the CUDA error status
// (0 on success).
int vit_rope(void* qkv, const void* table, int images, int tokens, int prefix, int dim, int half,
             int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int patches = tokens - prefix;
  if (images < 0 || prefix < 0 || patches < 0 || half <= 0 || half % kVec != 0 ||
      dim % half != 0 || (dim / half) % 2 != 0 || half / kVec > kThreads)
    return cudaErrorInvalidValue;
  if (images == 0 || patches == 0) return cudaSuccess;
  const long long blocks = static_cast<long long>(images) * patches;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const int groups = half / kVec;
  const dim3 block(groups, kThreads / groups);
  const int per_block = block.y * kRopePer, heads = dim / half;
  const dim3 grid(static_cast<unsigned>(blocks), (heads + per_block - 1) / per_block);
  rope_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<bf16*>(qkv), static_cast<const float*>(table), patches, tokens, prefix, dim,
      half);
  return cudaGetLastError();
}

}  // extern "C"
