// The int8 gemm route's epilogue for Hopper (sm_90a): torch._int_mm's int32
// sums dequantised, BatchNorm on its running statistics, and by mode
// nothing, ReLU, or a residual add and ReLU, in one pass and one launch.
//
// It replaces no TPU kernel: the JAX package leaves the route's convs (1x1
// at stride 1 or 2, 3x3 at stride 2) to XLA's lax.conv_general_dilated, and
// XLA fuses what follows them. Before it, the port ran the epilogue as
// separate torch passes after torch._int_mm (a cast, a multiply, a cast,
// then BatchNorm, the residual add and ReLU each on their own), and it
// still does on the CPU: ops/cuda/int8_epilogue.py:gemm_epilogue_reference
// is the plain version, and this kernel repeats it bit for bit, rounding
// wherever those passes round:
//   y = round_T(float(acc) * (sx[b] * sw[c]) [+ bias[c]])   T: bf16 or f32
//   z = round_T(w[c] * (y - mean[c]) * rsqrt(var[c] + eps) + shift[c])
//                                  as ATen's channels-last BatchNorm on the
//                                  card computes it: the last multiply and
//                                  add fused into one FMA
//   out = z, relu(z), or relu(round_T(z + residual))
// Every operation is spelled as an _rn intrinsic, which nvcc never
// contracts, so no other multiply-add is fused. ReLU carries NaN, as
// torch.relu does: an image whose scale is NaN comes out NaN.
//
// Bound. A few float operations an element against 4 bytes of int32 sums
// read and 2 (bf16) or 4 bytes written, plus the residual's read: the bytes
// bound it (at ResNet50's widest gemm conv at 448^2, 64 x 28^2 x 1,024
// outputs, 308 MB in bf16, 92 us at 3.35 TB/s; 411 MB where a residual
// is added). Each thread
// owns 8 consecutive channels (two 16-byte loads of sums, one of bf16
// residual, one 16-byte store of bf16 out) and walks rows with a grid
// stride, so its channels' constants are loaded once; neighbouring
// threads take neighbouring channels of a row, so a warp reads a
// contiguous 1 KB. The grid fills the card once (blocks per SM from the
// occupancy calculator), without atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // channels a thread
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void load(const float* p, float v[kVec]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[kVec]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  // v holds values already rounded to bf16, so the conversion is exact.
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[kVec]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// Grid: x over groups of kVec channels (threadIdx.x, blockIdx.x), y over
// rows with a stride (threadIdx.y, blockIdx.y). bias is read where kBias
// (the trunk's convs have none, and its registers would cost a block per
// SM); the BatchNorm (bn_mean null: none) and residual may be null. Three
// blocks of 256 threads share an SM: at 80 registers a thread the
// constants stay in registers, and the loads in flight cover the
// latency (at two blocks, 90 registers, the kernel took 13 % longer).
template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads, 3)
    epilogue_kernel(const int* __restrict__ acc, const float* __restrict__ sx,
                    const float* __restrict__ sw, const float* __restrict__ bias,
                    const float* __restrict__ bn_w, const float* __restrict__ bn_b,
                    const float* __restrict__ bn_mean, const float* __restrict__ bn_var,
                    float eps, const T* __restrict__ residual, T* __restrict__ out, int rows,
                    int cout, int rows_per_image, int relu) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  if (c0 >= cout) return;
  const bool bn = bn_mean != nullptr;
  float wsc[kVec], b[kVec], g[kVec], m[kVec], inv[kVec], s[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    wsc[j] = __ldg(sw + c0 + j);
    b[j] = kBias ? __ldg(bias + c0 + j) : 0.f;
    g[j] = bn ? __ldg(bn_w + c0 + j) : 1.f;
    m[j] = bn ? __ldg(bn_mean + c0 + j) : 0.f;
    // As ATen's batch_norm_calc_invstd: rsqrt(var + eps) in float32.
    inv[j] = bn ? rsqrtf(__fadd_rn(__ldg(bn_var + c0 + j), eps)) : 1.f;
    s[j] = bn ? __ldg(bn_b + c0 + j) : 0.f;
  }
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows; r += gridDim.y * blockDim.y) {
    const float scale = __ldg(sx + r / rows_per_image);
    const size_t off = static_cast<size_t>(r) * cout + c0;
    const int4 a0 = __ldg(reinterpret_cast<const int4*>(acc + off));
    const int4 a1 = __ldg(reinterpret_cast<const int4*>(acc + off) + 1);
    const int a[kVec] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float res[kVec];
    if (residual) Io<T>::load(residual + off, res);
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float y = __fmul_rn(__int2float_rn(a[j]), __fmul_rn(scale, wsc[j]));
      if (kBias) y = __fadd_rn(y, b[j]);
      y = Io<T>::round(y);
      if (bn) y = Io<T>::round(__fmaf_rn(__fmul_rn(g[j], __fsub_rn(y, m[j])), inv[j], s[j]));
      if (residual) y = Io<T>::round(__fadd_rn(y, res[j]));
      if (relu && !isnan(y)) y = fmaxf(y, 0.f);
      v[j] = y;
    }
    Io<T>::store(out + off, v);
  }
}

// Blocks of the kernel that fill every SM of the device once.
template <typename T, bool kBias>
cudaError_t resident_blocks(int device, int* blocks) {
  static int cached[kMaxDevices];  // one table per instance
  int* hit = device < kMaxDevices ? &cached[device] : nullptr;
  if (hit && *hit) {
    *blocks = *hit;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epilogue_kernel<T, kBias>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (hit) *hit = *blocks;
  return cudaSuccess;
}

template <typename T, bool kBias>
cudaError_t launch(const int* acc, const float* sx, const float* sw, const float* bias,
                   const float* bn_w, const float* bn_b, const float* bn_mean,
                   const float* bn_var, float eps, const void* residual, void* out, int rows,
                   int cout, int rows_per_image, int relu, int device, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = resident_blocks<T, kBias>(device, &blocks);
  if (err != cudaSuccess) return err;
  const int groups = cout / kVec;
  const int tx = groups < 32 ? groups : 32;
  const dim3 block(tx, kThreads / tx);
  const int gx = (groups + tx - 1) / tx;
  const long long want_y = (static_cast<long long>(rows) + block.y - 1) / block.y;
  const long long cap_y = blocks / gx > 0 ? blocks / gx : 1;
  const dim3 grid(gx, static_cast<unsigned>(want_y < cap_y ? want_y : cap_y));
  epilogue_kernel<T, kBias><<<grid, block, 0, stream>>>(
      acc, sx, sw, bias, bn_w, bn_b, bn_mean, bn_var, eps, static_cast<const T*>(residual),
      static_cast<T*>(out), rows, cout, rows_per_image, relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const int* acc, const float* sx, const float* sw, const float* bias,
                         const float* bn_w, const float* bn_b, const float* bn_mean,
                         const float* bn_var, float eps, const void* residual, void* out,
                         int rows, int cout, int rows_per_image, int relu, int device,
                         cudaStream_t stream) {
  if (bias)
    return launch<T, true>(acc, sx, sw, bias, bn_w, bn_b, bn_mean, bn_var, eps, residual, out,
                           rows, cout, rows_per_image, relu, device, stream);
  return launch<T, false>(acc, sx, sw, bias, bn_w, bn_b, bn_mean, bn_var, eps, residual, out,
                          rows, cout, rows_per_image, relu, device, stream);
}

}  // namespace

extern "C" {

const char* int8_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// acc (rows, cout) int32, rows = B * rows_per_image; sx (B,) and sw (cout,)
// f32 scales; bias (cout,) f32 or null; the BatchNorm's weight, bias,
// running mean and variance (cout,) f32 and eps, or bn_mean null for none;
// residual (rows, cout) of out's type or null; out (rows, cout) bf16
// (bf16_out 1) or f32 (0). cout a multiple of 8; acc, residual and out
// 16-byte aligned. The wrapper (ops/cuda/int8_epilogue.py) has checked
// them. Returns the CUDA error status (0 on success).
int int8_epilogue(const int* acc, const float* sx, const float* sw, const float* bias,
                  const float* bn_w, const float* bn_b, const float* bn_mean,
                  const float* bn_var, float eps, const void* residual, void* out, int bf16_out,
                  int rows, int cout, int rows_per_image, int relu, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  if (cout % kVec != 0 || cout <= 0 || rows_per_image <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16_out)
    return launch_typed<__nv_bfloat16>(acc, sx, sw, bias, bn_w, bn_b, bn_mean, bn_var, eps,
                                       residual, out, rows, cout, rows_per_image, relu, device,
                                       stream);
  return launch_typed<float>(acc, sx, sw, bias, bn_w, bn_b, bn_mean, bn_var, eps, residual, out,
                             rows, cout, rows_per_image, relu, device, stream);
}

}  // extern "C"
