// Deterministic reductions shared by the kernels that split one set's rows
// into segments: each segment's block writes a partial, and these passes
// sum the partials, or a masked per-row value, in a fixed order. No float
// atomics, so results repeat bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 256;

// out[b * len + i] = sum over s < S, in order, of part[(b * S + s) * len + i].
__global__ void reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int S, long long len, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / len;
  const long long i = idx % len;
  const float* p = part + b * S * len + i;
  float s = 0.f;
  for (int j = 0; j < S; ++j) s += p[j * len];
  out[idx] = s;
}

// out[b] = sum over n < N of mask[b, n] * v[b, n]: one block per set, each
// thread a strided partial, then a fixed tree in shared memory.
__global__ void __launch_bounds__(kReduceThreads)
masked_row_sum_kernel(const float* __restrict__ v, const float* __restrict__ mask,
                      float* __restrict__ out, int N) {
  __shared__ float part[kReduceThreads];
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  float s = 0.f;
  for (int n = threadIdx.x; n < N; n += kReduceThreads) s = fmaf(mask[base + n], v[base + n], s);
  part[threadIdx.x] = s;
  __syncthreads();
  for (int width = kReduceThreads / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) part[threadIdx.x] += part[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

cudaError_t launch_reduce_partials(const float* part, float* out, int B, int S, long long len,
                                   cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * len;
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  reduce_partials_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0, stream>>>(
      part, out, S, len, total);
  return cudaGetLastError();
}

}  // namespace
