// Diagonal-GMM posteriors and their EM / Fisher-vector statistics, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pyvisim_tpu/ops/pallas/aggregate.py:_fisher_kernel
// (gmm_em_stats_pallas, wrapped by fisher_stats_pallas). For each set b of a
// batch of (N, D) descriptor sets, with mask weights m:
//
//   logp[n,k] = x_n . minv_k - x_n^2 . half_inv_k + cst_k
//   q[n,k]    = m_n softmax_k(logp[n,:])          (max-subtracted)
//   s0[b,k]   = sum_n q[n,k]
//   s1[b,k,:] = sum_n q[n,k] x_n,   s2[b,k,:] = sum_n q[n,k] x_n^2
//   ll[b]     = sum_n m_n logsumexp_k(logp[n,:])  (optional)
//
// where minv = mu / sigma^2, half_inv = 0.5 / sigma^2 and
// cst = log w - 0.5 (D log 2pi + sum log sigma^2 + sum mu^2 / sigma^2) come
// from the wrapper. One entry point serves Fisher-vector encoding (a batch
// of sets, e.g. 128 x 196 rows) and an EM step (one set of 25,088 rows).
//
// Bound. The four products are 8*B*N*K*D flops: 13.2 GFLOP at B=128, N=196,
// D=257, K=256, ~0.2 ms at the card's 67 TFLOP/s of f32, against ~93 MB in
// and out (~0.03 ms). So operations bound it. The EM form pins full f32
// (Precision.HIGHEST in JAX: the M-step's s2/nk - mu^2 cancels), so every
// product is an f32 FMA written here: no TF32, no library call.
//
// Design. Blocks run in no order, so nothing is carried across a grid as
// the TPU kernel carries its (K, D) sums; the work is four passes:
//   1. logp_kernel: a block scores 64 rows against 64 components, staging
//      16-deep slices of x, x^2, minv and half_inv in shared memory (two
//      stages: the next slice loads while this one is used); each thread
//      owns a 4x4 tile of both products. It writes logp to q.
//   2. softmax_kernel: a warp per row turns logp into masked posteriors in
//      place and writes the row's logsumexp. The (rows, K) posterior block
//      goes through device memory (25.7 MB at the encode shape); keeping it
//      on chip is later work.
//   3. stats_kernel: a block owns one segment of a set's rows and a 64x64
//      (component, column) tile of s1 and s2, and walks its rows in order,
//      16 at a time, staged as in pass 1; the first column tile also sums
//      s0. Sets of at most seg rows are one segment; a larger set (the EM
//      form) is cut into segments whose partials reduce.cuh sums in order.
//   4. masked_row_sum_kernel (reduce.cuh): ll, one block per set.
// No float atomics, so results repeat bit for bit.

#include <cuda_runtime.h>

#include <math.h>

#include "reduce.cuh"

namespace {

constexpr int kTile = 64;    // rows x components (pass 1), components x columns (pass 3)
constexpr int kDepth = 16;   // depth staged per step: features (pass 1), rows (pass 3)
constexpr int kThreads = 256;
constexpr int kPad = kTile + 4;  // keeps a staged row 16-byte aligned for float4 reads
constexpr int kPerThread = kTile * kDepth / kThreads;

// Pass 1 staging: element e of a (64 x 16) tile is row e / 16, depth e % 16,
// stored transposed as [depth][row].
__device__ __forceinline__ void load_logp_tiles(const float* __restrict__ desc,
                                                const float* __restrict__ minv,
                                                const float* __restrict__ half_inv, int row0,
                                                int k0, int d0, int rows, int D, int K,
                                                float (&xr)[kPerThread], float (&mr)[kPerThread],
                                                float (&hr)[kPerThread]) {
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e / kDepth;
    const int gd = d0 + e % kDepth;
    const int gr = row0 + r;
    const int gk = k0 + r;
    const bool d_ok = gd < D;
    xr[q] = (gr < rows && d_ok) ? __ldg(desc + static_cast<size_t>(gr) * D + gd) : 0.f;
    const bool k_ok = gk < K && d_ok;
    mr[q] = k_ok ? __ldg(minv + static_cast<size_t>(gk) * D + gd) : 0.f;
    hr[q] = k_ok ? __ldg(half_inv + static_cast<size_t>(gk) * D + gd) : 0.f;
  }
}

__device__ __forceinline__ void store_logp_tiles(float (*xs)[kPad], float (*x2s)[kPad],
                                                 float (*ms)[kPad], float (*hs)[kPad],
                                                 const float (&xr)[kPerThread],
                                                 const float (&mr)[kPerThread],
                                                 const float (&hr)[kPerThread]) {
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int dd = e % kDepth, r = e / kDepth;
    xs[dd][r] = xr[q];
    x2s[dd][r] = xr[q] * xr[q];
    ms[dd][r] = mr[q];
    hs[dd][r] = hr[q];
  }
}

__global__ void __launch_bounds__(kThreads)
logp_kernel(const float* __restrict__ desc, const float* __restrict__ minv,
            const float* __restrict__ half_inv, const float* __restrict__ cst,
            float* __restrict__ logp, int rows, int D, int K) {
  __shared__ __align__(16) float xs[2][kDepth][kPad];
  __shared__ __align__(16) float x2s[2][kDepth][kPad];
  __shared__ __align__(16) float ms[2][kDepth][kPad];
  __shared__ __align__(16) float hs[2][kDepth][kPad];

  const int tx = threadIdx.x % 16;  // components tx*4 .. tx*4+3 of the tile
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int row0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int n_depth = (D + kDepth - 1) / kDepth;

  float am[4][4], ah[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) am[i][j] = ah[i][j] = 0.f;

  float xr[kPerThread], mr[kPerThread], hr[kPerThread];
  load_logp_tiles(desc, minv, half_inv, row0, k0, 0, rows, D, K, xr, mr, hr);
  store_logp_tiles(xs[0], x2s[0], ms[0], hs[0], xr, mr, hr);
  __syncthreads();
  for (int s = 0; s < n_depth; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < n_depth;
    if (more) load_logp_tiles(desc, minv, half_inv, row0, k0, (s + 1) * kDepth, rows, D, K, xr, mr, hr);
#pragma unroll
    for (int dd = 0; dd < kDepth; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[cur][dd][ty * 4]);
      const float4 a2 = *reinterpret_cast<const float4*>(&x2s[cur][dd][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ms[cur][dd][tx * 4]);
      const float4 h = *reinterpret_cast<const float4*>(&hs[cur][dd][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float a2v[4] = {a2.x, a2.y, a2.z, a2.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
      const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          am[i][j] = fmaf(av[i], bv[j], am[i][j]);
          ah[i][j] = fmaf(a2v[i], hv[j], ah[i][j]);
        }
    }
    // The other stage was last read before the previous barrier.
    if (more) store_logp_tiles(xs[cur ^ 1], x2s[cur ^ 1], ms[cur ^ 1], hs[cur ^ 1], xr, mr, hr);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + tx * 4 + j;
    if (k >= K) continue;
    const float ck = cst[k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < rows) logp[static_cast<size_t>(r) * K + k] = am[i][j] - ah[i][j] + ck;
    }
  }
}

// One warp per row: q[r, :] = mask[r] * softmax(logp[r, :]) in place, and
// lse[r] = logsumexp(logp[r, :]).
__global__ void __launch_bounds__(kThreads)
softmax_kernel(float* __restrict__ q, const float* __restrict__ mask, float* __restrict__ lse,
               int rows, int K) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  float* row = q + static_cast<size_t>(r) * K;
  float m = -INFINITY;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, row[k]);
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float denom = 0.f;
  for (int k = lane; k < K; k += 32) denom += expf(row[k] - m);
  for (int off = 16; off > 0; off >>= 1) denom += __shfl_xor_sync(0xffffffffu, denom, off);
  const float w = mask[r];
  for (int k = lane; k < K; k += 32) row[k] = expf(row[k] - m) / denom * w;
  if (lane == 0) lse[r] = m + logf(denom);
}

// Pass 3 staging: element e of a (16 x 64) tile is row e / 64, column e % 64,
// stored as [row][column]; neighbouring threads read neighbouring addresses.
__device__ __forceinline__ void load_stats_tiles(const float* __restrict__ qb,
                                                 const float* __restrict__ xb, int n0, int len,
                                                 int k0, int d0, int D, int K,
                                                 float (&qr)[kPerThread],
                                                 float (&xr)[kPerThread]) {
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int n = n0 + e / kTile;
    const int c = e % kTile;
    const bool n_ok = n < len;
    qr[p] = (n_ok && k0 + c < K) ? __ldg(qb + static_cast<size_t>(n) * K + k0 + c) : 0.f;
    xr[p] = (n_ok && d0 + c < D) ? __ldg(xb + static_cast<size_t>(n) * D + d0 + c) : 0.f;
  }
}

__device__ __forceinline__ void store_stats_tiles(float (*qs)[kPad], float (*xs)[kPad],
                                                  float (*x2s)[kPad],
                                                  const float (&qr)[kPerThread],
                                                  const float (&xr)[kPerThread]) {
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int r = e / kTile, c = e % kTile;
    qs[r][c] = qr[p];
    xs[r][c] = xr[p];
    x2s[r][c] = xr[p] * xr[p];
  }
}

// Block (b * S + s, kt, dt) sums rows [s * seg, min((s + 1) * seg, N)) of set
// b into p1/p2[b * S + s][k0:k0+64][d0:d0+64] and, for dt == 0, p0[...][k].
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ desc, const float* __restrict__ q,
             float* __restrict__ p0, float* __restrict__ p1, float* __restrict__ p2, int N,
             int seg, int S, int D, int K) {
  __shared__ __align__(16) float qs[2][kDepth][kPad];
  __shared__ __align__(16) float xs[2][kDepth][kPad];
  __shared__ __align__(16) float x2s[2][kDepth][kPad];

  const int tx = threadIdx.x % 16;  // columns tx*4 .. tx*4+3 of the tile
  const int ty = threadIdx.x / 16;  // components ty*4 .. ty*4+3 of the tile
  const int part = blockIdx.x;
  const int b = part / S;
  const int start = (part % S) * seg;
  const int len = min(seg, N - start);
  const int k0 = blockIdx.y * kTile;
  const int d0 = blockIdx.z * kTile;
  const size_t row0 = static_cast<size_t>(b) * N + start;
  const float* qb = q + row0 * K;
  const float* xb = desc + row0 * D;
  const bool with_s0 = blockIdx.z == 0 && tx == 0;

  float a1[4][4], a2[4][4], a0[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a0[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) a1[i][j] = a2[i][j] = 0.f;
  }

  float qr[kPerThread], xr[kPerThread];
  const int n_steps = (len + kDepth - 1) / kDepth;
  if (n_steps > 0) {
    load_stats_tiles(qb, xb, 0, len, k0, d0, D, K, qr, xr);
    store_stats_tiles(qs[0], xs[0], x2s[0], qr, xr);
  }
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < n_steps;
    if (more) load_stats_tiles(qb, xb, (s + 1) * kDepth, len, k0, d0, D, K, qr, xr);
#pragma unroll
    for (int dd = 0; dd < kDepth; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[cur][dd][ty * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&xs[cur][dd][tx * 4]);
      const float4 b2 = *reinterpret_cast<const float4*>(&x2s[cur][dd][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float b1v[4] = {b1.x, b1.y, b1.z, b1.w};
      const float b2v[4] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (with_s0) a0[i] += av[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a1[i][j] = fmaf(av[i], b1v[j], a1[i][j]);
          a2[i][j] = fmaf(av[i], b2v[j], a2[i][j]);
        }
      }
    }
    if (more) store_stats_tiles(qs[cur ^ 1], xs[cur ^ 1], x2s[cur ^ 1], qr, xr);
    __syncthreads();
  }

  const size_t out0 = static_cast<size_t>(part) * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
    if (with_s0) p0[out0 + k] = a0[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < D) {
        const size_t o = (out0 + k) * D + d;
        p1[o] = a1[i][j];
        p2[o] = a2[i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the passes on `stream` and returns the CUDA error status (0 on
// success). desc (B, N, D), mask (B, N), minv and half_inv (K, D), cst (K);
// outputs s0 (B, K), s1 and s2 (B, K, D), and ll (B) unless it is null.
// Scratch: q (B*N*K), lse (B*N) and, when a set has more than seg rows
// (S = ceil(N / seg) > 1), part (B*S*(K + 2*K*D)).
int gmm_stats_f32(const float* desc, const float* mask, const float* minv,
                  const float* half_inv, const float* cst, float* q, float* lse, float* part,
                  float* s0, float* s1, float* s2, float* ll, int B, int N, int D, int K,
                  int seg, int device, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int rows = B * N;
  const dim3 grid1((rows + kTile - 1) / kTile, (K + kTile - 1) / kTile);
  logp_kernel<<<grid1, kThreads, 0, stream>>>(desc, minv, half_inv, cst, q, rows, D, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int rows_per_block = kThreads / 32;
  softmax_kernel<<<(rows + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
      q, mask, lse, rows, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int S = (N + seg - 1) / seg;
  const size_t kd = static_cast<size_t>(K) * D;
  float* p0 = S > 1 ? part : s0;
  float* p1 = S > 1 ? part + static_cast<size_t>(B) * S * K : s1;
  float* p2 = S > 1 ? p1 + static_cast<size_t>(B) * S * kd : s2;
  const dim3 grid3(B * S, (K + kTile - 1) / kTile, (D + kTile - 1) / kTile);
  stats_kernel<<<grid3, kThreads, 0, stream>>>(desc, q, p0, p1, p2, N, seg, S, D, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (S > 1) {
    if ((err = launch_reduce_partials(p0, s0, B, S, K, stream)) != cudaSuccess) return err;
    if ((err = launch_reduce_partials(p1, s1, B, S, kd, stream)) != cudaSuccess) return err;
    if ((err = launch_reduce_partials(p2, s2, B, S, kd, stream)) != cudaSuccess) return err;
  }
  if (ll != nullptr) {
    masked_row_sum_kernel<<<B, kReduceThreads, 0, stream>>>(lse, mask, ll, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
