// Nearest-centroid aggregation for Hopper (sm_90a): VLAD residuals for a
// batch of descriptor sets, and the Lloyd (k-means) statistics of one set.
//
// vlad_aggregate_f32 replaces the TPU kernel
// pyvisim_tpu/ops/pallas/aggregate.py:_vlad_kernel (wrapped there by
// vlad_aggregate_pallas). For each set b of the batch:
//
//   label_n  = argmin_k ||x_n - c_k||^2        (lowest k wins a tie)
//   out[b,k] = sum_n m_n [label_n = k] x_n - (sum_n m_n [label_n = k]) c_k
//
// desc (B, N, D) f32, mask (B, N) f32 weights, centers (K, D) f32, all
// contiguous; out (B, K, D) f32.
//
// Bound. The assignment is 2*B*N*K*D flops; at the main path's shape
// (B=128, N=196, D=514, K=256) that is 6.6 GFLOP, ~0.1 ms on the card's
// f32 CUDA cores, against ~120 MB of descriptors in and residuals out
// (~0.04 ms of memory traffic). So the card's f32 rate bounds the work.
// TF32 tensor cores would be faster but flip labels near ties, so the dot
// products are full f32 FMAs.
//
// Design. The TPU kernel walks descriptor chunks on a sequential grid and
// keeps (K, D) sums in VMEM across steps; blocks on this card run in no
// order, so the work is split into passes that need no cross-block sums:
//   1. center_sqnorm_kernel: ||c_k||^2, one warp per center.
//   2. assign_kernel: a block scores 64 descriptor rows against all centers,
//      64 at a time, staging 16-wide slices of both in shared memory (two
//      stages: the next slice loads while this one is used); each thread owns
//      a 4x4 tile of dot products. Each thread scans its centers in ascending
//      order with a strict compare, then the 16 threads of a row group reduce
//      by (distance, index), so the lowest index wins ties. Writes int32
//      labels (B*N).
//   3. accumulate_kernel: a block owns one set and a slice of COLS columns,
//      holding a (K x COLS) accumulator in dynamic shared memory. Threads own
//      columns and walk the set's descriptors in order, 32 rows loaded ahead;
//      the weight of cluster k is summed by thread k % COLS. No atomics, so
//      results repeat bit for bit. The epilogue writes acc - count * c.
// The (N, K) distance block never reaches device memory, as on the TPU.
//
// lloyd_stats_f32 replaces pyvisim_tpu/ops/pallas/aggregate.py:_lloyd_kernel
// (lloyd_stats_pallas), the statistics of one k-means (Lloyd) step on one
// (N, D) set: labels, (K, D) sums and (K,) counts of masked rows, and the
// inertia sum_n m_n max(||x_n||^2 + min_k(||c_k||^2 - 2 x_n.c_k), 0). It runs
// the same passes: the assignment pass also sums ||x||^2 (in its first
// center tile) and writes each row's clamped squared distance; the
// accumulation pass takes row segments of one set in place of whole sets, so
// that one large set fills the card (25,088 rows: 25 segments x 5 column
// slices at D=514), and writes per-segment partials; reduce.cuh sums them and
// the masked distances in a fixed order. The work is 2*N*K*D flops (6.6
// GFLOP at N=25,088, D=514, K=256, ~0.1 ms at the f32 rate) against 51.6 MB
// of descriptors in, so it is bound by operations, as the VLAD pass is.

#include <cuda_runtime.h>

#include <math.h>

#include "reduce.cuh"

namespace {

constexpr int kRowTile = 64;     // descriptor rows per assignment block
constexpr int kCenterTile = 64;  // centers scored per inner tile
constexpr int kDepthTile = 16;   // feature dimensions staged per step
constexpr int kAssignThreads = 256;
constexpr int kStagePerThread = kRowTile * kDepthTile / kAssignThreads;
static_assert(kRowTile == kCenterTile, "load_tiles stages rows and centers alike");
constexpr int kStageLen = 256;   // labels and weights staged per accumulation step
constexpr int kPrefetch = 32;    // descriptor rows loaded ahead per accumulation thread

__global__ void center_sqnorm_kernel(const float* __restrict__ centers,
                                     float* __restrict__ c2, int D) {
  const float* c = centers + static_cast<size_t>(blockIdx.x) * D;
  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += 32) s = fmaf(c[d], c[d], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x == 0) c2[blockIdx.x] = s;
}

// Stages the (row, depth) and (center, depth) tiles for depth offset d0 in
// registers: element e of a tile is row e / kDepthTile, depth e % kDepthTile.
__device__ __forceinline__ void load_tiles(const float* __restrict__ desc,
                                           const float* __restrict__ centers, int row0,
                                           int k0, int d0, int rows, int D, int K,
                                           float (&xr)[kStagePerThread],
                                           float (&cr)[kStagePerThread]) {
#pragma unroll
  for (int q = 0; q < kStagePerThread; ++q) {
    const int e = threadIdx.x + q * kAssignThreads;
    const int r = e / kDepthTile;
    const int gd = d0 + e % kDepthTile;
    const int gr = row0 + r;
    const int gk = k0 + r;
    xr[q] = (gr < rows && gd < D) ? __ldg(desc + static_cast<size_t>(gr) * D + gd) : 0.f;
    cr[q] = (gk < K && gd < D) ? __ldg(centers + static_cast<size_t>(gk) * D + gd) : 0.f;
  }
}

__device__ __forceinline__ void store_tiles(float (*xs)[kRowTile + 4],
                                            float (*cs)[kCenterTile + 4],
                                            const float (&xr)[kStagePerThread],
                                            const float (&cr)[kStagePerThread]) {
#pragma unroll
  for (int q = 0; q < kStagePerThread; ++q) {
    const int e = threadIdx.x + q * kAssignThreads;
    xs[e % kDepthTile][e / kDepthTile] = xr[q];
    cs[e % kDepthTile][e / kDepthTile] = cr[q];
  }
}

// With WITH_ERR the pass also writes err[r] = max(||x_r||^2 + best, 0), the
// squared distance to the nearest center, clamped as the TPU kernel does.
template <bool WITH_ERR>
__global__ void __launch_bounds__(kAssignThreads)
assign_kernel(const float* __restrict__ desc, const float* __restrict__ centers,
              const float* __restrict__ c2, int* __restrict__ labels,
              float* __restrict__ err, int rows, int D, int K) {
  // Two stages of transposed tiles, [stage][depth][row or center], padded by
  // 4 floats so a tile row stays 16-byte aligned for the float4 reads. The
  // next depth slice is loaded into registers while this one is multiplied.
  __shared__ __align__(16) float xs[2][kDepthTile][kRowTile + 4];
  __shared__ __align__(16) float cs[2][kDepthTile][kCenterTile + 4];

  const int tx = threadIdx.x % 16;  // centers tx*4 .. tx*4+3 of the tile
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3 of the block
  const int row0 = blockIdx.x * kRowTile;
  const int n_depth = (D + kDepthTile - 1) / kDepthTile;

  float best[4], x2[4];
  int best_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    best_k[i] = 0;
    x2[i] = 0.f;
  }

  float xr[kStagePerThread], cr[kStagePerThread];
  for (int k0 = 0; k0 < K; k0 += kCenterTile) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    load_tiles(desc, centers, row0, k0, 0, rows, D, K, xr, cr);
    store_tiles(xs[0], cs[0], xr, cr);
    __syncthreads();
    for (int s = 0; s < n_depth; ++s) {
      const int cur = s & 1;
      const bool more = s + 1 < n_depth;
      if (more) load_tiles(desc, centers, row0, k0, (s + 1) * kDepthTile, rows, D, K, xr, cr);
#pragma unroll
      for (int dd = 0; dd < kDepthTile; ++dd) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[cur][dd][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[cur][dd][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        if (WITH_ERR && k0 == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x2[i] = fmaf(av[i], av[i], x2[i]);
        }
      }
      // The other stage was last read before the previous barrier.
      if (more) store_tiles(xs[cur ^ 1], cs[cur ^ 1], xr, cr);
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < K) {
        const float ck = c2[k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // ||x||^2 is the same for every k of a row and is left out.
          const float dist = fmaf(-2.f, acc[i][j], ck);
          if (dist < best[i]) {
            best[i] = dist;
            best_k[i] = k;
          }
        }
      }
    }
  }

  // The 16 threads of a row group are one half of a warp.
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int ok = __shfl_xor_sync(0xffffffffu, best_k[i], off);
      if (ob < best[i] || (ob == best[i] && ok < best_k[i])) {
        best[i] = ob;
        best_k[i] = ok;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < rows) {
        labels[r] = best_k[i];
        if (WITH_ERR) err[r] = fmaxf(x2[i] + best[i], 0.f);
      }
    }
  }
}

// Block b owns rows [b * seg, min((b + 1) * seg, rows)): a whole set for
// VLAD (seg = N), a segment of the one set for Lloyd. With RESIDUAL it
// writes acc - count * c to out (B, K, D); without, it writes acc to out
// and, from the first column slice, the counts to counts_out (S, K).
template <int COLS, bool RESIDUAL>
__global__ void __launch_bounds__(COLS)
accumulate_kernel(const float* __restrict__ desc, const float* __restrict__ mask,
                  const float* __restrict__ centers, const int* __restrict__ labels,
                  float* __restrict__ out, float* __restrict__ counts_out, int rows, int seg,
                  int D, int K) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                   // K * COLS
  float* counts = acc + K * COLS;      // K
  float* w_s = counts + K;             // kStageLen
  int* l_s = reinterpret_cast<int*>(w_s + kStageLen);  // kStageLen

  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int col = blockIdx.y * COLS + t;
  const bool active = col < D;

  for (int k = 0; k < K; ++k) acc[k * COLS + t] = 0.f;
  for (int k = t; k < K; k += COLS) counts[k] = 0.f;

  const size_t row0 = static_cast<size_t>(b) * seg;
  const int N = min(seg, static_cast<int>(rows - row0));
  const float* xb = desc + row0 * D + col;
  const float* mb = mask + row0;
  const int* lb = labels + row0;

  for (int n0 = 0; n0 < N; n0 += kStageLen) {
    const int len = min(kStageLen, N - n0);
    __syncthreads();  // the previous stage is consumed; counts are zeroed
    for (int i = t; i < len; i += COLS) {
      w_s[i] = mb[n0 + i];
      l_s[i] = lb[n0 + i];
    }
    __syncthreads();
    for (int i0 = 0; i0 < len; i0 += kPrefetch) {
      // Issue kPrefetch independent loads before the first use: one column
      // per thread is too little work to hide memory latency otherwise.
      float xv[kPrefetch];
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int i = i0 + j;
        xv[j] = (active && i < len) ? __ldg(xb + static_cast<size_t>(n0 + i) * D) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int i = i0 + j;
        if (i < len) {
          const float w = w_s[i];
          if (w != 0.f) {
            const int l = l_s[i];
            if (l % COLS == t) counts[l] += w;
            // An inactive thread adds 0 to its own, unused column.
            acc[l * COLS + t] = fmaf(w, xv[j], acc[l * COLS + t]);
          }
        }
      }
    }
  }
  __syncthreads();
  if (!RESIDUAL && blockIdx.y == 0)
    for (int k = t; k < K; k += COLS) counts_out[static_cast<size_t>(b) * K + k] = counts[k];
  if (!active) return;
  float* ob = out + static_cast<size_t>(b) * K * D + col;
  const float* cb = centers + col;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    ob[static_cast<size_t>(k) * D] =
        RESIDUAL ? fmaf(-counts[k], __ldg(cb + static_cast<size_t>(k) * D), acc[k * COLS + t])
                 : acc[k * COLS + t];
  }
}

size_t accumulate_smem_bytes(int cols, int K) {
  return (static_cast<size_t>(K) * cols + K + 2 * kStageLen) * sizeof(float);
}

template <int COLS, bool RESIDUAL>
cudaError_t launch_accumulate(const float* desc, const float* mask, const float* centers,
                              const int* labels, float* out, float* counts_out, int rows,
                              int seg, int D, int K, cudaStream_t stream) {
  const size_t smem = accumulate_smem_bytes(COLS, K);
  cudaError_t err = cudaFuncSetAttribute(accumulate_kernel<COLS, RESIDUAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + seg - 1) / seg, (D + COLS - 1) / COLS);
  accumulate_kernel<COLS, RESIDUAL><<<grid, COLS, smem, stream>>>(
      desc, mask, centers, labels, out, counts_out, rows, seg, D, K);
  return cudaGetLastError();
}

template <bool RESIDUAL>
cudaError_t accumulate(const float* desc, const float* mask, const float* centers,
                       const int* labels, float* out, float* counts_out, int rows, int seg,
                       int D, int K, int cols, cudaStream_t stream) {
  switch (cols) {
    case 128:
      return launch_accumulate<128, RESIDUAL>(desc, mask, centers, labels, out, counts_out,
                                              rows, seg, D, K, stream);
    case 64:
      return launch_accumulate<64, RESIDUAL>(desc, mask, centers, labels, out, counts_out,
                                             rows, seg, D, K, stream);
    case 32:
      return launch_accumulate<32, RESIDUAL>(desc, mask, centers, labels, out, counts_out,
                                             rows, seg, D, K, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool WITH_ERR>
cudaError_t assign(const float* desc, const float* centers, float* c2, int* labels, float* err,
                   int rows, int D, int K, cudaStream_t stream) {
  center_sqnorm_kernel<<<K, 32, 0, stream>>>(centers, c2, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  assign_kernel<WITH_ERR><<<(rows + kRowTile - 1) / kRowTile, kAssignThreads, 0, stream>>>(
      desc, centers, c2, labels, err, rows, D, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest column slice whose accumulator fits in a block's shared memory on
// this device, or 0 when K is too large for any.
int vlad_accumulate_cols(int K, int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  for (int cols = 128; cols >= 32; cols /= 2)
    if (accumulate_smem_bytes(cols, K) <= static_cast<size_t>(limit)) return cols;
  return 0;
}

const char* vlad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the three passes on `stream` and returns the CUDA error status
// (0 on success). c2 (K) and labels (B*N) are caller-allocated scratch.
int vlad_aggregate_f32(const float* desc, const float* mask, const float* centers,
                       float* c2, int* labels, float* out, int B, int N, int D, int K,
                       int device, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int rows = B * N;
  if ((err = assign<false>(desc, centers, c2, labels, nullptr, rows, D, K, stream)) != cudaSuccess)
    return err;
  return accumulate<true>(desc, mask, centers, labels, out, nullptr, rows, N, D, K,
                          vlad_accumulate_cols(K, device), stream);
}

// Lloyd statistics of one (N, D) set in segments of seg rows (S of them).
// c2 (K), labels (N), err (N) are caller-allocated scratch. With S > 1,
// part_sums (S, K, D) and part_counts (S, K) are scratch too; with S == 1
// they must be sums and counts themselves.
int lloyd_stats_f32(const float* desc, const float* mask, const float* centers, float* c2,
                    int* labels, float* err, float* part_sums, float* part_counts,
                    float* sums, float* counts, float* inertia, int N, int D, int K, int seg,
                    int device, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if ((e = assign<true>(desc, centers, c2, labels, err, N, D, K, stream)) != cudaSuccess) return e;
  if ((e = accumulate<false>(desc, mask, centers, labels, part_sums, part_counts, N, seg, D, K,
                             vlad_accumulate_cols(K, device), stream)) != cudaSuccess)
    return e;
  const int S = (N + seg - 1) / seg;
  if (S > 1) {
    if ((e = launch_reduce_partials(part_sums, sums, 1, S, static_cast<long long>(K) * D,
                                    stream)) != cudaSuccess)
      return e;
    if ((e = launch_reduce_partials(part_counts, counts, 1, S, K, stream)) != cudaSuccess)
      return e;
  }
  masked_row_sum_kernel<<<1, kReduceThreads, 0, stream>>>(err, mask, inertia, N);
  return cudaGetLastError();
}

}  // extern "C"
