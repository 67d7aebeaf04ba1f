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
// lloyd_stats_f32 replaces pyvisim_tpu/ops/pallas/aggregate.py:_lloyd_kernel
// (lloyd_stats_pallas), the statistics of one k-means (Lloyd) step on one
// (N, D) set: labels, (K, D) sums and (K,) counts of weighted rows, and the
// inertia sum_n m_n max(||x_n||^2 + min_k(||c_k||^2 - 2 x_n.c_k), 0).
//
// Bound. The assignment is 2*B*N*K*D flops on the rows that carry weight;
// at the main path's shapes (128 x 196 or 25,088 rows, D=514, K=256) that is
// 6.6 GFLOP, ~0.1 ms on the card's f32 CUDA cores, against ~120 MB of
// descriptors in and residuals out (~0.04 ms). So the card's f32 rate bounds
// the work. TF32 tensor cores would be faster but flip labels near ties, so
// the dot products are full f32 FMAs.
//
// Non-finite values travel as in the plain one-hot product: out[b,k,d] is
// NaN whenever a row n of set b with a non-finite x[n,d] has
// m_n [label_n = k] = 0 (0 * NaN and 0 * inf are NaN), and the inertia is
// NaN when any row's clamped distance is NaN, or +inf with weight 0.
//
// Design: three launches a call, no float atomics, every sum in a fixed
// order, so two calls give the same bits.
//   1. prep_kernel: ||c_k||^2 (one warp per four centers), a transposed copy
//      of the centers, ct (D padded to 16) x (K padded to 128), in 32 x 32
//      tiles, so that center tiles load with 16-byte copies; zeroes the
//      counts below.
//   2. assign_kernel: a block takes 96 rows (25,088 rows make 262 blocks,
//      two an SM on 132 SMs) against all centers, 128 at a time, through a
//      3-stage cp.async ring over (center tile, 16-deep slice) steps: rows as
//      they lie (8-byte copies; D = 514 makes 2,056-byte rows, which TMA
//      cannot describe), centers from ct. Each thread owns 6 rows x 8
//      centers and scans its centers in ascending order with a strict
//      compare; the 16 threads of a row group then reduce by (distance,
//      index), so the lowest index wins ties and a row whose distances are
//      all NaN gets 0, as argmin does. A row of zero weight gets label -1.
//      The non-finite values are counted per (set, column) in int32 nf
//      (integer atomics: exact and order-free): a non-finite x makes every
//      dot product of its row non-finite, so a row whose first one is not
//      finite is read again and its values counted. A block whose rows all
//      weigh 0 reads them once for nf and computes nothing else: their
//      products add exactly nothing. For Lloyd it also writes err =
//      max.NaN(||x||^2 + best, 0) of each row it computes; it skips only
//      when every |x| and |c| is below 1e15, so that the skipped distances
//      are finite, and flags a weightless row whose err is NaN or inf.
//   3. gather_kernel: a block takes one set, 32 clusters (VLAD; 8 for
//      Lloyd) and 128 columns (64 for Lloyd), 8 warps; a set that fits one
//      chunk takes up to 8 such steps of 32 clusters (all 256 at the deep
//      VLAD shape), while the grid keeps 3 blocks an SM. It stages 2,048
//      labels and weights at a time by cp.async, the next chunk in flight
//      while this one is scanned, and compacts the chunk's rows of nonzero
//      weight in its clusters, in row order. Each warp lists its 4 clusters'
//      (Lloyd: 1) rows from that, and when its list is full or the set ends
//      adds w * x in list order, which is row order for each cluster, the
//      loads of 4 (Lloyd 8) rows issued together. It writes acc - count * c
//      (VLAD) or acc and count (Lloyd) once. Column d of a cluster is NaN
//      when nf counts a non-finite value there that is not the cluster's
//      own: when nf > 0 and the sum is finite, or the sum is +-inf and the
//      cluster's own non-finite values (counted again, a slow path for
//      data that holds inf) are fewer than nf. For Lloyd the warps also sum
//      w * err over their rows; the last block to finish (an integer
//      counter) adds the clusters' sums in order, NaN if a weightless row
//      was flagged.
// The (N, K) distance block never reaches device memory, as on the TPU.

#include <cuda_runtime.h>

#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "device_utils.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 96;        // descriptor rows of an assignment block
constexpr int kCenters = 128;    // centers of an assignment tile
constexpr int kDepth = 16;       // feature dimensions staged per step
constexpr int kStages = 3;       // cp.async ring
constexpr int kRowsPerThread = kRows / 16;
constexpr int kLdA = kDepth + 4;  // a staged row, 16-byte aligned for float4 reads
constexpr int kStageA = kRows * kLdA;
constexpr int kStageB = kDepth * kCenters;
constexpr int kSmemAssign = kStages * (kStageA + kStageB) * 4;
constexpr float kSkipLimit = 1e15f;  // |x|, |c| below which a skipped distance is finite
constexpr int kGatherWarps = 8;      // warps of a gather block
constexpr int kVladClusters = 4;     // clusters of a VLAD gather warp (Lloyd: 1)
constexpr int kChunk = 2048;         // labels and weights staged per gather step
constexpr int kList = 128;           // listed rows of a gather warp before they are added

__host__ __device__ inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// Scratch of one call, in 4-byte words, each part 256-byte aligned.
struct Plan {
  int DP, KP;  // ct's rows (D padded) and columns (K padded)
  long long ct, c2, nf, flags, err, ipart, total;
};

Plan make_plan(int B, int N, int D, int K, bool lloyd) {
  Plan p;
  p.DP = static_cast<int>(round_up(D, kDepth));
  p.KP = static_cast<int>(round_up(K, kCenters));
  long long at = 0;
  p.ct = at;    at += round_up(static_cast<long long>(p.DP) * p.KP, 64);
  p.c2 = at;    at += round_up(p.KP, 64);
  p.nf = at;    at += round_up(static_cast<long long>(B) * D, 64);
  p.flags = at; at += 64;  // [0]: a weightless row's err is not finite; [1]: blocks done
  p.err = at;   if (lloyd) at += round_up(N, 64);
  p.ipart = at; if (lloyd) at += round_up(K, 64);
  p.total = at;
  return p;
}

// Block (j, i) of the first gridDim.y - 1 rows copies the 32 x 32 tile
// (centers 32j.., dimensions 32i..) into ct through shared memory. Block
// (j, last) takes the squared norms of centers 32j..32j+31 (warp w the four
// from 32j + 4w: lane-strided FMAs and a shuffle tree each) and zeroes a
// stride of `zero`.
__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ centers, float* __restrict__ ct, float* __restrict__ c2,
            int* __restrict__ zero, long long n_zero, int D, int K, int DP, int KP) {
  __shared__ float tile[32][33];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * 32;
  if (blockIdx.y + 1 == gridDim.y) {
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid; i < n_zero;
         i += static_cast<long long>(gridDim.x) * kThreads)
      zero[i] = 0;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = lane; d < D; d += 32)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + warp * 4 + q;
        if (k < K) {
          const float v = centers[static_cast<size_t>(k) * D + d];
          s[q] = fmaf(v, v, s[q]);
        }
      }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (int off = 16; off > 0; off >>= 1) s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
      if (lane == 0) c2[k0 + warp * 4 + q] = s[q];
    }
    return;
  }
  const int d0 = blockIdx.y * 32;
  for (int i = warp; i < 32; i += kThreads / 32) {
    const int k = k0 + i, d = d0 + lane;
    tile[i][lane] = (k < K && d < D) ? centers[static_cast<size_t>(k) * D + d] : 0.f;
  }
  __syncthreads();
  for (int i = warp; i < 32; i += kThreads / 32) {
    const int d = d0 + i;
    if (d < DP) ct[static_cast<size_t>(d) * KP + k0 + lane] = tile[lane][i];
  }
}

__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Block i assigns rows [96 i, 96 i + 96) of the (rows, D) matrix desc, whose
// sets are N rows each. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 r (r < 6) and centers 4 tx.. and 64 + 4 tx.. of each tile. VEC is
// the row copies' width in floats: 2 where D is even and desc 8-byte aligned.
template <int VEC, bool LLOYD>
__global__ void __launch_bounds__(kThreads, 2)
assign_kernel(const float* __restrict__ desc, const float* __restrict__ mask,
              const float* __restrict__ ct, const float* __restrict__ c2,
              int* __restrict__ labels, float* __restrict__ err, int* __restrict__ nf,
              int* __restrict__ flags, int rows, int N, int D, int K, int KP, bool aligned16) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, rows - row0);
  const float* x0 = desc + static_cast<size_t>(row0) * D;

  // Counts a non-finite x[row0 + r, d] (e = r * D + d) in nf.
  auto count = [&](long long e) {
    const int r = static_cast<int>(e / D);
    const long long d = e - static_cast<long long>(r) * D;
    atomicAdd(nf + static_cast<size_t>((row0 + r) / N) * D + d, 1);
  };

  bool count_nf = true;
  if (__syncthreads_and(tid >= n_rows || mask[row0 + tid] == 0.f)) {
    // Every row weighs 0: read them once for nf (and, for Lloyd, the bound).
    bool big = false, bad = false;
    auto check = [&](float v, long long e) {
      if (!isfinite(v)) {
        bad = true;
        count(e);
      } else {
        big |= fabsf(v) > kSkipLimit;
      }
    };
    const long long len = static_cast<long long>(n_rows) * D;
    long long e0 = 0;
    if (aligned16) {  // x0 is then 16-byte aligned too: 96 D floats per block
      const float4* x4 = reinterpret_cast<const float4*>(x0);
      const long long n4 = len / 4;
      for (long long i = tid; i < n4; i += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long j = i + u * kThreads;
          v[u] = j < n4 ? __ldg(x4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q) check(component(v[u], q), 4 * (i + u * kThreads) + q);
      }
      e0 = 4 * n4;
    }
    for (long long e = e0 + tid; e < len; e += kThreads) check(__ldg(x0 + e), e);
    count_nf = false;
    if (LLOYD)
      for (int k = tid; k < K; k += kThreads) big |= !(c2[k] <= kSkipLimit * kSkipLimit);
    if (!LLOYD || !__syncthreads_or(big)) {
      if (tid < n_rows) labels[row0 + tid] = -1;
      if (LLOYD && __syncthreads_or(bad) && tid == 0) atomicOr(flags, 1);
      return;
    }
  }

  float* As = smem;
  float* Bs = smem + kStages * kStageA;
  const int n_dsteps = (D + kDepth - 1) / kDepth;
  const int n_steps = (K + kCenters - 1) / kCenters * n_dsteps;
  constexpr int kPerRow = kDepth / VEC;
  constexpr int kCopiesA = kRows * kPerRow / kThreads;
  static_assert(kRows * kPerRow % kThreads == 0, "row copies must divide among the threads");

  auto stage = [&](int s) {
    if (s < n_steps) {
      const int kt = s / n_dsteps;
      const int d0 = (s - kt * n_dsteps) * kDepth;
      float* as = As + (s % kStages) * kStageA;
      float* bs = Bs + (s % kStages) * kStageB;
#pragma unroll
      for (int j = 0; j < kCopiesA; ++j) {
        const int e = tid + j * kThreads;
        const int r = e / kPerRow, c = e % kPerRow * VEC;
        const bool ok = r < n_rows && d0 + c < D;
        const float* src = ok ? x0 + static_cast<size_t>(r) * D + d0 + c : desc;
        if (VEC == 2)
          cp_async8(as + r * kLdA + c, src, ok);
        else
          cp_async4(as + r * kLdA + c, src, ok);
      }
#pragma unroll
      for (int j = 0; j < kStageB / 4 / kThreads; ++j) {
        const int e = tid + j * kThreads;
        const int dr = e / (kCenters / 4), c4 = e % (kCenters / 4);
        cp_async16(bs + dr * kCenters + c4 * 4,
                   ct + static_cast<size_t>(d0 + dr) * KP + kt * kCenters + c4 * 4, true);
      }
    }
    cp_async_commit();
  };

  const int tx = tid & 15, ty = tid >> 4;
  float acc[kRowsPerThread][8], best[kRowsPerThread];
  int bk[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    best[i] = INFINITY;
    bk[i] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  // Lloyd's ||x||^2: thread t < 2 kRows adds the squares of half t % 2 of
  // row t / 2's slices while the first center tile is staged.
  __shared__ float s_x2[kRows];
  float x2 = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage(s);
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    const int kt = s / n_dsteps, ds = s - kt * n_dsteps;
    const float* as = As + (s % kStages) * kStageA;
    const float* bs = Bs + (s % kStages) * kStageB;
    __syncthreads();
    stage(s + kStages - 1);
    if (LLOYD && kt == 0 && tid < 2 * kRows) {
      const float* v = as + (tid >> 1) * kLdA + (tid & 1) * (kDepth / 2);
#pragma unroll
      for (int q = 0; q < kDepth / 2; ++q) x2 = fmaf(v[q], v[q], x2);
    }
#pragma unroll
    for (int q4 = 0; q4 < kDepth / 4; ++q4) {
      float4 a[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kLdA + q4 * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* brow = bs + (q4 * 4 + q) * kCenters;
        const float4 b0 = *reinterpret_cast<const float4*>(brow + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 64 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float av = component(a[i], q);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    if (ds == n_dsteps - 1) {
      if (LLOYD && kt == 0) {
        x2 += __shfl_xor_sync(0xffffffffu, x2, 1);
        if (tid < 2 * kRows && (tid & 1) == 0) s_x2[tid >> 1] = x2;
      }
      if (kt == 0 && count_nf && tx == 0) {
        // A non-finite x makes every dot product of its row non-finite, 0 *
        // inf included: such a row's values are counted one by one.
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int r = ty + 16 * i;
          if (r < n_rows && !isfinite(acc[i][0]))
            for (int d = 0; d < D; ++d)
              if (!isfinite(x0[static_cast<size_t>(r) * D + d]))
                count(static_cast<long long>(r) * D + d);
        }
      }
      // The tile's last slice: fold its distances into the running minimum.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = kt * kCenters + (j < 4 ? tx * 4 + j : 60 + tx * 4 + j);
        const float ck = k < K ? c2[k] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          // ||x||^2 is the same for every k of a row and is left out.
          const float dist = fmaf(-2.f, acc[i][j], ck);
          if (k < K && dist < best[i]) {
            best[i] = dist;
            bk[i] = k;
          }
          acc[i][j] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  if (LLOYD) __syncthreads();  // s_x2 is written

  // The 16 threads of a row group are one half of a warp.
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int ok = __shfl_xor_sync(0xffffffffu, bk[i], off);
      if (ob < best[i] || (ob == best[i] && ok < bk[i])) {
        best[i] = ob;
        bk[i] = ok;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + 16 * i;
      if (r < n_rows) {
        const float w = mask[row0 + r];
        labels[row0 + r] = w != 0.f ? bk[i] : -1;
        if (LLOYD) {
          const float e = max_nan(s_x2[r] + best[i], 0.f);
          err[row0 + r] = e;
          if (w == 0.f && !(e <= FLT_MAX)) atomicOr(flags, 1);
        }
      }
    }
  }
}

// The gather pass's shape: G clusters a warp, LC columns a lane (32 apart),
// the loads of BATCH rows issued together.
template <bool LLOYD>
struct Gather {
  static constexpr int G = LLOYD ? 1 : kVladClusters;
  static constexpr int LC = LLOYD ? 2 : 4;
  static constexpr int BATCH = LLOYD ? 8 : 4;
  static constexpr int KB = kGatherWarps * G;  // clusters of a block
  static constexpr int COLS = 32 * LC;         // columns of a block
  // Dynamic shared memory: two chunks of labels and weights, the chunk's
  // rows of the block's clusters, and each warp's list of rows to add.
  static constexpr int kSmem = 2 * kChunk * 8 + kChunk * 9 + kGatherWarps * kList * 9;
};

// Non-finite x[n, d] among the rows n of set b (set0 = b * N) in cluster
// k with nonzero weight: the slow path of a sum that came out +-inf.
__device__ __noinline__ int own_nonfinite(const float* __restrict__ desc,
                                          const float* __restrict__ mask,
                                          const int* __restrict__ labels, size_t set0, int N,
                                          int D, int k, int d) {
  int own = 0;
  for (int n = 0; n < N; ++n)
    own += labels[set0 + n] == k && mask[set0 + n] != 0.f &&
           !isfinite(desc[(set0 + n) * D + d]);
  return own;
}

// Block x takes set x / groups and the S * KB clusters from kb = S KB (x %
// groups), KB at a time (in step t, warp w the G from kb + KB t + G w), and
// columns [COLS y, COLS (y + 1)): lane l the columns COLS y + l + 32 c.
// S > 1 only when a set fits one chunk, whose compacted rows then serve
// every step. VLAD writes out (B, K, D) residuals; Lloyd writes out (K, D)
// sums and, from column block 0, counts and the inertia.
template <bool LLOYD>
__global__ void __launch_bounds__(kThreads, 3)
gather_kernel(const float* __restrict__ desc, const float* __restrict__ mask,
              const float* __restrict__ centers, const int* __restrict__ labels,
              const float* __restrict__ err, const int* __restrict__ nf, float* __restrict__ out,
              float* __restrict__ counts, float* __restrict__ ipart, int* __restrict__ flags,
              float* __restrict__ inertia, int N, int D, int K, int groups, int S) {
  using P = Gather<LLOYD>;
  constexpr int G = P::G, LC = P::LC;
  extern __shared__ __align__(16) unsigned char gsmem[];
  int* s_lab = reinterpret_cast<int*>(gsmem);                  // [2][kChunk]
  float* s_w = reinterpret_cast<float*>(s_lab + 2 * kChunk);   // [2][kChunk]
  int* c_row = reinterpret_cast<int*>(s_w + 2 * kChunk);       // [kChunk]
  float* c_w = reinterpret_cast<float*>(c_row + kChunk);       // [kChunk]
  int* l_row = reinterpret_cast<int*>(c_w + kChunk);           // [warps][kList]
  float* l_w = reinterpret_cast<float*>(l_row + kGatherWarps * kList);
  unsigned char* c_slot = reinterpret_cast<unsigned char*>(l_w + kGatherWarps * kList);
  unsigned char* l_slot = c_slot + kChunk;                     // [warps][kList]
  __shared__ int s_count[kGatherWarps];
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / groups;
  const int kb = blockIdx.x % groups * S * P::KB;
  const int col0 = blockIdx.y * P::COLS + lane;
  const size_t set0 = static_cast<size_t>(b) * N;
  const float* xb = desc + set0 * D + col0;
  int* my_row = l_row + warp * kList;
  float* my_w = l_w + warp * kList;
  unsigned char* my_slot = l_slot + warp * kList;

  float acc[G][LC], cnt[G], ie;

  // Adds the warp's listed rows in list order, which is row order for each
  // cluster, the loads of BATCH rows issued together.
  int n_list = 0;
  auto flush = [&]() {
    __syncwarp();
    for (int j0 = 0; j0 < n_list; j0 += P::BATCH) {
      float xv[P::BATCH][LC], ev[P::BATCH];
#pragma unroll
      for (int q = 0; q < P::BATCH; ++q) {
        const bool ok = j0 + q < n_list;
        const int row = ok ? my_row[j0 + q] : 0;
        const float* x = xb + static_cast<size_t>(row) * D;
#pragma unroll
        for (int c = 0; c < LC; ++c) xv[q][c] = ok && col0 + 32 * c < D ? __ldg(x + 32 * c) : 0.f;
        if (LLOYD) ev[q] = ok ? err[set0 + row] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < P::BATCH; ++q) {
        if (j0 + q >= n_list) break;
        const float w = my_w[j0 + q];
        const int slot = my_slot[j0 + q];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g != slot) continue;
          cnt[g] += w;
          if (LLOYD) ie = fmaf(w, ev[q], ie);
#pragma unroll
          for (int c = 0; c < LC; ++c) acc[g][c] = fmaf(w, xv[q][c], acc[g][c]);
        }
      }
    }
    n_list = 0;
    __syncwarp();
  };

  // Chunk i of labels and weights goes to buffer i % 2 by cp.async, one
  // chunk ahead of its scan.
  auto fetch = [&](int n0) {
    int* lab = s_lab + (n0 / kChunk % 2) * kChunk;
    float* w = s_w + (n0 / kChunk % 2) * kChunk;
    const int len = min(kChunk, N - n0);
    for (int i = tid; i < len; i += kThreads) {
      cp_async4(lab + i, labels + set0 + n0 + i, true);
      cp_async4(w + i, mask + set0 + n0 + i, true);
    }
    cp_async_commit();
  };
  fetch(0);
  int n_bad[LC];  // the set's non-finite values in each of the lane's columns
#pragma unroll
  for (int c = 0; c < LC; ++c)
    n_bad[c] = col0 + 32 * c < D ? nf[static_cast<size_t>(b) * D + col0 + 32 * c] : 0;
  int total = 0;  // the chunk's compacted rows
  for (int t = 0; t < S; ++t) {
    const int k0 = kb + t * P::KB + warp * G;
    const int slot0 = t * P::KB + warp * G;
    ie = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      cnt[g] = 0.f;
#pragma unroll
      for (int c = 0; c < LC; ++c) acc[g][c] = 0.f;
    }
    for (int n0 = 0; n0 < N; n0 += kChunk) {
      if (t == 0) {
        cp_async_wait<0>();
        __syncthreads();  // this chunk has landed; the last one's lists are consumed
        if (n0 + kChunk < N) fetch(n0 + kChunk);
        const int* lab = s_lab + (n0 / kChunk % 2) * kChunk;
        const float* wt = s_w + (n0 / kChunk % 2) * kChunk;
        // The block's rows in row order: warp w compacts the chunk's 32-row
        // groups [w R, (w + 1) R).
        constexpr int kRounds = kChunk / kGatherWarps / 32;
        const int len = min(kChunk, N - n0);
        const int R = ((len + 31) / 32 + kGatherWarps - 1) / kGatherWarps;
        unsigned hits[kRounds];
        int mine = 0;
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          const int i = (warp * R + r) * 32 + lane;
          bool hit = false;
          if (r < R && i < len) {
            const int l = lab[i];
            hit = wt[i] != 0.f && l >= kb && l < kb + S * P::KB;
          }
          hits[r] = __ballot_sync(0xffffffffu, hit);
          mine += __popc(hits[r]);
        }
        if (lane == 0) s_count[warp] = mine;
        __syncthreads();
        int at = 0;
        total = 0;
#pragma unroll
        for (int w = 0; w < kGatherWarps; ++w) {
          at += w < warp ? s_count[w] : 0;
          total += s_count[w];
        }
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          if (hits[r] >> lane & 1u) {
            const int i = (warp * R + r) * 32 + lane;
            const int j = at + __popc(hits[r] & ((1u << lane) - 1u));
            c_row[j] = n0 + i;
            c_w[j] = wt[i];
            c_slot[j] = static_cast<unsigned char>(lab[i] - kb);
          }
          at += __popc(hits[r]);
        }
        __syncthreads();
      }
      // Each warp lists its clusters' rows.
      for (int j0 = 0; j0 < total; j0 += 32) {
        if (n_list > kList - 32) flush();
        const int j = j0 + lane;
        const int slot = j < total ? c_slot[j] - slot0 : -1;
        const bool hit = slot >= 0 && slot < G;
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (hit) {
          const int to = n_list + __popc(ballot & ((1u << lane) - 1u));
          my_row[to] = c_row[j];
          my_w[to] = c_w[j];
          my_slot[to] = static_cast<unsigned char>(slot);
        }
        n_list += __popc(ballot);
      }
    }
    flush();

#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int k = k0 + g;
      if (k >= K) break;
      float* ob = out + (static_cast<size_t>(b) * K + k) * D;
      float cv[LC];  // all of a cluster's loads in flight before the first use
#pragma unroll
      for (int c = 0; c < LC; ++c)
        cv[c] = !LLOYD && col0 + 32 * c < D
                    ? __ldg(centers + static_cast<size_t>(k) * D + col0 + 32 * c)
                    : 0.f;
#pragma unroll
      for (int c = 0; c < LC; ++c) {
        const int d = col0 + 32 * c;
        if (d >= D) continue;
        const float a = acc[g][c];
        float v = LLOYD ? a : fmaf(-cnt[g], cv[c], a);
        // A non-finite value in a row that is not the cluster's own makes
        // the one-hot product 0 * NaN or 0 * inf. The cluster's own
        // non-finite values leave a NaN (which stays) or +-inf in the sum;
        // only then must they be counted.
        if (n_bad[c] > 0 && !isnan(a) &&
            (!isinf(a) || n_bad[c] > own_nonfinite(desc, mask, labels, set0, N, D, k, d)))
          v = NAN;
        ob[d] = v;
      }
      if (LLOYD && blockIdx.y == 0 && lane == 0) {
        counts[k] = cnt[g];
        ipart[k] = ie;
      }
    }
  }
  if (LLOYD && blockIdx.y == 0) {
    // The last block of column slice 0 adds the clusters' inertia in order.
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(flags + 1, 1) == groups - 1;
    __syncthreads();
    if (s_last && warp == 0) {
      __threadfence();
      float s = 0.f;
      for (int kk = lane; kk < K; kk += 32) s += __ldcg(ipart + kk);
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) *inertia = __ldcg(flags) ? NAN : s;
    }
  }
}

template <int VEC, bool LLOYD>
cudaError_t launch_assign(const float* desc, const float* mask, const float* ct, const float* c2,
                          int* labels, float* err, int* nf, int* flags, int rows, int N, int D,
                          int K, int KP, bool aligned16, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(assign_kernel<VEC, LLOYD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemAssign);
  if (e != cudaSuccess) return e;
  assign_kernel<VEC, LLOYD><<<(rows + kRows - 1) / kRows, kThreads, kSmemAssign, stream>>>(
      desc, mask, ct, c2, labels, err, nf, flags, rows, N, D, K, KP, aligned16);
  return cudaGetLastError();
}

template <bool LLOYD>
cudaError_t launch_gather(const float* desc, const float* mask, const float* centers,
                          const int* labels, const float* err, const int* nf, float* out,
                          float* counts, float* ipart, int* flags, float* inertia, int B, int N,
                          int D, int K, cudaStream_t stream) {
  using P = Gather<LLOYD>;
  cudaError_t e = cudaFuncSetAttribute(gather_kernel<LLOYD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  // A set that fits one chunk takes up to 256 clusters a block (its slots
  // are bytes), as long as the grid keeps 3 blocks an SM.
  const int n_groups = (K + P::KB - 1) / P::KB;
  const long long col_blocks = (D + P::COLS - 1) / P::COLS;
  int S = 1;
  if (N <= kChunk)
    S = static_cast<int>(std::max(1LL, std::min({static_cast<long long>(n_groups),
                                                  256LL / P::KB,
                                                  B * col_blocks * n_groups / (3LL * sms)})));
  const int groups = (n_groups + S - 1) / S;
  const dim3 grid(B * groups, static_cast<unsigned>(col_blocks));
  gather_kernel<LLOYD><<<grid, kThreads, P::kSmem, stream>>>(
      desc, mask, centers, labels, err, nf, out, counts, ipart, flags, inertia, N, D, K, groups,
      S);
  return cudaGetLastError();
}

// The three passes of one call on `stream`. scratch holds make_plan's
// words; counts and inertia are Lloyd's (null for VLAD).
template <bool LLOYD>
cudaError_t run(const float* desc, const float* mask, const float* centers, void* scratch,
                int* labels, float* out, float* counts, float* inertia, int B, int N, int D,
                int K, cudaStream_t stream) {
  const Plan p = make_plan(B, N, D, K, LLOYD);
  float* words = static_cast<float*>(scratch);
  float* ct = words + p.ct;
  float* c2 = words + p.c2;
  int* nf = reinterpret_cast<int*>(words + p.nf);
  int* flags = reinterpret_cast<int*>(words + p.flags);
  float* err = LLOYD ? words + p.err : nullptr;
  float* ipart = LLOYD ? words + p.ipart : nullptr;

  prep_kernel<<<dim3(p.KP / 32, (p.DP + 31) / 32 + 1), kThreads, 0, stream>>>(
      centers, ct, c2, nf, p.flags + 64 - p.nf, D, K, p.DP, p.KP);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const uintptr_t at = reinterpret_cast<uintptr_t>(desc);
  const bool aligned16 = at % 16 == 0;
  e = (D % 2 == 0 && at % 8 == 0)
          ? launch_assign<2, LLOYD>(desc, mask, ct, c2, labels, err, nf, flags, B * N, N, D, K,
                                    p.KP, aligned16, stream)
          : launch_assign<1, LLOYD>(desc, mask, ct, c2, labels, err, nf, flags, B * N, N, D, K,
                                    p.KP, aligned16, stream);
  if (e != cudaSuccess) return e;
  return launch_gather<LLOYD>(desc, mask, centers, labels, err, nf, out, counts, ipart, flags,
                              inertia, B, N, D, K, stream);
}

}  // namespace

extern "C" {

// Scratch words (4 bytes each) that one call needs.
long long aggregate_scratch_words(int B, int N, int D, int K, int lloyd) {
  return make_plan(B, N, D, K, lloyd != 0).total;
}

const char* vlad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the three passes on `stream` and returns the CUDA error status
// (0 on success). labels (B*N) are written too: -1 for rows of zero weight.
int vlad_aggregate_f32(const float* desc, const float* mask, const float* centers,
                       void* scratch, int* labels, float* out, int B, int N, int D, int K,
                       int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return run<false>(desc, mask, centers, scratch, labels, out, nullptr, nullptr, B, N, D, K,
                    static_cast<cudaStream_t>(stream_ptr));
}

// Lloyd statistics of one (N, D) set: sums (K, D), counts (K), inertia (1)
// and labels (N), -1 for rows of zero weight.
int lloyd_stats_f32(const float* desc, const float* mask, const float* centers, void* scratch,
                    int* labels, float* sums, float* counts, float* inertia, int N, int D, int K,
                    int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return run<true>(desc, mask, centers, scratch, labels, sums, counts, inertia, 1, N, D, K,
                   static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
