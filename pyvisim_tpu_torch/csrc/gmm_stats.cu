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
// cst = log w - 0.5 (D log 2pi + sum log sigma^2 + sum mu^2 / sigma^2).
// One entry point serves Fisher-vector encoding (a batch of sets, e.g.
// 128 x 196 rows) and an EM step (one set of 25,088 rows).
//
// Bound. The products are 8*B*N*K*D flops on the rows that carry weight:
// 13.2 GFLOP at B=128, N=196, D=257, K=256, ~0.2 ms at the card's 67 TFLOP/s
// of f32, against ~93 MB in and out (~0.03 ms). So operations bound it. The
// EM form pins full f32 (Precision.HIGHEST in JAX: the M-step's
// s2/nk - mu^2 cancels), so every product is an f32 FMA written here: no
// TF32, no library call.
//
// Design. Each pass is one product in GEMM shape on the CUDA cores: 4x8 or
// 8x8 outputs a thread, 16-byte shared loads, a 3-stage cp.async ring.
//   0. prep_kernel: Bt = [minv | -half_inv]^T, (2D padded to 16) x K padded,
//      cst, and the bounds that let a masked row skip its products (below).
//   1. logp_kernel: logp = [x, x^2] . Bt + cst over a depth of 2D, 32 rows x
//      256 components a block; x^2 is squared in shared memory by the thread
//      that copied x. With K <= 256 the block holds all of its rows'
//      components and normalises them on chip: it writes the masked
//      posteriors q and the logsumexp once. A larger K writes logp, and
//      softmax_kernel normalises it in place.
//   2. stats_kernel: [s1 | s2] = q^T . [x, x^2] per set, 128 components x W
//      columns a block (W = 8 * ceil(2D / 8T) for the fewest T tiles with
//      W <= 128: 5 x 104 for 514 columns, 1 x 128 for 128), s0 summed
//      beside it; sets of more than seg rows are cut into segments whose
//      partials reduce.cuh sums in order.
//   3. masked_row_sum_kernel (reduce.cuh): ll, one block per set.
// No float atomics, and every sum runs in a fixed order, so results repeat
// bit for bit.
//
// Masked rows. q = softmax * m is exactly 0 on a row of weight 0 whose
// logp is finite, so such a row adds exactly nothing, and pass 1 may skip a
// block of 32 rows that all weigh 0 when it can show that: every |x| is
// finite, and a * P + a^2 * Q + C < 1e37 with a = max |x| of the block,
// P = max_k sum_d |minv|, Q = max_k sum_d half_inv, C = max_k |cst_k| over
// the components with cst_k > -inf (prep_kernel; a NaN or +inf in any of
// them, or no finite cst, forbids every skip). A skipped block writes
// lse = 0 and flags its rows, and pass 2 zero-fills their q and x and skips
// a 16-row step whose rows are all flagged. A block holding a NaN, or a
// value that could overflow logp, computes, so the NaN reaches its set's
// statistics as it does in the plain version.

#include <cuda_runtime.h>

#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "device_utils.cuh"
#include "reduce.cuh"

namespace {

constexpr int kDepth = 16;   // depth staged per step: features (pass 1), rows (pass 2)
constexpr int kStages = 3;   // cp.async ring
constexpr int kRows1 = 32;   // pass 1: rows of a block
constexpr int kComps1 = 256; // pass 1: components of a block
constexpr int kThreads1 = 256;
constexpr int kApad = kRows1 + 4;    // a staged depth slice of x, 16-byte aligned
constexpr int kLpad = kComps1 + 4;   // a row of the block's logp tile
constexpr int kStageA = kDepth * kApad;
constexpr int kStageB = kDepth * kComps1;
constexpr int kRingFloats1 = kStages * (kStageA + kStageB);
constexpr int kTileFloats1 = kRows1 * kLpad;
constexpr int kSmem1 = 4 * (kRingFloats1 > kTileFloats1 ? kRingFloats1 : kTileFloats1);
constexpr int kComps2 = 128; // pass 2: components of a block
constexpr int kMaxSteps = 256;  // 16-row steps of a segment: seg <= 4096
constexpr int kMaxSeg = kMaxSteps * kDepth;
constexpr int kPrepThreads = 128;
constexpr float kSkipLimit = 1e37f;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Layout of one call, shared by the planner and the launch.
struct Plan {
  int DP, KB, KQ;  // Bt rows (2D padded), Bt columns, q's row stride
  int W, T;        // pass 2 column tile and tiles
  int seg, S;      // rows per segment, segments per set
  long long bt, cst, bounds, q, lse, flag, part, total;  // scratch offsets, in floats
};

Plan make_plan(int B, int N, int D, int K) {
  Plan p;
  p.DP = round_up(2 * D, kDepth);
  p.KB = round_up(K, kComps1);
  p.KQ = round_up(K, kComps2);
  for (p.T = 1;; ++p.T) {
    p.W = 8 * ((2 * D + 8 * p.T - 1) / (8 * p.T));
    if (p.W <= 128) break;
  }
  const int blocks_per_set = (p.KQ / kComps2) * p.T;
  int S = 1;
  if (B * blocks_per_set < 128) S = (264 + B * blocks_per_set - 1) / (B * blocks_per_set);
  S = std::min(S, std::max(1, N / 256));
  S = std::max(S, (N + kMaxSeg - 1) / kMaxSeg);
  p.seg = round_up((N + S - 1) / S, kDepth);
  if (p.seg < 1) p.seg = kDepth;
  p.S = std::max(1, (N + p.seg - 1) / p.seg);
  const long long rows = static_cast<long long>(B) * N;
  auto align = [](long long x) { return (x + 63) / 64 * 64; };
  long long at = 0;
  p.bt = at;     at += align(static_cast<long long>(p.DP) * p.KB);
  p.cst = at;    at += align(K);
  p.bounds = at; at += 64;
  p.q = at;      at += align(rows * p.KQ);
  p.lse = at;    at += align(rows);
  p.flag = at;   at += align((rows + 3) / 4);
  p.part = at;
  if (p.S > 1) at += align(static_cast<long long>(B) * p.S * (K + 2LL * K * D));
  p.total = at;
  return p;
}

// Non-negative floats order as their bits; NaN sorts above +inf.
__device__ __forceinline__ unsigned order_key(float v) {
  return v == v ? __float_as_uint(v) : 0x7fffffffu;
}

// ---------------------------------------------------------------------------
// Pass 0: the GMM's terms. Block k (of KB) computes, as gmm_terms does,
// minv = mu / sigma^2 and half_inv = 0.5 / sigma^2 into column k of
// Bt = [minv | -half_inv]^T, and cst_k = log w_k - 0.5 (D log 2pi +
// sum log sigma^2 + sum mu minv) (the sums in a fixed tree order); and the
// skip bounds: P, Q, C as order keys (atomicMax of keys is exact and
// order-free), and 1 if any cst is finite.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const float* __restrict__ weights, const float* __restrict__ means,
            const float* __restrict__ covs, float* __restrict__ bt, float* __restrict__ cst,
            unsigned* __restrict__ bounds, int D, int K, int DP, int KB, float d_log_2pi) {
  __shared__ float s_sum[4][kPrepThreads];
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  float p = 0.f, h = 0.f, logs = 0.f, quad = 0.f;
  for (int j = t; j < DP; j += kPrepThreads) {
    float v = 0.f;
    if (k < K && j < 2 * D) {
      const size_t at = static_cast<size_t>(k) * D + (j < D ? j : j - D);
      const float inv = 1.0f / covs[at];
      if (j < D) {
        const float mu = means[at];
        v = mu * inv;
        p += fabsf(v);
        logs += logf(covs[at]);
        quad += mu * v;
      } else {
        v = -(0.5f * inv);
        h += fabsf(v);
      }
    }
    bt[static_cast<size_t>(j) * KB + k] = v;
  }
  s_sum[0][t] = p;
  s_sum[1][t] = h;
  s_sum[2][t] = logs;
  s_sum[3][t] = quad;
  __syncthreads();
  for (int width = kPrepThreads / 2; width > 0; width >>= 1) {
    if (t < width)
#pragma unroll
      for (int i = 0; i < 4; ++i) s_sum[i][t] += s_sum[i][t + width];
    __syncthreads();
  }
  if (t == 0 && k < K) {
    const float c = logf(weights[k]) - 0.5f * (d_log_2pi + s_sum[2][0] + s_sum[3][0]);
    cst[k] = c;
    atomicMax(bounds + 0, order_key(s_sum[0][0]));
    atomicMax(bounds + 1, order_key(s_sum[1][0]));
    if (c != -INFINITY) {
      atomicMax(bounds + 2, c < INFINITY ? order_key(fabsf(c)) : 0x7fffffffu);
      atomicMax(bounds + 3, 1u);
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 1: logp (and, when kFused, the masked softmax). Block (bx, by) takes
// rows bx*32.. and components by*256..; warp w components w*32.., lane a
// 4 x 8 tile whose components are two halves 16 apart, so that the lanes of
// a warp read contiguous shared memory. Three blocks fit an SM, so the
// 784 blocks of a 25,088-row call run in two even rounds.
// ---------------------------------------------------------------------------
template <bool kFused>
__global__ void __launch_bounds__(kThreads1, 3)
logp_kernel(const float* __restrict__ desc, const float* __restrict__ mask,
            const float* __restrict__ bt, const float* __restrict__ cst,
            const unsigned* __restrict__ bounds, float* __restrict__ q,
            float* __restrict__ lse, unsigned char* __restrict__ flag, int rows, int D, int K,
            int DP, int KB, int KQ) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_amax;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows1;
  const int k0 = blockIdx.y * kComps1;
  const int n_rows = min(kRows1, rows - row0);

  // A block of rows that all weigh 0 skips its products when it can show
  // they add nothing (see the file's comment).
  const bool weightless = tid >= n_rows || mask[row0 + tid] == 0.f;
  if (__syncthreads_and(weightless)) {
    if (tid == 0) s_amax = 0u;
    __syncthreads();
    const float* x = desc + static_cast<size_t>(row0) * D;
    float a = 0.f;
    bool bad = false;
    for (int e = tid; e < n_rows * D; e += kThreads1) {
      const float v = fabsf(__ldg(x + e));
      bad |= !(v <= FLT_MAX);
      a = fmaxf(a, v);
    }
    atomicMax(&s_amax, __float_as_uint(a));
    const bool any_bad = __syncthreads_or(bad);
    a = __uint_as_float(s_amax);
    const float P = __uint_as_float(bounds[0]), Q = __uint_as_float(bounds[1]),
                C = __uint_as_float(bounds[2]);
    if (!any_bad && bounds[3] != 0u && a * P + a * a * Q + C < kSkipLimit) {
      if (blockIdx.y == 0 && tid < n_rows) {
        lse[row0 + tid] = 0.f;
        flag[row0 + tid] = 1;
      }
      return;
    }
  }

  float* As = smem;
  float* Bs = smem + kStages * kStageA;
  const int n_steps = DP / kDepth;
  const int two_d = 2 * D;

  // A thread stages rows a_row + 16i (i < 2) of depth column a_dd.
  const int a_row = tid >> 4, a_dd = tid & 15;
  auto stage_copies = [&](int s) {
    if (s < n_steps) {
      float* as = As + (s % kStages) * kStageA;
      float* bs = Bs + (s % kStages) * kStageB;
      const int j0 = s * kDepth;
      const int j = j0 + a_dd;
      const float* x_col = desc + static_cast<size_t>(row0) * D + (j < D ? j : j - D);
#pragma unroll
      for (int i = 0; i < kRows1 / 16; ++i) {
        const int r = a_row + 16 * i;
        const bool ok = r < n_rows && j < two_d;
        cp_async4(as + a_dd * kApad + r, ok ? x_col + static_cast<size_t>(r) * D : desc, ok);
      }
#pragma unroll
      for (int i = 0; i < kDepth * kComps1 / 4 / kThreads1; ++i) {
        const int e = tid + i * kThreads1;
        const int dr = e >> 6, c4 = e & 63;
        cp_async16(bs + dr * kComps1 + c4 * 4, bt + static_cast<size_t>(j0 + dr) * KB + k0 + c4 * 4,
                   true);
      }
    }
    cp_async_commit();
  };

  const int ar = (lane >> 2) * 4;             // rows ar..+3
  const int bc = warp * 32 + (lane & 3) * 4;  // components bc..+3, bc+16..+19
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage_copies(s);
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    float* as = As + (s % kStages) * kStageA;
    const float* bs = Bs + (s % kStages) * kStageB;
    // x^2 columns: each thread squares what it copied itself.
    if (s * kDepth + a_dd >= D) {
#pragma unroll
      for (int i = 0; i < kRows1 / 16; ++i) {
        float* v = as + a_dd * kApad + a_row + 16 * i;
        *v = *v * *v;
      }
    }
    __syncthreads();
    stage_copies(s + kStages - 1);
#pragma unroll
    for (int dd = 0; dd < kDepth; ++dd) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + dd * kApad + ar);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + dd * kComps1 + bc);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + dd * kComps1 + bc + 16);
      const float av[4] = {a0.x, a0.y, a0.z, a0.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float ck[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + bc + (j < 4 ? j : 12 + j);
    ck[j] = k < K ? cst[k] : 0.f;
  }

  if (!kFused) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ar + i;
      if (r >= n_rows) continue;
      float* out = q + static_cast<size_t>(row0 + r) * KQ;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + bc + (j < 4 ? j : 12 + j);
        if (k < K) out[k] = acc[i][j] + ck[j];
      }
    }
    if (blockIdx.y == 0 && tid < n_rows) flag[row0 + tid] = 0;
    return;
  }

  // The block holds every component of its rows: logp to shared memory
  // (over the ring, now drained), then one warp per row normalises it.
  __syncthreads();
  float* tile = smem;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* dst = tile + (ar + i) * kLpad + bc;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0] + ck[0], acc[i][1] + ck[1],
                                                  acc[i][2] + ck[2], acc[i][3] + ck[3]);
    *reinterpret_cast<float4*>(dst + 16) = make_float4(acc[i][4] + ck[4], acc[i][5] + ck[5],
                                                       acc[i][6] + ck[6], acc[i][7] + ck[7]);
  }
  __syncthreads();
  for (int r = warp; r < n_rows; r += kThreads1 / 32) {
    float* v = tile + r * kLpad;
    float m = -INFINITY;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, v[k]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float denom = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float e = expf(v[k] - m);
      v[k] = e;  // the lane's own entries: no other lane reads them
      denom += e;
    }
    for (int off = 16; off > 0; off >>= 1) denom += __shfl_xor_sync(0xffffffffu, denom, off);
    const float scale = mask[row0 + r] / denom;
    float* out = q + static_cast<size_t>(row0 + r) * KQ;
    for (int k = lane; k < K; k += 32) out[k] = v[k] * scale;
    if (lane == 0) {
      lse[row0 + r] = m + logf(denom);
      flag[row0 + r] = 0;
    }
  }
}

// K > 256: one warp per row turns logp into masked posteriors in place and
// writes the row's logsumexp; rows that pass 1 skipped are left as they are.
__global__ void __launch_bounds__(256)
softmax_kernel(float* __restrict__ q, const float* __restrict__ mask, float* __restrict__ lse,
               const unsigned char* __restrict__ flag, int rows, int K, int KQ) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  if (r >= rows || flag[r]) return;
  float* row = q + static_cast<size_t>(r) * KQ;
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

// ---------------------------------------------------------------------------
// Pass 2: statistics. Block (b * S + s, ky, cz) sums rows
// [s * seg, min((s + 1) * seg, N)) of set b into the (128 x W) tile
// (ky * 128.., cz * W..) of [s1 | s2] (columns c < D of s1, c >= D of s2),
// and, when cz == 0, s0. blockDim = 16 * W / 8: thread (tk, tc) owns
// components tk*4..+3, 64+tk*4..+3 and columns tc*4..+3, W/2+tc*4..+3.
// Warp 0 first lists the 16-row steps that hold a row pass 1 computed.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
stats_kernel(const float* __restrict__ desc, const float* __restrict__ q,
             const unsigned char* __restrict__ flag, float* __restrict__ p0,
             float* __restrict__ p1, float* __restrict__ p2, int N, int seg, int S, int D,
             int K, int KQ, int W) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int steps[kMaxSteps];
  __shared__ unsigned step_skipped[kMaxSteps];
  __shared__ int s_active;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int cg = W / 8;
  const int tk = tid / cg, tc = tid % cg;
  const int part = blockIdx.x;
  const int b = part / S;
  const int start = (part % S) * seg;
  const int len = min(seg, N - start);
  const int k0 = blockIdx.y * kComps2;
  const int c0 = blockIdx.z * W;
  const size_t row0 = static_cast<size_t>(b) * N + start;
  const unsigned char* fl = flag + row0;
  const float* qb = q + row0 * KQ;
  const float* xb = desc + row0 * D;
  const int two_d = 2 * D;
  const bool with_s0 = blockIdx.z == 0;
  const int stage_floats = kDepth * (kComps2 + W);

  if (tid < 32) {
    const unsigned members = nthreads >= 32 ? 0xffffffffu : (1u << nthreads) - 1u;
    const int n_steps = (len + kDepth - 1) / kDepth;
    int found = 0;
    for (int c = 0; c < n_steps; c += 32) {
      const int st = c + tid;
      unsigned skipped = 0xffffu;  // bit r: row st * 16 + r adds nothing
      if (st < n_steps) {
#pragma unroll
        for (int r = 0; r < kDepth; ++r) {
          const int n = st * kDepth + r;
          if (n < len && fl[n] == 0) skipped &= ~(1u << r);
        }
      }
      const bool active = skipped != 0xffffu;
      const unsigned ballot = __ballot_sync(members, active);
      if (active) {
        const int slot = found + __popc(ballot & ((1u << tid) - 1u));
        steps[slot] = st;
        step_skipped[slot] = skipped;
      }
      found += __popc(ballot);
    }
    if (tid == 0) s_active = found;
  }
  __syncthreads();
  const int n_active = s_active;

  // A thread stages rows x_row0 + 2j (j < 8) of one column of [x, x^2]
  // each step (16 * W = 8 * nthreads, nthreads = 2W).
  const int x_row0 = tid / W;
  const int x_col = c0 + tid % W;
  const bool x_in = x_col < two_d;
  const bool x_square = x_col >= D;
  const float* x_src = xb + (x_square ? x_col - D : x_col);

  auto stage_copies = [&](int i) {
    if (i < n_active) {
      float* qs = smem + (i % kStages) * stage_floats;
      float* xs = qs + kDepth * kComps2;
      const int n0 = steps[i] * kDepth;
      const unsigned skipped = step_skipped[i];
      for (int e = tid; e < kDepth * kComps2 / 4; e += nthreads) {
        const int r = e >> 5, c4 = e & 31;
        const bool ok = !((skipped >> r) & 1u);
        cp_async16(qs + r * kComps2 + c4 * 4,
                   ok ? qb + static_cast<size_t>(n0 + r) * KQ + k0 + c4 * 4 : qb, ok);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = x_row0 + 2 * j;
        const bool ok = x_in && !((skipped >> r) & 1u);
        cp_async4(xs + tid + j * nthreads, ok ? x_src + static_cast<size_t>(n0 + r) * D : xb, ok);
      }
    }
    cp_async_commit();
  };

  float acc[8][8], a0[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a0[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int ak = tk * 4;
  const int bcol = tc * 4;
  const int half = W / 2;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage_copies(i);
  for (int i = 0; i < n_active; ++i) {
    cp_async_wait<kStages - 2>();
    const float* qs = smem + (i % kStages) * stage_floats;
    float* xs = const_cast<float*>(qs) + kDepth * kComps2;
    // x^2 columns: each thread squares what it copied itself.
    if (x_square) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* v = xs + tid + j * nthreads;
        *v = *v * *v;
      }
    }
    __syncthreads();
    stage_copies(i + kStages - 1);
    if (with_s0) {
#pragma unroll 4
      for (int dd = 0; dd < kDepth; ++dd) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + dd * kComps2 + ak);
        const float4 qb2 = *reinterpret_cast<const float4*>(qs + dd * kComps2 + 64 + ak);
        const float4 x0 = *reinterpret_cast<const float4*>(xs + dd * W + bcol);
        const float4 x1 = *reinterpret_cast<const float4*>(xs + dd * W + half + bcol);
        const float av[8] = {qa.x, qa.y, qa.z, qa.w, qb2.x, qb2.y, qb2.z, qb2.w};
        const float bv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          a0[r] += av[r];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
      }
    } else {
#pragma unroll 4
      for (int dd = 0; dd < kDepth; ++dd) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + dd * kComps2 + ak);
        const float4 qb2 = *reinterpret_cast<const float4*>(qs + dd * kComps2 + 64 + ak);
        const float4 x0 = *reinterpret_cast<const float4*>(xs + dd * W + bcol);
        const float4 x1 = *reinterpret_cast<const float4*>(xs + dd * W + half + bcol);
        const float av[8] = {qa.x, qa.y, qa.z, qa.w, qb2.x, qb2.y, qb2.z, qb2.w};
        const float bv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();

  const size_t out0 = static_cast<size_t>(part) * K;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = k0 + (r < 4 ? ak + r : 60 + ak + r);
    if (k >= K) continue;
    if (with_s0 && tc == 0) p0[out0 + k] = a0[r];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + (c < 4 ? bcol + c : half - 4 + bcol + c);
      if (col < two_d) {
        const bool sq = col >= D;
        (sq ? p2 : p1)[(out0 + k) * D + (sq ? col - D : col)] = acc[r][c];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The scratch a call needs, in floats.
long long gmm_stats_scratch_floats(int B, int N, int D, int K) {
  return make_plan(B, N, D, K).total;
}

// Launches the passes on `stream` and returns the CUDA error status (0 on
// success). desc (B, N, D), mask (B, N), the GMM's weights (K), means and
// covariances (K, D);
// outputs s0 (B, K), s1 and s2 (B, K, D), and ll (B) unless it is null.
// scratch: gmm_stats_scratch_floats floats, 256-byte aligned.
int gmm_stats_f32(const float* desc, const float* mask, const float* weights,
                  const float* means, const float* covs, float* scratch, float* s0,
                  float* s1, float* s2, float* ll, int B, int N, int D, int K, int device,
                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Plan p = make_plan(B, N, D, K);
  const int rows = B * N;
  float* bt = scratch + p.bt;
  float* cst = scratch + p.cst;
  unsigned* bounds = reinterpret_cast<unsigned*>(scratch + p.bounds);
  float* q = scratch + p.q;
  float* lse = scratch + p.lse;
  unsigned char* flag = reinterpret_cast<unsigned char*>(scratch + p.flag);

  if ((err = cudaMemsetAsync(bounds, 0, 4 * sizeof(unsigned), stream)) != cudaSuccess) return err;
  prep_kernel<<<p.KB, kPrepThreads, 0, stream>>>(weights, means, covs, bt, cst, bounds, D, K,
                                                  p.DP, p.KB,
                                                  static_cast<float>(D * 1.8378770664093453));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid1((rows + kRows1 - 1) / kRows1, p.KB / kComps1);
  if (p.KB == kComps1) {
    if ((err = cudaFuncSetAttribute(logp_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSmem1)) != cudaSuccess)
      return err;
    logp_kernel<true><<<grid1, kThreads1, kSmem1, stream>>>(desc, mask, bt, cst, bounds, q, lse,
                                                             flag, rows, D, K, p.DP, p.KB, p.KQ);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  } else {
    if ((err = cudaFuncSetAttribute(logp_kernel<false>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem1)) !=
        cudaSuccess)
      return err;
    logp_kernel<false><<<grid1, kThreads1, kSmem1, stream>>>(desc, mask, bt, cst, bounds, q, lse,
                                                              flag, rows, D, K, p.DP, p.KB, p.KQ);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    softmax_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(q, mask, lse, flag, rows, K, p.KQ);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const size_t kd = static_cast<size_t>(K) * D;
  float* part = scratch + p.part;
  float* p0 = p.S > 1 ? part : s0;
  float* p1 = p.S > 1 ? part + static_cast<size_t>(B) * p.S * K : s1;
  float* p2 = p.S > 1 ? p1 + static_cast<size_t>(B) * p.S * kd : s2;
  const int smem2 = kStages * kDepth * (kComps2 + p.W) * 4;
  if ((err = cudaFuncSetAttribute(stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem2)) != cudaSuccess)
    return err;
  const dim3 grid2(B * p.S, p.KQ / kComps2, p.T);
  stats_kernel<<<grid2, 16 * p.W / 8, smem2, stream>>>(desc, q, flag, p0, p1, p2, N, p.seg, p.S,
                                                       D, K, p.KQ, p.W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.S > 1) {
    if ((err = launch_reduce_partials(p0, s0, B, p.S, K, stream)) != cudaSuccess) return err;
    if ((err = launch_reduce_partials(p1, s1, B, p.S, kd, stream)) != cudaSuccess) return err;
    if ((err = launch_reduce_partials(p2, s2, B, p.S, kd, stream)) != cudaSuccess) return err;
  }
  if (ll != nullptr) {
    masked_row_sum_kernel<<<B, kReduceThreads, 0, stream>>>(lse, mask, ll, N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
