// SIFT keypoint kernels for Hopper (sm_90a): subpixel refinement of DoG
// extrema, the dominant gradient orientation, and the 128-D descriptor.
//
// sift_refine_f32 replaces the TPU kernel
// pyvisim_tpu/ops/pallas/sift_window.py:_refine_gather_kernel
// (refine_gather_pass) together with the math of
// pyvisim_tpu/ops/sift.py:_refine_candidates that consumes its windows.
// sift_orientation replaces _ori_kernel (orientation_window_pass) and
// sift_descriptor replaces _desc_kernel_gang / _desc_kernel
// (descriptor_window_pass). Their plain PyTorch versions, which repeat the
// arithmetic operation for operation, are in ops/cuda/sift_window.py.
//
// The file is compiled with --fmad=false (ops/cuda/_build.py): no multiply
// and add is fused, so every float operation rounds where the plain
// version's does. Results repeat bit for bit: no atomics, every sum is
// taken in a fixed order.
//
// Bound. All three are gathers: a candidate or keypoint reads a small
// window of a large tensor (the f32 DoG of an octave, or the bf16
// magnitude/angle atlas) and does a few tens of operations per value
// read, below the card's ~20 f32 operations per byte of bandwidth. So the
// bytes bound them: 27 f32 per candidate and iteration for the refinement,
// 4 bytes per window pixel for orientation and descriptor. The design
// keeps each window's reads in one block (L1 serves the reuse) and
// stages per-pixel terms in shared memory; nothing between the stages
// reaches device memory.
//
// The refinement's bound is microseconds per SIFT call, far below what the
// host takes to issue a launch, so it refines the candidates of every
// octave in one launch: the octaves' DoG tensors come as a table in the
// kernel's parameters (pointer, size and first candidate of each), not
// concatenated (octave 0 alone is 16 x 5 x 1024^2 f32 = 336 MB per call).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Kernel A: refinement (OpenCV adjustLocalExtrema).
// ---------------------------------------------------------------------------
constexpr int kMaxOctaves = 16;

// The candidates of octave o are start[o]..start[o + 1] - 1, and its DoG
// (b, n_layers + 2, h[o], w[o]) f32 is at dog[o].
struct RefineOctaves {
  const float* dog[kMaxOctaves];
  int h[kMaxOctaves], w[kMaxOctaves];
  int start[kMaxOctaves + 1];
  int n_octaves;
};

struct RefineParams {
  int n;          // candidates
  int b;          // images in the DoG batch
  int n_total;    // DoG layers per image (n_layers + 2)
  int h, w;       // the candidate's octave size
  int n_layers;   // candidates live on layers 1..n_layers
  int steps;      // refinement iterations
  int reach;      // largest move from the start, in pixels
  float contrast_threshold;
  float edge_threshold;
};

constexpr float kImgScale = 1.0f / 255.0f;
constexpr float kDerivScale = kImgScale * 0.5f;
constexpr float kSecondScale = kImgScale;
constexpr float kCrossScale = kImgScale * 0.25f;

__device__ __forceinline__ float dog_at(const float* img_dog, const RefineParams& p, int l,
                                        int r, int c) {
  // Clamped, so a rejected candidate's last step never reads out of
  // bounds; a kept one only ever reads inside the image.
  l = min(max(l, 0), p.n_total - 1);
  r = min(max(r, 0), p.h - 1);
  c = min(max(c, 0), p.w - 1);
  return img_dog[(static_cast<long long>(l) * p.h + r) * p.w + c];
}

// The value and the 9 derivatives of the 3x3x3 cube at (l, r, c), image
// scales folded in: s = (val, dDx, dDy, dDs, dxx, dyy, dss, dxy, dxs, dys).
__device__ void stencils(const float* d, const RefineParams& p, int l, int r, int c,
                         float* s) {
  const float v = dog_at(d, p, l, r, c);
  const float c_p = dog_at(d, p, l, r, c + 1), c_m = dog_at(d, p, l, r, c - 1);
  const float r_p = dog_at(d, p, l, r + 1, c), r_m = dog_at(d, p, l, r - 1, c);
  const float l_p = dog_at(d, p, l + 1, r, c), l_m = dog_at(d, p, l - 1, r, c);
  const float v2 = v * 2.0f;
  s[0] = v * kImgScale;
  s[1] = (c_p - c_m) * kDerivScale;
  s[2] = (r_p - r_m) * kDerivScale;
  s[3] = (l_p - l_m) * kDerivScale;
  s[4] = (c_p + c_m - v2) * kSecondScale;
  s[5] = (r_p + r_m - v2) * kSecondScale;
  s[6] = (l_p + l_m - v2) * kSecondScale;
  s[7] = (dog_at(d, p, l, r + 1, c + 1) - dog_at(d, p, l, r + 1, c - 1) -
          dog_at(d, p, l, r - 1, c + 1) + dog_at(d, p, l, r - 1, c - 1)) *
         kCrossScale;
  s[8] = (dog_at(d, p, l + 1, r, c + 1) - dog_at(d, p, l + 1, r, c - 1) -
          dog_at(d, p, l - 1, r, c + 1) + dog_at(d, p, l - 1, r, c - 1)) *
         kCrossScale;
  s[9] = (dog_at(d, p, l + 1, r + 1, c) - dog_at(d, p, l + 1, r - 1, c) -
          dog_at(d, p, l - 1, r + 1, c) + dog_at(d, p, l - 1, r - 1, c)) *
         kCrossScale;
}

// Closed-form solve of the symmetric 3x3 system H x = (dDx, dDy, dDs) by
// its adjugate; returns the offsets -x as (xc, xr, xi).
__device__ void solve3(const float* s, float& xc, float& xr, float& xi) {
  const float dDx = s[1], dDy = s[2], dDs = s[3];
  const float a = s[4], d = s[5], f = s[6], b = s[7], c = s[8], e = s[9];
  const float co00 = d * f - e * e;
  const float co01 = c * e - b * f;
  const float co02 = b * e - c * d;
  const float co11 = a * f - c * c;
  const float co12 = b * c - a * e;
  const float co22 = a * d - b * b;
  const float det = a * co00 + b * co01 + c * co02;
  const float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  xc = -((co00 * dDx + co01 * dDy + co02 * dDs) * inv_det);
  xr = -((co01 * dDx + co11 * dDy + co12 * dDs) * inv_det);
  xi = -((co02 * dDx + co12 * dDy + co22 * dDs) * inv_det);
}

// One thread per candidate: up to `steps` quadratic fits, each a step to
// the rounded offset, until all three offsets are below 0.5. A candidate
// is rejected when an offset is not finite or above 1e6, when a step
// leaves layers 1..n_layers, the 5-px border or the +-reach window around
// its start, when it has not converged, or on the contrast and edge tests.
// Rejected candidates keep their start and zero offsets. Candidates lie
// octave by octave, so a warp reads one octave's DoG (but where an
// octave's first candidate falls inside a warp).
__global__ void refine_kernel(const __grid_constant__ RefineOctaves octaves,
                              const int* __restrict__ img, const int* __restrict__ layer,
                              const int* __restrict__ row, const int* __restrict__ col,
                              const unsigned char* __restrict__ valid,
                              int* __restrict__ out_i, float* __restrict__ out_f,
                              unsigned char* __restrict__ ok_out, RefineParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  int o = 0;
  while (o + 1 < octaves.n_octaves && i >= octaves.start[o + 1]) ++o;
  p.h = octaves.h[o];
  p.w = octaves.w[o];
  const int l0 = layer[i], r0 = row[i], c0 = col[i];
  const int im = min(max(img[i], 0), p.b - 1);
  const float* d = octaves.dog[o] + static_cast<long long>(im) * p.n_total * p.h * p.w;
  bool ok = valid[i] != 0;
  bool converged = false;
  int l = l0, dr = 0, dc = 0;
  float xr = 0.0f, xc = 0.0f, xi = 0.0f, contr = 0.0f;
  float s[10];
  if (ok) {
    for (int it = 0; it < p.steps; ++it) {
      stencils(d, p, l, r0 + dr, c0 + dc, s);
      float xc_n, xr_n, xi_n;
      solve3(s, xc_n, xr_n, xi_n);
      xr = xr_n;
      xc = xc_n;
      xi = xi_n;
      if (fabsf(xc_n) < 0.5f && fabsf(xr_n) < 0.5f && fabsf(xi_n) < 0.5f) {
        converged = true;
        break;
      }
      if (!(fabsf(xc_n) <= 1e6f && fabsf(xr_n) <= 1e6f && fabsf(xi_n) <= 1e6f)) {
        ok = false;
        break;
      }
      const int nl = l + static_cast<int>(rintf(xi_n));
      const int ndr = dr + static_cast<int>(rintf(xr_n));
      const int ndc = dc + static_cast<int>(rintf(xc_n));
      const int gr = r0 + ndr, gc = c0 + ndc;
      const bool inside = nl >= 1 && nl <= p.n_layers && gr >= 5 && gr < p.h - 5 && gc >= 5 &&
                          gc < p.w - 5;
      const bool in_window = ndr >= -p.reach && ndr <= p.reach && ndc >= -p.reach &&
                             ndc <= p.reach;
      if (!(inside && in_window)) {
        ok = false;
        break;
      }
      l = nl;
      dr = ndr;
      dc = ndc;
    }
    ok = ok && converged;
    if (ok) {
      // s holds the stencils at the converged position.
      contr = s[0] + 0.5f * (s[1] * xc + s[2] * xr + s[3] * xi);
      const float e = p.edge_threshold;
      const float tr = s[4] + s[5];
      const float det = s[4] * s[5] - s[7] * s[7];
      ok = fabsf(contr) * static_cast<float>(p.n_layers) >= p.contrast_threshold && det > 0.0f &&
           tr * tr * e < (e + 1.0f) * (e + 1.0f) * det;
    }
  }
  if (!ok) {
    l = l0;
    dr = dc = 0;
    xr = xc = xi = contr = 0.0f;
  }
  out_i[i] = l;
  out_i[p.n + i] = r0 + dr;
  out_i[2 * p.n + i] = c0 + dc;
  out_f[i] = xr;
  out_f[p.n + i] = xc;
  out_f[2 * p.n + i] = xi;
  out_f[3 * p.n + i] = contr;
  ok_out[i] = ok ? 1 : 0;
}

// ---------------------------------------------------------------------------
// The gradient atlas shared by kernels B and C: per octave o a region of
// the flat atlas at octaves[3*o] (elements), laid out (B, L, H, W, 2) with
// H = octaves[3*o+1], W = octaves[3*o+2]; channel 0 is the magnitude
// (zero on the one-pixel border ring), channel 1 the angle atan2(dy, dx).
// ---------------------------------------------------------------------------
template <typename T>
struct AtlasType;

template <>
struct AtlasType<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // A pixel's (magnitude, angle), in one 4-byte read.
  static __device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  // The reference contracts its histogram weights in the atlas' type.
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct AtlasType<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float2 load_pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

struct Keypoint {
  long long plane;  // element offset of the keypoint's (image, layer) plane
  int h, w, r, c;
};

__device__ __forceinline__ Keypoint locate(const long long* octaves, int n_octaves,
                                           long long atlas_numel, int n_layers, int img,
                                           int octave, int layer, int r, int c) {
  Keypoint k;
  const int o = min(max(octave, 0), n_octaves - 1);
  k.h = static_cast<int>(octaves[3 * o + 1]);
  k.w = static_cast<int>(octaves[3 * o + 2]);
  const int l = min(max(layer, 1), n_layers) - 1;
  const long long plane_size = 2LL * k.h * k.w;
  const long long plane =
      octaves[3 * o] + (static_cast<long long>(max(img, 0)) * n_layers + l) * plane_size;
  // Clamped into the atlas, so a window never reads outside it.
  k.plane = max(0LL, min(plane, atlas_numel - plane_size));
  k.r = r;
  k.c = c;
  return k;
}

constexpr int kOriBins = 36;
constexpr int kOriWarps = 4;      // keypoints (warps) per block
constexpr int kOriChunks = 8;     // 32-pixel chunks of a warp's tile of the window
constexpr int kOriWarpWords = kOriChunks * 32 + kOriChunks * kOriBins + kOriBins;

struct WindowParams {
  int n;                  // keypoints
  int n_octaves;
  int n_layers;
  long long atlas_numel;  // elements of the flat atlas
};

// ---------------------------------------------------------------------------
// Kernel B: orientation. One warp per keypoint slot, kOriWarps slots per
// block: an invalid slot costs one flag read and three stores. Window
// |ii|, |jj| <= min(class radius, round(4.5 scl)); each in-image pixel adds
// exp(-(ii^2+jj^2) / (2 (1.5 scl)^2)) * mag to bin round(ang * 36/2pi)
// mod 36, and each bin's sum runs over its pixels in row-major window
// order, as the plain version's does.
//
// The warp takes the window 256 pixels at a time, 8 a lane. Each lane
// computes its pixels' terms and sets its lane bit in a shared word per
// (32-pixel chunk, bin); then the lane that owns a bin (lane l owns bins l
// and l + 32) walks the set bits of its bin's words, chunk by chunk and
// lane by lane, which is window order, and adds those terms onto its
// running sum. So a bin's work is its own pixel count, not the window's
// size, only the owners' adds run in series, and the sums are the plain
// version's, bit for bit. Then each lane smooths its bins
// with [1,4,6,4,1]/16, and two warp reductions find the first maximum (the
// lowest bin on ties) and the strongest other local peak >= 0.8 max (again
// the lowest bin on ties); lane 0 interpolates both angles.
// ---------------------------------------------------------------------------
struct Peak {
  float v;
  int bin;  // -1: no candidate
};

// The better of two candidates: a present one, the larger value, the lower
// bin on ties; as the first-maximum loops over bins 0..35 choose.
__device__ __forceinline__ Peak better(Peak a, Peak b) {
  if (b.bin < 0) return a;
  if (a.bin < 0) return b;
  if (b.v > a.v || (b.v == a.v && b.bin < a.bin)) return b;
  return a;
}

__device__ __forceinline__ Peak warp_best(Peak x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Peak o;
    o.v = __shfl_xor_sync(0xffffffffu, x.v, off);
    o.bin = __shfl_xor_sync(0xffffffffu, x.bin, off);
    x = better(x, o);
  }
  return x;
}

__device__ __forceinline__ float smooth_bin(const float* h, int b) {
  const float far = h[(b + kOriBins - 2) % kOriBins] + h[(b + 2) % kOriBins];
  const float near = h[(b + kOriBins - 1) % kOriBins] + h[(b + 1) % kOriBins];
  return far * 0.0625f + near * 0.25f + h[b] * 0.375f;
}

__device__ __forceinline__ float peak_angle(const float* hs, int pk) {
  const float l_ = hs[(pk + kOriBins - 1) % kOriBins], c_ = hs[pk],
              r_ = hs[(pk + 1) % kOriBins];
  const float denom = l_ - 2.0f * c_ + r_;
  const float interp = fabsf(denom) > 1e-12f ? 0.5f * (l_ - r_) / denom : 0.0f;
  return (static_cast<float>(pk) + interp) * 0.17453292519943295f;
}

template <typename T>
__global__ void __launch_bounds__(kOriWarps * 32)
    orientation_kernel(const T* __restrict__ atlas, const long long* __restrict__ octaves,
                       const int* __restrict__ img, const int* __restrict__ octave,
                       const int* __restrict__ layer, const int* __restrict__ row,
                       const int* __restrict__ col, const float* __restrict__ scl,
                       const int* __restrict__ radius, const unsigned char* __restrict__ valid,
                       float* __restrict__ theta, float* __restrict__ theta2,
                       unsigned char* __restrict__ has_second, WindowParams p) {
  // Per warp: the tile's terms, per chunk and bin the lanes whose pixel
  // falls into the bin, and the histogram.
  __shared__ unsigned ori_smem[kOriWarps * kOriWarpWords];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int k = blockIdx.x * kOriWarps + wid;
  if (k >= p.n) return;
  unsigned* own = ori_smem + wid * kOriWarpWords;
  float* wm_of = reinterpret_cast<float*>(own);
  unsigned (*lanes_of)[kOriBins] = reinterpret_cast<unsigned (*)[kOriBins]>(own + kOriChunks * 32);
  float* hist = reinterpret_cast<float*>(own + kOriChunks * 32 + kOriChunks * kOriBins);
  if (!valid[k]) {
    if (lane == 0) {
      theta[k] = 0.0f;
      theta2[k] = 0.0f;
      has_second[k] = 0;
    }
    return;
  }
  const Keypoint kp = locate(octaves, p.n_octaves, p.atlas_numel, p.n_layers, img[k],
                             octave[k], layer[k], row[k], col[k]);
  const float sc = scl[k];
  const int rad = min(radius[k], static_cast<int>(rintf(4.5f * sc)));
  const float sigma_w = 1.5f * sc;
  const float exp_scale = -1.0f / (2.0f * sigma_w * sigma_w);
  const int side = 2 * rad + 1;
  const int n_pix = side * side;
  const float inv_side = 1.0f / static_cast<float>(side);
  const T* plane = atlas + kp.plane;
  // A pixel's pair is one aligned read unless the plane starts at an odd
  // element (an atlas laid out by another caller).
  const bool paired = (reinterpret_cast<uintptr_t>(plane) & (2 * sizeof(T) - 1)) == 0;
  float acc_lo = 0.0f, acc_hi = 0.0f;  // bins lane and lane + 32
  for (int base = 0; base < n_pix; base += 32 * kOriChunks) {
    const int n_chunks = min(kOriChunks, (n_pix - base + 31) / 32);
    for (int i = lane; i < n_chunks * kOriBins; i += 32) (&lanes_of[0][0])[i] = 0u;
    __syncwarp();
    // Every pixel of the tile: its term, and its lane bit under its bin.
    for (int u = 0; u < n_chunks; ++u) {
      const int pix = base + u * 32 + lane;
      // pix / side, exact: (pix + 0.5) / side lies >= 0.5 / side from an
      // integer, far beyond the product's rounding error.
      const int row_in = __float2int_rz((static_cast<float>(pix) + 0.5f) * inv_side);
      const int ii = row_in - rad, jj = pix - row_in * side - rad;
      const int rr = kp.r + ii, cc = kp.c + jj;
      float wm = 0.0f;
      if (pix < n_pix && rr >= 1 && rr < kp.h - 1 && cc >= 1 && cc < kp.w - 1) {
        const long long at = (static_cast<long long>(rr) * kp.w + cc) * 2;
        float mag, ang;
        if (paired) {
          const float2 ma = AtlasType<T>::load_pair(plane + at);
          mag = ma.x;
          ang = ma.y;
        } else {
          mag = AtlasType<T>::load(plane + at);
          ang = AtlasType<T>::load(plane + at + 1);
        }
        const float fi = static_cast<float>(ii), fj = static_cast<float>(jj);
        wm = expf((fi * fi + fj * fj) * exp_scale) * mag;
        int bin = static_cast<int>(rintf(ang * 5.729577951308232f)) % kOriBins;
        if (bin < 0) bin += kOriBins;  // floor-mod, as the reference's % is
        atomicOr(&lanes_of[u][bin], 1u << lane);
      }
      wm_of[u * 32 + lane] = wm;
    }
    __syncwarp();
    // Each owner adds its bin's terms in window order: chunk by chunk,
    // lane by lane.
    for (int u = 0; u < n_chunks; ++u)
      for (unsigned m = lanes_of[u][lane]; m; m &= m - 1)
        acc_lo += wm_of[u * 32 + __ffs(m) - 1];
    if (lane < kOriBins - 32)
      for (int u = 0; u < n_chunks; ++u)
        for (unsigned m = lanes_of[u][lane + 32]; m; m &= m - 1)
          acc_hi += wm_of[u * 32 + __ffs(m) - 1];
    __syncwarp();
  }
  hist[lane] = acc_lo;
  if (lane < kOriBins - 32) hist[lane + 32] = acc_hi;
  __syncwarp();
  const float hs_lo = smooth_bin(hist, lane);
  const float hs_hi = lane < kOriBins - 32 ? smooth_bin(hist, lane + 32) : 0.0f;
  __syncwarp();
  hist[lane] = hs_lo;  // from here on, the smoothed histogram
  if (lane < kOriBins - 32) hist[lane + 32] = hs_hi;
  __syncwarp();

  Peak top{hs_lo, lane};
  if (lane < kOriBins - 32) top = better(top, Peak{hs_hi, lane + 32});
  top = warp_best(top);
  const float min_second = 0.8f * top.v;
  Peak second{0.0f, -1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int b = lane + 32 * j;
    if (b >= kOriBins) continue;
    const float v = hist[b];
    const float left = hist[(b + kOriBins - 1) % kOriBins], right = hist[(b + 1) % kOriBins];
    if (v > left && v >= right && v >= min_second && b != top.bin)
      second = better(second, Peak{v, b});
  }
  second = warp_best(second);
  if (lane == 0) {
    theta[k] = peak_angle(hist, top.bin);
    theta2[k] = second.bin >= 0 ? peak_angle(hist, second.bin) : 0.0f;
    has_second[k] = second.bin >= 0 ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// Kernel C: descriptor (OpenCV calcSIFTDescriptor). One block of 128
// threads per keypoint, pixel-parallel. Window pixels (|ii|, |jj| <=
// min(class radius, round(3 scl sqrt2 5/2))) are dealt to the threads
// round-robin in row-major order. A thread computes its pixel's rotated
// bin coordinates; a pixel in the image and inside the rotated 4x4 region
// reads its magnitude and angle and adds its <= 8 trilinear terms
// round(hat_r hat_c mag) * round(hat_o) into the thread's own 4x4x8
// histogram in shared memory (orientation bin 8 folds onto 0; bin 9 is
// always empty). Both factors are rounded to the atlas' type as the
// reference's contraction does, so every product is exact and only the
// order of the f32 sums differs from it. Other pixels cost no histogram
// work: the work grows with the terms that exist, not with 128 bins per
// window pixel.
// Thread t then sums bin t over the 128 private histograms in a fixed
// order, so the result repeats bit for bit; the histograms are stored
// bin-major, hist[bin][thread], so that the adds and the sums meet no
// bank conflicts. Then the 0.2 clip, the rescale to 512, the cap at 255
// and round-half-even; invalid keypoints get zeros.
// ---------------------------------------------------------------------------
constexpr int kDescThreads = 128;
constexpr int kDescBins = 128;
constexpr int kDescSmemBytes = kDescBins * kDescThreads * 4;  // 65,536

__device__ __forceinline__ float hat(float x) { return fmaxf(0.0f, 1.0f - fabsf(x)); }

// Sum of v over the block's 128 threads, in a fixed order.
__device__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  const float total = ((scratch[0] + scratch[1]) + scratch[2]) + scratch[3];
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kDescThreads)
    descriptor_kernel(const T* __restrict__ atlas, const long long* __restrict__ octaves,
                      const int* __restrict__ img, const int* __restrict__ octave,
                      const int* __restrict__ layer, const int* __restrict__ row,
                      const int* __restrict__ col, const float* __restrict__ scl,
                      const float* __restrict__ theta, const int* __restrict__ radius,
                      const unsigned char* __restrict__ valid, float* __restrict__ desc,
                      WindowParams p) {
  extern __shared__ float s_hist[];  // [kDescBins][kDescThreads]: one histogram a thread
  __shared__ float s_red[kDescThreads / 32];
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  float* out = desc + static_cast<long long>(k) * 128;
  if (!valid[k]) {
    out[t] = 0.0f;
    return;
  }
  const Keypoint kp = locate(octaves, p.n_octaves, p.atlas_numel, p.n_layers, img[k], octave[k],
                                layer[k], row[k], col[k]);
  const float th = theta[k];
  const float hist_width = 3.0f * scl[k];
  const float cos_t = cosf(th) / hist_width;
  const float sin_t = sinf(th) / hist_width;
  const int rad = min(radius[k],
                      static_cast<int>(rintf(hist_width * 1.4142135623730951f * 5.0f * 0.5f)));
  const int side = 2 * rad + 1;
  const int n_pix = side * side;
  const T* plane = atlas + kp.plane;
  float* hist = s_hist + t;  // bin b of this thread's histogram at hist[b * kDescThreads]
  for (int b = 0; b < kDescBins; ++b) hist[b * kDescThreads] = 0.0f;
  for (int q = t; q < n_pix; q += kDescThreads) {
    const int ii = q / side - rad, jj = q % side - rad;
    const int rr = kp.r + ii, cc = kp.c + jj;
    if (rr < 1 || rr >= kp.h - 1 || cc < 1 || cc >= kp.w - 1) continue;
    const float fi = static_cast<float>(ii), fj = static_cast<float>(jj);
    const float c_rot = fj * cos_t - fi * sin_t;
    const float r_rot = fj * sin_t + fi * cos_t;
    const float rbin = r_rot + 2.0f - 0.5f;
    const float cbin = c_rot + 2.0f - 0.5f;
    if (!(rbin > -1.0f && rbin < 4.0f && cbin > -1.0f && cbin < 4.0f)) continue;
    const long long at = (static_cast<long long>(rr) * kp.w + cc) * 2;
    const float mag = AtlasType<T>::load(plane + at);
    const float ang = AtlasType<T>::load(plane + at + 1);
    const float obin = (ang - th) * 1.2732395447351628f;
    const float wgt = expf((c_rot * c_rot + r_rot * r_rot) * -0.125f);
    const float m = mag * wgt;
    const float pos_o = obin - 8.0f * floorf(obin * 0.125f);  // in [0, 8]
    const float rb1 = rbin + 1.0f, cb1 = cbin + 1.0f;         // in (0, 5)
    const int r0 = static_cast<int>(floorf(rb1)), c0 = static_cast<int>(floorf(cb1));
    const int o0 = static_cast<int>(floorf(pos_o));
    // The two orientation bins the pixel reaches, 8 folded onto 0; a bin
    // past 8 gets no term (its hat is 0).
    float ho[2];
    int ob[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ko = o0 + e;
      ho[e] = ko >= 0 && ko <= 8 ? AtlasType<T>::round(hat(pos_o - static_cast<float>(ko))) : 0.0f;
      ob[e] = ko == 8 ? 0 : max(ko, 0);
    }
#pragma unroll
    for (int er = 0; er < 2; ++er) {
      const int kr = r0 + er;  // extended spatial bins 1..4
      if (kr < 1 || kr > 4) continue;
      const float hr = hat(rb1 - static_cast<float>(kr));
      if (hr == 0.0f) continue;
#pragma unroll
      for (int ec = 0; ec < 2; ++ec) {
        const int kc = c0 + ec;
        if (kc < 1 || kc > 4) continue;
        const float hc = hat(cb1 - static_cast<float>(kc));
        if (hc == 0.0f) continue;
        const float a = AtlasType<T>::round(hr * hc * m);
        float* cell = hist + ((kr - 1) * 4 + (kc - 1)) * 8 * kDescThreads;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ho[e] != 0.0f) cell[ob[e] * kDescThreads] += a * ho[e];
      }
    }
  }
  __syncthreads();
  // Thread t sums bin t over the 128 histograms, each lane starting at its
  // own offset (no bank conflicts); the order is fixed, so the sum repeats.
  const float* bin = s_hist + t * kDescThreads;
  const int lane = t & 31;
  float v = 0.0f;
  for (int j = 0; j < kDescThreads; ++j) v += bin[(j + lane) & (kDescThreads - 1)];
  const float thr = sqrtf(block_sum(v * v, s_red)) * 0.2f;
  v = fminf(v, thr);
  const float scale = 512.0f / fmaxf(sqrtf(block_sum(v * v, s_red)), 1e-12f);
  out[t] = rintf(fminf(v * scale, 255.0f));
}

template <typename T>
cudaError_t launch_orientation(const void* atlas, const long long* octaves, const int* img,
                               const int* octave, const int* layer, const int* row,
                               const int* col, const float* scl, const int* radius,
                               const unsigned char* valid, float* theta, float* theta2,
                               unsigned char* has_second, WindowParams p,
                               cudaStream_t stream) {
  orientation_kernel<T><<<(p.n + kOriWarps - 1) / kOriWarps, kOriWarps * 32, 0, stream>>>(
      static_cast<const T*>(atlas), octaves, img, octave, layer, row, col, scl, radius, valid,
      theta, theta2, has_second, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_descriptor(const void* atlas, const long long* octaves, const int* img,
                              const int* octave, const int* layer, const int* row,
                              const int* col, const float* scl, const float* theta,
                              const int* radius, const unsigned char* valid, float* desc,
                              WindowParams p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      descriptor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDescSmemBytes);
  if (err != cudaSuccess) return err;
  descriptor_kernel<T><<<p.n, kDescThreads, kDescSmemBytes, stream>>>(
      static_cast<const T*>(atlas), octaves, img, octave, layer, row, col, scl, theta, radius,
      valid, desc, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// table (4, n_octaves) int64 (host memory): per octave o the address of
// its DoG (B, n_layers + 2, H, W) f32, H, W and the number of its
// candidates, which lie octave after octave; per candidate img, layer,
// row, col (int32) and valid (uint8). Writes out_i (3, n) int32 = (layer,
// row, col), out_f (4, n) f32 = (xr, xc, xi, contrast) and ok (n) uint8,
// n the sum of the counts. One launch.
int sift_refine_f32(const long long* table, int n_octaves, const int* img, const int* layer,
                    const int* row, const int* col, const unsigned char* valid, int* out_i,
                    float* out_f, unsigned char* ok, int b, int n_layers, int steps, int reach,
                    float contrast_threshold, float edge_threshold, int device,
                    void* stream_ptr) {
  if (n_octaves < 1 || n_octaves > kMaxOctaves) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  RefineOctaves octaves{};
  octaves.n_octaves = n_octaves;
  for (int o = 0; o < n_octaves; ++o) {
    octaves.dog[o] = reinterpret_cast<const float*>(table[o]);
    octaves.h[o] = static_cast<int>(table[n_octaves + o]);
    octaves.w[o] = static_cast<int>(table[2 * n_octaves + o]);
    octaves.start[o + 1] = octaves.start[o] + static_cast<int>(table[3 * n_octaves + o]);
  }
  const int n = octaves.start[n_octaves];
  if (n == 0) return cudaSuccess;
  RefineParams p{n, b, n_layers + 2, 0, 0, n_layers, steps, reach, contrast_threshold,
                 edge_threshold};
  const int threads = 128;
  refine_kernel<<<(n + threads - 1) / threads, threads, 0,
                  static_cast<cudaStream_t>(stream_ptr)>>>(octaves, img, layer, row, col, valid,
                                                           out_i, out_f, ok, p);
  return cudaGetLastError();
}

// atlas: flat bf16 (atlas_bf16 = 1) or f32 gradient atlas; octaves
// (n_octaves, 3) int64 = (offset, H, W). Per keypoint img, octave, layer,
// row, col, radius (int32), scl (f32), valid (uint8). Writes theta,
// theta2 (f32) and has_second (uint8).
int sift_orientation(const void* atlas, int atlas_bf16, const long long* octaves, int n_octaves,
                     const int* img, const int* octave, const int* layer, const int* row,
                     const int* col, const float* scl, const int* radius,
                     const unsigned char* valid, float* theta, float* theta2,
                     unsigned char* has_second, int n, int n_layers, long long atlas_numel,
                     int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  WindowParams p{n, n_octaves, n_layers, atlas_numel};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return atlas_bf16 ? launch_orientation<__nv_bfloat16>(atlas, octaves, img, octave, layer, row,
                                                        col, scl, radius, valid, theta, theta2,
                                                        has_second, p, stream)
                    : launch_orientation<float>(atlas, octaves, img, octave, layer, row, col,
                                                scl, radius, valid, theta, theta2, has_second,
                                                p, stream);
}

// As sift_orientation, plus each keypoint's theta; writes desc (n, 128) f32.
int sift_descriptor(const void* atlas, int atlas_bf16, const long long* octaves, int n_octaves,
                    const int* img, const int* octave, const int* layer, const int* row,
                    const int* col, const float* scl, const float* theta, const int* radius,
                    const unsigned char* valid, float* desc, int n, int n_layers,
                    long long atlas_numel, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  WindowParams p{n, n_octaves, n_layers, atlas_numel};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return atlas_bf16 ? launch_descriptor<__nv_bfloat16>(atlas, octaves, img, octave, layer, row,
                                                       col, scl, theta, radius, valid, desc, p,
                                                       stream)
                    : launch_descriptor<float>(atlas, octaves, img, octave, layer, row, col, scl,
                                               theta, radius, valid, desc, p, stream);
}

}  // extern "C"
