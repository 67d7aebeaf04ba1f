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
  // The reference contracts its histogram weights in the atlas' type.
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct AtlasType<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
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

constexpr int kTile = 1024;  // window pixels staged in shared memory at a time
constexpr int kOriBins = 36;
constexpr int kOriThreads = 128;

struct WindowParams {
  int n;                  // keypoints
  int n_octaves;
  int n_layers;
  long long atlas_numel;  // elements of the flat atlas
};

// ---------------------------------------------------------------------------
// Kernel B: orientation. One block per keypoint. Window |ii|, |jj| <=
// min(class radius, round(4.5 scl)); each in-image pixel adds
// exp(-(ii^2+jj^2) / (2 (1.5 scl)^2)) * mag to bin round(ang * 36/2pi) mod 36.
// Thread k < 36 owns bin k and walks the window row by row, so each bin
// is a sum in a fixed order. Then thread 0 smooths with [1,4,6,4,1]/16,
// takes the first maximum, its parabolic angle, and the strongest other
// local peak >= 0.8 max.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kOriThreads)
    orientation_kernel(const T* __restrict__ atlas, const long long* __restrict__ octaves,
                       const int* __restrict__ img, const int* __restrict__ octave,
                       const int* __restrict__ layer, const int* __restrict__ row,
                       const int* __restrict__ col, const float* __restrict__ scl,
                       const int* __restrict__ radius, const unsigned char* __restrict__ valid,
                       float* __restrict__ theta, float* __restrict__ theta2,
                       unsigned char* __restrict__ has_second, WindowParams p) {
  __shared__ float s_wm[kTile];
  __shared__ unsigned char s_bin[kTile];
  __shared__ float s_hist[kOriBins];
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  if (!valid[k]) {
    if (t == 0) {
      theta[k] = 0.0f;
      theta2[k] = 0.0f;
      has_second[k] = 0;
    }
    return;
  }
  const Keypoint kp = locate(octaves, p.n_octaves, p.atlas_numel, p.n_layers, img[k], octave[k],
                                layer[k], row[k], col[k]);
  const float sc = scl[k];
  const int rad = min(radius[k], static_cast<int>(rintf(4.5f * sc)));
  const float sigma_w = 1.5f * sc;
  const float exp_scale = -1.0f / (2.0f * sigma_w * sigma_w);
  const int side = 2 * rad + 1;
  const int n_pix = side * side;
  const T* plane = atlas + kp.plane;
  float acc = 0.0f;
  for (int base = 0; base < n_pix; base += kTile) {
    const int count = min(kTile, n_pix - base);
    for (int q = t; q < count; q += kOriThreads) {
      const int pix = base + q;
      const int ii = pix / side - rad, jj = pix % side - rad;
      const int rr = kp.r + ii, cc = kp.c + jj;
      float wm = 0.0f;
      int bin = 0;
      if (rr >= 1 && rr < kp.h - 1 && cc >= 1 && cc < kp.w - 1) {
        const long long at = (static_cast<long long>(rr) * kp.w + cc) * 2;
        const float mag = AtlasType<T>::load(plane + at);
        const float ang = AtlasType<T>::load(plane + at + 1);
        const float fi = static_cast<float>(ii), fj = static_cast<float>(jj);
        wm = expf((fi * fi + fj * fj) * exp_scale) * mag;
        bin = static_cast<int>(rintf(ang * 5.729577951308232f)) % kOriBins;
        if (bin < 0) bin += kOriBins;  // floor-mod, as the reference's % is
      }
      s_wm[q] = wm;
      s_bin[q] = static_cast<unsigned char>(bin);
    }
    __syncthreads();
    if (t < kOriBins)
      for (int q = 0; q < count; ++q)
        if (s_bin[q] == t) acc += s_wm[q];
    __syncthreads();
  }
  if (t < kOriBins) s_hist[t] = acc;
  __syncthreads();
  if (t != 0) return;

  float hs[kOriBins];
  for (int b = 0; b < kOriBins; ++b) {
    const float far = s_hist[(b + kOriBins - 2) % kOriBins] + s_hist[(b + 2) % kOriBins];
    const float near = s_hist[(b + kOriBins - 1) % kOriBins] + s_hist[(b + 1) % kOriBins];
    hs[b] = far * 0.0625f + near * 0.25f + s_hist[b] * 0.375f;
  }
  int peak = 0;
  for (int b = 1; b < kOriBins; ++b)
    if (hs[b] > hs[peak]) peak = b;
  const float omax = hs[peak];
  int second = -1;
  for (int b = 0; b < kOriBins; ++b) {
    const float left = hs[(b + kOriBins - 1) % kOriBins], right = hs[(b + 1) % kOriBins];
    const bool is_peak = hs[b] > left && hs[b] >= right && hs[b] >= 0.8f * omax && b != peak;
    if (is_peak && (second < 0 || hs[b] > hs[second])) second = b;
  }
  float angles[2] = {0.0f, 0.0f};
  const int peaks[2] = {peak, second};
  for (int j = 0; j < 2; ++j) {
    const int pk = peaks[j];
    if (pk < 0) continue;
    const float l_ = hs[(pk + kOriBins - 1) % kOriBins], c_ = hs[pk],
                r_ = hs[(pk + 1) % kOriBins];
    const float denom = l_ - 2.0f * c_ + r_;
    const float interp = fabsf(denom) > 1e-12f ? 0.5f * (l_ - r_) / denom : 0.0f;
    angles[j] = (static_cast<float>(pk) + interp) * 0.17453292519943295f;
  }
  theta[k] = angles[0];
  theta2[k] = angles[1];
  has_second[k] = second >= 0 ? 1 : 0;
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
                               unsigned char* has_second, WindowParams p, cudaStream_t stream) {
  orientation_kernel<T><<<p.n, kOriThreads, 0, stream>>>(
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
