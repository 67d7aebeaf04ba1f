// SIFT's image ingest for Hopper (sm_90a): raw uint8 images, gray or
// colour, turned gray and letterboxed into the (B, size, size) uint8 base
// tensor that the SIFT core takes, in one pass and one launch per chunk.
//
// It replaces no TPU kernel: the JAX package turns images gray and
// letterboxes them on the host (pyvisim_tpu/features/_features.py:
// _to_gray_u8, pyvisim_tpu/ops/sift.py:_letterbox), and so did this port
// until host numpy held the SIFT encode back. Its plain PyTorch version is
// ops/cuda/ingest.py:gray_letterbox_reference; both repeat the host numpy
// route (ops/sift.py:_to_gray_u8, _letterbox) bit for bit:
//   gray:   numpy's float64 (R * 0.299 + G * 0.587) + B * 0.114, each
//           operation rounded as numpy rounds it (the file is compiled
//           with --fmad=false, and the operations are spelled as _rn
//           intrinsics, which are never fused), then round half to even;
//   resize: OpenCV's fixed-point INTER_LINEAR as _resize_linear computes
//           it, 11-bit weights, int32 horizontal sums and the vertical
//           blend ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16),
//           (+ 2) >> 2, clipped to 0..255; pixels past nh x nw are zero.
// The tap tables (source columns and rows, weights) come from the host,
// where _edge_taps and _linear_taps define them.
//
// Bound. Each output pixel reads four source pixels of 1 or 3+ bytes and
// does a few tens of integer and float64 operations: far below the card's
// operations per byte, so the bytes bound it (the raw chunk read once and
// the base written once: 16 MB and 4 MB for 16 images of 500 x 667 x 3 at
// 512, about 6 us at 3.35 TB/s). One thread per output pixel, neighbouring
// threads on neighbouring output bytes; a pixel's source reads overlap its
// neighbours' and L1 serves them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Columns of one image's row in the table (int64); column 1, the height,
// is read by the wrapper's checks alone.
constexpr int kOffset = 0;    // first byte of the image in the raw buffer
constexpr int kWidth = 2;
constexpr int kChannels = 3;  // 1 (gray) or >= 3 (the first three are R, G, B)
constexpr int kOutH = 4;      // nh, the letterboxed height
constexpr int kOutW = 5;      // nw
constexpr int kTapX = 6;      // sx, sx1, ax0, ax1 (nw each) at taps[kTapX]
constexpr int kTapY = 7;      // sy0, sy1, by0, by1 (nh each) at taps[kTapY]
constexpr int kColumns = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ int gray_at(const unsigned char* img, int w, int c, int r, int x) {
  const unsigned char* p = img + (static_cast<long long>(r) * w + x) * c;
  if (c == 1) return p[0];
  const double g = __dadd_rn(__dadd_rn(__dmul_rn(static_cast<double>(p[0]), 0.299),
                                       __dmul_rn(static_cast<double>(p[1]), 0.587)),
                             __dmul_rn(static_cast<double>(p[2]), 0.114));
  return __double2int_rn(g);  // round half to even, as numpy's round
}

// Grid: x covers the size * size output pixels of one image, y the images.
__global__ void __launch_bounds__(kThreads)
    gray_letterbox_kernel(const unsigned char* __restrict__ raw,
                          const long long* __restrict__ table,
                          const long long* __restrict__ taps, unsigned char* __restrict__ out,
                          int size) {
  const int b = blockIdx.y;
  const int pixel = blockIdx.x * kThreads + threadIdx.x;
  if (pixel >= size * size) return;
  const long long* row = table + static_cast<long long>(b) * kColumns;
  const int r = pixel / size, x = pixel - r * size;
  const int nh = static_cast<int>(__ldg(row + kOutH)), nw = static_cast<int>(__ldg(row + kOutW));
  int value = 0;
  if (r < nh && x < nw) {
    const unsigned char* img = raw + __ldg(row + kOffset);
    const int w = static_cast<int>(__ldg(row + kWidth));
    const int c = static_cast<int>(__ldg(row + kChannels));
    const long long* tx = taps + __ldg(row + kTapX);
    const long long* ty = taps + __ldg(row + kTapY);
    const int sx0 = static_cast<int>(__ldg(tx + x)), sx1 = static_cast<int>(__ldg(tx + nw + x));
    const int ax0 = static_cast<int>(__ldg(tx + 2 * nw + x));
    const int ax1 = static_cast<int>(__ldg(tx + 3 * nw + x));
    const int sy0 = static_cast<int>(__ldg(ty + r)), sy1 = static_cast<int>(__ldg(ty + nh + r));
    const int by0 = static_cast<int>(__ldg(ty + 2 * nh + r));
    const int by1 = static_cast<int>(__ldg(ty + 3 * nh + r));
    const int s0 = gray_at(img, w, c, sy0, sx0) * ax0 + gray_at(img, w, c, sy0, sx1) * ax1;
    const int s1 = gray_at(img, w, c, sy1, sx0) * ax0 + gray_at(img, w, c, sy1, sx1) * ax1;
    value = ((((s0 >> 4) * by0) >> 16) + (((s1 >> 4) * by1) >> 16) + 2) >> 2;
    value = min(max(value, 0), 255);
  }
  out[static_cast<long long>(b) * size * size + pixel] = static_cast<unsigned char>(value);
}

}  // namespace

extern "C" {

const char* ingest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// raw: the chunk's images, each C-contiguous at its table offset; meta:
// the (b, 8) int64 table (offset, h, w, channels, nh, nw, tap_x, tap_y)
// followed by the int64 tap tables; out (b, size, size) uint8. The wrapper
// (ops/cuda/ingest.py) has checked every entry. One launch.
int ingest_gray_letterbox(const unsigned char* raw, const long long* meta, int b, int size,
                          unsigned char* out, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b == 0) return cudaSuccess;
  const dim3 grid((size * size + kThreads - 1) / kThreads, b);
  gray_letterbox_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      raw, meta, meta + static_cast<long long>(b) * kColumns, out, size);
  return cudaGetLastError();
}

}  // extern "C"
