// Dense Arc* corner mask on the SAE — hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel esvio_tpu/events/corners_pallas.py
// (corner_mask_pallas, body _make_kernel).  For every pixel of both
// polarity planes it reads the 16-point r=3 and the 20-point r=4
// Bresenham circles, grows the newest contiguous arc from the circle's
// first maximum with the reference's greedy two-phase expansion
// (event_detector.cc:337-426) and accepts when
//   size <= max  or  n - max <= size <= n - min,
// (min, max) = (4, 6) on the small circle and (5, 8) on the large one.
// A pixel is a corner when both circles accept.
//
// Border semantics: the plain version (the XLA formulation, jnp.roll) wraps
// around the image, so the halo indices here wrap modulo H and W too; the
// mask then equals the plain version bit for bit everywhere.
//
// What bounds it: it reads 8 B and writes 2 B per pixel, so at the
// pipeline's sizes (<= 640x480) it is bound by latency and launch, not by
// bytes.  The design keeps the 36 shifted planes of the plain version out of
// device memory: one 2-D block (32 x 8 threads, one thread per pixel) loads
// its SAE tile plus a 4-pixel halo into shared memory once and every circle
// tap is a shared-memory read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BW = 32;            // block width  (pixels)
constexpr int BH = 8;             // block height (pixels)
constexpr int PAD = 4;            // halo = largest circle radius
constexpr int TW = BW + 2 * PAD;  // tile width in shared memory
constexpr int TH = BH + 2 * PAD;

// circle offsets (dx, dy), esvio_tpu/events/corners.py SMALL/LARGE_CIRCLE
__constant__ int c_small_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_small_dy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
__constant__ int c_large_dx[20] = {0, 1, 2, 3, 4, 4, 4, 3, 2, 1, 0, -1, -2, -3, -4, -4, -4, -3, -2, -1};
__constant__ int c_large_dy[20] = {4, 4, 3, 2, 1, 0, -1, -2, -3, -4, -4, -4, -3, -2, -1, 0, 1, 2, 3, 4};

// Newest-arc size on one circle: same comparisons as corners._newest_segment_size
// (strict '>' so the first maximum wins, '>=' for growth).
template <int N, int MIN_T, int MAX_T>
__device__ __forceinline__ bool circle_ok(const float* tile, int cy, int cx,
                                          const int* dxs, const int* dys) {
  auto val = [&](int k) { return tile[(cy + dys[k]) * TW + cx + dxs[k]]; };

  float seg_min = val(0);
  int start = 0;
  for (int k = 1; k < N; ++k) {
    const float v = val(k);
    if (v > seg_min) { seg_min = v; start = k; }
  }
  int right = (start + 1) % N;
  int left = (start - 1 + N) % N;
  float right_val = val(right), left_val = val(left);
  float right_min = right_val, left_min = left_val;

  auto extend = [&](bool go_right) {
    if (go_right) {
      right = (right + 1) % N;
      right_val = val(right);
      right_min = fminf(right_min, right_val);
    } else {
      left = (left - 1 + N) % N;
      left_val = val(left);
      left_min = fminf(left_min, left_val);
    }
  };

  for (int i = 1; i < MIN_T; ++i) {
    const bool go_right = right_val > left_val;
    seg_min = go_right ? fminf(seg_min, right_min) : fminf(seg_min, left_min);
    extend(go_right);
  }
  int seg_size = MIN_T;
  for (int i = MIN_T; i < N; ++i) {
    const bool go_right = right_val > left_val;
    const float ext_val = go_right ? right_val : left_val;
    const float ext_min = go_right ? right_min : left_min;
    if (ext_val >= seg_min) {
      seg_size = i + 1;
      seg_min = fminf(seg_min, ext_min);
    }
    extend(go_right);
  }
  return (seg_size <= MAX_T) || (seg_size >= N - MAX_T && seg_size <= N - MIN_T);
}

__global__ void corner_mask_kernel(const float* __restrict__ sae,
                                   uint8_t* __restrict__ out, int H, int W) {
  __shared__ float tile[TH * TW];
  const int plane = blockIdx.z;
  const float* src = sae + static_cast<size_t>(plane) * H * W;
  const int x0 = blockIdx.x * BW - PAD;
  const int y0 = blockIdx.y * BH - PAD;
  const int tid = threadIdx.y * BW + threadIdx.x;

  for (int i = tid; i < TH * TW; i += BW * BH) {
    int gy = (y0 + i / TW) % H;
    int gx = (x0 + i % TW) % W;
    if (gy < 0) gy += H;
    if (gx < 0) gx += W;
    tile[i] = src[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  const int x = blockIdx.x * BW + threadIdx.x;
  const int y = blockIdx.y * BH + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + PAD;
  const int cx = threadIdx.x + PAD;
  const bool ok = circle_ok<16, 4, 6>(tile, cy, cx, c_small_dx, c_small_dy) &&
                  circle_ok<20, 5, 8>(tile, cy, cx, c_large_dx, c_large_dy);
  out[static_cast<size_t>(plane) * H * W + static_cast<size_t>(y) * W + x] = ok ? 1 : 0;
}

}  // namespace

// sae: (planes, H, W) float32 contiguous; out: (planes, H, W) uint8.
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int esv_corner_mask(const float* sae, uint8_t* out, int planes,
                               int H, int W, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(BW, BH, 1);
  const dim3 grid((W + BW - 1) / BW, (H + BH - 1) / BH, planes);
  corner_mask_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(sae, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
