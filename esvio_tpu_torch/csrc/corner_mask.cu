// Dense Arc* corner mask on the SAE — hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel esvio_tpu/events/corners_pallas.py:139
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
// Bound on an H100 (SXM, 700 W): it reads 4 B and writes 1 B (torch.bool)
// per pixel, 768 KB at (2, 240, 320): 0.23 µs at 3.35 TB/s.  The arc test
// takes 163 float compares and minimums per pixel (both circles), 25 M at
// (2, 240, 320).  Compares and minimums issue at 64 per clock per SM on
// sm_90 (CUDA C++ Programming Guide, arithmetic instruction throughput),
// 16.7 T/s on 132 SMs at 1.98 GHz: 1.5 µs, so operations bound it.
//
// Design.  A 32 x 8 block covers a 32 x 8 pixel tile, one pixel per
// thread: 240x320 and 260x346 give 600 and 726 blocks of 256 threads,
// five resident per SM.  The block loads its tile with a 4-px halo into
// shared memory; each thread wraps its halo columns once and each tile row
// once, with one % each.  The first pass over a circle reads its taps at
// offsets fixed at compile time and copies the values, twice over, into
// this thread's column of a shared buffer (k-major, stride = block size,
// so a warp's reads hit 32 distinct banks); the arc expansion then reads
// the value at its data-dependent index there with one conflict-free
// shared load per step, and its two ends walk the doubled circle without
// wrapping.  That replaces the __constant__ (dx, dy) tables, whose
// divergent indices serialized each warp's reads, and the % by 16 and 20.
// Two pixels a thread (the second 32 px to the right) measured slower on
// the H100 (PERF.md): their doubled buffer halves the resident warps,
// which hide the expansion's latency better than a second arc per thread.
// The output is written as torch.bool, one byte a pixel.
//
// ptxas (sm_90a): 48 registers, no spills, 43,520 bytes of static shared
// memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;              // threads along x = tile width (pixels)
constexpr int TY = 8;               // threads along y = tile height (pixels)
constexpr int NT = TX * TY;         // threads per block
constexpr int PAD = 4;              // halo = largest circle radius
constexpr int TW = TX + 2 * PAD;    // tile width in shared memory
constexpr int TH = TY + 2 * PAD;
constexpr int NMAX = 20;            // taps of the larger circle

// Tap k of the N-point circle as an offset in the tile
// (esvio_tpu/events/corners.py SMALL_CIRCLE / LARGE_CIRCLE, (dx, dy)).
template <int N>
__device__ __forceinline__ constexpr int tap(int k) {
  constexpr int sdx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int sdy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  constexpr int ldx[20] = {0, 1, 2, 3, 4, 4, 4, 3, 2, 1, 0, -1, -2, -3, -4, -4, -4, -3, -2, -1};
  constexpr int ldy[20] = {4, 4, 3, 2, 1, 0, -1, -2, -3, -4, -4, -4, -3, -2, -1, 0, 1, 2, 3, 4};
  return N == 16 ? sdy[k] * TW + sdx[k] : ldy[k] * TW + ldx[k];
}

// Newest-arc test on one circle for this thread's pixel: the same
// comparisons as corners._newest_segment_size (strict '>' so the first
// maximum wins, '>=' for growth).  `buf` is this thread's column of the
// shared value buffer, which holds the circle twice: value k at
// buf[k * NT] and again at k + N, so the arc's right end walks up from
// start + 1 and its left end down from start + N - 1 without wrapping.
template <int N, int MIN_T, int MAX_T>
__device__ __forceinline__ bool circle_ok(const float* tile, int base, float* buf) {
  auto at = [&](int k) -> float& { return buf[k * NT]; };
  float seg_min = tile[base + tap<N>(0)];
  int start = 0;
  at(0) = seg_min;
  at(N) = seg_min;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    const float v = tile[base + tap<N>(k)];
    at(k) = v;
    at(k + N) = v;
    if (v > seg_min) { seg_min = v; start = k; }
  }

  int right = start + 1, left = start + N - 1, seg_size = MIN_T;
  float right_val = at(right), left_val = at(left);
  float right_min = right_val, left_min = left_val;

  // one step: grow the arc on the side `go_right` names, one shared load
  auto extend = [&](bool go_right) {
    const float v = at(go_right ? right + 1 : left - 1);
    right += go_right;
    left -= !go_right;
    right_val = go_right ? v : right_val;
    left_val = go_right ? left_val : v;
    right_min = go_right ? fminf(right_min, v) : right_min;
    left_min = go_right ? left_min : fminf(left_min, v);
  };

#pragma unroll
  for (int i = 1; i < MIN_T; ++i) {
    const bool go_right = right_val > left_val;
    seg_min = go_right ? fminf(seg_min, right_min) : fminf(seg_min, left_min);
    extend(go_right);
  }
#pragma unroll
  for (int i = MIN_T; i < N; ++i) {
    const bool go_right = right_val > left_val;
    const float ext_val = go_right ? right_val : left_val;
    const float ext_min = go_right ? right_min : left_min;
    if (ext_val >= seg_min) {
      seg_size = i + 1;
      seg_min = fminf(seg_min, ext_min);
    }
    if (i + 1 < N) extend(go_right);
  }
  return (seg_size <= MAX_T) || (seg_size >= N - MAX_T && seg_size <= N - MIN_T);
}

__global__ void __launch_bounds__(NT)
corner_mask_kernel(const float* __restrict__ sae, uint8_t* __restrict__ out, int H, int W) {
  __shared__ float tile[TH * TW];
  __shared__ float vals[2 * NMAX * NT];
  const int plane = blockIdx.z;
  const float* src = sae + static_cast<size_t>(plane) * H * W;
  const int x0 = blockIdx.x * TX - PAD;
  const int y0 = blockIdx.y * TY - PAD;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  // halo wraps like jnp.roll: each thread's columns once, each row once
  constexpr int NCOL = (TW + TX - 1) / TX;
  int gx[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    int g = (x0 + tx + j * TX) % W;
    gx[j] = g < 0 ? g + W : g;
  }
  for (int row = ty; row < TH; row += TY) {
    int gy = (y0 + row) % H;
    gy = gy < 0 ? gy + H : gy;
    const float* srow = src + static_cast<size_t>(gy) * W;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int col = tx + j * TX;
      if (col < TW) tile[row * TW + col] = srow[gx[j]];
    }
  }
  __syncthreads();

  const int base = (ty + PAD) * TW + tx + PAD;
  float* buf = vals + ty * TX + tx;
  const bool ok_s = circle_ok<16, 4, 6>(tile, base, buf);
  const bool ok_l = circle_ok<20, 5, 8>(tile, base, buf);

  const int y = blockIdx.y * TY + ty;
  const int x = blockIdx.x * TX + tx;
  if (y < H && x < W)
    out[static_cast<size_t>(plane) * H * W + static_cast<size_t>(y) * W + x] = (ok_s && ok_l) ? 1 : 0;
}

}  // namespace

// sae: (planes, H, W) float32 contiguous; out: (planes, H, W) torch.bool
// storage (one byte per pixel, 0 or 1).  Launches on `stream`; returns
// cudaGetLastError() of the launch.
extern "C" int esv_corner_mask(const float* sae, uint8_t* out, int planes,
                               int H, int W, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(TX, TY, 1);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, planes);
  corner_mask_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(sae, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
