// Pyramidal Lucas-Kanade, a forward pass and its reverse check in one
// launch — hand-written CUDA for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's LK is jit-compiled jnp, a
// lax.while_loop over the Gauss-Newton iterations of each pyramid level
// (esvio_tpu/frontend/lk.py:145).  It was added because eager PyTorch
// cannot run that loop without the host: the plain version
// (esvio_tpu_torch/frontend/lk.py) launches some 38 small operations an
// iteration and reads "all lanes converged" back before the next one, so
// the card waited on Python through some 300 iterations a front end a tick.
//
// The function, per feature lane, is the plain version's: for each level
// from coarse to fine, cut 48 x 48 patches of the previous and the current
// image (origins clamped into the image), take 3 x 3 Scharr gradients of
// the previous patch with edge replication and the 1/32 normalisation,
// sample the 21 x 21 template and its gradients bilinearly at the previous
// point, then iterate δ = -G⁻¹ Σ ∇I·(J - T) on the current patch until
// |δ| < eps or `iters`; the guess doubles between levels and the status
// (min eigenvalue, the point in the previous image, in the current one and
// inside its patch) counts at level 0 only.  The reverse pass tracks the
// forward result back over the two finest levels, from the original
// points, with the forward status as its valid flag.
//
// Why stopping each lane on its own is the same result: a converged lane
// never moves again in the plain version (g = where(converged, g, g + δ)),
// so its global "all converged" exit and a lane's own exit give the same
// points.  A lane's reverse check needs only that lane's forward result.
//
// Bound on an H100 (SXM, 700 W): a lane cuts two 48 x 48 patches a level
// (18.4 KB), but the patches overlap and come from L2, so the bytes it
// must move are the level images of both pyramids once: 0.96 MB at
// 346 x 260, 3.3 MB at 640 x 480 (0.3-1.0 µs at 3.35 TB/s).  An iteration
// costs ~30 FLOP a window pixel: 0.04-0.17 GFLOP for the 3,000-13,000 lane
// iterations of a launch at the cells' shapes (0.6-2.6 µs of float32 at
// 67 TFLOP/s).  Neither binds: the iterations of a level are a serial
// chain (each needs the previous δ), 80-180 a launch at the cells' shapes,
// so the latency of one iteration (samples, a block reduction, the 2 x 2
// solve) is what the design spends on: 0.6-0.75 µs each, 0.06-0.11 ms a
// launch (PERF.md).
//
// Design.  One block of 256 threads per lane (256 lanes at the tracker's
// capacity: two blocks per SM on 132 SMs, one wave).  A level cuts both
// patches into shared memory (Sy = min(48, H), Sx = min(48, W)), computes
// the gradient patches there, and leaves each thread its two of the 441
// window pixels' template and gradient values in registers.  An iteration
// samples the current patch at those two pixels, sums ∇I·r with warp
// shuffles (an xor butterfly, so every lane of a warp holds the same sum)
// and one cross-warp step through a double-buffered shared array that every
// thread reads in the same order: every thread then holds bit-identical
// sums, forms the same δ and takes the same exit, with one __syncthreads
// an iteration and no shared flag.  Sampling clamps to [0, S - 1] as the
// hat weights do and never reads past index S - 1.  Products and sums the
// plain version rounds one by one (gradients, G, δ, |δ|²) are written with
// _rn intrinsics so that nvcc does not fuse them into FMAs; the window sums
// still run in another order than the plain version's.  Invalid lanes
// skip every level and return their initial guess through the same
// scaling (exact: powers of two), with status false.  Each level loop
// writes the lane's iteration count; the wrapper takes the maximum over
// lanes, the plain version's count, only when the per-tick record reads it.
// The kernel allocates and synchronises nothing.
//
// ptxas (sm_90a): 64 registers, no spills, 37,056 bytes of static shared
// memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 21;                    // window side
constexpr int HALF = WIN / 2;
constexpr int NPIX = WIN * WIN;            // 441 window pixels
constexpr int PATCH = 48;                  // patch side (tracking range ±13 px a level)
constexpr int NT = 256;                    // threads per block (one lane)
constexpr int NWARP = NT / 32;
constexpr int PPT = (NPIX + NT - 1) / NT;  // window pixels per thread: 2
constexpr int MAXL = 8;                    // pyramid levels the interface takes
constexpr int FB_LEVELS = 2;               // reverse-check levels, the finest (maxLevel)
constexpr float MIN_EIG_THRESH = 1e-4f;    // OpenCV minEigThreshold (per pixel)
constexpr float DET_MIN = 1e-12f;

struct Pyramids {
  const float* a[MAXL];  // the forward pass's previous images, level 0 first
  const float* b[MAXL];  // its current images (the reverse pass's previous)
  int h[MAXL];
  int w[MAXL];
  int levels;            // levels of the forward pass
};

struct Smem {
  float prev[PATCH * PATCH];
  float ix[PATCH * PATCH];
  float iy[PATCH * PATCH];
  float cur[PATCH * PATCH];
  float part[2][3][NWARP];  // per-warp partial sums, double-buffered
};

// Sum K values over the block; every thread gets the same bits.  `phase`
// alternates the partials' buffer, so one barrier a call suffices: a warp
// writes buffer p again only after the next call's barrier, which every
// warp reaches after it has read buffer p.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], Smem& s, int& phase) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s.part[phase][k][threadIdx.x >> 5] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = s.part[phase][k][0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) t += s.part[phase][k][w];
    v[k] = t;
  }
  phase ^= 1;
}

// Bilinear sample of a patch (row stride PATCH) at (ry, rx) in patch
// coordinates, clamped to [0, S - 1] like the plain version's hat weights
// max(0, 1 - |r - s|); the second tap is clamped too (its weight is then 0).
__device__ __forceinline__ float sample(const float* p, float ry, float rx, int sy, int sx) {
  ry = fminf(fmaxf(ry, 0.0f), static_cast<float>(sy - 1));
  rx = fminf(fmaxf(rx, 0.0f), static_cast<float>(sx - 1));
  const float fy = floorf(ry);
  const float fx = floorf(rx);
  const int y0 = static_cast<int>(fy);
  const int x0 = static_cast<int>(fx);
  const int y1 = min(y0 + 1, sy - 1);
  const int x1 = min(x0 + 1, sx - 1);
  const float wy0 = 1.0f - (ry - fy);
  const float wy1 = fmaxf(1.0f - ((fy + 1.0f) - ry), 0.0f);
  const float wx0 = 1.0f - (rx - fx);
  const float wx1 = fmaxf(1.0f - ((fx + 1.0f) - rx), 0.0f);
  const float v0 = wy0 * p[y0 * PATCH + x0] + wy1 * p[y1 * PATCH + x0];
  const float v1 = wy0 * p[y0 * PATCH + x1] + wy1 * p[y1 * PATCH + x1];
  return v0 * wx0 + v1 * wx1;
}

// 3a + 10b + 3c, rounded step by step as the plain version adds it
__device__ __forceinline__ float smooth(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(3.0f, a), __fmul_rn(10.0f, b)), __fmul_rn(3.0f, c));
}

// clamp(floor(v) - half, 0, hi) as the plain version's int64 origin
__device__ __forceinline__ int origin(float v, int half, int hi) {
  const int f = static_cast<int>(fminf(fmaxf(floorf(v), -1.0e8f), 1.0e8f));
  return min(max(f - half, 0), hi);
}

// Cut a patch of `img` (H x W) at (oy, ox) into `dst`.
__device__ __forceinline__ void load_patch(float* dst, const float* __restrict__ img, int W,
                                           int oy, int ox, int sy, int sx) {
  for (int i = threadIdx.x; i < sy * sx; i += NT) {
    const int y = i / sx;
    const int x = i - y * sx;
    dst[y * PATCH + x] = __ldg(img + static_cast<size_t>(oy + y) * W + ox + x);
  }
}

// One level of one lane: the plain version's _track_level.  Updates the
// guess (gx, gy); returns the iterations run and sets `ok` to the status
// terms (min eigenvalue, in previous, in current, in patch).
__device__ int track_level(Smem& s, int& phase, const float* __restrict__ img_p,
                           const float* __restrict__ img_c, int H, int W, float px,
                           float py, float& gx, float& gy, int iters, float eps_sq,
                           bool& ok) {
  const int sy = min(PATCH, H);
  const int sx = min(PATCH, W);
  const int tid = threadIdx.x;

  const int oy_t = origin(py, sy / 2, H - sy);
  const int ox_t = origin(px, sx / 2, W - sx);
  const int oy_c = origin(gy, sy / 2, H - sy);
  const int ox_c = origin(gx, sx / 2, W - sx);
  load_patch(s.prev, img_p, W, oy_t, ox_t, sy, sx);
  load_patch(s.cur, img_c, W, oy_c, ox_c, sy, sx);
  __syncthreads();

  // Scharr gradients of the previous patch, edges replicated
  for (int i = tid; i < sy * sx; i += NT) {
    const int y = i / sx;
    const int x = i - y * sx;
    const int ym = max(y - 1, 0) * PATCH, y0 = y * PATCH, yp = min(y + 1, sy - 1) * PATCH;
    const int xm = max(x - 1, 0), xp = min(x + 1, sx - 1);
    const float* p = s.prev;
    const float rows_m = smooth(p[ym + xm], p[y0 + xm], p[yp + xm]);
    const float rows_p = smooth(p[ym + xp], p[y0 + xp], p[yp + xp]);
    const float cols_m = smooth(p[ym + xm], p[ym + x], p[ym + xp]);
    const float cols_p = smooth(p[yp + xm], p[yp + x], p[yp + xp]);
    s.ix[y0 + x] = __fdiv_rn(__fsub_rn(rows_p, rows_m), 32.0f);
    s.iy[y0 + x] = __fdiv_rn(__fsub_rn(cols_p, cols_m), 32.0f);
  }
  __syncthreads();

  // this thread's window pixels: template, gradients, offsets
  const float ry_t = py - static_cast<float>(oy_t);
  const float rx_t = px - static_cast<float>(ox_t);
  float tpl[PPT], gix[PPT], giy[PPT], offy[PPT], offx[PPT];
  float g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int k0 = tid + j * NT;
    const bool in = k0 < NPIX;
    const int k = in ? k0 : NPIX - 1;
    const int ky = k / WIN;
    offy[j] = static_cast<float>(ky - HALF);
    offx[j] = static_cast<float>(k - ky * WIN - HALF);
    const float ry = ry_t + offy[j];
    const float rx = rx_t + offx[j];
    // a padding slot samples a real pixel with zero weight
    tpl[j] = in ? sample(s.prev, ry, rx, sy, sx) : 0.0f;
    gix[j] = in ? sample(s.ix, ry, rx, sy, sx) : 0.0f;
    giy[j] = in ? sample(s.iy, ry, rx, sy, sx) : 0.0f;
    g[0] += __fmul_rn(gix[j], gix[j]);
    g[1] += __fmul_rn(gix[j], giy[j]);
    g[2] += __fmul_rn(giy[j], giy[j]);
  }
  block_sum<3>(g, s, phase);
  const float g_xx = g[0], g_xy = g[1], g_yy = g[2];
  const float det = __fsub_rn(__fmul_rn(g_xx, g_yy), __fmul_rn(g_xy, g_xy));
  const float dxy = __fsub_rn(g_xx, g_yy);
  const float disc = __fadd_rn(__fmul_rn(dxy, dxy), __fmul_rn(4.0f, __fmul_rn(g_xy, g_xy)));
  const float min_eig = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(g_xx, g_yy), __fsqrt_rn(disc)));
  const bool ok_grad = __fdiv_rn(min_eig, static_cast<float>(NPIX)) > MIN_EIG_THRESH;
  const float inv_det = det > DET_MIN ? __fdiv_rn(1.0f, det) : 0.0f;
  const bool in_prev = px >= HALF && px < W - HALF && py >= HALF && py < H - HALF;

  // Gauss-Newton on the current patch, cut around the level's first guess
  const float oyf = static_cast<float>(oy_c);
  const float oxf = static_cast<float>(ox_c);
  int n_it = 0;
  while (n_it < iters) {
    ++n_it;
    const float ry_c = gy - oyf;
    const float rx_c = gx - oxf;
    float b[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float r = sample(s.cur, ry_c + offy[j], rx_c + offx[j], sy, sx) - tpl[j];
      b[0] += __fmul_rn(gix[j], r);
      b[1] += __fmul_rn(giy[j], r);
    }
    block_sum<2>(b, s, phase);
    const float dx = -__fmul_rn(__fsub_rn(__fmul_rn(g_yy, b[0]), __fmul_rn(g_xy, b[1])), inv_det);
    const float dy = -__fmul_rn(__fsub_rn(__fmul_rn(g_xx, b[1]), __fmul_rn(g_xy, b[0])), inv_det);
    gx = __fadd_rn(gx, dx);
    gy = __fadd_rn(gy, dy);
    if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < eps_sq) break;
  }

  const bool in_cur = gx >= 0.0f && gx < W - 1.0f && gy >= 0.0f && gy < H - 1.0f;
  const float qx = gx - oxf;
  const float qy = gy - oyf;
  const bool in_patch = qx >= HALF - 1.0f && qx <= static_cast<float>(sx - HALF) &&
                        qy >= HALF - 1.0f && qy <= static_cast<float>(sy - HALF);
  ok = ok_grad && in_prev && in_cur && in_patch;
  return n_it;
}

// One pass (lk_track) of one lane over `levels` levels from images `src`
// to `dst`: pts (x, y) at level 0, init the level-0 initial guess.
// Writes each tracked level's iteration count at iters_out[loop++].
__device__ bool run_pass(Smem& s, int& phase, const float* const* src, const float* const* dst,
                         const int* hs, const int* ws, int levels, float px, float py,
                         float& gx, float& gy, bool active, int iters, float eps_sq,
                         int* iters_out, int& loop) {
  const float scale_top = static_cast<float>(1 << (levels - 1));
  gx = gx / scale_top;
  gy = gy / scale_top;
  bool status = true;
  for (int lvl = levels - 1; lvl >= 0; --lvl) {
    const int H = hs[lvl], W = ws[lvl];
    if (min(H, W) >= WIN) {  // levels smaller than the window are skipped
      int n_it = 0;
      if (active) {
        const float scale = static_cast<float>(1 << lvl);
        bool ok;
        n_it = track_level(s, phase, src[lvl], dst[lvl], H, W, px / scale, py / scale, gx,
                           gy, iters, eps_sq, ok);
        status = status && (lvl != 0 || ok);
      }
      if (threadIdx.x == 0) iters_out[loop] = n_it;
      ++loop;
    }
    if (lvl > 0) {
      gx = gx * 2.0f;
      gy = gy * 2.0f;
    }
  }
  return status && active;
}

__global__ void __launch_bounds__(NT)
lk_track_kernel(const Pyramids pyr, const float* __restrict__ pts,
                const float* __restrict__ init, const uint8_t* __restrict__ valid,
                float* __restrict__ pts_out, uint8_t* __restrict__ status_out,
                int* __restrict__ iters_out, int n_loops, int n, int iters, float eps_sq) {
  __shared__ Smem s;
  const int lane = blockIdx.x;
  int phase = 0;
  int loop = 0;
  int* it_lane = iters_out + static_cast<size_t>(lane) * n_loops;
  const float px = pts[2 * lane], py = pts[2 * lane + 1];

  // forward: previous -> current, from `init`
  float fx = init[2 * lane], fy = init[2 * lane + 1];
  const bool st_f = run_pass(s, phase, pyr.a, pyr.b, pyr.h, pyr.w, pyr.levels, px, py, fx, fy,
                             valid[lane] != 0, iters, eps_sq, it_lane, loop);
  // reverse: current -> previous over the finest levels, from the points
  float bx = px, by = py;
  const bool st_b = run_pass(s, phase, pyr.b, pyr.a, pyr.h, pyr.w, min(FB_LEVELS, pyr.levels),
                             fx, fy, bx, by, st_f, iters, eps_sq, it_lane, loop);
  if (threadIdx.x == 0) {
    pts_out[2 * lane] = fx;
    pts_out[2 * lane + 1] = fy;
    pts_out[2 * (n + lane)] = bx;
    pts_out[2 * (n + lane) + 1] = by;
    status_out[lane] = st_f;
    status_out[n + lane] = st_b;
  }
}

}  // namespace

// pyr: host array of 2 * levels device pointers (the forward pass's
// previous images, level 0 first, then its current ones), hw: host array
// of (H, W) per level, eps_sq: host pointer to the squared convergence
// threshold.  pts, init (n, 2), valid (n,) bool; pts_out (2, n, 2) and
// status_out (2, n) bool: forward, then reverse; iters_out (n, loops):
// each lane's iterations per level loop (tracked forward levels, coarse
// to fine, then the reverse's).
extern "C" int esv_lk_track(const float* const* pyr, const int* hw, int levels,
                            const float* pts, const float* init, const uint8_t* valid,
                            float* pts_out, uint8_t* status_out, int* iters_out, int n,
                            int iters, const float* eps_sq, void* stream) {
  if (levels < 1 || levels > MAXL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pyramids p{};
  int n_loops = 0;
  for (int l = 0; l < levels; ++l) {
    p.a[l] = pyr[l];
    p.b[l] = pyr[levels + l];
    p.h[l] = hw[2 * l];
    p.w[l] = hw[2 * l + 1];
    n_loops += (p.h[l] < p.w[l] ? p.h[l] : p.w[l]) >= WIN;
    if (l < FB_LEVELS) n_loops += (p.h[l] < p.w[l] ? p.h[l] : p.w[l]) >= WIN;
  }
  p.levels = levels;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  lk_track_kernel<<<n, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      p, pts, init, valid, pts_out, status_out, iters_out, n_loops, n, iters, *eps_sq);
  return static_cast<int>(cudaGetLastError());
}
