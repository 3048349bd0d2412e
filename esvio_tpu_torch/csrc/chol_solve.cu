// Damped Cholesky solve of the reduced camera system — hand-written CUDA
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel esvio_tpu/solver/chol_pallas.py:145
// (chol_solve_batched, body _kernel): x with (A + λI) x = b for B SPD
// systems of size N = 190, padded inside the kernel to NP = 192 with two
// unit-diagonal rows.  U^T U factorization of [A | b], whose last column
// becomes the forward substitution (U^T y = b), then backward
// substitution (U x = y), all in plain float32 FMA (no TF32, no tensor
// cores: the reference runs at Precision.HIGHEST, chol_pallas.py:86).
//
// NaN contract: a non-positive pivot gives rsqrtf(pivot) = NaN (or inf),
// which poisons the rest of the factor and the solution; nothing clamps
// and nothing exits early.  The LM loop reads a non-finite dx as a failed
// step and raises λ (gauss_newton.reduced_solve).
//
// Bound on an H100 (SXM, 700 W): 2·190³/3 + 2·190² ≈ 4.65 MFLOP per
// system at the 67 TFLOP/s float32 peak is 0.069 µs; the bytes (A, b, λ
// in, x out: 146 KB) take 0.044 µs at 3.35 TB/s, so operations bound it.
// One CTA per system uses one SM: 4.65 MFLOP at 67/132 TFLOP/s ≈ 9.2 µs is
// this design's own ceiling.  The pipeline solves B = 1 system per LM
// iteration, the batched dp solve B = 8; both take one wave.
//
// Design.  One CTA of 512 threads per system keeps [A | b] (192 x 196
// floats) in dynamic shared memory for the whole solve.  The kernel reads
// A, b and λ as the caller holds them: A's rows arrive by 8-byte cp.async
// copies, all in flight at once, then λ goes on the diagonal and the pad
// rows and b's column are written, so the wrapper launches nothing else.
// The factorization is blocked and right-looking with panels of NB = 32;
// per panel
//   1. warp 0 factors the 32 x 32 diagonal block in registers (lane c
//      holds column c; see factor_diag), no block barrier inside it;
//   2. one thread per remaining column (b included, as column 192) solves
//      U11^T U12 = A12 in registers, reading U11's rows as float4
//      broadcasts;
//   3. SYRK A22 -= U12^T U12 over the upper triangle: each thread keeps a
//      4 x 4 tile in registers, fed by float4 reads of the panel rows (the
//      row stride of 196 floats keeps them 16-byte aligned).
// That is 3 barriers per panel where the column-by-column design took 32.
// The backward substitution walks 32-row blocks from the bottom: warp 0
// solves the diagonal block with shuffles, then all threads apply the
// block's GEMV to the rows above.  30 barriers in all, against 385.
// The summation order differs from a column-by-column factorization, so
// results are held to float64 (relative 5e-5), not to its bits.
//
// What is left: the two 192-step dependent chains (pivots, back
// substitution), and the SYRK's late panels, which leave most warps idle.
//
// ptxas (sm_90a, 512 threads): 76 registers, no spills, no stack frame,
// 151,424 bytes of dynamic shared memory.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int N = 190;            // live system size
constexpr int NP = 192;           // padded size
constexpr int LD = 196;           // row stride: column NP holds b, then y, then x
constexpr int NB = 32;            // panel width: one lane per column
constexpr int TQ = 4;             // SYRK register tile
constexpr int THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;
static_assert(NB == 32, "one lane per column of a panel; SYRK units of 32 columns");
constexpr int SMEM_BYTES = (NP * LD + NP + NB) * static_cast<int>(sizeof(float));

// Warp 0 factors the NB x NB diagonal block at (k0, k0) in registers:
// lane c holds column k0 + c.  Row j of U goes to shared memory and comes
// back as float4 broadcasts; the next pivot needs only lane j+1's own u,
// so its shuffle does not wait for the row.  Writes U's rows (and garbage
// below the diagonal, which nothing reads) and 1/U[j][j] to s_inv.
__device__ __forceinline__ void factor_diag(float* R, float* s_inv, int k0, int lane) {
  float reg[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) reg[i] = R[(k0 + i) * LD + k0 + lane];
  float my_s = 0.0f;
  float piv = __shfl_sync(FULL, reg[0], 0);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float s = rsqrtf(piv);
    const float u = reg[j] * s;                 // U[k0+j][k0+lane]
    if (lane == j) my_s = s;
    reg[j] = u;
    float* urow = R + (k0 + j) * LD + k0;
    urow[lane] = u;
    if (j + 1 < NB) piv = __shfl_sync(FULL, fmaf(-u, u, reg[j + 1]), j + 1);
    __syncwarp();
#pragma unroll
    for (int m = (j + 1) / 4 * 4; m < NB; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(urow + m);
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (m + q > j) reg[m + q] = fmaf(-w[q], u, reg[m + q]);
    }
  }
  s_inv[k0 + lane] = my_s;
}

// One 4 x 4 tile of the SYRK: R[r0.., c0..] -= U12[:, r0..]^T U12[:, c0..]
// over the panel rows k0 .. k0 + NB - 1.
__device__ __forceinline__ void syrk_tile(float* R, int k0, int r0, int c0) {
  float acc[TQ][TQ] = {};
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    const float* pr = R + (k0 + q) * LD;
    const float4 ur = *reinterpret_cast<const float4*>(pr + r0);
    const float4 uc = *reinterpret_cast<const float4*>(pr + c0);
    const float rv[TQ] = {ur.x, ur.y, ur.z, ur.w};
    const float cv[TQ] = {uc.x, uc.y, uc.z, uc.w};
#pragma unroll
    for (int a2 = 0; a2 < TQ; ++a2)
#pragma unroll
      for (int b2 = 0; b2 < TQ; ++b2) acc[a2][b2] = fmaf(rv[a2], cv[b2], acc[a2][b2]);
  }
#pragma unroll
  for (int a2 = 0; a2 < TQ; ++a2) {
    float4* row = reinterpret_cast<float4*>(R + (r0 + a2) * LD + c0);
    float4 v = *row;
    v.x -= acc[a2][0];
    v.y -= acc[a2][1];
    v.z -= acc[a2][2];
    v.w -= acc[a2][3];
    *row = v;
  }
}

__global__ void __launch_bounds__(THREADS)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  const float* __restrict__ lam, float* __restrict__ x) {
  extern __shared__ __align__(16) float smem[];
  float* R = smem;                  // [A + λI | b], row-major, stride LD
  float* s_inv = smem + NP * LD;    // 1/U[j][j]
  float* xs = s_inv + NP;           // the diagonal block's x, for the GEMV

  const int sys = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* Ag = A + static_cast<size_t>(sys) * N * N;
  const float* bg = b + static_cast<size_t>(sys) * N;
  const float lm = lam[sys];

  // A's rows go straight to shared memory as 8-byte cp.async copies (190
  // floats a row, 8-byte aligned), all in flight at once; then λ on the
  // diagonal, the pad rows and columns, and b as column NP
  for (int i = tid; i < N * (N / 2); i += THREADS) {
    const int r = i / (N / 2);
    const int c = 2 * (i - r * (N / 2));
    __pipeline_memcpy_async(R + r * LD + c, Ag + r * N + c, 8);
  }
  __pipeline_commit();
  for (int i = tid; i < NP * (LD - N); i += THREADS) {
    const int r = i / (LD - N);
    const int c = N + (i - r * (LD - N));
    R[r * LD + c] = c == NP ? (r < N ? bg[r] : 0.0f) : (r == c ? 1.0f : 0.0f);
  }
  for (int i = tid; i < (NP - N) * N; i += THREADS) R[N * LD + i / N * LD + i % N] = 0.0f;
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int r = tid; r < N; r += THREADS) R[r * LD + r] += lm;
  __syncthreads();

  // ---- blocked factorization; R's upper triangle becomes U, column NP y
  for (int k0 = 0; k0 < NP; k0 += NB) {
    const int k1 = k0 + NB;
    if (warp == 0) factor_diag(R, s_inv, k0, lane);
    __syncthreads();

    // panel rows right of the block, b included: U11^T U12 = A12
    for (int c = k1 + tid; c <= NP; c += THREADS) {
      float u[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) u[i] = R[(k0 + i) * LD + c];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        u[j] *= s_inv[k0 + j];
        const float* uj = R + (k0 + j) * LD + k0;
#pragma unroll
        for (int m = (j + 1) / 4 * 4; m < NB; m += 4) {
          const float4 v = *reinterpret_cast<const float4*>(uj + m);
          const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (m + q > j) u[m + q] = fmaf(-w[q], u[j], u[m + q]);
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) R[(k0 + i) * LD + c] = u[i];
    }
    __syncthreads();
    if (k1 == NP) break;

    // SYRK over the trailing m x m block in warp units of 16 rows x 32
    // columns (lane = 4 x 8 grid of 4 x 4 thread tiles, so a warp's float4
    // reads of a panel row touch 4 + 8 distinct addresses: one wavefront
    // each).  Column unit C needs row units R <= 2C + 1 (the upper
    // triangle; the lower tiles it also computes are never read); units are
    // ordered by C, C starting at unit C(C + 1).  Then b's column, 4 rows
    // a thread.
    const int m = NP - k1;
    const int n_units = (m / 32) * (m / 32 + 1);
    const int n_b_units = (m / 4 + 31) / 32;
    for (int u = warp; u < n_units + n_b_units; u += THREADS / 32) {
      int r0, c0;
      if (u < n_units) {
        int C = static_cast<int>((sqrtf(1.0f + 4.0f * u) - 1.0f) * 0.5f);
        while (C * (C + 1) > u) --C;
        while ((C + 1) * (C + 2) <= u) ++C;
        r0 = k1 + (u - C * (C + 1)) * 16 + (lane >> 3) * TQ;
        c0 = k1 + C * 32 + (lane & 7) * TQ;
      } else {
        const int t = (u - n_units) * 32 + lane;
        if (t >= m / 4) continue;
        r0 = k1 + t * TQ;
        c0 = NP;
      }
      syrk_tile(R, k0, r0, c0);
    }
    __syncthreads();
  }

  // ---- blocked backward substitution U x = y, 32-row blocks from the bottom
  for (int k0 = NP - NB; k0 >= 0; k0 -= NB) {
    if (warp == 0) {
      float u[NB];                  // row k0 + lane of the diagonal block
      const float4* urow = reinterpret_cast<const float4*>(R + (k0 + lane) * LD + k0);
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {
        const float4 v = urow[q];
        u[4 * q] = v.x;
        u[4 * q + 1] = v.y;
        u[4 * q + 2] = v.z;
        u[4 * q + 3] = v.w;
      }
      float y = R[(k0 + lane) * LD + NP];
#pragma unroll
      for (int j = NB - 1; j >= 0; --j) {
        const float xj = __shfl_sync(FULL, y * s_inv[k0 + j], j);
        if (lane == j) y = xj;
        else if (lane < j) y = fmaf(-u[j], xj, y);
      }
      R[(k0 + lane) * LD + NP] = y;
      xs[lane] = y;
    }
    __syncthreads();
    if (k0 == 0) break;
    for (int r = tid; r < k0; r += THREADS) {
      const float4* urow = reinterpret_cast<const float4*>(R + r * LD + k0);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {
        const float4 v = urow[q];
        acc = fmaf(v.x, xs[4 * q], acc);
        acc = fmaf(v.y, xs[4 * q + 1], acc);
        acc = fmaf(v.z, xs[4 * q + 2], acc);
        acc = fmaf(v.w, xs[4 * q + 3], acc);
      }
      R[r * LD + NP] -= acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < N; i += THREADS) x[static_cast<size_t>(sys) * N + i] = R[i * LD + NP];
}

}  // namespace

// A: (B, 190, 190), b: (B, 190), lam: (B,), x: (B, 190), all float32 and
// contiguous on the device.  Launches on `stream`; returns the error of
// the one-time shared-memory attribute call or cudaGetLastError() of the
// launch.  The attribute is set once per process (one device).
extern "C" int esv_chol_solve(const float* A, const float* b, const float* lam,
                              float* x, int B, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  chol_solve_kernel<<<B, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(A, b, lam, x);
  return static_cast<int>(cudaGetLastError());
}
