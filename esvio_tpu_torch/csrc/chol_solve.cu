// Fused Cholesky solve of the reduced camera system — hand-written CUDA
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel esvio_tpu/solver/chol_pallas.py
// (chol_solve_batched, body _kernel): x with A x = b for B padded SPD
// systems of size NP = 192 (the 190-dim reduced camera system plus two
// unit-diagonal pad rows; the wrapper adds the LM damping λI before the
// call).  Right-looking U^T U factorization of [A | b], which yields the
// forward substitution (U^T y = b) as its last column, then backward
// substitution (U x = y), all in plain float32 FMA (no TF32).
//
// NaN contract: a non-positive pivot gives rsqrtf(pivot) = NaN (or inf),
// which poisons the row and the solution; the LM loop reads a non-finite
// dx as a failed step and raises λ (gauss_newton.reduced_solve).
//
// What bounds it: ~385 block-wide barriers in a dependent chain (one per
// factor column, one per step of the 192-step backward substitution); the
// pipeline solves B = 1 system per LM iteration and the
// batched use B = 8, so at most 8 of the 132 SMs are busy.  It is bound by
// latency, not by FLOPs (1.2 MFLOP per system) or bytes (147 KB read
// once).  Design: one CTA per system keeps the whole 192 x 192 matrix and
// the right-hand side (148,224 B) in dynamic shared memory for both
// phases, so nothing but A, b and x touches device memory; 1024 threads
// on a 32 x 32 grid keep each trailing update to a few strided sweeps, and
// each thread recomputes the pivot scale and x_j instead of waiting at a
// barrier for one thread to publish them.

#include <cuda_runtime.h>

namespace {

constexpr int NP = 192;
constexpr int LD = NP + 1;        // row stride: column NP carries b, then y
constexpr int THREADS = 1024;     // 32 x 32: a warp spans 32 columns

__global__ void __launch_bounds__(THREADS)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x) {
  // [A | b] row-major with stride LD.  The odd stride also keeps the
  // column reads of the backward substitution free of bank conflicts.
  extern __shared__ float R[];
  __shared__ float s_row[NP];   // 1/sqrt(pivot) of each row
  __shared__ float xs[NP];

  const int sys = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid & 31;      // column lane
  const int ty = tid >> 5;      // row lane
  const float* Ag = A + static_cast<size_t>(sys) * NP * NP;
  for (int i = tid; i < NP * NP; i += THREADS) R[(i / NP) * LD + i % NP] = Ag[i];
  for (int i = tid; i < NP; i += THREADS) R[i * LD + NP] = b[static_cast<size_t>(sys) * NP + i];
  __syncthreads();

  // ---- factorization A = U^T U of [A | b], one barrier per column.  Row j
  // of R stays unscaled; U's row j is R's row j times s = 1/sqrt(R[j][j]),
  // formed on the fly by every thread, so the trailing update
  //   R[r][c] -= U[j][r] U[j][c]        (j < r <= c <= NP)
  // never waits for a scaled row to be written.  Column NP carries b and
  // ends as the forward substitution U^T y = b (y_j = R[j][NP] * s_j).
  for (int j = 0; j < NP; ++j) {
    const float* rj = R + j * LD;
    const float s = rsqrtf(rj[j]);
    if (tid == 0) s_row[j] = s;
    for (int r = j + 1 + ty; r < NP; r += 32) {
      const float ujr = rj[r] * s;
      float* row = R + r * LD;
      for (int c = r + tx; c <= NP; c += 32) row[c] = fmaf(-ujr, rj[c] * s, row[c]);
    }
    __syncthreads();
  }
  for (int i = tid; i < NP; i += THREADS) R[i * LD + NP] *= s_row[i];
  __syncthreads();

  // ---- backward substitution U x = y, column-oriented, one barrier per
  // step: every thread forms x_j itself, then y_i -= U[i][j] x_j for i < j
  for (int j = NP - 1; j >= 0; --j) {
    const float xj = R[j * LD + NP] / (R[j * LD + j] * s_row[j]);
    if (tid == 0) xs[j] = xj;
    for (int i = tid; i < j; i += THREADS)
      R[i * LD + NP] = fmaf(-(R[i * LD + j] * s_row[i]), xj, R[i * LD + NP]);
    __syncthreads();
  }

  for (int i = tid; i < NP; i += THREADS) x[static_cast<size_t>(sys) * NP + i] = xs[i];
}

}  // namespace

// A: (B, 192, 192) float32 SPD (damped, padded); b: (B, 192); x: (B, 192).
// Launches on `stream`; returns cudaGetLastError() (including the
// shared-memory attribute call).
extern "C" int esv_chol_solve(const float* A, const float* b, float* x, int B,
                              void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = NP * LD * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(A, b, x);
  return static_cast<int>(cudaGetLastError());
}
