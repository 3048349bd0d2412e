// Normal-equation assembly of the sliding-window LM solve — hand-written
// CUDA for Hopper (sm_90a): kernel K4.
//
// Replaces no Pallas kernel: the JAX package leaves this assembly to XLA
// (esvio_tpu/solver/gauss_newton.py:671 assemble_normal_reduced), and the
// port's plain version (solver/gauss_newton.assemble_normal_reduced_plain)
// takes the factor Jacobians in forward mode and spreads them with one-hot
// products: about 1,250 small device operations an assembly.  K4 computes
// the same (Hpp, Hpl, hll, bp, bl, cost) in two launches, with the
// Jacobians in closed form (their plain PyTorch mirror is
// tests/assemble_cases.proj22_jac_closed / imu_residual_jac_closed, which the
// CPU tests hold against the forward-mode ones):
//
//   * the projection table: every lane of both books, 23 rows a lane
//     (11 mono with ex1 := ex0, 11 cross-stereo, 1 static-stereo), the
//     two-frame two-camera factor's 2 x 26 Jacobian
//     [pose_i | pose_j | ex0 | ex1 | λ | td], the gate and masks of
//     gauss_newton._proj_inputs, the Cauchy weight, the mono fold
//     (ex0 += ex1, ex1 := 0) and the static rows' zeroed pose blocks;
//   * the 10 IMU factors, 15 x 30 (integration_base.h / imu_factor.h, the
//     rotation residual's bias block exact), weighted by imu_sqrt;
//   * the prior: r = (r0 + J0 (x ⊟ lin)) valid, its gradient J0wᵀ r and
//     the given prior_H = J0wᵀ J0w.
//
// Bound on an H100 (700 W): 256 lanes x 23 rows x 2 residuals of 26
// columns, about 16 MFLOP in all (0.24 µs at 67 TFLOP/s), and 760 KB in
// and out (the 190 x 190 Hpp, prior_H and J0 are most of it, 0.23 µs at
// 3.35 TB/s; solver/normal_assembly.work counts both): the kernel is bound
// by latency, its dependent chains and its two launches, not by bytes or
// FLOP (44 µs at 128 + 128 lanes, PERF.md).
//
// Design.  Launch 1 (normal_rows_kernel), grid (lane groups + 11, B): a
// block of LANES warps per group of LANES lanes, one warp per lane.  Thread
// t < 23 of the warp computes row t in registers and leaves its weighted,
// folded 2 x 26 Jacobian and residual in shared memory.  The warp then
// reduces its lane: λ's sums (hll, bl, the Hpl column), the lane's
// gradient, and its share of H in "hub" form: the 19 hub columns (the
// start frame's pose, the book's two extrinsic slots, td) against every
// column, and the 6 x 6 diagonal block of every other frame; every other
// entry of a lane's share is zero, and a hub column sits at one fixed place
// in every row of its lane.  The block adds its lanes' shares lane by lane,
// in order, into a 91 x 91 partial in shared memory (the entries of one
// lane are distinct, so no two threads of a pass meet) and writes it, with
// the group's gradient and cost, to scratch.  Ten more blocks build the
// IMU factors (one each: thread 0 the 15 x 30 Jacobian, the block the
// weighted products) and one the prior's residual.  Launch 2
// (normal_reduce_kernel), one thread per entry of Hpp: prior_H, then the
// IMU factors that hold the entry, then the groups' partials, in that
// fixed order; its last block writes bp and the cost.  No atomics
// anywhere: the same input gives the same bits, and Hpp is symmetric bit
// for bit.  A lane that the gate keeps out costs one ballot.
//
// Inputs are float32 (bools as bytes) and contiguous, with B windows along
// a leading axis (every argument per window, g too); outputs are written
// whole, zeros included, so the wrapper allocates them with torch.empty.

#include <cuda_runtime.h>

namespace {

constexpr int NS = 11;                 // frames in the window
constexpr int N_IMU = NS - 1;
constexpr int OFF_SB = 66;
constexpr int OFF_EX = 165;
constexpr int DIM = 190;
constexpr int NC = 91;                 // projection columns: poses | ex | td
constexpr int TD_C = 90;
constexpr int ROWS = 2 * NS + 1;       // rows of a lane
constexpr int RW = 27;                 // a row's 26 columns and its residual
constexpr int LANES = 8;               // lanes of a block, one warp each
constexpr int THREADS = 32 * LANES;
constexpr int NHUB = 19;
constexpr int PART = NC * NC + NC + 1; // a group's partial: H, b, cost
constexpr int IMU_W = 30;
constexpr int IMU_PART = IMU_W * IMU_W + IMU_W + 1;
constexpr float PROJ_SQRT_INFO = 460.0f / 1.5f;
constexpr unsigned FULL = 0xffffffffu;

// shared floats of one warp (lane): its rows, its hub rows, its diagonal
// blocks, its Hpl column and its gradient; before them the group's H
constexpr int SM_ROWS = ROWS * 2 * RW;
constexpr int SM_HUB = NHUB * NC;
constexpr int SM_DIAG = NS * 36;
constexpr int SM_LANE = SM_ROWS + SM_HUB + SM_DIAG + 2 * NC;
constexpr int SM_PART = NC * NC;       // the group's H, summed lane by lane
constexpr int SMEM_BYTES = (SM_PART + LANES * SM_LANE + 2 * LANES) * static_cast<int>(sizeof(float));

// The order of the pointers in the host array `args` of the entry point
// (solver/normal_assembly.ARGS names them in this order).
enum Arg {
  A_P, A_Q, A_V, A_BA, A_BG, A_EX_P, A_EX_Q, A_TD,
  A_LIN_P, A_LIN_Q, A_LIN_V, A_LIN_BA, A_LIN_BG, A_LIN_EX_P, A_LIN_EX_Q, A_LIN_TD,
  A_J0, A_R0, A_PRIOR_VALID, A_PRIOR_H,
  A_DELTA_P, A_DELTA_Q, A_DELTA_V, A_PRE_JAC, A_SUM_DT, A_LIN_BA_PRE, A_LIN_BG_PRE,
  A_IMU_SQRT, A_IMU_VALID, A_G,
  A_IMG_UN, A_IMG_VEL, A_IMG_UN_R, A_IMG_VEL_R, A_IMG_OBS, A_IMG_STEREO,
  A_IMG_TD_OBS, A_IMG_INV_DEPTH, A_IMG_DEPTH_VALID, A_IMG_ACTIVE,
  A_EVT_UN, A_EVT_VEL, A_EVT_UN_R, A_EVT_VEL_R, A_EVT_OBS, A_EVT_STEREO,
  A_EVT_TD_OBS, A_EVT_INV_DEPTH, A_EVT_DEPTH_VALID, A_EVT_ACTIVE,
  A_HPP, A_HPL, A_HLL, A_BP, A_BL, A_COST, A_SCRATCH,
  N_ARGS
};

struct Args {
  const void* p[N_ARGS];
  int l_img, l_evt, n_groups;
  float cauchy_c;
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int i, int b, int per) {
  return static_cast<const T*>(a.p[i]) + static_cast<size_t>(b) * per;
}

__device__ __forceinline__ float* out(const Args& a, int i, int b, size_t per) {
  return const_cast<float*>(static_cast<const float*>(a.p[i])) + b * per;
}

__device__ __forceinline__ size_t scratch_per(const Args& a) {
  return static_cast<size_t>(a.n_groups) * PART + N_IMU * IMU_PART + DIM;
}

// ---------------------------------------------------------------- algebra
__device__ __forceinline__ void quat_rot(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.f - 2.f * (y * y + z * z); R[1] = 2.f * (x * y - w * z); R[2] = 2.f * (x * z + w * y);
  R[3] = 2.f * (x * y + w * z); R[4] = 1.f - 2.f * (x * x + z * z); R[5] = 2.f * (y * z - w * x);
  R[6] = 2.f * (x * z - w * y); R[7] = 2.f * (y * z + w * x); R[8] = 1.f - 2.f * (x * x + y * y);
}

__device__ __forceinline__ void quat_mul(const float* q, const float* p, float* o) {
  o[0] = q[0] * p[0] - q[1] * p[1] - q[2] * p[2] - q[3] * p[3];
  o[1] = q[0] * p[1] + q[1] * p[0] + q[2] * p[3] - q[3] * p[2];
  o[2] = q[0] * p[2] - q[1] * p[3] + q[2] * p[0] + q[3] * p[1];
  o[3] = q[0] * p[3] + q[1] * p[2] - q[2] * p[1] + q[3] * p[0];
}

// L(q) p = q ⊗ p and R(p) q = q ⊗ p, row-major 4 x 4
__device__ __forceinline__ void quat_left(const float* q, float* M) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float m[16] = {w, -x, -y, -z, x, w, -z, y, y, z, w, -x, z, -y, x, w};
  for (int i = 0; i < 16; ++i) M[i] = m[i];
}

__device__ __forceinline__ void quat_right(const float* p, float* M) {
  const float w = p[0], x = p[1], y = p[2], z = p[3];
  const float m[16] = {w, -x, -y, -z, x, w, z, -y, y, -z, w, x, z, y, -x, w};
  for (int i = 0; i < 16; ++i) M[i] = m[i];
}

// y = R v, y = Rᵀ v
__device__ __forceinline__ void mv(const float* R, const float* v, float* y) {
  for (int i = 0; i < 3; ++i) y[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

__device__ __forceinline__ void mtv(const float* R, const float* v, float* y) {
  for (int i = 0; i < 3; ++i) y[i] = R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2];
}

// a row of a 2 x 3 Jacobian times [v]x: (a × v)ᵀ
__device__ __forceinline__ void cross_row(const float* a, const float* v, float* o) {
  o[0] = a[1] * v[2] - a[2] * v[1];
  o[1] = a[2] * v[0] - a[0] * v[2];
  o[2] = a[0] * v[1] - a[1] * v[0];
}

// ------------------------------------------------------- projection rows
struct Book {
  const float *un, *vel, *un_r, *vel_r, *td_obs, *inv_depth;
  const unsigned char *obs, *stereo, *depth_valid, *active;
  int exl, exr, lane;   // extrinsic slots of the book, the lane in it
};

__device__ Book book_of(const Args& a, int b, int l) {
  const bool img = l < a.l_img;
  const int base = img ? A_IMG_UN : A_EVT_UN;
  const int L = img ? a.l_img : a.l_evt;
  Book k;
  k.lane = img ? l : l - a.l_img;
  k.exl = img ? 0 : 1;
  k.exr = k.exl + 2;
  k.un = in<float>(a, base + 0, b, L * NS * 2);
  k.vel = in<float>(a, base + 1, b, L * NS * 2);
  k.un_r = in<float>(a, base + 2, b, L * NS * 2);
  k.vel_r = in<float>(a, base + 3, b, L * NS * 2);
  k.obs = in<unsigned char>(a, base + 4, b, L * NS);
  k.stereo = in<unsigned char>(a, base + 5, b, L * NS);
  k.td_obs = in<float>(a, base + 6, b, L * NS);
  k.inv_depth = in<float>(a, base + 7, b, L);
  k.depth_valid = in<unsigned char>(a, base + 8, b, L);
  k.active = in<unsigned char>(a, base + 9, b, L);
  return k;
}

// Row t of lane k.lane (start frame s): its weighted and folded residual
// and 2 x 26 Jacobian into row[0..2*RW) (row k: 26 columns, then r_k);
// zeros where the row's mask is off.
__device__ void proj_row(const Args& a, int b, const Book& k, int s, float lam, int t, float* row) {
  const int F = NS;
  const int kind = t < F ? 0 : (t < 2 * F ? 1 : 2);      // mono, cross, static
  const int j = kind == 0 ? t : (kind == 1 ? t - F : s);
  const int lf = k.lane * F;
  const bool mask = kind == 0 ? (k.obs[lf + j] && j != s)
                  : kind == 1 ? (k.stereo[lf + j] && j != s) : k.stereo[lf + s] != 0;
  for (int i = 0; i < 2 * RW; ++i) row[i] = 0.f;
  if (!mask) return;

  const float* P = in<float>(a, A_P, b, NS * 3);
  const float* Q = in<float>(a, A_Q, b, NS * 4);
  const float* exp_ = in<float>(a, A_EX_P, b, 12);
  const float* exq = in<float>(a, A_EX_Q, b, 16);
  const float td = *in<float>(a, A_TD, b, 1);
  const int ex1 = kind == 0 ? k.exl : k.exr;

  float Ri[9], Rj[9], R0[9], R1[9];
  quat_rot(Q + 4 * s, Ri);
  quat_rot(Q + 4 * j, Rj);
  quat_rot(exq + 4 * k.exl, R0);
  quat_rot(exq + 4 * ex1, R1);
  const float* Pi = P + 3 * s;
  const float* Pj = P + 3 * j;
  const float* p0 = exp_ + 3 * k.exl;
  const float* p1 = exp_ + 3 * ex1;

  const float* pti = k.un + 2 * (lf + s);
  const float* veli = k.vel + 2 * (lf + s);
  const float tdi = k.td_obs[lf + s];
  const float* ptj = (kind == 0 ? k.un : k.un_r) + 2 * (lf + j);
  const float* velj = (kind == 0 ? k.vel : k.vel_r) + 2 * (lf + j);
  const float tdj = kind == 2 ? tdi : k.td_obs[lf + j];

  const float pts_i[3] = {pti[0] - (td - tdi) * veli[0], pti[1] - (td - tdi) * veli[1], 1.f};
  const float pts_j[2] = {ptj[0] - (td - tdj) * velj[0], ptj[1] - (td - tdj) * velj[1]};
  const float cam_i[3] = {pts_i[0] / lam, pts_i[1] / lam, pts_i[2] / lam};
  float imu_i[3], w[3], d[3], imu_j[3], e[3], cam_j[3];
  mv(R0, cam_i, imu_i);
  for (int c = 0; c < 3; ++c) imu_i[c] += p0[c];
  mv(Ri, imu_i, w);
  for (int c = 0; c < 3; ++c) d[c] = w[c] + Pi[c] - Pj[c];
  mtv(Rj, d, imu_j);
  for (int c = 0; c < 3; ++c) e[c] = imu_j[c] - p1[c];
  mtv(R1, e, cam_j);
  const float x = cam_j[0], y = cam_j[1], z = cam_j[2];
  const float r[2] = {PROJ_SQRT_INFO * (x / z - pts_j[0]), PROJ_SQRT_INFO * (y / z - pts_j[1])};
  const float iz = 1.f / z;
  const float red[2][3] = {{PROJ_SQRT_INFO * iz, 0.f, -PROJ_SQRT_INFO * x * iz * iz},
                           {0.f, PROJ_SQRT_INFO * iz, -PROJ_SQRT_INFO * y * iz * iz}};
  const float wgt = 1.f / sqrtf(1.f + (r[0] * r[0] + r[1] * r[1]) / (a.cauchy_c * a.cauchy_c));

  for (int q = 0; q < 2; ++q) {
    float d_imu_j[3], d_w[3], d_imu_i[3], d_cam_i[3], tmp[3];
    for (int c = 0; c < 3; ++c)         // red R1ᵀ
      d_imu_j[c] = red[q][0] * R1[3 * c] + red[q][1] * R1[3 * c + 1] + red[q][2] * R1[3 * c + 2];
    for (int c = 0; c < 3; ++c)         // · Rjᵀ
      d_w[c] = d_imu_j[0] * Rj[3 * c] + d_imu_j[1] * Rj[3 * c + 1] + d_imu_j[2] * Rj[3 * c + 2];
    for (int c = 0; c < 3; ++c)         // · Ri
      d_imu_i[c] = d_w[0] * Ri[c] + d_w[1] * Ri[3 + c] + d_w[2] * Ri[6 + c];
    for (int c = 0; c < 3; ++c)         // · R0
      d_cam_i[c] = d_imu_i[0] * R0[c] + d_imu_i[1] * R0[3 + c] + d_imu_i[2] * R0[6 + c];
    float J[26];
    for (int c = 0; c < 3; ++c) {
      J[c] = d_w[c];
      J[6 + c] = -d_w[c];
      J[12 + c] = d_imu_i[c];
      J[18 + c] = -d_imu_j[c];
    }
    cross_row(d_imu_i, imu_i, tmp);
    for (int c = 0; c < 3; ++c) J[3 + c] = -tmp[c];
    cross_row(d_imu_j, imu_j, tmp);
    for (int c = 0; c < 3; ++c) J[9 + c] = tmp[c];
    cross_row(d_cam_i, cam_i, tmp);
    for (int c = 0; c < 3; ++c) J[15 + c] = -tmp[c];
    cross_row(red[q], cam_j, tmp);
    for (int c = 0; c < 3; ++c) J[21 + c] = tmp[c];
    J[24] = -(d_cam_i[0] * pts_i[0] + d_cam_i[1] * pts_i[1] + d_cam_i[2] * pts_i[2]) / (lam * lam);
    J[25] = -(d_cam_i[0] * veli[0] + d_cam_i[1] * veli[1]) / lam + PROJ_SQRT_INFO * velj[q];

    float* o = row + q * RW;
    for (int c = 0; c < 26; ++c) o[c] = J[c] * wgt;
    if (kind == 0)                      // mono: ex1 is ex0
      for (int c = 12; c < 18; ++c) { o[c] += o[c + 6]; o[c + 6] = 0.f; }
    if (kind == 2)                      // static: j is i
      for (int c = 0; c < 12; ++c) o[c] = 0.f;
    o[26] = r[q] * wgt;
  }
}

// The hub index of 91-layout column c for a lane (start s, slots exl /
// exr): 0-5 the start pose, 6-11 exl, 12-17 exr, 18 td; -1 if c is none.
__device__ __forceinline__ int hub_of(int c, int s, int exl, int exr) {
  if (c < OFF_SB) return c / 6 == s ? c - 6 * s : -1;
  if (c == TD_C) return 18;
  const int e = (c - OFF_SB) / 6, o = c - OFF_SB - 6 * e;
  return e == exl ? 6 + o : (e == exr ? 12 + o : -1);
}

__device__ __forceinline__ int hub_col(int h, int s, int exl, int exr) {
  return h < 6 ? 6 * s + h : h < 12 ? OFF_SB + 6 * exl + h - 6 : h < 18 ? OFF_SB + 6 * exr + h - 12 : TD_C;
}

// A hub column's place in every row of its lane: the start pose is the
// pose_i block, exl the ex0 block, exr the ex1 block (zero in mono rows).
__device__ __forceinline__ int hub_src(int h) { return h < 6 ? h : (h < 18 ? h + 6 : 25); }

// The k-th column of the 60 pose columns outside the start frame s.
__device__ __forceinline__ int pose_col(int k, int s) {
  const int p = k / 6;
  return 6 * (p >= s ? p + 1 : p) + k - 6 * p;
}

// Σ over rows t of a lane (residuals both) of row[ca] * row[cb]: all rows,
// or frame p's mono and cross rows alone (p >= 0)
__device__ __forceinline__ float rows_dot(const float* rows, int ca, int cb, int p) {
  float v = 0.f;
  const int t0 = p < 0 ? 0 : p, dt = p < 0 ? 1 : NS, t1 = p < 0 ? ROWS : 2 * NS;
  for (int t = t0; t < t1; t += dt) {
    const float* rw = rows + t * 2 * RW;
    v = fmaf(rw[ca], rw[cb], v);
    v = fmaf(rw[RW + ca], rw[RW + cb], v);
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// ------------------------------------------------------------ IMU factor
// Factor k (frames k, k+1) unweighted: r (15) and J (15 x 30, row-major,
// zeroed by the caller) in [pose_i 6 | sb_i 9 | pose_j 6 | sb_j 9], as
// tests/assemble_cases.imu_residual_jac_closed.
__device__ void imu_factor(const Args& a, int b, int k, float* r, float* J) {
  const float* P = in<float>(a, A_P, b, NS * 3) + 3 * k;
  const float* Q = in<float>(a, A_Q, b, NS * 4) + 4 * k;
  const float* V = in<float>(a, A_V, b, NS * 3) + 3 * k;
  const float* Ba = in<float>(a, A_BA, b, NS * 3) + 3 * k;
  const float* Bg = in<float>(a, A_BG, b, NS * 3) + 3 * k;
  const float* dp = in<float>(a, A_DELTA_P, b, N_IMU * 3) + 3 * k;
  const float* dq = in<float>(a, A_DELTA_Q, b, N_IMU * 4) + 4 * k;
  const float* dv = in<float>(a, A_DELTA_V, b, N_IMU * 3) + 3 * k;
  const float* Jp = in<float>(a, A_PRE_JAC, b, N_IMU * 225) + 225 * k;
  const float sdt = in<float>(a, A_SUM_DT, b, N_IMU)[k];
  const float* lba = in<float>(a, A_LIN_BA_PRE, b, N_IMU * 3) + 3 * k;
  const float* lbg = in<float>(a, A_LIN_BG_PRE, b, N_IMU * 3) + 3 * k;
  const float* g = in<float>(a, A_G, b, 3);
  const float *Pj = P + 3, *Qj = Q + 4, *Vj = V + 3, *Baj = Ba + 3, *Bgj = Bg + 3;

  // the preintegration Jacobian's blocks (rows p 0, θ 3, v 6; cols ba 9, bg 12)
  auto blk = [&](int r0, int c0, int i, int c) { return Jp[(r0 + i) * 15 + c0 + c]; };
  float dba[3], dbg[3], th[3], cv[3], cp[3];
  for (int i = 0; i < 3; ++i) { dba[i] = Ba[i] - lba[i]; dbg[i] = Bg[i] - lbg[i]; }
  for (int i = 0; i < 3; ++i) {
    th[i] = cv[i] = cp[i] = 0.f;
    for (int c = 0; c < 3; ++c) {
      th[i] += blk(3, 12, i, c) * dbg[c];
      cv[i] += blk(6, 9, i, c) * dba[c] + blk(6, 12, i, c) * dbg[c];
      cp[i] += blk(0, 9, i, c) * dba[c] + blk(0, 12, i, c) * dbg[c];
    }
    cv[i] += dv[i];
    cp[i] += dp[i];
  }
  const float half[4] = {1.f, 0.5f * th[0], 0.5f * th[1], 0.5f * th[2]};
  float cq[4];
  quat_mul(dq, half, cq);
  float Ri[9];
  quat_rot(Q, Ri);
  float up[3], uv[3], vp[3], vv[3];
  for (int i = 0; i < 3; ++i) {
    up[i] = 0.5f * g[i] * sdt * sdt + Pj[i] - P[i] - V[i] * sdt;
    uv[i] = g[i] * sdt + Vj[i] - V[i];
  }
  mtv(Ri, up, vp);
  mtv(Ri, uv, vv);
  const float qic[4] = {Q[0], -Q[1], -Q[2], -Q[3]};
  float A[4];
  quat_mul(qic, Qj, A);
  const float n = cq[0] * cq[0] + cq[1] * cq[1] + cq[2] * cq[2] + cq[3] * cq[3];
  const float ic[4] = {cq[0] / n, -cq[1] / n, -cq[2] / n, -cq[3] / n};
  float icA[4];
  quat_mul(ic, A, icA);
  for (int i = 0; i < 3; ++i) {
    r[i] = vp[i] - cp[i];
    r[3 + i] = 2.f * icA[1 + i];
    r[6 + i] = vv[i] - cv[i];
    r[9 + i] = Baj[i] - Ba[i];
    r[12 + i] = Bgj[i] - Bg[i];
  }

  auto set = [&](int r0, int c0, int i, int c, float v) { J[(r0 + i) * IMU_W + c0 + c] = v; };
  // rotation blocks: -vec(L(ic) R(A)), vec(L(ic ⊗ A)), the bias block
  float Lic[16], RA[16], LicA[16], Ldq[16];
  quat_left(ic, Lic);
  quat_right(A, RA);
  quat_left(icA, LicA);
  quat_left(dq, Ldq);
  // G = L(δq)[:, 1:] dq_dbg / 2 (4 x 3); cG = cqᵀ G (3)
  float G[12], cG[3];
  for (int m = 0; m < 4; ++m)
    for (int c = 0; c < 3; ++c) {
      float v = 0.f;
      for (int q = 0; q < 3; ++q) v += Ldq[4 * m + 1 + q] * blk(3, 12, q, c);
      G[3 * m + c] = 0.5f * v;
    }
  for (int c = 0; c < 3; ++c)
    cG[c] = cq[0] * G[c] + cq[1] * G[3 + c] + cq[2] * G[6 + c] + cq[3] * G[9 + c];
  const float conj[4] = {1.f, -1.f, -1.f, -1.f};
  for (int i = 0; i < 3; ++i)
    for (int c = 0; c < 3; ++c) {
      const float RiT = Ri[3 * c + i];          // Riᵀ[i][c]
      set(0, 0, i, c, -RiT);                    // r_p / Pi
      set(0, 6, i, c, -RiT * sdt);              // r_p / Vi
      set(0, 9, i, c, -blk(0, 9, i, c));        // r_p / Bai
      set(0, 12, i, c, -blk(0, 12, i, c));      // r_p / Bgi
      set(0, 15, i, c, RiT);                    // r_p / Pj
      set(6, 6, i, c, -RiT);                    // r_v / Vi
      set(6, 9, i, c, -blk(6, 9, i, c));
      set(6, 12, i, c, -blk(6, 12, i, c));
      set(6, 21, i, c, RiT);                    // r_v / Vj
      float m = 0.f;                            // (L(ic) R(A))[1+i][1+c]
      for (int q = 0; q < 4; ++q) m += Lic[4 * (1 + i) + q] * RA[4 * q + 1 + c];
      set(3, 3, i, c, -m);
      set(3, 18, i, c, LicA[4 * (1 + i) + 1 + c]);
      float rg = 0.f;                           // (R(A) conj G)[1+i][c]
      for (int q = 0; q < 4; ++q) rg += RA[4 * (1 + i) + q] * conj[q] * G[3 * q + c];
      set(3, 12, i, c, (2.f / n) * rg - (4.f / n) * icA[1 + i] * cG[c]);
    }
  // skew blocks of r_p and r_v at θi: [Riᵀ u]x
  const float sk[2][3] = {{vp[0], vp[1], vp[2]}, {vv[0], vv[1], vv[2]}};
  for (int h = 0; h < 2; ++h) {
    const int r0 = h == 0 ? 0 : 6;
    const float* v = sk[h];
    set(r0, 3, 0, 1, -v[2]); set(r0, 3, 0, 2, v[1]);
    set(r0, 3, 1, 0, v[2]);  set(r0, 3, 1, 2, -v[0]);
    set(r0, 3, 2, 0, -v[1]); set(r0, 3, 2, 1, v[0]);
  }
  for (int i = 0; i < 3; ++i) {
    set(9, 9, i, i, -1.f);  set(9, 24, i, i, 1.f);
    set(12, 12, i, i, -1.f); set(12, 27, i, i, 1.f);
  }
}

__device__ __forceinline__ int imu_local(int c, int k) {
  // column c of the 190 layout in factor k's 30 columns, or -1
  if (c < OFF_SB) {
    const int p = c / 6, o = c - 6 * p;
    return p == k ? o : (p == k + 1 ? 15 + o : -1);
  }
  if (c < OFF_EX) {
    const int q = (c - OFF_SB) / 9, o = c - OFF_SB - 9 * q;
    return q == k ? 6 + o : (q == k + 1 ? 21 + o : -1);
  }
  return -1;
}

__device__ __forceinline__ int proj_col(int c) {
  // column c of the 190 layout in the 91 projection columns, or -1
  if (c < OFF_SB) return c;
  return c < OFF_EX ? -1 : c - OFF_EX + OFF_SB;
}

// ----------------------------------------------------------- launch 1
__device__ void lane_block(const Args& a, int b, float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Lt = a.l_img + a.l_evt;
  const int l = blockIdx.x * LANES + warp;
  float* P = smem;                                     // the group's H
  float* rows = smem + SM_PART + warp * SM_LANE;
  float* hub = rows + SM_ROWS;
  float* diag = hub + SM_HUB;
  float* hpl = diag + SM_DIAG;
  float* lb = hpl + NC;
  int* meta = reinterpret_cast<int*>(smem + SM_PART + LANES * SM_LANE);   // s (-1: out)
  float* lcost = smem + SM_PART + LANES * SM_LANE + LANES;

  for (int i = tid; i < NC * NC; i += THREADS) P[i] = 0.f;
  int s = -1, exl = 0, exr = 2;
  float hll = 0.f, blv = 0.f, cst = 0.f;
  if (l < Lt) {
    const Book k = book_of(a, b, l);
    exl = k.exl;
    exr = k.exr;
    const bool o = lane < NS && k.obs[k.lane * NS + lane];
    const unsigned m = __ballot_sync(FULL, o);
    const int s0 = m ? __ffs(m) - 1 : 0;
    const bool gate = k.active[k.lane] && __popc(m) >= 2 && s0 < NS - 3 && k.depth_valid[k.lane];
    if (gate) {
      s = s0;
      const float inv = k.inv_depth[k.lane];
      const float lam = fabsf(inv) > 1e-4f ? inv : 1.f;
      if (lane < ROWS) proj_row(a, b, k, s, lam, lane, rows + lane * 2 * RW);
      __syncwarp();
      if (lane < ROWS) {
        const float* rw = rows + lane * 2 * RW;
        for (int q = 0; q < 2; ++q) {
          const float jl = rw[q * RW + 24], rr = rw[q * RW + 26];
          hll += jl * jl;
          blv += jl * rr;
          cst += rr * rr;
        }
      }
      hll = warp_sum(hll);
      blv = warp_sum(blv);
      cst = warp_sum(cst);
    }
  }
  if (lane == 0) { meta[warp] = s; lcost[warp] = cst; }

  if (s >= 0) {
    // the lane's Hpl column (Σ J_c J_λ) and gradient (Σ J_c r), 91 columns
    for (int c = lane; c < NC; c += 32) {
      const int hc = hub_of(c, s, exl, exr);
      const int p = hc >= 0 ? -1 : (c < OFF_SB ? c / 6 : -2);
      const int sc = hc >= 0 ? hub_src(hc) : 6 + c % 6;
      hpl[c] = p == -2 ? 0.f : rows_dot(rows, sc, 24, p);
      lb[c] = p == -2 ? 0.f : rows_dot(rows, sc, 26, p);
    }
    // its share of H: hub x hub over every row, hub x the other frames'
    // poses over their mono and cross rows, and those frames' diagonal
    // blocks (no other entry of the share is non-zero)
    for (int e = lane; e < NHUB * NHUB; e += 32) {
      const int h = e / NHUB, h2 = e - h * NHUB;
      hub[h * NC + hub_col(h2, s, exl, exr)] = rows_dot(rows, hub_src(h), hub_src(h2), -1);
    }
    for (int e = lane; e < NHUB * 60; e += 32) {
      const int h = e / 60, c = pose_col(e - h * 60, s);
      hub[h * NC + c] = rows_dot(rows, hub_src(h), 6 + c % 6, c / 6);
    }
    for (int e = lane; e < SM_DIAG; e += 32) {
      const int p = e / 36, o1 = (e - 36 * p) / 6, o2 = e - 36 * p - 6 * o1;
      diag[e] = p == s ? 0.f : rows_dot(rows, 6 + o1, 6 + o2, p);
    }
    if (lane == 0) {
      out(a, A_HLL, b, Lt)[l] = hll;
      out(a, A_BL, b, Lt)[l] = blv;
    }
  } else if (l < Lt) {
    for (int c = lane; c < NC; c += 32) hpl[c] = 0.f;
    if (lane == 0) {
      out(a, A_HLL, b, Lt)[l] = 0.f;
      out(a, A_BL, b, Lt)[l] = 0.f;
    }
  }
  __syncthreads();

  // the group's Hpl columns, whole (zeros at the speed-bias rows)
  float* Hpl = out(a, A_HPL, b, static_cast<size_t>(DIM) * Lt);
  for (int i = tid; i < DIM * LANES; i += THREADS) {
    const int r = i / LANES, w = i - r * LANES;
    const int lw = blockIdx.x * LANES + w;
    if (lw >= Lt) continue;
    const int c = proj_col(r);
    Hpl[static_cast<size_t>(r) * Lt + lw] =
        c < 0 ? 0.f : smem[SM_PART + w * SM_LANE + SM_ROWS + SM_HUB + SM_DIAG + c];
  }

  // the group's H, lane by lane in order: each lane's hub rows, their
  // transposes outside the hub and its diagonal blocks, which no two
  // threads of one pass share; H stays symmetric bit for bit
  constexpr int N1 = NHUB * (NHUB + 60), N2 = NHUB * 60, N3 = 60 * 6;
  for (int w = 0; w < LANES; ++w) {
    const int sw = meta[w];
    if (sw >= 0) {
      const int ew = blockIdx.x * LANES + w < a.l_img ? 0 : 1;
      const float* hw = smem + SM_PART + w * SM_LANE + SM_ROWS;
      const float* dw = hw + SM_HUB;
      for (int i = tid; i < N1 + N2 + N3; i += THREADS) {
        if (i < N1) {
          const int h = i / (NHUB + 60), k = i - h * (NHUB + 60);
          const int c = k < NHUB ? hub_col(k, sw, ew, ew + 2) : pose_col(k - NHUB, sw);
          P[hub_col(h, sw, ew, ew + 2) * NC + c] += hw[h * NC + c];
        } else if (i < N1 + N2) {
          const int h = (i - N1) / 60, c = pose_col(i - N1 - h * 60, sw);
          P[c * NC + hub_col(h, sw, ew, ew + 2)] += hw[h * NC + c];
        } else {
          const int q = i - N1 - N2, k = q / 6, c = pose_col(k, sw);
          const int p = c / 6, o1 = c % 6, o2 = q - 6 * k;
          P[c * NC + 6 * p + o2] += dw[36 * p + 6 * o1 + o2];
        }
      }
    }
    __syncthreads();
  }

  // the group's partial: H, gradient, cost
  float* part = out(a, A_SCRATCH, b, scratch_per(a)) + static_cast<size_t>(blockIdx.x) * PART;
  for (int i = tid; i < NC * NC; i += THREADS) part[i] = P[i];
  for (int c = tid; c < NC; c += THREADS) {
    float v = 0.f;
    for (int w = 0; w < LANES; ++w)
      if (meta[w] >= 0) v += smem[SM_PART + w * SM_LANE + SM_ROWS + SM_HUB + SM_DIAG + NC + c];
    part[NC * NC + c] = v;
  }
  if (tid == 0) {
    float v = 0.f;
    for (int w = 0; w < LANES; ++w) v += lcost[w];
    part[NC * NC + NC] = v;
  }
}

__device__ void imu_block(const Args& a, int b, int k, float* smem) {
  const int tid = threadIdx.x;
  float* part = out(a, A_SCRATCH, b, scratch_per(a)) + static_cast<size_t>(a.n_groups) * PART + k * IMU_PART;
  const bool valid = in<unsigned char>(a, A_IMU_VALID, b, N_IMU)[k] != 0;
  if (!valid) {
    for (int i = tid; i < IMU_PART; i += THREADS) part[i] = 0.f;
    return;
  }
  float* r = smem;                 // 15
  float* J = r + 16;               // 15 x 30
  float* rw = J + 15 * IMU_W;      // 15
  float* Jw = rw + 16;             // 15 x 30
  for (int i = tid; i < 15 * IMU_W; i += THREADS) J[i] = 0.f;
  __syncthreads();
  if (tid == 0) imu_factor(a, b, k, r, J);
  __syncthreads();
  const float* S = in<float>(a, A_IMU_SQRT, b, N_IMU * 225) + 225 * k;
  for (int i = tid; i < 15 * IMU_W + 15; i += THREADS) {
    if (i < 15 * IMU_W) {
      const int ri = i / IMU_W, c = i - ri * IMU_W;
      float v = 0.f;
      for (int m = 0; m < 15; ++m) v += S[ri * 15 + m] * J[m * IMU_W + c];
      Jw[i] = v;
    } else {
      const int ri = i - 15 * IMU_W;
      float v = 0.f;
      for (int m = 0; m < 15; ++m) v += S[ri * 15 + m] * r[m];
      rw[ri] = v;
    }
  }
  __syncthreads();
  for (int i = tid; i < IMU_W * IMU_W + IMU_W; i += THREADS) {
    float v = 0.f;
    if (i < IMU_W * IMU_W) {
      const int p = i / IMU_W, q = i - p * IMU_W;
      for (int m = 0; m < 15; ++m) v += Jw[m * IMU_W + p] * Jw[m * IMU_W + q];
    } else {
      const int p = i - IMU_W * IMU_W;
      for (int m = 0; m < 15; ++m) v += Jw[m * IMU_W + p] * rw[m];
    }
    part[i] = v;
  }
  if (tid == 0) {
    float v = 0.f;
    for (int m = 0; m < 15; ++m) v += rw[m] * rw[m];
    part[IMU_W * IMU_W + IMU_W] = v;
  }
}

// r_prior = (r0 + J0 (x ⊟ lin)) · valid into scratch (its last DIM floats)
__device__ void prior_block(const Args& a, int b, float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* dx = smem;
  if (tid < NS + 4 + 1) {
    if (tid < NS) {              // pose and speed-bias of frame tid
      const int f = tid;
      const float* P = in<float>(a, A_P, b, NS * 3) + 3 * f;
      const float* lP = in<float>(a, A_LIN_P, b, NS * 3) + 3 * f;
      const float* Q = in<float>(a, A_Q, b, NS * 4) + 4 * f;
      const float* lQ = in<float>(a, A_LIN_Q, b, NS * 4) + 4 * f;
      const float lc[4] = {lQ[0], -lQ[1], -lQ[2], -lQ[3]};
      float dq[4];
      quat_mul(lc, Q, dq);
      const float sg = dq[0] >= 0.f ? 2.f : -2.f;
      for (int c = 0; c < 3; ++c) {
        dx[6 * f + c] = P[c] - lP[c];
        dx[6 * f + 3 + c] = sg * dq[1 + c];
      }
      const int fields[3][2] = {{A_V, A_LIN_V}, {A_BA, A_LIN_BA}, {A_BG, A_LIN_BG}};
      for (int h = 0; h < 3; ++h) {
        const float* x = in<float>(a, fields[h][0], b, NS * 3) + 3 * f;
        const float* x0 = in<float>(a, fields[h][1], b, NS * 3) + 3 * f;
        for (int c = 0; c < 3; ++c) dx[OFF_SB + 9 * f + 3 * h + c] = x[c] - x0[c];
      }
    } else if (tid < NS + 4) {   // extrinsic slot
      const int e = tid - NS;
      const float* p = in<float>(a, A_EX_P, b, 12) + 3 * e;
      const float* lp = in<float>(a, A_LIN_EX_P, b, 12) + 3 * e;
      const float* q = in<float>(a, A_EX_Q, b, 16) + 4 * e;
      const float* lq = in<float>(a, A_LIN_EX_Q, b, 16) + 4 * e;
      const float lc[4] = {lq[0], -lq[1], -lq[2], -lq[3]};
      float dq[4];
      quat_mul(lc, q, dq);
      const float sg = dq[0] >= 0.f ? 2.f : -2.f;
      for (int c = 0; c < 3; ++c) {
        dx[OFF_EX + 6 * e + c] = p[c] - lp[c];
        dx[OFF_EX + 6 * e + 3 + c] = sg * dq[1 + c];
      }
    } else {
      dx[DIM - 1] = *in<float>(a, A_TD, b, 1) - *in<float>(a, A_LIN_TD, b, 1);
    }
  }
  __syncthreads();
  const bool valid = *in<unsigned char>(a, A_PRIOR_VALID, b, 1) != 0;
  const float* J0 = in<float>(a, A_J0, b, DIM * DIM);
  const float* r0 = in<float>(a, A_R0, b, DIM);
  float* rp = out(a, A_SCRATCH, b, scratch_per(a)) + static_cast<size_t>(a.n_groups) * PART + N_IMU * IMU_PART;
  for (int k = warp; k < DIM; k += LANES) {
    float v = 0.f;
    if (valid)
      for (int m = lane; m < DIM; m += 32) v += J0[k * DIM + m] * dx[m];
    v = warp_sum(v);
    if (lane == 0) rp[k] = valid ? r0[k] + v : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) normal_rows_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int x = blockIdx.x;
  if (x < a.n_groups) lane_block(a, b, smem);
  else if (x < a.n_groups + N_IMU) imu_block(a, b, x - a.n_groups, smem);
  else prior_block(a, b, smem);
}

// ----------------------------------------------------------- launch 2
constexpr int RED_THREADS = 256;
constexpr int RED_BLOCKS = (DIM * DIM + RED_THREADS - 1) / RED_THREADS;

__global__ void __launch_bounds__(RED_THREADS) normal_reduce_kernel(const Args a) {
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* scr = out(a, A_SCRATCH, b, scratch_per(a));
  const float* imu = scr + static_cast<size_t>(a.n_groups) * PART;
  const float* rp = imu + N_IMU * IMU_PART;
  if (blockIdx.x < RED_BLOCKS) {
    const int i = blockIdx.x * RED_THREADS + tid;
    if (i >= DIM * DIM) return;
    const int ra = i / DIM, cb = i - ra * DIM;
    float v = in<float>(a, A_PRIOR_H, b, DIM * DIM)[i];
    const int ka = ra < OFF_SB ? ra / 6 : (ra < OFF_EX ? (ra - OFF_SB) / 9 : -9);
    for (int k = ka - 1; k <= ka; ++k) {
      if (k < 0 || k >= N_IMU) continue;
      const int la = imu_local(ra, k), lc = imu_local(cb, k);
      if (la >= 0 && lc >= 0) v += imu[k * IMU_PART + la * IMU_W + lc];
    }
    const int pa = proj_col(ra), pc = proj_col(cb);
    if (pa >= 0 && pc >= 0)
      for (int gi = 0; gi < a.n_groups; ++gi) v += scr[static_cast<size_t>(gi) * PART + pa * NC + pc];
    out(a, A_HPP, b, DIM * DIM)[i] = v;
    return;
  }
  // bp: the prior's gradient, the IMU factors', the groups'
  const bool valid = *in<unsigned char>(a, A_PRIOR_VALID, b, 1) != 0;
  const float* J0 = in<float>(a, A_J0, b, DIM * DIM);
  if (tid < DIM) {
    const int ra = tid;
    float v = 0.f;
    if (valid)
      for (int k = 0; k < DIM; ++k) v += J0[k * DIM + ra] * rp[k];
    const int ka = ra < OFF_SB ? ra / 6 : (ra < OFF_EX ? (ra - OFF_SB) / 9 : -9);
    for (int k = ka - 1; k <= ka; ++k) {
      if (k < 0 || k >= N_IMU) continue;
      const int la = imu_local(ra, k);
      if (la >= 0) v += imu[k * IMU_PART + IMU_W * IMU_W + la];
    }
    const int pa = proj_col(ra);
    if (pa >= 0)
      for (int gi = 0; gi < a.n_groups; ++gi) v += scr[static_cast<size_t>(gi) * PART + NC * NC + pa];
    out(a, A_BP, b, DIM)[ra] = v;
  }
  if (tid < 32) {
    float v = 0.f;
    for (int k = tid; k < N_IMU; k += 32) v += imu[k * IMU_PART + IMU_W * IMU_W + IMU_W];
    for (int gi = tid; gi < a.n_groups; gi += 32) v += scr[static_cast<size_t>(gi) * PART + NC * NC + NC];
    for (int k = tid; k < DIM; k += 32) v += rp[k] * rp[k];
    v = warp_sum(v);
    if (tid == 0) out(a, A_COST, b, 1)[0] = v;
  }
}

}  // namespace

// args: host array of N_ARGS device pointers in the order of `enum Arg`
// (read before the call returns); cauchy_c: host pointer to the Cauchy
// loss scale; batch: windows B; l_img / l_evt: lanes of the two books.
// Launches the two kernels on `stream`; returns the first error of the
// one-time shared-memory attribute call or of either launch.
extern "C" int esv_normal_assembly(const unsigned long long* args, const float* cauchy_c,
                                   int batch, int l_img, int l_evt, void* stream) {
  if (batch <= 0 || batch > 65535 || l_img < 0 || l_evt < 0) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      normal_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Args a;
  for (int i = 0; i < N_ARGS; ++i) a.p[i] = reinterpret_cast<const void*>(args[i]);
  a.l_img = l_img;
  a.l_evt = l_evt;
  a.n_groups = (l_img + l_evt + LANES - 1) / LANES;
  a.cauchy_c = *cauchy_c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  normal_rows_kernel<<<dim3(a.n_groups + N_IMU + 1, batch), THREADS, SMEM_BYTES, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  normal_reduce_kernel<<<dim3(RED_BLOCKS + 1, batch), RED_THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
