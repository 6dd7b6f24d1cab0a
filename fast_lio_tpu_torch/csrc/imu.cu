// The IMU stage of a scan in two kernels: the forward propagation over the
// padded IMU block (imu_propagate_kernel, one block a lane) and the
// per-point motion compensation (imu_deskew_kernel, a grid over the points).
// Built by fast_lio_tpu_torch/kernels/build.py with nvcc (this library with
// --fmad=false, so that every product and sum outside the matrix products
// rounds as PyTorch's separate elementwise ops do) into a shared library
// with a plain C interface, called through ctypes by
// fast_lio_tpu_torch/kernels/imu.py.
//
// Replaces no pallas_call: the JAX package writes the stage in XLA
// (fast_lio_tpu/imu.py, propagate_and_deskew), and the port's plain
// version (fast_lio_tpu_torch/imu.py, propagate_and_deskew_plain) runs it
// as about 1,700 small kernels, each a CUDA-graph node that costs more
// than its work.  The work is small: the quaternion chain of M - 1 pairs,
// a 23x23 Jacobian and noise term per pair, their composition into one
// (F, G), two covariance products and a pass over the N points.  So each
// kernel is bound by its latency, not by bytes or operations: the design
// keeps everything of a lane in one block's shared memory and uses the
// structure of the process model to do about a quarter of the dense work.
//
// Numerics, as the plain version computes them (true f32 or f64):
//  - The pair set-up, so3_exp, the quaternion products and rotations, the
//    3x3 Jacobians and the deskew are the plain version's elementwise
//    formulas, term for term and in its order.
//  - The quaternion chain is an inclusive scan in control_flow.
//    associative_scan's association order (JAX's): pairs [0:-1:2] and
//    [1::2] combined, the half scanned, the evens combined, interleaved.
//  - vel and pos are sequential prefix sums (torch.cumsum along dim 0).
//  - Of the (F, G) scan only the last element is made, in the association
//    order that element has there (control_flow.associative_last):
//    adjacent pairs combined level by level, each level's odd tail
//    combined last, the deepest first.  It is evaluated as a binary
//    counter over the pairs: push a pair, combine the top two while they
//    sit at one level, then fold the leftovers from the highest level
//    down.  An invalid pair is an exact identity (F = I, G = 0), and a
//    combine with an identity returns the other operand, which is what
//    the dense product gives bit for bit; so identities are skipped.
//  - Matrix products sum over k in increasing order with fused
//    multiply-adds (fma(), which --fmad=false leaves in place), as BLAS
//    does; terms that are exact zeros of the process model are skipped,
//    which leaves the sum's bits as the dense sum in the same order gives
//    them.  The products round otherwise than cuBLAS's, so the kernel is
//    held to the plain CUDA version by test_torch_imu.py's tolerances.
//  - No atomics: every result is written by one thread, the same bits on
//    every run.
//
// Structure used.  The error state (23) has two blocks the propagation
// never touches, offset_R_L_I and offset_T_L_I (6-11): a pair's F has
// identity rows and columns there and G zero rows and columns.  So F and
// G live on the 17 other indices (K: pos, rot, vel, bg, ba, grav); of F's
// 17 rows only 11 (pos, rot, vel, grav) differ from the identity, and a
// pair's Fw Q Fw^T needs Fw's four 3x3 blocks alone.  A combine
// (F_b F_a, F_b G_a F_b^T + G_b) costs 3 x 11 x 17 x 17 fmas, against
// 3 x 23^3 dense: 9.5k instead of 36.5k.
//
// Padding contract (imu.py): slot 0 is the previous frame's tail sample;
// a pair is valid where its tail slot is real and not before the previous
// scan's end; padded slots may hold any finite values.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MAX_M = 256;      // IMU slots a lane (kernels/imu.py MAX_M)
constexpr int THREADS = 512;    // the propagation block
constexpr int DESKEW_THREADS = 256;
constexpr int DEPTH = 9;        // the counter's stack: <= 8 for 255 pairs
constexpr int KD = 17;          // the indices F and G live on
constexpr int MAT = KD * KD;
constexpr int SLOT = 2 * MAT;   // one (F, G) on K
constexpr int TMP = 2 * MAT;    // a combine's Fn and X
constexpr int D = 23;           // error-state dimension
constexpr int NQ = 12;          // process-noise dimension
constexpr int PRM = 55;         // a step's parameters (PRM_* below)
constexpr int KNOT = 17;        // a knot: t, rot (4), pos, vel, gyr, acc
constexpr int IN = 21;          // inputs (enum below; the feed's float)
constexpr int OUT = 11;         // the propagation's outputs

// a step's parameters: E = exp(-w dt) as a matrix and C = (-R hat(a)) dt
// (row-major 3x3 each); Fw's rows on rot, vel, bg, ba over the noise
// block each row reads (12 x 3): B1 = -A(-w dt) dt, B2 = -R dt, I dt,
// I dt; dt
constexpr int PRM_E = 0, PRM_C = 9, PRM_FW = 18, PRM_DT = 54;

struct Arr {
  const void* p;
  long long lane;  // elements between lanes (0: one array for all)
  long long row;   // elements between rows of a matrix
};

enum {
  POS, ROT, OFFR, OFFT, VEL, BG, BA, GRAV, PM, QM, CANG, CACC,  // T
  IMU_T, ACC, GYR, SCALE, LAST_END, PCL_END, PTS, PT_TIME,      // float
  MASK                                                           // bool
};

struct PropArgs {
  Arr in[IN];
  void* out[OUT];  // pos .. grav, P, angvel_last, acc_s_last; contiguous
  void* knots;     // (lanes, KNOT * M), contiguous
  int M;
  int lanes;
};

struct DeskewArgs {
  const void* knots;
  const void* x_end[4];  // pos, rot, offset_R_L_I, offset_T_L_I outputs
  Arr pts;
  Arr pt_time;
  void* out;  // (lanes, N, 3), contiguous
  int M;
  int N;
  int lanes;
};

// offsets in the state vector xs
constexpr int XP = 0, XR = 3, XOR = 7, XOT = 11, XV = 14, XBG = 17, XBA = 20,
              XG = 23, XN = 26;
// the fields' sizes, in the order of the enum and of xs
__constant__ int kFieldSize[8] = {3, 4, 4, 3, 3, 3, 3, 3};
__constant__ int kFieldOff[8] = {XP, XR, XOR, XOT, XV, XBG, XBA, XG};
// K index -> full index; rows of F that differ from the identity
__constant__ int kFull[KD] = {0, 1, 2, 3, 4, 5, 12, 13, 14, 15, 16, 17,
                              18, 19, 20, 21, 22};
__constant__ int kOfFull[D] = {0, 1, 2, 3, 4, 5, -1, -1, -1, -1, -1, -1,
                               6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// the offset of level l of the chain's scan: sum of Mp >> i for i < l
__device__ __forceinline__ int level_off(int Mp, int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += Mp >> i;
  return off;
}

__device__ __forceinline__ bool live_row(int k) { return k <= 8 || k >= 15; }
__device__ __forceinline__ int live_row_at(int u) { return u < 9 ? u : u + 6; }

template <typename T>
__device__ __forceinline__ T small_angle() { return T(1e-8); }

// ---- the plain version's elementwise formulas (math/so3.py, math/s2.py)

template <typename T>
__device__ void qmul(const T* a, const T* b, T* r) {
  const T w1 = a[0], x1 = a[1], y1 = a[2], z1 = a[3];
  const T w2 = b[0], x2 = b[1], y2 = b[2], z2 = b[3];
  r[0] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  r[1] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  r[2] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  r[3] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
}

template <typename T>
__device__ void cross(const T* a, const T* b, T* r) {
  const T r0 = a[1] * b[2] - a[2] * b[1];
  const T r1 = a[2] * b[0] - a[0] * b[2];
  const T r2 = a[0] * b[1] - a[1] * b[0];
  r[0] = r0;
  r[1] = r1;
  r[2] = r2;
}

// v + 2 (w (u x v) + u x (u x v)), u = q[1:4], w = q[0]
template <typename T>
__device__ void qrot(const T* q, const T* v, T* r) {
  T uv[3], uuv[3];
  cross(q + 1, v, uv);
  cross(q + 1, uv, uuv);
  for (int i = 0; i < 3; ++i) r[i] = v[i] + T(2) * (q[0] * uv[i] + uuv[i]);
}

// quat_rotate(conj(q), v)
template <typename T>
__device__ void qrot_conj(const T* q, const T* v, T* r) {
  const T c[4] = {q[0], -q[1], -q[2], -q[3]};
  qrot(c, v, r);
}

template <typename T>
__device__ __forceinline__ T sumsq(const T* v) {
  return v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
}

template <typename T>
__device__ void so3_exp(const T* v, T* q) {
  const T theta2 = sumsq(v);
  const T safe2 = theta2 < small_angle<T>() ? small_angle<T>() : theta2;
  const T t = sqrt(safe2);
  const bool small = theta2 < small_angle<T>();
  const T c = small ? T(1) - theta2 / T(8) : cos(T(0.5) * t);
  const T s = small ? T(0.5) - theta2 / T(48) : sin(T(0.5) * t) / t;
  q[0] = c;
  q[1] = s * v[0];
  q[2] = s * v[1];
  q[3] = s * v[2];
}

template <typename T>
__device__ void hat(const T* v, T* K) {
  K[0] = T(0); K[1] = -v[2]; K[2] = v[1];
  K[3] = v[2]; K[4] = T(0); K[5] = -v[0];
  K[6] = -v[1]; K[7] = v[0]; K[8] = T(0);
}

// C (n x m) = A (n x l) B (l x m), row-major, sums in k order by fma
template <int n, int l, int m, typename T>
__device__ __forceinline__ void matmul(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < m; ++j) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < l; ++k) acc = fma(A[i * l + k], B[k * m + j], acc);
      C[i * m + j] = acc;
    }
}

// eye + c1 hat(v) + c2 hat(v)^2 (so3_exp_matrix with c1 = sinc,
// c2 = cosc; A_matrix with its own)
template <typename T>
__device__ void rodrigues(const T* v, T c1, T c2, T* out) {
  T K[9], K2[9];
  hat(v, K);
  matmul<3, 3, 3>(K, K, K2);
  for (int i = 0; i < 9; ++i)
    out[i] = (T(i % 4 == 0 ? 1 : 0) + c1 * K[i]) + c2 * K2[i];
}

// so3_exp_matrix(v) and A_matrix(v), which share theta
template <typename T>
__device__ void exp_and_a(const T* v, T* E, T* A) {
  const T theta2 = sumsq(v);
  const T safe2 = theta2 < small_angle<T>() ? small_angle<T>() : theta2;
  const T t = sqrt(safe2);
  const bool small = theta2 < small_angle<T>();
  const T sin_t = sin(t), cos_t = cos(t);
  const T sinc = small ? T(1) - theta2 / T(6) : sin_t / t;
  const T cosc = small ? T(0.5) - theta2 / T(24) : (T(1) - cos_t) / safe2;
  rodrigues(v, sinc, cosc, E);
  const T a1 = cosc;  // A_matrix's c1 is so3_exp_matrix's cosc
  const T a2 = small ? T(1.0 / 6.0) - theta2 / T(120)
                     : (T(1) - sin_t / t) / safe2;
  rodrigues(v, a1, a2, A);
}

template <typename T>
__device__ void quat_to_matrix(const T* q, T* R) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  R[0] = T(1) - T(2) * (yy + zz);
  R[1] = T(2) * (xy - wz);
  R[2] = T(2) * (xz + wy);
  R[3] = T(2) * (xy + wz);
  R[4] = T(1) - T(2) * (xx + zz);
  R[5] = T(2) * (yz - wx);
  R[6] = T(2) * (xz - wy);
  R[7] = T(2) * (yz + wx);
  R[8] = T(1) - T(2) * (xx + yy);
}

// s2.mx(g, 0) = -(hat(g) Bx) (3x2) and s2.nx_yy(g) mx(g, 0) (2x2)
template <typename T>
__device__ void gravity_blocks(const T* g, T* Mx, T* NM) {
  const T L = T(9.809);
  const T v0 = g[0], v1 = g[1], v2 = g[2];
  const T denom_raw = L + v0;
  const bool ok = denom_raw > T(1e-11);
  const T denom = ok ? denom_raw : T(1);
  T Bx[6];
  if (ok) {
    Bx[0] = -v1 / L;
    Bx[1] = -v2 / L;
    Bx[2] = (L - v1 * v1 / denom) / L;
    Bx[3] = -v2 * v1 / denom / L;
    Bx[4] = -v2 * v1 / denom / L;
    Bx[5] = (L - v2 * v2 / denom) / L;
  } else {
    Bx[0] = T(0); Bx[1] = T(0); Bx[2] = T(0);
    Bx[3] = T(-1); Bx[4] = T(1); Bx[5] = T(0);
  }
  T H[9], HB[6], BxT[6], N[6];
  hat(g, H);
  matmul<3, 3, 2>(H, Bx, HB);
  for (int i = 0; i < 6; ++i) Mx[i] = -HB[i];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 2; ++j) BxT[j * 3 + i] = Bx[i * 2 + j];
  matmul<2, 3, 3>(BxT, H, N);
  const T LL = T(9.809 * 9.809);
  for (int i = 0; i < 6; ++i) N[i] = N[i] / LL;
  matmul<2, 3, 2>(N, Mx, NM);
}

// a predict step's parameters (ekf.predict_matrices) at rotation q with
// omega = gyro - bg, a = acc - ba, over dt
template <typename T>
__device__ void step_params(const T* q, const T* omega, const T* a, T dt,
                            T* prm) {
  const T v[3] = {-omega[0] * dt, -omega[1] * dt, -omega[2] * dt};
  T A[9], R[9], H[9], RH[9], Rn[9];
  exp_and_a(v, prm + PRM_E, A);
  quat_to_matrix(q, R);
  hat(a, H);
  for (int i = 0; i < 9; ++i) Rn[i] = -R[i];
  matmul<3, 3, 3>(Rn, H, RH);
  for (int i = 0; i < 9; ++i) {
    const int r = i / 3, c = i % 3;
    prm[PRM_C + i] = RH[i] * dt;
    prm[PRM_FW + i] = -A[i] * dt;
    prm[PRM_FW + 9 + i] = Rn[i] * dt;
    prm[PRM_FW + 18 + i] = T(r == c ? 1 : 0) * dt;
    prm[PRM_FW + 27 + i] = T(r == c ? 1 : 0) * dt;
  }
  prm[PRM_DT] = dt;
}

// F of a step on K, entry (i, j); prm == nullptr: the identity
template <typename T>
__device__ T f_entry(int i, int j, const T* prm, const T* Mx, const T* NM) {
  const T one = i == j ? T(1) : T(0);
  if (prm == nullptr) return one;
  if (i < 3) return j == i + 6 ? prm[PRM_DT] : one;  // pos: d/d vel
  if (i < 6) {  // rot
    if (j >= 3 && j < 6) return prm[PRM_E + (i - 3) * 3 + j - 3];
    if (j >= 9 && j < 12) return prm[PRM_FW + (i - 3) * 3 + j - 9];
    return T(0);
  }
  if (i < 9) {  // vel
    if (j >= 3 && j < 6) return prm[PRM_C + (i - 6) * 3 + j - 3];
    if (j >= 12 && j < 15) return prm[PRM_FW + (i - 3) * 3 + j - 12];
    if (j >= 15) return Mx[(i - 6) * 2 + j - 15] * prm[PRM_DT];
    return one;
  }
  if (i < 15) return one;  // bg, ba
  return j >= 15 ? NM[(i - 15) * 2 + j - 15] : T(0);  // grav
}

// G = (Fw Q) Fw^T of a step on K, entry (i, j): Fw's row w reads the
// noise block w / 3 alone
template <typename T>
__device__ T g_entry(int i, int j, const T* prm, const T* Q) {
  if (prm == nullptr || i < 3 || i > 14 || j < 3 || j > 14) return T(0);
  const int w = i - 3, v = j - 3, bw = w / 3, bv = v / 3;
  const T* fw = prm + PRM_FW;
  T acc = T(0);
  for (int c2 = 0; c2 < 3; ++c2) {
    T y = T(0);
    for (int c = 0; c < 3; ++c)
      y = fma(fw[w * 3 + c], Q[(3 * bw + c) * NQ + 3 * bv + c2], y);
    acc = fma(y, fw[v * 3 + c2], acc);
  }
  return acc;
}

// a step's (F, G) on K into slot S (row-major, KD x KD each);
// prm == nullptr: the identity
template <typename T>
__device__ void build_slot(T* S, const T* prm, const T* Mx, const T* NM,
                           const T* Q) {
  for (int t = threadIdx.x; t < SLOT; t += THREADS) {
    const int u = t % MAT, i = u / KD, j = u % KD;
    S[t] = t < MAT ? f_entry(i, j, prm, Mx, NM) : g_entry(i, j, prm, Q);
  }
  __syncthreads();
}

// sum over k < KD, in k order by fma, of a[k] * b[k * sb]
template <typename T>
__device__ __forceinline__ T dot(const T* a, const T* b, int sb) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < KD; ++k) acc = fma(a[k], b[k * sb], acc);
  return acc;
}

// slot a <- compose(a, b), a before b: (F_b F_a, F_b G_a F_b^T + G_b).
// Stage 1: F_b F_a's live rows into Fn and X = F_b G_a (a non-live row of
// F_b is e_i: X's row i is G_a's).  Stage 2: G_a <- X F_b^T + G_b (a
// non-live column of F_b^T picks X's column); F_a's live rows <- Fn.
// tmp holds TMP.
template <typename T>
__device__ void combine(T* a, const T* b, T* tmp) {
  T* Fa = a;
  T* Ga = a + MAT;
  const T* Fb = b;
  const T* Gb = b + MAT;
  T* Fn = tmp;
  T* X = tmp + MAT;
  constexpr int LIVE = 11 * KD;
  for (int t = threadIdx.x; t < 2 * LIVE + 6 * KD; t += THREADS) {
    if (t < 2 * LIVE) {
      const bool x = t >= LIVE;
      const int u = x ? t - LIVE : t;
      const int r = live_row_at(u / KD), c = u % KD;
      const T v = dot(Fb + r * KD, (x ? Ga : Fa) + c, KD);
      (x ? X : Fn)[r * KD + c] = v;
    } else {
      const int u = t - 2 * LIVE, i = 9 + u / KD, c = u % KD;
      X[i * KD + c] = Ga[i * KD + c];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < MAT + LIVE; t += THREADS) {
    if (t < MAT) {
      const int i = t / KD, c = t % KD;
      const T v = live_row(c) ? dot(Fb + c * KD, X + i * KD, 1)
                              : X[i * KD + c];
      Ga[i * KD + c] = v + Gb[i * KD + c];
    } else {
      const int u = t - MAT, r = live_row_at(u / KD), c = u % KD;
      Fa[r * KD + c] = Fn[r * KD + c];
    }
  }
  __syncthreads();
}

// Pout = sym((F P) F^T + G) on the full 23x23 (P and the scratch Y, Z
// row-major; Pout at row stride ps, may be P), F and G on K (slot S)
template <typename T>
__device__ void cov_step(const T* S, const T* P, T* Y, T* Z, T* Pout,
                         long long ps) {
  const T* F = S;
  const T* G = S + MAT;
  for (int t = threadIdx.x; t < D * D; t += THREADS) {
    const int i = t / D, j = t % D, ki = kOfFull[i];
    T acc;
    if (ki < 0 || !live_row(ki)) {
      acc = P[i * D + j];
    } else {
      acc = T(0);
#pragma unroll
      for (int k = 0; k < KD; ++k)
        acc = fma(F[ki * KD + k], P[kFull[k] * D + j], acc);
    }
    Y[i * D + j] = acc;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < D * D; t += THREADS) {
    const int i = t / D, j = t % D, ki = kOfFull[i], kj = kOfFull[j];
    T acc;
    if (kj < 0 || !live_row(kj)) {
      acc = Y[i * D + j];
    } else {
      acc = T(0);
#pragma unroll
      for (int k = 0; k < KD; ++k)
        acc = fma(F[kj * KD + k], Y[i * D + kFull[k]], acc);
    }
    Z[i * D + j] = acc + (ki >= 0 && kj >= 0 ? G[ki * KD + kj] : T(0));
  }
  __syncthreads();
  for (int t = threadIdx.x; t < D * D; t += THREADS) {
    const int i = t / D, j = t % D;
    Pout[i * ps + j] = T(0.5) * (Z[i * D + j] + Z[j * D + i]);
  }
  __syncthreads();
}

// the state, 16 scalars, Q, Mx, NM and the final step's parameters
constexpr size_t PROP_FIXED = XN + 16 + NQ * NQ + 6 + 4 + PRM;

// shared memory of the propagation block, in T: the fixed part, the
// pairs' arrays, the scratch (the chain's levels, then the stack of
// slots), then two int arrays
__host__ __device__ inline size_t prop_pairs(int Mp) {
  return PROP_FIXED + (17 + PRM) * (size_t)Mp;
}

__host__ __device__ inline size_t prop_scratch(int Mp) {
  const size_t scan = 16 * (size_t)Mp;
  const size_t stack = (size_t)DEPTH * SLOT + TMP;
  return scan > stack ? scan : stack;
}

template <typename T>
__host__ __device__ size_t prop_smem_bytes(int M) {
  const int Mp = M - 1;
  return (prop_pairs(Mp) + prop_scratch(Mp)) * sizeof(T) +
         2 * sizeof(int) * (size_t)Mp;
}

// an element of a feed array (float)
template <typename T>
__device__ __forceinline__ T in_at(const Arr& a, int lane, long long i) {
  return T(static_cast<const float*>(a.p)[lane * a.lane + i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
imu_propagate_kernel(const PropArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = blockIdx.y, tid = threadIdx.x;
  const int M = a.M, Mp = M - 1;
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* misc = xs + XN;  // scale, last_end, pcl_end, dt_final, cang, cacc,
                      // the final step's omega and acc
  T* Qs = misc + 16;
  T* Mx = Qs + NQ * NQ;
  T* NM = Mx + 6;
  T* prmF = NM + 4;
  T* dts = prmF + PRM;
  T* omg = dts + Mp;
  T* abd = omg + 3 * Mp;
  T* qa = abd + 3 * Mp;
  T* velA = qa + 4 * Mp;
  T* posA = velA + 3 * Mp;
  T* prm = posA + 3 * Mp;
  T* U = xs + prop_pairs(Mp);
  int* valid = reinterpret_cast<int*>(U + prop_scratch(Mp));
  int* lastv = valid + Mp;
  const uint8_t* mask =
      static_cast<const uint8_t*>(a.in[MASK].p) + lane * a.in[MASK].lane;

  // ---- 0: the state, Q, the scalars and the carry
  for (int t = tid; t < XN + NQ * NQ + 3 + 6; t += THREADS) {
    if (t < XN) {
      int f = 0;
      while (f < 7 && t >= kFieldOff[f + 1]) ++f;
      const Arr& in = a.in[POS + f];
      xs[t] = static_cast<const T*>(in.p)[lane * in.lane + t - kFieldOff[f]];
    } else if (t < XN + NQ * NQ) {
      const int u = t - XN;
      const Arr& in = a.in[QM];
      Qs[u] = static_cast<const T*>(in.p)[lane * in.lane +
                                          (u / NQ) * in.row + u % NQ];
    } else if (t < XN + NQ * NQ + 3) {
      const int u = t - XN - NQ * NQ;
      misc[u] = in_at<T>(a.in[SCALE + u], lane, 0);
    } else {
      const int u = t - XN - NQ * NQ - 3;
      const Arr& in = a.in[u < 3 ? CANG : CACC];
      misc[4 + u] = static_cast<const T*>(in.p)[lane * in.lane + u % 3];
    }
  }
  __syncthreads();
  const T scale = misc[0], last_end = misc[1], pcl_end = misc[2];
  const T* cang = misc + 4;
  const T* cacc = misc + 7;
  const T* grav = xs + XG;

  // ---- 1: the pairs (imu.py: pair masks, dts, averages, omega, a_body)
  T* e = U;            // the chain's levels
  T* r = U + 8 * Mp;   // their scans
  for (int k = tid; k < Mp; k += THREADS) {
    const Arr &ti = a.in[IMU_T], &ac = a.in[ACC], &gy = a.in[GYR];
    const T head_t = in_at<T>(ti, lane, k);
    const T tail_t = in_at<T>(ti, lane, k + 1);
    const bool ok = mask[k + 1] && tail_t >= last_end;
    const T from = head_t < last_end ? last_end : head_t;
    T dt = tail_t - from;
    dt = ok ? (dt < T(0) ? T(0) : dt) : T(0);
    T v[3];
    for (int c = 0; c < 3; ++c) {
      const float* gp = static_cast<const float*>(gy.p) + lane * gy.lane;
      const float* ap = static_cast<const float*>(ac.p) + lane * ac.lane;
      const T gavg = T(0.5) * T(gp[k * gy.row + c] + gp[(k + 1) * gy.row + c]);
      const T aavg =
          T(0.5) * T(ap[k * ac.row + c] + ap[(k + 1) * ac.row + c]) * scale;
      omg[3 * k + c] = gavg - xs[XBG + c];
      abd[3 * k + c] = aavg - xs[XBA + c];
      v[c] = omg[3 * k + c] * dt;
    }
    so3_exp(v, e + 4 * k);
    dts[k] = dt;
    valid[k] = ok;
  }
  __syncthreads();

  // ---- 2: the quaternion chain, associative_scan's order.  Level l
  // holds Mp >> l elements from offset level_off(Mp, l).
  int L = 0;  // the top level, of one element
  for (int n = Mp, off = 0; n >= 2; off += n, n /= 2, ++L) {
    for (int j = tid; j < n / 2; j += THREADS)
      qmul(e + 4 * (off + 2 * j), e + 4 * (off + 2 * j + 1),
           e + 4 * (off + n + j));
    __syncthreads();
  }
  if (tid < 4) r[4 * level_off(Mp, L) + tid] = e[4 * level_off(Mp, L) + tid];
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    const int off = level_off(Mp, l), up = off + (Mp >> l);
    for (int i = tid; i < (Mp >> l); i += THREADS) {
      T* out = r + 4 * (off + i);
      if (i == 0) {
        for (int c = 0; c < 4; ++c) out[c] = e[4 * off + c];
      } else if (i & 1) {
        for (int c = 0; c < 4; ++c) out[c] = r[4 * (up + (i - 1) / 2) + c];
      } else {
        qmul(r + 4 * (up + (i - 2) / 2), e + 4 * (off + i), out);
      }
    }
    __syncthreads();
  }
  for (int k = tid; k < Mp; k += THREADS) qmul(xs + XR, r + 4 * k, qa + 4 * k);
  __syncthreads();

  // ---- 3: world-frame accelerations times dt; the last valid pair
  T* awi = U;
  for (int k = tid; k < Mp; k += THREADS) {
    T w[3];
    qrot(k == 0 ? xs + XR : qa + 4 * (k - 1), abd + 3 * k, w);
    for (int c = 0; c < 3; ++c) awi[3 * k + c] = (w[c] + grav[c]) * dts[k];
    int lv = k;
    while (lv >= 0 && !valid[lv]) --lv;
    lastv[k] = lv;
  }
  __syncthreads();

  // ---- 4: vel and pos (prefix sums, warp 0); each valid pair's
  // parameters (warps 1-8); Mx and NM; the final step's
  if (tid < 3) {  // 8 pairs' loads ahead of their sums
    const int c = tid;
    const T v0 = xs[XV + c], p0 = xs[XP + c];
    T csv = T(0), csp = T(0), vprev = v0;
    for (int k0 = 0; k0 < Mp; k0 += 8) {
      T aw[8], dd[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (k0 + q < Mp) {
          aw[q] = awi[3 * (k0 + q) + c];
          dd[q] = dts[k0 + q];
        }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (k0 + q < Mp) {
          csv = csv + aw[q];
          const T va = v0 + csv;
          csp = csp + vprev * dd[q];
          velA[3 * (k0 + q) + c] = va;
          posA[3 * (k0 + q) + c] = p0 + csp;
          vprev = va;
        }
    }
  } else if (tid >= 32 && tid < 32 + Mp) {
    const int k = tid - 32;
    if (valid[k])
      step_params(k == 0 ? xs + XR : qa + 4 * (k - 1), omg + 3 * k,
                  abd + 3 * k, dts[k], prm + PRM * k);
  } else if (tid == 320) {  // warps 10 and 11: beside the pairs' 1-8
    gravity_blocks(grav, Mx, NM);
  } else if (tid == 352) {
    const Arr& ti = a.in[IMU_T];
    T imu_end = -INFINITY;
    for (int i = 0; i < M; ++i)
      if (mask[i]) {
        const T t = in_at<T>(ti, lane, i);
        imu_end = t > imu_end ? t : imu_end;
      }
    const T dt = pcl_end - imu_end;
    // last_in: the last valid pair's averages, or zeros
    const int lv = lastv[Mp - 1];
    const Arr &ac = a.in[ACC], &gy = a.in[GYR];
    const float* gp = static_cast<const float*>(gy.p) + lane * gy.lane;
    const float* ap = static_cast<const float*>(ac.p) + lane * ac.lane;
    T omega[3], acc[3];
    for (int c = 0; c < 3; ++c) {
      const T gavg = lv < 0 ? T(0) : T(0.5) * T(gp[lv * gy.row + c] +
                                                 gp[(lv + 1) * gy.row + c]);
      const T aavg = lv < 0 ? T(0)
                            : T(0.5) * T(ap[lv * ac.row + c] +
                                         ap[(lv + 1) * ac.row + c]) * scale;
      omega[c] = gavg - xs[XBG + c];
      acc[c] = aavg - xs[XBA + c];
    }
    step_params(qa + 4 * (Mp - 1), omega, acc, dt, prmF);
    misc[3] = dt;
    misc[10] = omega[0]; misc[11] = omega[1]; misc[12] = omega[2];
    misc[13] = acc[0]; misc[14] = acc[1]; misc[15] = acc[2];
  }
  __syncthreads();

  // ---- 5: the knots for the deskew: t, rot, pos, vel, gyr, acc
  {
    T* kn = static_cast<T*>(a.knots) + (size_t)lane * KNOT * M;
    for (int m = tid; m < M; m += THREADS) {
      T t, q[4], p[3], v[3], g[3], w[3];
      if (m == 0) {
        t = T(0);
        for (int c = 0; c < 4; ++c) q[c] = xs[XR + c];
        for (int c = 0; c < 3; ++c) {
          p[c] = xs[XP + c];
          v[c] = xs[XV + c];
          g[c] = cang[c];
          w[c] = cacc[c];
        }
      } else {
        const int k = m - 1, lv = lastv[k];
        t = valid[k] ? in_at<T>(a.in[IMU_T], lane, m)
                     : (mask[m] ? T(0) : T(1e9));
        for (int c = 0; c < 4; ++c) q[c] = qa[4 * k + c];
        if (lv >= 0) qrot(qa + 4 * lv, abd + 3 * lv, w);
        for (int c = 0; c < 3; ++c) {
          p[c] = posA[3 * k + c];
          v[c] = velA[3 * k + c];
          g[c] = lv >= 0 ? omg[3 * lv + c] : cang[c];
          w[c] = lv >= 0 ? w[c] + grav[c] : cacc[c];
        }
      }
      kn[m] = t;
      for (int c = 0; c < 4; ++c) kn[M + 4 * m + c] = q[c];
      for (int c = 0; c < 3; ++c) {
        kn[5 * M + 3 * m + c] = p[c];
        kn[8 * M + 3 * m + c] = v[c];
        kn[11 * M + 3 * m + c] = g[c];
        kn[14 * M + 3 * m + c] = w[c];
      }
    }
  }

  // ---- 6: the (F, G) total, associative_last's order, as a binary
  // counter; identities skipped (uniform control flow: every thread makes
  // the same choices from shared memory)
  // After k pushes the stack holds an element for each set bit of k, the
  // highest level at the bottom; pushing pair k merges as often as k has
  // trailing ones.  Bit s of `ident` marks slot s an identity.
  T* tmp = U + DEPTH * SLOT;  // TMP
  unsigned ident = 0;
  int sp = 0;
  for (int k = 0; k < Mp; ++k) {
    if (valid[k]) {
      build_slot(U + sp * SLOT, prm + PRM * k, Mx, NM, Qs);
      ident &= ~(1u << sp);
    } else {
      ident |= 1u << sp;
    }
    ++sp;
    for (int m = __ffs(~k) - 1; m > 0; --m, --sp) {  // trailing ones of k
      T* A = U + (sp - 2) * SLOT;
      const T* B = U + (sp - 1) * SLOT;
      if (ident >> (sp - 1) & 1) continue;  // compose(a, I) = a
      if (ident >> (sp - 2) & 1) {          // compose(I, b) = b
        for (int t = tid; t < SLOT; t += THREADS) A[t] = B[t];
        __syncthreads();
        ident &= ~(1u << (sp - 2));
      } else {
        combine(A, B, tmp);
      }
    }
  }
  for (int s = 1; s < sp; ++s) {  // the fold, the highest level first
    if (ident >> s & 1) continue;
    if (ident & 1) {
      for (int t = tid; t < SLOT; t += THREADS) U[t] = U[s * SLOT + t];
      __syncthreads();
      ident &= ~1u;
    } else {
      combine(U, U + s * SLOT, tmp);
    }
  }
  if (ident & 1) build_slot<T>(U, nullptr, Mx, NM, Qs);

  // ---- 7: P_prop = sym(F P F^T + G); P_end = sym(F' P_prop F'^T + G')
  T* Pm = U + SLOT;  // the full matrices, row-major
  T* Y = U + 2 * SLOT;
  T* Z = U + 3 * SLOT;
  {
    const Arr& in = a.in[PM];
    const T* P = static_cast<const T*>(in.p) + lane * in.lane;
    for (int t = tid; t < D * D; t += THREADS)
      Pm[t] = P[(t / D) * in.row + t % D];
  }
  __syncthreads();
  cov_step(U, Pm, Y, Z, Pm, D);
  build_slot(U, prmF, Mx, NM, Qs);
  cov_step(U, Pm, Y, Z, static_cast<T*>(a.out[8]) + (size_t)lane * D * D,
           D);

  // ---- 8: x_end = oplus(x_prop, f, dt) and the carry (one thread)
  if (tid == 0) {
    const T dt = misc[3];
    const T* omega = misc + 10;
    const T* acc = misc + 13;
    const T* rot_p = qa + 4 * (Mp - 1);
    const T* vel_p = velA + 3 * (Mp - 1);
    const T* pos_p = posA + 3 * (Mp - 1);
    T out[XN], ai[3], v[3], q[4];
    qrot(rot_p, acc, ai);
    const T z = T(0) * dt;  // f's zero rows times dt
    for (int c = 0; c < 3; ++c) {
      out[XP + c] = pos_p[c] + vel_p[c] * dt;
      out[XOT + c] = xs[XOT + c] + z;
      out[XV + c] = vel_p[c] + (ai[c] + grav[c]) * dt;
      out[XBG + c] = xs[XBG + c] + z;
      out[XBA + c] = xs[XBA + c] + z;
      v[c] = omega[c] * dt;
    }
    so3_exp(v, q);
    qmul(rot_p, q, out + XR);
    const T zv[3] = {z, z, z};
    so3_exp(zv, q);
    qmul(xs + XOR, q, out + XOR);
    qrot(q, grav, out + XG);
    for (int f = 0; f < 8; ++f)
      for (int c = 0; c < kFieldSize[f]; ++c)
        static_cast<T*>(a.out[f])[(size_t)lane * kFieldSize[f] + c] =
            out[kFieldOff[f] + c];
    const int lv = lastv[Mp - 1];
    T w[3];
    if (lv >= 0) qrot(qa + 4 * lv, abd + 3 * lv, w);
    for (int c = 0; c < 3; ++c) {
      static_cast<T*>(a.out[9])[(size_t)lane * 3 + c] =
          lv >= 0 ? omg[3 * lv + c] : cang[c];
      static_cast<T*>(a.out[10])[(size_t)lane * 3 + c] =
          lv >= 0 ? w[c] + grav[c] : cacc[c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(DESKEW_THREADS)
imu_deskew_kernel(const DeskewArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kn = reinterpret_cast<T*>(smem_raw);
  const int lane = blockIdx.y, M = a.M;
  T* xe = kn + KNOT * M;  // pos, rot, offset_R_L_I, offset_T_L_I
  const T* src = static_cast<const T*>(a.knots) + (size_t)lane * KNOT * M;
  for (int t = threadIdx.x; t < KNOT * M + 14; t += DESKEW_THREADS) {
    if (t < KNOT * M) {
      kn[t] = src[t];
    } else {
      const int u = t - KNOT * M;
      const int f = u < 3 ? 0 : u < 7 ? 1 : u < 11 ? 2 : 3;
      const int off[4] = {0, 3, 7, 11}, size[4] = {3, 4, 4, 3};
      xe[u] = static_cast<const T*>(a.x_end[f])[(size_t)lane * size[f] + u -
                                                off[f]];
    }
  }
  __syncthreads();
  const int p = blockIdx.x * DESKEW_THREADS + threadIdx.x;
  if (p >= a.N) return;
  const T* kt = kn;
  const T* krot = kn + M;
  const T* kpos = kn + 5 * M;
  const T* kvel = kn + 8 * M;
  const T* kgyr = kn + 11 * M;
  const T* kacc = kn + 14 * M;
  const T t = in_at<T>(a.pt_time, lane, p);
  // torch.searchsorted(knot_t, t, right=False) - 1, clamped to [0, M - 2]
  int lo = 0, hi = M;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(kt[mid] >= t)) lo = mid + 1;
    else hi = mid;
  }
  const int head = min(max(lo - 1, 0), M - 2), tail = head + 1;
  const T dt = t - kt[head];
  T v[3], e[4], qi[4], Tei[3], pl[3], pw[3], pi[3], o[3];
  for (int c = 0; c < 3; ++c) v[c] = kgyr[3 * tail + c] * dt;
  so3_exp(v, e);
  qmul(krot + 4 * head, e, qi);
  for (int c = 0; c < 3; ++c)
    Tei[c] = kpos[3 * head + c] + kvel[3 * head + c] * dt +
             T(0.5) * kacc[3 * tail + c] * dt * dt - xe[c];
  const Arr& ps = a.pts;
  const float* pp =
      static_cast<const float*>(ps.p) + lane * ps.lane + p * ps.row;
  const T pt[3] = {T(pp[0]), T(pp[1]), T(pp[2])};
  qrot(xe + 7, pt, pl);
  for (int c = 0; c < 3; ++c) pl[c] = pl[c] + xe[11 + c];
  qrot(qi, pl, pw);
  for (int c = 0; c < 3; ++c) pw[c] = pw[c] + Tei[c];
  qrot_conj(xe + 3, pw, pi);
  for (int c = 0; c < 3; ++c) pi[c] = pi[c] - xe[11 + c];
  qrot_conj(xe + 7, pi, o);
  T* out = static_cast<T*>(a.out) + ((size_t)lane * a.N + p) * 3;
  for (int c = 0; c < 3; ++c) out[c] = o[c];
}

template <typename T>
int propagate(const PropArgs* a, void* stream) {
  if (a->M < 2 || a->M > MAX_M || a->lanes < 1 || a->lanes > 65535)
    return (int)cudaErrorInvalidValue;
  imu_propagate_kernel<T>
      <<<dim3(1, a->lanes), THREADS, prop_smem_bytes<T>(a->M),
         static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

template <typename T>
int deskew(const DeskewArgs* a, void* stream) {
  if (a->M < 2 || a->M > MAX_M || a->lanes < 1 || a->lanes > 65535 ||
      a->N < 0)
    return (int)cudaErrorInvalidValue;
  if (a->N == 0) return 0;
  const dim3 grid((a->N + DESKEW_THREADS - 1) / DESKEW_THREADS, a->lanes);
  imu_deskew_kernel<T>
      <<<grid, DESKEW_THREADS, (KNOT * (size_t)a->M + 14) * sizeof(T),
         static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

template <typename T>
int configure_one() {
  return (int)cudaFuncSetAttribute(imu_propagate_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)prop_smem_bytes<T>(MAX_M));
}

}  // namespace

extern "C" {

// Raises the propagation kernels' dynamic shared-memory limit to what
// MAX_M slots take; call once per device before the first launch.
int imu_configure() {
  const int err = configure_one<float>();
  return err ? err : configure_one<double>();
}

// The propagation of `lanes` lanes (grid.y) on `stream`, from a PropArgs
// (kernels/imu.py's _PropArgs); returns cudaGetLastError() (0 = ok).  The
// suffix names the computing type; the feed is float in both.
int imu_propagate_f32(const void* a, void* s) {
  return propagate<float>(static_cast<const PropArgs*>(a), s);
}
int imu_propagate_f64(const void* a, void* s) {
  return propagate<double>(static_cast<const PropArgs*>(a), s);
}

// The deskew of every lane's N points against the knots the propagation
// wrote, from a DeskewArgs (kernels/imu.py's _DeskewArgs).
int imu_deskew_f32(const void* a, void* s) {
  return deskew<float>(static_cast<const DeskewArgs*>(a), s);
}
int imu_deskew_f64(const void* a, void* s) {
  return deskew<double>(static_cast<const DeskewArgs*>(a), s);
}

const char* imu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
