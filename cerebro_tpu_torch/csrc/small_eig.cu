// Batched small-matrix solvers for geometric verification's PnP and
// Umeyama steps on the H100: three entries, each a plain C launch function
// bound with ctypes (cerebro_tpu_torch/ops/small_eig.py).
//
//   small_eig_sym12_launch   the eigenvector of the smallest eigenvalue of a
//                            symmetric 12x12 matrix (pnp_dlt's exact path):
//                            cyclic Jacobi, EIG_SWEEPS sweeps, one warp per
//                            matrix, the matrix and the rotations in shared
//                            memory;
//   small_eig_svd3_launch    U, S, Vt of a 3x3 matrix (pnp_dlt's exact path,
//                            umeyama_rigid): one-sided Jacobi on the columns,
//                            SVD_SWEEPS sweeps, one thread per matrix, all in
//                            registers. The singular values come out as
//                            column norms, so nothing squares the condition
//                            number (no eigendecomposition of H^T H);
//   small_eig_spd6_solve_launch  x = H^-1 g for a symmetric positive definite
//                            6x6 H (pnp_refine_gn's damped normal equations):
//                            Cholesky and two triangular solves, one thread
//                            per system.
//
// Replaces no Pallas kernel: in the JAX package these are jnp.linalg calls
// (XLA's custom calls). On the card, torch.linalg's eigh, svd and solve read
// their error code back to the host after every call, which stalls the host
// and forbids capturing a pair's verification as one CUDA graph; these
// entries compute the same functions and read nothing back. The work is a
// few thousand flops a matrix (at most 256 matrices a call): every entry is
// bound by its launch, not by bytes or operations, so each keeps its matrix
// on chip and takes one launch.
//
// Each launch function runs on the caller's stream, allocates nothing and
// returns cudaGetLastError(). A non-finite input gives a non-finite output
// (a NaN poisons the pose, and RANSAC's finite guards drop it); so does an H
// that is not positive definite in float32, where Cholesky takes the root of
// a negative pivot.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int EIG_N = 12;
constexpr int EIG_SWEEPS = 10;  // cyclic sweeps; a 12x12 reaches f32 rounding in 5-7
constexpr int EIG_WARPS = 4;    // matrices per block
constexpr int SVD_SWEEPS = 6;   // a 3x3's columns are orthogonal to f32 rounding after 3-4
constexpr int SPD_N = 6;
constexpr int THREADS = 128;

// The Jacobi rotation that zeroes a_pq of a symmetric matrix (Golub & Van
// Loan, sym.schur2): t = tan(theta), the smaller root of t^2 + 2 tau t - 1.
__device__ __forceinline__ void jacobi_rotation(float app, float aqq, float apq,
                                                float& c, float& s, float& t) {
  c = 1.f;
  s = 0.f;
  t = 0.f;
  if (apq != 0.f) {
    const float tau = (aqq - app) / (2.f * apq);
    // |tau| above ~1.8e19 overflows tau^2: then t = 0 and the rotation is
    // the identity, with a_pq (below 1e-19 of the diagonal gap) dropped
    t = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
    c = 1.f / sqrtf(1.f + t * t);
    s = t * c;
  }
}

// One warp per matrix: lane k < 12 owns row and column k. A rotation
// (p, q) is one step: lane k != p, q rewrites a_kp, a_kq (and their mirror
// entries), lane 0 the 2x2 block (Rutishauser's form: a_pp - t a_pq,
// a_qq + t a_pq, a_pq = 0), and lane k the row k of V = V J. No two lanes
// write one entry and no lane reads one that another writes in the step.
__global__ void __launch_bounds__(32 * EIG_WARPS)
sym12_min_eigvec(const float* __restrict__ M, float* __restrict__ out, int batch) {
  __shared__ float sa[EIG_WARPS][EIG_N][EIG_N + 1];
  __shared__ float sv[EIG_WARPS][EIG_N][EIG_N + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * EIG_WARPS + warp;
  if (b >= batch) return;  // the whole warp leaves together
  float(*a)[EIG_N + 1] = sa[warp];
  float(*v)[EIG_N + 1] = sv[warp];
  const float* m = M + (int64_t)b * EIG_N * EIG_N;
  for (int i = lane; i < EIG_N * EIG_N; i += 32) {
    const int r = i / EIG_N, col = i % EIG_N;
    a[r][col] = m[i];
    v[r][col] = r == col ? 1.f : 0.f;
  }
  __syncwarp();
  for (int sweep = 0; sweep < EIG_SWEEPS; ++sweep) {
    for (int p = 0; p < EIG_N - 1; ++p) {
      for (int q = p + 1; q < EIG_N; ++q) {
        const float app = a[p][p], aqq = a[q][q], apq = a[p][q];
        float c, s, t;
        jacobi_rotation(app, aqq, apq, c, s, t);
        __syncwarp();  // every lane has read the 2x2 block
        if (lane < EIG_N) {
          const int k = lane;
          if (k != p && k != q) {
            const float akp = a[k][p], akq = a[k][q];
            const float nkp = c * akp - s * akq;
            const float nkq = s * akp + c * akq;
            a[k][p] = nkp;
            a[p][k] = nkp;
            a[k][q] = nkq;
            a[q][k] = nkq;
          }
          const float vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
        if (lane == 0) {
          a[p][p] = app - t * apq;
          a[q][q] = aqq + t * apq;
          a[p][q] = 0.f;
          a[q][p] = 0.f;
        }
        __syncwarp();
      }
    }
  }
  // the smallest diagonal entry, ties toward the lower index
  float best = lane < EIG_N ? a[lane][lane] : INFINITY;
  int arg = lane < EIG_N ? lane : EIG_N;
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    if (ob < best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if (arg >= EIG_N) arg = 0;  // a NaN diagonal: column 0, NaN all the same
  if (lane < EIG_N) out[(int64_t)b * EIG_N + lane] = v[lane][arg];
}

__device__ __forceinline__ float dot3(const float* x, const float* y) {
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

__device__ __forceinline__ void cross3(const float* x, const float* y, float* z) {
  z[0] = x[1] * y[2] - x[2] * y[1];
  z[1] = x[2] * y[0] - x[0] * y[2];
  z[2] = x[0] * y[1] - x[1] * y[0];
}

// w -= (u . w) u, twice ("twice is enough" for one vector against one).
__device__ __forceinline__ void orthogonalize(const float* u, float* w) {
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const float d = dot3(u, w);
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] -= d * u[i];
  }
}

// Columns are kept as c[j][i] = A[i][j] (column j, row i): a rotation of
// columns p and q then touches two contiguous triples.
__global__ void __launch_bounds__(THREADS)
svd3(const float* __restrict__ A, float* __restrict__ U, float* __restrict__ S,
     float* __restrict__ Vt, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const float* a = A + (int64_t)b * 9;
  float c[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c[j][i] = a[i * 3 + j];
      v[j][i] = i == j ? 1.f : 0.f;  // v[j] = column j of V
    }
  }
#pragma unroll
  for (int sweep = 0; sweep < SVD_SWEEPS; ++sweep) {
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0;
      const int q = pair == 0 ? 1 : 2;
      // the two-sided rotation of the Gram matrix's 2x2 block (alpha, gamma;
      // gamma, beta) applied to the columns from the right
      float cs, sn, t;
      jacobi_rotation(dot3(c[p], c[p]), dot3(c[q], c[q]), dot3(c[p], c[q]), cs, sn, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float cp = c[p][i], cq = c[q][i];
        c[p][i] = cs * cp - sn * cq;
        c[q][i] = sn * cp + cs * cq;
        const float vp = v[p][i], vq = v[q][i];
        v[p][i] = cs * vp - sn * vq;
        v[q][i] = sn * vp + cs * vq;
      }
    }
  }
  float s[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) s[j] = sqrtf(dot3(c[j], c[j]));
  // descending order, as torch.linalg.svd returns it (a sorting network of
  // three compare-and-swaps of the value, its column and its V column)
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int i = step == 1 ? 1 : 0;
    const int j = step == 0 ? 1 : 2;
    const int lo = step == 2 ? 0 : i;
    const int hi = step == 2 ? 1 : j;
    if (s[hi] > s[lo]) {
      const float ts = s[lo];
      s[lo] = s[hi];
      s[hi] = ts;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float tc = c[lo][k];
        c[lo][k] = c[hi][k];
        c[hi][k] = tc;
        const float tv = v[lo][k];
        v[lo][k] = v[hi][k];
        v[hi][k] = tv;
      }
    }
  }
  // U: u0 = c0 / s0; u1 = c1 made orthogonal to u0 and normalised (any unit
  // vector orthogonal to u0 when c1 vanishes: rank 1); u2 = u0 x u1, with
  // the sign of c2 on it (either sign for rank 2, where c2 vanishes)
  float u[3][3];
  if (s[0] > 0.f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u[0][i] = c[0][i] / s[0];
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) u[0][i] = i == 0 ? 1.f : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) u[1][i] = c[1][i];
  orthogonalize(u[0], u[1]);
  float n1 = sqrtf(dot3(u[1], u[1]));
  if (!(n1 > 1e-30f)) {
    // the axis least along u0, made orthogonal to it
    const float ax = fabsf(u[0][0]), ay = fabsf(u[0][1]), az = fabsf(u[0][2]);
    const int k = (ax <= ay && ax <= az) ? 0 : (ay <= az ? 1 : 2);
#pragma unroll
    for (int i = 0; i < 3; ++i) u[1][i] = i == k ? 1.f : 0.f;
    orthogonalize(u[0], u[1]);
    n1 = sqrtf(dot3(u[1], u[1]));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) u[1][i] /= n1;
  cross3(u[0], u[1], u[2]);
  const float n2 = sqrtf(dot3(u[2], u[2]));
  const float sg = dot3(u[2], c[2]) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) u[2][i] *= sg / n2;

  float* uo = U + (int64_t)b * 9;
  float* vo = Vt + (int64_t)b * 9;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      uo[i * 3 + j] = u[j][i];  // U[i][j] = row i of column j
      vo[i * 3 + j] = v[i][j];  // Vt[i][j] = V[j][i] = row j of column i
    }
    S[(int64_t)b * 3 + i] = s[i];
  }
}

__global__ void __launch_bounds__(THREADS)
spd6_solve(const float* __restrict__ H, const float* __restrict__ g, float* __restrict__ x,
           int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const float* h = H + (int64_t)b * SPD_N * SPD_N;
  float L[SPD_N][SPD_N];
#pragma unroll
  for (int j = 0; j < SPD_N; ++j) {
    float d = h[j * SPD_N + j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    L[j][j] = sqrtf(d);
#pragma unroll
    for (int i = j + 1; i < SPD_N; ++i) {
      float e = h[i * SPD_N + j];
#pragma unroll
      for (int k = 0; k < j; ++k) e -= L[i][k] * L[j][k];
      L[i][j] = e / L[j][j];
    }
  }
  float y[SPD_N];
#pragma unroll
  for (int i = 0; i < SPD_N; ++i) {
    float e = g[(int64_t)b * SPD_N + i];
#pragma unroll
    for (int k = 0; k < i; ++k) e -= L[i][k] * y[k];
    y[i] = e / L[i][i];
  }
#pragma unroll
  for (int i = SPD_N - 1; i >= 0; --i) {
    float e = y[i];
#pragma unroll
    for (int k = i + 1; k < SPD_N; ++k) e -= L[k][i] * y[k];
    y[i] = e / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < SPD_N; ++i) x[(int64_t)b * SPD_N + i] = y[i];
}

int blocks(int work, int per_block) { return (work + per_block - 1) / per_block; }

}  // namespace

extern "C" {

// M (batch, 12, 12) symmetric, row-major; out (batch, 12).
int small_eig_sym12_launch(const float* M, float* out, int batch, cudaStream_t stream) {
  if (batch > 0) {
    sym12_min_eigvec<<<blocks(batch, EIG_WARPS), 32 * EIG_WARPS, 0, stream>>>(M, out, batch);
  }
  return (int)cudaGetLastError();
}

// A (batch, 3, 3); U (batch, 3, 3), S (batch, 3), Vt (batch, 3, 3).
int small_eig_svd3_launch(const float* A, float* U, float* S, float* Vt, int batch,
                          cudaStream_t stream) {
  if (batch > 0) svd3<<<blocks(batch, THREADS), THREADS, 0, stream>>>(A, U, S, Vt, batch);
  return (int)cudaGetLastError();
}

// H (batch, 6, 6) symmetric positive definite, g (batch, 6); x (batch, 6).
int small_eig_spd6_solve_launch(const float* H, const float* g, float* x, int batch,
                                cudaStream_t stream) {
  if (batch > 0) spd6_solve<<<blocks(batch, THREADS), THREADS, 0, stream>>>(H, g, x, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
