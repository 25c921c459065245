// K1: fused masked score + max/argmax over the descriptor DB.
//
// Replaces the Pallas kernel cerebro_tpu/ops/similarity.py::_score_argmax_kernel
// (launched by max_and_argmax). For each query q it returns the max over DB
// rows n of the bf16 x bf16 -> f32 dot q . db[n], with rows whose gid is not
// below limits[q] scored -1e30, and the ROW of that max (lowest row on ties,
// as jnp.argmax). An all-masked query gives (-1e30, row 0). The (Q, N) score
// matrix is never written to device memory.
//
// What bounds it on an H100: at the main path's Q = 8 queries the kernel does
// 2 * 8 = 16 flops per DB element, i.e. 8 flops per byte read, far below the
// ~295 flops/byte where the tensor cores would be the limit. It is bound by
// reading the DB once: 29,184 x 8,192 bf16 = 478 MB, 0.14 ms at 3.35 TB/s.
//
// What the design does about it:
//   * The TPU streams the DB through one core in grid order; here the N rows
//     are split across blocks (one per SM: the query group's 128 KB of shared
//     memory allows one resident block, and more blocks would only reload it)
//     and every byte of the DB is read exactly once per query group, with
//     16-byte loads, neighbouring lanes on neighbouring addresses.
//   * A group of up to 8 queries sits in dynamic shared memory
//     (8 x 8,192 x 2 B = 128 KB). Each warp works on 4 DB rows at once, so a
//     query chunk read from shared memory serves 4 rows and 4 independent
//     16-byte loads per lane are in flight.
//   * Dot products accumulate in f32 per lane, then reduce across the warp;
//     each warp keeps a running (max, row) per query in registers. Warps merge
//     in shared memory, blocks write one (max, row) partial per query, and a
//     second small kernel merges the partials per query. No atomics: the
//     result does not depend on scheduling.
//   * Larger Q runs as a second grid axis over query groups.
//   * The N edge needs no padding: blocks and warps mask rows >= N themselves.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int QG = 8;                 // queries per shared-memory group
constexpr int ROWS = 4;               // DB rows per warp iteration
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MERGE_THREADS = 256;
constexpr float MASKED = -1e30f;      // NEG_INF of the reference
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void unpack_bf16x8(const uint4 v, float f[8]) {
  // bf16 is the top half of an f32: shifting the bits up converts exactly.
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
  f[4] = __uint_as_float(v.z << 16);
  f[5] = __uint_as_float(v.z & 0xffff0000u);
  f[6] = __uint_as_float(v.w << 16);
  f[7] = __uint_as_float(v.w & 0xffff0000u);
}

// (s, r) beats (bs, br): larger score, or equal score at a lower row.
__device__ __forceinline__ bool beats(float s, int r, float bs, int br) {
  return s > bs || (s == bs && r < br);
}

__global__ void __launch_bounds__(THREADS, 1)
score_argmax_partial(const uint4* __restrict__ queries,   // (Q, D) bf16
                     const uint4* __restrict__ db,        // (N, D) bf16
                     const int* __restrict__ limits,      // (Q,)
                     const int* __restrict__ gids,        // (N,)
                     float* __restrict__ part_max,        // (Q, nblocks)
                     int* __restrict__ part_row,          // (Q, nblocks)
                     int Q, int N, int D, int rows_per_block) {
  extern __shared__ uint4 qs[];                // (QG, D / 8) query chunks
  __shared__ int lim[QG];
  __shared__ float red_max[WARPS][QG];
  __shared__ int red_row[WARPS][QG];

  const int chunks = D / 8;
  const int q0 = blockIdx.y * QG;
  for (int i = threadIdx.x; i < QG * chunks; i += THREADS) {
    const int qi = i / chunks;
    qs[i] = (q0 + qi < Q) ? queries[(size_t)(q0 + qi) * chunks + (i - qi * chunks)]
                          : make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x < QG) {
    // padding queries of the last group match nothing
    lim[threadIdx.x] = (q0 + threadIdx.x < Q) ? limits[q0 + threadIdx.x] : INT_MIN;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(N, r_begin + rows_per_block);

  float best[QG];
  int best_row[QG];
#pragma unroll
  for (int q = 0; q < QG; ++q) {
    best[q] = -INFINITY;
    best_row[q] = INT_MAX;
  }

  for (int base = r_begin + warp * ROWS; base < r_end; base += WARPS * ROWS) {
    float acc[ROWS][QG];
    const uint4* rowp[ROWS];
    bool live[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      live[r] = base + r < r_end;
      rowp[r] = db + (size_t)(live[r] ? base + r : base) * chunks;
#pragma unroll
      for (int q = 0; q < QG; ++q) acc[r][q] = 0.f;
    }
    for (int c = lane; c < chunks; c += 32) {
      float dv[ROWS][8];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const uint4 v = live[r] ? __ldg(rowp[r] + c) : make_uint4(0u, 0u, 0u, 0u);
        unpack_bf16x8(v, dv[r]);
      }
#pragma unroll
      for (int q = 0; q < QG; ++q) {
        float qv[8];
        unpack_bf16x8(qs[q * chunks + c], qv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[r][q] = fmaf(qv[k], dv[r][k], acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int q = 0; q < QG; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r][q] += __shfl_xor_sync(FULL, acc[r][q], off);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (!live[r]) continue;
      const int row = base + r;
      const int g = gids[row];
#pragma unroll
      for (int q = 0; q < QG; ++q) {
        const float s = (g < lim[q]) ? acc[r][q] : MASKED;
        if (beats(s, row, best[q], best_row[q])) {
          best[q] = s;
          best_row[q] = row;
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < QG; ++q) {
      red_max[warp][q] = best[q];
      red_row[warp][q] = best_row[q];
    }
  }
  __syncthreads();
  if (threadIdx.x < QG && q0 + threadIdx.x < Q) {
    const int q = threadIdx.x;
    float m = -INFINITY;
    int row = INT_MAX;
    for (int w = 0; w < WARPS; ++w) {
      if (beats(red_max[w][q], red_row[w][q], m, row)) {
        m = red_max[w][q];
        row = red_row[w][q];
      }
    }
    part_max[(size_t)(q0 + q) * gridDim.x + blockIdx.x] = m;
    part_row[(size_t)(q0 + q) * gridDim.x + blockIdx.x] = row;
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
score_argmax_merge(const float* __restrict__ part_max, const int* __restrict__ part_row,
                   float* __restrict__ out_max, int* __restrict__ out_row, int nparts) {
  __shared__ float sm[MERGE_THREADS];
  __shared__ int sr[MERGE_THREADS];
  const int q = blockIdx.x;
  const int t = threadIdx.x;
  float m = -INFINITY;
  int row = INT_MAX;
  for (int i = t; i < nparts; i += MERGE_THREADS) {
    const float pm = part_max[(size_t)q * nparts + i];
    const int pr = part_row[(size_t)q * nparts + i];
    if (beats(pm, pr, m, row)) {
      m = pm;
      row = pr;
    }
  }
  sm[t] = m;
  sr[t] = row;
  __syncthreads();
  for (int stride = MERGE_THREADS / 2; stride > 0; stride >>= 1) {
    if (t < stride && beats(sm[t + stride], sr[t + stride], sm[t], sr[t])) {
      sm[t] = sm[t + stride];
      sr[t] = sr[t + stride];
    }
    __syncthreads();
  }
  if (t == 0) {
    out_max[q] = sm[0];
    out_row[q] = sr[0];
  }
}

}  // namespace

// Launch K1 on `stream`. `part_max`/`part_row` are (Q, nblocks) scratch the
// caller allocates; nblocks = ceil(N / rows_per_block). D % 8 == 0 and every
// pointer is 16-byte aligned (the caller checks). Returns cudaGetLastError().
extern "C" int score_argmax_launch(const void* queries, const void* db, const void* limits,
                                   const void* gids, void* part_max, void* part_row,
                                   void* out_max, void* out_row, int Q, int N, int D,
                                   int rows_per_block, void* stream) {
  const size_t smem = (size_t)QG * D * 2;
  cudaError_t err = cudaFuncSetAttribute(
      score_argmax_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = (N + rows_per_block - 1) / rows_per_block;
  const dim3 grid(nblocks, (Q + QG - 1) / QG);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  score_argmax_partial<<<grid, THREADS, smem, s>>>(
      static_cast<const uint4*>(queries), static_cast<const uint4*>(db),
      static_cast<const int*>(limits), static_cast<const int*>(gids),
      static_cast<float*>(part_max), static_cast<int*>(part_row), Q, N, D, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  score_argmax_merge<<<Q, MERGE_THREADS, 0, s>>>(
      static_cast<const float*>(part_max), static_cast<const int*>(part_row),
      static_cast<float*>(out_max), static_cast<int*>(out_row), nblocks);
  return (int)cudaGetLastError();
}
