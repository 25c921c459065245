// K1 and K2: masked descriptor scores and the exact top-K per query, in one
// pass over the descriptor DB on the tensor cores.
//
// Replaces the Pallas kernels cerebro_tpu/ops/similarity.py::_score_argmax_kernel
// (:98, K1, launched by max_and_argmax) and ::_score_argmax_banned_kernel
// (:286, K2, launched once per pass of search_topk_streaming).
//
// What it computes. For each query q, the K best (score, row) pairs over all
// N DB rows, ordered by `beats` (higher score first, then lower row). The
// score is the f32 sum of the bf16 products q . db[row]; a row scores exactly
// -1e30 when its gid is not below limits[q] or equals one of banned[q, :KB]
// (-1 slots are inert as long as no row carries gid -1). Masked rows take
// part in the selection at -1e30 like any other row, so the slots after a
// query's last real hit hold its lowest unmatchable rows: the order of
// lax.top_k over the JAX package's dense masked score matrix. The merge
// kernel writes (score, gids[row]). Instantiations: K=1, KB=0 is K1
// (max_and_argmax); K=1, KB>=1 is K2's banned argmax; K=k, KB=0 is a whole
// search_topk call. The (Q, N) score matrix never reaches device memory.
//
// What bounds it on an H100: reading the DB. At the main path's 29,184 x
// 8,192 bf16 rows that is 478 MB, 0.143 ms at 3.35 TB/s; the products of 64
// queries take 0.031 ms on the bf16 tensor cores. So the design reads every
// DB byte once per call, for any K and for up to 64 queries, and keeps the
// tensor cores and the selection out of the way of the copies:
//   * One block per SM owns a contiguous range of rows (a multiple of 32)
//     and walks it in tiles of 128 rows; each tile walks D in chunks of 64
//     bf16 (128 bytes, one 128-byte swizzle row).
//   * One producer thread keeps TMA loads in flight into a ring of up to 16
//     stages with full and empty mbarriers. A stage holds the tile's DB
//     chunk, loaded as boxes of 32 rows (4 KB; a block's last tile loads
//     only the boxes it owns), and the matching chunk of QP queries (Q
//     rounded up to 8, 16, 32 or 64), which streams from L2 beside the DB.
//     With boxes of 8 rows the number of TMA operations, not the bytes, set
//     the pace (PERF.md). TMA fills rows and columns past the tensor's edge
//     with zeros: ragged D and padding queries cost nothing.
//   * One consumer warpgroup issues wgmma m64nQPk16 f32.bf16.bf16 with both
//     operands K-major in shared memory, two per k step (the tile's two
//     64-row halves). Accumulators stay in registers, at most 64 a thread.
//   * D is never split: each score is one f32 sum in a fixed order, so two
//     exact copies of a DB row score bit-identically and the lower row wins.
//   * Epilogue per tile: the accumulators go to shared memory as (query,
//     row); 128 / QP threads per query apply the mask and the ban (limits,
//     banned lists and the tile's gids sit in shared memory) and keep
//     running top-K lists in registers by insertion under `beats`. The
//     producer keeps loading the next tile meanwhile. At the end the lists
//     of each query merge by warp shuffles into the block's (Q, nblocks, K)
//     partials; a second kernel, one block per query, selects the top K of
//     the nblocks x K partials and translates rows to gids.
// Q above 64 runs 64-query tiles as grid axis y: one DB read per 64 queries.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TILE_ROWS = 128;                     // DB rows per tile: two m64 halves
constexpr int CHUNK = 64;                          // bf16 columns per stage (128 bytes)
constexpr int GROUP_ROWS = 32;                     // rows per DB TMA box
constexpr int ROW_BYTES = CHUNK * 2;               // 128
constexpr int DB_STAGE_BYTES = TILE_ROWS * ROW_BYTES;  // 16 KB
constexpr int HALF_BYTES = 64 * ROW_BYTES;         // one m64 half of the tile
constexpr int CONSUMERS = 128;                     // one warpgroup
constexpr int THREADS = CONSUMERS + 32;            // and one producer warp
constexpr int MAX_STAGES = 16;
constexpr int SCORE_PITCH = TILE_ROWS + 4;         // floats per query row of staged scores
constexpr int MERGE_THREADS = 128;
constexpr float MASKED = -1e30f;                   // NEG_INF of the reference
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory, in bytes from the 1 KB-aligned base: the ring, the
// staged scores, the limits, the tile's gids and the banned lists. The
// launcher adds 1 KB for the alignment.
struct SmemLayout {
  int stage_bytes, scores, limits, gids, bans, total;
};

__host__ __device__ inline SmemLayout smem_layout(int qp, int kb, int stages) {
  SmemLayout l;
  l.stage_bytes = DB_STAGE_BYTES + qp * ROW_BYTES;
  l.scores = stages * l.stage_bytes;
  l.limits = l.scores + qp * SCORE_PITCH * 4;
  l.gids = l.limits + qp * 4;
  l.bans = l.gids + TILE_ROWS * 4;
  l.total = l.bans + qp * kb * 4;
  return l;
}

// (s, r) beats (bs, br): larger score, or equal score at a lower row.
__device__ __forceinline__ bool beats(float s, int r, float bs, int br) {
  return s > bs || (s == bs && r < br);
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A wait
// of ~10 s means a copy that never lands: trap, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// One 2-d TMA box to shared memory at (column c0, row c1), completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma operand descriptor of a K-major tile with 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO is unused for this
// layout. Adding 2 advances the start by 32 bytes, one k16 step.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x QP) (+)= A(64 x 16) * B(QP x 16)^T, f32 accumulators, bf16 inputs,
// A and B K-major in shared memory. scale_d = 0 overwrites D.
template <int QP>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ---- running top-K lists in registers, best first --------------------------

template <int K>
__device__ __forceinline__ void list_init(float (&bv)[K], int (&br)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    bv[i] = -INFINITY;  // below every real score, masked ones included
    br[i] = INT_MAX;
  }
}

template <int K>
__device__ __forceinline__ void list_insert(float (&bv)[K], int (&br)[K], float v, int r) {
  if (!beats(v, r, bv[K - 1], br[K - 1])) return;
  // slot i takes slot i-1 if (v, r) beats it, else (v, r) if that beats slot i
#pragma unroll
  for (int i = K - 1; i > 0; --i) {
    if (beats(v, r, bv[i - 1], br[i - 1])) {
      bv[i] = bv[i - 1];
      br[i] = br[i - 1];
    } else if (beats(v, r, bv[i], br[i])) {
      bv[i] = v;
      br[i] = r;
    }
  }
  if (beats(v, r, bv[0], br[0])) {
    bv[0] = v;
    br[0] = r;
  }
}

template <int K>
__device__ __forceinline__ void list_pop(float (&bv)[K], int (&br)[K]) {
#pragma unroll
  for (int i = 0; i + 1 < K; ++i) {
    bv[i] = bv[i + 1];
    br[i] = br[i + 1];
  }
  bv[K - 1] = -INFINITY;
  br[K - 1] = INT_MAX;
}

// ---- the kernels -----------------------------------------------------------

template <int K, int QP>
__global__ void __launch_bounds__(THREADS, 1)
score_topk_partial(__grid_constant__ const CUtensorMap db_map,  // (N, D) bf16, box 32 x 64
                   __grid_constant__ const CUtensorMap q_map,   // (Q, D) bf16, box QP x 64
                   const int* __restrict__ limits,              // (Q,)
                   const int* __restrict__ gids,                // (N,)
                   const int* __restrict__ banned,              // (Q, KB)
                   float* __restrict__ part_val,                // (Q, nblocks, K)
                   int* __restrict__ part_row,                  // (Q, nblocks, K)
                   int Q, int N, int D, int KB, int rows_per_block, int stages) {
  constexpr int T = CONSUMERS / QP;  // epilogue threads per query
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];

  const SmemLayout L = smem_layout(QP, KB, stages);
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* scores = reinterpret_cast<float*>(smem + L.scores);  // (QP, SCORE_PITCH)
  int* lim = reinterpret_cast<int*>(smem + L.limits);         // (QP,)
  int* tile_gid = reinterpret_cast<int*>(smem + L.gids);      // (TILE_ROWS,)
  int* ban = reinterpret_cast<int*>(smem + L.bans);           // (QP, KB)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * QP;
  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(N, r_begin + rows_per_block);
  const int chunks = (D + CHUNK - 1) / CHUNK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < QP; i += THREADS) {
    // padding queries of the last tile match nothing
    lim[i] = (q0 + i < Q) ? limits[q0 + i] : INT_MIN;
  }
  for (int i = tid; i < QP * KB; i += THREADS) {
    const int qi = i / KB;
    ban[i] = (q0 + qi < Q) ? banned[(size_t)(q0 + qi) * KB + (i - qi * KB)] : -1;
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int row0 = r_begin; row0 < r_end; row0 += TILE_ROWS) {
        const int groups = (min(TILE_ROWS, r_end - row0) + GROUP_ROWS - 1) / GROUP_ROWS;
        const uint32_t bytes = (groups * GROUP_ROWS + QP) * ROW_BYTES;
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(&empty_bar[stage], phase ^ 1);
          uint8_t* st = smem + stage * L.stage_bytes;
          mbar_expect_tx(&full_bar[stage], bytes);
          for (int g = 0; g < groups; ++g) {
            tma_load(st + g * GROUP_ROWS * ROW_BYTES, &db_map, c * CHUNK, row0 + g * GROUP_ROWS,
                     &full_bar[stage]);
          }
          tma_load(st + DB_STAGE_BYTES, &q_map, c * CHUNK, q0, &full_bar[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int eq = tid / T;    // this thread's query in the epilogue
  const int esub = tid % T;  // and its phase over the tile's rows
  float bv[K];
  int br[K];
  list_init(bv, br);
  float acc0[QP / 2], acc1[QP / 2];
#pragma unroll
  for (int i = 0; i < QP / 2; ++i) acc0[i] = acc1[i] = 0.f;

  const uint32_t ring = smem_u32(smem);
  int stage = 0;
  uint32_t phase = 0;
  for (int row0 = r_begin; row0 < r_end; row0 += TILE_ROWS) {
    const int nrows = min(TILE_ROWS, r_end - row0);
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full_bar[stage], phase);
      const uint32_t base = ring + stage * L.stage_bytes;
      const uint64_t da0 = smem_desc(base);
      const uint64_t da1 = smem_desc(base + HALF_BYTES);
      const uint64_t dq = smem_desc(base + DB_STAGE_BYTES);
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        const int scale_d = (c > 0 || kk > 0) ? 1 : 0;
        Wgmma<QP>::mma(acc0, da0 + 2 * kk, dq + 2 * kk, scale_d);
        Wgmma<QP>::mma(acc1, da1 + 2 * kk, dq + 2 * kk, scale_d);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc0);
      fence_regs(acc1);
      mbar_arrive(&empty_bar[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: stage the tile's scores as (query, row), then select
    named_sync(1, CONSUMERS);  // every thread is done reading the last tile's scores
    // accumulator 4j+e of a thread holds row 16 warp + lane/4 + 8 (e/2) of
    // its half and query 8j + 2 (lane%4) + e%2
#pragma unroll
    for (int j = 0; j < QP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + lane / 4 + 8 * (e / 2);
        const int col = 8 * j + 2 * (lane % 4) + (e % 2);
        scores[col * SCORE_PITCH + r] = acc0[4 * j + e];
        scores[col * SCORE_PITCH + 64 + r] = acc1[4 * j + e];
      }
    }
    if (tid < nrows) tile_gid[tid] = gids[row0 + tid];
    named_sync(1, CONSUMERS);
    const int lq = lim[eq];
    const int* qban = ban + eq * KB;
    const float* qs = scores + eq * SCORE_PITCH;
    for (int r = esub; r < nrows; r += T) {
      const int g = tile_gid[r];
      bool ok = g < lq;
      for (int b = 0; b < KB; ++b) ok = ok && qban[b] != g;
      list_insert(bv, br, ok ? qs[r] : MASKED, row0 + r);
    }
  }

  // merge the T lists of each query (aligned lanes of one warp), best first
  for (int j = 0; j < K; ++j) {
    float v = bv[0];
    int r = br[0];
#pragma unroll
    for (int off = T / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, off);
      const int orow = __shfl_xor_sync(FULL, r, off);
      if (beats(ov, orow, v, r)) {
        v = ov;
        r = orow;
      }
    }
    if (bv[0] == v && br[0] == r) list_pop(bv, br);
    if (esub == 0 && q0 + eq < Q) {
      const size_t o = ((size_t)(q0 + eq) * gridDim.x + blockIdx.x) * K + j;
      part_val[o] = v;
      part_row[o] = r;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(MERGE_THREADS)
score_topk_merge(const float* __restrict__ part_val, const int* __restrict__ part_row,
                 const int* __restrict__ gids, float* __restrict__ out_val,
                 int* __restrict__ out_gid, int nparts, int N) {
  __shared__ float wv[MERGE_THREADS / 32];
  __shared__ int wr[MERGE_THREADS / 32];
  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const int n = nparts * K;
  const float* pv = part_val + (size_t)q * n;
  const int* pr = part_row + (size_t)q * n;
  // slot j takes the best candidate that the slot j-1 winner beats; rows
  // are distinct, so each real row is taken once
  float last_v = INFINITY;
  int last_r = -1;
  for (int j = 0; j < K; ++j) {
    float v = -INFINITY;
    int r = INT_MAX;
    for (int i = t; i < n; i += MERGE_THREADS) {
      const float cv = pv[i];
      const int cr = pr[i];
      if (beats(last_v, last_r, cv, cr) && beats(cv, cr, v, r)) {
        v = cv;
        r = cr;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, off);
      const int orow = __shfl_xor_sync(FULL, r, off);
      if (beats(ov, orow, v, r)) {
        v = ov;
        r = orow;
      }
    }
    if (t % 32 == 0) {
      wv[t / 32] = v;
      wr[t / 32] = r;
    }
    __syncthreads();
    v = wv[0];
    r = wr[0];
#pragma unroll
    for (int w = 1; w < MERGE_THREADS / 32; ++w) {
      if (beats(wv[w], wr[w], v, r)) {
        v = wv[w];
        r = wr[w];
      }
    }
    __syncthreads();
    last_v = v;
    last_r = r;
    if (t == 0) {
      out_val[(size_t)q * K + j] = v;
      // every slot holds a real row while K <= N; slots past N (K rounded
      // up above a small N) keep the initial row and are never read
      out_gid[(size_t)q * K + j] = gids[r < N ? r : 0];
    }
  }
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, D) row-major bf16 tensor read in boxes of box_rows x 64 with the
// 128-byte swizzle; out-of-bounds elements read as zero.
bool encode_map(CUtensorMap* map, const void* base, int rows, int D, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)CHUNK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *queries, *db, *limits, *gids, *banned;
  void *part_val, *part_row, *out_val, *out_gid;
  int Q, N, D, KB, rows_per_block;
  cudaStream_t stream;
};

template <int K, int QP>
int launch_kq(const Args& a) {
  CUtensorMap db_map, q_map;
  if (!encode_map(&db_map, a.db, a.N, a.D, GROUP_ROWS) ||
      !encode_map(&q_map, a.queries, a.Q, a.D, QP))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the budget leaves room for the static barriers and the 1 KB alignment
  const int budget = optin - 2048;
  const SmemLayout fixed = smem_layout(QP, a.KB, 0);
  const int stages = std::min(MAX_STAGES, (budget - fixed.total) / fixed.stage_bytes);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = smem_layout(QP, a.KB, stages).total + 1024;
  cudaError_t err = cudaFuncSetAttribute(score_topk_partial<K, QP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = (a.N + a.rows_per_block - 1) / a.rows_per_block;
  const dim3 grid(nblocks, (a.Q + QP - 1) / QP);
  score_topk_partial<K, QP><<<grid, THREADS, smem, a.stream>>>(
      db_map, q_map, static_cast<const int*>(a.limits), static_cast<const int*>(a.gids),
      static_cast<const int*>(a.banned), static_cast<float*>(a.part_val),
      static_cast<int*>(a.part_row), a.Q, a.N, a.D, a.KB, a.rows_per_block, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  score_topk_merge<K><<<a.Q, MERGE_THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.part_val), static_cast<const int*>(a.part_row),
      static_cast<const int*>(a.gids), static_cast<float*>(a.out_val),
      static_cast<int*>(a.out_gid), nblocks, a.N);
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const Args& a) {
  if (a.Q <= 8) return launch_kq<K, 8>(a);
  if (a.Q <= 16) return launch_kq<K, 16>(a);
  if (a.Q <= 32) return launch_kq<K, 32>(a);
  return launch_kq<K, 64>(a);
}

}  // namespace

// Launch the partial and merge kernels on `stream`: out_val / out_gid are
// (Q, K), part_val / part_row (Q, nblocks, K) scratch with nblocks =
// ceil(N / rows_per_block); rows_per_block is a multiple of 32. K is one of
// 1, 2, 4, 8, 16, 32; KB = 0 takes no banned list. The caller checks D % 8 == 0 and
// 16-byte-aligned queries and db. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported K, a banned list too long for
// shared memory, or a tensor map the driver refuses.
extern "C" int score_topk_launch(const void* queries, const void* db, const void* limits,
                                 const void* gids, const void* banned, void* part_val,
                                 void* part_row, void* out_val, void* out_gid, int Q, int N,
                                 int D, int KB, int K, int rows_per_block, void* stream) {
  const Args a{queries, db, limits, gids, banned, part_val, part_row, out_val, out_gid,
               Q, N, D, KB, rows_per_block, static_cast<cudaStream_t>(stream)};
  switch (K) {
    case 1: return launch_k<1>(a);
    case 2: return launch_k<2>(a);
    case 4: return launch_k<4>(a);
    case 8: return launch_k<8>(a);
    case 16: return launch_k<16>(a);
    case 32: return launch_k<32>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
