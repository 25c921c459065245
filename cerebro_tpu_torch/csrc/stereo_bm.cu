// K3: fused SAD stereo block matching over a batch of rectified pairs.
//
// Replaces the Pallas kernel cerebro_tpu/ops/stereo_pallas.py::_make_kernel
// (inner `kernel`, launched by _block_match_batched / block_match_pallas).
// It computes the function of geometry/stereo.py::block_match, per image:
//   cost_d(y, x) = centred block x block box sum (zeros outside the image) of
//                  |L(y, x) - R(y, x - d)|, or 1e3 where x < d;
//   best         = first argmin over d in [0, num_disp);
//   parabola on the costs at d0 - 1, d0, d0 + 1, d0 = clamp(best, 1, nd - 2),
//                  delta clipped to +-1; disparity = d0 + delta;
//   second       = min cost over |d - best| > 1;
//   valid        = best_cost < uniqueness * second
//                  AND box(|L - roll(L, 1)|) > texture_thresh (roll over W)
//                  AND 0 < best < nd - 1 AND x >= nd.
// The TPU kernel's 16-row tiles, 128-lane padding, pltpu.roll and banded
// matmuls are layout choices and are not carried over.
//
// What bounds it on an H100: not memory. It reads 2 images and writes 5
// bytes per pixel (8 x 240 x 320 pixels: ~8 MB, ~2.4 us at 3.35 TB/s). The
// function needs, per pixel and disparity, |L - R| (2 operations), running
// vertical and horizontal box sums (an add and a subtract each: 4) and the
// winner and second-best compares (2): ~8 f32 operations on the CUDA cores,
// ~0.3 GOP for the main path's 8 images at 64 disparities (~5 us at
// 67 TFLOP/s). What a kernel spends above that is shared-memory traffic and
// instruction issue: every sum passes through shared memory between the
// vertical, horizontal and winner steps (~150 KB per output row of a block
// here), plus index arithmetic, halo columns, the steps that fill each
// band's window, and the barriers between the steps of an output row.
//
// What the design does about it (numbers at 8 x 240 x 320, nd 64, block 21):
//   * Grid: (64-column strips, bands, batch). Bands are the most even split
//     of H into at most 40 rows, halved (to 16 rows at least) while the grid
//     has fewer blocks than the card has SMs: 5 x 6 x 8 = 240 blocks, all
//     resident at once. A block slides down its band one row at a time,
//     2h + 40 = 60 vertical steps, the first 2h of which only fill the
//     window.
//   * Rows staged in shared memory: a ring of block + 1 row slots holds the
//     L and R columns the strip reads (and L's column W - 1 for the texture
//     term at x = 0). A step stores the entering row, which each thread
//     fetched from global memory one step ahead, and reads the leaving row
//     back from its slot: no global load inside the disparity loop.
//   * Column sums in registers: thread t owns colsum column t mod (64 + 2h)
//     and the J disparities g + 4j of group g = t div (64 + 2h) (J a
//     template parameter, 4 J >= nd); group 0 also owns the texture sum.
//     Whether x >= d holds is fixed per (column, slot) for the band. A step
//     is two shared loads of R and three or four FADDs per disparity, and on
//     an output row one plain store of each sum into `colsum`. Slots with
//     d >= nd hold DEAD, so no store, sum or winner step tests d < nd, and
//     every shared-memory offset of the J loops is a compile-time immediate.
//   * Per output row, each (disparity, 16-column segment) thread slides the
//     horizontal window along colsum, writing the row's costs (`cost`, one
//     pixel per row of it) in one round of the block's threads. No
//     (H, W, D) cost volume is written to device memory.
//   * Per output pixel, 4 lanes load the costs of disparities lane + 4k into
//     registers once and keep, in one pass, their first minimum and the
//     minimum of their other slots; the winner and the second best outside
//     +-1 of it follow from those and two warp-shuffle merges; lane 0 fits
//     the parabola and writes the pixel.
// The running sums add and subtract the very terms a direct sum adds, so on
// integer-valued images (8-bit pixels: every sum < 2^24) each cost is exact
// in f32 and the result equals the plain version's; on other images the
// costs differ from a direct sum by f32 rounding only.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int CW = 64;                 // output columns per block
constexpr int G = 4;                   // disparity groups of the vertical step
constexpr int LANES = 4;               // threads per pixel in the winner step
constexpr int SEG = 16;                // columns one thread slides the window over
constexpr int MAX_BAND = 40;           // output rows per block, at most
constexpr int MIN_BAND = 16;           // ... and at least, when the card is short of blocks
constexpr int MAX_SMEM = 227 * 1024;
constexpr float BIG = 1e3f;            // cost where the right pixel does not exist
constexpr float DEAD = 1e30f;          // column sum of a slot with d >= nd: never a minimum

// Shared memory, in floats (DS = G * J disparity slots, the texture sum
// in channel DS):
//   ring   (block + 1) slots of `slot` floats: L columns x0 - h - 1 ..
//          x0 + CW + h - 1 (nc + 1), L column W - 1 (1), R columns
//          x0 - h - (nd - 1) .. x0 + CW + h - 1 (nc + nd - 1);
//   colsum (nc, CD): column x0 - h + c, disparity d at c * CD + d. CD =
//          DS + 1 is odd, so the 32 columns a warp stores sit in 32 banks,
//          and a compile-time stride, so every offset is an immediate;
//   cost   (CW, CQ): pixel x0 + i, disparity d at i * CQ + d; CQ = DS + 4,
//          4 mod 32 for J >= 8, so the 8 pixels x 4 lanes of a winner warp
//          hit 32 banks.
template <int J>
struct Layout {
  static constexpr int DS = G * J, CD = DS + 1, CQ = DS + 4;
  int h, nc, slots, slot;
  __host__ __device__ Layout(int num_disp, int block)
      : h(block / 2), nc(CW + 2 * (block / 2)), slots(block + 1),
        slot(2 * (CW + 2 * (block / 2)) + num_disp + 1) {}
  __host__ __device__ int threads() const { return nc * G; }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)slots * slot + (size_t)nc * CD + (size_t)CW * CQ);
  }
};

// One vertical step of this thread's colsum column for its J slots: add the
// entering row's term (ADD) and subtract the leaving row's (SUB), each
// |L(x) - R(x - d)|, or BIG for the slots j >= jge where x < d (MASKED).
// `l_in` / `l_out` are the rows' L(x); `rin` / `rout` point at their
// R(x - g) in the ring, slot j's R(x - d) at [-G * j]. Slots with d >= nd
// run too (their reads stay inside the ring slot): they hold DEAD, which
// absorbs every term.
template <int J, bool ADD, bool SUB, bool MASKED>
__device__ __forceinline__ void vertical_step(float (&acc)[J], float l_in, float l_out,
                                              const float* __restrict__ rin,
                                              const float* __restrict__ rout, int jge) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float a = MASKED && j >= jge ? BIG : fabsf(l_in - rin[-G * j]);
    const float b = MASKED && j >= jge ? BIG : fabsf(l_out - rout[-G * j]);
    if (ADD && SUB) {
      acc[j] += a - b;
    } else if (ADD) {
      acc[j] += a;
    } else {
      acc[j] -= b;
    }
  }
}

template <int J, bool ADD, bool SUB>
__device__ __forceinline__ void vertical_step(float (&acc)[J], float l_in, float l_out,
                                              const float* rin, const float* rout, int jge,
                                              bool masked) {
  if (masked) {
    vertical_step<J, ADD, SUB, true>(acc, l_in, l_out, rin, rout, jge);
  } else {
    vertical_step<J, ADD, SUB, false>(acc, l_in, l_out, rin, rout, jge);
  }
}

// Global source of ring element e (a column of L or R), or nullptr where the
// column lies outside the image (the ring then holds 0 there, which no
// step adds).
template <int J>
__device__ __forceinline__ const float* ring_source(const float* L, const float* R, int e,
                                                    const Layout<J>& lay, int x0, int W, int nd) {
  if (e >= lay.slot) return nullptr;
  int x;
  const float* img;
  if (e <= lay.nc) {
    x = x0 - lay.h - 1 + e;
    img = L;
  } else if (e == lay.nc + 1) {
    x = W - 1;
    img = L;
  } else {
    x = x0 - lay.h - (nd - 1) + (e - lay.nc - 2);
    img = R;
  }
  return x >= 0 && x < W ? img + x : nullptr;
}

template <int J>
__global__ void __launch_bounds__(MAX_THREADS)
stereo_bm_kernel(const float* __restrict__ left, const float* __restrict__ right,
                 float* __restrict__ disp, uint8_t* __restrict__ valid, int H, int W,
                 int nd, int block, int band, float uniqueness, float texture_thresh) {
  using Lay = Layout<J>;
  const Lay lay(nd, block);
  const int h = lay.h;
  const int t = threadIdx.x;
  const int x0 = blockIdx.x * CW;
  const int y0 = blockIdx.y * band;
  const int y_end = min(y0 + band, H);
  const size_t img = (size_t)blockIdx.z * H * W;
  const float* L = left + img;
  const float* R = right + img;
  extern __shared__ float sm[];
  float* ring = sm;                                  // row r in slot r % slots
  float* colsum = ring + lay.slots * lay.slot;
  float* cost = colsum + lay.nc * Lay::CD;
  for (int i = t; i < lay.nc * Lay::CD; i += blockDim.x) colsum[i] = 0.f;

  // ---- vertical step: colsum column c (image column x), group g ----
  const int c = t % lay.nc;
  const int g = t / lay.nc;
  const int x = x0 - h + c;
  const bool col_in = x >= 0 && x < W;               // zeros outside the image
  const int jlive = g < nd ? (nd - 1 - g) / G + 1 : 0;       // slots with d < nd
  const int jge = x < g ? 0 : min(jlive, (x - g) / G + 1);   // ... and d <= x
  const bool masked = jge < jlive;
  const int tix = x == 0 ? lay.nc + 1 : c;           // L(x - 1 mod W) in a slot
  const int rix = lay.nc + 2 + c + nd - 1 - g;       // R(x - g) in a slot
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = j < jlive ? 0.f : DEAD;
  float* col = colsum + c * Lay::CD;                 // this thread's colsum column
  float tacc = 0.f;                                  // texture sum (group 0)

  // ---- this thread's share of each entering row, fetched a step ahead ----
  const float* src0 = ring_source<J>(L, R, t, lay, x0, W, nd);
  const float* src1 = ring_source<J>(L, R, t + blockDim.x, lay, x0, W, nd);
  float pre0 = 0.f, pre1 = 0.f;
  auto fetch = [&](int r) {
    pre0 = src0 ? __ldg(src0 + (size_t)r * W) : 0.f;
    pre1 = src1 ? __ldg(src1 + (size_t)r * W) : 0.f;
  };

  // ---- winner step: pixel x0 + xo, disparities lane + LANES * k ----
  const int xo = t / LANES;
  const int lane = t % LANES;
  const float* cx = cost + xo * Lay::CQ;           // disparity d at cx[d]

  const int y_first = max(y0 - 2 * h, -h);           // earlier steps add no image row
  fetch(y_first + h);                                // row max(y0 - h, 0) < H
  // ring slots of the entering and the leaving row, advanced each step
  int slot_in = (y_first + h) % lay.slots;
  int slot_out = (y_first - h - 1 + lay.slots) % lay.slots;
  for (int y = y_first; y < y_end; ++y) {
    const int r_in = y + h;                          // window rows y - h .. y + h
    const int r_out = y - h - 1;
    const bool add = r_in < H;
    const bool sub = r_out >= 0 && r_out >= y0 - h;  // only rows this band added
    float* s_in = ring + slot_in * lay.slot;
    const float* s_out = ring + slot_out * lay.slot;
    slot_in = slot_in + 1 == lay.slots ? 0 : slot_in + 1;
    slot_out = slot_out + 1 == lay.slots ? 0 : slot_out + 1;
    // Slot r_in % slots last held row r_in - block - 1, read by the previous
    // step only if it subtracted, and every such step ends behind barriers.
    if (add) {
      if (t < lay.slot) s_in[t] = pre0;
      if (t + (int)blockDim.x < lay.slot) s_in[t + blockDim.x] = pre1;
      if (r_in + 1 < H && y + 1 < y_end) fetch(r_in + 1);
    }
    __syncthreads();

    if (col_in) {
      const float l_in = add ? s_in[c + 1] : 0.f;
      const float l_out = sub ? s_out[c + 1] : 0.f;
      const float* rin = s_in + rix;
      const float* rout = s_out + rix;
      if (add && sub) {
        vertical_step<J, true, true>(acc, l_in, l_out, rin, rout, jge, masked);
      } else if (add) {
        vertical_step<J, true, false>(acc, l_in, l_out, rin, rout, jge, masked);
      } else if (sub) {
        vertical_step<J, false, true>(acc, l_in, l_out, rin, rout, jge, masked);
      }
      if (g == 0) {
        if (add) tacc += fabsf(l_in - s_in[tix]);
        if (sub) tacc -= fabsf(l_out - s_out[tix]);
      }
    }
    if (y < y0) continue;                            // window not full yet
    if (col_in) {
#pragma unroll
      for (int j = 0; j < J; ++j) col[g + G * j] = acc[j];
      if (g == 0) col[Lay::DS] = tacc;
    }
    __syncthreads();

    // ---- horizontal: cost of pixel x0 + i, disparity d = colsum[d][i .. i + 2h] ----
    for (int i = t; i < Lay::CD * (CW / SEG); i += blockDim.x) {
      const int d = i % Lay::CD;
      const int xs = (i / Lay::CD) * SEG;
      const float* cl = colsum + xs * Lay::CD + d;
      const float* cr = cl + 2 * h * Lay::CD;
      float* o = cost + xs * Lay::CQ + d;
      float s = 0.f;
#pragma unroll 4
      for (int k = 0; k <= 2 * h; ++k) s += cl[k * Lay::CD];
      o[0] = s;
#pragma unroll
      for (int j = 1; j < SEG; ++j) {
        s += cr[j * Lay::CD] - cl[(j - 1) * Lay::CD];
        o[j * Lay::CQ] = s;
      }
    }
    __syncthreads();

    // ---- winner of pixel (y, x0 + xo) over 4 lanes (warps 0-7, whole) ----
    if (t < LANES * CW) {
      // first minimum m1 at slot k1 (strict <: the lower d wins a tie) and
      // m2, the minimum over the other slots
      float m1 = INFINITY, m2 = INFINITY;
      int k1 = J;
#pragma unroll
      for (int k = 0; k < J; ++k) {
        const float v = cx[lane + LANES * k];
        if (v < m1) {
          m2 = m1;
          m1 = v;
          k1 = k;
        } else {
          m2 = fminf(m2, v);
        }
      }
      float best = m1;
      int bidx = lane + LANES * k1;
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        if (ob < best || (ob == best && oi < bidx)) {
          best = ob;
          bidx = oi;
        }
      }
      // Of bidx - 1, bidx, bidx + 1 at most one is this lane's (dx): the
      // second best outside them is m2 if dx is the lane's minimum, else m1.
      const int dx = bidx - 1 + ((lane - bidx + 1) & (LANES - 1));
      float second = dx <= bidx + 1 && dx == lane + LANES * k1 ? m2 : m1;
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1) {
        second = fminf(second, __shfl_xor_sync(0xffffffffu, second, off));
      }
      const int xw = x0 + xo;
      if (lane == 0 && xw < W) {
        const int d0 = min(max(bidx, 1), nd - 2);
        const float cm = cx[d0 - 1];
        const float cc = cx[d0];
        const float cp = cx[d0 + 1];
        const float denom = fmaxf(cm - 2.f * cc + cp, 1e-6f);
        const float delta = fminf(fmaxf(0.5f * (cm - cp) / denom, -1.f), 1.f);
        const bool ok = best < uniqueness * second && cx[Lay::DS] > texture_thresh &&
                        bidx > 0 && bidx < nd - 1 && xw >= nd;
        const size_t o = img + (size_t)y * W + xw;
        disp[o] = (float)d0 + delta;
        valid[o] = ok ? 1 : 0;
      }
    }
  }
}

// Band height: the most even split of H into bands of at most `max_band`
// rows, with max_band halved (to MIN_BAND at least) while the grid would
// have fewer blocks than the card has SMs.
int pick_band(int H, long blocks_per_band_row, int sms) {
  int max_band = MAX_BAND;
  for (;;) {
    const int bands = (H + max_band - 1) / max_band;
    const int band = (H + bands - 1) / bands;
    const long blocks = (long)((H + band - 1) / band) * blocks_per_band_row;
    if (blocks >= sms || max_band <= MIN_BAND) return band;
    max_band = max(MIN_BAND, max_band / 2);
  }
}

template <int J>
int launch(const float* left, const float* right, float* disp, uint8_t* valid, int B, int H,
           int W, int nd, int block, float uniqueness, float texture_thresh,
           cudaStream_t stream) {
  const Layout<J> lay(nd, block);
  if (lay.threads() > MAX_THREADS || lay.bytes() > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stereo_bm_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes());
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int strips = (W + CW - 1) / CW;
  const int band = pick_band(H, (long)strips * B, sms);
  const dim3 grid(strips, (H + band - 1) / band, B);
  stereo_bm_kernel<J><<<grid, lay.threads(), lay.bytes(), stream>>>(
      left, right, disp, valid, H, W, nd, block, band, uniqueness, texture_thresh);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K3 on `stream` for B images of H x W. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an even block, num_disp outside [3, 128],
// more than 1024 threads ((64 + 2 (block / 2)) x 4), or a num_disp and block
// whose per-block state does not fit in shared memory.
extern "C" int stereo_bm_launch(const void* left, const void* right, void* disp, void* valid,
                                int B, int H, int W, int num_disp, int block,
                                float uniqueness, float texture_thresh, void* stream) {
  if (B < 1 || H < 1 || W < 1 || num_disp < 3 || num_disp > G * 32 || block % 2 != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* l = static_cast<const float*>(left);
  const auto* r = static_cast<const float*>(right);
  auto* d = static_cast<float*>(disp);
  auto* v = static_cast<uint8_t*>(valid);
  auto s = static_cast<cudaStream_t>(stream);
  // the fewest J registers with G * J >= num_disp
  if (num_disp <= G * 4) return launch<4>(l, r, d, v, B, H, W, num_disp, block, uniqueness, texture_thresh, s);
  if (num_disp <= G * 8) return launch<8>(l, r, d, v, B, H, W, num_disp, block, uniqueness, texture_thresh, s);
  if (num_disp <= G * 16) return launch<16>(l, r, d, v, B, H, W, num_disp, block, uniqueness, texture_thresh, s);
  return launch<32>(l, r, d, v, B, H, W, num_disp, block, uniqueness, texture_thresh, s);
}
