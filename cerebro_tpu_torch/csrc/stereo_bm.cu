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
// 67 TFLOP/s). This kernel does more: each step of a colsum entry costs ~18
// instructions (two loads, index arithmetic, a shared-memory update), and
// the halo columns and each band's fill steps repeat ~3x the vertical
// steps the image needs, so instruction issue, not the f32 rate, bounds it.
//
// What the design does about it:
//   * Grid: (64-column strips, bands of <= 16 rows, batch). A block slides
//     down its band one row at a time. For every column of its strip plus a
//     block/2 halo on each side, and every disparity, it keeps the vertical
//     box sum of |L - R| in shared memory (`colsum`): each row step adds the
//     row entering the window and subtracts the row leaving it. A band
//     starts with block - 1 steps that only fill the window. Short bands
//     give the grid enough blocks (600 at 8 x 240 x 320) to fill the card,
//     at the price of those steps: 36 vertical steps per 16 output rows.
//   * Per output row, each (disparity, 16-column segment) thread slides the
//     horizontal window along colsum, writing the row's costs (`cost`) to
//     shared memory. No (H, W, D) cost volume is written to device memory.
//   * Per output pixel, 4 lanes split the disparities: the first minimum,
//     then the minimum outside +-1 of it, each merged by warp shuffles;
//     lane 0 reads the d0 +- 1 costs for the parabola and writes the pixel.
//   * The texture sum is one more colsum channel, |L(x) - L(x - 1 mod W)|.
// The running sums add and subtract the very terms a direct sum adds, so on
// integer-valued images (8-bit pixels: every sum < 2^24) each cost is exact
// in f32 and the result equals the plain version's; on other images the
// costs differ from a direct sum by f32 rounding only.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int CW = 64;                 // output columns per block
constexpr int SEG = 16;                // columns one thread slides the window over
constexpr int LANES = THREADS / CW;    // threads per pixel in the winner step
constexpr int MAX_BAND = 16;           // output rows per block, at most
constexpr int MAX_SMEM = 227 * 1024;
constexpr float BIG = 1e3f;            // cost where the right pixel does not exist

// Shared memory: colsum (chans, cs) then cost (chans, cp), chans = nd + 1
// (channel nd is the texture term). Odd row strides keep the 32 channels a
// warp touches at once in 32 different banks.
struct Layout {
  int h, chans, cwh, cs, cp;
  __host__ __device__ Layout(int num_disp, int block)
      : h(block / 2), chans(num_disp + 1), cwh(CW + 2 * (block / 2)),
        cs((CW + 2 * (block / 2)) | 1), cp(CW + 1) {}
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)chans * (cs + cp);
  }
};

// One vertical step of colsum column x: add what image row r_in (if `add`)
// and subtract what row r_out (if `sub`) contribute, |L(x) - R(x - d)| or
// BIG where x < d, for each disparity d of this thread's channel group
// (d = g, g + G, ...); group G - 1 also steps the texture channel nd,
// |L(x) - L(x - 1 mod W)|. The calling thread owns these colsum entries.
__device__ __forceinline__ void vertical_step(float* __restrict__ col, const float* __restrict__ L,
                                              const float* __restrict__ R, int r_in, bool add,
                                              int r_out, bool sub, int x, int W, int nd, int g,
                                              int G, int cs) {
  const size_t o_in = (size_t)r_in * W + x, o_out = (size_t)r_out * W + x;
  const int xm = x == 0 ? W - 1 : x - 1;
  const float l_in = add ? __ldg(L + o_in) : 0.f;
  const float l_out = sub ? __ldg(L + o_out) : 0.f;
  for (int d = g; d < nd; d += G) {
    float v = 0.f;
    if (add) v += x >= d ? fabsf(l_in - __ldg(R + o_in - d)) : BIG;
    if (sub) v -= x >= d ? fabsf(l_out - __ldg(R + o_out - d)) : BIG;
    col[d * cs] += v;
  }
  if (g == G - 1) {
    float v = 0.f;
    if (add) v += fabsf(l_in - __ldg(L + o_in - x + xm));
    if (sub) v -= fabsf(l_out - __ldg(L + o_out - x + xm));
    col[nd * cs] += v;
  }
}

__global__ void __launch_bounds__(THREADS)
stereo_bm_kernel(const float* __restrict__ left, const float* __restrict__ right,
                 float* __restrict__ disp, uint8_t* __restrict__ valid, int H, int W,
                 int nd, int block, int band, float uniqueness, float texture_thresh) {
  const Layout lay(nd, block);
  const int h = lay.h;
  const int x0 = blockIdx.x * CW;
  const int y0 = blockIdx.y * band;
  const int y_end = min(y0 + band, H);
  const size_t img = (size_t)blockIdx.z * H * W;
  const float* L = left + img;
  const float* R = right + img;
  extern __shared__ float sm[];
  float* colsum = sm;                          // column x0 - h + i at colsum[d * cs + i]
  float* cost = sm + lay.chans * lay.cs;       // column x0 + i at cost[d * cp + i]
  for (int i = threadIdx.x; i < lay.chans * lay.cs; i += THREADS) colsum[i] = 0.f;
  __syncthreads();

  // vertical step: this thread's colsum column(s) and channel group
  const int groups = max(1, THREADS / lay.cwh);
  const int vg = threadIdx.x / lay.cwh;         // >= groups: idle in this step
  const int vc = threadIdx.x % lay.cwh;
  const int xo = threadIdx.x / LANES;          // winner step: this thread's pixel
  const int lane = threadIdx.x % LANES;        // ... and its share of disparities
  const int per_lane = (nd + LANES - 1) / LANES;
  const int d_lo = lane * per_lane;
  const int d_hi = min(nd, d_lo + per_lane);
  const float* cx = cost + xo;                 // cost of disparity d at cx[d * cp]

  for (int y = y0 - 2 * h; y < y_end; ++y) {
    // ---- vertical: window rows y - h .. y + h ----
    const int r_in = y + h;
    const int r_out = y - h - 1;
    const bool add = r_in >= 0 && r_in < H;
    const bool sub = r_out >= 0 && r_out >= y0 - h;
    // Each colsum entry has one owner thread here, so vertical steps need no
    // barrier between them; the last horizontal step is behind a barrier.
    if ((add || sub) && vg < groups) {
      for (int c = vc; c < lay.cwh; c += THREADS) {
        const int x = x0 - h + c;
        if (x < 0 || x >= W) continue;         // zeros outside the image
        vertical_step(colsum + c, L, R, r_in, add, r_out, sub, x, W, nd, vg, groups, lay.cs);
      }
    }
    if (y < y0) continue;                      // window not full yet
    __syncthreads();

    // ---- horizontal: cost[d][x] = sum of colsum[d][x .. x + 2h] ----
    for (int i = threadIdx.x; i < lay.chans * (CW / SEG); i += THREADS) {
      const int d = i % lay.chans;
      const int x = (i / lay.chans) * SEG;
      const float* c = colsum + d * lay.cs + x;
      float* o = cost + d * lay.cp + x;
      float acc = 0.f;
      for (int k = 0; k <= 2 * h; ++k) acc += c[k];
      o[0] = acc;
      for (int j = 1; j < SEG; ++j) {
        acc += c[j + 2 * h] - c[j - 1];
        o[j] = acc;
      }
    }
    __syncthreads();

    // ---- winner of pixel (y, x0 + xo) over 4 lanes ----
    float best = INFINITY;
    int bidx = nd;
    for (int d = d_lo; d < d_hi; ++d) {
      const float c = cx[d * lay.cp];
      if (c < best) {                          // strict: the first minimum wins
        best = c;
        bidx = d;
      }
    }
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (ob < best || (ob == best && oi < bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    float second = INFINITY;
    for (int d = d_lo; d < d_hi; ++d) {
      if (abs(d - bidx) > 1) second = fminf(second, cx[d * lay.cp]);
    }
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) {
      second = fminf(second, __shfl_xor_sync(0xffffffffu, second, off));
    }
    const int x = x0 + xo;
    if (lane == 0 && x < W) {
      const int d0 = min(max(bidx, 1), nd - 2);
      const float cm = cx[(d0 - 1) * lay.cp];
      const float cc = cx[d0 * lay.cp];
      const float cp = cx[(d0 + 1) * lay.cp];
      const float denom = fmaxf(cm - 2.f * cc + cp, 1e-6f);
      const float delta = fminf(fmaxf(0.5f * (cm - cp) / denom, -1.f), 1.f);
      const bool ok = best < uniqueness * second && cx[nd * lay.cp] > texture_thresh &&
                      bidx > 0 && bidx < nd - 1 && x >= nd;
      const size_t o = img + (size_t)y * W + x;
      disp[o] = (float)d0 + delta;
      valid[o] = ok ? 1 : 0;
    }
  }
}

}  // namespace

// Launch K3 on `stream` for B images of H x W. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an even block, num_disp < 3, or a num_disp
// and block whose per-block state does not fit in shared memory.
extern "C" int stereo_bm_launch(const void* left, const void* right, void* disp, void* valid,
                                int B, int H, int W, int num_disp, int block,
                                float uniqueness, float texture_thresh, void* stream) {
  const Layout lay(num_disp, block);
  if (B < 1 || H < 1 || W < 1 || num_disp < 3 || block % 2 != 1 || lay.bytes() > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      stereo_bm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes());
  if (err != cudaSuccess) return (int)err;
  const int bands = (H + MAX_BAND - 1) / MAX_BAND;
  const int band = (H + bands - 1) / bands;    // even bands: 240 rows -> 15 x 16
  const dim3 grid((W + CW - 1) / CW, (H + band - 1) / band, B);
  stereo_bm_kernel<<<grid, THREADS, lay.bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(left), static_cast<const float*>(right),
      static_cast<float*>(disp), static_cast<uint8_t*>(valid), H, W, num_disp, block, band,
      uniqueness, texture_thresh);
  return (int)cudaGetLastError();
}
