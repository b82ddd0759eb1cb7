// K3 on Hopper, single-channel path: the weight gradient of a dense
// windowed plan in the (N, M) layout, fp32 or bf16 in, fp32 out (channel
// plans run ssam_wgrad_tc.cu). The C entry is in ssam_wgrad.cu, the
// instantiations in ssam_wgrad_f32.cu and ssam_wgrad_bf16.cu (one
// translation unit each, so they build in parallel).
//
// Replaces src/repro/core/engine.py::_wgrad_dense_kernel (launched by
// run_weight_grad_plan, pallas_call at line 873), which walks the reduction
// as a sequential grid into a VMEM accumulator. It computes
//
//   dW[n, m] = sum_b sum_(oy, ox) g[b, oy, ox] * xp[b, oy + n, ox + m],
//
// or, with a filter per image (C filters cycled over the images),
// dW[c, n, m], the same sum over the images b * C + c,
//
// xp being x read at (oy + n - ly, ox + m - lx), zero outside the input.
// Rewritten with the column j = ox + m - lx of x as the walk's index:
//
//   dW[n, m] = sum_b sum_oy sum_j g[b, oy, j + lx - m] * x[b, oy + n - ly, j]
//
// with g and x zero outside their extents.
//
// Bound on an H100: the kernel reads 8 B Ho Wo bytes in fp32 and does
// 2 N M B Ho Wo operations, so up to about 80 taps it is bound by bytes
// (8192^2: 537 MB, 0.160 ms at 3.35 TB/s), beyond that by fp32 FMAs at
// 67 TFLOP/s (20 x 20: 0.801 ms). The kernel before this one staged every
// chunk of 64 positions by synchronous scalar loads between two barriers,
// N times over for neighbouring rows, for 4 FMAs a thread: it waited on
// memory (5 x 5 at 8192^2: 4.8 ms, 3.4 % of its bound).
//
// Design: the paper's systolic walk, turned onto the correlation.
//  * Lanes own x's columns: a lane holds V = 16 bytes of a row (4 fp32 or
//    8 bf16 values, one 16-byte shared load), a warp a strip of 32 V
//    columns. Every product (ox, n, m) has exactly one column j, so each
//    is counted once and no lane idles at a strip's edge.
//  * For each output row oy the lane needs g[oy, j + lx - m] for its V
//    columns and every m: a window of V + M - 1 values of the cotangent's
//    row, shifted against x by the taps. It reads the window from the
//    staged row (the aligned 16-byte chunks that cover it, then a shift by
//    d, the launch's constant offset of the window in its chunk); the last
//    lanes' windows reach into a halo box staged beside the strip. A
//    shared load of 16 bytes a chunk costs fewer issue slots than the
//    M - 1 shuffles that would carry the window from lane to lane.
//  * A register cache of x rows: a thread keeps NB rows of its V columns
//    (the band's rows), loads one new row per output row and rotates the
//    cache by unrolling the row loop. Its sums, one per tap of the band and
//    step k = M - 1 - m, stay in registers for the whole walk. Each output
//    row then costs one x load, the window's chunks and M V FMAs per band
//    row. Wide filters (12 columns and more) hold one row more and load
//    the next row and its window before this row's FMAs.
//  * Zeros, not masks: TMA reads zeros outside the tensors (negative
//    coordinates too), so the lead and trail padding, the columns of g
//    outside [0, Wo) and the rows past the image cost no test.
//  * One persistent block an SM (16 warps at 128 registers up to 10
//    columns, 8 warps at up to 255 from 12) walks units of (image, chunk
//    of `rows` output rows, strip) in a fixed order, unit k, k + grid,
//    ...: the units in flight at once cover a band of the image, so the
//    rows and columns a unit re-reads (its N - 1 halo rows of x, M - 1 + d
//    halo columns of g) come from L2 (a filter per image: below). The next units' boxes are in flight
//    by TMA (three boxes a unit, completion on an mbarrier per stage) in a
//    ring of 2-4 stages, sized so an SM keeps about 32 KB in flight. Once
//    every warp is done with a unit (one barrier), thread 0 refills its
//    stage, as K1's ring does. A box starts on a 16-byte aligned column
//    (else error 715) and lands 128-byte aligned (else error 716).
//  * Taps split across warps: the footprint's rows are cut into bands of
//    at most NB rows (NB M sums a thread), and the chunk's rows into row
//    groups; a block has bands x row groups warps, which share each
//    staged unit.
//  * Tiles of the footprint: a filter wider than 32 columns, or with more
//    rows than a block's bands hold, is cut into tiles of taps, one launch
//    each; a tile (n0, m0) of n x m taps is the weight gradient of an n x m
//    filter read at lead (ly - n0, lx - m0), and writes its rows and
//    columns of the partials. Each tile reads x and g once more.
//  * A fixed order, no atomics: a lane's sums, then a butterfly of
//    shuffles over the warp, then the row groups in warp order in shared
//    memory; each block writes one (N, M) partial, and a second kernel adds
//    the partials in block order. Two calls give the same bits.
//  * A gradient per filter (a depthwise conv2d's B * C images, image
//    b * C + c feeding filter c): the units run channel-major, a channel's
//    images and their chunks consecutive, and block k walks a run of
//    consecutive units, so it meets a run of channels and each
//    channel a run of blocks. When the unit's channel changes, the block
//    flushes its sums (the reduction above, through a buffer of its own
//    beside the ring) into its partial k + c of that channel, and starts
//    again from zero; the second kernel adds, per channel, the partials of
//    the blocks that met it, in block order: G + C - 1 partials, no
//    atomics. With one filter the blocks keep the walk of stride G above
//    (one partial a block): paired runs on the card found a run 11-22 %
//    slower on the byte-bound 8192^2 filters.
// No tensor cores: the cases that matter are byte-bound, and fp32 FMAs
// keep the plain version's precision.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssam_hopper.cuh"
#include "ssam_wgrad_table.h"  // generated: core/engine.py::WGRAD_BAND_ROWS

namespace ssam {

constexpr int kWgMaxStages = 4;

// An instantiation (width bucket MB, band rows NB: the table
// SSAM_WGRAD_F32 / SSAM_WGRAD_BF16 that the build generates from
// core/engine.py::WGRAD_BAND_ROWS) is narrow (buckets below
// SSAM_WGRAD_WIDE_FROM: a block of up to 16 warps at 128 registers) or wide
// (up to 8 warps at up to 255 registers, each warp loading the next row
// while it multiplies this one); one block an SM either way. Paired runs
// on the card chose the split: the byte-bound narrow filters need the
// warps, the wide ones the registers.
__host__ __device__ constexpr bool wg_wide(int MB) {
  return MB >= SSAM_WGRAD_WIDE_FROM;
}

__host__ __device__ constexpr int wg_threads(int MB) {
  return wg_wide(MB) ? 256 : 512;
}

// One launch: one tile of the footprint's taps.
struct WgradRowsArgs {
  float* part;   // the tile's first sum in the (grid, N, M) partials, or in
                 // the output when grid == 1
  int pstride, ld;   // a block's partial (N M) and a filter row (M) apart
  int ho, N, M, ly;  // the tile's taps and its lead row
  int goff, d, hw;   // g's box: column offset from the strip, window shift,
                     // halo width (elements)
  int nbands, rgroups, rows, strips, chunks, units;
  int filters, upc;  // filters cycled over the images; units a channel
  int rounds, rem;   // a filter per image: the blocks' runs of units
  int red_off;       // the reduction buffer, bytes past the ring's start
  int stages, stage_bytes, gh_off, x_off;  // a stage's regions (bytes)
  int tx_bytes;                            // bytes TMA writes into a stage
};

template <bool BF16>
struct WgIo;

template <>
struct WgIo<false> {
  using T = float;
  static constexpr int V = 4;
  // o[off + e] = p[e], e < 4: one 16-byte shared load
  template <int K>
  static __device__ __forceinline__ void load(const float* p, float (&o)[K],
                                              int off) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[off] = v.x;
    o[off + 1] = v.y;
    o[off + 2] = v.z;
    o[off + 3] = v.w;
  }
};

template <>
struct WgIo<true> {
  using T = __nv_bfloat16;
  static constexpr int V = 8;
  template <int K>
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[K], int off) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[off + 2 * i] = __uint_as_float(w[i] << 16);
      o[off + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// w[e] = raw[e + d] for the launch's constant d < V: the window starts d
// values into its first chunk. One branch of moves; w may be raw itself
// (the moves then run in place, upwards).
template <int V, int K, int WN, int D = 0>
__device__ __forceinline__ void shift_window(const float (&raw)[K],
                                             float (&w)[WN], int d) {
  if constexpr (D + 1 < V) {
    if (d != D) {
      shift_window<V, K, WN, D + 1>(raw, w, d);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < WN && e + D < K; ++e) w[e] = raw[e + D];
}

// acc[n][k] += sum_v w[v + k] * x[n][v] over the band's rows n < nbr, the
// cache's row n in slot (tt + n) % C, every step k of the bucket (a step
// k >= M sums into a slot no tap reads, cheaper than a branch per step).
template <int V, int MB, int NB, int C, int K>
__device__ __forceinline__ void band_fma(float (&acc)[NB][MB],
                                         const float (&w)[K],
                                         const float (&X)[C][V], int tt,
                                         int nbr) {
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (n < nbr) {
      const float(&xr)[V] = X[(tt + n) % C];
#pragma unroll
      for (int k = 0; k < MB; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[n][k] = fmaf(w[v + k], xr[v], acc[n][k]);
    }
  }
}

// Thread 0: the three TMA boxes of unit u into the stage at st. Units run
// channel-major: unit u feeds filter c = u / upc, its image b * filters + c.
template <int SW, bool RUN>
__device__ __forceinline__ void issue_unit(const CUtensorMap* xmap,
                                           const CUtensorMap* gmap,
                                           const CUtensorMap* hmap,
                                           const WgradRowsArgs& a, int u,
                                           uint8_t* st, uint32_t bar) {
  const int c = RUN ? u / a.upc : 0;
  const int r = (RUN ? u - c * a.upc : u) / a.strips, sx = u % a.strips;
  const int cy = r % a.chunks;
  const int b = RUN ? r / a.chunks * a.filters + c : r / a.chunks;
  const int j0 = sx * SW, oy0 = cy * a.rows;
  mbar_expect_tx(bar, a.tx_bytes);
  tma_load_3d(smem_addr(st), gmap, bar, j0 + a.goff, oy0, b);
  if (a.hw) tma_load_3d(smem_addr(st + a.gh_off), hmap, bar,
                        j0 + a.goff + SW, oy0, b);
  tma_load_3d(smem_addr(st + a.x_off), xmap, bar, j0, oy0 - a.ly, b);
}

// The chunks lane .. lane + QR - 1 of the cotangent's staged row t, those
// past the strip from the halo box.
template <class Io, int QR>
__device__ __forceinline__ void load_window(const typename Io::T* gm,
                                            const typename Io::T* gh, int hw,
                                            int t, int lane,
                                            float (&raw)[QR * Io::V]) {
  constexpr int V = Io::V;
#pragma unroll
  for (int j = 0; j < QR; ++j)
    Io::load(lane + j < 32 ? gm + t * 32 * V + j * V : gh + t * hw + j * V,
             raw, j * V);
}

// One warp's rows [r0, r1) of a staged unit, on its band (n0, nbr). The
// register cache holds the band's NB rows; a wide instantiation (PF) holds
// one more, the next row's newest, which it loads with the next row's
// window before this row's FMAs.
template <bool BF16, int MB, int NB, bool PF>
__device__ __forceinline__ void walk_rows(const uint8_t* st,
                                          const WgradRowsArgs& a, int r0,
                                          int r1, int n0, int nbr, int lane,
                                          float (&acc)[NB][MB]) {
  using Io = WgIo<BF16>;
  using T = typename Io::T;
  constexpr int V = Io::V;
  constexpr int SW = 32 * V;
  constexpr int C = PF ? NB + 1 : NB;               // cache slots
  constexpr int WN = MB + V - 1;                    // the window
  constexpr int QR = (2 * V + MB - 2 + V - 1) / V;  // its chunks, any d
  const T* gm = reinterpret_cast<const T*>(st) + lane * V;
  const T* gh = reinterpret_cast<const T*>(st + a.gh_off) - SW + lane * V;
  const T* xl = reinterpret_cast<const T*>(st + a.x_off) + lane * V;
  const int xlast = a.rows + a.N - 2;  // the last staged x row
  float X[C][V];
#pragma unroll
  for (int k = 0; k < (PF ? NB : NB - 1); ++k)
    Io::load(xl + min(r0 + n0 + k, xlast) * SW, X[k], 0);
  float raw[QR * V];
  if constexpr (PF) load_window<Io, QR>(gm, gh, a.hw, r0, lane, raw);
  for (int t0 = r0; t0 < r1; t0 += C) {
#pragma unroll
    for (int tt = 0; tt < C; ++tt) {
      const int t = t0 + tt;
      if (t >= r1) break;
      if constexpr (PF) {
        float w[WN];
        shift_window<V, QR * V, WN>(raw, w, a.d);
        // row t + 1 in flight: its window, and its newest cache row (band
        // row NB - 1) into the slot this row does not read
        load_window<Io, QR>(gm, gh, a.hw, min(t + 1, a.rows - 1), lane, raw);
        Io::load(xl + min(t + n0 + NB, xlast) * SW, X[(tt + NB) % C], 0);
        band_fma<V, MB, NB, C>(acc, w, X, tt, nbr);
      } else {
        // the cache's newest row (band row NB - 1), then the window,
        // shifted in place
        Io::load(xl + min(t + n0 + NB - 1, xlast) * SW,
                 X[(tt + NB - 1) % C], 0);
        load_window<Io, QR>(gm, gh, a.hw, t, lane, raw);
        shift_window<V, QR * V, QR * V>(raw, raw, a.d);
        band_fma<V, MB, NB, C>(acc, raw, X, tt, nbr);
      }
    }
  }
}

// The fixed-order reduction of a block's sums into its partial `slot`
// (block k's of channel c: k + c): the lanes by a butterfly, then the row
// groups in warp order through `red` (warps x NB x MB floats); the sums
// start again from zero.
template <int NB, int MB>
__device__ __forceinline__ void flush_sums(const WgradRowsArgs& a,
                                           float (&acc)[NB][MB], float* red,
                                           int slot) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int k = 0; k < MB; ++k) {
      float v = acc[n][k];
      acc[n][k] = 0.f;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[(warp * NB + n) * MB + k] = v;
    }
  __syncthreads();
  for (int e = threadIdx.x; e < a.N * a.M; e += blockDim.x) {
    const int nn = e / a.M, m = e % a.M;
    int b = 0;
    while ((b + 1) * a.N / a.nbands <= nn) ++b;
    const int n = nn - b * a.N / a.nbands, k = a.M - 1 - m;
    float sum = 0.f;
    for (int r = 0; r < a.rgroups; ++r)
      sum += red[((r * a.nbands + b) * NB + n) * MB + k];
    a.part[(size_t)slot * a.pstride + nn * a.ld + m] = sum;
  }
  __syncthreads();  // red is free for the next flush
}

// RUN: a filter per image, each block a run of units flushed at every
// channel change; else one filter, the walk of stride G with no flush in
// the loop (a flush there, never taken, cost the wide instantiations up to
// 10 % on the card).
template <bool BF16, int MB, int NB, bool RUN>
__global__ void __launch_bounds__(wg_threads(MB), 1)
    wgrad_rows_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ WgradRowsArgs a) {
  constexpr int SW = 32 * WgIo<BF16>::V;
  extern __shared__ uint8_t smem_raw[];
  // the stages' barriers, then the ring, 128-byte aligned
  uint8_t* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint8_t* ring = base + 128;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_addr(&full[s]), 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  // This block's units. One filter: every G-th from blockIdx.x (the
  // blocks in flight cover a band of the image, whose halo rows and
  // columns they share through L2; a run of consecutive units was 11-22 %
  // slower on the card). A filter per image (RUN): a run of consecutive
  // units [u0, u1), block k's from k (rounds - 1) + min(k, rem), the first
  // rem blocks rounds of them and the others one fewer (rounds = ceil(units
  // / G)): it meets a run of channels, so it flushes rarely and the
  // partials number G + C - 1. The bound and the step are spelled out per
  // walk, so that with one filter the loop is the stride-G walk's own
  // (held at 128 registers, the narrow instantiations spill nothing).
  const int G = gridDim.x, blk = blockIdx.x;
  const int u0 = RUN ? blk * (a.rounds - 1) + min(blk, a.rem) : blk;
  const int u1 = RUN ? u0 + a.rounds - (blk < a.rem ? 0 : 1) : 0;
  if (tid == 0)
    for (int s = 0; s < a.stages; ++s) {
      const int u = u0 + s * (RUN ? 1 : G);
      if (u < (RUN ? u1 : a.units))
        issue_unit<SW, RUN>(&xmap, &gmap, &hmap, a, u,
                            ring + s * a.stage_bytes, smem_addr(&full[s]));
    }

  const int band = warp % a.nbands, rg = warp / a.nbands;
  const int n0 = band * a.N / a.nbands;
  const int nbr = (band + 1) * a.N / a.nbands - n0;
  float acc[NB][MB];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int k = 0; k < MB; ++k) acc[n][k] = 0.f;

  for (int u = u0, i = 0; u < (RUN ? u1 : a.units);
       u += (RUN ? 1 : G), ++i) {
    int ur = u;  // the unit within its channel's
    if constexpr (RUN) {
      ur = u % a.upc;
      if (ur == 0 && i > 0)  // a new channel: flush the last one's sums
        flush_sums<NB, MB>(a, acc,
                           reinterpret_cast<float*>(ring + a.red_off),
                           blk + u / a.upc - 1);
    }
    const int s = i % a.stages;
    uint8_t* st = ring + s * a.stage_bytes;
    const int oy0 = ((ur / a.strips) % a.chunks) * a.rows;
    const int T = min(a.rows, a.ho - oy0);
    const int r0 = rg * T / a.rgroups, r1 = (rg + 1) * T / a.rgroups;
    mbar_wait(smem_addr(&full[s]), (i / a.stages) & 1);
    if (r0 < r1)
      walk_rows<BF16, MB, NB, wg_wide(MB)>(st, a, r0, r1, n0, nbr, lane,
                                           acc);
    __syncthreads();  // every warp is done with the stage: refill it
    const int next = u + a.stages * (RUN ? 1 : G);
    if (tid == 0 && next < (RUN ? u1 : a.units))
      issue_unit<SW, RUN>(&xmap, &gmap, &hmap, a, next, st,
                          smem_addr(&full[s]));
  }
  // the last channel's sums: with a filter per image through their own
  // buffer, with one filter (channel 0) through the ring, free now (every
  // load issued was read)
  flush_sums<NB, MB>(a, acc,
                     reinterpret_cast<float*>(RUN ? ring + a.red_off : ring),
                     blk + (RUN ? (u1 - 1) / a.upc : 0));
}

using WgradFn = void (*)(CUtensorMap, CUtensorMap, CUtensorMap,
                         WgradRowsArgs);

// The instantiation of width bucket mb holding nb band rows, walking runs
// (a filter per image) or not, or null.
WgradFn pick_wgrad_f32(int mb, int nb, bool runs);
WgradFn pick_wgrad_bf16(int mb, int nb, bool runs);

}  // namespace ssam
