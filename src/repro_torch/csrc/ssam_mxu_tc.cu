// K2 on Hopper, channel-reduce path: NCHW windowed plans under
// strategy="mxu" as an implicit GEMM on the tensor cores, wgmma fed by
// TMA, and the input adjoint of a strided plan, all its output phases in
// one launch.
//
// Replaces src/repro/core/engine.py::_apply_plan_mxu (the strategy="mxu"
// body of _window_kernel, pallas_call at line 587) for plans with
// reduce/out axes: im2row over the tap set contracted with the filter,
// fp32 accumulation, the epilogue at the flush. It computes
//
//   out[b, co, oy*osh + py, ox*osw + px] = epi( sum_ci sum_taps
//       w[co, ci, coeff] * x[b, ci, oy*sh + dr, ox*sw + dc] )
//
// over one phase's taps (dr, dc, coeff), with x zero outside the input (the
// plan's padding is never stored). A forward is one phase: (dr, dc) =
// (row - ly, col - lx), output stride 1. A strided plan's dx is one phase
// per output phase (core/adjoint.strided_input_adjoint_phases), read at
// stride 1 from the cotangent as the forward produced it and written at
// the plan's stride: no scattered cotangent, no inserted zero multiplied.
// A phase no tap reaches writes zeros.
//
// Design. A GEMM with M = output positions, N = C_out and K = C_in x taps.
// A block of two warpgroups owns 128 positions of one output row (b, oy) of
// one phase x 128 channels, 64 positions each. K runs in k-blocks of 32
// input channels of one tap, ordered (channel slab, tap):
//  * the filter, laid out by the wrapper as (C_out, k-blocks x 32), is
//    K-major: one TMA box (32 x 128 channels, 128-byte swizzle) per k-block
//    is wgmma's B tile as it lands. Its 3xTF32 split is written once per
//    k-block: big (the 13 low mantissa bits cleared) in place, small =
//    w - big into a second swizzled buffer (double buffered).
//  * x's rows stay as they are in device memory: one TMA box per channel
//    slab holds the rows all the phase's taps reach for 32 channels, over
//    the 128 positions' span (x viewed as (16 bytes, chunks, H, C, B), so
//    every box starts at a 16-byte boundary and spans up to 1024 fp32
//    columns); each tap of the slab reads it. Where such a stage would not
//    fit, a box per k-block holds that tap's row only.
//  * A, the im2row operand, is never materialised: each thread gathers its
//    wgmma A fragment (positions g and g + 8 of its warp's 16, channels
//    t and t + 4 of each k8 step) straight from the staged rows into
//    registers, at offset tap + position*sw + the box's alignment shift,
//    and splits it there. bf16 x is exact in TF32, so its small part is 0
//    and that product is skipped: two products, against the fp32 filter
//    (a bf16 wgmma would round the filter to bf16). The tap shift and the
//    stride are
//    addresses, so there is no rewrite pass and no copy per tap. The
//    staged row length is padded so the channel pitch is 8 words mod 32:
//    a fragment load is free of bank conflicts at stride 1, two-way at
//    stride 2 (every other word is read).
//  * each warpgroup runs wgmma m64n128k8 (A from registers, B through a
//    descriptor) big*big, big*small, small*big per k8 step into a fresh
//    accumulator per k-block, added to a register sum with a
//    round-to-nearest fp32 add (the tensor core's own accumulation
//    truncates; the stem sums 1536 products). While the tensor cores run
//    k-block i, the threads split k-block i + 1's filter tile.
//  * two rings on mbarriers: filter tiles (2-4 stages) and x slabs (1-2
//    stages), refilled by one thread as stages free up. No atomics, no
//    split of K across blocks: two calls give equal bits.
//  * the flush stages the fp32 tile through shared memory; the epilogue
//    (ssam_epilogue.cuh; a residual read at the output's position) runs
//    over it a stage at a time, one op a loop, and
//    rows of consecutive positions are stored. Applied per element
//    straight from the accumulator (64 unrolled copies of the op switch),
//    it cost more than the forward's whole reduction over 512 channels
//    (paired calls on the card).
//
// Bound on an H100: conv2 of the Whisper stem (8,512,1,3000) -> stride 2
// needs 2*512*512*3*8*1500 = 18.87 GFLOP: 0.038 ms at 495 TFLOP/s of TF32
// counted once, 0.114 ms for the three products of the split, 0.282 ms at
// the 67 TFLOP/s of fp32; its dx by phases the same. conv1 (5.90 GFLOP,
// 57.3 MB) is bound by bytes, 0.017 ms.
// What holds it: conv2 takes about three times the floor of its three
// products (PERF.md section 6). Per k-block shared memory serves wgmma's B
// reads (96 KB), the split (48 KB) and the gather, and the block waits for
// its products before it folds them; gathering k-block i + 1's fragments
// in the shadow of k-block i's products (a second fragment set, 229
// registers) was slower in paired calls on the card. conv1's 9 k-blocks
// a block leave each block's fixed cost (ring fill, flush) large against
// its work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssam_epilogue.cuh"
#include "ssam_hopper.cuh"
#include "ssam_tf32.cuh"

namespace ssam {

constexpr int kMtThreads = 256;   // two warpgroups
constexpr int kMtPos = 64;        // positions of one warpgroup (wgmma M)
constexpr int kMtCo = 128;        // channels of one warpgroup (wgmma N)
constexpr int kMtKb = 32;         // k-block: 32 input channels of one tap
constexpr int kMtRow = 128;       // bytes of a filter row of one k-block
constexpr int kMtMaxBStages = 4;
constexpr int kMtMaxXStages = 2;
constexpr int kMtPhaseInts = 8;   // a phase's header in the table

struct MxuTcArgs {
  void* out;            // (batch, co, hout, wout), x's dtype
  const float* bias;    // co values, or null
  const void* resid;    // the residual (out's dtype and layout), or null
  const int* table;     // phase headers, then per tap (x row, x offset)
  int epi_op[kMaxEpi];  // 1 bias, 2 gelu (tanh), 3 silu, 4 relu, 5 scale,
                        // 6 residual
  float epi_val[kMaxEpi];
  int n_epi;
  int co, hout, wout;
  int sh, sw, osh, osw;   // read and output strides
  int nphases, co_tiles, slabs;
  int per16;              // elements in 16 bytes
  int row_len, rows;      // staged row length and rows per channel
  int x_per_kblock;       // 1: an x box per k-block (the tap's row only)
  int b_stages, x_stages, b_bytes, x_bytes, x_box_bytes;
  int body_bytes;         // the rings, at least the output tile
};

// The filter tile of one k-block, split for 3xTF32: big in place, small
// beside it (same offsets, so the same swizzle). 16 bytes a thread a step.
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* small,
                                           int bytes) {
  for (int o = threadIdx.x * 16; o < bytes; o += kMtThreads * 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(tile + o);
    uint4 hb, hs;
    split_tf32_trunc(v.x, hb.x, hs.x);
    split_tf32_trunc(v.y, hb.y, hs.y);
    split_tf32_trunc(v.z, hb.z, hs.z);
    split_tf32_trunc(v.w, hb.w, hs.w);
    *reinterpret_cast<uint4*>(tile + o) = hb;
    *reinterpret_cast<uint4*>(small + o) = hs;
  }
  fence_proxy_async();  // read next by wgmma (the async proxy)
}

__device__ __forceinline__ void fence_frag(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int f = 0; f < 4; ++f) asm volatile("" : "+r"(r[k][f])::"memory");
}

// One epilogue op over the staged output tile (channel-major, pitch
// 2 * kMtPos + 4), the op a compile-time constant.
template <int Op>
__device__ __forceinline__ void tile_op(float* tile, int nel, float val,
                                        const float* bias, int co0) {
  constexpr int kPos = 2 * kMtPos;
#pragma unroll 4
  for (int i = threadIdx.x; i < nel; i += kMtThreads) {
    float* t = tile + (i / kPos) * (kPos + 4) + i % kPos;
    *t = apply_epilogue_op(Op, val, bias, *t, co0 + i / kPos);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kMtThreads, 1)
    mxu_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ MxuTcArgs a) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the rings to it
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* bring = smem;                               // filter tiles
  uint8_t* small = bring + a.b_stages * a.b_bytes;     // their small parts
  uint8_t* xring = small + 2 * a.b_bytes;              // x slabs
  // the barriers follow the rings, or the output tile where that is larger
  uint64_t* bfull = reinterpret_cast<uint64_t*>(smem + a.body_bytes);
  uint64_t* xfull = bfull + kMtMaxBStages;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int ph_i = blockIdx.z % a.nphases;
  const int zr = blockIdx.z / a.nphases;
  const int co_t = zr % a.co_tiles, b = zr / a.co_tiles;
  const int oy = blockIdx.y;
  const int ox0 = blockIdx.x * 2 * kMtPos;
  const int* ph = a.table + ph_i * kMtPhaseInts;
  const int py = ph[0], px = ph[1], hq = ph[2], wq = ph[3];
  const int ntaps = ph[4], dcmin = ph[5], kb_base = ph[6];
  const int* taps = a.table + ph[7];   // per tap: x row offset, x offset
  if (oy >= hq || ox0 >= wq) return;   // a smaller phase's spare blocks
  const int co0 = co_t * kMtCo;
  const int pos0 = wg * kMtPos;   // this warpgroup's positions

  const int nkb = ntaps * a.slabs;
  const int xg = a.x_per_kblock ? 1 : ntaps;   // k-blocks per x stage
  const int nxu = ntaps ? nkb / xg : 0;
  // the x box starts at the 16-byte chunk at or below the first column read
  const int col0 = ox0 * a.sw + dcmin;
  const int c0 = col0 >= 0 ? col0 / a.per16
                           : -((a.per16 - 1 - col0) / a.per16);
  const int shift = col0 - c0 * a.per16;

  auto issue_b = [&](int j) {
    const int s = j % a.b_stages;
    const uint32_t bar = smem_addr(&bfull[s]);
    mbar_expect_tx(bar, a.b_bytes);
    tma_load_2d(smem_addr(bring + s * a.b_bytes), &wmap, bar,
                (kb_base + j) * kMtKb, co0);
  };
  auto issue_x = [&](int u) {
    const int s = u % a.x_stages;
    const int j0 = u * xg;
    const uint32_t bar = smem_addr(&xfull[s]);
    mbar_expect_tx(bar, a.x_box_bytes);
    tma_load_5d(smem_addr(xring + s * a.x_bytes), &xmap, bar, 0, c0,
                oy * a.sh + taps[2 * (j0 % ntaps)], (j0 / ntaps) * kMtKb, b);
  };

  if (tid == 0) {
    for (int s = 0; s < a.b_stages; ++s) mbar_init(smem_addr(&bfull[s]), 1);
    for (int s = 0; s < a.x_stages; ++s) mbar_init(smem_addr(&xfull[s]), 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < min(a.b_stages, nkb); ++j) issue_b(j);
    for (int u = 0; u < min(a.x_stages, nxu); ++u) issue_x(u);
  }

  float acc[64], fresh[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = fresh[i] = 0.f;
  // This thread's A fragment: rows (positions) prow and prow + 8, columns
  // (channels of the k-block) t4 and t4 + 4 of each k8 step.
  const int g = lane >> 2, t4 = lane & 3;
  const int pitch = a.rows * a.row_len;        // channel pitch (elements)
  const int prow = pos0 + 16 * warp + g;
  const int tbase = t4 * pitch + prow * a.sw + shift;

  if (nkb > 0) {
    mbar_wait(smem_addr(&bfull[0]), 0);
    split_tile(bring, small, a.b_bytes);
  }
  __syncthreads();
  for (int j = 0; j < nkb; ++j) {
    const int u = j / xg;
    const int xs_i = u % a.x_stages;
    if (j % xg == 0) mbar_wait(smem_addr(&xfull[xs_i]), (u / a.x_stages) & 1);
    const uint8_t* xs = xring + xs_i * a.x_bytes;
    const int base = tbase + taps[2 * (j % ntaps) + 1];
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int e =
            base + (8 * k + 4 * (f >> 1)) * pitch + 8 * (f & 1) * a.sw;
        if constexpr (kBf16) {
          ab[k][f] = (uint32_t)reinterpret_cast<const uint16_t*>(xs)[e] << 16;
          as[k][f] = 0u;
        } else {
          split_tf32_trunc(reinterpret_cast<const uint32_t*>(xs)[e], ab[k][f],
                           as[k][f]);
        }
      }
    const uint64_t db =
        desc_sw128(smem_addr(bring + (j % a.b_stages) * a.b_bytes));
    const uint64_t ds = desc_sw128(smem_addr(small + (j & 1) * a.b_bytes));
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_tf32_ra(fresh, ab[k], db + 2 * k, k);
      wgmma_tf32_ra(fresh, ab[k], ds + 2 * k, 1);
      if constexpr (!kBf16) wgmma_tf32_ra(fresh, as[k], db + 2 * k, 1);
    }
    wgmma_commit();
    fence_acc(fresh);
    // while the tensor cores run k-block j, split k-block j + 1's filter
    if (j + 1 < nkb) {
      const int s1 = (j + 1) % a.b_stages;
      mbar_wait(smem_addr(&bfull[s1]), ((j + 1) / a.b_stages) & 1);
      split_tile(bring + s1 * a.b_bytes, small + ((j + 1) & 1) * a.b_bytes,
                 a.b_bytes);
    }
    wgmma_wait_all();
    fence_acc(fresh);
    fence_frag(ab);  // the fragments stay in their registers until here
    fence_frag(as);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += fresh[i];
    __syncthreads();  // k-block j's stages are read
    if (tid == 0) {
      if (j + a.b_stages < nkb) {
        fence_proxy_async();
        issue_b(j + a.b_stages);
      }
      if ((j + 1) % xg == 0 && u + a.x_stages < nxu) {
        fence_proxy_async();
        issue_x(u + a.x_stages);
      }
    }
  }

  // The flush. The accumulator of m64n128: thread (warp w, lane l) holds
  // rows (positions) 16w + l/4 (+8) and columns (channels) 8j + 2(l%4)
  // (+1) in acc[4j + 2h + q]. The tile goes through shared memory (every
  // load of the rings has been consumed), channel-major at a pitch of 4
  // words mod 32, so the lanes of one register write 32 banks; then the
  // epilogue runs over it a stage at a time and the rows of consecutive
  // positions are stored (128 bytes a warp at output stride 1).
  constexpr int kPos = 2 * kMtPos;   // positions a block
  constexpr int cpitch = kPos + 4;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        tile[(8 * jj + 2 * t4 + q) * cpitch + prow + 8 * h] =
            acc[4 * jj + 2 * h + q];
  __syncthreads();
  const int orow = oy * a.osh + py;
  const int npos = min(kPos, wq - ox0);
  // the tile's channels that exist, by positions
  const int nel = min(kMtCo, a.co - co0) * kPos;
  // the epilogue a stage at a time (one op, a compile-time constant, for
  // the whole loop), each thread on the elements it stores
#pragma unroll 1
  for (int s = 0; s < a.n_epi; ++s) {
    const float val = a.epi_val[s];
    switch (a.epi_op[s]) {
      case 1: tile_op<1>(tile, nel, val, a.bias, co0); break;
      case 2: tile_op<2>(tile, nel, val, a.bias, co0); break;
      case 3: tile_op<3>(tile, nel, val, a.bias, co0); break;
      case 4: tile_op<4>(tile, nel, val, a.bias, co0); break;
      case 5: tile_op<5>(tile, nel, val, a.bias, co0); break;
      case 6:  // the residual at each output's position, four a thread
#pragma unroll 4
        for (int i = 4 * tid; i < nel; i += 4 * kMtThreads) {
          const int c = i / kPos, p = i % kPos;
          if (p >= npos) continue;
          const size_t at =
              (((size_t)b * a.co + co0 + c) * a.hout + orow) * a.wout +
              (size_t)(ox0 + p) * a.osw + px;
          float r[4];
          if (a.osw == 1) {
            load_residual4(a.resid, kBf16, at, min(4, npos - p), r);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              r[k] = p + k < npos
                         ? load_residual(a.resid, kBf16,
                                         at + (size_t)k * a.osw)
                         : 0.f;
          }
          float* t = tile + c * cpitch + p;
#pragma unroll
          for (int k = 0; k < 4; ++k) t[k] += r[k];
        }
        break;
    }
  }
#pragma unroll 4
  for (int i = tid; i < nel; i += kMtThreads) {
    const int c = i / kPos, p = i % kPos;
    if (p >= npos) continue;
    const float v = tile[c * cpitch + p];
    const size_t at =
        (((size_t)b * a.co + co0 + c) * a.hout + orow) * a.wout +
        (size_t)(ox0 + p) * a.osw + px;
    if constexpr (kBf16)
      static_cast<__nv_bfloat16*>(a.out)[at] = __float2bfloat16(v);
    else
      static_cast<float*>(a.out)[at] = v;
  }
}

}  // namespace ssam

// Plain C entry of K2's channel-reduce path, loaded with ctypes. x is read
// through a 5-D map over (16 bytes, x_pitch / per16 chunks, xh, xc, xb):
// its rows x_pitch elements apart, zero past the input's width. The filter
// wb is (co, ktot) fp32, k-blocks of 32 columns in the table's order. The
// geometry (tile, stages, row length, the grid's x and y) is
// core/engine.py's mxu_tc_layout; epi_ops and epi_vals are host arrays of
// kMaxEpi entries.
extern "C" int ssam_mxu_tc_launch(
    const void* x, void* out, int io_bf16, const float* wb, const int* table,
    const float* bias, const void* resid, const int* epi_ops,
    const float* epi_vals, int n_epi, int xh, int xc, int xb, int x_pitch, int ktot, int co, int hout,
    int wout, int sh, int sw, int osh, int osw, int nphases, int co_tiles,
    int slabs, int row_len, int rows, int x_per_kblock,
    int b_stages, int x_stages, int x_bytes, int grid_x, int grid_y,
    int smem_bytes, void* stream) {
  using namespace ssam;
  const int es = io_bf16 ? 2 : 4;
  const int per16 = 16 / es;
  const int b_bytes = kMtCo * kMtRow;
  const int x_box_bytes = row_len * es * rows * kMtKb;
  const long long grid_z = (long long)xb * co_tiles * nphases;
  // the flush stages the block's output tile where the rings were
  const int tile_bytes = 4 * kMtCo * (2 * kMtPos + 4);
  const int body_bytes =
      max((b_stages + 2) * b_bytes + x_stages * x_bytes, tile_bytes);
  if (n_epi < 0 || n_epi > kMaxEpi || sh < 1 || sw < 1 || osh < 1 ||
      osw < 1 || hout < 1 || wout < 1 || nphases < 1 || slabs < 1 ||
      co_tiles != (co + kMtCo - 1) / kMtCo || x_pitch % per16 ||
      row_len % per16 || row_len / per16 > 256 || rows < 1 || rows > 256 ||
      ktot % kMtKb || b_stages < 2 || b_stages > kMtMaxBStages ||
      x_stages < 1 || x_stages > kMtMaxXStages || x_bytes % 1024 ||
      x_bytes < x_box_bytes || grid_y > 65535 || grid_z > 65535 ||
      smem_bytes < 1024 + body_bytes + 8 * (kMtMaxBStages + kMtMaxXStages) ||
      ((uintptr_t)x | (uintptr_t)wb) % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUtensorMap xmap, wmap;
  const cuuint64_t xrow = (cuuint64_t)x_pitch * es;
  const cuuint64_t xdim[5] = {(cuuint64_t)per16, (cuuint64_t)(x_pitch / per16),
                              (cuuint64_t)xh, (cuuint64_t)xc, (cuuint64_t)xb};
  const cuuint64_t xstr[4] = {16, xrow, xrow * xh, xrow * xh * xc};
  const cuuint32_t xbox[5] = {(cuuint32_t)per16, (cuuint32_t)(row_len / per16),
                              (cuuint32_t)rows, (cuuint32_t)kMtKb, 1};
  CUresult r = encode(
      &xmap, io_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      5, const_cast<void*>(x), xdim, xstr, xbox, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTmaError + (int)r;
  const cuuint64_t wdim[2] = {(cuuint64_t)ktot, (cuuint64_t)co};
  const cuuint64_t wstr[1] = {(cuuint64_t)ktot * 4};
  const cuuint32_t wbox[2] = {(cuuint32_t)kMtKb, (cuuint32_t)kMtCo};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(wb), wdim, wstr, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTmaError + (int)r;

  MxuTcArgs a;
  a.out = out;
  a.bias = bias;
  a.resid = resid;
  a.table = table;
  for (int s = 0; s < kMaxEpi; ++s) {
    a.epi_op[s] = s < n_epi ? epi_ops[s] : 0;
    a.epi_val[s] = s < n_epi ? epi_vals[s] : 0.f;
    if ((a.epi_op[s] == 1 && bias == nullptr) ||
        (a.epi_op[s] == 6 && resid == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  a.n_epi = n_epi;
  a.co = co;
  a.hout = hout;
  a.wout = wout;
  a.sh = sh;
  a.sw = sw;
  a.osh = osh;
  a.osw = osw;
  a.nphases = nphases;
  a.co_tiles = co_tiles;
  a.slabs = slabs;
  a.per16 = per16;
  a.row_len = row_len;
  a.rows = rows;
  a.x_per_kblock = x_per_kblock;
  a.b_stages = b_stages;
  a.x_stages = x_stages;
  a.b_bytes = b_bytes;
  a.x_bytes = x_bytes;
  a.x_box_bytes = x_box_bytes;
  a.body_bytes = body_bytes;
  auto fn = io_bf16 ? mxu_tc_kernel<true> : mxu_tc_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  fn<<<dim3(grid_x, grid_y, (unsigned)grid_z), kMtThreads, smem_bytes,
       static_cast<cudaStream_t>(stream)>>>(xmap, wmap, a);
  return (int)cudaGetLastError();
}
