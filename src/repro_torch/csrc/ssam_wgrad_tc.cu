// K3 on Hopper, channel (NCHW) plans: the weight gradient as an implicit
// GEMM on the tensor cores, wgmma on tiles staged by TMA.
//
// Replaces src/repro/core/engine.py::_wgrad_dense_kernel (launched by
// run_weight_grad_plan, pallas_call at line 873) for plans with a channel
// axis. It computes, in fp32,
//
//   dW[co, ci, n, m] = sum_b sum_(oy, ox) g[b, co, oy, ox]
//                          * x[b, ci, sy*oy + n - ly, sx*ox + m - lx]
//
// with x zero outside the input. (sy, sx) = (1, 1) is the reference's dense
// form; a strided plan (Whisper's conv2, sx = 2) reads its cotangent as the
// forward produced it, so the reduction runs over the real positions only,
// never over a cotangent scattered onto the dense lattice.
//
// Design. A GEMM with M = C_out, N = C_in * taps (dW's columns) and
// K = B * Ho * Wo (the cotangent's positions). Both operands are K-major in
// device memory: a row g[b, co, oy, :] is contiguous in ox, and a tap's
// im2col row is a row of x read from an offset (at stride sx). A block of
// two warpgroups owns 128 output channels x 128 columns and walks K in
// k-blocks of 128 bytes of one (b, oy) row (32 fp32 or 64 bf16 positions):
//  * one thread loads each k-block with TMA into a ring of stages (3 or 4,
//    as shared memory allows), completion on an mbarrier per stage: the g
//    tile as one box of a 4-D map over (Wo, Ho, C_out, B), in the 128-byte
//    swizzle wgmma reads; and, per tap of the block's N tile, the ci-slab of
//    x rows the tap reaches, one box of a 4-D map over (W, H, C_in, B). The
//    N tile is ordered (tap, ci-slab), so each tap is one box. TMA fills
//    outside the tensor with zeros (negative coordinates included), so the
//    plan's padding is never stored and no border branch exists.
//  * TMA takes a box only at an innermost coordinate of a multiple of 16
//    bytes (anything else faults), and the card's driver refuses an element
//    stride on the innermost axis. So a tap's x box starts at its first
//    column, sx*ox0 + m - lx, rounded down to 16 bytes, and spans
//    sx*(kb - 1) columns and 16 bytes more; the pass that prepares each
//    stage for wgmma (below) reads position j at the tap's shift + sx*j in
//    it. A stride so reads every sx-th column in place, and the reduction
//    runs over the real positions only. Where that box would pass TMA's
//    256 columns, or leave shared memory for fewer than 3 stages, the
//    wrapper splits x into sx column phases instead (one pass over x; the
//    map's rows are then (row, phase) pairs), whose columns a tap reads
//    consecutively.
//  * each warpgroup runs wgmma m64n128 on its 64 channels against the whole
//    N tile, B (x) read from shared memory through a descriptor, A (g) from
//    registers in fp32 and through a descriptor in bf16.
//  * Filters of any size: the taps are cut into N tiles of at most 16 (128
//    columns of at least 8 channels), a block walks only its own tile's
//    taps, and a tap's box column, shift, row and phase are computed from
//    its index, the filter's width and the plan's lead (tc_tap), so no
//    table in the kernel's parameters bounds the filter (an earlier one
//    held 64 taps: AlexNet's 11 x 11 and a 9 x 9 raised).
//
// fp32 parity: 3xTF32 (ssam_tf32.cuh): each operand splits into big = a
// with the 13 bits TF32 drops cleared and small = a - big (exact), and
// each k8 step issues big*big, big*small and small*big. g (A) is read into
// registers as wgmma's A fragment and split there; x (B) is written, big
// and small, from the staged rows into two swizzled operand buffers. The
// operands of k-block i + 1 are prepared into a second pair of buffers
// while the tensor cores run k-block i. The tensor core's fp32 accumulation
// truncates, which over 12,000-24,000 positions per dW element would drift
// toward the tolerance, so each k-block runs into a fresh accumulator
// (scale-d = 0 on its first product) that is then added to a register sum
// with a round-to-nearest fp32 add. bf16 inputs run bf16 wgmma (k16): a
// product of two bf16 values is exact in fp32 (as it is in TF32, where
// their small part is 0), so one pass suffices; g is read as TMA staged
// it, x through the same gather.
//
// Determinism: no atomics. Where (C_out, N) tiles are too few for 132 SMs
// (conv2 has 4 x 12), K splits into slices that write partial tiles, and a
// second kernel adds them in slice order.
//
// Bound on an H100: conv2's dW needs 2*512*512*3*8*1500 = 18.87 GFLOP,
// 0.038 ms at 495 TFLOP/s of TF32 counted once (0.282 ms at the 67 TFLOP/s
// of fp32 outside the tensor cores), and moves 76.9 MB (0.023 ms): it is
// bound by operations. conv1's (5.90 GFLOP, 57.3 MB) is bound by bytes. The
// old kernel (ssam_wgrad.cu, kept for the single-channel layout) issued 4
// scalar and one broadcast shared load per 16 CUDA-core FMAs and was
// limited by shared-memory issue; here TMA moves the tiles without
// instructions and the tensor cores read them through descriptors. The
// three products per product make 0.114 ms the floor of this design on
// conv2. What it spends beyond that: shared-memory traffic (each product
// reads its B tile from shared memory, and the staging pass rewrites every
// x tile), and each block's fixed cost (ring fill, partial tile), which
// the wrapper weighs against wave quantisation when it splits K.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssam_hopper.cuh"
#include "ssam_tf32.cuh"

namespace ssam {

constexpr int kTcThreads = 256;          // two warpgroups
constexpr int kTcBM = 128;               // output channels per block
constexpr int kTcBN = 128;               // (tap, ci) columns per block
constexpr int kTcRow = 128;              // bytes of a k-block row: the swizzle
constexpr int kTcTile = kTcBM * kTcRow;  // bytes of one operand tile
constexpr int kTcMaxStages = 4;

struct WgradTcArgs {
  float* part;   // (slices, N tiles, cout, 128), or the output
  int cout, cin, taps, sy, ho;
  int m, ly, lx;               // the filter's columns; the plan's lead
  int xstep, xph;              // x column step; column phases of the x map
  int ci_tile, tpt, ci_tiles;  // channels per box, taps per N tile, slabs
  int kb, kb_per_row, kblocks;
  int box_w, stages, stage_bytes;  // x box columns; the ring
};

// Tap `tap` (row n, column m of the filter) as its x boxes read it: the
// box's first column offset (16-byte aligned, `align` elements), the tap's
// shift in the box, its row offset and its column phase
// (core/engine.py::wgrad_tc_tap). Computed from the tap's index, so no
// table bounds the filter's size.
struct TcTap {
  int col, shift, row, phase;
};

__device__ __forceinline__ TcTap tc_tap(const WgradTcArgs& a, int tap,
                                        int align) {
  const int n = tap / a.m, m = tap % a.m;
  // q, p = divmod(m - lx, xph), rounded toward minus infinity
  const int v = m - a.lx;
  const int q = (v >= 0 ? v : v - a.xph + 1) / a.xph, p = v - q * a.xph;
  const int s = ((q % align) + align) % align;
  return TcTap{q - s, s, n - a.ly, p};
}

// Issue the TMA loads of k-block kb (the g tile, then one x box per tap of
// the block's N tile) into the stage at dst, completing on bar.
__device__ __forceinline__ void issue_kblock(const CUtensorMap* gmap,
                                             const CUtensorMap* xmap,
                                             const WgradTcArgs& a, int kb,
                                             uint32_t dst, uint32_t bar,
                                             uint32_t tx_bytes, int co0,
                                             int c0, int tap0, int ntap,
                                             int es) {
  const int row = kb / a.kb_per_row;
  const int ox0 = (kb % a.kb_per_row) * a.kb;
  const int b = row / a.ho, oy = row % a.ho;
  mbar_expect_tx(bar, tx_bytes);
  tma_load_4d(dst, gmap, bar, ox0, oy, co0, b);
  for (int t = 0; t < ntap; ++t) {
    const TcTap tp = tc_tap(a, tap0 + t, 16 / es);
    tma_load_4d(dst + kTcTile + t * a.ci_tile * a.box_w * es, xmap, bar,
                a.xstep * ox0 + tp.col, (a.sy * oy + tp.row) * a.xph + tp.phase,
                c0, b);
  }
}

// Prepares the operands of the stage at st for wgmma, into op. The x
// operand's row r (tap t = r / ci_tile, its channel r % ci_tile), position
// j is the staged box's column row_shift[r] (tap t's shift) + xstep * j,
// and lands in the 128-byte swizzle (16-byte chunk j / per16 of the row at
// chunk (j / per16) ^ (r % 8)); consecutive threads take consecutive
// positions, so the stores do not conflict on banks (the loads only by
// the stride). For fp32 the x operand's small part goes beside it.
template <bool kBf16>
__device__ __forceinline__ void stage_operands(const WgradTcArgs& a,
                                               uint8_t* st, uint8_t* op,
                                               const int* row_shift,
                                               int xrows) {
  constexpr int es = kBf16 ? 2 : 4;
  constexpr int per16 = 16 / es;
  constexpr int kb = kTcRow / es;
  const uint8_t* xs = st + kTcTile;
  const int j = threadIdx.x % kb;  // this thread's position in every row
  for (int r = threadIdx.x / kb; r < xrows; r += kTcThreads / kb) {
    const int src = r * a.box_w + row_shift[r] + a.xstep * j;
    const int off =
        r * kTcRow + (((j / per16) ^ (r & 7)) * per16 + j % per16) * es;
    if constexpr (kBf16) {
      *reinterpret_cast<uint16_t*>(op + off) =
          reinterpret_cast<const uint16_t*>(xs)[src];
    } else {
      uint32_t hb, hs;
      split_tf32_trunc(reinterpret_cast<const uint32_t*>(xs)[src], hb, hs);
      *reinterpret_cast<uint32_t*>(op + off) = hb;
      *reinterpret_cast<uint32_t*>(op + kTcTile + off) = hs;
    }
  }
  // generic-proxy writes, read next by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <bool kBf16>
__global__ void __launch_bounds__(kTcThreads, 1)
    wgrad_tc_kernel(const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ WgradTcArgs a) {
  constexpr int es = kBf16 ? 2 : 4;  // bytes per element
  // the x operand (fp32: its big part, then its small part)
  constexpr int op_bytes = (kBf16 ? 1 : 2) * kTcTile;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ops = smem + a.stages * a.stage_bytes;  // two operand buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(ops + 2 * op_bytes);
  int* row_shift = reinterpret_cast<int*>(full + kTcMaxStages);  // per x row

  const int tid = threadIdx.x, wg = tid / 128;
  const int tg = blockIdx.x / a.ci_tiles;  // (tap group, ci slab) of N
  const int c0 = (blockIdx.x % a.ci_tiles) * a.ci_tile;
  const int tap0 = tg * a.tpt;
  const int ntap = min(a.tpt, a.taps - tap0);
  const int co0 = blockIdx.y * kTcBM;
  const int slice = blockIdx.z;
  const int kb_begin = (int)((long long)slice * a.kblocks / gridDim.z);
  const int kb_end = (int)((long long)(slice + 1) * a.kblocks / gridDim.z);
  const int nkb = kb_end - kb_begin;
  const int xrows = ntap * a.ci_tile;
  const uint32_t tx_bytes = kTcTile + xrows * a.box_w * es;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < kTcBN)
    row_shift[tid] =
        tid < xrows ? tc_tap(a, tap0 + tid / a.ci_tile, 16 / es).shift : 0;
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(a.stages, nkb); ++i)
      issue_kblock(&gmap, &xmap, a, kb_begin + i,
                   smem_addr(smem + i * a.stage_bytes), smem_addr(&full[i]),
                   tx_bytes, co0, c0, tap0, ntap, es);

  float acc[64], fresh[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = fresh[i] = 0.f;
  const uint32_t a_off = wg * 64 * kTcRow;  // this warpgroup's 64 channels
  const int warp = (tid % 128) / 32, lane = tid % 32;

  if (nkb > 0) {
    mbar_wait(smem_addr(&full[0]), 0);
    stage_operands<kBf16>(a, smem, ops, row_shift, xrows);
  }
  __syncthreads();
  for (int i = 0; i < nkb; ++i) {
    const int s = i % a.stages;
    uint8_t* st = smem + s * a.stage_bytes;
    uint8_t* op = ops + (i & 1) * op_bytes;
    const uint64_t db = desc_sw128(smem_addr(op));
    if constexpr (kBf16) {
      const uint64_t da = desc_sw128(smem_addr(st) + a_off);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_bf16(fresh, da + 2 * k, db + 2 * k, k);
    } else {
      // g's fragments, read from the swizzled tile and split in registers:
      // row 16w + l/4 (+8), k 8k + l%4 (+4), at chunk (k / 4) ^ (row % 8)
      const uint32_t* gt = reinterpret_cast<const uint32_t*>(st + a_off);
      const int row = 16 * warp + lane / 4, t = lane % 4;
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int r = row + 8 * (f & 1), chunk = 2 * k + (f >> 1);
          split_tf32_trunc(gt[r * 32 + ((chunk ^ (r & 7)) << 2) + t],
                           ab[k][f], as[k][f]);
        }
      const uint64_t sb = desc_sw128(smem_addr(op + kTcTile));
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_tf32_ra(fresh, ab[k], db + 2 * k, k);
        wgmma_tf32_ra(fresh, ab[k], sb + 2 * k, 1);
        wgmma_tf32_ra(fresh, as[k], db + 2 * k, 1);
      }
    }
    wgmma_commit();
    fence_acc(fresh);
    // while the tensor cores run k-block i, prepare k-block i + 1
    if (i + 1 < nkb) {
      const int s1 = (i + 1) % a.stages;
      mbar_wait(smem_addr(&full[s1]), ((i + 1) / a.stages) & 1);
      stage_operands<kBf16>(a, smem + s1 * a.stage_bytes,
                            ops + ((i + 1) & 1) * op_bytes, row_shift,
                            xrows);
    }
    wgmma_wait_all();
    fence_acc(fresh);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += fresh[j];
    __syncthreads();  // k-block i's stage and operands are read
    if (tid == 0 && i + a.stages < nkb) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_kblock(&gmap, &xmap, a, kb_begin + i + a.stages, smem_addr(st),
                   smem_addr(&full[s]), tx_bytes, co0, c0, tap0, ntap, es);
    }
  }

  // The accumulator of m64n128: thread (warp w, lane l) holds rows
  // 16w + l/4 (+8) and columns 8j + 2(l%4) (+1) in d[4j + 2*half + q].
  // A split reduction stores the tile as it is, (slice, N tile, co, col);
  // wgrad_tc_sum_kernel adds the slices and places the columns.
  const int cols = a.cin * a.taps;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
      const int col = 8 * j + 2 * (lane % 4);
      if (co >= a.cout) continue;
      if (gridDim.z > 1) {
        float* dst = a.part + (((size_t)slice * gridDim.x + blockIdx.x) *
                                   a.cout + co) * kTcBN + col;
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        continue;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = (col + q) / a.ci_tile, ci = c0 + (col + q) % a.ci_tile;
        if (t < ntap && ci < a.cin)
          a.part[(size_t)co * cols + ci * a.taps + tap0 + t] =
              acc[4 * j + 2 * h + q];
      }
    }
}

// dW[co, ci, tap] = the sum over slices, in slice order, of the partial
// tiles: column (tap, ci) lives in N tile (tap / tpt) * ci_tiles +
// ci / ci_tile at column (tap % tpt) * ci_tile + ci % ci_tile. One thread
// per partial column, so the reads are coalesced.
__global__ void wgrad_tc_sum_kernel(const float* part, float* out,
                                    int slices, int ntiles, int cout,
                                    int cin, int taps, int ci_tile, int tpt,
                                    int ci_tiles) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)ntiles * cout * kTcBN;
  if (e >= n) return;
  const int col = e % kTcBN, co = (e / kTcBN) % cout;
  const int nt = (int)(e / ((size_t)kTcBN * cout));
  const int t = col / ci_tile;
  const int tap = (nt / ci_tiles) * tpt + t;
  const int ci = (nt % ci_tiles) * ci_tile + col % ci_tile;
  if (t >= tpt || tap >= taps || ci >= cin) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[k * n + e];
  out[((size_t)co * cin + ci) * taps + tap] = s;
}

}  // namespace ssam

// Plain C entry of K3's channel path, loaded with ctypes. The filter has
// `taps` taps of `m` columns a row; (ly, lx) is the plan's lead. x is read
// through a 4-D map over (xw, xh, xc, xb) with rows x_pitch elements apart,
// in boxes of box_w columns of which every xstep-th is used; its rows are
// (row, phase) pairs for xph column phases. g is read through a 4-D map over (gw, gh, gc, gb) with rows
// g_pitch apart. part may equal out when the reduction is not split
// (gz == 1).
extern "C" int ssam_wgrad_tc_launch(
    const void* x, const void* g, int io_bf16, float* part, float* out,
    int xw, int xh, int xc, int xb, int x_pitch, int gw, int gh, int gc,
    int gb, int g_pitch, int cout, int cin, int taps, int m, int ly, int lx,
    int sy, int xstep, int xph, int ci_tile, int tpt, int ci_tiles,
    int kb_per_row, int kblocks, int box_w, int stages, int stage_bytes,
    int gx, int gy, int gz, int smem_bytes, void* stream) {
  using namespace ssam;
  const int es = io_bf16 ? 2 : 4;
  const int kb = kTcRow / es;
  if (taps < 1 || m < 1 || taps % m || ci_tile < 8 || ci_tile % 8 ||
      tpt < 1 || tpt * ci_tile > kTcBN || xstep < 1 || xph < 1 || gz < 1 ||
      kblocks < gz || box_w > 256 || (box_w * es) % 16 ||
      box_w < xstep * (kb - 1) + 16 / es ||
      stages < 2 || stages > kTcMaxStages || stage_bytes % 1024 ||
      stage_bytes < kTcTile + tpt * ci_tile * box_w * es ||
      gx != ci_tiles * ((taps + tpt - 1) / tpt) ||
      gy != (cout + kTcBM - 1) / kTcBM || (x_pitch * es) % 16 ||
      (g_pitch * es) % 16 || ((uintptr_t)x | (uintptr_t)g) % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType dt = io_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap gmap, xmap;
  const cuuint64_t gdim[4] = {(cuuint64_t)gw, (cuuint64_t)gh,
                              (cuuint64_t)gc, (cuuint64_t)gb};
  const cuuint64_t grow = (cuuint64_t)g_pitch * es;
  const cuuint64_t gstr[3] = {grow, grow * gh, grow * gh * gc};
  const cuuint32_t gbox[4] = {(cuuint32_t)kb, 1, kTcBM, 1};
  CUresult r = encode(&gmap, dt, 4, const_cast<void*>(g), gdim, gstr, gbox,
                      ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTmaError + (int)r;
  const cuuint64_t xdim[4] = {(cuuint64_t)xw, (cuuint64_t)xh,
                              (cuuint64_t)xc, (cuuint64_t)xb};
  const cuuint64_t xrow = (cuuint64_t)x_pitch * es;
  const cuuint64_t xstr[3] = {xrow, xrow * xh, xrow * xh * xc};
  const cuuint32_t xbox[4] = {(cuuint32_t)box_w, 1, (cuuint32_t)ci_tile, 1};
  r = encode(&xmap, dt, 4, const_cast<void*>(x), xdim, xstr, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kTmaError + (int)r;

  WgradTcArgs a;
  a.part = part;
  a.cout = cout;
  a.cin = cin;
  a.taps = taps;
  a.m = m;
  a.ly = ly;
  a.lx = lx;
  a.sy = sy;
  a.xstep = xstep;
  a.xph = xph;
  a.ho = gh;
  a.ci_tile = ci_tile;
  a.tpt = tpt;
  a.ci_tiles = ci_tiles;
  a.kb = kb;
  a.kb_per_row = kb_per_row;
  a.kblocks = kblocks;
  a.box_w = box_w;
  a.stages = stages;
  a.stage_bytes = stage_bytes;
  auto fn = io_bf16 ? wgrad_tc_kernel<true> : wgrad_tc_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  fn<<<dim3(gx, gy, gz), kTcThreads, smem_bytes,
       static_cast<cudaStream_t>(stream)>>>(gmap, xmap, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || gz == 1) return (int)e;
  const long long n = (long long)gx * cout * kTcBN;
  wgrad_tc_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      part, out, gz, gx, cout, cin, taps, ci_tile, tpt, ci_tiles);
  return (int)cudaGetLastError();
}
