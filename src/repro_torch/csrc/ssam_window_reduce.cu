// K1 on Hopper, channel-reduce path: NCHW windowed plans with an fp32
// reduction over the input channels, an output stride and a fused
// epilogue.
//
// Replaces src/repro/core/engine.py::_window_kernel for plans with
// reduce/out axes (conv2d_nchw_plan and its input adjoint): the reduce grid
// sweep with the VMEM accumulator (_accumulate_over_reduce), the strided
// read of _apply_plan_once, and _apply_epilogue_val at the flush.
//
//   out[b, co, oy, ox] = epi( sum_ci sum_taps
//                             x[b, ci, oy*sh + row - ly, ox*sw + col - lx]
//                             * w[co, ci, coeff] )
//
// with zeros where the read leaves the input (the plan's lead/trail
// padding is never materialised).
//
// Design:
//  * One block of 8 warps owns 32 output channels x 1 output row x 128
//    output columns. Warp k holds channels 4k..4k+3; lane l holds columns
//    l, l+32, l+64, l+96; each thread keeps its 16 sums in fp32 registers
//    for the whole reduction. Hopper blocks run in no set order, so the
//    C_in sweep is a loop inside the block, not a grid axis, and no float
//    atomics are used: every sum is taken in one order (ci ascending, taps
//    in plan order).
//  * Per pass, ci_t input channels are staged in shared memory: the input
//    rows the taps reach ((127*sw + M) columns each, zero outside the
//    domain) and the filter values w[co0..co0+31, ci, tap] laid out
//    channel-minor, so a warp reads its 4 channels' coefficients as one
//    broadcast float4.
//  * Taps read the staged rows directly at (lane + 32j)*sw + col: a strided
//    plan computes only the kept lanes, as the reference's strided read
//    does. Every staged value is reused by the 32 output channels of the
//    block, which is the reuse a channel-mixing plan offers; the warp
//    shuffle schedule of the single-channel path (ssam_window.cuh) pays
//    off where taps are many and channels one.
//  * The epilogue (bias per out channel, tanh-GELU, SiLU, ReLU, scale) is
//    applied once to the summed value, then the output is stored.
//
// Bound on an H100: the Whisper stem's plans do 2*C_in*taps FMAs per
// output (C_in = 80 or 512, 3 taps) over inputs of a few tens of MB, so
// they are bound by fp32 operations (67 TFLOP/s), not bytes. Per tap and
// staged channel a warp issues 4 shared loads and one broadcast float4
// load for 16 FMAs, so shared-memory issue, not the FMA pipe, is the limit
// of this simple version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssam_epilogue.cuh"

namespace ssam {

constexpr int kRThreads = 256;
constexpr int kRCoTile = 32;   // output channels per block
constexpr int kRCoWarp = 4;    // output channels per thread
constexpr int kRColsLane = 4;  // output columns per thread
constexpr int kRCols = 128;    // output columns per block

struct ReduceArgs {
  const void* x;        // (batch, cr, hin, win), fp32 or bf16
  void* out;            // (batch, co, ho, wo), x's dtype
  int io_bf16;
  const float* w;       // (co, cr, fsz) fp32
  const int* taps;      // ntaps (row, col, coeff) triples, plan order
  int ntaps;
  const float* bias;    // co values, or null
  int epi_op[kMaxEpi];  // 1 bias, 2 gelu (tanh), 3 silu, 4 relu, 5 scale
  float epi_val[kMaxEpi];
  int n_epi;
  int batch, cr, co, hin, win, ho, wo;
  int ly, lx, sh, sw;
  int fsz, rows, M;     // filter slice size N*M, plan rows N, plan columns M
  int ci_t;             // input channels staged per pass
};

__device__ __forceinline__ float load_in(const ReduceArgs& a, size_t i) {
  return a.io_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[i])
             : static_cast<const float*>(a.x)[i];
}

__global__ void __launch_bounds__(kRThreads) window_reduce_kernel(ReduceArgs a) {
  extern __shared__ float smem[];
  int* tap = reinterpret_cast<int*>(smem);
  float* ws = smem + ((3 * a.ntaps + 3) & ~3);
  float* xs = ws + a.ci_t * a.ntaps * kRCoTile;
  const int span = (kRCols - 1) * a.sw + a.M;

  const int co_tiles = (a.co + kRCoTile - 1) / kRCoTile;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * kRCoTile;
  const int oy = blockIdx.y;
  const int ox0 = blockIdx.x * kRCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int iy0 = oy * a.sh - a.ly;
  const int ix0 = ox0 * a.sw - a.lx;

  for (int i = threadIdx.x; i < 3 * a.ntaps; i += kRThreads) tap[i] = a.taps[i];

  float acc[kRCoWarp][kRColsLane];
#pragma unroll
  for (int k = 0; k < kRCoWarp; ++k)
#pragma unroll
    for (int j = 0; j < kRColsLane; ++j) acc[k][j] = 0.f;

  for (int c0 = 0; c0 < a.cr; c0 += a.ci_t) {
    const int nc = min(a.ci_t, a.cr - c0);
    __syncthreads();  // the tap table is in; the last pass is read
    for (int i = threadIdx.x; i < nc * a.ntaps * kRCoTile; i += kRThreads) {
      const int k = i % kRCoTile;
      const int t = (i / kRCoTile) % a.ntaps;
      const int c = i / (kRCoTile * a.ntaps);
      const int co = co0 + k;
      ws[i] = co < a.co
                  ? a.w[((size_t)co * a.cr + c0 + c) * a.fsz + tap[3 * t + 2]]
                  : 0.f;
    }
    for (int row = warp; row < nc * a.rows; row += kRThreads / 32) {
      const int c = row / a.rows, r = row % a.rows;
      const int gy = iy0 + r;
      const bool in = gy >= 0 && gy < a.hin;
      const size_t base =
          (((size_t)b * a.cr + c0 + c) * a.hin + (in ? gy : 0)) * a.win;
      for (int j = lane; j < span; j += 32) {
        const int gx = ix0 + j;
        xs[row * span + j] =
            (in && gx >= 0 && gx < a.win) ? load_in(a, base + gx) : 0.f;
      }
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      for (int t = 0; t < a.ntaps; ++t) {
        const float4 wv = *reinterpret_cast<const float4*>(
            &ws[(c * a.ntaps + t) * kRCoTile + warp * kRCoWarp]);
        const float* xr = xs + (c * a.rows + tap[3 * t]) * span + tap[3 * t + 1];
        float xv[kRColsLane];
#pragma unroll
        for (int j = 0; j < kRColsLane; ++j) xv[j] = xr[(lane + 32 * j) * a.sw];
#pragma unroll
        for (int j = 0; j < kRColsLane; ++j) {
          acc[0][j] = fmaf(xv[j], wv.x, acc[0][j]);
          acc[1][j] = fmaf(xv[j], wv.y, acc[1][j]);
          acc[2][j] = fmaf(xv[j], wv.z, acc[2][j]);
          acc[3][j] = fmaf(xv[j], wv.w, acc[3][j]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kRCoWarp; ++k) {
    const int co = co0 + warp * kRCoWarp + k;
    if (co >= a.co) continue;
    const size_t obase = (((size_t)b * a.co + co) * a.ho + oy) * a.wo;
#pragma unroll
    for (int j = 0; j < kRColsLane; ++j) {
      const int ox = ox0 + lane + 32 * j;
      if (ox >= a.wo) continue;
      const float v =
          apply_epilogue(a.epi_op, a.epi_val, a.n_epi, a.bias, acc[k][j], co);
      if (a.io_bf16)
        static_cast<__nv_bfloat16*>(a.out)[obase + ox] = __float2bfloat16(v);
      else
        static_cast<float*>(a.out)[obase + ox] = v;
    }
  }
}

}  // namespace ssam

// Plain C entry of K1's channel-reduce path, loaded with ctypes. epi_ops
// and epi_vals are host arrays of kMaxEpi entries.
extern "C" int ssam_window_reduce_launch(
    const void* x, void* out, int io_bf16, const float* w, const int* taps,
    int ntaps, const float* bias, const int* epi_ops, const float* epi_vals,
    int n_epi, int batch, int cr, int co, int hin, int win, int ho, int wo,
    int ly, int lx, int sh, int sw, int fsz, int rows, int M, int ci_t,
    int smem_bytes, void* stream) {
  if (ntaps < 1 || n_epi < 0 || n_epi > ssam::kMaxEpi || ci_t < 1 || sh < 1 ||
      sw < 1 || ho < 1 || wo < 1 || ho > 65535)
    return (int)cudaErrorInvalidValue;
  ssam::ReduceArgs a;
  a.x = x;
  a.out = out;
  a.io_bf16 = io_bf16;
  a.w = w;
  a.taps = taps;
  a.ntaps = ntaps;
  a.bias = bias;
  for (int s = 0; s < ssam::kMaxEpi; ++s) {
    a.epi_op[s] = s < n_epi ? epi_ops[s] : 0;
    a.epi_val[s] = s < n_epi ? epi_vals[s] : 0.f;
    if (a.epi_op[s] == 1 && bias == nullptr) return (int)cudaErrorInvalidValue;
  }
  a.n_epi = n_epi;
  a.batch = batch;
  a.cr = cr;
  a.co = co;
  a.hin = hin;
  a.win = win;
  a.ho = ho;
  a.wo = wo;
  a.ly = ly;
  a.lx = lx;
  a.sh = sh;
  a.sw = sw;
  a.fsz = fsz;
  a.rows = rows;
  a.M = M;
  a.ci_t = ci_t;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssam::window_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int co_tiles = (co + ssam::kRCoTile - 1) / ssam::kRCoTile;
  dim3 grid((wo + ssam::kRCols - 1) / ssam::kRCols, ho, batch * co_tiles);
  ssam::window_reduce_kernel<<<grid, ssam::kRThreads, smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
