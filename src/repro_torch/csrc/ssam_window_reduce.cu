// K1 on Hopper, channel-reduce path: NCHW windowed plans with an fp32
// reduction over the input channels, an output stride and a fused
// epilogue, and the input adjoint of a strided plan, all its output phases
// in one launch.
//
// Replaces src/repro/core/engine.py::_window_kernel for plans with
// reduce/out axes (conv2d_nchw_plan and its input adjoint): the reduce grid
// sweep with the VMEM accumulator (_accumulate_over_reduce), the strided
// read of _apply_plan_once, and _apply_epilogue_val at the flush.
//
//   out[b, co, oy*osh + py, ox*osw + px] = epi( sum_ci sum_taps
//       x[b, ci, oy*sh + dr, ox*sw + dc] * w[co, ci, coeff] )
//
// over one phase's taps (dr, dc, coeff), with zeros where the read leaves
// the input (the plan's lead/trail padding is never materialised). A
// forward is one phase: (dr, dc) = (row - ly, col - lx), output stride 1.
// A strided plan's dx is sh*sw phases read at stride 1 from the cotangent
// and written at the plan's stride (core/adjoint.strided_input_adjoint_
// phases): each output phase takes only the taps that reach it, so no
// cotangent is scattered and no inserted zero is multiplied. A phase that
// no tap reaches writes zeros.
//
// Bound on an H100: the Whisper stem's plans do 2*C_in*taps flops per
// output (C_in = 80 or 512, 3 taps) over a few tens of MB, so they are
// bound by fp32 operations (67 TFLOP/s: 0.282 ms for conv2, 0.088 ms for
// conv1), not bytes (0.023 ms). K1 is the paper's lanes strategy and stays
// on the CUDA cores in fp32 (the tensor-core design is K2's). To reach the
// FMA pipe, shared-memory traffic per FMA has to be small:
//  * Implicit GEMM, register-tiled. M = C_out, N = the output columns of
//    one output row (b, oy), K = C_in x taps. A block owns 128 output
//    channels x `cols` (64, 96 or 128) columns with 2*cols threads; each
//    thread keeps an 8 (channels) x 8 (consecutive columns) tile of fp32
//    sums in registers for the whole reduction: 64 FMAs per filter value
//    and input value it reads.
//  * The paper's register cache along the row. Per staged channel and tap
//    group (up to 3 adjacent columns of one row), a thread reads its
//    8*sw + 3 - sw input values (10 at stride 1, 17 at stride 2) once into
//    registers and applies every tap of the group by indexing that window
//    at compile-time offsets (the group's tap set is a template argument:
//    all three columns, the first two, or the first one, which covers the
//    forward of a 3-wide row and both phases of its stride-2 adjoint); the
//    8 channels' coefficients are two float4 loads from a slab laid out
//    (ci, tap, co). At 3 taps that is 192 FMAs for 16 (stride 1) or 23
//    (stride 2) shared loads, where a thread of the first version issued
//    16 FMAs per 5. Warps are shaped so these loads are free of bank
//    conflicts: a warp covers 64 channels x 32 columns at stride 1 (4
//    column groups 8 words apart), 128 x 16 at stride 2 (2 column groups
//    16 words apart); the slab swizzles each 64-channel block so a warp's
//    first and second float4 each read 128 contiguous bytes. Other strides
//    and tap sets read each tap's 8 values on their own.
//  * Asynchronous staging. A ring of 3 stages of cp.async copies (16
//    bytes) brings slab k + 2 (x's rows and the filter slab of `ci_slab`
//    channels) while the FFMAs run on slab k. A staged row starts at the
//    16-byte aligned element at or below its first needed one, so any row
//    pitch (bf16 rows of 1500, fp32 rows of 17 or 257) copies at full
//    width; the reads apply the row's shift. Chunks wholly outside the
//    input are zero stores, the few that straddle its edge go element by
//    element. bf16 input is staged as is and widened to fp32 where the
//    window is read.
//  * One fixed order for every sum (ci ascending; inside a channel the tap
//    table's groups in order, each group's taps by column), no atomics, no
//    split of C_in across blocks: two calls give equal bits.
//  * The epilogue (bias per out channel, tanh-GELU, SiLU, ReLU, scale, a
//    residual read at the output's position; ssam_epilogue.cuh) is applied
//    once to each sum; a thread stores its 8
//    columns as two float4 (one 16-byte store of 8 bf16) where the row
//    allows, else element by element.
// What holds it now (paired A/B calls on the card): not the shared loads
// (taking the window or the coefficient loads out changes little), partly
// the staging (a fifth of the time: every block stages the whole filter
// slab of its 128 channels), and mostly the FFMA issue rate itself: the
// inner loop is FFMA-dense in SASS, but sustains well under one FFMA per
// cycle per scheduler (PERF.md §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssam_epilogue.cuh"

namespace ssam {

constexpr int kRCoTile = 128;   // output channels per block
constexpr int kRTh = 8;         // channels and columns per thread
constexpr int kRMW = 3;         // columns of one tap group's window
constexpr int kRStages = 3;     // the cp.async ring
constexpr int kRPhaseInts = 10; // a phase's header in the tap table
constexpr int kRGroupInts = 2 + kRMW;

struct ReduceArgs {
  const void* x;        // (batch, cr, hin, win), fp32 or bf16, 16-byte aligned
  void* out;            // (batch, co, hout, wout), x's dtype
  const float* w;       // (cr, fsz, co_pad) fp32: the filter, C_out minor
  const int* table;     // phase headers, then each phase's taps, rows, groups
  int table_ints;
  const float* bias;    // co values, or null
  const void* resid;    // the residual (out's dtype and layout), or null
  int epi_op[kMaxEpi];  // 1 bias, 2 gelu (tanh), 3 silu, 4 relu, 5 scale,
                        // 6 residual
  float epi_val[kMaxEpi];
  int n_epi;
  int batch, cr, co, co_pad, hin, win, hout, wout;
  int sh, sw;           // read stride
  int osh, osw;         // output stride
  int fsz, nphases, cols, ci_slab, lp;
  int x_bytes, stage_bytes;  // x part of a stage, whole stage
  int table_bytes;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRStages - 2));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The staged filter slab: (channel, tap) rows of 128 channels, each
// 64-channel block swizzled so thread group g's channels 8g..8g+3 sit at
// 4g and 8g+4..8g+7 at 32 + 4g: a warp's float4 loads read 128 contiguous
// bytes. j is a multiple of 4.
__device__ __forceinline__ int slab_pos(int j) {
  const int jj = j & 63;
  return (j & ~63) + ((jj & 7) >> 2) * 32 + (jj >> 3) * 4;
}

// Flat element index of x[b, c, gy, 0] (gy may lie outside the input).
__device__ __forceinline__ long long row_base(const ReduceArgs& a, int b,
                                              int c, int gy) {
  return ((static_cast<long long>(b) * a.cr + c) * a.hin + gy) *
         static_cast<long long>(a.win);
}

// Issue the copies of slab [c0, c0 + nc) into one ring stage.
template <typename T>
__device__ void stage_slab(const ReduceArgs& a, const int* ph,
                           const int* tab, unsigned char* buf, int c0,
                           int nc, int b, int oy, long long ix0, int co0) {
  constexpr int E = 16 / sizeof(T);
  const int ntaps = ph[4], nrows = ph[5];
  const int* tapk = tab + ph[8];
  const int* rowdr = tapk + ntaps;
  const int chunks = a.lp / E;
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(a.x);
  T* xs = reinterpret_cast<T*>(buf);
  // x: a warp per staged row (channel c, row r), its lanes over the row's
  // 16-byte chunks
  const float inv_rows = 1.f / nrows;
  for (int crow = warp; crow < nc * nrows; crow += nwarps) {
    const int c = __float2int_rz((crow + 0.5f) * inv_rows);
    const int gy = oy * a.sh + rowdr[crow - c * nrows];
    const long long rb = row_base(a, b, c0 + c, gy);
    const long long g0 = rb + ix0;
    const bool rin = gy >= 0 && gy < a.hin;
    T* row = xs + static_cast<size_t>(crow) * a.lp;
    for (int q = lane; q < chunks; q += 32) {
      const long long e0 = g0 - (g0 & (E - 1)) + static_cast<long long>(q) * E;
      T* dst = row + q * E;
      if (rin && e0 >= rb && e0 + E <= rb + a.win) {
        cp_async16(dst, x + e0);
      } else if (!rin || e0 + E <= rb || e0 >= rb + a.win) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const long long e = e0 + j;
          dst[j] = (e >= rb && e < rb + a.win) ? x[e] : narrow<T>(0.f);
        }
      }
    }
  }
  // the filter: a warp per (channel, tap) row of 128 channels, a lane per
  // 16-byte chunk
  float* ws = reinterpret_cast<float*>(buf + a.x_bytes);
  const float inv_taps = 1.f / ntaps;
  for (int ct = warp; ct < nc * ntaps; ct += nwarps) {
    const int c = __float2int_rz((ct + 0.5f) * inv_taps);
    cp_async16(ws + ct * kRCoTile + slab_pos(4 * lane),
               a.w + (static_cast<size_t>(c0 + c) * a.fsz +
                      tapk[ct - c * ntaps]) * a.co_pad + co0 + 4 * lane);
  }
}

// One tap group's FMAs for the window columns in MASK (bit m: column m):
// the present taps' coefficients first, then the thread's register window
// of input values, then 64 FMAs a tap.
template <typename T, int SW, int MASK>
__device__ __forceinline__ void group_fma(float (&acc)[kRTh][kRTh],
                                          const T* xw0, const float* wc,
                                          const int (&tt)[kRMW]) {
  constexpr int HI = (MASK & 4) ? 3 : (MASK & 2) ? 2 : 1;
  constexpr int WN = (kRTh - 1) * SW + HI;
  float4 w[kRMW][2];
#pragma unroll
  for (int m = 0; m < kRMW; ++m)
    if (MASK >> m & 1) {
      w[m][0] = *reinterpret_cast<const float4*>(wc + tt[m] * kRCoTile);
      w[m][1] = *reinterpret_cast<const float4*>(wc + tt[m] * kRCoTile + 32);
    }
  float xw[WN];
#pragma unroll
  for (int j = 0; j < WN; ++j) xw[j] = widen(xw0[j]);
#pragma unroll
  for (int m = 0; m < kRMW; ++m) {
    if (!(MASK >> m & 1)) continue;
    const float wv[kRTh] = {w[m][0].x, w[m][0].y, w[m][0].z, w[m][0].w,
                            w[m][1].x, w[m][1].y, w[m][1].z, w[m][1].w};
#pragma unroll
    for (int i = 0; i < kRTh; ++i) {
      const float xv = xw[i * SW + m];
#pragma unroll
      for (int o = 0; o < kRTh; ++o) acc[o][i] = fmaf(wv[o], xv, acc[o][i]);
    }
  }
}

// Any read stride and any set of taps: each present tap's 8 input values
// read on their own.
template <typename T>
__device__ __forceinline__ void group_fma_strided(float (&acc)[kRTh][kRTh],
                                                  const T* xw0,
                                                  const float* wc,
                                                  const int (&tt)[kRMW],
                                                  int sw) {
#pragma unroll
  for (int m = 0; m < kRMW; ++m) {
    if (tt[m] < 0) continue;
    float xv[kRTh];
#pragma unroll
    for (int i = 0; i < kRTh; ++i) xv[i] = widen(xw0[i * sw + m]);
    const float4 w0 = *reinterpret_cast<const float4*>(wc + tt[m] * kRCoTile);
    const float4 w1 =
        *reinterpret_cast<const float4*>(wc + tt[m] * kRCoTile + 32);
    const float wv[kRTh] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < kRTh; ++i)
#pragma unroll
      for (int o = 0; o < kRTh; ++o) acc[o][i] = fmaf(wv[o], xv[i], acc[o][i]);
  }
}

// A tap group as the channel loop reads it: its row's dr, the staged-row
// offset of its window (row * lp + window column), its taps per column.
struct Group {
  int dr, off, mask;
  int tt[kRMW];
};

__device__ __forceinline__ Group load_group(const int* g, const int* rowdr,
                                            int lp) {
  Group q;
  q.dr = rowdr[g[0]];
  q.off = g[0] * lp + g[1];
  q.mask = 0;
#pragma unroll
  for (int m = 0; m < kRMW; ++m) {
    q.tt[m] = g[2 + m];
    q.mask |= (q.tt[m] >= 0) << m;
  }
  return q;
}

// One channel of one group: the staged row's shift (the low bits of its
// first read's flat index, computed in 32 bits), then the FMAs.
template <typename T, int SW>
__device__ __forceinline__ void channel_fma(const ReduceArgs& a,
                                            float (&acc)[kRTh][kRTh],
                                            const Group& q, const T* xrow,
                                            const float* wc, unsigned cb,
                                            int oy, unsigned ix0lo,
                                            int colbase) {
  constexpr unsigned E = 16 / sizeof(T);
  const unsigned s =
      ((cb * a.hin + static_cast<unsigned>(oy * a.sh + q.dr)) * a.win +
       ix0lo) & (E - 1);
  const T* xw0 = xrow + q.off + s;
  const int sw = SW ? SW : a.sw;
  xw0 += colbase * sw;
  // the masks of a 3-wide row (7) and of its stride-2 adjoint's phases (1:
  // one tap, 3: two adjacent) get a register window; any other group
  // reads each tap's values on their own
  if constexpr (SW != 0) {
    if (q.mask == 7) return group_fma<T, SW, 7>(acc, xw0, wc, q.tt);
    if (q.mask == 3) return group_fma<T, SW, 3>(acc, xw0, wc, q.tt);
    if (q.mask == 1) return group_fma<T, SW, 1>(acc, xw0, wc, q.tt);
  }
  group_fma_strided<T>(acc, xw0, wc, q.tt, sw);
}

// SW: the read stride (1 or 2: a register window per tap group; 0: any
// stride, each tap's 8 values read on their own). T: x's element type.
template <typename T, int SW>
__global__ void __launch_bounds__(256, 2)
    window_reduce_kernel(ReduceArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + a.table_bytes;
  constexpr int E = 16 / sizeof(T);

  const int co_tiles = a.co_pad / kRCoTile;
  const int ph_i = blockIdx.z % a.nphases;
  const int zr = blockIdx.z / a.nphases;
  const int co0 = (zr % co_tiles) * kRCoTile;
  const int b = zr / co_tiles;
  const int oy = blockIdx.y;
  const int ox0 = blockIdx.x * a.cols;

  for (int i = threadIdx.x; i < a.table_ints; i += blockDim.x)
    tab[i] = a.table[i];
  __syncthreads();
  const int* ph = tab + ph_i * kRPhaseInts;
  const int hq = ph[2], wq = ph[3];
  if (oy >= hq || ox0 >= wq) return;  // a smaller phase's spare blocks
  const int ntaps = ph[4], nrows = ph[5], ngroups = ph[6];
  const int* groups = tab + ph[8] + ntaps + nrows;
  const int* rowdr = tab + ph[8] + ntaps;
  const long long ix0 = static_cast<long long>(ox0) * a.sw + ph[7];

  // this thread's 8 channels (group G of 16) and 8 columns (group xg)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int G, xg;
  if constexpr (SW == 2) {  // a warp: 16 channel groups x 2 column groups
    G = lane & 15;
    xg = warp * 2 + (lane >> 4);
  } else {        // a warp: 8 channel groups x 4 column groups
    G = (warp & 1) * 8 + (lane & 7);
    xg = (warp >> 1) * 4 + (lane >> 3);
  }
  const int colbase = xg * kRTh;
  const int wpos = (G >> 3) * 64 + (G & 7) * 4;

  float acc[kRTh][kRTh];
#pragma unroll
  for (int o = 0; o < kRTh; ++o)
#pragma unroll
    for (int i = 0; i < kRTh; ++i) acc[o][i] = 0.f;

  const int nslabs = ngroups ? (a.cr + a.ci_slab - 1) / a.ci_slab : 0;
  // a phase with one tap group (every 1-row filter up to 3 wide) keeps it
  // in registers
  const Group g1 = ngroups ? load_group(groups, rowdr, a.lp) : Group{};
  const unsigned ix0lo = static_cast<unsigned>(ix0);
#pragma unroll 1
  for (int s = 0; s < kRStages - 1; ++s) {
    if (s < nslabs)
      stage_slab<T>(a, ph, tab, ring + s * a.stage_bytes, s * a.ci_slab,
                    min(a.ci_slab, a.cr - s * a.ci_slab), b, oy, ix0, co0);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < nslabs; ++k) {
    cp_async_wait_ring();
    __syncthreads();  // slab k is in; slab k - 1's stage is free
    const int kn = k + kRStages - 1;
    if (kn < nslabs)
      stage_slab<T>(a, ph, tab, ring + (kn % kRStages) * a.stage_bytes,
                    kn * a.ci_slab, min(a.ci_slab, a.cr - kn * a.ci_slab), b,
                    oy, ix0, co0);
    cp_async_commit();

    const unsigned char* buf = ring + (k % kRStages) * a.stage_bytes;
    const T* xs = reinterpret_cast<const T*>(buf);
    const float* ws = reinterpret_cast<const float*>(buf + a.x_bytes) + wpos;
    const int c0 = k * a.ci_slab;
    const int nc = min(a.ci_slab, a.cr - c0);
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const unsigned cb = static_cast<unsigned>(b * a.cr + c0 + c);
      const T* xrow = xs + static_cast<size_t>(c * nrows) * a.lp;
      const float* wc = ws + c * ntaps * kRCoTile;
      if (ngroups == 1) {
        channel_fma<T, SW>(a, acc, g1, xrow, wc, cb, oy, ix0lo, colbase);
      } else {
#pragma unroll 1
        for (int gi = 0; gi < ngroups; ++gi)
          channel_fma<T, SW>(a, acc,
                             load_group(groups + gi * kRGroupInts, rowdr,
                                        a.lp),
                             xrow, wc, cb, oy, ix0lo, colbase);
      }
    }
  }
  cp_async_wait_all();

  // the flush: epilogue, then the 8 columns of each of the 8 channels
  const int orow = oy * a.osh + ph[0];
  const int ox = ox0 + colbase;
  const int px = ph[1];
#pragma unroll
  for (int o = 0; o < kRTh; ++o) {
    const int co = co0 + G * kRTh + o;
    if (co >= a.co) continue;
    const size_t obase =
        ((static_cast<size_t>(b) * a.co + co) * a.hout + orow) * a.wout;
    const size_t first = obase + static_cast<size_t>(ox) * a.osw + px;
    float v[kRTh];
#pragma unroll
    for (int i = 0; i < kRTh; ++i) v[i] = acc[o][i];
    // the chain on the channel's 8 sums, one dispatch a stage for the 8
    apply_epilogue_regs<kRTh>(
        a.epi_op, a.epi_val, a.n_epi, a.bias ? a.bias[co] : 0.f, v,
        [&](int i) {
          return ox + i < wq
                     ? load_residual(a.resid, sizeof(T) == 2,
                                     first + static_cast<size_t>(i) * a.osw)
                     : 0.f;
        });
    if (a.osw == 1 && ox + kRTh <= wq && first % E == 0) {
      if (sizeof(T) == 4) {
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(a.out) +
                                                first);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        __align__(16) __nv_bfloat16 h[kRTh];
#pragma unroll
        for (int i = 0; i < kRTh; ++i) h[i] = narrow<__nv_bfloat16>(v[i]);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) +
                                  first) = *reinterpret_cast<uint4*>(h);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRTh; ++i) {
        if (ox + i >= wq) break;
        const size_t at = first + static_cast<size_t>(i) * a.osw;
        static_cast<T*>(a.out)[at] = narrow<T>(v[i]);
      }
    }
  }
}

template <typename T, int SW>
int launch(const ReduceArgs& a, int grid_x, int grid_y, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_reduce_kernel<T, SW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(grid_x, grid_y, a.batch * (a.co_pad / kRCoTile) * a.nphases);
  window_reduce_kernel<T, SW><<<grid, 2 * a.cols, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stride(const ReduceArgs& a, int grid_x, int grid_y, int smem,
                  cudaStream_t stream) {
  if (a.sw == 1) return launch<T, 1>(a, grid_x, grid_y, smem, stream);
  if (a.sw == 2) return launch<T, 2>(a, grid_x, grid_y, smem, stream);
  return launch<T, 0>(a, grid_x, grid_y, smem, stream);
}

}  // namespace ssam

// Plain C entry of K1's channel-reduce path, loaded with ctypes. epi_ops
// and epi_vals are host arrays of kMaxEpi entries; the geometry (cols,
// ci_slab, lp, the stage sizes, the grid's x and y) is core/engine.py's
// reduce_layout.
extern "C" int ssam_window_reduce_launch(
    const void* x, void* out, int io_bf16, const float* w, const int* table,
    int table_ints, const float* bias, const void* resid, const int* epi_ops,
    const float* epi_vals, int n_epi, int batch, int cr, int co, int co_pad,
    int hin, int win, int hout, int wout, int sh, int sw, int osh, int osw,
    int fsz, int nphases, int cols, int ci_slab, int lp, int x_bytes,
    int stage_bytes, int grid_x, int grid_y, int smem_bytes, void* stream) {
  const int table_bytes = (4 * table_ints + 15) & ~15;
  if (n_epi < 0 || n_epi > ssam::kMaxEpi || ci_slab < 1 || sh < 1 ||
      sw < 1 || osh < 1 || osw < 1 || hout < 1 || wout < 1 || nphases < 1 ||
      grid_y > 65535 || co_pad % ssam::kRCoTile || co_pad < co ||
      (cols != 64 && cols != 96 && cols != 128) || (lp * (io_bf16 ? 2 : 4)) % 16 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || x_bytes % 16 ||
      stage_bytes % 16 ||
      smem_bytes < table_bytes + ssam::kRStages * stage_bytes)
    return (int)cudaErrorInvalidValue;
  ssam::ReduceArgs a;
  a.x = x;
  a.out = out;
  a.w = w;
  a.table = table;
  a.table_ints = table_ints;
  a.bias = bias;
  a.resid = resid;
  for (int s = 0; s < ssam::kMaxEpi; ++s) {
    a.epi_op[s] = s < n_epi ? epi_ops[s] : 0;
    a.epi_val[s] = s < n_epi ? epi_vals[s] : 0.f;
    if ((a.epi_op[s] == 1 && bias == nullptr) ||
        (a.epi_op[s] == 6 && resid == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  a.n_epi = n_epi;
  a.batch = batch;
  a.cr = cr;
  a.co = co;
  a.co_pad = co_pad;
  a.hin = hin;
  a.win = win;
  a.hout = hout;
  a.wout = wout;
  a.sh = sh;
  a.sw = sw;
  a.osh = osh;
  a.osw = osw;
  a.fsz = fsz;
  a.nphases = nphases;
  a.cols = cols;
  a.ci_slab = ci_slab;
  a.lp = lp;
  a.x_bytes = x_bytes;
  a.stage_bytes = stage_bytes;
  a.table_bytes = table_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return io_bf16
             ? ssam::launch_stride<__nv_bfloat16>(a, grid_x, grid_y,
                                                  smem_bytes, s)
             : ssam::launch_stride<float>(a, grid_x, grid_y, smem_bytes, s);
}
