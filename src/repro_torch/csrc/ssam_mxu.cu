// K2 on Hopper: the tensor-core strategy of the windowed-plan engine
// (strategy="mxu").
//
// Replaces src/repro/core/engine.py::_apply_plan_mxu, the strategy="mxu"
// body of _window_kernel (launched at the same pallas_call as K1): im2row
// over the plan's tap set, contracted with the coefficients on the matrix
// unit with an fp32 accumulator.
//
// Both paths run on the tensor cores, mma.sync.m16n8k8 in TF32. TF32 keeps
// 10 mantissa bits, about three digits, so for fp32 parity each operand is
// split, big = tf32(a) and small = tf32(a - big), and big*big + big*small +
// small*big is accumulated in fp32 (3xTF32; the dropped small*small term is
// about 2^-22 of the product). The tensor core's own fp32 accumulation
// truncates, so each k-step's big*big product is added outside it, with a
// round-to-nearest fp32 add (mma_3xtf32). bf16 inputs are upcast on load
// (their small part is 0) and the output is cast back.
//
// Channel-reduce path (NCHW plans: the Whisper stem and its input adjoint):
//   out[b, co, oy, ox] = epi( sum_{ci, tap} w[co, ci, tap]
//                              * x[b, ci, oy*sh + row - ly, ox*sw + col - lx] )
// is a GEMM with M = C_out, N = output positions and K = C_in*taps. A block
// of 8 warps owns 64 output channels x 1 output row x 128 columns of one
// batch row; warp (wm, wn) keeps 32 channels x 32 columns as 2 x 4 m16n8 fp32
// accumulator tiles for the whole reduction. K streams through shared memory
// ci_t input channels per pass: the pass stages the filter tile (A,
// row-major, pitch lda = 4 mod 32, so the 32 loads of an A fragment fall in
// 32 banks) and the halo-overlapped input rows the taps reach ((127*sw + M)
// columns each, zero outside the domain: the plan's padding is never
// materialised). The im2row operand B[k = ci*taps + tap][n] =
// xs[ci][row][n*sw + col] is read from that staged tile through a per-k
// offset table, so it exists only in shared memory, never in device memory.
// A strided plan reads lane n*sw + col and computes only the kept outputs.
// The epilogue (ssam_epilogue.cuh) applies to the fp32 sum before the store.
// Nothing is skipped: taps that read only padding rows (a 3x3 filter on
// H = 1) are multiplied like the others.
//
// Single-channel path (Table-3 stencils 2-D and 3-D, conv2d valid, same and
// batched): no channel axis fills M, so M = the tile's output positions (16
// per fragment), K = the taps padded to 8 and N = 1 padded to 8: the
// coefficient column is B ('table' plans: the plan's immediates) and only
// column 0 of the 8 does work. A block stages its t-widened skirt once, as
// K1 does (same tiles, same pad-once geometry), and each application reads
// A[p][tap] = src[pos(p) + off(tap)] from it: the im2row operand is the
// staged tile seen through the tap offsets. Every application but the last
// writes its iterate back to shared memory (two buffers, ping-pong), the
// last to device memory.
//
// Bound on an H100: the stencils and small filters are bound by
// device-memory bytes (each input read once, each output written once), the
// stem by tensor-core operations (2*C_in*taps per output: conv2's forward is
// 18.9 GFLOP, 0.038 ms at 495 TFLOP/s of TF32 counted once). This simple
// version spends 3 mma.sync per product on the split, gathers every fragment
// with scalar shared loads, and wastes 7/8 of the single-channel path's
// columns; wgmma with TMA-staged tiles, and more useful columns (several
// output shifts per B column), are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssam_epilogue.cuh"

namespace ssam {

constexpr int kMThreads = 256;
constexpr int kMWarps = kMThreads / 32;
constexpr int kMCoTile = 64;  // output channels per reduce block (GEMM M)
constexpr int kMCols = 128;   // output columns per reduce block (GEMM N)

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// d += a * b on one m16n8k8 tile: TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 on one k-step. The tensor core's fp32 accumulation truncates, so
// a long chain of big*big sums drifts: each step's big*big product starts
// from zero and is added to acc with a round-to-nearest fp32 add, while
// the two small cross terms, about 2^-11 of it, accumulate in the tensor
// core in cor. The result is acc + cor.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], float (&cor)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  float hi[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(hi, ab, bb);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += hi[i];
  mma_tf32(cor, as, bb);
  mma_tf32(cor, ab, bs);
}

__device__ __forceinline__ float load_x(const void* x, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
              : static_cast<const float*>(x)[i];
}

__device__ __forceinline__ void store_out(void* out, int bf16, size_t i,
                                          float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

// ---------------------------------------------------------------------------
// Channel-reduce path
// ---------------------------------------------------------------------------

struct MxuReduceArgs {
  const void* x;        // (batch, cr, hin, win), fp32 or bf16
  void* out;            // (batch, co, ho, wo), x's dtype
  int io_bf16;
  const float* w;       // (co, cr, fsz) fp32
  const int* taps;      // ntaps (row, col, coeff) triples, plan order
  int ntaps;
  const float* bias;    // co values, or null
  int epi_op[kMaxEpi];
  float epi_val[kMaxEpi];
  int n_epi;
  int batch, cr, co, hin, win, ho, wo;
  int ly, lx, sh, sw;
  int fsz, rows, M;     // filter slice size N*M, plan rows N, plan columns M
  int ci_t, kc, lda, span;  // channels per pass, its K padded to 8, A pitch,
                            // staged columns per input row
};

__global__ void __launch_bounds__(kMThreads) mxu_reduce_kernel(MxuReduceArgs a) {
  extern __shared__ float smem[];
  int* koff = reinterpret_cast<int*>(smem);  // k -> its row's offset in xs
  int* kwid = koff + a.kc;                   // k -> ci*fsz + coeff
  float* ws = smem + 2 * a.kc;               // kMCoTile x lda filter tile
  float* xs = ws + kMCoTile * a.lda;         // ci_t x rows x span input rows
  const int T = a.ntaps;

  const int co_tiles = (a.co + kMCoTile - 1) / kMCoTile;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * kMCoTile;
  const int oy = blockIdx.y;
  const int ox0 = blockIdx.x * kMCols;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;  // the mma's group and thread in it
  const int wm = warp >> 2, wn = warp & 3;
  const int iy0 = oy * a.sh - a.ly;
  const int ix0 = ox0 * a.sw - a.lx;

  for (int k = tid; k < a.kc; k += kMThreads) {
    const bool real = k < a.ci_t * T;
    const int c = real ? k / T : 0, t = real ? k % T : 0;
    koff[k] = real ? (c * a.rows + a.taps[3 * t]) * a.span + a.taps[3 * t + 1]
                   : 0;
    kwid[k] = real ? c * a.fsz + a.taps[3 * t + 2] : 0;
  }

  float acc[2][4][4], cor[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = cor[mi][ni][i] = 0.f;

  for (int c0 = 0; c0 < a.cr; c0 += a.ci_t) {
    const int nc = min(a.ci_t, a.cr - c0);
    const int kv = nc * T;           // this pass's contraction depth
    const int kp = (kv + 7) & ~7;    // padded to the mma's k = 8
    __syncthreads();  // the tables are in; the last pass is read
    for (int i = tid; i < kMCoTile * kp; i += kMThreads) {
      const int m = i / kp, k = i % kp;
      const int co = co0 + m;
      ws[m * a.lda + k] =
          (co < a.co && k < kv)
              ? a.w[((size_t)co * a.cr + c0) * a.fsz + kwid[k]]
              : 0.f;
    }
    for (int row = warp; row < nc * a.rows; row += kMWarps) {
      const int c = row / a.rows, r = row % a.rows;
      const int gy = iy0 + r;
      const bool in = gy >= 0 && gy < a.hin;
      const size_t base =
          (((size_t)b * a.cr + c0 + c) * a.hin + (in ? gy : 0)) * a.win;
      for (int j = lane; j < a.span; j += 32) {
        const int gx = ix0 + j;
        xs[row * a.span + j] = (in && gx >= 0 && gx < a.win)
                                   ? load_x(a.x, a.io_bf16, base + gx)
                                   : 0.f;
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < kp; k0 += 8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A fragment: rows g and g+8, columns q and q+4 of the 16 x 8 tile
        const float* wr = ws + (wm * 32 + mi * 16 + g) * a.lda + k0 + q;
        split_tf32(wr[0], ab[mi][0], as[mi][0]);
        split_tf32(wr[8 * a.lda], ab[mi][1], as[mi][1]);
        split_tf32(wr[4], ab[mi][2], as[mi][2]);
        split_tf32(wr[8 * a.lda + 4], ab[mi][3], as[mi][3]);
      }
      // B fragment: rows (k) q and q+4, column (position) g
      const int ka = k0 + q, kb = ka + 4;
      const bool va = ka < kv, vb = kb < kv;
      const float* xa = xs + koff[ka];
      const float* xb = xs + koff[kb];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = (wn * 32 + ni * 8 + g) * a.sw;
        uint32_t bb[2], bs[2];
        split_tf32(va ? xa[n] : 0.f, bb[0], bs[0]);
        split_tf32(vb ? xb[n] : 0.f, bb[1], bs[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_3xtf32(acc[mi][ni], cor[mi][ni], ab[mi], as[mi], bb, bs);
      }
    }
  }

  // Accumulator tile: rows g (i < 2) and g+8, columns 2q and 2q+1.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int co = co0 + wm * 32 + mi * 16 + g + (i >= 2 ? 8 : 0);
        const int ox = ox0 + wn * 32 + ni * 8 + 2 * q + (i & 1);
        if (co >= a.co || ox >= a.wo) continue;
        const float v = apply_epilogue(a.epi_op, a.epi_val, a.n_epi, a.bias,
                                       acc[mi][ni][i] + cor[mi][ni][i], co);
        store_out(a.out, a.io_bf16,
                  (((size_t)b * a.co + co) * a.ho + oy) * a.wo + ox, v);
      }
}

// ---------------------------------------------------------------------------
// Single-channel path
// ---------------------------------------------------------------------------

struct MxuWindowArgs {
  const void* x;       // batch x (zin) x hin x win input, lane axis last
  void* out;           // batch x (zo) x ho x wo output
  int io_bf16;
  const float* cvals;  // coefficient values
  const int* taps;     // ntaps (dz, row, col, cidx) quadruples, plan order
  int ntaps, tp;       // taps, and taps padded to 8
  int batch, zin, hin, win, zo, ho, wo;
  int lz, ly, lx;      // t * lead per axis: input index of output 0 is -lead
  int D, N, M, t;
  int bz, bh, bw;      // output tile
};

__global__ void __launch_bounds__(kMThreads) mxu_window_kernel(MxuWindowArgs a) {
  extern __shared__ float smem[];
  int* toff = reinterpret_cast<int*>(smem);  // tp tap offsets in the iterate
  float* coef = smem + a.tp;                 // tp coefficients, 0 past ntaps
  float* buf0 = coef + a.tp;
  const int t = a.t;
  float* buf1 = buf0 + (a.bz + t * (a.D - 1)) * (a.bh + t * (a.N - 1)) *
                           (a.bw + t * (a.M - 1));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;

  for (int i = tid; i < a.tp; i += kMThreads)
    coef[i] = i < a.ntaps ? a.cvals[a.taps[4 * i + 3]] : 0.f;

  // This block's output tile, trimmed at the ragged edge of the domain.
  const int tiles_z = (a.zo + a.bz - 1) / a.bz;
  const int b = blockIdx.z / tiles_z;
  const int oz0 = (blockIdx.z % tiles_z) * a.bz;
  const int oy0 = blockIdx.y * a.bh, ox0 = blockIdx.x * a.bw;
  const int tz = min(a.bz, a.zo - oz0), ty = min(a.bh, a.ho - oy0);
  const int tx = min(a.bw, a.wo - ox0);
  int ez = tz + t * (a.D - 1), ey = ty + t * (a.N - 1),
      ex = tx + t * (a.M - 1);

  // Stage the skirt once, reading x in place; zeros outside the domain.
  const int iz0 = oz0 - a.lz, iy0 = oy0 - a.ly, ix0 = ox0 - a.lx;
  const size_t iplane = (size_t)a.hin * a.win;
  const size_t ibase = (size_t)b * a.zin * iplane;
  for (int row = warp; row < ez * ey; row += kMWarps) {
    const int gz = iz0 + row / ey, gy = iy0 + row % ey;
    const bool row_in = gz >= 0 && gz < a.zin && gy >= 0 && gy < a.hin;
    const size_t rbase = ibase + (size_t)gz * iplane + (size_t)gy * a.win;
    for (int xx = lane; xx < ex; xx += 32) {
      const int gx = ix0 + xx;
      buf0[row * ex + xx] = (row_in && gx >= 0 && gx < a.win)
                                ? load_x(a.x, a.io_bf16, rbase + gx)
                                : 0.f;
    }
  }

  const size_t oplane = (size_t)a.ho * a.wo;
  const size_t obase = (size_t)b * a.zo * oplane;
  float* src = buf0;
  float* dst = buf1;
  for (int k = 0; k < t; ++k) {
    const bool last = k == t - 1;
    for (int i = tid; i < a.tp; i += kMThreads)
      toff[i] = i < a.ntaps ? (a.taps[4 * i] * ey + a.taps[4 * i + 1]) * ex +
                                  a.taps[4 * i + 2]
                            : 0;
    __syncthreads();  // the iterate and its tap offsets are in
    const int dz = ez - (a.D - 1), dy = ey - (a.N - 1), dx = ex - (a.M - 1);
    const int dplane = dy * dx;
    const int npos = dz * dplane;
    for (int p0 = warp * 16; p0 < npos; p0 += kMWarps * 16) {
      // A rows g and g+8: output positions p0 + g and p0 + g + 8 (clamped
      // in the last tile; their sums are not stored)
      int off[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(p0 + g + 8 * h, npos - 1);
        const int z = p / dplane, r = p - z * dplane;
        const int y = r / dx;
        off[h] = (z * ey + y) * ex + (r - y * dx);
      }
      float d[4] = {0.f, 0.f, 0.f, 0.f}, cor[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < a.tp; k0 += 8) {
        const int ka = k0 + q, kb = ka + 4;
        const bool va = ka < a.ntaps, vb = kb < a.ntaps;
        const int oa = toff[ka], ob = toff[kb];
        uint32_t ab[4], as[4], bb[2], bs[2];
        split_tf32(va ? src[off[0] + oa] : 0.f, ab[0], as[0]);
        split_tf32(va ? src[off[1] + oa] : 0.f, ab[1], as[1]);
        split_tf32(vb ? src[off[0] + ob] : 0.f, ab[2], as[2]);
        split_tf32(vb ? src[off[1] + ob] : 0.f, ab[3], as[3]);
        // B: the coefficient column is column 0 (held by group 0)
        split_tf32(g == 0 ? coef[ka] : 0.f, bb[0], bs[0]);
        split_tf32(g == 0 ? coef[kb] : 0.f, bb[1], bs[1]);
        mma_3xtf32(d, cor, ab, as, bb, bs);
      }
      if (q == 0) {  // column 0 of the accumulator: d[0] row g, d[2] row g+8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + g + 8 * h;
          if (p >= npos) continue;
          const float v = d[2 * h] + cor[2 * h];
          if (last) {
            const int z = p / dplane, r = p - z * dplane;
            const int y = r / dx;
            store_out(a.out, a.io_bf16,
                      obase + (size_t)(oz0 + z) * oplane +
                          (size_t)(oy0 + y) * a.wo + (ox0 + r - y * dx),
                      v);
          } else {
            dst[p] = v;
          }
        }
      }
    }
    __syncthreads();  // the iterate is written before it is read
    ez = dz;
    ey = dy;
    ex = dx;
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
}

}  // namespace ssam

// Plain C entries of K2, loaded with ctypes. epi_ops and epi_vals are host
// arrays of kMaxEpi entries.
extern "C" int ssam_mxu_reduce_launch(
    const void* x, void* out, int io_bf16, const float* w, const int* taps,
    int ntaps, const float* bias, const int* epi_ops, const float* epi_vals,
    int n_epi, int batch, int cr, int co, int hin, int win, int ho, int wo,
    int ly, int lx, int sh, int sw, int fsz, int rows, int M, int ci_t,
    int kc, int lda, int span, int smem_bytes, void* stream) {
  if (ntaps < 1 || n_epi < 0 || n_epi > ssam::kMaxEpi || ci_t < 1 ||
      kc < ci_t * ntaps || kc % 8 || lda < kc || sh < 1 || sw < 1 ||
      span < (ssam::kMCols - 1) * sw + M || ho < 1 || wo < 1 || ho > 65535)
    return (int)cudaErrorInvalidValue;
  ssam::MxuReduceArgs a;
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
  a.kc = kc;
  a.lda = lda;
  a.span = span;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssam::mxu_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int co_tiles = (co + ssam::kMCoTile - 1) / ssam::kMCoTile;
  dim3 grid((wo + ssam::kMCols - 1) / ssam::kMCols, ho, batch * co_tiles);
  ssam::mxu_reduce_kernel<<<grid, ssam::kMThreads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ssam_mxu_window_launch(
    const void* x, void* out, int io_bf16, const float* cvals, const int* taps,
    int ntaps, int tp, int batch, int zin, int hin, int win, int zo, int ho,
    int wo, int lz, int ly, int lx, int D, int N, int M, int t, int bz,
    int bh, int bw, int smem_bytes, void* stream) {
  if (ntaps < 1 || tp < ntaps || tp % 8 || t < 1 || D < 1 || N < 1 ||
      M < 1 || bz < 1 || bh < 1 || bw < 1 || zo < 1 || ho < 1 || wo < 1)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssam::mxu_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ssam::MxuWindowArgs a;
  a.x = x;
  a.out = out;
  a.io_bf16 = io_bf16;
  a.cvals = cvals;
  a.taps = taps;
  a.ntaps = ntaps;
  a.tp = tp;
  a.batch = batch;
  a.zin = zin;
  a.hin = hin;
  a.win = win;
  a.zo = zo;
  a.ho = ho;
  a.wo = wo;
  a.lz = lz;
  a.ly = ly;
  a.lx = lx;
  a.D = D;
  a.N = N;
  a.M = M;
  a.t = t;
  a.bz = bz;
  a.bh = bh;
  a.bw = bw;
  const int tiles_z = (zo + bz - 1) / bz;
  dim3 grid((wo + bw - 1) / bw, (ho + bh - 1) / bh, batch * tiles_z);
  ssam::mxu_window_kernel<<<grid, ssam::kMThreads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
