// K2 on Hopper: the tensor-core strategy of the windowed-plan engine
// (strategy="mxu"), single-channel plans.
//
// Replaces src/repro/core/engine.py::_apply_plan_mxu, the strategy="mxu"
// body of _window_kernel (launched at the same pallas_call as K1): im2row
// over the plan's tap set, contracted with the coefficients on the matrix
// unit with an fp32 accumulator. Channel (NCHW) plans run K2's wgmma
// kernel, ssam_mxu_tc.cu.
//
// mma.sync.m16n8k8 in TF32. TF32 keeps 10 mantissa bits, about three
// digits, so for fp32 parity each operand is split, big = tf32(a) and
// small = tf32(a - big), and big*big + big*small + small*big is
// accumulated in fp32 (3xTF32; the dropped small*small term is about 2^-22
// of the product). The tensor core's own fp32 accumulation truncates, so
// each k-step's big*big product is added outside it, with a
// round-to-nearest fp32 add (mma_3xtf32 in ssam_tf32.cuh). bf16 inputs are
// upcast on load (their small part is 0) and the output is cast back.
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
// device-memory bytes (each input read once, each output written once).
// This simple version spends 3 mma.sync per product on the split, gathers
// every fragment with scalar shared loads, and wastes 7/8 of the columns;
// more useful columns (several output shifts per B column, a Toeplitz B)
// are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssam_tf32.cuh"

namespace ssam {

constexpr int kMThreads = 256;
constexpr int kMWarps = kMThreads / 32;

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

// Plain C entry of K2's single-channel path, loaded with ctypes.
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
