// K1 on Hopper: the windowed-plan kernel of the SSAM execution model.
//
// Replaces src/repro/core/engine.py::_window_kernel (its block body
// _apply_plan_once, launched by _window_call) for plans with table or
// dense coefficients, 2-D or 3-D, both schedule variants and t >= 1 fused
// time steps.
//
// Design (paper Listings 1 and 2):
//  * One thread block computes one disjoint output tile (bz, bh, bw). Its
//    t-widened input skirt, (bz + t(D-1)) x (bh + t(N-1)) x (bw + t(M-1)),
//    is read from global memory once, in place, with zeros where the skirt
//    leaves the domain (the plan's lead/trail padding is never
//    materialised), and staged in shared memory.
//  * Each warp is a 32-lane systolic array walking the W (lane) axis. A
//    thread keeps a register cache of C = N + P - 1 rows (times D slices
//    for 3-D plans) of its column and produces P output rows.
//  * shift_psum: partial sums move one column step with __shfl_up_sync;
//    after the M column steps lane l holds the output of column
//    l - (M-1). shift_data: the data moves down with __shfl_down_sync and
//    the partial sums stay put; lane l holds the output of column l.
//  * Warp edges: a shuffle loses the lanes that would cross the warp, so a
//    warp only keeps V = 33 - M outputs and neighbouring warps overlap by
//    M - 1 columns (the paper's halo; no shared-memory hand-off).
//  * 3-D plans walk Z inside the thread: the register cache rolls down one
//    slice per output slice, and Z taps are reads of other cached slices.
//  * t > 1: every application but the last writes its (smaller) iterate
//    back to shared memory, ping-ponging two buffers; the iterate is not
//    re-zeroed at the domain edge (pad-once semantics of
//    ref.stencil_iterate). The last application stores to global memory.
//  * Taps and coefficients come as one table per plan: slot (m, dz, r)
//    holds an index into a coefficient array (the plan's immediates for
//    'table' plans, the (N, M) filter for 'dense' plans) or -1 for no tap.
//    Each column step sums its taps in (dz, r) order, the plan's order.
//
// Bound on an H100: 2-D stencils with few taps and small filters are
// bound by device-memory bytes (each input element read once from HBM,
// each output written once); wide boxes (2d121pt, 13x13 and larger
// filters) are bound by fp32 FMAs. This simple version keeps the FMAs in
// registers and the re-reads of the halo in shared memory; the warp
// overlap spends 32/V of the FMAs, which is the cost to take down next.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssam {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kMaxSteps = 32;
constexpr int kMaxSlots = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct WindowArgs {
  const void* x;       // batch x (zin) x hin x win input, lane axis last
  void* out;           // batch x (zo) x ho x wo output
  int io_bf16;         // 1: bf16 input and output, 0: fp32
  const float* cvals;  // coefficient values
  const int* cidx;     // steps * D * N slots: index into cvals, -1 = no tap
  const int* shifts;   // per column step
  int batch, zin, hin, win, zo, ho, wo;
  int lz, ly, lx;      // t * lead per axis: input index of output 0 is -lead
  int steps, M, t, variant;
  int bz, bh, bw;      // output tile
};

// Words of shared memory before the first staging buffer: the tap table.
__host__ __device__ inline int table_words(int steps, int D, int N) {
  int w = steps * D * N + steps * D + steps;
  return (w + 3) & ~3;
}

template <int N, int D, int P>
__device__ __forceinline__ void accumulate(const float (&c)[D][N + P - 1],
                                           float (&s)[P], const float* coef,
                                           const unsigned* mask, int m) {
#pragma unroll
  for (int dz = 0; dz < D; ++dz) {
    const unsigned mk = mask[m * D + dz];
    const float* cf = coef + (m * D + dz) * N;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (mk & (1u << r)) {
        const float w = cf[r];
#pragma unroll
        for (int p = 0; p < P; ++p) s[p] = fmaf(c[dz][p + r], w, s[p]);
      }
    }
  }
}

// One valid application of the plan on a shared-memory iterate of extent
// (zs, hs, ws). The result, of extent (zs-D+1, hs-N+1, ws-M+1), goes to
// shared memory (dst) or, for the last application, to global memory.
template <int N, int D, int P>
__device__ __forceinline__ void apply_once(
    const WindowArgs& a, const float* src, int zs, int hs, int ws,
    float* dst, bool last, int b, int oz0, int oy0, int ox0,
    const float* coef, const unsigned* mask, const int* shift) {
  constexpr int C = N + P - 1;
  const int M = a.M;
  const int V = kWarp - (M - 1);
  const int zd = zs - (D - 1), hd = hs - (N - 1), wd = ws - (M - 1);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int nwc = (wd + V - 1) / V;
  const int nyc = (hd + P - 1) / P;
  const int base_items = nwc * nyc;
  // Split Z into chunks when the W x H items alone cannot feed the warps.
  int zsplit = (2 * nwarps + base_items - 1) / base_items;
  zsplit = max(1, min(zsplit, zd));
  const int zlen = (zd + zsplit - 1) / zsplit;
  const int items = base_items * zsplit;
  const size_t oplane = (size_t)a.ho * a.wo;
  const size_t obase = (size_t)b * a.zo * oplane;

  for (int it = warp; it < items; it += nwarps) {
    const int wc = it % nwc;
    const int yc = (it / nwc) % nyc;
    const int zc = it / base_items;
    const int col = wc * V + lane;  // source column this lane holds
    const int y0 = yc * P;
    const int zb = zc * zlen, ze = min(zd, zb + zlen);
    float c[D][C];
    for (int z = zb; z < ze; ++z) {
      if (z == zb) {
#pragma unroll
        for (int dz = 0; dz < D; ++dz)
#pragma unroll
          for (int i = 0; i < C; ++i)
            c[dz][i] = (y0 + i < hs && col < ws)
                           ? src[((z + dz) * hs + y0 + i) * ws + col] : 0.f;
      } else {
#pragma unroll
        for (int dz = 0; dz + 1 < D; ++dz)
#pragma unroll
          for (int i = 0; i < C; ++i) c[dz][i] = c[dz + 1][i];
#pragma unroll
        for (int i = 0; i < C; ++i)
          c[D - 1][i] = (y0 + i < hs && col < ws)
                            ? src[((z + D - 1) * hs + y0 + i) * ws + col] : 0.f;
      }
      float s[P];
#pragma unroll
      for (int p = 0; p < P; ++p) s[p] = 0.f;
      int oc;
      bool valid;
      if (a.variant == 0) {  // shift_psum
        for (int m = 0; m < a.steps; ++m) {
          const int sh = shift[m];
          if (sh) {
#pragma unroll
            for (int p = 0; p < P; ++p) s[p] = __shfl_up_sync(kFull, s[p], sh);
          }
          accumulate<N, D, P>(c, s, coef, mask, m);
        }
        oc = col - (M - 1);
        valid = lane >= M - 1 && oc < wd;
      } else {  // shift_data
        float xs[D][C];
#pragma unroll
        for (int dz = 0; dz < D; ++dz)
#pragma unroll
          for (int i = 0; i < C; ++i) xs[dz][i] = c[dz][i];
        for (int m = 0; m < a.steps; ++m) {
          const int sh = shift[m];
          if (sh) {
#pragma unroll
            for (int dz = 0; dz < D; ++dz)
#pragma unroll
              for (int i = 0; i < C; ++i)
                xs[dz][i] = __shfl_down_sync(kFull, xs[dz][i], sh);
          }
          accumulate<N, D, P>(xs, s, coef, mask, m);
        }
        oc = col;
        valid = lane < V && oc < wd;
      }
      if (!valid) continue;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int y = y0 + p;
        if (y >= hd) break;
        if (last) {
          const size_t off = obase + (size_t)(oz0 + z) * oplane +
                             (size_t)(oy0 + y) * a.wo + (ox0 + oc);
          if (a.io_bf16)
            static_cast<__nv_bfloat16*>(a.out)[off] = __float2bfloat16(s[p]);
          else
            static_cast<float*>(a.out)[off] = s[p];
        } else {
          dst[(z * hd + y) * wd + oc] = s[p];
        }
      }
    }
  }
}

template <int N, int D, int P>
__global__ void __launch_bounds__(kThreads) window_kernel(WindowArgs a) {
  extern __shared__ float smem[];
  const int steps = a.steps;
  const int nslots = steps * D * N;
  float* coef = smem;
  unsigned* mask = reinterpret_cast<unsigned*>(coef + nslots);
  int* shift = reinterpret_cast<int*>(mask + steps * D);
  float* buf0 = smem + table_words(steps, D, N);
  const int t = a.t;
  float* buf1 = buf0 + (a.bz + t * (D - 1)) * (a.bh + t * (N - 1)) *
                           (a.bw + t * (a.M - 1));

  for (int i = threadIdx.x; i < nslots; i += blockDim.x) {
    const int k = a.cidx[i];
    coef[i] = k >= 0 ? a.cvals[k] : 0.f;
  }
  for (int i = threadIdx.x; i < steps * D; i += blockDim.x) {
    unsigned mk = 0;
    for (int r = 0; r < N; ++r)
      if (a.cidx[i * N + r] >= 0) mk |= 1u << r;
    mask[i] = mk;
  }
  for (int i = threadIdx.x; i < steps; i += blockDim.x) shift[i] = a.shifts[i];

  // This block's output tile, trimmed at the ragged edge of the domain.
  const int tiles_z = (a.zo + a.bz - 1) / a.bz;
  const int b = blockIdx.z / tiles_z;
  const int oz0 = (blockIdx.z % tiles_z) * a.bz;
  const int oy0 = blockIdx.y * a.bh, ox0 = blockIdx.x * a.bw;
  const int tz = min(a.bz, a.zo - oz0), ty = min(a.bh, a.ho - oy0);
  const int tx = min(a.bw, a.wo - ox0);
  int zs = tz + t * (D - 1), hs = ty + t * (N - 1), ws = tx + t * (a.M - 1);

  // Stage the skirt once, reading x in place; zeros outside the domain.
  const int iz0 = oz0 - a.lz, iy0 = oy0 - a.ly, ix0 = ox0 - a.lx;
  const size_t iplane = (size_t)a.hin * a.win;
  const size_t ibase = (size_t)b * a.zin * iplane;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  for (int row = warp; row < zs * hs; row += nwarps) {
    const int gz = iz0 + row / hs, gy = iy0 + row % hs;
    const bool row_in = gz >= 0 && gz < a.zin && gy >= 0 && gy < a.hin;
    const size_t rbase = ibase + (size_t)gz * iplane + (size_t)gy * a.win;
    for (int xx = lane; xx < ws; xx += kWarp) {
      const int gx = ix0 + xx;
      float v = 0.f;
      if (row_in && gx >= 0 && gx < a.win) {
        v = a.io_bf16
                ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[rbase + gx])
                : static_cast<const float*>(a.x)[rbase + gx];
      }
      buf0[row * ws + xx] = v;
    }
  }
  __syncthreads();

  float* src = buf0;
  float* dst = buf1;
  for (int k = 0; k < t; ++k) {
    const bool last = k == t - 1;
    apply_once<N, D, P>(a, src, zs, hs, ws, dst, last, b, oz0, oy0, ox0,
                        coef, mask, shift);
    __syncthreads();
    zs -= D - 1;
    hs -= N - 1;
    ws -= a.M - 1;
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
}

typedef void (*KernelFn)(WindowArgs);

// Instantiation tables, one translation unit each so they build in parallel.
KernelFn pick_2d(int N);          // D = 1, P = 8, N in [1, 32]
KernelFn pick_3d(int N, int D);   // P = 4, N and D in [1, 5]

}  // namespace ssam
