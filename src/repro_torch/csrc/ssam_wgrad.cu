// K3 on Hopper: the weight gradient of a dense windowed plan.
//
// Replaces src/repro/core/engine.py::_wgrad_dense_kernel (launched by
// run_weight_grad_plan, pallas_call at line 873). It computes, in fp32,
//
//   dW[co, ci, n, m] = sum_b sum_(oy, ox) g[b, co, oy, ox]
//                                          * xp[b, ci, oy + n, ox + m]
//
// where xp is x read at (oy + n - ly, ox + m - lx), zero outside the input
// (the plan's lead padding is never materialised). The plain dense (N, M)
// layout is the case C_in = C_out = 1.
//
// Design (a GEMM over the implicit im2col of x, C_out x (C_in*N*M), with
// the cotangent's positions as the reduction):
//  * A block of 256 threads owns co_tile output channels x rows_tile
//    flattened (ci, n, m) rows of dW. Its threads split into cg channel
//    groups (CR channels each) x rg row groups (4 rows each, strided by rg
//    so that neighbouring lanes read neighbouring rows) x ph position
//    phases; each thread keeps CR x 4 sums in fp32 registers.
//  * The reduction walks chunks of 64 cotangent positions along a row. Per
//    chunk, g[b, co-tile, oy, chunk] and the input rows the block's taps
//    reach, x[b, ci-span, oy + n - ly, chunk + m - lx] (64 + M - 1
//    columns, padded to an odd pitch against bank conflicts), are staged
//    in shared memory; the im2col row (ci, n, m) at position j is
//    xs[(ci, n)][j + m].
//  * Hopper blocks run in no set order and the TPU's sequential reduce grid
//    does not exist here, so no sum crosses blocks by atomics: phases are
//    added in a fixed order inside the block, and where (co, row) tiles are
//    too few to fill 132 SMs (the single-channel (N, M) case has one), the
//    chunks split into slices that write partials, which a second kernel
//    adds in slice order. The result is the same on every run.
//
// Bound on an H100: the Whisper stem's gradients (C_out 512, C_in 80 or
// 512, 3 taps, 24000 positions) are bound by fp32 operations; the (N, M)
// single-channel case by the bytes of x and g. Per position a warp issues
// 4 shared loads and one broadcast float4 load for 16 FMAs (CR = 4), so
// shared-memory issue is the limit of this simple version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssam {

constexpr int kWThreads = 256;
constexpr int kWPos = 64;  // cotangent positions per staged chunk

struct WgradArgs {
  const void* x;   // (batch, cin, hin, win), fp32 or bf16
  const void* g;   // (batch, cout, ho, wo), x's dtype
  int io_bf16;
  float* part;     // (slices, cout, cin*N*M), or the output when slices == 1
  int batch, cin, cout, hin, win, ho, wo, N, M, ly, lx;
  int cg, rg, ph;  // thread layout
  int nchunks, slices, span, lp;
};

__device__ __forceinline__ float load_io(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int CR>
__global__ void __launch_bounds__(kWThreads) wgrad_kernel(WgradArgs a) {
  extern __shared__ float smem[];
  const int NM = a.N * a.M;
  const int rows = a.cin * NM;
  const int co_tile = a.cg * CR;
  const int rows_tile = 4 * a.rg;
  const int r0 = blockIdx.x * rows_tile;
  const int co0 = blockIdx.y * co_tile;
  const int slice = blockIdx.z;
  const int rgi = threadIdx.x % a.rg;
  const int cgi = (threadIdx.x / a.rg) % a.cg;
  const int phi = threadIdx.x / (a.rg * a.cg);
  const int ci_lo = r0 / NM;
  const int ci_n = min(a.span, a.cin - ci_lo);
  const int cols = kWPos + a.M - 1;

  float* gs = smem;                   // kWPos x co_tile
  float* xs = smem + kWPos * co_tile;  // (ci_n * N) rows x lp

  int off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + rgi + a.rg * i;
    if (r < rows) {
      const int ci = r / NM, n = (r / a.M) % a.N, m = r % a.M;
      off[i] = ((ci - ci_lo) * a.N + n) * a.lp + m;
    } else {
      off[i] = 0;  // a valid cell; the sum is never stored
    }
  }
  float acc[CR][4];
#pragma unroll
  for (int k = 0; k < CR; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[k][i] = 0.f;

  const int ncx = (a.wo + kWPos - 1) / kWPos;
  const int c_begin = (int)((long long)slice * a.nchunks / a.slices);
  const int c_end = (int)((long long)(slice + 1) * a.nchunks / a.slices);
  for (int ch = c_begin; ch < c_end; ++ch) {
    const int b = ch / (a.ho * ncx);
    const int oy = (ch / ncx) % a.ho;
    const int ox0 = (ch % ncx) * kWPos;
    __syncthreads();  // the last chunk is read
    for (int i = threadIdx.x; i < co_tile * kWPos; i += kWThreads) {
      const int k = i / kWPos, j = i % kWPos;
      const int co = co0 + k, ox = ox0 + j;
      gs[j * co_tile + k] =
          (co < a.cout && ox < a.wo)
              ? load_io(a.g, a.io_bf16,
                        (((size_t)b * a.cout + co) * a.ho + oy) * a.wo + ox)
              : 0.f;
    }
    for (int i = threadIdx.x; i < ci_n * a.N * cols; i += kWThreads) {
      const int j = i % cols, cn = i / cols;
      const int c = cn / a.N, n = cn % a.N;
      const int gy = oy + n - a.ly, gx = ox0 + j - a.lx;
      xs[cn * a.lp + j] =
          (gy >= 0 && gy < a.hin && gx >= 0 && gx < a.win)
              ? load_io(a.x, a.io_bf16,
                        (((size_t)b * a.cin + ci_lo + c) * a.hin + gy) * a.win +
                            gx)
              : 0.f;
    }
    __syncthreads();
    for (int j = phi; j < kWPos; j += a.ph) {
      float gv[CR];
      if constexpr (CR == 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&gs[j * co_tile + cgi * CR]);
        gv[0] = v.x;
        gv[1] = v.y;
        gv[2] = v.z;
        gv[3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < CR; ++k) gv[k] = gs[j * co_tile + cgi * CR + k];
      }
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[off[i] + j];
#pragma unroll
      for (int k = 0; k < CR; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[k][i] = fmaf(gv[k], xv[i], acc[k][i]);
    }
  }

  // Add the position phases in phase order, then store this slice's sums.
  __syncthreads();
  float* red = smem;  // ph x co_tile x rows_tile
#pragma unroll
  for (int k = 0; k < CR; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(phi * co_tile + cgi * CR + k) * rows_tile + rgi + a.rg * i] =
          acc[k][i];
  __syncthreads();
  for (int e = threadIdx.x; e < co_tile * rows_tile; e += kWThreads) {
    float s = 0.f;
    for (int p = 0; p < a.ph; ++p) s += red[p * co_tile * rows_tile + e];
    const int co = co0 + e / rows_tile, r = r0 + e % rows_tile;
    if (co < a.cout && r < rows)
      a.part[((size_t)slice * a.cout + co) * rows + r] = s;
  }
}

// out[e] = sum over slices of part[s][e], in slice order.
__global__ void wgrad_sum_kernel(const float* part, float* out, int slices,
                                 size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[k * n + e];
  out[e] = s;
}

}  // namespace ssam

// Plain C entry of K3, loaded with ctypes. part may equal out when the
// reduction is not split (gz == 1).
extern "C" int ssam_wgrad_launch(
    const void* x, const void* g, int io_bf16, float* part, float* out,
    int batch, int cin, int cout, int hin, int win, int ho, int wo, int N,
    int M, int ly, int lx, int cr, int cg, int rg, int ph, int gx, int gy,
    int gz, int nchunks, int span, int lp, int smem_bytes, void* stream) {
  if ((cr != 1 && cr != 4) || cg * rg * ph != ssam::kWThreads || gz < 1 ||
      nchunks < 1 || lp < ssam::kWPos + M - 1)
    return (int)cudaErrorInvalidValue;
  ssam::WgradArgs a;
  a.x = x;
  a.g = g;
  a.io_bf16 = io_bf16;
  a.part = part;
  a.batch = batch;
  a.cin = cin;
  a.cout = cout;
  a.hin = hin;
  a.win = win;
  a.ho = ho;
  a.wo = wo;
  a.N = N;
  a.M = M;
  a.ly = ly;
  a.lx = lx;
  a.cg = cg;
  a.rg = rg;
  a.ph = ph;
  a.nchunks = nchunks;
  a.slices = gz;
  a.span = span;
  a.lp = lp;
  void (*fn)(ssam::WgradArgs) =
      cr == 4 ? ssam::wgrad_kernel<4> : ssam::wgrad_kernel<1>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fn<<<dim3(gx, gy, gz), ssam::kWThreads, smem_bytes, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || gz == 1) return (int)e;
  const size_t n = (size_t)cout * cin * N * M;
  ssam::wgrad_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, out, gz, n);
  return (int)cudaGetLastError();
}
