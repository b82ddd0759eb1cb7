// K4 on Hopper: the weight gradient of a per-lane (depthwise) windowed
// plan, the dW of Mamba's depthwise causal conv1d.
//
// Replaces src/repro/core/engine.py::_wgrad_perlane_kernel (launched by
// run_weight_grad_plan, pallas_call at line 835). It computes, in fp32,
//
//   dW[k, d] = sum_b sum_t g[b, t, d] * xp[b, t + k, d]
//
// where xp is x read at t + k - lead, zero outside [0, T) (the plan's lead
// and trail padding is never materialised), g is (batch, Tg, D) with
// Tg = T + lead + trail - (K - 1), and dW is (K, D).
//
// Design. On the TPU the lanes are an output grid axis and batch x time
// tiles a sequential reduce sweep into one VMEM accumulator. Hopper blocks
// run in parallel in no set order, so:
//  * one thread per channel, 128 channels per block (coalesced loads along
//    D); each thread keeps its K sums in fp32 registers and streams down
//    its slice of time with the last K-1 rows of x in a register window,
//    loading kUnroll rows of x and g ahead of the FMAs;
//  * the grid is channel tiles x time slices x sequences, the slices sized
//    so that the card fills when D is small; each block writes its K sums
//    to an (slices * batch, K, D) scratch, and a second kernel adds the
//    partials in a fixed order (sequence-major, slice ascending). No
//    atomics: the result is the same on every run, as K3's split is.
//
// Bound on an H100: bytes. Each (t, d) reads one x and one g value for 2K
// FLOPs; at Hymba's (2, 2048, 3200) fp32 that is 104.9 MB, 0.031 ms at
// 3.35 TB/s. The partials (a few MB) and the second pass are the cost of
// the fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kUnroll = 4;

struct WgradPerlaneArgs {
  const void* x;  // (batch, T, D), fp32 or bf16
  const void* g;  // (batch, Tg, D), x's dtype
  int io_bf16;
  float* part;    // (batch * slices, K, D), or dW itself when that is one
  int T, D, Tg, lead, rows, slices;
};

__device__ __forceinline__ float load(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int K>
__global__ void __launch_bounds__(kLanes)
    wgrad_perlane_kernel(WgradPerlaneArgs a) {
  const int d = blockIdx.x * kLanes + threadIdx.x;
  if (d >= a.D) return;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = s * a.rows;
  const int t1 = min(t0 + a.rows, a.Tg);
  const size_t xbase = (size_t)b * a.T * a.D;
  const size_t gbase = (size_t)b * a.Tg * a.D;
  auto xrow = [&](int t) -> float {
    const int ti = t - a.lead;
    return (ti >= 0 && ti < a.T) ? load(a.x, a.io_bf16, xbase +
                                        (size_t)ti * a.D + d)
                                 : 0.f;
  };
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  // c[i] holds xp row t + i for the cotangent row t being summed
  float c[K - 1 + kUnroll];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) c[i] = xrow(t0 + i);
  for (int t = t0; t < t1; t += kUnroll) {
    float gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      c[K - 1 + u] = xrow(t + K - 1 + u);
      gv[u] = t + u < t1
                  ? load(a.g, a.io_bf16, gbase + (size_t)(t + u) * a.D + d)
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(gv[u], c[u + k], acc[k]);
#pragma unroll
    for (int i = 0; i < K - 1; ++i) c[i] = c[i + kUnroll];
  }
  float* dst = a.part + ((size_t)b * a.slices + s) * K * a.D + d;
#pragma unroll
  for (int k = 0; k < K; ++k) dst[(size_t)k * a.D] = acc[k];
}

// out[i] = sum over the partials p = 0..parts-1 of part[p * n + i], in order.
__global__ void wgrad_perlane_sum(const float* part, float* out, int parts,
                                  size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * n + i];
  out[i] = s;
}

using WgradPerlaneFn = void (*)(WgradPerlaneArgs);

WgradPerlaneFn pick(int k) {
  switch (k) {
    case 1: return wgrad_perlane_kernel<1>;
    case 2: return wgrad_perlane_kernel<2>;
    case 3: return wgrad_perlane_kernel<3>;
    case 4: return wgrad_perlane_kernel<4>;
    case 5: return wgrad_perlane_kernel<5>;
    case 6: return wgrad_perlane_kernel<6>;
    case 7: return wgrad_perlane_kernel<7>;
    case 8: return wgrad_perlane_kernel<8>;
  }
  return nullptr;
}

}  // namespace

// Plain C entry of K4, loaded with ctypes. part may equal out when
// batch * slices == 1.
extern "C" int ssam_wgrad_perlane_launch(
    const void* x, const void* g, int io_bf16, float* part, float* out,
    int batch, int T, int D, int Tg, int K, int lead, int rows, int slices,
    void* stream) {
  WgradPerlaneFn fn = pick(K);
  if (fn == nullptr || batch < 1 || batch > 65535 || T < 1 || D < 1 ||
      Tg < 1 || lead < 0 || rows < 1 || rows % kUnroll || slices < 1 ||
      slices > 65535 || (size_t)rows * slices < (size_t)Tg)
    return (int)cudaErrorInvalidValue;
  WgradPerlaneArgs a;
  a.x = x;
  a.g = g;
  a.io_bf16 = io_bf16;
  a.part = part;
  a.T = T;
  a.D = D;
  a.Tg = Tg;
  a.lead = lead;
  a.rows = rows;
  a.slices = slices;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fn<<<dim3((D + kLanes - 1) / kLanes, slices, batch), kLanes, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  const int parts = batch * slices;
  if (e != cudaSuccess || parts == 1) return (int)e;
  const size_t n = (size_t)K * D;
  wgrad_perlane_sum<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, out,
                                                                 parts, n);
  return (int)cudaGetLastError();
}
