// K1 on Hopper, per-lane path: depthwise (per-lane coefficient) windowed
// plans, i.e. the depthwise causal conv1d of Mamba blocks and its input
// adjoint, with a per-lane bias and an activation fused.
//
// Replaces src/repro/core/engine.py::_window_kernel for plans with
// coeff_mode 'perlane' (depthwise_conv1d_plan and its input adjoint): the
// per-lane coefficient rows of _coeff (w[coeff_id, lane]) and the per-lane
// bias of _apply_epilogue_val, applied at the flush.
//
//   out[b, t, d] = epi( sum_r x[b, t + r - lead, d] * w[cid[r], d] )
//
// over the footprint rows r that carry a tap (cid[r] >= 0), with zeros
// where the read leaves [0, T) (the plan's lead/trail padding is never
// materialised). The forward plan has lead K-1 and cid[r] = r; its input
// adjoint has lead 0 (trail K-1) and the reflected cid[r] = K-1-r, so the
// kernel reads w through cid, never through the row index.
//
// Design (the paper's "vertical" direction, section 5.4: the taps walk
// time, the cheap in-thread direction, and M = 1 needs no shuffles):
//  * One thread per channel, 128 channels per block: neighbouring threads
//    read neighbouring addresses of a time row, so every load and store is
//    coalesced along D.
//  * A block covers 64 output rows. Each thread keeps the last N-1 input
//    rows of its channel in registers and streams down time, loading
//    kUnroll new rows before it computes kUnroll outputs, so several loads
//    per thread are in flight. The N-1 halo rows of a block are read again
//    by the block above it (1/64 of the reads for a 4-tap filter).
//  * The sum is fp32 for fp32 and bf16 I/O, taken in row order (the plan's
//    order); the epilogue is applied once to it before the store.
//
// Bound on an H100: bytes. Each output costs 2N FLOPs against 8 bytes of
// fp32 I/O, far below the card's operations-per-byte line; at Hymba's
// (2, 2048, 3200) the input and output are 104.9 MB, 0.031 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssam_epilogue.cuh"

namespace {

constexpr int kLanes = 128;   // channels per block, one thread each
constexpr int kRows = 64;     // output rows per block
constexpr int kMaxRows = 8;   // footprint rows (filter taps)
constexpr int kUnroll = 4;    // input rows loaded ahead

struct PerlaneArgs {
  const void* x;      // (batch, T, D), fp32 or bf16
  void* out;          // (batch, To, D), x's dtype
  int io_bf16;
  const float* w;     // (K, D) fp32
  const float* bias;  // (D,) fp32, or null
  int cid[kMaxRows];  // per footprint row: the row of w, -1 = no tap
  int epi_op[ssam::kMaxEpi];
  float epi_val[ssam::kMaxEpi];
  int n_epi;
  int T, D, To, lead;
};

__device__ __forceinline__ float load_x(const PerlaneArgs& a, size_t base,
                                        int t, int d) {
  if (t < 0 || t >= a.T) return 0.f;
  const size_t i = base + (size_t)t * a.D + d;
  return a.io_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[i])
             : static_cast<const float*>(a.x)[i];
}

template <int N>
__global__ void __launch_bounds__(kLanes)
    window_perlane_kernel(PerlaneArgs a) {
  const int d = blockIdx.x * kLanes + threadIdx.x;
  if (d >= a.D) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kRows;
  const int t1 = min(t0 + kRows, a.To);
  const size_t xbase = (size_t)b * a.T * a.D;
  const size_t obase = (size_t)b * a.To * a.D;
  float wr[N];
  bool on[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    on[r] = a.cid[r] >= 0;
    wr[r] = on[r] ? a.w[(size_t)a.cid[r] * a.D + d] : 0.f;
  }
  // c[i] holds input row t - lead + i for the output row t being computed
  float c[N - 1 + kUnroll];
#pragma unroll
  for (int i = 0; i < N - 1; ++i) c[i] = load_x(a, xbase, t0 - a.lead + i, d);
  for (int t = t0; t < t1; t += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      c[N - 1 + u] = load_x(a, xbase, t - a.lead + N - 1 + u, d);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < t1) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < N; ++r)
          if (on[r]) s = fmaf(c[u + r], wr[r], s);
        s = ssam::apply_epilogue(a.epi_op, a.epi_val, a.n_epi, a.bias, s, d);
        const size_t o = obase + (size_t)(t + u) * a.D + d;
        if (a.io_bf16)
          static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(s);
        else
          static_cast<float*>(a.out)[o] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < N - 1; ++i) c[i] = c[i + kUnroll];
  }
}

using PerlaneFn = void (*)(PerlaneArgs);

PerlaneFn pick(int n) {
  switch (n) {
    case 1: return window_perlane_kernel<1>;
    case 2: return window_perlane_kernel<2>;
    case 3: return window_perlane_kernel<3>;
    case 4: return window_perlane_kernel<4>;
    case 5: return window_perlane_kernel<5>;
    case 6: return window_perlane_kernel<6>;
    case 7: return window_perlane_kernel<7>;
    case 8: return window_perlane_kernel<8>;
  }
  return nullptr;
}

}  // namespace

// Plain C entry of K1's per-lane path, loaded with ctypes.
extern "C" int ssam_window_perlane_launch(
    const void* x, void* out, int io_bf16, const float* w, const int* cid,
    int N, const float* bias, const int* epi_ops, const float* epi_vals,
    int n_epi, int batch, int T, int D, int To, int lead, void* stream) {
  PerlaneFn fn = pick(N);
  if (fn == nullptr || n_epi < 0 || n_epi > ssam::kMaxEpi || batch < 1 ||
      T < 1 || D < 1 || To < 1 || lead < 0 || batch > 65535 ||
      (To + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  PerlaneArgs a;
  a.x = x;
  a.out = out;
  a.io_bf16 = io_bf16;
  a.w = w;
  a.bias = bias;
  for (int r = 0; r < kMaxRows; ++r) a.cid[r] = r < N ? cid[r] : -1;
  for (int s = 0; s < ssam::kMaxEpi; ++s) {
    a.epi_op[s] = s < n_epi ? epi_ops[s] : 0;
    a.epi_val[s] = s < n_epi ? epi_vals[s] : 0.f;
    if (a.epi_op[s] == 1 && bias == nullptr) return (int)cudaErrorInvalidValue;
  }
  a.n_epi = n_epi;
  a.T = T;
  a.D = D;
  a.To = To;
  a.lead = lead;
  dim3 grid((D + kLanes - 1) / kLanes, (To + kRows - 1) / kRows, batch);
  fn<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
