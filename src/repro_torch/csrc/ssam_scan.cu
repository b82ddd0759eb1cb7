// K5: the SSAM scan kernel for Hopper (sm_90a), the paper's Fig. 1e.
//
// Replaces src/repro/core/engine.py::_scan_kernel (launched by _scan_call,
// pl.pallas_call at engine.py:1015). It computes, along each row of an
// (R, T) operand, either the inclusive prefix sum (combine 'add') or the
// linear recurrence h_t = a_t * h_{t-1} + b_t (combine 'linrec', transfer
// pairs (A, B)), seeded from an optional carry-in h_{-1} (default 0), and
// optionally publishes the final raw state h_{T-1} as an (R, 1) carry-out.
//
// Design. Rows are independent and T is contiguous, so one warp owns one
// row and walks T in 32-lane pieces: lane l of piece p holds t = 32p + l,
// so every load and store is coalesced. Each piece runs the Kogge-Stone
// arrows of Eq. 1 as __shfl_up_sync by 1, 2, 4, 8 and 16, gated by
// lane >= d with the identity (add: 0; linrec: (1, 0)) below; for linrec a
// step is A, B = A*As, A*Bs + B, i.e. f_t o f_{t-d}, and the shuffle reads
// the registers from before the step. The piece then applies the running
// carry (add: s + carry; linrec: A*carry + B) and the new carry is lane
// 31's value, broadcast with __shfl_sync. Loads past T are masked to the
// identity in registers (the reference pads a copy with 1 and 0 in HBM),
// so the lanes past the end leave the carry unchanged and lane 31 holds
// h_{T-1} after the last piece. The accumulator is fp32 for fp32 and bf16
// I/O; the carry-in and carry-out use the I/O type, as in the reference.
//
// The plan's lane tile S sets the tile of the plain version
// (run_scan_plan_reference), not this kernel's: both compute the same
// function and differ only in rounding (the order of the products of the
// prefix), which the fp32 tolerance of the tests covers.
//
// Bound: bytes. Each element is read once per operand and written once
// (add: 8 bytes, linrec: 12 bytes in fp32) against a handful of FMAs, far
// below the card's operations-per-byte line. A warp starts the loads of
// kUnroll pieces before it scans them, so several loads per warp are in
// flight while the carry walks the row in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <bool kLinrec, typename IO>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
ssam_scan_kernel(const IO* __restrict__ a, const IO* __restrict__ b,
                 const IO* __restrict__ carry_in, IO* __restrict__ out,
                 IO* __restrict__ carry_out, int R, int T) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= R) return;  // the whole warp leaves together
  const long long base = row * (long long)T;
  // Combine 'add' takes its one operand in `a` and has no A.
  const IO* xb = kLinrec ? b + base : a + base;
  const IO* xa = a + base;
  IO* o = out + base;
  float carry = carry_in != nullptr ? load_f(carry_in + row) : 0.f;

  for (int t0 = 0; t0 < T; t0 += kWarp * kUnroll) {
    float A[kUnroll], B[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kWarp + lane;
      const bool ok = t < T;
      B[u] = ok ? load_f(xb + t) : 0.f;
      A[u] = kLinrec ? (ok ? load_f(xa + t) : 1.f) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u * kWarp >= T) break;  // uniform across the warp
      float Au = A[u], Bu = B[u];
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const float Bs = __shfl_up_sync(kFull, Bu, d);
        if (kLinrec) {
          const float As = __shfl_up_sync(kFull, Au, d);
          if (lane >= d) {
            Bu = Au * Bs + Bu;  // uses A from before the step
            Au = Au * As;
          }
        } else if (lane >= d) {
          Bu = Bu + Bs;
        }
      }
      const float h = kLinrec ? Au * carry + Bu : Bu + carry;
      const int t = t0 + u * kWarp + lane;
      if (t < T) store_f(o + t, h);
      carry = __shfl_sync(kFull, h, kWarp - 1);
    }
  }
  if (carry_out != nullptr && lane == 0) store_f(carry_out + row, carry);
}

template <typename IO>
cudaError_t launch(const void* a, const void* b, const void* carry_in,
                   void* out, void* carry_out, int R, int T, int linrec,
                   cudaStream_t stream) {
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarp * kWarpsPerBlock);
  const IO* pa = static_cast<const IO*>(a);
  const IO* pb = static_cast<const IO*>(b);
  const IO* pc = static_cast<const IO*>(carry_in);
  IO* po = static_cast<IO*>(out);
  IO* pco = static_cast<IO*>(carry_out);
  if (linrec)
    ssam_scan_kernel<true, IO><<<grid, block, 0, stream>>>(pa, pb, pc, po,
                                                           pco, R, T);
  else
    ssam_scan_kernel<false, IO><<<grid, block, 0, stream>>>(pa, pb, pc, po,
                                                            pco, R, T);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry of K5, loaded with ctypes. `b` is null for combine 'add'
// (linrec = 0); `carry_in` and `carry_out` may be null. Returns the CUDA
// error of the launch (0 on success).
extern "C" int ssam_scan_launch(const void* a, const void* b,
                                const void* carry_in, void* out,
                                void* carry_out, int R, int T, int linrec,
                                int io_bf16, void* stream) {
  if (a == nullptr || out == nullptr || R < 1 || T < 1 ||
      (linrec && b == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(io_bf16 ? launch<__nv_bfloat16>(a, b, carry_in, out,
                                               carry_out, R, T, linrec, s)
                       : launch<float>(a, b, carry_in, out, carry_out, R, T,
                                       linrec, s));
}
