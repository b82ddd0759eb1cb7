// The fused epilogue of the windowed kernels (K1's ssam_window.cuh,
// ssam_window_reduce.cu and ssam_window_perlane.cu, K2's ssam_mxu.cu and
// ssam_mxu_tc.cu): the reference's _apply_epilogue_val, applied to the fp32
// sum of one output before it is cast and stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ssam {

constexpr int kMaxEpi = 8;

// op codes (core/engine.py EPILOGUE_CODES): 1 bias (bias[co]: per out
// channel or per lane), 2 gelu (tanh), 3 silu, 4 relu, 5 scale; 6
// residual_add, which the callers apply: they read the residual at the
// output's position.
__device__ __forceinline__ float apply_epilogue_op(int op, float val,
                                                   const float* bias,
                                                   float v, int co) {
  switch (op) {
    case 1:
      return v + bias[co];
    case 2: {  // 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3)))
      const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(u));
    }
    case 3:
      return v / (1.f + expf(-v));
    case 4:
      return fmaxf(v, 0.f);
    case 5:
      return v * val;
  }
  return v;
}

// One op on the N values a thread holds, the op a compile-time constant
// (1: + bias, a scalar here).
template <int Op, int N>
__device__ __forceinline__ void epilogue_each(float (&v)[N], float val,
                                              float bias) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = Op == 1 ? v[i] + bias
                   : apply_epilogue_op(Op, val, nullptr, v[i], 0);
}

// The chain on N values held in registers: each stage's op dispatched once
// for all N (a per-value dispatch costs more than the stencils' own
// arithmetic), `bias` the scalar bias, `res(i)` value i's residual (read by
// op 6 only).
template <int N, class Res>
__device__ __forceinline__ void apply_epilogue_regs(const int* op,
                                                    const float* val, int n,
                                                    float bias, float (&v)[N],
                                                    Res res) {
  for (int s = 0; s < n; ++s) {
    const float vs = val[s];
    switch (op[s]) {
      case 1: epilogue_each<1, N>(v, vs, bias); break;
      case 2: epilogue_each<2, N>(v, vs, bias); break;
      case 3: epilogue_each<3, N>(v, vs, bias); break;
      case 4: epilogue_each<4, N>(v, vs, bias); break;
      case 5: epilogue_each<5, N>(v, vs, bias); break;
      case 6:
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += res(i);
        break;
    }
  }
}

// The residual's element `at` (fp32 or bf16, the output's dtype), or 0
// where there is none.
__device__ __forceinline__ float load_residual(const void* resid, int bf16,
                                               size_t at) {
  if (resid == nullptr) return 0.f;
  return bf16 ? __bfloat162float(
                    static_cast<const __nv_bfloat16*>(resid)[at])
              : static_cast<const float*>(resid)[at];
}

// The residual's n <= 4 consecutive elements from `at` into r (zeros past
// n, or where there is no residual): one 16-byte (fp32) or 8-byte (bf16)
// load where all four are there and aligned, else one load each.
__device__ __forceinline__ void load_residual4(const void* resid, int bf16,
                                               size_t at, int n,
                                               float (&r)[4]) {
  if (resid == nullptr) {
    r[0] = r[1] = r[2] = r[3] = 0.f;
    return;
  }
  if (n == 4 && !bf16 && ((reinterpret_cast<uintptr_t>(resid) +
                           4 * at) & 15) == 0) {
    const float4 v = *reinterpret_cast<const float4*>(
        static_cast<const float*>(resid) + at);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
    return;
  }
  if (n == 4 && bf16 && ((reinterpret_cast<uintptr_t>(resid) + 2 * at) &
                         7) == 0) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(resid) + at);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    r[0] = lo.x, r[1] = lo.y, r[2] = hi.x, r[3] = hi.y;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r[k] = k < n ? load_residual(resid, bf16, at + k) : 0.f;
}

}  // namespace ssam
