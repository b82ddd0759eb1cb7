// The fused epilogue of the channel-reduce paths (K1's ssam_window_reduce.cu
// and K2's ssam_mxu_tc.cu): the reference's _apply_epilogue_val, applied to
// the fp32 sum of one output before it is stored.
#pragma once

#include <cuda_runtime.h>

namespace ssam {

constexpr int kMaxEpi = 8;

// op codes (core/engine.py EPILOGUE_CODES): 1 bias (per out channel),
// 2 gelu (tanh), 3 silu, 4 relu, 5 scale.
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

__device__ __forceinline__ float apply_epilogue(const int* op,
                                                const float* val, int n,
                                                const float* bias, float v,
                                                int co) {
  for (int s = 0; s < n; ++s) v = apply_epilogue_op(op[s], val[s], bias, v, co);
  return v;
}

}  // namespace ssam
