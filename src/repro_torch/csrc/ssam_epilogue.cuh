// The fused epilogue of the channel-reduce paths (K1's ssam_window_reduce.cu
// and K2's ssam_mxu.cu): the reference's _apply_epilogue_val, applied to
// the fp32 sum of one output before it is stored.
#pragma once

#include <cuda_runtime.h>

namespace ssam {

constexpr int kMaxEpi = 8;

// op codes (core/engine.py EPILOGUE_CODES): 1 bias (per out channel),
// 2 gelu (tanh), 3 silu, 4 relu, 5 scale.
__device__ __forceinline__ float apply_epilogue(const int* op,
                                                const float* val, int n,
                                                const float* bias, float v,
                                                int co) {
  for (int s = 0; s < n; ++s) {
    switch (op[s]) {
      case 1:
        v += bias[co];
        break;
      case 2: {  // 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3)))
        const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
        v = 0.5f * v * (1.f + tanhf(u));
        break;
      }
      case 3:
        v = v / (1.f + expf(-v));
        break;
      case 4:
        v = fmaxf(v, 0.f);
        break;
      case 5:
        v *= val[s];
        break;
    }
  }
  return v;
}

}  // namespace ssam
